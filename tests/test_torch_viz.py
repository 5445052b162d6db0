"""The port's `utils/viz.py` and `cli render` against tapnet_tpu's.

The JAX package's render tests (tests/test_cli_data_viz.py: `render` on
2d-rot and 3d-basic, `render_3d_blocks` and `render_animation` on
3d-basic, `render_sequence` on 3d-basic) on the same instances, states and
actions: the port's files hold the JAX functions' pixels (decoded with
PIL; a GIF frame by frame) and pass the JAX tests' size and magic checks.
`render_3d`, the 2D sequence and (through the CLI) the 2D animation are
held the same way. The port's inputs are its own tensors (a batch of one,
or one instance), rolled out by the port; the JAX functions get the same
arrays (tests/test_torch_rollout.py holds the rollouts bit for bit).
`cli render` prints the JAX CLI's reward for the same seed and writes the
same pixels; where matplotlib does not import, it fails with matplotlib's
ModuleNotFoundError, as the JAX package's does. The 3D voxel GIF and
sequence take seconds each (a bar3d panel per step) and are marked slow.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image, ImageSequence

import tapnet_tpu
from tapnet_tpu.cli import main as jax_cli
from tapnet_tpu.types import EnvState as JEnvState, Instance as JInstance
from tapnet_tpu.utils import viz as JV
import tapnet_torch
from tapnet_torch import random as R
from tapnet_torch.cli import main as torch_cli
from tapnet_torch.env import core as E
from tapnet_torch.env.sampler import sample_instance
from tapnet_torch.types import Instance
from tapnet_torch.utils import viz as V


def _rollouts(name, seed, policy="first"):
    """(port inputs, JAX inputs): (instance, state, actions) of the seed's
    instance rolled out by the port (the port's instance a batch of one)
    and the same arrays as the JAX package's NamedTuples of jax arrays
    (tests/test_torch_rollout.py holds the port's rollout to the JAX one
    bit for bit)."""
    cfg, jcfg = tapnet_torch.CONFIGS[name], tapnet_tpu.CONFIGS[name]
    key = R.key(seed)
    batch = sample_instance(key[None], cfg)
    state, actions, _ = E.rollout(Instance(*(x[0] for x in batch)), key, cfg,
                                  policy)
    jinst = JInstance(*(jnp.asarray(x[0].numpy()) for x in batch))
    jstate = JEnvState(*(jnp.asarray(x.numpy()) for x in state))
    return (cfg, jcfg, (batch, state, actions),
            (jinst, jstate, jnp.asarray(actions.numpy())))


def _frames(path):
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in
                ImageSequence.Iterator(im)]


def _same_pixels(got, want):
    a, b = _frames(got), _frames(want)
    assert len(a) == len(b), (len(a), len(b))
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape and np.array_equal(x, y), f"frame {i}"
    return len(a)


@pytest.mark.parametrize("name", ["2d-rot", "3d-basic"])
def test_render_matches_jax(tmp_path, name):
    cfg, jcfg, (inst, state, _), (jinst, jstate, _) = _rollouts(name, 0)
    got = V.render(inst, state, cfg, str(tmp_path / "port.png"))
    want = JV.render(jinst, jstate, jcfg, str(tmp_path / "jax.png"))
    assert os.path.getsize(got) > 1000
    assert _same_pixels(got, want) == 1


def test_render_3d_heightmaps_matches_jax(tmp_path):
    cfg, jcfg, (inst, state, _), (jinst, jstate, _) = _rollouts(
        "multi-container", 1)
    got = V.render(inst, state, cfg, str(tmp_path / "port.png"),
                   title="hm", blocks_3d=False)
    want = JV.render_3d(jinst, jstate, jcfg, str(tmp_path / "jax.png"),
                        title="hm")
    assert os.path.getsize(got) > 1000
    _same_pixels(got, want)


def test_2d_sequence_matches_jax(tmp_path):
    """(The 2D GIF is held by the cli render case below.)"""
    cfg, jcfg, (inst, _, actions), (jinst, _, jactions) = _rollouts(
        "2d-rot", 1, "random")
    got = V.render_sequence(inst, actions, cfg, str(tmp_path / "p.png"))
    want = JV.render_sequence(jinst, jactions, jcfg, str(tmp_path / "j.png"))
    assert _same_pixels(got, want) == 1


@pytest.mark.slow
def test_render_3d_blocks_and_gif_match_jax(tmp_path):
    cfg, jcfg, (inst, state, actions), (jinst, jstate, jactions) = _rollouts(
        "3d-basic", 2)
    png = V.render_3d_blocks(inst, state, cfg, str(tmp_path / "b.png"))
    assert os.path.getsize(png) > 10_000
    _same_pixels(png, JV.render_3d_blocks(jinst, jstate, jcfg,
                                          str(tmp_path / "jb.png")))
    gif = V.render_animation(inst, actions, cfg, str(tmp_path / "seq.gif"))
    assert os.path.getsize(gif) > 10_000
    with open(gif, "rb") as f:
        assert f.read(6) in (b"GIF87a", b"GIF89a")
    n = _same_pixels(gif, JV.render_animation(jinst, jactions, jcfg,
                                              str(tmp_path / "jseq.gif")))
    assert n == int(actions.ge(0).sum()) + 1


@pytest.mark.slow
def test_render_sequence_3d_matches_jax(tmp_path):
    cfg, jcfg, (inst, _, actions), (jinst, _, jactions) = _rollouts(
        "3d-basic", 4)
    out = V.render_sequence(inst, actions, cfg, str(tmp_path / "seq3d.png"))
    assert os.path.getsize(out) > 10_000
    _same_pixels(out, JV.render_sequence(jinst, jactions, jcfg,
                                         str(tmp_path / "j.png")))


def test_render_rejects_a_larger_batch():
    cfg = tapnet_torch.CONFIGS["2d-basic"]
    batch = sample_instance(R.split(R.key(0), 2), cfg)
    state = E.reset(batch, cfg)
    with pytest.raises(ValueError, match="batch of 2"):
        V.render(batch, state, cfg)


def _cli(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name,sequence,ext", [("2d-rot", False, "png"),
                                               ("2d-basic", True, "gif")])
def test_cli_render_matches_jax(tmp_path, capsys, name, sequence, ext):
    flags = ["--config", name, "--seed", "3"] + (
        ["--sequence"] if sequence else [])
    got = _cli(torch_cli, ["--device", "cpu", "render", *flags, "--out",
                           str(tmp_path / f"port.{ext}")], capsys)
    want = _cli(jax_cli, ["render", *flags, "--out",
                          str(tmp_path / f"jax.{ext}")], capsys)
    assert set(got) == {"path", "reward"}
    assert got["reward"] == want["reward"]
    frames = _same_pixels(got["path"], want["path"])
    if sequence:    # render_animation: the start, then one frame a step
        assert frames == tapnet_torch.CONFIGS[name].num_blocks + 1
        with open(got["path"], "rb") as f:
            assert f.read(6) in (b"GIF87a", b"GIF89a")


HIDE_MATPLOTLIB = """
import importlib.abc, sys
class Hide(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] == "matplotlib":
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
sys.meta_path.insert(0, Hide())
sys.argv = ["cli"] + sys.argv[1:]
import runpy
runpy.run_module(sys.argv.pop(1), run_name="__main__")
"""


def test_cli_render_without_matplotlib(tmp_path):
    """Where matplotlib is absent (as on the card's machine) the port's
    `render` fails as the JAX package's does: the viz functions import it
    inside, so matplotlib's own ModuleNotFoundError propagates, after the
    rollout and before any file is written."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", HIDE_MATPLOTLIB, "tapnet_torch.cli", "--device",
         "cpu", "render", "--config", "2d-basic", "--out",
         str(tmp_path / "x.png")], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0
    assert res.stderr.strip().splitlines()[-1] == (
        "ModuleNotFoundError: No module named 'matplotlib'")
    assert "tapnet_torch/utils/viz.py" in res.stderr
    assert not os.path.exists(tmp_path / "x.png")
