"""`python -m tapnet_torch.cli` against `python -m tapnet_tpu.cli`, both
called in-process on the CPU (`--device cpu` / `--platform cpu`) with the
same arguments.

- `train` on multi-container with `--mixed-p2d 0.5` (driver config 5) and
  on 2d-basic with `--trace-dir` (one epoch of 2 steps, batch 8, hidden
  32): the metrics lines carry the JAX trainer's keys at its steps, among
  them `env_steps_per_s_per_chip` and, when mixed, `valid_2d_frac` (the
  port's `train()` lacked the first before it logged through
  `utils.profiling.StepsPerSecond`), and each writes a checkpoint; the
  port's trace (a Chrome trace JSON) names `train_step`;
- `eval --baselines --mixed-p2d 0.5`: one JSON line with the JAX CLI's
  keys; the port evaluating the JAX run's own `.msgpack` directory prints
  the JAX CLI's values (within 1e-6);
- `generate`: the same file and sidecar;
- `--nan-checks` on a state with a NaN parameter raises FloatingPointError
  naming it; `train --mesh` (a gloo world of one in this process), `bench`
  (one JSON line), `train --tb-dir` (its events file reads back to the
  metrics file's values) and `render --sequence` (a PNG), which raised
  until they were ported, run; without `--device cpu` and without a card
  a task fails.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from tapnet_tpu import cli as jcli
from tapnet_torch import cli
from tapnet_torch.train import checkpoints as ckpt
from tapnet_torch.train.reinforce import init_train_state

SMALL = ["--epochs", "1", "--steps-per-epoch", "2", "--batch", "8",
         "--valid-batch", "8", "--hidden", "32"]
RUNS = {"mixed": ["--config", "multi-container", "--mixed-p2d", "0.5"],
        "traced": ["--config", "2d-basic"]}


def _lines(path):
    return [json.loads(x) for x in open(path)]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(run, side): its directory} after `train` by both CLIs."""
    out = {}
    for run, flags in RUNS.items():
        for side, main, dev in (("jax", jcli.main, ["--platform", "cpu"]),
                                ("port", cli.main, ["--device", "cpu"])):
            d = str(tmp_path_factory.mktemp(f"{run}-{side}"))
            extra = ["--trace-dir", os.path.join(d, "trace")] \
                if run == "traced" else []
            assert main(dev + ["train", *flags, *SMALL, "--ckpt-dir",
                               os.path.join(d, "ck"), "--metrics",
                               os.path.join(d, "m.jsonl"), *extra]) == 0
            out[run, side] = d
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_train_lines_have_the_jax_keys(runs, run):
    got = _lines(os.path.join(runs[run, "port"], "m.jsonl"))
    want = _lines(os.path.join(runs[run, "jax"], "m.jsonl"))
    assert [set(x) for x in got] == [set(x) for x in want]
    assert [x["step"] for x in got] == [x["step"] for x in want]
    assert "env_steps_per_s_per_chip" in got[-1]
    assert ("valid_2d_frac" in got[-1]) == (run == "mixed")
    assert ckpt.latest_checkpoint(os.path.join(runs[run, "port"], "ck"))


def test_trace_names_train_step(runs):
    traces = glob.glob(os.path.join(runs["traced", "port"], "trace",
                                    "*.json"))
    assert len(traces) == 1
    assert '"train_step"' in open(traces[0]).read()


def test_eval_prints_the_jax_keys(runs, capsys):
    args = ["eval", *RUNS["mixed"], "--batch", "8", "--hidden", "32",
            "--baselines"]
    jdir = os.path.join(runs["mixed", "jax"], "ck")
    assert jcli.main(["--platform", "cpu", *args, "--ckpt-dir", jdir]) == 0
    want = _last_json(capsys)
    assert cli.main(["--device", "cpu", *args, "--ckpt-dir",
                     os.path.join(runs["mixed", "port"], "ck")]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want)
    assert got["ckpt"].endswith(".pt") and got["step"] == want["step"]
    # the port evaluating the JAX run's checkpoint: the JAX CLI's numbers
    assert cli.main(["--device", "cpu", *args, "--ckpt-dir", jdir]) == 0
    same = _last_json(capsys)
    assert same["ckpt"] == want["ckpt"]
    for k, v in want.items():
        if k != "ckpt":
            np.testing.assert_allclose(same[k], v, rtol=0, atol=1e-6,
                                       err_msg=k)


def test_generate_writes_the_jax_file(tmp_path, capsys):
    args = ["generate", "--config", "multi-container", "--num", "20",
            "--seed", "3", "--out"]
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert jcli.main(["--platform", "cpu", *args, jp]) == 0
    want = _last_json(capsys)
    assert cli.main(["--device", "cpu", *args, tp]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want) and got["num"] == 20
    za, zb = np.load(tp), np.load(jp)
    assert sorted(za.files) == sorted(zb.files)
    for f in za.files:
        assert za[f].dtype == zb[f].dtype
        np.testing.assert_array_equal(za[f], zb[f], err_msg=f)
    assert open(tp + ".json").read() == open(jp + ".json").read()


def test_nan_checks_name_the_parameter(tmp_path):
    ts = init_train_state(0, cli.build_config(cli._parser().parse_args(
        ["train", "--config", "2d-basic"])), hidden=32, device="cpu")
    with torch.no_grad():
        ts.actor.query.weight[3, 1] = float("nan")
    ckpt.save_checkpoint(str(tmp_path), ts)
    with pytest.raises(FloatingPointError, match="actor.query.weight"):
        cli.main(["--device", "cpu", "train", "--config", "2d-basic",
                  *SMALL, "--ckpt-dir", str(tmp_path), "--nan-checks"])


@pytest.mark.parametrize("args", [
    ["train", "--config", "2d-basic", "--mesh", *SMALL],
    ["train", "--config", "2d-basic", *SMALL, "--tb-dir", "{tmp}/tb",
     "--metrics", "{tmp}/m.jsonl"],
    ["render", "--config", "2d-basic", "--out", "{tmp}/x.png", "--sequence"],
    ["bench", "--config", "2d-basic", "--batch", "64"]],
    ids=["mesh", "tb-dir", "render", "bench"])
def test_formerly_unported_tasks_run(args, tmp_path, capsys):
    """Each raised NotImplementedError until it was ported; now each runs
    and prints its JSON lines, and writes its file."""
    from tapnet_torch.train.metrics import read_scalars
    args = [a.format(tmp=tmp_path) for a in args]
    assert cli.main(["--device", "cpu", *args]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if "--tb-dir" in args:
        recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
        want = [(k, r["step"], float(np.float32(v))) for r in recs
                for k, v in r.items()
                if k != "step" and isinstance(v, (int, float))]
        (events,) = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
        assert want and read_scalars(events) == want
    if args[0] == "render":
        assert set(out) == {"path", "reward"} and 0 < out["reward"] <= 3
        with open(out["path"], "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_the_card_is_the_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["generate", "--config", "2d-basic", "--num", "4",
                  "--out", str(tmp_path / "x.npz")])
