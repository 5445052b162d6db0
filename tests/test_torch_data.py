"""Instance datasets in the port (`tapnet_torch.utils.data`) against the
JAX package's (`tapnet_tpu.utils.data`) on the CPU.

- `generate_dataset` for the same seed and chunking writes the same arrays
  under the same names and dtypes, and the same config sidecar;
- a file written by either package loads in the other: `load_instances`,
  `load_config`, and `PackDataset` batches in the same (shuffled) order;
- a `make_train_step(from_dataset=True)` step fed by the port's
  `PackDataset` against the JAX step on the same batch and state, within
  the tolerances of `test_torch_train.py::test_train_step_matches_jax`.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tapnet_torch as T
from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.train import reinforce as JR
from tapnet_tpu.types import Instance as JInstance
from tapnet_tpu.utils import data as JD
from tapnet_torch import random as R
from tapnet_torch.convert import params_from_flax
from tapnet_torch.train import reinforce as TR
from tapnet_torch.utils import data as D

NAME = "multi-container"


def _same_file(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for f in za.files:
        assert za[f].dtype == zb[f].dtype, f
        np.testing.assert_array_equal(za[f], zb[f], err_msg=f)
    assert open(a + ".json").read() == open(b + ".json").read()


def test_generate_dataset_matches_jax(tmp_path):
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JD.generate_dataset(jp, JCONFIGS[NAME], 20, seed=3, batch_size=8)
    assert D.generate_dataset(tp, T.CONFIGS[NAME], 20, seed=3, batch_size=8,
                              device="cpu") == tp
    _same_file(tp, jp)
    assert np.load(tp)["dims"].shape == (20, T.CONFIGS[NAME].num_blocks, 3)


def test_files_load_in_both_packages(tmp_path):
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JD.generate_dataset(jp, JCONFIGS[NAME], 10, seed=4)
    D.save_instances(tp, D.load_instances(jp), D.load_config(jp))
    _same_file(tp, jp)
    assert D.load_config(jp) == T.CONFIGS[NAME]
    assert dataclasses.asdict(JD.load_config(tp)) == dataclasses.asdict(
        T.CONFIGS[NAME])
    for a, b in zip(JD.load_instances(tp), D.load_instances(jp)):
        np.testing.assert_array_equal(a, b)
    for seed in (None, 5):
        got = list(D.PackDataset(jp, 3, shuffle_seed=seed))
        want = list(JD.PackDataset(jp, 3, shuffle_seed=seed))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g._fields == JInstance._fields
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_from_dataset_step_matches_jax(tmp_path):
    name, hidden, batch = "2d-basic", 32, 8
    path = str(tmp_path / "d.npz")
    D.generate_dataset(path, T.CONFIGS[name], 16, seed=6, device="cpu")
    inst = next(iter(D.PackDataset(path, batch, shuffle_seed=1)))
    jts = jax.jit(JR.init_train_state, static_argnums=(1, 2))(
        jax.random.key(5), JCONFIGS[name], hidden)
    actor, critic = params_from_flax(jax.tree.map(np.asarray, jts.params),
                                     T.CONFIGS[name], hidden)
    key = np.asarray(jax.random.key_data(jts.key)).astype(np.int64)
    ts = TR.train_state(actor, critic, torch.from_numpy(key))
    with jax.default_matmul_precision("highest"):
        jts1, m_j = JR.make_train_step(
            JCONFIGS[name], batch=batch, hidden=hidden,
            from_dataset=True)(jts, JInstance(*inst))
    ts1, m = T.make_train_step(T.CONFIGS[name], batch=batch, hidden=hidden,
                               from_dataset=True, device="cpu")(
        ts, inst.to("cpu"))
    for k in ("reward", "C", "P", "S"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["loss_critic"]),
                               float(m_j["loss_critic"]), rtol=1e-5)
    for k in ("loss_actor", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-4,
                                   err_msg=k)
    assert ts1.step == 1
    np.testing.assert_array_equal(
        ts1.key.numpy(), np.asarray(jax.random.key_data(jts1.key)))


def test_generate_needs_a_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.generate_dataset(str(tmp_path / "x.npz"), T.CONFIGS[NAME], 4)
