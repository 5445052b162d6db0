"""The port's msgpack decoder (`tapnet_torch.utils.msgpack`) and its
resume from the JAX package's `ckpt_*.msgpack`, on the CPU.

- `unpackb` against `msgpack.unpackb` on flax's bytes of a JAX TrainState
  and on hand-made values; its refusals (another extension type, a dtype
  numpy does not know, flax's chunked arrays, truncated or trailing bytes);
- a JAX run of 2 train steps (2d-basic, hidden 32, batch 8) saved by the
  JAX package, restored by `train.checkpoints.restore_checkpoint`: params,
  both Adam moments (Dense kernels transposed), count, step and key equal;
  then step 3 on both sides within the tolerances of
  `test_torch_train.py::test_train_step_matches_jax`;
- greedy `pack()` of the restored actor bit-equal to the JAX greedy decode
  (plans; rewards within 1e-6).
"""

import flax.serialization
import jax
import msgpack as reference
import numpy as np
import pytest

import tapnet_torch as T
from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.env.sampler import sample_batch as jax_sample_batch
from tapnet_tpu.infer import pack as jax_pack
from tapnet_tpu.train import checkpoints as JC
from tapnet_tpu.train import reinforce as JR
from tapnet_torch.convert import flax_to_state_dict
from tapnet_torch.train import checkpoints as ckpt
from tapnet_torch.types import Instance
from tapnet_torch.utils.msgpack import unpackb

NAME, HIDDEN, B = "2d-basic", 32, 8


def _same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def _restore(raw):
    return reference.unpackb(raw, ext_hook=flax.serialization.
                             _msgpack_ext_unpack, raw=False)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(TrainState after 2 steps, the step, the checkpoint path)."""
    jcfg = JCONFIGS[NAME]
    ts = JR.init_train_state(jax.random.key(4), jcfg, HIDDEN)
    with jax.default_matmul_precision("highest"):
        step = JR.make_train_step(jcfg, batch=B, hidden=HIDDEN)
        for _ in range(2):
            ts, _ = step(ts)
    path = JC.save_checkpoint(str(tmp_path_factory.mktemp("jck")), ts)
    return ts, step, path


def test_decoder_matches_msgpack_on_a_train_state(jax_run):
    raw = open(jax_run[2], "rb").read()
    got = unpackb(raw)
    _same(got, _restore(raw))
    assert got["key"].dtype == np.uint32 and got["step"].dtype == np.int32
    assert set(got["opt_state"]["1"]["0"]) == {"count", "mu", "nu"}


VALUES = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32,
          2**63, -1, -32, -33, -129, -2**15 - 1, -2**40, 1.5, -0.25,
          "", "x" * 31, "y" * 32, "z" * 300, "é" * 40000, b"", b"\x00" * 300,
          b"b" * 70000, [], [1, [2, [3]]], list(range(16)),
          list(range(70000)), {}, {"a": {"b": None}},
          {str(i): i for i in range(16)},
          {"arr": np.arange(6, dtype=np.int16).reshape(2, 3),
           "f": np.ones((0, 4), np.float64), "u": np.uint32([1, 2**32 - 1]),
           "b": np.array([True, False]), "s": np.float32(2.5),
           "i": np.int64(-7)}]


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_decoder_matches_msgpack_on_values(i):
    raw = flax.serialization.msgpack_serialize(VALUES[i])
    got = unpackb(raw)
    want = _restore(raw)
    if isinstance(want, dict):
        _same(got, want)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("raw, match", [
    (reference.packb(reference.ExtType(2, b"\x92\x01\x02")), "extension"),
    (reference.packb(reference.ExtType(
        1, reference.packb(([2], "int3", b"\x00" * 4)))), "dtype"),
    (reference.packb({"__msgpack_chunked_array__": True}), "chunked"),
    (reference.packb([1, 2, 3])[:-1], "truncated"),
    (reference.packb(1) + b"\x01", "trailing"),
    (b"\xc1", "starts no"),
], ids=["ext2", "unknown-dtype", "chunked", "truncated", "trailing", "c1"])
def test_decoder_refuses(raw, match):
    with pytest.raises(ValueError, match=match):
        unpackb(raw)


def _np(tree):
    return jax.tree.map(np.array, tree)


def test_resume_from_a_jax_checkpoint(jax_run):
    jts, step, path = jax_run
    cfg = T.CONFIGS[NAME]
    template = T.init_train_state(0, cfg, hidden=HIDDEN, device="cpu")
    ts = ckpt.restore_checkpoint(path, template)
    assert ts.step == 2
    np.testing.assert_array_equal(
        ts.key.numpy(), np.asarray(jax.random.key_data(jts.key)))
    adam = jts.opt_state[1][0]
    for part, module in (("actor", ts.actor), ("critic", ts.critic)):
        want = flax_to_state_dict(_np(jts.params[part]))
        mu = flax_to_state_dict(_np(adam.mu[part]))
        nu = flax_to_state_dict(_np(adam.nu[part]))
        for name, p in module.named_parameters():
            st = ts.opt.state[p]
            np.testing.assert_array_equal(p.detach().numpy(),
                                          want[name].numpy())
            np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                          mu[name].numpy())
            np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                          nu[name].numpy())
            assert float(st["step"]) == int(adam.count) == 2
    with jax.default_matmul_precision("highest"):
        jts3, m_j = step(jts)
    ts3, m = T.make_train_step(cfg, batch=B, hidden=HIDDEN,
                               device="cpu")(ts)
    for k in ("reward", "C", "P", "S"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["loss_critic"]),
                               float(m_j["loss_critic"]), rtol=1e-5)
    for k in ("loss_actor", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-4,
                                   err_msg=k)
    assert ts3.step == int(jts3.step) == 3
    np.testing.assert_array_equal(
        ts3.key.numpy(), np.asarray(jax.random.key_data(jts3.key)))


def test_restored_actor_greedy_matches_jax(jax_run):
    jts, _, path = jax_run
    cfg, jcfg = T.CONFIGS[NAME], JCONFIGS[NAME]
    ts = ckpt.restore_checkpoint(
        path, T.init_train_state(0, cfg, hidden=HIDDEN, device="cpu"))
    inst_j = jax_sample_batch(jax.random.key(9), 12, jcfg)
    with jax.default_matmul_precision("highest"):
        want = jax_pack(inst_j, jcfg, jts.params["actor"], HIDDEN,
                        policy="greedy")
    got = T.pack(Instance(*_np(inst_j)), cfg, ts.actor, policy="greedy",
                 device="cpu")
    np.testing.assert_array_equal(got.actions, np.asarray(want.actions))
    for f in ("heightmap", "placements", "packed", "t"):
        np.testing.assert_array_equal(getattr(got.states, f),
                                      np.asarray(getattr(want.states, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.rewards, np.asarray(want.rewards),
                               rtol=0, atol=1e-6)
