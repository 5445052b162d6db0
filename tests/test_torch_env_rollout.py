"""The port's heuristic rollouts against tapnet_tpu's.

The same instances (JAX sampler) and per-instance keys go through the
jitted `tapnet_tpu.env.core.rollout_batch` and through the port's
`env.core.rollout_batch` (the general path) and
`ops.env.fused_rollout_batch` (on CPU tensors: the plain version the CUDA
kernel is held to on the card), for `first` and `random`. Integer outputs
(actions, heightmaps, placements, packed, t, reward terms) bit-equal,
rewards within 1e-6. Two cases are also held to the JAX whole-rollout kernel
in interpret mode. The entry points: `pack(policy="first"|"random",
device="cpu")` against `tapnet_tpu.pack(..., prefer_fused=False)` and
`evaluate(baselines=True, device="cpu")` against the JAX `evaluate`.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tapnet_tpu
from tapnet_tpu.config import TAPConfig as JTAPConfig
from tapnet_tpu.env import core as JE
from tapnet_tpu.env.sampler import sample_batch as jax_sample_batch
from tapnet_tpu.models.tapnet import init_params as jax_init_params
from tapnet_tpu.ops import pallas_env as JPE
from tapnet_tpu.train import trainer as JT
import tapnet_torch
from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.convert import actor_from_flax
from tapnet_torch.env import core as E
from tapnet_torch.ops import env as OE
from tapnet_torch.train import trainer as T
from tapnet_torch.types import Instance

CUBE6 = dict(dim=3, container_width=6, container_depth=6, container_height=6,
             target_width=6, target_depth=6)
# name -> (config kwargs or the name of one of CONFIGS, batch)
CASES = {
    "2d-basic": ("2d-basic", 24),
    "2d-rot": ("2d-rot", 12),
    "3d-basic": ("3d-basic", 12),
    "multi-container": ("multi-container", 12),
    "multi-container-capped": ("multi-container-capped", 12),
    "2d-rot-lb-hard": (dict(allow_rot=True, reward_type="C+P+S-lb-hard"), 12),
    "2d-capped-tight": (dict(target_height=3, reward_type="C+P-lb-soft"), 20),
    "2d-capped-3c": (dict(container_height=24, target_height=5,
                          num_containers=3, allow_rot=True), 12),
    "2d-window": (dict(num_blocks=16, min_blocks=8, container_width=8,
                       container_height=16, target_width=8, window=4,
                       allow_rot=True), 12),
    "2d-mcs-soft": (dict(reward_type="C+P+S-mcs-soft"), 12),
    "3d-mcs-hard-2c": (dict(**CUBE6, num_blocks=8, min_blocks=8,
                            num_containers=2,
                            reward_type="C+P+S-mcs-hard"), 12),
}


def _configs(name):
    spec, B = CASES[name]
    if isinstance(spec, str):
        return tapnet_torch.CONFIGS[spec], tapnet_tpu.CONFIGS[spec], B
    return TAPConfig(**spec), JTAPConfig(**spec), B


def _inputs(jcfg, B, seed):
    """A JAX instance batch with its per-instance keys, and both as the
    port's tensors."""
    key = jax.random.key(seed)
    jinst = jax_sample_batch(key, B, jcfg)
    jkeys = jax.random.split(key, B)
    tinst = Instance(*(torch.from_numpy(np.array(x)) for x in jinst))
    tkeys = torch.from_numpy(
        np.asarray(jax.random.key_data(jkeys)).astype(np.int64))
    return jinst, jkeys, tinst, tkeys


def _assert_rollout_equal(got, want, tinst, jinst, cfg, jcfg, label):
    s_t, a_t, r_t = got
    s_j, a_j, r_j = want
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j),
                                  err_msg=f"{label} actions")
    for f in s_t._fields:
        np.testing.assert_array_equal(getattr(s_t, f).numpy(),
                                      np.asarray(getattr(s_j, f)),
                                      err_msg=f"{label} {f}")
    terms_j = jax.vmap(lambda s, i: JE.reward_terms(s, i, jcfg))(s_j, jinst)
    for g, w in zip(E.reward_terms(s_t, tinst, cfg), terms_j):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{label} reward terms")
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0,
                               atol=1e-6, err_msg=f"{label} rewards")


@pytest.mark.parametrize("policy", ["first", "random"])
@pytest.mark.parametrize("name", list(CASES))
def test_rollout_batch_matches_jax(name, policy):
    cfg, jcfg, B = _configs(name)
    jinst, jkeys, tinst, tkeys = _inputs(jcfg, B, seed=9)
    want = JE.rollout_batch(jinst, jkeys, jcfg, policy=policy)
    assert OE.eligible(cfg)
    _assert_rollout_equal(E.rollout_batch(tinst, tkeys, cfg, policy), want,
                          tinst, jinst, cfg, jcfg, "rollout_batch")
    _assert_rollout_equal(OE.fused_rollout_batch(tinst, tkeys, cfg, policy),
                          want, tinst, jinst, cfg, jcfg,
                          "fused_rollout_batch")
    actions = np.asarray(want[1])
    if cfg.target_height == 0:
        # every real block placed; the no-op steps are the padding's
        assert np.array_equal((actions >= 0).sum(1),
                              np.asarray(jinst.n_total))
    elif name == "2d-capped-tight":
        assert (actions < 0).any()      # the cap strands blocks


@pytest.mark.parametrize("name", ["2d-rot", "2d-rot-lb-hard"])
def test_fused_rollout_batch_matches_jax_kernel(name):
    """Against the JAX whole-rollout kernel, run as its own tests run it on
    the CPU (interpret mode)."""
    cfg, jcfg, B = _configs(name)
    jinst, jkeys, tinst, tkeys = _inputs(jcfg, B, seed=11)
    want = JPE.fused_rollout_batch(jinst, jkeys, jcfg, policy="random",
                                   interpret=True)
    _assert_rollout_equal(OE.fused_rollout_batch(tinst, tkeys, cfg, "random"),
                          want, tinst, jinst, cfg, jcfg,
                          "fused_rollout_batch")


def test_policy_bits_and_select_action():
    """The draws are bits(fold_in(key_b, t)); select_action takes the
    (draw mod count)-th feasible action and -1 on an empty mask."""
    cfg = tapnet_torch.CONFIGS["2d-basic"]
    jkeys = jax.random.split(jax.random.key(4), 6)
    tkeys = torch.from_numpy(
        np.asarray(jax.random.key_data(jkeys)).astype(np.int64))
    bits = E.policy_bits(tkeys, cfg, "random")
    want = jax.vmap(lambda k: jax.vmap(
        lambda t: jax.random.bits(jax.random.fold_in(k, t),
                                  dtype=np.uint32))(
        np.arange(cfg.num_blocks, dtype=np.int32)))(jkeys)
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(want).astype(np.int64))
    assert not E.policy_bits(tkeys, cfg, "first").any()
    with pytest.raises(ValueError):
        E.policy_bits(tkeys, cfg, "greedy")

    mask = torch.tensor([[0, 1, 0, 1, 1], [0, 0, 0, 0, 0], [1, 0, 0, 0, 1]],
                        dtype=torch.bool)
    draws = torch.tensor([2**32 - 1, 5, 3], dtype=torch.int64)
    # (2^32 - 1) % 3 = 0 -> first of [1, 3, 4]; empty; 3 % 2 = 1 -> 4
    assert E.select_action(mask, draws).tolist() == [1, -1, 4]
    assert E.select_action(mask, torch.zeros(3, dtype=torch.int64)
                           ).tolist() == [1, -1, 0]


def test_rollout_kernel_refuses_cpu_tensors_and_oversize():
    """Only a CPU tensor sends the wrapper to the plain version: the kernel
    launcher itself takes CUDA tensors or raises, and configs beyond the
    kernel's per-thread sizes are refused, never rerouted."""
    cfg = tapnet_torch.CONFIGS["2d-basic"]
    inst = tapnet_torch.env.sampler.sample_batch(R.key(1), 4, cfg)
    keys = R.split(R.key(1), 4)
    ops = OE.rollout_operands(inst, E.policy_bits(keys, cfg, "random"), cfg)
    N = cfg.num_blocks
    assert [tuple(o.shape) for o in ops] == [(N, 4)] * 5 + [(4,), (N, 4)]
    assert all(o.dtype == torch.int32 for o in ops)
    with pytest.raises(ValueError, match="CUDA"):
        OE.rollout_kernel(ops, cfg)
    big = TAPConfig(dim=3, container_width=20, container_depth=20,
                    container_height=20, target_width=20, target_depth=20)
    assert not OE.eligible(big)
    with pytest.raises(NotImplementedError):
        OE.rollout_kernel(ops, big)
    assert all(OE.eligible(c) for c in tapnet_torch.CONFIGS.values())
    assert OE.fused_rollout_batch.launches == 0


# --------------------------------------------------------------------- #
# entry points

@pytest.mark.parametrize("policy", ["first", "random"])
def test_pack_heuristic_matches_jax(policy):
    """pack() on a capped two-container 3D config: stranded blocks and all
    (2d-basic is held in tests/test_torch_pack.py)."""
    name = "multi-container-capped"
    cfg, jcfg = tapnet_torch.CONFIGS[name], tapnet_tpu.CONFIGS[name]
    B = 10
    jinst = jax_sample_batch(jax.random.key(31), B, jcfg)
    inst_np = Instance(*(np.array(x) for x in jinst))
    jkey = jax.random.key(17)
    tkey = torch.from_numpy(
        np.asarray(jax.random.key_data(jkey)).astype(np.int64))
    want = tapnet_tpu.pack(jinst, jcfg, policy=policy, key=jkey,
                           prefer_fused=False)
    got = tapnet_torch.pack(inst_np, cfg, policy=policy, key=tkey,
                            device="cpu")
    np.testing.assert_array_equal(got.actions, np.asarray(want.actions))
    for f in ("heightmap", "placements", "packed", "t"):
        np.testing.assert_array_equal(getattr(got.states, f),
                                      np.asarray(getattr(want.states, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.rewards, np.asarray(want.rewards), rtol=0,
                               atol=1e-6)
    assert len(got) == B
    for i in range(B):
        assert ([dataclasses.astuple(s) for s in got.steps(i)]
                == [dataclasses.astuple(s) for s in want.steps(i)])
        assert got.complete(i) == want.complete(i)
    # an int seed is the same key
    again = tapnet_torch.pack(inst_np, cfg, policy=policy, key=17,
                              device="cpu")
    np.testing.assert_array_equal(again.actions, got.actions)


def test_evaluate_baselines_matches_jax():
    name, hidden = "2d-basic", 32
    cfg, jcfg = tapnet_torch.CONFIGS[name], tapnet_tpu.CONFIGS[name]
    params = jax_init_params(jax.random.key(2), jcfg, hidden)
    actor = actor_from_flax(jax.tree.map(np.asarray, params["actor"]), cfg,
                            hidden)
    with jax.default_matmul_precision("highest"):
        want = JT.evaluate(params, jcfg,
                           JT.TrainLoopConfig(valid_batch=16, hidden=hidden),
                           baselines=True)
    got = T.evaluate(actor, cfg,
                     T.TrainLoopConfig(valid_batch=16, hidden=hidden),
                     baselines=True, device="cpu")
    assert set(got) == set(want)
    assert {"random_reward", "first_reward"} <= set(got)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    without = T.evaluate(actor, cfg,
                         T.TrainLoopConfig(valid_batch=16, hidden=hidden),
                         device="cpu")
    assert "random_reward" not in without
