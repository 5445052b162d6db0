"""Rolling configs on the CPU: the port's windowed head, its rollouts and its
windowed replay vs tapnet_tpu's.

Three configs: a small rolling one (12 blocks, window 4, rotation), a
two-limb one (34 blocks, window 6) and CONFIGS["2d-rolling"] (50 blocks,
window 10, ragged block counts) at a small batch; hidden 32, the same
weights on both sides (flax init_params through convert.py), the JAX side
jitted at matmul precision "highest".

- `head_ctx` on a subset of the tokens and the windowed head
  (`_make_windowed_head`) vs the JAX functions, atol 1e-6; the windowed
  head vs the port's full head at the window's positions, atol 1e-6;
- the general, step-fused and actor-fused (plain K2) rollouts vs the JAX
  general path: flags, heightmaps, masks, actions and the final state
  bit-equal, logp within 1e-4;
- the windowed replay vs `jax.value_and_grad` of the JAX windowed replay
  (value rtol 1e-5, each gradient within 5e-5 of its leaf's max), vs the
  port's general replay, and cut into slabs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.config import TAPConfig as JTAPConfig
from tapnet_tpu.env.sampler import sample_batch as jax_sample_batch
from tapnet_tpu.models.features import static_tokens as jax_static_tokens
from tapnet_tpu.models.tapnet import TAPNetActor as JActor
from tapnet_tpu.models.tapnet import init_params
from tapnet_tpu.train import rollout as JRO
from tapnet_torch.config import CONFIGS, TAPConfig
from tapnet_torch.convert import actor_from_flax, flax_to_state_dict
from tapnet_torch.models.features import (heightmap_grid, merge_tokens,
                                          static_tokens, tokens_from_flags)
from tapnet_torch.train import rollout as RO
from tapnet_torch.types import Instance

HIDDEN = 32
SMALL = dict(num_blocks=12, min_blocks=6, container_width=8,
             container_height=12, target_width=8, window=4, allow_rot=True)
TWO_LIMB = dict(num_blocks=34, min_blocks=20, container_width=8,
                container_height=40, target_width=8, window=6)
BATCH = {"rolling-small": 16, "two-limb": 8, "2d-rolling": 8}


def configs(name):
    if name == "2d-rolling":
        return JCONFIGS[name], CONFIGS[name]
    kw = SMALL if name == "rolling-small" else TWO_LIMB
    return JTAPConfig(**kw), TAPConfig(**kw)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.cache
def setup(name, seed=7):
    """Weights, instances, keys and the JAX general rollout of a config."""
    jcfg, cfg = configs(name)
    B = BATCH[name]
    params = jax.jit(init_params, static_argnums=(1, 2))(
        jax.random.key(seed), jcfg, HIDDEN)["actor"]
    instances = jax.jit(jax_sample_batch, static_argnums=(1, 2))(
        jax.random.key(seed + 1), B, jcfg)
    jkeys = jax.random.split(jax.random.key(seed + 2), B)
    with jax.default_matmul_precision("highest"):
        states, record, logp = jax.jit(
            lambda p, i, k: JRO.rollout_batch_record(
                p, i, k, jcfg, hidden=HIDDEN, step_kernel=False,
                actor_kernel=False))(params, instances, jkeys)
    actor = actor_from_flax(jax.tree.map(np.asarray, params), cfg, HIDDEN)
    tkeys = torch.from_numpy(
        np.asarray(jax.random.key_data(jkeys)).astype(np.int64))
    return dict(jcfg=jcfg, cfg=cfg, params=params, instances=instances,
                states=states, record=record, logp=logp, actor=actor,
                inst=Instance(*(_t(x) for x in instances)), keys=tkeys,
                rec=RO.RolloutRecord(*(_t(x) for x in record)))


NAMES = ["rolling-small", "two-limb", "2d-rolling"]


@pytest.mark.parametrize("name", ["rolling-small", "two-limb"])
def test_head_ctx_matches_jax(name):
    """head_ctx on 5 of the T tokens, ctx and dsum from a numpy seed."""
    s = setup(name)
    jcfg, cfg, B = s["jcfg"], s["cfg"], BATCH[name]
    rng = np.random.default_rng(3)
    Tk, C, W, D = 5, cfg.num_containers, cfg.target_width, cfg.target_depth
    se = rng.normal(size=(B, Tk, HIDDEN)).astype(np.float32)
    dyn = rng.random(size=(B, Tk, 8)).astype(np.float32)
    hm = rng.random(size=(B, C, W, D, 1)).astype(np.float32)
    prev = rng.integers(-1, cfg.num_actions, size=(B,)).astype(np.int32)
    ctx = rng.normal(size=(B, HIDDEN)).astype(np.float32)
    dsum = rng.random(size=(B, 8)).astype(np.float32)
    jactor = JActor(jcfg, HIDDEN)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.vmap(lambda *a: jactor.apply(
            s["params"], *a, method=JActor.head_ctx)))(
                se, dyn, hm, prev, ctx, dsum)
    with torch.no_grad():
        got = s["actor"].head_ctx(*(_t(x) for x in
                                    (se, dyn, hm, prev, ctx, dsum)))
    assert got.shape == (B, Tk * C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_windowed_head_matches_jax(name):
    """The windowed head at a mid-rollout step of the JAX record."""
    s = setup(name)
    jcfg, cfg = s["jcfg"], s["cfg"]
    k = cfg.num_blocks // 3
    flags, hm = s["record"].flags[k], s["record"].heightmap[k]
    prev = s["record"].action[k - 1]
    t_frac = np.float32(k) / cfg.num_blocks
    jactor = JActor(jcfg, HIDDEN)

    def jax_head(params, instances):
        static = jax.vmap(lambda i: jax_static_tokens(i, jcfg))(instances)
        emb = jactor.apply(params, static, method=JActor.embed_static)
        head = JRO._make_windowed_head(jactor, params, instances, static,
                                       emb, jcfg, HIDDEN, jnp.float32)
        return head(flags, hm, prev, t_frac)

    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax_head)(s["params"], s["instances"])
    actor, inst = s["actor"], s["inst"]
    with torch.no_grad():
        static = static_tokens(inst, cfg)
        emb = actor.embed_static(static)
        head = RO._make_windowed_head(actor, inst, static, emb, cfg)
        got = head(_t(flags), _t(hm), _t(prev), float(t_frac))
        # and the port's full head at the window's positions
        dynamic = merge_tokens(static, tokens_from_flags(
            _t(flags), torch.tensor(float(t_frac)), cfg))
        full = actor.head(emb, dynamic, heightmap_grid(_t(hm), cfg),
                          _t(prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    win = ((_t(flags).int() >> 3) & 1).bool()
    at = win[:, :, None].expand(-1, -1, cfg.num_rot * cfg.num_containers
                                ).reshape(got.shape)
    assert RO._use_windowed_head(cfg) and at.any() and not at.all()
    np.testing.assert_allclose(got[at].numpy(), full[at].numpy(), atol=1e-6)
    assert (got[~at] == 0).all()


@pytest.mark.parametrize("path", ["general", "step_kernel", "actor_kernel"])
@pytest.mark.parametrize("name", NAMES)
def test_rolling_rollouts_match_jax(name, path):
    s = setup(name)
    kw = {} if path == "general" else {path: True}
    s_t, r_t, lp_t = RO.rollout_batch_record(s["actor"], s["inst"],
                                             s["keys"], s["cfg"], **kw)
    for f in r_t._fields:
        np.testing.assert_array_equal(getattr(r_t, f).numpy(),
                                      np.asarray(getattr(s["record"], f)),
                                      err_msg=f)
    for f in s_t._fields:
        np.testing.assert_array_equal(getattr(s_t, f).numpy(),
                                      np.asarray(getattr(s["states"], f)),
                                      err_msg=f)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(s["logp"]),
                               rtol=1e-4, atol=1e-4)
    if name == "2d-rolling":   # ragged block counts: padding steps are -1
        assert (r_t.action == -1).any()


def _port_value_and_grad(actor, inst, rec, cfg, **kw):
    actor.zero_grad(set_to_none=True)
    lp = RO.replay_logp_sum(actor, inst, rec, cfg, **kw)
    lp.sum().backward()
    return lp.detach(), {n: p.grad.clone() for n, p in
                         actor.named_parameters()}


def _assert_close_scaled(got, want, atol=5e-5):
    assert set(want) == set(got)
    for n, w in want.items():
        scale = float(w.abs().max()) + 1e-9
        np.testing.assert_allclose(got[n].numpy() / scale,
                                   w.numpy() / scale, atol=atol, err_msg=n)


@pytest.mark.parametrize("name", ["rolling-small", "two-limb"])
def test_windowed_replay_matches_jax(name):
    s = setup(name)
    with jax.default_matmul_precision("highest"):
        val, grads = jax.jit(jax.value_and_grad(
            lambda p: JRO.replay_logp_sum(
                p, s["instances"], s["record"], s["jcfg"], hidden=HIDDEN,
                kernel=False, windowed=True).sum()))(s["params"])
    lp, got = _port_value_and_grad(s["actor"], s["inst"], s["rec"],
                                   s["cfg"], kernel=False)
    np.testing.assert_allclose(float(lp.sum()), float(val), rtol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(s["logp"]),
                               rtol=1e-4, atol=1e-4)
    _assert_close_scaled(got, flax_to_state_dict(
        jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("other", [dict(windowed=False), dict(chunk=3)])
def test_windowed_replay_matches_general_and_slabs(other):
    """The windowed replay vs the general one (all tokens, the window
    through flags and mask) and vs itself cut into checkpointed slabs."""
    s = setup("rolling-small")
    args = (s["actor"], s["inst"], s["rec"], s["cfg"])
    vw, gw = _port_value_and_grad(*args, kernel=False)
    vo, go = _port_value_and_grad(*args, kernel=False, **other)
    np.testing.assert_allclose(vo.numpy(), vw.numpy(), rtol=1e-5, atol=1e-5)
    _assert_close_scaled(go, gw)


def test_windowed_replay_refuses_other_configs():
    s = setup("rolling-small")
    with pytest.raises(ValueError, match="rolling window"):
        RO.replay_logp_sum(s["actor"], s["inst"], s["rec"],
                           CONFIGS["2d-basic"], kernel=False, windowed=True)
    assert not RO._use_windowed_head(CONFIGS["2d-basic"])
    assert not RO._use_windowed_head(CONFIGS["multi-container-capped"])
    assert RO._use_windowed_head(CONFIGS["2d-rolling"])
