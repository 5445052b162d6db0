"""Port replay (plain versions of the K5 kernels) vs tapnet_tpu's replay.

The port's `replay_logp_sum(kernel=True)` on CPU tensors runs the plain
forward and backward of the replay kernels through `ReplayLogp`, the
autograd Function the card runs with the CUDA kernels. On records of JAX
rollouts with the same weights (flax init_params through convert.py) its
value and every actor-parameter gradient, the token encoder included
(through embed_static_T), are held to `jax.value_and_grad` of the JAX
replay: value rtol 1e-5; each gradient within atol 5e-5 of its leaf's max
magnitude (accumulation order, as tests/test_pallas_replay.py scales it).
The JAX side runs at matmul precision "highest" (exact f32 dots).

Rolling configs (a 12-block window-4 config with rotation, a 34-block
window-6 config) go through the step-grid schedule: the plain step-grid
forward and backward are held to `jax.value_and_grad` of the JAX replay in
the same way, to the Pallas step-grid kernels in interpret mode (12-block
config, batch 128), to the plain monolithic version on 2d-basic, and to the
port's windowed replay.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.config import TAPConfig as JTAPConfig
from tapnet_tpu.env.sampler import sample_batch
from tapnet_tpu.models.tapnet import init_params
from tapnet_tpu.train import rollout as JRO
from tapnet_torch.config import CONFIGS, TAPConfig
from tapnet_torch.convert import actor_from_flax, flax_to_state_dict
from tapnet_torch.ops import replay as RP
from tapnet_torch.train import rollout as RO
from tapnet_torch.types import Instance

PADDED = dict(num_blocks=8, min_blocks=4, container_width=8,
              container_height=8, target_width=8, allow_rot=True)
CUSTOM = {
    "padded": PADDED,
    "rolling-small": dict(num_blocks=12, min_blocks=6, container_width=8,
                          container_height=12, target_width=8, window=4,
                          allow_rot=True),
    "two-limb": dict(num_blocks=34, min_blocks=20, container_width=8,
                     container_height=40, target_width=8, window=6),
}


@functools.cache
def _setup(name, B=64, hidden=32, seed=3):
    if name in CUSTOM:
        jcfg, cfg = JTAPConfig(**CUSTOM[name]), TAPConfig(**CUSTOM[name])
    else:
        jcfg, cfg = JCONFIGS[name], CONFIGS[name]
    key = jax.random.key(seed)
    params = jax.jit(init_params, static_argnums=(1, 2))(
        key, jcfg, hidden)["actor"]
    instances = jax.jit(sample_batch, static_argnums=(1, 2))(key, B, jcfg)
    keys = jax.random.split(jax.random.key(seed + 4), B)
    with jax.default_matmul_precision("highest"):
        _, record, _ = jax.jit(lambda p, i, k: JRO.rollout_batch_record(
            p, i, k, jcfg, hidden=hidden, step_kernel=False,
            actor_kernel=False, with_logp=False))(params, instances, keys)
    t = lambda x: torch.from_numpy(np.array(x))
    actor = actor_from_flax(jax.tree.map(np.asarray, params), cfg, hidden)
    return (jcfg, cfg, params, instances, record, actor,
            Instance(*(t(x) for x in instances)),
            RO.RolloutRecord(*(t(x) for x in record)))


def _port_value_and_grad(actor, inst, rec, cfg, temperature=1.0, **kw):
    actor.zero_grad(set_to_none=True)
    lp = RO.replay_logp_sum(actor, inst, rec, cfg, temperature, **kw)
    lp.sum().backward()
    return lp.detach(), {n: p.grad.clone() for n, p in
                         actor.named_parameters()}


def _assert_grads_close(want_tree, got, atol=5e-5):
    want = flax_to_state_dict(jax.tree.map(np.asarray, want_tree))
    assert set(want) == set(got)
    for name, w in want.items():
        scale = float(w.abs().max()) + 1e-9
        np.testing.assert_allclose(got[name].numpy() / scale,
                                   w.numpy() / scale, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("name,temperature", [
    ("2d-basic", 1.0), ("2d-rot", 1.0), ("multi-container-capped", 1.0),
    ("padded", 0.7), ("rolling-small", 1.0), ("two-limb", 0.7)])
def test_plain_kernels_match_jax_replay(name, temperature):
    jcfg, cfg, params, instances, record, actor, inst, rec = (
        _setup(name, B=16) if name == "two-limb" else _setup(name))
    assert RP._steps_grid(cfg) == (name in ("rolling-small", "two-limb"))
    if name in CUSTOM:
        assert (rec.action == -1).any()
    with jax.default_matmul_precision("highest"):
        vals, grads = jax.jit(jax.value_and_grad(
            lambda p: JRO.replay_logp_sum(
                p, instances, record, jcfg, hidden=32,
                temperature=temperature, kernel=False).sum()))(params)
    lp, got = _port_value_and_grad(actor, inst, rec, cfg, temperature,
                                   kernel=True)
    np.testing.assert_allclose(float(lp.sum()), float(vals), rtol=1e-5)
    _assert_grads_close(grads, got)


def test_plain_kernels_match_jax_kernels_interpret():
    """Against the Pallas replay kernels themselves (interpret mode), per
    instance: 2d-basic, batch 128, hidden 32."""
    jcfg, cfg, params, instances, record, actor, inst, rec = _setup(
        "2d-basic", B=128)
    with jax.default_matmul_precision("highest"):
        f = lambda p: JRO.replay_logp_sum(p, instances, record, jcfg,
                                          hidden=32, kernel=True,
                                          interpret=True)
        lp_j, vjp = jax.jit(lambda p: jax.vjp(f, p))(params)
        grads = vjp(jnp.ones_like(lp_j))[0]
    lp, got = _port_value_and_grad(actor, inst, rec, cfg, kernel=True)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-5,
                               atol=1e-5)
    _assert_grads_close(grads, got)


def test_plain_step_grid_matches_jax_step_grid_interpret():
    """Against the Pallas step-grid kernels (interpret mode), per instance:
    the 12-block rolling config, batch 128, hidden 32."""
    jcfg, cfg, params, instances, record, actor, inst, rec = _setup(
        "rolling-small", B=128)
    with jax.default_matmul_precision("highest"):
        f = lambda p: JRO.replay_logp_sum(p, instances, record, jcfg,
                                          hidden=32, kernel=True,
                                          interpret=True)
        lp_j, vjp = jax.jit(lambda p: jax.vjp(f, p))(params)
        grads = vjp(jnp.ones_like(lp_j))[0]
    lp, got = _port_value_and_grad(actor, inst, rec, cfg, kernel=True)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-5,
                               atol=1e-5)
    _assert_grads_close(grads, got)


@pytest.mark.parametrize("name", ["2d-basic", "rolling-small"])
def test_plain_kernels_match_jax_kernels_interpret_hidden_256(name):
    """Hidden 256, the widest the CUDA kernels cover (their head runs in
    two passes of 16 instances there): against the Pallas kernels in
    interpret mode, per instance, batch 128: the monolithic schedule on
    2d-basic, the step-grid one on the 12-block rolling config."""
    hidden = 256
    jcfg, cfg, params, instances, record, actor, inst, rec = _setup(
        name, B=128, hidden=hidden)
    assert RP.eligible(cfg, hidden) and RP.eligible(cfg, hidden,
                                                    torch.bfloat16)
    assert RP._steps_grid(cfg) == (name == "rolling-small")
    with jax.default_matmul_precision("highest"):
        f = lambda p: JRO.replay_logp_sum(p, instances, record, jcfg,
                                          hidden=hidden, kernel=True,
                                          interpret=True)
        lp_j, vjp = jax.jit(lambda p: jax.vjp(f, p))(params)
        grads = vjp(jnp.ones_like(lp_j))[0]
    lp, got = _port_value_and_grad(actor, inst, rec, cfg, kernel=True)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-5,
                               atol=1e-5)
    _assert_grads_close(grads, got)


def _operands(name, B=64):
    _, cfg, _, _, _, actor, inst, rec = _setup(name, B=B)
    with torch.no_grad():
        (flags, hms, masks, acts, statp, statm), se, ctx, params = \
            RO.replay_operands(actor, inst, rec, cfg, grad=False)
    return cfg, (flags, hms, masks, acts, se, ctx, statp, statm, params)


@pytest.mark.parametrize("chunks", [1, 3, 10])
def test_plain_step_grid_matches_plain_monolithic(chunks, monkeypatch):
    """The step-grid schedule forced onto 2d-basic: the same value and
    gradients as the monolithic one, for any number of step chunks (the
    count a larger batch or another card would get from `step_chunks`)."""
    cfg, ops = _operands("2d-basic")
    monkeypatch.setattr(RP, "step_chunks", lambda cfg, B: chunks)
    so = ops[:4] + (RP._prev_rows(ops[3]),) + ops[4:]
    dlp = torch.linspace(-1.0, 1.0, ops[3].shape[1])
    np.testing.assert_allclose(
        RP.replay_logp_fwd_steps(*so, cfg).numpy(),
        RP.replay_logp_fwd(*ops, cfg).numpy(), rtol=1e-6, atol=1e-6)
    want = RP.replay_logp_bwd(dlp, *ops, cfg)
    got = RP.replay_logp_bwd_steps(dlp, *so, cfg)
    for a, w in zip([got[0], got[1], *got[2]], [want[0], want[1], *want[2]]):
        scale = float(w.abs().max()) + 1e-9
        np.testing.assert_allclose(a.numpy() / scale, w.numpy() / scale,
                                   atol=5e-6)


def test_step_grid_replay_matches_windowed_replay():
    """Rolling: the kernel route (all tokens scored, the rest masked) and
    the windowed replay (the window's tokens only) give the same value and
    gradients."""
    _, cfg, _, _, _, actor, inst, rec = _setup("rolling-small")
    vk, gk = _port_value_and_grad(actor, inst, rec, cfg, kernel=True)
    vw, gw = _port_value_and_grad(actor, inst, rec, cfg, kernel=False)
    np.testing.assert_allclose(vw.numpy(), vk.numpy(), rtol=1e-5, atol=1e-5)
    for n in gk:
        scale = float(gk[n].abs().max()) + 1e-9
        np.testing.assert_allclose(gw[n].numpy() / scale,
                                   gk[n].numpy() / scale, atol=5e-5,
                                   err_msg=n)


def test_primal_mode_returns_logp0_with_identical_gradients():
    _check_primal_mode("2d-basic")


def test_primal_mode_step_grid():
    _check_primal_mode("rolling-small")


def _check_primal_mode(name):
    _, cfg, _, _, _, actor, inst, rec = _setup(name)
    B = rec.action.shape[1]
    logp0 = torch.linspace(-3.0, -1.0, B)
    v1, g1 = _port_value_and_grad(actor, inst, rec, cfg, kernel=True)
    v0, g0 = _port_value_and_grad(actor, inst, rec, cfg, kernel=True,
                                  logp0=logp0)
    assert torch.equal(v0, logp0)
    for n in g1:
        assert torch.equal(g0[n], g1[n]), n
    assert not torch.equal(v1, logp0)


@pytest.mark.parametrize("chunk", [0, 2])
def test_general_replay_matches_plain_kernels(chunk):
    """The port's general replay (autograd through TAPNetActor.head over
    all N steps; chunk=2 with checkpointed chunks) vs its plain K5."""
    _, cfg, _, _, _, actor, inst, rec = _setup("2d-rot")
    vk, gk = _port_value_and_grad(actor, inst, rec, cfg, kernel=True)
    vg, gg = _port_value_and_grad(actor, inst, rec, cfg, kernel=False,
                                  chunk=chunk)
    np.testing.assert_allclose(vg.numpy(), vk.numpy(), rtol=1e-5, atol=1e-5)
    for n in gk:
        scale = float(gk[n].abs().max()) + 1e-9
        np.testing.assert_allclose(gg[n].numpy() / scale,
                                   gk[n].numpy() / scale, atol=5e-5,
                                   err_msg=n)


def _smem_before(cfg, h, steps):
    """The backward block's shared memory before the tensor-core plan: both
    dtypes took the float32 plan, which is unchanged."""
    return RP.smem_bytes(cfg, h, True, steps, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [32, 64, 96, 128, 160, 192, 224, 256])
def test_kernel_coverage(h, dtype):
    """Every shipped config is covered at every hidden width and in both
    dtypes, rolling and N > 31 by the step-grid schedule; every case covered
    before the tensor-core plan stays covered (the bfloat16 plan is no larger
    than the float32 one), and `eligible` agrees with the plan's mirror; N =
    63 and the monolithic schedule at N > 31 are refused."""
    for name, cfg in CONFIGS.items():
        steps = RP._steps_grid(cfg)
        assert steps == (name == "2d-rolling")
        smem = RP.smem_bytes(cfg, h, True, dtype=dtype)
        assert smem <= _smem_before(cfg, h, steps), name
        if _smem_before(cfg, h, steps) <= RP.SMEM_LIMIT:
            assert RP.eligible(cfg, h, dtype), name
        assert RP.eligible(cfg, h, dtype) == (smem <= RP.SMEM_LIMIT), name
        assert RP.smem_bytes(cfg, h, False, dtype=dtype) <= smem, name
        RP._check_cfg(cfg, h, steps, dtype)
    two_limb = TAPConfig(**CUSTOM["two-limb"])
    assert RP.eligible(two_limb, h, dtype) and RP._steps_grid(two_limb)
    with pytest.raises(NotImplementedError, match="monolithic"):
        RP._check_cfg(two_limb, h, False, dtype)
    too_many = TAPConfig(num_blocks=63, min_blocks=20, container_width=8,
                         container_height=40, target_width=8)
    assert not RP.eligible(too_many, h, dtype)
    with pytest.raises(NotImplementedError, match="N <= 62"):
        RP._check_cfg(too_many, h, True, dtype)
    # the step chunks fill the card and never outnumber the steps
    rolling = CONFIGS["2d-rolling"]
    assert RP.step_chunks(rolling, 4096) == 2
    assert RP.step_chunks(rolling, 32) == 50
    assert RP.scratch_bytes(rolling, 4096, h)["d_se_partials"] == \
        2 * 100 * h * 4096 * 4
    assert RP.scratch_bytes(rolling, 4096, h, dtype)["se_rows"] == \
        (2 if dtype == torch.bfloat16 else 4) * 4096 * 100 * h


# ------------------------------------------------------------------ #
# the live-column compaction (the rule the replay kernels apply)

def test_live_columns_rule():
    """`live_columns` lists exactly the (instance, token) pairs whose
    instance acts and whose mask allows the token in some container, in
    (instance, token) order; on a rolling record they are a small share of
    all pairs."""
    cfg, ops = _operands("rolling-small")
    masks, acts = ops[2].numpy(), ops[3].numpy()
    T, C = cfg.num_blocks * cfg.num_rot, cfg.num_containers
    total = 0
    for k in range(cfg.num_blocks):
        b, t = RP.live_columns(ops[2][k], ops[3][k], cfg)
        want = [(bi, ti) for bi in range(acts.shape[1]) for ti in range(T)
                if acts[k, bi] >= 0
                and any(masks[k, ti * C + c, bi] == 1 for c in range(C))]
        assert list(zip(b.tolist(), t.tolist())) == want
        total += len(want)
    assert 0 < total < 0.5 * acts.size * T


@pytest.mark.parametrize("name,temperature", [
    ("2d-basic", 1.0), ("padded", 0.7), ("rolling-small", 1.0),
    ("two-limb", 0.7)])
def test_live_replay_matches_full_plain(name, temperature):
    """The plain replay over the live columns only against the full plain
    versions: logp within 1e-6 relative, every gradient within 1e-6 of its
    max magnitude (only the grouping of the sums differs)."""
    cfg, ops = _operands(name, B=16 if name == "two-limb" else 64)
    if name != "2d-basic":
        assert (ops[3] == -1).any()     # instances that finish early
    dlp = torch.linspace(-1.0, 1.0, ops[3].shape[1])
    np.testing.assert_allclose(
        RP.replay_logp_fwd_live(*ops, cfg, temperature).numpy(),
        RP.replay_logp_fwd_ref(*ops, cfg, temperature).numpy(), rtol=1e-6)
    got = RP.replay_logp_bwd_live(dlp, *ops, cfg, temperature)
    want = RP.replay_logp_bwd_ref(dlp, *ops, cfg, temperature)
    for i, (a, w) in enumerate(zip([got[0], got[1], *got[2]],
                                   [want[0], want[1], *want[2]])):
        scale = float(w.abs().max()) + 1e-12
        np.testing.assert_allclose(a.numpy() / scale, w.numpy() / scale,
                                   atol=1e-6, rtol=0, err_msg=f"output {i}")


@pytest.mark.parametrize("name,temperature", [
    ("2d-basic", 1.0), ("rolling-small", 1.0), ("two-limb", 0.7)])
def test_live_replay_matches_jax_replay(name, temperature, monkeypatch):
    """The plain live-column replay, routed through `ReplayLogp` in place of
    the kernels' full plain versions, against `jax.value_and_grad` of the
    JAX replay at the tolerances of `test_plain_kernels_match_jax_replay`."""
    jcfg, cfg, params, instances, record, actor, inst, rec = (
        _setup(name, B=16) if name == "two-limb" else _setup(name))
    monkeypatch.setattr(RP, "replay_logp_fwd", RP.replay_logp_fwd_live)
    monkeypatch.setattr(RP, "replay_logp_bwd", RP.replay_logp_bwd_live)
    monkeypatch.setattr(
        RP, "replay_logp_fwd_steps",
        lambda f, h, m, a, prev, *rest: RP.replay_logp_fwd_live(
            f, h, m, a, *rest))
    monkeypatch.setattr(
        RP, "replay_logp_bwd_steps",
        lambda d, f, h, m, a, prev, *rest: RP.replay_logp_bwd_live(
            d, f, h, m, a, *rest))
    with jax.default_matmul_precision("highest"):
        vals, grads = jax.jit(jax.value_and_grad(
            lambda p: JRO.replay_logp_sum(
                p, instances, record, jcfg, hidden=32,
                temperature=temperature, kernel=False).sum()))(params)
    lp, got = _port_value_and_grad(actor, inst, rec, cfg, temperature,
                                   kernel=True)
    np.testing.assert_allclose(float(lp.sum()), float(vals), rtol=1e-5)
    _assert_grads_close(grads, got)


def test_kernel_hidden_widths():
    """The kernels tile hidden rows by 32 lanes (by 64 above 256): widths
    that are multiples of 32 up to 256 and of 64 up to 512 are theirs;
    the routers cover every other width up to 512 on operands padded to
    the next of them (`ReplayLogp`), but the kernels themselves refuse it
    (raise, no fallback), and every width past 512."""
    cfg = CONFIGS["2d-basic"]
    for h in (32, 64, 96, 128, 160, 192, 224, 256, 320, 384, 448, 512):
        assert RP.eligible(cfg, h), h
        RP._check_cfg(cfg, h, False)
    for h in (16, 48, 288):
        assert RP.eligible(cfg, h), h
        with pytest.raises(NotImplementedError, match="multiple of 32"):
            RP._check_cfg(cfg, h, False)
    for h in (544, 576):
        assert not RP.eligible(cfg, h), h
        with pytest.raises(NotImplementedError, match="multiple of 32"):
            RP._check_cfg(cfg, h, False)
