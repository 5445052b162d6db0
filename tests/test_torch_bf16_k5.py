"""The bf16 compute dtype's replay: tapnet_torch against tapnet_tpu with
`dtype=jnp.bfloat16`, sections 3 and 4 of tests/test_torch_bf16.py (the
module docstring there gives the method, the tolerances and why), split
from that file along its K2 / K5 line so that neither file holds a
worker for most of the suite's time:

3. the plain bf16 K5, monolithic and step-grid, against the Pallas replay
   kernels in bf16 (`replay_logp_fused`) on JAX's own bf16 operands
   (2d-basic, 2d-rolling; interpret mode, once per config in a module
   fixture): the value within K5_VALUE_TOL (relative), each of the 13
   gradients within K5_GRAD_TOL of its largest magnitude, the float32
   plain K5 on the same operands outside both; `ReplayLogp`'s gradients
   in their operands' dtypes;
4. the general and the windowed bf16 replays against JAX's `kernel=False`
   replays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapnet_tpu.ops import pallas_replay as JPR
from tapnet_tpu.train import rollout as JRO
from tapnet_torch.ops import replay as RP
from tapnet_torch.train import rollout as RO

from test_torch_bf16 import (BF, HIDDEN, JBF, VALUE_TOL, _compile_strict,
                             _f32, _grads_close, _port, _port_value_and_grad,
                             _setup)

K5_VALUE_TOL = 1e-4  # plain K5 vs Pallas K5: the value, relative
K5_GRAD_TOL = 1e-2   # plain K5 vs Pallas K5: each gradient, of its max


# ---- 3. plain bf16 K5 against the Pallas replay kernels ---------------- #

def _jax_replay(s, kernel, dlp):
    """JAX bf16 replay value [B] and the gradient of sum(dlp * value)."""
    f = lambda p: JRO.replay_logp_sum(
        p, s["instances"], s["record"], s["jcfg"], hidden=HIDDEN,
        dtype=JBF, kernel=kernel, interpret=kernel)
    with jax.default_matmul_precision("highest"):
        lp, vjp = jax.jit(lambda p: jax.vjp(f, p))(s["params"]["actor"])
        grads = vjp(jnp.asarray(dlp))[0]
    return np.asarray(lp), grads


def _jax_k5_operands(s):
    """The operands JAX's kernel replay hands `replay_logp_fused`
    (statics, (params, se, ctx), data), taken at the call."""
    got = {}

    def capture(statics, diff, data):
        got.update(statics=statics, diff=diff, data=data)
        return jnp.zeros(data[3].shape[1:], jnp.float32)

    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision("highest"):
        mp.setattr(JPR, "replay_logp_fused", capture)
        JRO._replay_logp_kernel(s["params"]["actor"], s["instances"],
                                s["record"], s["jcfg"], HIDDEN, 1.0, JBF,
                                interpret=True)
    return got["statics"], got["diff"], got["data"]


@pytest.fixture(scope="module", params=["2d-basic", "2d-rolling"])
def jax_kernel_replay(request):
    """The Pallas bf16 replay kernels (interpret mode, compiled strict) run
    once per config on JAX's own operands: the value [B] and the gradients
    of sum(dlp * value) in (params, se, ctx); on 2d-basic through the
    step-grid schedule (module doc)."""
    s = _setup(request.param, B=128)
    dlp = jnp.asarray(np.random.default_rng(7).uniform(-1, 1, 128),
                      jnp.float32)
    statics, diff, data = _jax_k5_operands(s)

    def value_and_grad(d, g):
        lp, vjp = jax.vjp(lambda x: JPR.replay_logp_fused(statics, x, data),
                          d)
        return lp, vjp(g)[0]

    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision("highest"):
        mp.setattr(JPR, "_steps_grid", lambda cfg: True)
        lp, grads = _compile_strict(value_and_grad, diff, dlp)(diff, dlp)
    return s, np.asarray(dlp), diff, data, lp, grads


def _plain_k5(schedule, dtype, dlp, diff, data, cfg):
    """The port's plain K5 (`schedule` "monolithic" or "steps") on JAX's
    operands in `dtype`: value [B] and (d_se, d_ctx, 11 head-operand
    gradients), each cast to its operand's dtype as `ReplayLogp` does."""
    params, se, ctx = diff
    flags, hms, masks, acts, prev, statp, statm, _ = (_port(x) for x in data)
    cast = lambda x: _port(x).to(dtype if x.dtype == JBF else torch.float32)
    se, ctx, statp, statm = (cast(x) for x in (se, ctx, data[5], data[6]))
    params = tuple(cast(p) for p in params)
    dlp = torch.from_numpy(dlp.copy())
    if schedule == "steps":
        lp = RP.replay_logp_fwd_steps_ref(flags, hms, masks, acts, prev, se,
                                          ctx, statp, statm, params, cfg)
        dse, dctx, dp = RP.replay_logp_bwd_steps_ref(
            dlp, flags, hms, masks, acts, prev, se, ctx, statp, statm, params,
            cfg)
    else:
        lp = RP.replay_logp_fwd_ref(flags, hms, masks, acts, se, ctx, statp,
                                    statm, params, cfg)
        dse, dctx, dp = RP.replay_logp_bwd_ref(
            dlp, flags, hms, masks, acts, se, ctx, statp, statm, params, cfg)
    return lp, [g.to(x.dtype) for g, x in zip((dse, dctx, *dp),
                                              (se, ctx, *params))]


def _k5_errors(lp, grads, lp_j, grads_j):
    """(the value's largest relative difference, each gradient's largest
    difference over its largest magnitude) against JAX's."""
    lp_j = np.asarray(lp_j)
    verr = float(np.abs(lp.numpy() - lp_j).max() / np.abs(lp_j).max())
    want = [grads_j[1], grads_j[2], *grads_j[0]]
    gerr = []
    for g, w in zip(grads, want):
        w = _f32(w)
        gerr.append(float(np.abs(_f32(g) - w).max())
                    / (float(np.abs(w).max()) + 1e-9))
    return verr, gerr


@pytest.mark.parametrize("schedule", ["monolithic", "steps"])
def test_plain_k5_bf16_matches_jax_kernels(jax_kernel_replay, schedule):
    """The plain bf16 K5 against the Pallas kernels on the same bf16
    operands, within K5_VALUE_TOL and K5_GRAD_TOL; the float32 plain K5 on
    the same operands falls outside both, so the tolerances see the bf16
    rounding points."""
    s, dlp, diff, data, lp_j, grads_j = jax_kernel_replay
    cfg = s["cfg"]
    assert RP._steps_grid(cfg) == (cfg.window > 0)
    lp, grads = _plain_k5(schedule, BF, dlp, diff, data, cfg)
    assert [g.dtype for g in grads] == [BF] * 12 + [torch.float32]
    verr, gerr = _k5_errors(lp, grads, lp_j, grads_j)
    assert verr <= K5_VALUE_TOL, f"value: relative err {verr}"
    assert max(gerr) <= K5_GRAD_TOL, f"gradients: scaled errs {gerr}"
    verr32, gerr32 = _k5_errors(*_plain_k5(schedule, torch.float32, dlp,
                                           diff, data, cfg), lp_j, grads_j)
    assert verr32 > K5_VALUE_TOL and max(gerr32) > K5_GRAD_TOL, \
        (verr32, gerr32)
    print(f"\n{cfg.num_blocks}-block K5 {schedule}: bf16 value {verr:.2e} "
          f"grads {max(gerr):.2e}; float32 value {verr32:.2e} grads "
          f"{max(gerr32):.2e}")


def test_k5_bf16_gradients_take_operand_dtypes():
    """ReplayLogp hands each operand a gradient in its dtype: bf16 for se,
    ctx and the ten weights, float32 for v (the JAX `_bwd_impl` casts)."""
    s = _setup("2d-basic")
    cfg = s["cfg"]
    data, se, ctx, params = RO.replay_operands(s["actor"], s["inst"],
                                               s["rec"], cfg, grad=False,
                                               dtype=BF)
    leaves = [x.detach().requires_grad_() for x in (se, ctx, *params)]
    lp = RP.ReplayLogp.apply(cfg, 1.0, None, *data, *leaves)
    lp.sum().backward()
    assert [x.grad.dtype for x in leaves] == [BF] * 12 + [torch.float32]
    dse, dctx, dpar = RP.replay_logp_bwd_ref(
        torch.ones(lp.shape), data[0], data[1], data[2], data[3], se, ctx,
        data[4], data[5], params, cfg)
    assert dse.dtype == torch.float32
    np.testing.assert_array_equal(leaves[0].grad.float().numpy(),
                                  dse.to(BF).float().numpy())


# ---- 4. the general and windowed bf16 replays ------------------------- #

@pytest.mark.parametrize("name", ["2d-basic", "2d-rolling"])
def test_general_replays_match_jax_bf16(name):
    s = _setup(name)
    cfg = s["cfg"]
    B = s["rec"].action.shape[1]
    dlp = np.random.default_rng(8).uniform(-1, 1, B).astype(np.float32)
    lp_j, grads_j = _jax_replay(s, False, dlp)
    lp, got = _port_value_and_grad(s["actor"], s["inst"], s["rec"], cfg,
                                   dlp, kernel=False)
    _, ref = _port_value_and_grad(s["actor"], s["inst"], s["rec"], cfg,
                                  dlp, dtype=torch.float32, kernel=False)
    np.testing.assert_allclose(lp.numpy(), lp_j, rtol=VALUE_TOL,
                               atol=VALUE_TOL)
    worst = _grads_close(grads_j, got, ref)
    print(f"\n{name} general replay: value "
          f"{np.abs(lp.numpy() - lp_j).max() / np.abs(lp_j).max():.2e}, "
          f"grads {worst:.2e}")
