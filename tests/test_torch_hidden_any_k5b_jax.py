"""Hidden 48's replay backward on the card's route against the JAX kernel.

Hidden 48 is the width of the JAX package's own kernel tests
(tests/test_pallas_replay.py). The port's kernels take multiples of 32, so
the card runs it at 64 on operands padded with zeros
(`actor_step.kernel_width`): `ReplayLogp` pads once a call, runs K5b and
slices the gradients back. Here that route, through the port's plain K5b,
is held on 2d-basic at batch 128 (below 128 the JAX kernel's tile leaves
NaN lanes), matmul precision "highest", to the JAX custom VJP
`replay_logp_fused` in interpret mode, with a rollout's logp as the primal
(use_primal, so its VJP is the Pallas backward kernel's): the value and
the gradients of se, ctx and the 11 head operands at
tests/test_torch_replay.py's hidden-256 tolerances (value rtol 1e-5; each
gradient within 5e-5 of its leaf's max magnitude). K5f is not on that
route; padded against unpadded it is held in
tests/test_torch_hidden_any.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.ops import pallas_replay as JRP
from tapnet_torch import random as R
from tapnet_torch.config import CONFIGS
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.models.tapnet import init_params
from tapnet_torch.ops import actor_step as AS
from tapnet_torch.ops import replay as RP
from tapnet_torch.train import rollout as RO

HIDDEN = 48


def test_card_route_k5b_matches_jax_kernel():
    cfg, jcfg = CONFIGS["2d-basic"], JCONFIGS["2d-basic"]
    B = 128
    assert RO.routes(cfg, True, HIDDEN).replay
    assert RP.eligible(cfg, HIDDEN) and AS.kernel_width(HIDDEN) != HIDDEN
    actor = init_params(3, cfg, HIDDEN, "cpu")
    inst = sample_batch(R.key(3), B, cfg)
    with torch.no_grad():
        _, rec, lp0 = RO.rollout_batch_record(actor, inst,
                                              R.split(R.key(4), B), cfg)
        data, se, ctx, params = RO.replay_operands(actor, inst, rec, cfg,
                                                   grad=False)
    flags, hms, masks, acts, statp, statm = data
    dlp = torch.linspace(-1.0, 1.0, B)
    # the JAX kernels at their boundary: the primal given (the train step's
    # use_primal), so the VJP is the backward kernel's
    J = lambda x: jnp.asarray(x.numpy())
    jdata = tuple(J(x) for x in (flags, hms, masks, acts,
                                 RP._prev_rows(acts), statp, statm, lp0))
    jdiff = (tuple(J(p) for p in params), J(se), J(ctx))
    statics = (jcfg, 1.0, "float32", True, True)

    def value_and_vjp(d):
        out, vjp = jax.vjp(lambda dd: JRP.replay_logp_fused(statics, dd,
                                                           jdata), d)
        return out, vjp(J(dlp))[0]

    with jax.default_matmul_precision("highest"):
        lp_j, (gp_j, gse_j, gctx_j) = jax.jit(value_and_vjp)(jdiff)
    # the card's route: ReplayLogp pads to 64, runs K5b's plain version
    # and slices the gradients back
    leaves = [x.clone().requires_grad_(True) for x in (se, ctx, *params)]
    lp = RP.ReplayLogp.apply(cfg, 1.0, lp0, flags, hms, masks, acts, statp,
                             statm, *leaves)
    (lp * dlp).sum().backward()
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(lp_j),
                               rtol=1e-5, atol=1e-5)
    for name, x, w in zip(["d_se", "d_ctx"] + [f"d_params[{i}]"
                                              for i in range(11)],
                          leaves, (gse_j, gctx_j, *gp_j)):
        w = np.asarray(w)
        scale = float(np.abs(w).max()) + 1e-12
        np.testing.assert_allclose(x.grad.numpy() / scale, w / scale,
                                   atol=5e-5, err_msg=name)
