"""Hidden 48 on the card's route against the JAX K2 (interpret mode).

Hidden 48 is the width of the JAX package's own kernel tests
(tests/test_actor_step.py, tests/test_pallas_replay.py). The port's
kernels take multiples of 32, so the card runs it at 64 on operands padded
with zeros (`actor_step.kernel_width`, `pad_head`): the decode loop pads
once a rollout. Here that route, through the port's plain K2, is held to
the Pallas kernel on 2d-basic at batch 128 (the JAX kernel's batch tile:
it asserts a multiple of 128), matmul precision "highest":

one sampled decode step: the plain K2 (both modes) on the padded operands
against `pallas_actor_step.actor_select_step` on the unpadded ones:
integer outputs bit-equal, logits and logp within 1e-5. The replay
backward at hidden 48 is tests/test_torch_hidden_any_k5b_jax.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.models.tapnet import init_params as jax_init_params
from tapnet_tpu.ops import pallas_actor_step as JAS
from tapnet_torch.config import CONFIGS
from tapnet_torch.convert import actor_from_flax
from tapnet_torch.ops import actor_step as AS
from tapnet_torch.train import rollout as RO

from test_torch_actor_step import _operands, _port_ops

HIDDEN = 48


def test_card_route_k2_matches_jax_kernel():
    cfg, jcfg = CONFIGS["2d-basic"], JCONFIGS["2d-basic"]
    assert RO.routes(cfg, True, HIDDEN).decode == "actor"
    flax_params = jax_init_params(jax.random.key(9), jcfg, HIDDEN)["actor"]
    actor = actor_from_flax(jax.tree.map(np.asarray, flax_params), cfg,
                            HIDDEN)
    ops = _operands(cfg, actor, seed=9)
    with jax.default_matmul_precision("highest"):
        want = JAS.actor_select_step(
            *(jnp.asarray(o) for o in ops),
            JAS.head_operands(flax_params, jcfg, jnp.float32),
            cfg=jcfg, temperature=0.8, interpret=True)
    hk = AS.kernel_width(HIDDEN)
    assert hk == 64
    port = _port_ops(ops)
    port[12] = AS.pad_hidden(port[12], hk, 2)
    port[13] = AS.pad_hidden(port[13], hk, 0)
    params = AS.pad_head(AS.head_operands(actor, cfg), hk)
    labels = ("packed", "hm", "plc", "act", "flags", "mask", "logits", "logp")
    for ref in (AS.actor_select_step_ref, AS.actor_select_step_live_ref):
        got = ref(*port, params, cfg, temperature=0.8)
        for label, w, g in zip(labels, want, got):
            w = np.asarray(w)
            if g is None:
                assert label == "logits"
            elif label in ("logits", "logp"):
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                           atol=1e-5, err_msg=label)
            else:
                np.testing.assert_array_equal(g.numpy(), w, err_msg=label)
