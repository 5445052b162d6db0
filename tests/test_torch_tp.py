"""The port's tensor-parallel rule (`parallel/tp.py`) against
tapnet_tpu's.

- `tp_spec` on every parameter of the actor and the critic (the names of
  `convert.flax_to_state_dict`) equals the JAX `tp_spec` on the flax leaf
  it converts (the flax tree's shapes, `jax.eval_shape`), for n_model in {1, 2, 4, 8} at hidden 32 and 128: the
  LayerNorm biases sharded, their scales, `v`, the `prev_embed` table and
  the critic's out-1 Dense replicated where the JAX rule replicates them;
- four gloo ranks (`parallel.scaling.run_ranks`): the TP-sharded actor
  forward on a 2 x 2 mesh (the JAX test's config, hidden 32, B = 8, the
  JAX package's weights and tokens) equals the replicated port forward and
  the JAX `actor.apply` logits within the JAX test's 1e-5; on a 4 x 1 mesh
  (model axis of one) it is bit-equal to the replicated forward; the
  kernels really are DTensors sharded over the model axis; a mesh larger
  or smaller than the group raises;
- slow: the JAX test's own 2 x 4 mesh on eight ranks.
"""


import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

import _torch_mesh_worker as W
import tapnet_tpu
from tapnet_tpu.env import core as JE
from tapnet_tpu.env.sampler import sample_batch as jax_sample_batch
from tapnet_tpu.models import build_tokens as jax_build_tokens
from tapnet_tpu.models import init_params as jax_init_params
from tapnet_tpu.models.tapnet import TAPNetActor as JActor
from tapnet_tpu.parallel import tp as JTP
import tapnet_torch
from tapnet_torch.convert import actor_from_flax
from tapnet_torch.models.tapnet import TAPNetActor, TAPNetCritic
from tapnet_torch.parallel.scaling import run_ranks
from tapnet_torch.parallel.tp import tp_spec

TINY = dict(dim=2, num_blocks=6, min_blocks=6, container_width=6,
            container_height=6, target_width=6, allow_rot=True)
TO_PORT = {P(None, "model"): Shard(0), P("model"): Shard(0), P(): Replicate()}


def _converted_name(path):
    """The port's state-dict name of a flax leaf (`convert.py`'s map)."""
    names = [getattr(k, "key", str(k)) for k in path]
    if names[0] == "params":
        names = names[1:]
    leaf = {"kernel": "weight", "embedding": "weight"}.get(names[-1],
                                                          names[-1])
    return ".".join(names[:-1] + [leaf])


@pytest.mark.parametrize("hidden", [32, 128])
def test_tp_spec_matches_jax_rule(hidden):
    cfg = tapnet_torch.CONFIGS["multi-container"]
    jcfg = tapnet_tpu.CONFIGS["multi-container"]
    # the rule reads names and shapes only: the flax tree's shapes
    params = jax.eval_shape(lambda k: jax_init_params(k, jcfg, hidden),
                            jax.random.key(0))
    for part, module in (("actor", TAPNetActor(cfg, hidden)),
                         ("critic", TAPNetCritic(cfg, hidden))):
        owners = dict(module.named_modules())
        named = dict(module.named_parameters())
        leaves = jax.tree_util.tree_flatten_with_path(params[part])[0]
        assert sorted(_converted_name(p) for p, _ in leaves) == sorted(named)
        for n_model in (1, 2, 4, 8):
            kinds = set()
            for path, leaf in leaves:
                name = _converted_name(path)
                assert named[name].numel() == np.prod(leaf.shape)
                want = TO_PORT[JTP.tp_spec(path, leaf, n_model)]
                got = tp_spec(name, named[name], n_model,
                              owners[name.rpartition(".")[0]])
                assert got == want, (part, name, n_model, got, want)
                kinds.add((name.split(".")[-1], str(got)))
            if part == "actor":
                assert ("scale", "R") in kinds and ("bias", "S(0)") in kinds
        if part == "critic":
            assert tp_spec("Dense_3.weight", named["Dense_3.weight"], 2,
                           owners["Dense_3"]) == Replicate()
        else:
            for name in ("v", "prev_embed.weight",
                         "token_enc.LayerNorm_0.scale"):
                assert tp_spec(name, named[name], 1,
                               owners[name.rpartition(".")[0]]) == Replicate()
            assert tp_spec("token_enc.LayerNorm_1.bias",
                           named["token_enc.LayerNorm_1.bias"], 4,
                           owners["token_enc.LayerNorm_1"]) == Shard(0)


def _jax_inputs(hidden, B=8):
    """The JAX test's weights, tokens (reset states of B instances) and
    logits (float32 products at "highest" precision), each made in one
    jit."""
    jcfg = tapnet_tpu.TAPConfig(**TINY)
    actor = JActor(jcfg, hidden)

    def tokens(key):
        instances = jax_sample_batch(key, B, jcfg)
        states = jax.vmap(lambda i: JE.reset(i, jcfg))(instances)
        return jax.vmap(lambda i, s: jax_build_tokens(i, s, jcfg))(
            instances, states)

    key = jax.random.key(0)
    params = jax.jit(lambda k: jax_init_params(k, jcfg, hidden)["actor"])(
        key)
    static, dynamic, hm = jax.jit(tokens)(key)
    with jax.default_matmul_precision("highest"):
        logits = jax.jit(lambda p, s, d, h: jax.vmap(
            lambda s_, d_, h_: actor.apply(p, s_, d_, h_))(s, d, h))(
                params, static, dynamic, hm)
    sd = actor_from_flax(jax.tree.map(np.asarray, params),
                         tapnet_torch.TAPConfig(**TINY), hidden).state_dict()
    return (sd, tuple(torch.from_numpy(np.array(x))
                      for x in (static, dynamic, hm)), np.asarray(logits))


def _check_ranks(world, shapes):
    hidden = 32
    sd, tokens, want = _jax_inputs(hidden)
    ranks = run_ranks(W.tp_forward, world,
                      (TINY, hidden, sd, tokens, shapes), device="cpu",
                      timeout_s=300)
    for rank, (ref, out, errors) in enumerate(ranks):
        np.testing.assert_allclose(ref.numpy(), want, rtol=1e-5, atol=1e-5)
        for (n_data, n_model), (logits, placements, coord) in out.items():
            assert coord == [rank // n_model, rank % n_model]
            if n_model == 1:
                assert torch.equal(logits, ref)
            else:
                np.testing.assert_allclose(logits.numpy(), ref.numpy(),
                                           rtol=1e-5, atol=1e-5)
                np.testing.assert_allclose(logits.numpy(), want,
                                           rtol=1e-5, atol=1e-5)
            # the kernels (and the LayerNorm biases) are sharded DTensors
            assert placements["token_enc.Dense_0.weight"] == "(Shard(dim=0),)"
            assert placements["token_enc.LayerNorm_0.bias"] == \
                "(Shard(dim=0),)"
            assert "v" not in placements and \
                "prev_embed.weight" not in placements
        assert errors == [f"RuntimeError: need {2 * world} devices, found "
                          f"{world}", f"ValueError: a 1 x 1 mesh spans the "
                          f"whole process group, which has {world} ranks"]
        if rank:
            assert torch.equal(logits, ranks[0][1][n_data, n_model][0])


def test_tp_forward_four_ranks():
    _check_ranks(4, [(2, 2), (4, 1)])


@pytest.mark.slow  # eight spawned ranks
def test_tp_forward_eight_ranks():
    _check_ranks(8, [(2, 4)])
