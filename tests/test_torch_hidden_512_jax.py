"""A hidden-512 train step on the card's route against the JAX plain path.

One 2d-basic train step's losses and every actor and critic gradient at
hidden 512, batch 8, on the card's route (`routes` answering as on the
card: the plain K2 in the decode loop, the plain K5 under `ReplayLogp`),
against the JAX package's plain path (flax model and autodiff, no Pallas,
no interpret mode) at matmul precision "highest", at
tests/test_torch_train.py's tolerances. Hidden 512 is the widest width the
kernels take (the WX form of the head, csrc/geo.cuh). The padding and the
plan mirrors are held in tests/test_torch_hidden_any.py.
"""

import jax
import numpy as np
import torch

from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.env.sampler import sample_instance
from tapnet_tpu.train import reinforce as JR
from tapnet_torch.config import CONFIGS
from tapnet_torch.convert import flax_to_state_dict, params_from_flax
from tapnet_torch.train import reinforce as TR
from tapnet_torch.train import rollout as RO
from tapnet_torch.types import Instance


def _leaf_close(want_tree, got, atol=5e-5):
    want = flax_to_state_dict(jax.tree.map(np.asarray, want_tree))
    assert set(want) == set(got)
    for name, w in want.items():
        scale = float(w.abs().max()) + 1e-9
        np.testing.assert_allclose(got[name].numpy() / scale,
                                   w.numpy() / scale, atol=atol,
                                   err_msg=name)


def test_hidden_512_step_on_the_card_route_matches_jax(monkeypatch):
    hidden, B = 512, 8
    jcfg, cfg = JCONFIGS["2d-basic"], CONFIGS["2d-basic"]
    routes = RO.routes
    monkeypatch.setattr(RO, "routes", lambda c, on_card, *a, **k: routes(
        c, True, *a, **k))
    assert RO.routes(cfg, False, hidden) == RO.Routes("actor", True, True)
    taken = []
    for name in ("_rollout_record_actorfused", "_replay_logp_kernel"):
        fn = getattr(RO, name)
        monkeypatch.setattr(RO, name, lambda *a, _fn=fn, _n=name, **k: (
            taken.append(_n), _fn(*a, **k))[1])
    jts = jax.jit(JR.init_train_state, static_argnums=(1, 2))(
        jax.random.key(0), jcfg, hidden)
    actor, critic = params_from_flax(jax.tree.map(np.asarray, jts.params),
                                     cfg, hidden)
    inst_j = jax.jit(lambda k: jax.vmap(lambda kk: sample_instance(kk, jcfg))(
        jax.random.split(k, B)))(jax.random.key(11))
    keys_j = jax.random.split(jax.random.key(12), B)

    def loss(p):
        a, c, _, _ = JR._batch_losses(p, inst_j, keys_j, jcfg, hidden, 1.0,
                                      False, step_kernel=False,
                                      actor_kernel=False)
        return a + c, (a, c)

    with jax.default_matmul_precision("highest"):
        grads, (a_j, c_j) = jax.jit(jax.grad(loss, has_aux=True))(
            jts.params)
    inst = Instance(*(torch.from_numpy(np.array(x)) for x in inst_j))
    keys = torch.from_numpy(
        np.asarray(jax.random.key_data(keys_j)).astype(np.int64))
    a, c, _, _ = TR._batch_losses(actor, critic, inst, keys, cfg, 1.0)
    assert taken == ["_rollout_record_actorfused", "_replay_logp_kernel"]
    (a + c).backward()
    np.testing.assert_allclose(c.item(), float(c_j), rtol=1e-5)
    np.testing.assert_allclose(a.item(), float(a_j), rtol=1e-4)
    _leaf_close(grads["actor"], {n: p.grad for n, p in
                                 actor.named_parameters()})
    _leaf_close(grads["critic"], {n: p.grad for n, p in
                                  critic.named_parameters()})
