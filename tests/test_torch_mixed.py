"""Mixed 2D/3D batches (SPEC.md §9, driver config 5) in the port, against
the JAX package on the CPU reference path.

- `sample_batch_mixed`: bit-equal to the JAX sampler on multi-container and
  3d-basic at p2d 0.5, 1.0 (all flat) and 1e-12 (none flat: equal to
  `sample_batch`); flat instances are depth-1 blocks at y = 0 whose volume
  is the depth-1 container's; the two refusals (a 2D env, more blocks than
  W x H cells).
- `make_train_step(mixed_p2d=0.5)` on multi-container, hidden 32, batch 8:
  instances and actions bit-equal to the JAX step's, the metrics within
  the tolerances of `test_torch_train.py::test_train_step_matches_jax`
  (reward terms rtol 1e-6, loss_critic 1e-5, loss_actor and grad_norm
  1e-4), the next key equal. The same step on the card's routes (`routes`
  patched as in `test_torch_route.py`: K2's plain live-column version and
  the replay kernels' plain versions) within rtol 1e-4 of the general
  route's losses.
- `evaluate(mixed_p2d=0.5, baselines=True)` against the JAX `evaluate`
  (the same keys; every value within 1e-6), and on the card's routes (K1's
  and K4's plain versions) equal to the general route's.
"""

import jax
import numpy as np
import pytest
import torch

import tapnet_torch as T
from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.env.sampler import sample_batch_mixed as jax_mixed
from tapnet_tpu.models.tapnet import init_params as jax_init_params
from tapnet_tpu.train import reinforce as JR
from tapnet_tpu.train import rollout as JRO
from tapnet_tpu.train import trainer as JT
from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.convert import actor_from_flax, params_from_flax
from tapnet_torch.env.sampler import sample_batch, sample_batch_mixed
from tapnet_torch.ops import actor_step as AS
from tapnet_torch.ops import env as OE
from tapnet_torch.ops import policy_step as PS
from tapnet_torch.train import reinforce as TR
from tapnet_torch.train import rollout as RO
from tapnet_torch.train import trainer as TT

NAME, HIDDEN, B = "multi-container", 32, 8


@pytest.mark.parametrize("p2d", [0.5, 1.0, 1e-12])
@pytest.mark.parametrize("name", ["multi-container", "3d-basic"])
def test_sample_batch_mixed_matches_jax(name, p2d):
    cfg, jcfg = T.CONFIGS[name], JCONFIGS[name]
    got = sample_batch_mixed(R.key(7), 12, cfg, p2d)
    want = jax.jit(lambda k: jax_mixed(k, 12, jcfg, p2d))(jax.random.key(7))
    for f, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    dims, pos0, nt = (x.numpy() for x in got[:3])
    real = np.arange(cfg.num_blocks)[None] < nt[:, None]
    flat = ((dims[:, :, 1] == 1) | ~real).all(1)
    want_flat = {0.5: (1, 11), 1.0: (12, 12), 1e-12: (0, 0)}[p2d]
    assert want_flat[0] <= flat.sum() <= want_flat[1]
    assert (pos0[flat][..., 1] == 0).all()
    vol = np.where(real, dims.astype(np.int64).prod(2), 0).sum(1)
    depth = np.where(flat, 1, cfg.container_depth)
    np.testing.assert_array_equal(
        vol, cfg.container_width * depth * cfg.container_height)
    if p2d == 1e-12:
        for a, b in zip(got, sample_batch(R.key(7), 12, cfg)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_mixed_refusals():
    with pytest.raises(ValueError, match="3D env"):
        sample_batch_mixed(R.key(0), 4, T.CONFIGS["2d-basic"])
    tall = TAPConfig(dim=3, num_blocks=10, container_width=2,
                     container_depth=8, container_height=3, target_width=2,
                     target_depth=8)
    with pytest.raises(ValueError, match="depth-1"):
        sample_batch_mixed(R.key(0), 4, tall)
    with pytest.raises(ValueError, match="3D env"):
        T.make_train_step(T.CONFIGS["2d-basic"], batch=4, hidden=HIDDEN,
                          mixed_p2d=0.5, device="cpu")


@pytest.fixture(scope="module")
def jax_state():
    return jax.jit(JR.init_train_state, static_argnums=(1, 2))(
        jax.random.key(3), JCONFIGS[NAME], HIDDEN)


def _port_state(jts, cfg):
    actor, critic = params_from_flax(jax.tree.map(np.asarray, jts.params),
                                     cfg, HIDDEN)
    key = np.asarray(jax.random.key_data(jts.key)).astype(np.int64)
    return TR.train_state(actor, critic, torch.from_numpy(key))


def test_mixed_train_step_matches_jax(jax_state):
    jcfg, cfg = JCONFIGS[NAME], T.CONFIGS[NAME]
    ts = _port_state(jax_state, cfg)
    _, k_inst, k_act = jax.random.split(jax_state.key, 3)
    inst_j = jax.jit(lambda k: jax_mixed(k, B, jcfg, 0.5))(k_inst)
    ks = R.split(ts.key, 3)
    inst = sample_batch_mixed(ks[1], B, cfg, 0.5)
    for a, b in zip(inst, inst_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int((inst.dims[:, :, 1].amax(1) == 1).sum()) < B
    with jax.default_matmul_precision("highest"):
        _, rec_j, _ = jax.jit(lambda p, i, k: JRO.rollout_batch_record(
            p, i, k, jcfg, hidden=HIDDEN, step_kernel=False,
            actor_kernel=False))(jax_state.params["actor"], inst_j,
                                 jax.random.split(k_act, B))
    _, rec, _ = RO.rollout_batch_record(ts.actor, inst, R.split(ks[2], B),
                                        cfg)
    np.testing.assert_array_equal(rec.action.numpy(),
                                  np.asarray(rec_j.action))
    with jax.default_matmul_precision("highest"):
        jts1, m_j = JR.make_train_step(jcfg, batch=B, hidden=HIDDEN,
                                       mixed_p2d=0.5)(jax_state)
    ts1, m = T.make_train_step(cfg, batch=B, hidden=HIDDEN, mixed_p2d=0.5,
                               device="cpu")(ts)
    for k in ("reward", "C", "P", "S"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["loss_critic"]),
                               float(m_j["loss_critic"]), rtol=1e-5)
    for k in ("loss_actor", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(
        ts1.key.numpy(), np.asarray(jax.random.key_data(jts1.key)))


@pytest.fixture
def card_rules(monkeypatch):
    """`routes` answering as on the card, and the kernel paths taken."""
    routes = RO.routes
    monkeypatch.setattr(RO, "routes",
                        lambda cfg, on_card, *a, **k: routes(cfg, True, *a,
                                                             **k))
    taken = []
    for mod, name in ((AS, "actor_select_step_live_ref"),
                      (PS, "select_place_ref"),
                      (OE, "fused_rollout_batch_ref"),
                      (RO, "_replay_logp_kernel")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            taken.append(_n), _fn(*a, **k))[1])
    return taken


def _general(monkeypatch):
    monkeypatch.setattr(RO, "routes", lambda cfg, on_card, *a, **k:
                        RO.Routes("general", False, False))


def test_mixed_train_step_on_card_routes(card_rules):
    cfg = T.CONFIGS[NAME]

    def metrics():
        ts = T.init_train_state(0, cfg, hidden=HIDDEN, device="cpu")
        _, m = T.make_train_step(cfg, batch=B, hidden=HIDDEN, mixed_p2d=0.5,
                                 device="cpu")(ts)
        return {k: float(v) for k, v in m.items()}

    got = metrics()
    assert card_rules.count("actor_select_step_live_ref") == cfg.num_blocks
    assert "_replay_logp_kernel" in card_rules
    with pytest.MonkeyPatch.context() as mp:
        _general(mp)
        want = metrics()
    for k in ("loss_actor", "loss_critic", "reward", "C", "P", "S"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.fixture(scope="module")
def actors():
    params = jax_init_params(jax.random.key(2), JCONFIGS[NAME], HIDDEN)
    return params, actor_from_flax(jax.tree.map(np.asarray, params["actor"]),
                                   T.CONFIGS[NAME], HIDDEN)


def test_mixed_evaluate_matches_jax(actors):
    params, actor = actors
    with jax.default_matmul_precision("highest"):
        want = JT.evaluate(params, JCONFIGS[NAME], JT.TrainLoopConfig(
            valid_batch=12, hidden=HIDDEN, mixed_p2d=0.5), baselines=True)
    got = TT.evaluate(actor, T.CONFIGS[NAME], TT.TrainLoopConfig(
        valid_batch=12, hidden=HIDDEN, mixed_p2d=0.5), baselines=True,
        device="cpu")
    assert set(got) == set(want)
    assert {"valid_2d_frac", "random_reward", "first_reward"} <= set(got)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_mixed_evaluate_on_card_routes(actors, card_rules):
    """Greedy decode through K1's plain version, the baselines through
    K4's: the general route's dict, value for value."""
    _, actor = actors
    cfg = T.CONFIGS[NAME]
    loop = TT.TrainLoopConfig(valid_batch=12, hidden=HIDDEN, mixed_p2d=0.5)
    got = TT.evaluate(actor, cfg, loop, baselines=True, device="cpu")
    assert card_rules.count("select_place_ref") == cfg.num_blocks
    assert card_rules.count("fused_rollout_batch_ref") == 2
    with pytest.MonkeyPatch.context() as mp:
        _general(mp)
        want = TT.evaluate(actor, cfg, loop, baselines=True, device="cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
