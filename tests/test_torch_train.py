"""The train slice as a whole: tapnet_torch's REINFORCE step, optimizer,
checkpoints and trainer vs tapnet_tpu's, on the CPU reference path.

2d-basic, hidden 32, batch 32, the same key and the same weights on both
sides (the JAX package's init_params through convert.py): the sampled
instances and actions are bit-equal and the per-instance R, C, P, S exactly
equal; loss_critic within rtol 1e-5, loss_actor and grad_norm within rtol
1e-4; every actor and critic gradient of the whole loss within atol 5e-5 of
its leaf's max magnitude. The JAX side runs at matmul precision "highest".
The clip + Adam update is held to optax's chain at rtol 1e-6. One step of a
rolling config (12 blocks, window 4, rotation, ragged block counts; batch
16) is held to the JAX step in the same way: there the port rolls out with
the windowed head and replays through the windowed replay.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tapnet_torch as T
from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.env import core as JE
from tapnet_tpu.env.sampler import sample_instance
from tapnet_tpu.train import reinforce as JR
from tapnet_tpu.train import rollout as JRO
from tapnet_torch import random as R
from tapnet_torch.convert import flax_to_state_dict, params_from_flax
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.train import checkpoints as ckpt
from tapnet_torch.train import reinforce as TR
from tapnet_torch.train import rollout as RO
from tapnet_torch.train.trainer import assert_deterministic
from tapnet_torch.types import Instance

HIDDEN, B = 32, 32
NAME = "2d-basic"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_state():
    jcfg = JCONFIGS[NAME]
    ts = jax.jit(JR.init_train_state, static_argnums=(1, 2))(
        jax.random.key(0), jcfg, HIDDEN)
    return jcfg, ts


def _port_state(ts, cfg):
    actor, critic = params_from_flax(_np(ts.params), cfg, HIDDEN)
    key = torch.from_numpy(
        np.asarray(jax.random.key_data(ts.key)).astype(np.int64))
    return TR.train_state(actor, critic, key)


def _leaf_close(want_tree, got, atol=5e-5):
    want = flax_to_state_dict(_np(want_tree))
    assert set(want) == set(got)
    for name, w in want.items():
        scale = float(w.abs().max()) + 1e-9
        np.testing.assert_allclose(got[name].numpy() / scale,
                                   w.numpy() / scale, atol=atol,
                                   err_msg=name)


def test_train_step_matches_jax(jax_state):
    jcfg, jts = jax_state
    cfg = T.CONFIGS[NAME]
    ts = _port_state(jts, cfg)
    # the key schedule: instances and actions bit-equal
    _, k_inst, k_act = jax.random.split(jts.key, 3)
    inst_j = jax.jit(lambda k: jax.vmap(lambda kk: sample_instance(kk, jcfg))(
        jax.random.split(k, B)))(k_inst)
    ks = R.split(ts.key, 3)
    inst = sample_batch(ks[1], B, cfg)
    for a, b in zip(inst, inst_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    act_keys_j = jax.random.split(k_act, B)
    with jax.default_matmul_precision("highest"):
        states_j, rec_j, _ = jax.jit(lambda p, i, k: JRO.rollout_batch_record(
            p, i, k, jcfg, hidden=HIDDEN, step_kernel=False,
            actor_kernel=False))(jts.params["actor"], inst_j, act_keys_j)
    _, rec, _ = RO.rollout_batch_record(ts.actor, inst, R.split(ks[2], B),
                                        cfg)
    np.testing.assert_array_equal(rec.action.numpy(),
                                  np.asarray(rec_j.action))
    # R, C, P, S per instance, exactly
    _, _, Rw, terms = TR._batch_losses(ts.actor, ts.critic, inst,
                                       R.split(ks[2], B), cfg, 1.0)
    terms_j = jax.vmap(lambda s, i: JE.reward_terms(s, i, jcfg))(states_j,
                                                                inst_j)
    for a, b in zip(terms, terms_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(Rw.numpy(),
                                  np.asarray(_jax_reward(terms_j, jcfg)))
    # one whole step
    with jax.default_matmul_precision("highest"):
        jts1, m_j = JR.make_train_step(jcfg, batch=B, hidden=HIDDEN)(jts)
    ts1, m = T.make_train_step(cfg, batch=B, hidden=HIDDEN,
                               device="cpu")(ts)
    for k in ("reward", "C", "P", "S"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["loss_critic"]),
                               float(m_j["loss_critic"]), rtol=1e-5)
    for k in ("loss_actor", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-4,
                                   err_msg=k)
    assert ts1.step == 1
    np.testing.assert_array_equal(
        ts1.key.numpy(), np.asarray(jax.random.key_data(jts1.key)))
    # Adam's first step moves each weight by about lr (sign of its gradient)
    got = {**{f"a.{k}": v for k, v in ts1.actor.state_dict().items()},
           **{f"c.{k}": v for k, v in ts1.critic.state_dict().items()}}
    want = {**{f"a.{k}": v for k, v in
               flax_to_state_dict(_np(jts1.params["actor"])).items()},
            **{f"c.{k}": v for k, v in
               flax_to_state_dict(_np(jts1.params["critic"])).items()}}
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1.1e-3,
                                   err_msg=k)


ROLLING = dict(num_blocks=12, min_blocks=6, container_width=8,
               container_height=12, target_width=8, window=4, allow_rot=True)


def test_rolling_train_step_matches_jax():
    from tapnet_tpu.config import TAPConfig as JTAPConfig
    jcfg, cfg = JTAPConfig(**ROLLING), T.TAPConfig(**ROLLING)
    Br = 16
    jts = jax.jit(JR.init_train_state, static_argnums=(1, 2))(
        jax.random.key(1), jcfg, HIDDEN)
    ts = _port_state(jts, cfg)
    with jax.default_matmul_precision("highest"):
        jts1, m_j = JR.make_train_step(jcfg, batch=Br, hidden=HIDDEN)(jts)
    ts1, m = T.make_train_step(cfg, batch=Br, hidden=HIDDEN,
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
    got = {**{f"a.{k}": v for k, v in ts1.actor.state_dict().items()},
           **{f"c.{k}": v for k, v in ts1.critic.state_dict().items()}}
    want = {**{f"a.{k}": v for k, v in
               flax_to_state_dict(_np(jts1.params["actor"])).items()},
            **{f"c.{k}": v for k, v in
               flax_to_state_dict(_np(jts1.params["critic"])).items()}}
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1.1e-3,
                                   err_msg=k)


def test_rolling_train_step_kernel_route_on_cpu():
    """The card's route rehearsed on CPU tensors: the actor-fused rollout
    (plain K2) with its logp as the primal and the step-grid replay (plain
    K5b-steps) give the losses of the CPU reference route."""
    cfg = T.TAPConfig(**ROLLING)
    ts = T.init_train_state(0, cfg, hidden=HIDDEN, device="cpu")
    inst = sample_batch(R.key(3), 16, cfg)
    keys = R.split(R.key(4), 16)
    a0, c0, _, _ = TR._batch_losses(ts.actor, ts.critic, inst, keys, cfg, 1.0)
    _, rec, lp0 = RO.rollout_batch_record(ts.actor, inst, keys, cfg,
                                          actor_kernel=True)
    lp = RO.replay_logp_sum(ts.actor, inst, rec, cfg, kernel=True, logp0=lp0)
    assert torch.equal(lp.detach(), lp0)
    lp_ref = RO.replay_logp_sum(ts.actor, inst, rec, cfg, kernel=False)
    np.testing.assert_allclose(lp.detach().numpy(), lp_ref.detach().numpy(),
                               rtol=1e-4, atol=1e-4)
    g1 = torch.autograd.grad(lp.sum(), list(ts.actor.parameters()),
                             allow_unused=True)
    g2 = torch.autograd.grad(lp_ref.sum(), list(ts.actor.parameters()),
                             allow_unused=True)
    for (n, _), a, b in zip(ts.actor.named_parameters(), g1, g2):
        scale = float(b.abs().max()) + 1e-9
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale,
                                   atol=5e-5, err_msg=n)
    assert np.isfinite(float(a0.detach())) and np.isfinite(float(c0.detach()))


def _jax_reward(terms, jcfg):
    vol, dc, dp, sn, sd = terms
    f = lambda n, d: jnp.where(d > 0, n.astype(jnp.float32)
                               / jnp.maximum(d, 1).astype(jnp.float32), 0.0)
    vals = {"C": f(vol, dc), "P": f(vol, dp), "S": f(sn, sd)}
    return sum(vals[t] for t in jcfg.reward_terms)


def test_loss_gradients_match_jax(jax_state):
    jcfg, jts = jax_state
    cfg = T.CONFIGS[NAME]
    ts = _port_state(jts, cfg)
    inst_j = jax.jit(lambda k: jax.vmap(lambda kk: sample_instance(kk, jcfg))(
        jax.random.split(k, B)))(jax.random.key(11))
    keys_j = jax.random.split(jax.random.key(12), B)

    def loss(p):
        a, c, _, _ = JR._batch_losses(p, inst_j, keys_j, jcfg, HIDDEN, 1.0,
                                      False, step_kernel=False,
                                      actor_kernel=False)
        return a + c, (a, c)

    with jax.default_matmul_precision("highest"):
        grads, (a_j, c_j) = jax.jit(jax.grad(loss, has_aux=True))(
            jts.params)
    inst = Instance(*(torch.from_numpy(np.array(x)) for x in inst_j))
    keys = torch.from_numpy(
        np.asarray(jax.random.key_data(keys_j)).astype(np.int64))
    a, c, _, _ = TR._batch_losses(ts.actor, ts.critic, inst, keys, cfg, 1.0)
    (a + c).backward()
    np.testing.assert_allclose(c.item(), float(c_j), rtol=1e-5)
    np.testing.assert_allclose(a.item(), float(a_j), rtol=1e-4)
    _leaf_close(grads["actor"], {n: p.grad for n, p in
                                 ts.actor.named_parameters()})
    _leaf_close(grads["critic"], {n: p.grad for n, p in
                                  ts.critic.named_parameters()})


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_optimizer_matches_optax(scale):
    """Three clip + Adam steps on identical gradients, below (0.01) and
    above (10) the clip of 2."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(scale * rng.normal(size=s)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    opt = optax.chain(optax.clip_by_global_norm(2.0), optax.adam(5e-4))
    pj = [jnp.asarray(p) for p in params]
    state = opt.init(pj)
    pt = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    adam = TR.make_optimizer(pt, 5e-4)
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, pj)
        pj = optax.apply_updates(pj, upd)
        for p, x in zip(pt, g):
            p.grad = torch.from_numpy(x.copy())
        norm = TR.clip_by_global_norm_([p.grad for p in pt], 2.0)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(g)), rtol=1e-6)
        adam.step()
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


def _small_state():
    return T.init_train_state(0, T.CONFIGS[NAME], hidden=HIDDEN,
                              device="cpu")


def _step():
    return T.make_train_step(T.CONFIGS[NAME], batch=8, hidden=HIDDEN,
                             device="cpu")


def _equal_states(a, b):
    for x, y in zip(a.actor.state_dict().values(),
                    b.actor.state_dict().values()):
        assert torch.equal(x, y)
    for x, y in zip(a.critic.state_dict().values(),
                    b.critic.state_dict().values()):
        assert torch.equal(x, y)
    assert a.step == b.step and torch.equal(a.key, b.key)


def test_checkpoint_resume_continues_exact_trajectory(tmp_path):
    step = _step()
    ts, _ = step(_small_state())
    path = ckpt.save_checkpoint(str(tmp_path), ts)
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    ts_a, m_a = step(copy.deepcopy(ts))
    template = T.init_train_state(123, T.CONFIGS[NAME], hidden=HIDDEN,
                                  device="cpu")
    ts_b = ckpt.restore_checkpoint(path, template)
    _equal_states(ts, ts_b)
    ts_b, m_b = step(ts_b)
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    _equal_states(ts_a, ts_b)


def test_step_is_deterministic():
    assert_deterministic(_step(), _small_state())


def test_train_writes_metrics_and_checkpoints(tmp_path):
    loop = T.TrainLoopConfig(epochs=1, steps_per_epoch=3, batch=8,
                             hidden=HIDDEN, valid_batch=8,
                             ckpt_dir=str(tmp_path / "ck"),
                             metrics_path=str(tmp_path / "m.jsonl"),
                             eval_best_of=2)
    ts = T.train(T.CONFIGS[NAME], loop, device="cpu")
    assert ts.step == 3
    lines = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    assert lines[-1]["step"] == 3 and lines[-1]["epoch"] == 0
    for k in ("loss_actor", "loss_critic", "reward", "C", "P", "S",
              "grad_norm", "valid_reward", "valid_reward_bo2",
              "env_steps_per_s"):
        assert np.isfinite(lines[-1][k]), k
    assert ckpt.latest_checkpoint(str(tmp_path / "ck")).endswith(
        "ckpt_00000003.pt")
    # resume: nothing left to do, the state comes back from the checkpoint
    ts2 = T.train(T.CONFIGS[NAME], loop, device="cpu")
    _equal_states(ts, ts2)


def test_unported_options_raise():
    cfg = T.CONFIGS[NAME]
    for kw in ({"mesh": object()}, {"mixed_p2d": 0.5},
               {"steps_per_call": 2}, {"compute_dtype": torch.bfloat16}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.make_train_step(cfg, batch=8, device="cpu", **kw)
    for kw in ({"tb_dir": "x"}, {"trace_dir": "x"}, {"nan_checks": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.train(cfg, T.TrainLoopConfig(**kw), device="cpu")
