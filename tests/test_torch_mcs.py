"""The port's `mcs` placement rule against tapnet_tpu's.

`mcs` picks the candidate offset whose placement gives the highest exact
score fraction (SPEC.md §6.4). The port compares the fractions with 21-bit
limbs held in int64 tensors; the JAX package with u32 limbs. Held here:

- the limb product and the limb compare against Python integers, on random
  values and on the edges 0, 2^32 - 1 and 2^63 - 1;
- the score fraction against `fractions.Fraction`;
- `choose_placement` and `step` against `tapnet_tpu.env.core`, bit-equal
  along random feasible trajectories of the MCS_CASES of tests/test_mcs.py;
- `select_place_ref` (the plain version of the select_step kernel) against
  `pallas_policy_step.select_step(interpret=True)`, and the plain actor step
  against `pallas_actor_step.actor_select_step(interpret=True)`, both under
  `mcs`, 2D and 3D: integer outputs bit-equal, logits and logp within 1e-5.
"""

import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapnet_tpu.config import TAPConfig as JTAPConfig
from tapnet_tpu.env import core as JE
from tapnet_tpu.env.sampler import sample_batch as jax_sample_batch
from tapnet_tpu.models.tapnet import init_params as jax_init_params
from tapnet_tpu.ops import pallas_actor_step as JAS
from tapnet_tpu.ops import pallas_policy_step as JPS
from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.convert import actor_from_flax
from tapnet_torch.env import core as E
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.models.features import static_tokens
from tapnet_torch.models.tapnet import embed_static_T
from tapnet_torch.ops import actor_step as AS
from tapnet_torch.ops import policy_step as PS
from tapnet_torch.types import Instance

EDGES = [0, 1, 2**21 - 1, 2**21, 2**32 - 1, 2**32, 2**42 - 1, 2**63 - 1]


def _values(seed, n=4096):
    """int64 in [0, 2^63): random values of every magnitude, then every
    pair of edge values."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**63, size=n, dtype=np.int64)
    a >>= rng.integers(0, 63, size=n)
    pairs = np.array([(x, y) for x in EDGES for y in EDGES], dtype=np.int64)
    b = rng.permutation(a)
    return (np.concatenate([a, pairs[:, 0]]),
            np.concatenate([b, pairs[:, 1]]))


def _from_limbs(limbs):
    out = np.zeros(limbs[0].shape, dtype=object)
    for limb in limbs:
        v = limb.numpy().astype(object)
        assert (v >= 0).all() and (v < 2**21).all()
        out = (out << 21) | v
    return out


def test_limb_mul_matches_python_ints():
    a, b = _values(0)
    got = _from_limbs(E._mul_u63(torch.from_numpy(a), torch.from_numpy(b)))
    assert (got == a.astype(object) * b.astype(object)).all()


def test_limb_compare_matches_python_ints():
    """n1*d2 against n2*d1, as `_mcs_choose` compares two fractions."""
    n1, d2 = _values(1)
    n2, d1 = _values(2)
    # a third of the pairs equal, a third differing in the lowest bit
    n2[::3], d1[::3] = d2[::3], n1[::3]
    n2[1::3], d1[1::3] = n1[1::3], d2[1::3] ^ 1
    t = torch.from_numpy
    gt, eq = E._limbs_gt_eq(E._mul_u63(t(n1), t(d2)), E._mul_u63(t(n2), t(d1)))
    lhs = n1.astype(object) * d2.astype(object)
    rhs = n2.astype(object) * d1.astype(object)
    assert (gt.numpy() == (lhs > rhs)).all()
    assert (eq.numpy() == (lhs == rhs)).all()
    assert eq.numpy()[::3].all() and gt.numpy().any()


@pytest.mark.parametrize("rt", ["C+P+S", "P+S", "C", "S+C"])
def test_score_fraction_matches_fractions(rt):
    cfg = TAPConfig(reward_type=f"{rt}-mcs-soft")
    rng = np.random.default_rng(3)
    vol, dc, dp, sn, sd = (rng.integers(1, 2**20, size=64).astype(np.int32)
                           for _ in range(5))
    n, d = E._mcs_score_fraction(cfg, *(torch.from_numpy(v)
                                        for v in (vol, dc, dp, sn, sd)))
    assert n.dtype == d.dtype == torch.int64
    terms = {"C": (vol, dc), "P": (vol, dp), "S": (sn, sd)}
    for i in range(64):
        want = sum(fractions.Fraction(int(terms[t][0][i]),
                                      int(terms[t][1][i]))
                   for t in cfg.reward_terms)
        assert fractions.Fraction(int(n[i]), int(d[i])) == want


# --------------------------------------------------------------------- #
# choose_placement and step against the JAX env

MCS_CASES = [
    ("C+P+S-mcs-soft", 2, 1),
    ("C+P+S-mcs-hard", 2, 1),
    ("C+P+S-mcs-hard", 3, 2),
    ("P+S-mcs-soft", 3, 1),
]


def _mcs_kw(rt, dim, C):
    return dict(dim=dim, num_blocks=8, min_blocks=6, container_width=6,
                container_depth=1 if dim == 2 else 4, container_height=6,
                target_width=6, target_depth=1 if dim == 2 else 4,
                num_containers=C, allow_rot=True, reward_type=rt)


def _to_torch(instances):
    return Instance(*(torch.from_numpy(np.array(x)) for x in instances))


@pytest.mark.parametrize("rt,dim,C", MCS_CASES)
def test_mcs_choose_placement_and_step_match_jax(rt, dim, C):
    kw = _mcs_kw(rt, dim, C)
    cfg, jcfg = TAPConfig(**kw), JTAPConfig(**kw)
    B = 12
    jinst = jax_sample_batch(jax.random.key(5), B, jcfg)
    tinst = _to_torch(jinst)

    mask_fn = jax.jit(jax.vmap(lambda s, i: JE.action_mask(s, i, jcfg)))
    step_fn = jax.jit(jax.vmap(lambda s, a, i: JE.step(s, a, i, jcfg)))

    def jax_choose(s, a, i):
        b, r, c = jcfg.decompose_action(a)
        w, d, h = JE.rotated_dims(i, b, r, jcfg)
        return JE.choose_placement(s.heightmap[c], w, d, h, jcfg,
                                   JE.reward_terms(s, i, jcfg))
    choose_fn = jax.jit(jax.vmap(jax_choose))

    js = jax.vmap(lambda i: JE.reset(i, jcfg))(jinst)
    ts = E.reset(tinst, cfg)
    rng = np.random.default_rng(7)
    bi = torch.arange(B)
    moved = False
    for t in range(cfg.num_blocks):
        jm = np.asarray(mask_fn(js, jinst))
        np.testing.assert_array_equal(E.action_mask(ts, tinst, cfg).numpy(),
                                      jm)
        a = np.where(jm.any(1), (rng.random(jm.shape) * jm).argmax(1),
                     0).astype(np.int32)
        ta = torch.from_numpy(a)
        b, r, c = cfg.decompose_action(ta)
        w, d, h = E.rotated_dims(tinst, b, r, cfg)
        got = E.choose_placement(ts.heightmap[bi, c.long()], w, d, h, cfg,
                                 E.reward_terms(ts, tinst, cfg))
        want = choose_fn(js, a, jinst)
        ok = np.asarray(want[4])
        np.testing.assert_array_equal(got[4].numpy(), ok)
        for label, g, w_ in zip(("x", "y", "l", "stable"), got, want):
            # with no valid candidate the winner is arbitrary and unused
            np.testing.assert_array_equal(g.numpy()[ok], np.asarray(w_)[ok],
                                          err_msg=f"{label} at step {t}")
        a = np.where(jm.any(1), a, -1).astype(np.int32)
        js = step_fn(js, a, jinst)
        ts = E.step(ts, torch.from_numpy(a), tinst, cfg)
        for f in ts._fields:
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f"{f} after step {t}")
        moved |= bool((a >= 0).any())
    assert moved and ts.packed.any()


def test_mcs_needs_score_ctx_and_fills_the_pit():
    """The crafted state of tests/test_mcs.py: a block that fills a pit wins
    under mcs; the answer equals the JAX env's; no context raises."""
    kw = dict(target_width=6, reward_type="C+P+S-mcs-soft")
    cfg, jcfg = TAPConfig(**kw), JTAPConfig(**kw)
    hm = np.array([[2], [2], [0], [0], [2], [2]], dtype=np.int32)
    ctx = (20, 12, 8, 4, 4)
    want = JE.choose_placement(jnp.asarray(hm), jnp.int32(2), jnp.int32(1),
                               jnp.int32(2), jcfg,
                               tuple(jnp.int32(v) for v in ctx))
    one = lambda v: torch.tensor([v], dtype=torch.int32)
    got = E.choose_placement(torch.from_numpy(hm)[None], one(2), one(1),
                             one(2), cfg, tuple(one(v) for v in ctx))
    assert [int(v) for v in got] == [int(v) for v in want]
    assert int(got[0]) == 2 and int(got[2]) == 0
    with pytest.raises(ValueError, match="score_ctx"):
        E.choose_placement(torch.from_numpy(hm)[None], one(2), one(1),
                           one(2), cfg)


# --------------------------------------------------------------------- #
# the kernels' plain versions under mcs against the JAX kernels

KERNEL_CASES = {
    "2d": dict(allow_rot=True, reward_type="C+P+S-mcs-soft"),
    "3d": dict(dim=3, num_blocks=8, min_blocks=8, container_width=6,
               container_depth=6, container_height=6, target_width=6,
               target_depth=6, num_containers=2,
               reward_type="C+P+S-mcs-hard"),
}
KB = 128  # one batch tile of the JAX kernels


def _mid_rollout(cfg, seed):
    """Instances, a state after N/2 random feasible steps, the last actions
    and the rng that drew them."""
    inst = sample_batch(R.key(seed), KB, cfg)
    state = E.reset(inst, cfg)
    rng = np.random.default_rng(seed)
    prev = np.full((KB,), -1, np.int32)
    for _ in range(cfg.num_blocks // 2):
        mask = E.action_mask(state, inst, cfg).numpy()
        u = rng.random(mask.shape) * mask
        prev = np.where(mask.any(1), u.argmax(1), -1).astype(np.int32)
        state = E.step(state, torch.from_numpy(prev), inst, cfg)
    return inst, state, prev, rng


def _state_operands(cfg, inst, state):
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    return dict(
        packed=state.packed.T.int().numpy(),
        hm=state.heightmap.permute(1, 2, 3, 0).reshape(C * W, D, KB).numpy(),
        plc=state.placements.permute(1, 2, 0).reshape(N * 6, KB).numpy(),
        dims_w=inst.dims[:, :, 0].T.numpy(),
        dims_d=inst.dims[:, :, 1].T.numpy(),
        dims_h=inst.dims[:, :, 2].T.numpy())


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_select_place_ref_mcs_matches_jax_kernel(name):
    kw = KERNEL_CASES[name]
    cfg, jcfg = TAPConfig(**kw), JTAPConfig(**kw)
    inst, state, _, rng = _mid_rollout(cfg, seed=7)
    mask = E.action_mask(state, inst, cfg).T.int().contiguous().numpy()
    logits = rng.standard_normal(mask.shape).astype(np.float32)
    score = np.where(mask == 1, logits, np.float32(-1e9))
    ops = dict(score=score, mask=mask, **_state_operands(cfg, inst, state))
    ops = {k: np.ascontiguousarray(v) for k, v in ops.items()}
    want = JPS.select_step(*(jnp.asarray(v) for v in ops.values()),
                           cfg=jcfg, interpret=True)
    got = PS.select_step(*(torch.from_numpy(v) for v in ops.values()),
                         cfg=cfg)
    for label, w, g in zip(("packed", "hm", "plc", "act"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=label)
    assert (got[3].numpy() >= 0).any()
    # the rule is not lb in disguise: some placement differs from lb's
    lb = PS.select_step(*(torch.from_numpy(v) for v in ops.values()),
                        cfg=TAPConfig(**{**kw, "reward_type": kw[
                            "reward_type"].replace("mcs", "lb")}))
    assert not torch.equal(lb[2], got[2])


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_actor_select_step_ref_mcs_matches_jax_kernel(name):
    kw = KERNEL_CASES[name]
    cfg, jcfg = TAPConfig(**kw), JTAPConfig(**kw)
    hidden = 32
    N, A, T = cfg.num_blocks, cfg.num_actions, cfg.num_blocks * cfg.num_rot
    flax_params = jax_init_params(jax.random.key(3), jcfg, hidden)["actor"]
    actor = actor_from_flax(jax.tree.map(np.asarray, flax_params), cfg,
                            hidden)
    inst, state, prev, rng = _mid_rollout(cfg, seed=5)
    static = static_tokens(inst, cfg)
    static_t4 = static.permute(2, 1, 0).reshape(4, T * KB)
    with torch.no_grad():
        se_htb = embed_static_T(actor, static_t4).reshape(-1, T, KB)
    upm, rotm = AS.precedence_bitmasks(inst, cfg)
    so = _state_operands(cfg, inst, state)
    ops = [np.full((1, 1), (N // 2) / N, np.float32), so["packed"], so["hm"],
           so["plc"], prev[None], so["dims_w"], so["dims_d"], so["dims_h"],
           upm.numpy(), rotm.numpy(), AS.fits_planes(inst, cfg).numpy(),
           rng.gumbel(size=(A, KB)).astype(np.float32),
           se_htb.permute(1, 0, 2).numpy(), se_htb.mean(1).numpy(),
           static_t4.reshape(4, T, KB).numpy(), static.mean(1).T.numpy()]
    ops = [np.ascontiguousarray(o) for o in ops]
    with jax.default_matmul_precision("highest"):
        want = JAS.actor_select_step(
            *(jnp.asarray(o) for o in ops),
            JAS.head_operands(flax_params, jcfg, jnp.float32),
            cfg=jcfg, temperature=0.7, interpret=True)
    port_ops = [torch.from_numpy(o) for o in ops]
    port_ops[12] = port_ops[12].permute(2, 0, 1).contiguous()  # [B, T, h]
    got = AS.actor_select_step(*port_ops, AS.head_operands(actor, cfg),
                               cfg, temperature=0.7)
    labels = ("packed", "hm", "plc", "act", "flags", "mask", "logits", "logp")
    for label, w, g in zip(labels, want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.shape == g.shape, label
        if label in ("logits", "logp"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=label)
        else:
            np.testing.assert_array_equal(g, w, err_msg=label)
    assert (got[3] >= 0).all()
