"""The bf16 compute dtype: tapnet_torch against tapnet_tpu with
`dtype=jnp.bfloat16` (the JAX train step's accelerator dtype).

Parameters come from the JAX package (flax init_params through
convert.py), inputs from a numpy seed; the JAX side runs at matmul
precision "highest". Like is compared with like (SPEC.md §12 tier 2 in
bf16: logits to about 1e-2, validation distributional):

1. the bf16 actor head, `embed_static`, `embed_static_T`, the windowed
   head and the critic against flax with `dtype=jnp.bfloat16` (2d-basic,
   3d-basic, 2d-rolling);
2. the plain bf16 K2 (both modes) against the Pallas `actor_select_step(
   dtype=bfloat16, interpret=True)` in lockstep over a whole sampled
   rollout (2d-basic, 2d-rolling): logits within LOGIT_TOL, integer outputs
   equal where the actions agree, action agreement > 0.99 at every step;
   and with its products summed as the card's tensor cores sum them
   (chunks of 16 along k), within `chip_smoke.py` phase 24's gate;
3. (tests/test_torch_bf16_k5.py) the plain bf16 K5, monolithic and
   step-grid, against the Pallas replay kernels in bf16
   (`replay_logp_fused`, the function `replay_logp_sum(kernel=True)`
   calls) on JAX's own bf16 operands (2d-basic, 2d-rolling;
   interpret mode, once per config in a module fixture; on 2d-basic the JAX
   side runs its step-grid schedule, the same function: its monolithic
   kernels stop on this CPU's XLA, which has no bf16 x bf16 -> f32 dot).
   The value within K5_VALUE_TOL (relative), each of the 13 gradients within
   K5_GRAD_TOL of its largest magnitude: one bf16 ulp (2^-7 at most) of
   that magnitude, as both sides cast the gradient to bf16, with a margin.
   The float32 plain K5 on the same operands must fall outside both;
4. (tests/test_torch_bf16_k5.py) the general and the windowed bf16
   replays against JAX's `kernel=False` replays;
5. one bf16 train step against JAX `make_train_step(compute_dtype=
   bfloat16)`'s loss and gradients on JAX's recorded actions (teacher
   forced), the metrics of a whole step, the tpu_parity.py gate (action
   agreement > 0.9, mean reward |diff| < 0.02) on free rollouts, and the
   bf16 step on the six CONFIGS;
6. the port's general bf16 rollouts against its K2 route on the CPU (the
   same gate);
7. `routes` and `eligible` with a dtype.

The two JAX paths are further apart in bf16 than either is from its port
counterpart (the kernels multiply by v in f32 and take exact count
summaries; the flax head does neither), so no test holds one JAX path to
the other's port.

The Pallas kernels run compiled with XLA's `xla_allow_excess_precision`
off (`_compile_strict`). By default XLA:CPU may fold a round trip through
bf16 away, such as each score's `.astype(bf16).astype(f32)` in the
kernels, so the interpret run would skip roundings the kernel source
writes.

Gradients of the flax path (4 and 5): each leaf's largest difference from
JAX's, over the leaf's largest magnitude, is at most GRAD_TOL plus JAX's
own distance from the float32 gradient on the same record (the port's
float32 path, held to JAX's float32 elsewhere), measured the same way. JAX
differentiates the bf16 graph with bf16 reductions: on 2d-rolling its
gradient of dyn_hidden.bias, a sum over ~8,000 token rows, is 40% of the
leaf's magnitude from the float32 gradient, where the port's (float32
accumulation, one rounding) is 2.3%.

Each comparison with JAX prints its reading (`pytest -s`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tapnet_torch as T
from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.config import TAPConfig as JTAPConfig
from tapnet_tpu.env import core as JE
from tapnet_tpu.env.sampler import sample_batch as jax_sample_batch
from tapnet_tpu.models import features as JF
from tapnet_tpu.models.tapnet import TAPNetActor as JActor
from tapnet_tpu.models.tapnet import TAPNetCritic as JCritic
from tapnet_tpu.models.tapnet import embed_static_T as jax_embed_static_T
from tapnet_tpu.models.tapnet import init_params as jax_init_params
from tapnet_tpu.ops import pallas_actor_step as JAS
from tapnet_tpu.train import reinforce as JR
from tapnet_tpu.train import rollout as JRO
from tapnet_torch.config import CONFIGS, TAPConfig
from tapnet_torch.convert import flax_to_state_dict, params_from_flax
from tapnet_torch.env import core as E
from tapnet_torch.models import features as F
from tapnet_torch.models.tapnet import embed_static_T
from tapnet_torch.ops import actor_step as AS
from tapnet_torch.ops import policy_step as PS
from tapnet_torch.ops import replay as RP
from tapnet_torch.ops.reward import fused_reward
from tapnet_torch.train import reinforce as TR
from tapnet_torch.train import rollout as RO
from tapnet_torch.types import Instance

BF = torch.bfloat16
JBF = jnp.bfloat16
HIDDEN = 32
LOGIT_TOL = 1e-2    # bf16 logits, absolute (SPEC.md §12)
EMB_TOL = 3e-2      # bf16 activations, of the tensor's max magnitude
VALUE_TOL = 1e-2    # replayed logp and losses, relative
GRAD_TOL = 8e-2     # each gradient leaf, of its max magnitude (module doc)
ROLLING = dict(num_blocks=12, min_blocks=6, container_width=8,
               container_height=12, target_width=8, window=4, allow_rot=True)


def _configs(name):
    if name == "rolling-small":
        return TAPConfig(**ROLLING), JTAPConfig(**ROLLING)
    return CONFIGS[name], JCONFIGS[name]


def _t(x):
    return torch.from_numpy(np.array(x))


def _f32(x):
    """A JAX or torch bf16 array as a float32 numpy array (exact)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _scaled_close(got, want, tol, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) + 1e-9
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: scaled err {err}"
    return err


@functools.cache
def _setup(name, B=16, seed=3):
    """Weights, instances, a mid-rollout state and a JAX bf16 record."""
    cfg, jcfg = _configs(name)
    params = jax.jit(jax_init_params, static_argnums=(1, 2))(
        jax.random.key(seed), jcfg, HIDDEN)
    actor, critic = params_from_flax(jax.tree.map(np.asarray, params), cfg,
                                     HIDDEN)
    instances = jax.jit(jax_sample_batch, static_argnums=(1, 2))(
        jax.random.key(seed + 1), B, jcfg)
    keys = jax.random.split(jax.random.key(seed + 2), B)
    with jax.default_matmul_precision("highest"):
        states, record, logp = jax.jit(
            lambda p, i, k: JRO.rollout_batch_record(
                p, i, k, jcfg, hidden=HIDDEN, dtype=JBF, step_kernel=False,
                actor_kernel=False))(params["actor"], instances, keys)
    inst = Instance(*(_t(x) for x in instances))
    return dict(cfg=cfg, jcfg=jcfg, params=params, actor=actor,
                critic=critic, instances=instances, inst=inst, keys=keys,
                tkeys=_t(jax.random.key_data(keys)).long(), states=states,
                record=record, logp=logp,
                rec=RO.RolloutRecord(*(_t(x) for x in record)))


def _mid_inputs(s, k=None):
    """Head inputs at decode step k of the JAX record, both sides."""
    cfg = s["cfg"]
    k = cfg.num_blocks // 3 if k is None else k
    flags, hm = s["rec"].flags[k], s["rec"].heightmap[k]
    prev = s["rec"].action[k - 1]
    static = F.static_tokens(s["inst"], cfg)
    dynamic = F.merge_tokens(static, F.tokens_from_flags(
        flags, torch.tensor(k / cfg.num_blocks), cfg))
    return static, dynamic, F.heightmap_grid(hm, cfg), prev


# ---- 1. the model in bf16 against flax --------------------------------- #

@pytest.mark.parametrize("name", ["2d-basic", "3d-basic", "2d-rolling"])
def test_model_matches_flax_bf16(name):
    s = _setup(name)
    cfg, jcfg = s["cfg"], s["jcfg"]
    actor, critic = s["actor"], s["critic"]
    static, dynamic, hmg, prev = _mid_inputs(s)
    B, T = static.shape[:2]
    jactor = JActor(jcfg, HIDDEN, dtype=JBF)
    ap = s["params"]["actor"]
    with jax.default_matmul_precision("highest"):
        emb_j = jax.jit(jax.vmap(lambda x: jactor.apply(
            ap, x, method=JActor.embed_static)))(static.numpy())
        logits_j = jax.jit(jax.vmap(lambda se, dy, hg, pa: jactor.apply(
            ap, se, dy, hg, pa, method=JActor.head)))(
                emb_j, dynamic.numpy(), hmg.numpy(), prev.numpy())
        st4 = static.permute(2, 1, 0).reshape(4, -1).numpy()
        embT_j = jax.jit(lambda p, x: jax_embed_static_T(p, x, JBF))(ap, st4)
        s0 = jax.vmap(lambda i: JE.reset(i, jcfg))(s["instances"])
        v_j = jax.jit(jax.vmap(lambda i, st: JCritic(jcfg, HIDDEN, dtype=JBF)
                               .apply(s["params"]["critic"],
                                      *JF.build_tokens(i, st, jcfg))))(
            s["instances"], s0)
    with torch.no_grad():
        emb = actor.embed_static(static, BF)
        assert emb.dtype == BF
        e_emb = _scaled_close(emb, emb_j, EMB_TOL, "embed_static")
        # the head on flax's own keys: the head alone
        logits = actor.head(torch.from_numpy(_f32(emb_j)).to(BF), dynamic,
                            hmg, prev, BF)
        assert logits.dtype == torch.float32
        err = np.abs(logits.numpy() - _f32(logits_j)).max()
        assert err <= LOGIT_TOL, f"head logits: max err {err}"
        embT = embed_static_T(actor, static.permute(2, 1, 0).reshape(4, -1),
                              BF)
        assert embT.dtype == BF
        e_embT = _scaled_close(embT, embT_j, EMB_TOL, "embed_static_T")
        V = critic(*F.build_tokens(s["inst"], E.reset(s["inst"], cfg), cfg),
                   BF)
        assert V.dtype == torch.float32
        np.testing.assert_allclose(V.numpy(), _f32(v_j), atol=LOGIT_TOL,
                                   err_msg="critic")
    print(f"\n{name} model: embed_static {e_emb:.2e}, head logits {err:.2e}, "
          f"embed_static_T {e_embT:.2e}, critic "
          f"{np.abs(V.numpy() - _f32(v_j)).max():.2e}")


def test_windowed_head_matches_jax_bf16():
    s = _setup("2d-rolling")
    cfg, jcfg = s["cfg"], s["jcfg"]
    k = cfg.num_blocks // 3
    flags, hm = np.asarray(s["record"].flags[k]), np.asarray(
        s["record"].heightmap[k])
    prev = np.asarray(s["record"].action[k - 1])
    t_frac = np.float32(k) / cfg.num_blocks
    jactor = JActor(jcfg, HIDDEN, dtype=JBF)

    def jax_head(params, instances):
        static = jax.vmap(lambda i: JF.static_tokens(i, jcfg))(instances)
        emb = jactor.apply(params, static, method=JActor.embed_static)
        head = JRO._make_windowed_head(jactor, params, instances, static,
                                       emb, jcfg, HIDDEN, JBF)
        return emb, head(flags, hm, prev, t_frac)

    with jax.default_matmul_precision("highest"):
        emb_j, want = jax.jit(jax_head)(s["params"]["actor"],
                                        s["instances"])
    actor, inst = s["actor"], s["inst"]
    with torch.no_grad():
        static = F.static_tokens(inst, cfg)
        emb = torch.from_numpy(_f32(emb_j)).to(BF)   # the head alone
        head = RO._make_windowed_head(actor, inst, static, emb, cfg, BF)
        got = head(_t(flags), _t(hm), _t(prev), float(t_frac))
    err = np.abs(got.numpy() - _f32(want)).max()
    assert err <= LOGIT_TOL, f"windowed head: max err {err}"
    print(f"\nwindowed head logits: max err {err:.2e}")


# ---- 2. plain bf16 K2 against the Pallas kernel ------------------------ #

def _compile_strict(f, *args):
    """f compiled for args with `xla_allow_excess_precision` off (module
    doc): every bf16 rounding the source writes is kept."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _port(x):
    """A JAX or numpy operand as a torch tensor in its dtype (bf16 exact)."""
    if getattr(x, "dtype", None) == JBF:
        return torch.from_numpy(_f32(x)).to(BF)
    return torch.from_numpy(np.array(x))


def _k2_operands(s):
    """The first decode step's operands (reset state, prev -1), the float
    ones from the JAX side in bf16; numpy or JAX, batch-last."""
    cfg, jcfg, params = s["cfg"], s["jcfg"], s["params"]["actor"]
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    T = N * cfg.num_rot
    inst = s["inst"]
    B = inst.dims.shape[0]
    state = E.reset(inst, cfg)
    static = F.static_tokens(inst, cfg)
    st4 = static.permute(2, 1, 0).reshape(4, T * B).numpy()
    with jax.default_matmul_precision("highest"):
        se_htb = jax.jit(lambda p, x: jax_embed_static_T(p, x, JBF))(
            params, st4).reshape(-1, T, B)
    upm, rotm = AS.precedence_bitmasks(inst, cfg)
    return [
        np.zeros((1, 1), np.float32),
        state.packed.T.int().numpy(),
        state.heightmap.permute(1, 2, 3, 0).reshape(C * W, D, B).numpy(),
        state.placements.permute(1, 2, 0).reshape(N * 6, B).numpy(),
        np.full((1, B), -1, np.int32),
        inst.dims[:, :, 0].T.numpy(), inst.dims[:, :, 1].T.numpy(),
        inst.dims[:, :, 2].T.numpy(), upm.numpy(), rotm.numpy(),
        AS.fits_planes(inst, cfg).numpy(),
        np.zeros((cfg.num_actions, B), np.float32),
        jnp.transpose(se_htb, (1, 0, 2)), se_htb.mean(axis=1),
        jnp.asarray(st4.reshape(4, T, B), JBF),
        jnp.asarray(static.numpy(), JBF).mean(axis=1).T]


K2_LABELS = ("packed", "hm", "plc", "act", "flags", "mask", "logits", "logp")


@functools.cache
def _k2_trajectory(name):
    """The Pallas bf16 K2 over a whole sampled rollout at temperature 0.7,
    from the reset state (prev -1, t = 0) to the last step: per step the
    operands as the port takes them (se as [B, T, h]) and the kernel's
    outputs as float32 numpy. Each step starts from the kernel's previous
    outputs, so the trajectory is the JAX side's alone."""
    s = _setup(name, B=128)
    cfg, jcfg = s["cfg"], s["jcfg"]
    N = cfg.num_blocks
    ops = _k2_operands(s)
    jparams = JAS.head_operands(s["params"]["actor"], jcfg, JBF)
    step = lambda o, p: JAS.actor_select_step(
        *o, p, cfg=jcfg, temperature=0.7, dtype=JBF, interpret=True)
    with jax.default_matmul_precision("highest"):
        step = _compile_strict(step, [jnp.asarray(o) for o in ops], jparams)
    rng = np.random.default_rng(11)
    steps = []
    for k in range(N):
        ops[11] = rng.gumbel(size=ops[11].shape).astype(np.float32)
        want = step([jnp.asarray(o) for o in ops], jparams)
        pops = [_port(o) for o in ops]
        pops[12] = pops[12].permute(2, 0, 1).contiguous()  # se as [B, T, h]
        steps.append((pops, {lab: _f32(v) for lab, v in zip(K2_LABELS,
                                                            want)}))
        ops[0] = np.full((1, 1), (k + 1) / N, np.float32)
        ops[1], ops[2], ops[3] = (np.asarray(want[i]) for i in range(3))
        ops[4] = np.asarray(want[3])[None]
    return steps


@pytest.mark.parametrize("name", ["2d-basic", "2d-rolling"])
def test_plain_k2_bf16_matches_jax_kernel(name):
    """A whole sampled rollout in lockstep: every step, from the reset state
    (prev -1, t = 0) to the last, runs the Pallas kernel and the plain K2
    (both modes) on the same pre-step state, then both go on from the
    kernel's next state (`_k2_trajectory`)."""
    s = _setup(name, B=128)
    cfg = s["cfg"]
    N = cfg.num_blocks
    params = AS.head_operands(s["actor"], cfg, BF)
    assert [p.dtype for p in params] == [BF] * 10 + [torch.float32]
    worst, agree = 0.0, []
    for k, (pops, w) in enumerate(_k2_trajectory(name)):
        full = AS.actor_select_step(*pops, params, cfg, temperature=0.7)
        live = AS.actor_select_step(*pops, params, cfg, temperature=0.7,
                                    logits=False)
        same = full[3].numpy() == w["act"]
        agree.append(same.mean())
        err = np.abs(full[6].numpy() - w["logits"]).max()
        assert err <= LOGIT_TOL, f"step {k} logits: max err {err}"
        worst = max(worst, float(err))
        for got in (full, live):
            g = dict(zip(K2_LABELS, got))
            np.testing.assert_array_equal(g["act"], full[3])
            for lab in ("flags", "mask"):
                np.testing.assert_array_equal(g[lab].numpy(), w[lab],
                                              err_msg=f"step {k} {lab}")
            for lab in ("packed", "hm", "plc"):
                np.testing.assert_array_equal(
                    g[lab].numpy()[..., same], w[lab][..., same],
                    err_msg=f"step {k} {lab}")
            np.testing.assert_allclose(g["logp"].numpy()[same],
                                       w["logp"][same], atol=LOGIT_TOL,
                                       rtol=VALUE_TOL, err_msg=f"step {k}")
    assert len(agree) == N and min(agree) > 0.99, agree
    print(f"\n{name} K2 lockstep: {N} steps, logits max err {worst:.3e}, "
          f"action agreement >= {min(agree):.4f}")


# chip_smoke.py phase 24's gate for K2 bf16 against its plain version:
# BF16_ATOL + BF16_RTOL |x| for logits and logp, BF16_AGREE for the actions
CARD_ATOL, CARD_RTOL, CARD_AGREE = 1e-2, 2.0 ** -7, 0.99


def _tc_matmul(a, b):
    """a @ b (float32 operands holding bfloat16 values) summed as
    mma.sync.m16n8k16 bf16 x bf16 + f32 does: the exact products of each
    chunk of 16 along k summed (in float64) and rounded to float32, the
    chunks added into a float32 accumulator in k order."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 16):
        acc = acc + (a[:, k0:k0 + 16].double()
                     @ b[k0:k0 + 16].double()).float()
    return acc


class _TensorCoreSums(torch.overrides.TorchFunctionMode):
    """Inside it, every matrix product with k > 8 is `_tc_matmul`: the
    products K2 bf16 runs on the tensor cores (W1, W2, Wq, Wp); W8 x8 (k
    = 8) stays a float32 product, as the kernel keeps it SIMT. Counts the
    products it took and those whose sums came out other than float32's."""

    def __init__(self):
        super().__init__()
        self.products = self.moved = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func in (torch.Tensor.__matmul__, torch.Tensor.matmul,
                     torch.matmul)
                and args[0].dim() == 2 and args[0].shape[1] > 8):
            out = _tc_matmul(*args)
            self.products += 1
            self.moved += not torch.equal(out, func(*args))
            return out
        return func(*args, **(kwargs or {}))


def _card_close(what, got, want):
    d = np.abs(got - want)
    assert (d <= CARD_ATOL + CARD_RTOL * np.abs(want)).all(), \
        f"{what}: max err {d.max()}"
    return float(d.max()) if d.size else 0.0


@pytest.mark.parametrize("name", ["2d-basic", "2d-rolling"])
def test_tensor_core_sums_meet_the_card_gate(name):
    """K2 bf16 on the card sums its products on the tensor cores, in their
    own order. The plain bf16 K2 (both modes) with every product so
    grouped (`_TensorCoreSums`) against the Pallas kernel in lockstep (the
    trajectory of the test above) meets phase 24's gate unchanged: logits,
    and logp where the actions agree, within CARD_ATOL + CARD_RTOL |x|;
    flags and mask equal; the state rows equal where the actions agree;
    the actions agreeing on more than CARD_AGREE of the acting (instance,
    step) pairs."""
    s = _setup(name, B=128)
    cfg = s["cfg"]
    params = AS.head_operands(s["actor"], cfg, BF)
    worst = moved = 0.0
    agree = pairs = 0
    mode = _TensorCoreSums()
    for k, (pops, w) in enumerate(_k2_trajectory(name)):
        with mode:
            full = AS.actor_select_step(*pops, params, cfg, temperature=0.7)
            live = AS.actor_select_step(*pops, params, cfg, temperature=0.7,
                                        logits=False)
        plain = AS.actor_select_step(*pops, params, cfg, temperature=0.7)
        moved = max(moved, float((full[6] - plain[6]).abs().max()))
        worst = max(worst, _card_close(f"step {k} logits", full[6].numpy(),
                                       w["logits"]))
        same = full[3].numpy() == w["act"]
        acting = w["act"] >= 0
        agree += int((same & acting).sum())
        pairs += int(acting.sum())
        for got in (full, live):
            g = dict(zip(K2_LABELS, got))
            np.testing.assert_array_equal(g["act"], full[3])
            for lab in ("flags", "mask"):
                np.testing.assert_array_equal(g[lab].numpy(), w[lab],
                                              err_msg=f"step {k} {lab}")
            for lab in ("packed", "hm", "plc"):
                np.testing.assert_array_equal(
                    g[lab].numpy()[..., same], w[lab][..., same],
                    err_msg=f"step {k} {lab}")
            worst = max(worst, _card_close(f"step {k} logp",
                                           g["logp"].numpy()[same],
                                           w["logp"][same]))
    assert agree / max(pairs, 1) > CARD_AGREE, (agree, pairs)
    # every step's W1, W2, Wq and Wp products in both modes, and most sums
    # reordered
    assert mode.products == 2 * 4 * len(_k2_trajectory(name))
    assert mode.moved > mode.products // 2, (mode.moved, mode.products)
    print(f"\n{name} K2 with tensor-core sums vs the Pallas kernel: max "
          f"logit/logp err {worst:.3e}; {mode.moved} of {mode.products} "
          f"products summed to other float32 values, the scores moved by "
          f"up to {moved:.3e}; action agreement {agree / pairs:.4f}")


# ---- the replays' value and gradients, shared with
# tests/test_torch_bf16_k5.py (sections 3 and 4) ------------------------ #

def _port_value_and_grad(actor, inst, rec, cfg, dlp, dtype=BF, **kw):
    actor.zero_grad(set_to_none=True)
    lp = RO.replay_logp_sum(actor, inst, rec, cfg, dtype=dtype, **kw)
    assert lp.dtype == torch.float32
    (lp * torch.from_numpy(dlp)).sum().backward()
    return lp.detach(), {n: p.grad.clone() for n, p in
                         actor.named_parameters()}


def _grads_close(want_tree, got, ref):
    """Every leaf of `got` within GRAD_TOL (scaled) of JAX's bf16 gradient
    `want_tree`, plus JAX's own scaled distance from `ref`, the float32
    gradient of the same function (module doc). Returns the largest scaled
    difference."""
    want = flax_to_state_dict(jax.tree.map(np.asarray, want_tree))
    assert set(want) == set(got) == set(ref)
    worst = 0.0
    for n, w in want.items():
        w = w.numpy()
        scale = float(np.abs(w).max()) + 1e-9
        own = float(np.abs(w - ref[n].numpy()).max()) / scale
        worst = max(worst, _scaled_close(got[n], w, GRAD_TOL + own, n))
    return worst


# ---- 5. the bf16 train step ------------------------------------------- #

def test_train_step_loss_and_gradients_match_jax_bf16():
    """JAX's bf16 losses and gradients against the port's on JAX's own
    record (teacher forced): instances, record, final states and rewards
    from the JAX rollout, the replay, critic and losses on both sides."""
    s = _setup("2d-basic", B=32)
    cfg, jcfg = s["cfg"], s["jcfg"]

    def loss(p):
        a, c, _, _ = JR._batch_losses(p, s["instances"], s["keys"], jcfg,
                                      HIDDEN, 1.0, False, dtype=JBF,
                                      step_kernel=False, actor_kernel=False)
        return a + c, (a, c)

    with jax.default_matmul_precision("highest"):
        grads, (a_j, c_j) = jax.jit(jax.grad(loss, has_aux=True))(
            s["params"])
    inst, rec, st = s["inst"], s["rec"], s["states"]
    _, _, _, Rw = fused_reward(_t(st.heightmap), _t(st.placements),
                               inst.dims, cfg.reward_terms)
    got = {}
    for dt in (BF, torch.float32):
        actor, critic = params_from_flax(
            jax.tree.map(np.asarray, s["params"]), cfg, HIDDEN)
        logp = RO.replay_logp_sum(actor, inst, rec, cfg, dtype=dt)
        V = critic(*F.build_tokens(inst, E.reset(inst, cfg), cfg), dt)
        a = -((Rw - V.detach()) * logp).mean()
        c = ((V - Rw) ** 2).mean()
        (a + c).backward()
        got[dt] = (a.item(), c.item(),
                   {n: p.grad for n, p in actor.named_parameters()},
                   {n: p.grad for n, p in critic.named_parameters()})
    a, c, g_actor, g_critic = got[BF]
    np.testing.assert_allclose(c, float(c_j), rtol=VALUE_TOL)
    np.testing.assert_allclose(a, float(a_j), rtol=VALUE_TOL, atol=1e-3)
    wa = _grads_close(grads["actor"], g_actor, got[torch.float32][2])
    wc = _grads_close(grads["critic"], g_critic, got[torch.float32][3])
    print(f"\nteacher-forced step: actor loss {abs(a - float(a_j)):.2e}, "
          f"critic loss {abs(c / float(c_j) - 1):.2e} (relative), grads "
          f"actor {wa:.2e} critic {wc:.2e}")


def _gate(actions_a, actions_b, reward_a, reward_b):
    """tpu_parity.py's bf16 gate: action agreement over the record and the
    mean reward's absolute difference."""
    agree = float((np.asarray(actions_a) == np.asarray(actions_b)).mean())
    drew = abs(float(np.mean(reward_a)) - float(np.mean(reward_b)))
    assert agree > 0.9 and drew < 0.02, (agree, drew)
    return agree, drew


def test_train_step_matches_jax_bf16():
    """A whole bf16 step from the same state and key: the free rollouts pass
    the parity gate; the reward terms' means and the losses agree."""
    cfg, jcfg = CONFIGS["2d-basic"], JCONFIGS["2d-basic"]
    B = 32
    jts = jax.jit(JR.init_train_state, static_argnums=(1, 2))(
        jax.random.key(0), jcfg, HIDDEN)
    actor, critic = params_from_flax(jax.tree.map(np.asarray, jts.params),
                                     cfg, HIDDEN)
    ts = TR.train_state(actor, critic, _t(jax.random.key_data(jts.key)
                                           ).long())
    with jax.default_matmul_precision("highest"):
        _, m_j = JR.make_train_step(jcfg, batch=B, hidden=HIDDEN,
                                    compute_dtype=JBF)(jts)
    _, m = T.make_train_step(cfg, batch=B, hidden=HIDDEN, device="cpu",
                             compute_dtype=BF)(ts)
    diff = {k: abs(float(m[k]) - float(m_j[k])) for k in ("reward", "C",
                                                          "P", "S")}
    for k, d in diff.items():
        assert d < 0.02, k
    print(f"\nwhole step: metric diffs {diff}")
    np.testing.assert_allclose(float(m["loss_critic"]),
                               float(m_j["loss_critic"]), rtol=0.1)
    assert np.isfinite(float(m["grad_norm"]))


def test_free_rollouts_pass_the_parity_gate():
    s = _setup("2d-basic", B=128)
    cfg = s["cfg"]
    st, rec, _ = RO.rollout_batch_record(s["actor"], s["inst"], s["tkeys"],
                                         cfg, dtype=BF)
    R_j = jax.vmap(lambda x, i: JE.reward(x, i, s["jcfg"]))(s["states"],
                                                           s["instances"])
    print("\nfree rollouts vs JAX: agreement %.4f, reward diff %.2e" % _gate(
        rec.action.numpy(), s["record"].action,
        E.reward(st, s["inst"], cfg).numpy(), np.asarray(R_j)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_step_runs_on_every_config(name):
    cfg = CONFIGS[name]
    ts = T.init_train_state(0, cfg, hidden=HIDDEN, device="cpu")
    ts, m = T.make_train_step(cfg, batch=8, hidden=HIDDEN, device="cpu",
                              compute_dtype="bfloat16")(ts)
    assert all(np.isfinite(float(v)) for v in m.values()), m
    assert all(p.dtype == torch.float32 for p in ts.parameters())


# ---- 6. general route against the K2 route on the CPU ------------------ #

@pytest.mark.parametrize("name", ["2d-basic", "rolling-small"])
def test_general_rollouts_match_k2_route_bf16(name):
    s = _setup(name, B=128)
    cfg = s["cfg"]
    with torch.no_grad():
        st_g, rec_g, _ = RO.rollout_batch_record(
            s["actor"], s["inst"], s["tkeys"], cfg, dtype=BF)
        st_k, rec_k, lp_k = RO.rollout_batch_record(
            s["actor"], s["inst"], s["tkeys"], cfg, dtype=BF,
            actor_kernel=True)
        # the K2 route's logp is the replay kernels' value on its record
        lp_r = RO.replay_logp_sum(s["actor"], s["inst"], rec_k, cfg,
                                  kernel=True, dtype=BF)
    _gate(rec_g.action.numpy(), rec_k.action.numpy(),
          E.reward(st_g, s["inst"], cfg).numpy(),
          E.reward(st_k, s["inst"], cfg).numpy())
    np.testing.assert_allclose(lp_r.numpy(), lp_k.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---- 7. routes and eligible with a dtype ------------------------------- #

@pytest.mark.parametrize("name", list(CONFIGS))
def test_routes_and_eligible_with_a_dtype(name):
    cfg = CONFIGS[name]
    for h in (32, 128, 256):
        for f in (AS.eligible, RP.eligible):
            assert f(cfg, h, BF) == f(cfg, h, torch.float32) == f(cfg, h)
            assert not f(cfg, h, torch.float16)
        r = RO.routes(cfg, True, h, dtype=BF)
        assert r == RO.routes(cfg, True, h)
        half = RO.routes(cfg, True, h, dtype=torch.float16)
        assert half.decode == ("step" if PS.eligible(cfg) else "general")
        assert not half.replay
        assert RO.routes(cfg, False, h, dtype=BF) == RO.Routes(
            "general", False, False)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        AS._check_cfg(CONFIGS["2d-basic"], 32, torch.float16)


def test_compute_dtype_values():
    assert TR.compute_dtype_of(None) == torch.float32
    assert TR.compute_dtype_of("float32") == torch.float32
    assert TR.compute_dtype_of(torch.bfloat16) == BF
    assert TR.compute_dtype_of("bfloat16") == BF
    for bad in (torch.float16, "float16", jnp.bfloat16):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TR.compute_dtype_of(bad)
