"""actor_select_step: one whole decode step of the learned policy, batch-last.

Port of `tapnet_tpu/ops/pallas_actor_step.py`: accessibility from
precedence bitmasks -> flags -> mask -> heightmap encoder, previous-action
embedding, query and per-token dyn MLP -> additive attention -> masked
(tempered) logits + gumbel -> select/place -> log pi of the chosen action.

Exactness (SPEC.md §12): the integer outputs (flags, mask, env state,
actions given equal argmax) are bit-equal to the JAX kernel; logits and
logp follow the same formula with the same f32 rounding points, and agree
to accumulation-order tolerance.

Two modes. The full one (`logits=True`) scores every token and returns the
logits [A, B]. The decode loop's mode (`logits=False`, what
`train/rollout.py` runs) scores only the live columns (`live_columns`: the
pairs (instance, token) whose mask allows the token in some container) and
returns None for the logits: every other action scores -1e9 masked, adds
exactly 0 to the softmax (exp(-1e9 - max) is 0 in f32) and never wins the
gumbel argmax while any action is valid, so action, state, flags and mask
are the full mode's and logp its sum less exact zeros.

- `actor_select_step_ref`: the plain PyTorch version of the full mode (the
  JAX kernel's formula as batched tensor ops), the reference the kernel is
  held to; `actor_select_step_live_ref`: the plain version of the live
  mode;
- `actor_select_step`: on a CPU tensor the plain version of the mode asked
  for; on a CUDA tensor it launches `csrc/actor_step.cu` on the current
  stream and counts it in `actor_select_step.launches`.

Coverage, as the JAX kernel's: both placement rules (`lb`, `mcs`),
unbounded height, N <= 62. The precedence graphs arrive as column bitmasks
in L = ceil(N/31) limbs of 31 bits; a rolling window is cut inside the
kernel (rank[i] = accessible blocks before i, win = acc0 & rank < window),
written to flag bit 3 and used for the mask, the count summary and the token
input; the tokens outside the window are masked, which gives the windowed
head's softmax exactly. A finite height cap is not covered, here as there:
its mask needs a candidate scan per action, and such configs decode through
`select_step`. The kernel's own limits (`eligible`): C <= 4, W*D <= 256, a
hidden width up to 512 (the kernel's widths, `kernel_width`, are the
multiples of 32 up to 256 and of 64 above: the WH body above 128 and its
WX form above 256; a width between them runs on operands padded with
zeros, `pad_head`, which changes no output), and a block's shared memory
within 227 KB; the routers (`train/rollout.py` `routes`) send any other
config down the step-fused path.

The static keys `se` are [B, T, h]: a column's keys are one contiguous row
(the JAX kernel's [T, h, B] transposed), built once per rollout.

Compute dtype (the JAX kernel's static `dtype`). The float operands se,
ctx, statp, statm and the head weights come in one dtype, float32 or
bfloat16 (`head_operands(actor, cfg, dtype)`; v, the gumbel and t/N stay
float32), and pick the kernel's instantiation. In bfloat16 every product
accumulates in float32 and is rounded to bfloat16 exactly where the JAX
kernel casts to its compute dtype (`rounder`): the count summary, the
normalised heightmap and its mean, each Dense output before and after its
bias, dyn, se + dyn, + q, tanh, and each score before it becomes the
float32 logit; the masking, the softmax, the gumbel argmax and log pi are
float32. The bfloat16 instantiation runs every product of the head on the
tensor cores (exact bf16 products summed in float32, in the tensor core's
order: a score can land one bf16 ulp from the plain version's) and reads
the weights in their [out, in] layout: it does not read `params_t`.

Above hidden 128 the head's products run once over a block's 32 instances
and stream the weights through a ring of bulk copies (csrc/actor_step.cu,
the WH design note). The query's step-invariant part, Wq_ctx ctx [h, B]
and Wq_emb E [h, A+1], is made once per rollout (`query_parts`, a kernel
of its own; plain version `query_parts_ref`) together with the ring slabs
of W1, W2 and Wq' = Wq's enc and dsum columns (`ring_slabs`):
`wide_operands`, which the decode loop calls beside `transposed` and which
`actor_select_step` calls itself when they are not given.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tapnet_torch.config import TAPConfig
from tapnet_torch.env.core import rotated_dims_all
from tapnet_torch.models.features import _scale
from tapnet_torch.ops import _build
from tapnet_torch.ops.policy_step import (MAX_WD, _check, env_ints,
                                          select_place_ref)

NEG = -1e9
MAX_C = 4  # csrc/actor_step.cu
MAX_N = 62  # two 31-bit precedence limbs
MAX_H = 512  # hidden: at most 512 (`kernel_width`)
SMEM_LIMIT = 232448  # bytes of shared memory a block may hold
TB = 32   # csrc/actor_step.cu: instances per block
WPS = 40  # csrc/actor_step.cu: bfloat16 row stride of the staged Wp
F32 = torch.float32
DTYPES = (torch.float32, torch.bfloat16)  # the kernels' instantiations


def rounder(dtype):
    """x -> x rounded to `dtype` (to nearest even) and back to float32: the
    cast to the compute dtype of the JAX kernels, on float32 values. The
    identity in float32."""
    if dtype == F32:
        return lambda x: x
    return lambda x: x.to(dtype).float()


def kernel_width(h: int) -> int:
    """The width the kernels run hidden h at: h rounded up to a multiple of
    32 up to 256, of 64 above (the WX products split the rows into two
    halves of a multiple of 32). The head operands of another width are
    padded to it with zeros (`pad_head`): hidden 48 does the work of 64."""
    return -(-h // 32) * 32 if h <= 256 else -(-h // 64) * 64


def geometry(h: int) -> dict:
    """The head's geometry at hidden width h (csrc/geo.cuh `Geo`, shared
    by csrc/actor_step.cu and csrc/replay.cu): up to 128 one pass over the
    tile's 32 instances, above (the replay's head) two passes of 16
    (`tp`), with the row stride of their [feature][instance] arrays
    (`lp`), the token group (`g` columns), the float32 weight slice (`ks`
    rows) and the products' row halves (`nh`: two above 256, WX)."""
    wc = 0 if h <= 128 else 1 if h <= 256 else 2
    tp = 16 if wc else TB
    return {"tp": tp, "lp": tp + 1, "g": (64, 32, 16)[wc],
            "ks": (64, 32, 16)[wc], "nh": 2 if wc == 2 else 1}


def _covers_config(cfg: TAPConfig) -> bool:
    return (cfg.target_height == 0 and cfg.num_blocks <= MAX_N
            and cfg.num_containers <= MAX_C
            and cfg.target_width * cfg.target_depth <= MAX_WD)


def eligible(cfg: TAPConfig, h: int = 128, dtype=F32) -> bool:
    """Configs the kernel covers at hidden width h and compute dtype
    `dtype`: unbounded height and bitmask-size precedence (N <= 62), as the
    JAX kernel (rolling windows are cut inside the kernel); the port's own
    limits: float32 or bfloat16, at most 4 containers, W*D <= 256 cells,
    1 <= h <= 512 (run at `kernel_width(h)` on padded operands) and a block
    that fits in shared memory (`smem_bytes`). The shipped configs fit at
    every such h; up to 256 the plan holds each container's queries for
    the whole tile, so with 3 or 4 containers (float32 2d-rolling: 2) the
    widest of those widths do not fit (tests/test_torch_k2_wide.py
    `FIRST_MISS`) and take the next route."""
    return (dtype in DTYPES and _covers_config(cfg) and 0 < h <= MAX_H
            and smem_bytes(cfg, kernel_width(h), dtype) <= SMEM_LIMIT)


def _check_cfg(cfg: TAPConfig, h: int = None, dtype=F32):
    """Raise NotImplementedError outside the config rule or, given h, the
    kernel's coverage."""
    if not _covers_config(cfg):
        raise NotImplementedError(
            f"actor_select_step covers unbounded height, N <= {MAX_N}, C <= "
            f"{MAX_C} and W*D <= {MAX_WD}, not {cfg}")
    if dtype not in DTYPES:
        raise NotImplementedError(
            f"actor_select_step computes in float32 or bfloat16, not {dtype}")
    if h is not None and (h != kernel_width(h) or not eligible(cfg, h,
                                                                dtype)):
        raise NotImplementedError(
            f"actor_select_step kernel covers a hidden width that is a "
            f"multiple of 32 up to 256 or of 64 up to {MAX_H} (pad_head "
            f"pads the others) with at most {SMEM_LIMIT} B of shared "
            f"memory per block, not hidden {h} "
            f"({smem_bytes(cfg, kernel_width(h), dtype)} B in {dtype}) on "
            f"{cfg}")


def _num_limbs(N: int) -> int:
    """31-bit int32 bitmask limbs covering N blocks (sign bit unused)."""
    return (N + 30) // 31


RING_K = 32  # csrc/ring_bf16.cuh: columns of a bfloat16 slab
RING_S = 3   # its stages
KR = RING_K // 2  # rows of a float32 slab of W^T (as many bytes)


def wh_rows(WD: int, h: int) -> int:
    """Rows of the WH plan's encoder view (csrc/actor_step.cu wh_rows):
    feats [W*D + 2], then [enc, dsum] [h + 8]."""
    return max(WD + 2, h + 8)


def xb_words(WD: int, h: int) -> int:
    """32-bit words of the bfloat16 instantiation's packed B operand at h <=
    128: the longest of the encoder/query products' k (W*D + 2 or 3h + 8),
    padded to 16, as pairs in rows of MMA_XS = 40 words
    (csrc/mma_bf16.cuh)."""
    k = max(WD + 2, 3 * h + 8)
    return (k + 15) // 16 * 8 * 40


def smem_bytes(cfg: TAPConfig, h: int, dtype=F32) -> int:
    """Shared memory of one block, in bytes, as
    csrc/actor_step.cu::smem_bytes computes it for the instantiation of
    `dtype`. At h <= 128 both hold their activations as float32, the
    head's arrays (the C queries, the encoder view, the token view) for the
    tile's 32 instances; the bfloat16 one's tensor-core plan holds Wp as
    bfloat16 rows of WPS in place of the float Wp^T, h1 rows padded to G +
    4, the token group's dyn [G][h+4], and in the token view the
    encoder/query weight slices as two bfloat16 slabs of h (64 + 8) / 2
    floats each beside the product's B operand as bfloat16 pairs
    (`xb_words`). Above 128: `_smem_bytes_wh`."""
    up4 = lambda x: (x + 3) & ~3
    tc = dtype == torch.bfloat16
    if h > 128:
        return _smem_bytes_wh(cfg, h, tc)
    geo = geometry(h)
    G, LP = geo["g"], geo["lp"]
    N, R, C = cfg.num_blocks, cfg.num_rot, cfg.num_containers
    WD = cfg.target_width * cfg.target_depth
    T = N * R
    A = T * C
    tok = 8 * G + 32 * (G + 4) + G * (h + 4) if tc else 40 * G
    stage = h * (64 + 8) + xb_words(WD, h) if tc else geo["ks"] * h
    floats = (up4(h * WPS // 2 if tc else 32 * h) + 256 + 32 + up4(h)
              + up4(C * h * LP) + A * TB + up4((WD + 2 + h + 3 * h + 8) * LP)
              + max(tok, stage,
                    (N + 2 * _num_limbs(N) * N + R * N) * TB,
                    (13 + 8 * 16 + C * WD + 3 * N) * TB))
    ints = 12 * TB + 4 * TB + TB + 2 + TB * T
    return 4 * (floats + ints)


def _smem_bytes_wh(cfg: TAPConfig, h: int, tc: bool) -> int:
    """`smem_bytes` above hidden 128 (csrc/actor_step.cu `layout_wh`): Wp
    (float Wp^T, or bfloat16 rows of WPS), W8, b8, v, the C queries [h][33]
    of the whole tile, the scores, the encoder view X [wh_rows][33] and e1
    [h][33] (bfloat16: copies [rows16][32] and [h][32] only), then the
    largest of the token view (G = 32), the weight ring's RING_S stages of
    h x RING_K bfloat16 and phase 0's and 3's rows, then the ring's
    mbarriers and counts and the 32 query columns. Above 256 (WX) the
    queries and the float X and e1 are in the block's scratch in device
    memory (`wx_scratch`), G = 16, and a stage holds a row half (h / 2
    rows)."""
    up4 = lambda x: (x + 3) & ~3
    N, R, C = cfg.num_blocks, cfg.num_rot, cfg.num_containers
    WD = cfg.target_width * cfg.target_depth
    geo = geometry(h)
    wx = geo["nh"] == 2
    T, A, G, LD = N * R, N * R * C, geo["g"], TB + 1
    XR = wh_rows(WD, h)
    enc = (((XR + 15) // 16 * 16 + h) * 16 if tc
           else 0 if wx else up4((XR + h) * LD))
    tok = 8 * G + 32 * (G + 4) + G * (h + 4) if tc else 40 * G
    floats = (up4(h * WPS // 2 if tc else 32 * h) + 256 + 32 + up4(h)
              + (0 if wx else up4(C * h * LD)) + A * TB + enc
              + max(tok, RING_S * (h // geo["nh"]) * RING_K // 2,
                    (N + 2 * _num_limbs(N) * N + R * N) * TB,
                    (13 + 8 * 16 + C * WD + 3 * N) * TB)
              + up4(3 * RING_S + TB))
    ints = 12 * TB + 4 * TB + TB + 2 + TB * T
    return 4 * (floats + ints)


def wx_scratch(cfg: TAPConfig, h: int, dtype=F32) -> int:
    """Floats of one block's scratch in device memory above hidden 256
    (csrc/actor_step.cu `wx_scratch`): the C queries [h][33], then in
    float32 the encoder view X [wh_rows][33] and e1 [h][33] (bfloat16
    keeps its copies in shared memory); 0 up to 256."""
    if h <= 256:
        return 0
    up4 = lambda x: (x + 3) & ~3
    WD = cfg.target_width * cfg.target_depth
    return (up4(cfg.num_containers * h * (TB + 1))
            + (0 if dtype == torch.bfloat16
               else up4((wh_rows(WD, h) + h) * (TB + 1))))


def pad_head(params, hk: int):
    """The head operands (`head_operands` order) of hidden width h padded
    with zeros to the width hk >= h the kernels run it at (`kernel_width`):
    the rows of Wp, W1, b1, W2, b2, E, Wq, bq and v, W2's columns and each
    of Wq's three h-wide column blocks (enc, ctx, embedding; the 8 dsum
    columns stay last). Inside K2 and K5 the head is affine maps, ReLU and
    tanh with no normalisation over the hidden axis, so a padded unit is 0
    everywhere (relu(0) = tanh(0) = 0, its v is 0): every score, log pi and
    the real units' values and gradients are those of hidden h (up to the
    order of f32 sums), and the pads' gradients are exactly 0. The
    operands themselves when hk = h."""
    h = params[8].shape[0]
    if hk == h:
        return tuple(params)
    F = torch.nn.functional
    rows = lambda t: F.pad(t, (0, 0, 0, hk - h))
    w2 = F.pad(params[5], (0, hk - h, 0, hk - h))
    wq = params[8]
    blk = [F.pad(wq[:, i * h:(i + 1) * h], (0, hk - h)) for i in range(3)]
    wq = rows(torch.cat(blk + [wq[:, 3 * h:]], 1))
    return (params[0], params[1], rows(params[2]), rows(params[3]),
            rows(params[4]), w2, rows(params[6]), rows(params[7]), wq,
            rows(params[9]), rows(params[10]))


def unpad_head(grads, h: int):
    """The gradients of `pad_head`'s operands sliced back to hidden h (the
    inverse of its padding)."""
    hk = grads[8].shape[0]
    if hk == h:
        return tuple(grads)
    g = list(grads)
    for i in (2, 3, 4, 6, 7, 9, 10):
        g[i] = g[i][:h]
    g[5] = g[5][:h, :h]
    wq = g[8][:h]
    g[8] = torch.cat([wq[:, i * hk:i * hk + h] for i in range(3)]
                     + [wq[:, 3 * hk:]], 1)
    return tuple(g)


def pad_hidden(x, hk: int, dim: int):
    """x padded with zeros along `dim` (its hidden axis) to width hk: se
    and ctx at the kernels' width."""
    n = hk - x.shape[dim]
    if n == 0:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, n]
    return torch.nn.functional.pad(x, pad)


def head_operands(actor, cfg: TAPConfig, dtype=F32, grad: bool = False):
    """The actor head's weights in the kernel's [out, in] layout (W @ X with
    the batch as the last axis), contiguous, in the kernel's order: w8t,
    b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v; cast to the compute dtype
    where the flax Dense would cast them, v kept float32 (the JAX
    `head_operands`).

    Detached for the rollout; with `grad=True` they keep the autograd graph
    (casts, transposes and column views of the parameters), so the replay's
    gradients reach `actor.dyn_hidden.weight` and the others."""
    f = lambda t, d=dtype: (t if grad else t.detach()).to(d).contiguous()
    col = lambda b: f(b)[:, None].contiguous()
    hm = actor.hm_enc
    return (f(actor.dyn_hidden.weight), col(actor.dyn_hidden.bias),
            f(actor.dyn_proj.weight),
            f(hm.Dense_0.weight), col(hm.Dense_0.bias),
            f(hm.Dense_1.weight), col(hm.Dense_1.bias),
            f(actor.prev_embed.weight.T),
            f(actor.query.weight), col(actor.query.bias),
            f(actor.v, F32))


def head_shapes(cfg: TAPConfig, h: int):
    """Shapes of the 11 head operands, in `head_operands` order."""
    WD = cfg.target_width * cfg.target_depth
    A = cfg.num_actions
    return [(32, 8), (32, 1), (h, 32), (h, WD + 2), (h, 1), (h, h), (h, 1),
            (h, A + 1), (h, 3 * h + 8), (h, 1), (h, 1)]


def transposed(params):
    """W1, W2 and Wq of `head_operands` as [in, h]: K2's float32
    instantiation at hidden <= 128 and the K5 kernels stream their rows.
    The decode loop makes them once per such rollout."""
    return tuple(params[i].T.contiguous() for i in (3, 5, 8))


def query_parts_ref(params, ctx):
    """Plain version of `query_parts`: the query's step-invariant part,
    (Wq[:, h:2h] ctx [h, B], Wq[:, 2h:3h] E [h, A+1]) in float32 (exact
    products of the compute dtype's values, float32 sums): qin's rows h ..
    3h are ctx and the previous action's embedding column, neither of which
    changes over a rollout."""
    wq, et = params[8].float(), params[7].float()
    h = wq.shape[0]
    return wq[:, h:2 * h] @ ctx.float(), wq[:, 2 * h:3 * h] @ et


@functools.cache
def _qp_lib():
    fn = _build.load("actor_step").tapnet_actor_query_parts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def query_parts(params, ctx):
    """`query_parts_ref` on the card: one launch of csrc/actor_step.cu
    `query_parts_kernel` (counted in `query_parts.launches`; the tensor
    cores, 3xTF32 in float32), the plain version on CPU tensors. Once per
    rollout above hidden 128; h a multiple of 32."""
    if not ctx.is_cuda:
        return query_parts_ref(params, ctx)
    wq, et = params[8], params[7]
    h, B = ctx.shape
    dev = ctx.device
    for name, t, shape in (("wq", wq, (h, 3 * h + 8)), ("ctx", ctx, (h, B)),
                           ("et", et, (h, et.shape[1]))):
        _check(t, name, shape, ctx.dtype, dev)
    if wq.data_ptr() % 16:  # the kernel copies Wq's rows in 16-byte chunks
        wq = wq.clone()
    qctx = torch.empty((h, B), dtype=F32, device=dev)
    qemb = torch.empty((h, et.shape[1]), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = _build.ptr_array((wq, ctx, et, qctx, qemb))
        ints = _build.int_array([B, h, et.shape[1],
                                 int(ctx.dtype == torch.bfloat16)])
        err = _qp_lib()(ctypes.cast(ptrs, ctypes.c_void_p),
                        ctypes.cast(ints, ctypes.c_void_p),
                        ctypes.c_void_p(stream))
    query_parts.launches += 1
    _build.check(err, "query_parts")
    return qctx, qemb


query_parts.launches = 0


def wq_prime(params):
    """Wq's columns that a WH step still streams, [h, h + 8]: the enc
    columns 0 .. h and the dsum columns 3h .. 3h + 8."""
    wq = params[8]
    h = wq.shape[0]
    return torch.cat([wq[:, :h], wq[:, 3 * h:]], 1)


@functools.cache
def _swizzle_index(h: int, ns: int, device):
    """For a bfloat16 matrix [h][ns RING_K] (K padded), the flat source
    index of each element of its slabs: slab s holds h rows of RING_K
    values, row r's 16-byte chunk ch at position ch ^ ((r >> 1) & 3)
    (csrc/ring_bf16.cuh)."""
    ar = lambda n: torch.arange(n, device=device)
    s = ar(ns)[:, None, None, None]
    r = ar(h)[None, :, None, None]
    ch = ar(4)[None, None, :, None] ^ ((r >> 1) & 3)
    k = s * RING_K + 8 * ch + ar(8)[None, None, None, :]
    return (r * ns * RING_K + k).reshape(-1)


def ring_slabs(params, h: int):
    """The WH products' weights as the ring's slabs, one contiguous buffer:
    W1 [h][W*D+2], W2 [h][h] and Wq' [h][h+8] (`wq_prime`), in that order,
    each matrix's columns padded with zeros to whole slabs. bfloat16: a
    slab is h rows of RING_K columns, 16-byte chunks swizzled
    (`_swizzle_index`). float32 (as many bytes a slab: KR = 16 columns):
    W1 transposed, a slab its KR rows of W1^T [K][h] (the SIMT product);
    W2 and Wq' in the 3xTF32 products' A-fragment order, a slab
    [h / 16][2][32 lanes][4]: for row tile m, half f and lane 4 g + t, the
    columns 4 t .. 4 t + 3 of the slab's 16 in row 16 m + 8 f + g.
    Above 256 (WX) each matrix is its two row halves' slabs (h / 2 rows
    each, laid out alike), the first half's then the second's.
    Returned as bfloat16 (float32 slabs reinterpreted), as the kernel's
    pointer 40 takes them."""
    nh = geometry(h)["nh"]
    hr = h // nh
    out = []
    for i, wm in enumerate((params[3], params[5], wq_prime(params))):
        for w in wm.chunk(nh, 0):
            K = w.shape[1]
            sk = RING_K if w.dtype == torch.bfloat16 else KR
            ns = -(-K // sk)
            wp = torch.nn.functional.pad(w, (0, ns * sk - K))
            if w.dtype == torch.bfloat16:
                out.append(wp.reshape(-1)[_swizzle_index(hr, ns, w.device)])
                continue
            if i == 0:
                slab = wp.T                                    # [ns KR][hr]
            else:  # [s][m][f][g][t][e] = W[16 m + 8 f + g][16 s + 4 t + e]
                slab = wp.reshape(hr // 16, 2, 8, ns, 4, 4).permute(
                    3, 0, 1, 2, 4, 5)
            out.append(slab.contiguous().view(torch.bfloat16).reshape(-1))
    return torch.cat(out)


def wide_operands(params, ctx, cfg: TAPConfig):
    """What a WH step reads that is made once per rollout: (qctx, qemb)
    from `query_parts`, the `ring_slabs` and, above 256, the blocks'
    scratch (`wx_scratch` floats a block of TB instances; empty up to
    256); None at hidden <= 128 or on CPU tensors (the plain versions
    compute the query whole)."""
    h = params[8].shape[0]
    if h <= 128 or not ctx.is_cuda:
        return None
    n = -(-ctx.shape[1] // TB) * wx_scratch(cfg, h, ctx.dtype)
    return (*query_parts(params, ctx), ring_slabs(params, h),
            torch.empty(n, dtype=torch.float32, device=ctx.device))


def precedence_bitmasks(instances, cfg: TAPConfig):
    """Column bitmasks of the up/rot graphs, i32[L*N, B], L = ceil(N/31):
    upm[l*N + i, b] = sum_{j in limb l} up[b, j, i] << (j - 31 l)."""
    N = cfg.num_blocks
    j = torch.arange(N, device=instances.up.device)

    def limbs(graph):
        g = graph.long()                                     # [B, j, i]
        rows = []
        for limb in range(_num_limbs(N)):
            in_l = (j >= 31 * limb) & (j < 31 * (limb + 1))
            pw = torch.where(in_l, 1 << (j - 31 * limb).clamp(0, 30), 0)
            rows.append((g * pw[None, :, None]).sum(1).T)    # [N, B]
        return torch.cat(rows, 0).int().contiguous()

    return limbs(instances.up), limbs(instances.rot)


def fits_planes(instances, cfg: TAPConfig):
    """Per-rotation geometric target fit, i32[R*N, B]."""
    rows = []
    for r in range(cfg.num_rot):
        d = rotated_dims_all(instances.dims, r, cfg)
        rows.append(((d[..., 0] <= cfg.target_width)
                     & (d[..., 1] <= cfg.target_depth)).int().T)
    return torch.cat(rows, 0).contiguous()


def _head_state(tf, packed, hm, prev, upm, rotm, fits, ctx, statm, params,
                cfg: TAPConfig):
    """A decode step up to its token work: flags [N, B], mask [A, B], the
    planes (acc0, accr, win) [N, B], t/N as a row [1, B] and the C queries
    [h, B] (`actor_select_step_ref` operands)."""
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    R, A = cfg.num_rot, cfg.num_actions
    T = N * R
    B = packed.shape[1]
    dev = packed.device
    f32 = torch.float32
    rd = rounder(ctx.dtype)
    w1t, b1, w2t, b2, et, wqt, bq = (p.float() for p in params[3:10])

    # accessibility from the bitmask limbs (env.core._accessibility
    # semantics: blocked[i] = any_j graph[j, i] & unpacked[j])
    unpk = 1 - packed
    iota = torch.arange(N, device=dev)
    blocked0 = torch.zeros((N, B), dtype=torch.bool, device=dev)
    blockedr = torch.zeros((N, B), dtype=torch.bool, device=dev)
    for limb in range(_num_limbs(N)):
        in_l = (iota >= 31 * limb) & (iota < 31 * (limb + 1))
        pw = torch.where(in_l, 1 << (iota - 31 * limb).clamp(0, 30),
                         0).int()[:, None]
        ub = (unpk * pw).sum(0, keepdim=True).int()           # [1, B]
        blocked0 |= (upm[limb * N:(limb + 1) * N] & ub) != 0
        blockedr |= (rotm[limb * N:(limb + 1) * N] & ub) != 0
    acc0 = (unpk == 1) & ~blocked0
    accr = acc0 & ~blockedr
    acc0_i, accr_i = acc0.int(), accr.int()
    if cfg.window > 0:
        # rolling window: the first `window` accessible blocks in index
        # order (features.dynamic_flags)
        rank = acc0_i.cumsum(0) - acc0_i
        win_i = acc0_i * (rank < cfg.window).int()
    else:
        win_i = acc0_i
    flags = packed + 2 * acc0_i + 4 * accr_i + 8 * win_i

    ok = torch.stack([win_i, win_i * accr_i][:R], 0)         # [R, N, B]
    mask_nr = (ok * fits.reshape(R, N, B)).permute(1, 0, 2)   # [N, R, B]
    mask = mask_nr[:, :, None].expand(N, R, C, B).reshape(A, B).int()

    # exact-count context summary dsum [8, B]
    pk = packed.sum(0, keepdim=True).to(f32)
    a0 = acc0_i.sum(0, keepdim=True).to(f32)
    ar = accr_i.sum(0, keepdim=True).to(f32)
    wn = win_i.sum(0, keepdim=True).to(f32)
    acc_mean = (a0 + ar) / T if R == 2 else a0 / N
    tf_row = rd(torch.ones(1, B, dtype=f32, device=dev) * tf.reshape(1, 1))
    dsum = torch.cat([rd(pk / N), rd(acc_mean), rd(wn / N), tf_row,
                      statm.float()], 0)

    # heightmap encoder per container, then the query
    inv_s = torch.full((), 1.0 / _scale(cfg), dtype=f32, device=dev)
    idx = (prev + 1).clamp(0, A).long()[0]                    # [B]
    prev_emb = et[:, idx]                                     # [h, B]
    qs = []
    for c in range(C):
        xc = rd(hm[c * W:(c + 1) * W].reshape(W * D, B).to(f32) * inv_s)
        feats = torch.cat([xc, xc.amax(0, keepdim=True),
                           rd(xc.sum(0, keepdim=True) / (W * D))], 0)
        e1 = torch.relu(rd(rd(w1t @ feats) + b1))
        enc = rd(rd(w2t @ e1) + b2)
        qs.append(rd(rd(wqt @ torch.cat([enc, ctx.float(), prev_emb, dsum],
                                        0)) + bq))
    return flags.int(), mask, (acc0_i, accr_i, win_i), tf_row, qs


def _token_inputs(packed, planes, tf_row, statp, cfg: TAPConfig):
    """The dyn MLP's input x [8, T, B] float32; token t = (i, r)."""
    R, T = cfg.num_rot, cfg.num_blocks * cfg.num_rot
    B = packed.shape[1]
    f32 = torch.float32
    acc0_i, accr_i, win_i = planes
    pk_t = packed.to(f32).repeat_interleave(R, 0)             # [T, B]
    ac_t = torch.stack([acc0_i, accr_i][:R], 1).reshape(T, B).to(f32)
    wn_t = win_i.to(f32).repeat_interleave(R, 0)
    statp = statp.float()
    return torch.stack([pk_t, ac_t, wn_t, tf_row.expand(T, B),
                        statp[0], statp[1], statp[2], statp[3]], 0)


def _select_logp(masked, g, mask, packed, hm, plc, dims_w, dims_d, dims_h,
                 cfg: TAPConfig):
    """Gumbel argmax + select/place of the masked scores [A, B], and log pi
    of the chosen action (0 where none is valid)."""
    B = packed.shape[1]
    p_n, h_n, l_n, a_n = select_place_ref(cfg, masked + g, mask, packed, hm,
                                          plc, dims_w, dims_d, dims_h)
    mx = masked.amax(0)
    lse = torch.log(torch.exp(masked - mx).sum(0))
    bi = torch.arange(B, device=packed.device)
    lp = (masked[a_n.clamp(min=0).long(), bi] - mx) - lse
    logp = torch.where(a_n >= 0, lp, torch.zeros_like(lp))
    return p_n, h_n, l_n, a_n, logp


def actor_select_step_ref(tf, packed, hm, plc, prev, dims_w, dims_d, dims_h,
                          upm, rotm, fits, g, se, ctx, statp, statm, params,
                          cfg: TAPConfig, temperature: float = 1.0):
    """Plain version of the full mode. tf f32[1, 1] (t/N), packed i32[N, B],
    hm i32[C*W, D, B], plc i32[N*6, B], prev i32[1, B], dims_* i32[N, B],
    upm/rotm i32[L*N, B] (`precedence_bitmasks`), fits i32[R*N, B], g
    f32[A, B] (zeros = greedy), se [B, T, h], ctx [h, B], statp [4, T, B],
    statm [4, B] and params = head_operands(...) in the compute dtype
    (float32 or bfloat16, v float32).

    Returns (packed', hm', plc', act i32[B], flags i32[N, B], mask i32[A, B],
    logits f32[A, B], logp f32[B])."""
    _check_cfg(cfg, dtype=se.dtype)
    T, A = cfg.num_blocks * cfg.num_rot, cfg.num_actions
    B = packed.shape[1]
    rd = rounder(se.dtype)
    w8t, b8, wpt = (p.float() for p in params[:3])
    v = params[10]
    flags, mask, planes, tf_row, qs = _head_state(
        tf, packed, hm, prev, upm, rotm, fits, ctx, statm, params, cfg)
    x_all = _token_inputs(packed, planes, tf_row, statp, cfg)
    h1 = torch.relu(rd(rd(w8t @ x_all.reshape(8, T * B)) + b8))  # [32, T*B]
    dyn = rd(wpt @ h1).reshape(-1, T, B).permute(1, 0, 2)    # [T, h, B]
    sd = rd(se.permute(1, 2, 0).float() + dyn)
    scores = torch.stack([rd((rd(torch.tanh(rd(sd + q[None]))) * v[None])
                             .sum(1)) for q in qs], 1).reshape(A, B)
    masked = torch.where(mask == 1, scores / temperature, NEG)
    p_n, h_n, l_n, a_n, logp = _select_logp(masked, g, mask, packed, hm, plc,
                                            dims_w, dims_d, dims_h, cfg)
    return p_n, h_n, l_n, a_n, flags, mask, scores, logp


def live_columns(mask, cfg: TAPConfig):
    """The live columns of a decode step, the rule the kernel's main-path
    mode applies: pairs (instance b, token t) whose mask [A, B] allows t in
    some container (which implies that the instance has a valid action).
    Returns (b [n], t [n]) ordered by instance, then token, the kernel's
    column order. Every other action scores -1e9 masked and adds exactly 0
    to the softmax."""
    T, C = cfg.num_blocks * cfg.num_rot, cfg.num_containers
    live = (mask.reshape(T, C, -1) == 1).any(1)               # [T, B]
    b, t = live.T.nonzero(as_tuple=True)
    return b, t


def actor_select_step_live_ref(tf, packed, hm, plc, prev, dims_w, dims_d,
                               dims_h, upm, rotm, fits, g, se, ctx, statp,
                               statm, params, cfg: TAPConfig,
                               temperature: float = 1.0):
    """Plain version of the decode loop's mode: operands as in
    `actor_select_step_ref`; the dyn MLP and the attention run on the live
    columns only (`live_columns`), every other action is masked. Returns
    the full version's outputs with None for the logits: the integer ones
    equal, logp the same sum less exact zeros."""
    _check_cfg(cfg, dtype=se.dtype)
    T, C, A = cfg.num_blocks * cfg.num_rot, cfg.num_containers, cfg.num_actions
    B = packed.shape[1]
    rd = rounder(se.dtype)
    w8t, b8, wpt = (p.float() for p in params[:3])
    v = params[10]
    flags, mask, planes, tf_row, qs = _head_state(
        tf, packed, hm, prev, upm, rotm, fits, ctx, statm, params, cfg)
    b, t = live_columns(mask, cfg)
    x = _token_inputs(packed, planes, tf_row, statp, cfg)[:, t, b]  # [8, n]
    h1 = torch.relu(rd(rd(w8t @ x) + b8))                     # [32, n]
    sd = rd(se[b, t].T.float() + rd(wpt @ h1))                # [h, n]
    scores = torch.stack([rd((rd(torch.tanh(rd(sd + q[:, b]))) * v).sum(0))
                          for q in qs], 1)                    # [n, C]
    masked = torch.full((T, C, B), NEG, dtype=scores.dtype,
                        device=scores.device)
    masked[t, :, b] = scores / temperature
    p_n, h_n, l_n, a_n, logp = _select_logp(masked.reshape(A, B), g, mask,
                                            packed, hm, plc, dims_w, dims_d,
                                            dims_h, cfg)
    return p_n, h_n, l_n, a_n, flags, mask, None, logp


@functools.cache
def _lib():
    lib = _build.load("actor_step")
    fn = lib.tapnet_actor_select_step
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(ops, cfg: TAPConfig, temperature: float, logits: bool,
            params_t, stream: int, wide=None):
    """Check the operands, allocate the outputs on their device and launch
    the kernel on `stream`. Returns (outputs, CUDA error code)."""
    (tf, packed, hm, plc, prev, dims_w, dims_d, dims_h, upm, rotm, fits, g,
     se, ctx, statp, statm, params) = ops
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    R, A = cfg.num_rot, cfg.num_actions
    T, B, h = N * R, packed.shape[1], se.shape[2]
    cdt = se.dtype
    _check_cfg(cfg, h, cdt)
    L = _num_limbs(N)
    dev, i32, f32 = packed.device, torch.int32, torch.float32
    shapes = [("tf", tf, (1, 1), f32), ("packed", packed, (N, B), i32),
              ("hm", hm, (C * W, D, B), i32), ("plc", plc, (N * 6, B), i32),
              ("prev", prev, (1, B), i32), ("dims_w", dims_w, (N, B), i32),
              ("dims_d", dims_d, (N, B), i32), ("dims_h", dims_h, (N, B), i32),
              ("upm", upm, (L * N, B), i32), ("rotm", rotm, (L * N, B), i32),
              ("fits", fits, (R * N, B), i32), ("g", g, (A, B), f32),
              ("se", se, (B, T, h), cdt), ("ctx", ctx, (h, B), cdt),
              ("statp", statp, (4, T, B), cdt), ("statm", statm, (4, B), cdt)]
    shapes += [(f"params[{k}]", p, s, f32 if k == 10 else cdt)
               for k, (p, s) in enumerate(zip(params, head_shapes(cfg, h)))]
    WD = W * D
    if h > 128:  # the ring's slabs in place of params_t
        params_t = None
    elif params_t is None and cdt == F32:
        raise ValueError("the float32 instantiation reads params_t")
    if params_t is not None:  # optional in bfloat16, which does not read it
        shapes += [(f"params_t[{k}]", p, s, cdt) for k, (p, s) in enumerate(
            zip(params_t, [(WD + 2, h), (h, h), (3 * h + 8, h)]))]
    if h > 128:
        if wide is None:
            raise ValueError("above hidden 128 the kernel reads "
                             "wide_operands(params, ctx, cfg)")
        sk = RING_K if cdt == torch.bfloat16 else KR
        n = sum(-(-k // sk) for k in (WD + 2, h, h + 8)) * h * RING_K
        shapes += [("qctx", wide[0], (h, B), f32),
                   ("qemb", wide[1], (h, A + 1), f32),
                   ("slabs", wide[2], (n,), torch.bfloat16),
                   ("scratch", wide[3],
                    (-(-B // TB) * wx_scratch(cfg, h, cdt),), f32)]
    for name, t, shape, dt in shapes:
        _check(t, name, shape, dt, dev)
    outs = (torch.empty_like(packed), torch.empty_like(hm),
            torch.empty_like(plc), torch.empty(B, dtype=i32, device=dev),
            torch.empty((N, B), dtype=i32, device=dev),
            torch.empty((A, B), dtype=i32, device=dev),
            torch.empty((A, B), dtype=f32, device=dev) if logits else None,
            torch.empty(B, dtype=f32, device=dev))
    none = torch.empty(0, device=dev)
    ptrs = _build.ptr_array(
        (packed, hm, plc, dims_w, dims_d, dims_h, tf, prev, upm, rotm, fits,
         g, se, ctx, statp, statm) + tuple(params)
        + tuple(none if o is None else o for o in outs)
        + (tuple(params_t) if params_t is not None else (none,) * 3)
        + (tuple(wide) if wide is not None else (none,) * 4))
    ints = _build.int_array([B] + env_ints(cfg)
                            + [h, cfg.window, int(logits),
                               int(cdt == torch.bfloat16)])
    err = _lib()(ctypes.cast(ptrs, ctypes.c_void_p),
                 ctypes.cast(ints, ctypes.c_void_p),
                 ctypes.c_float(1.0 / _scale(cfg)),
                 ctypes.c_float(temperature), ctypes.c_void_p(stream))
    return outs, err


def actor_select_step(tf, packed, hm, plc, prev, dims_w, dims_d, dims_h,
                      upm, rotm, fits, g, se, ctx, statp, statm, params,
                      cfg: TAPConfig, temperature: float = 1.0,
                      logits: bool = True, params_t=None, wide=None):
    """One fused actor + select decode step; operands and results as in
    `actor_select_step_ref`. `logits=False`: the decode loop's mode, the
    token work on the live columns only and None in the logits' slot. The
    dtype of se picks the float32 or the bfloat16 instantiation.
    params_t: `transposed(params)`, which only the float32 instantiation
    reads, at hidden <= 128 (ignored above); wide: `wide_operands(params,
    ctx, cfg)`, which the kernel reads above 128 (each made here when needed
    and not given; the plain versions read neither)."""
    ops = (tf, packed, hm, plc, prev, dims_w, dims_d, dims_h, upm, rotm,
           fits, g, se, ctx, statp, statm, params)
    if not packed.is_cuda:
        ref = actor_select_step_ref if logits else actor_select_step_live_ref
        return ref(*ops, cfg, temperature)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        if se.dtype == F32 and params_t is None and se.shape[2] <= 128:
            params_t = transposed(params)
        if wide is None:
            wide = wide_operands(params, ctx, cfg)
        outs, err = _launch(ops, cfg, temperature, logits, params_t, stream,
                            wide)
    actor_select_step.launches += 1
    _build.check(err, "actor_select_step")
    return outs


actor_select_step.launches = 0
