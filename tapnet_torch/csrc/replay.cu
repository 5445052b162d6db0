// replay_logp: the REINFORCE replay of the actor head, forward and backward.
//
// Replaces: tapnet_tpu/ops/pallas_replay.py::replay_logp_fused, both
// schedules: monolithic, `_fwd_kernel` (sum_t log pi(a_t | s_t) from the
// rollout record) and `_bwd_kernel` / `_bwd_step` (the hand-derived backward:
// d_se, d_ctx and the gradients of the 11 head weights, summed over the
// batch); and step-grid, `_fwd_kernel_steps` / `_bwd_kernel_steps` (rolling
// windows and N > 31: the same math on a grid over batch tiles and steps).
//
// Per decode step k of one instance the head is re-run from the recorded
// flags, heightmap, mask and previous action: accessibility bits -> the
// count summary dsum; per container c the heightmap encoder feats -> e1 ->
// enc and the query q_c = Wq [enc, ctx, E[:, prev+1], dsum] + bq; per token
// t the dyn MLP h1 = relu(W8 x_t + b8), dyn = Wp h1 and the scores
// s[t, c] = v . tanh(se_t + dyn + q_c); then the shifted log-softmax of the
// masked, tempered scores at the recorded action (action -1 adds 0).
// The backward forms g = dlp * valid * (onehot - p) * mask / temp and runs
// the chain of `_bwd_step`.
//
// Bound: operations. Per instance and step at hidden h, W*D cells, T tokens
// and C containers the forward is C*(h*(WD+2) + h*h + h*(3h+8)) +
// T*(32*8 + 32*h + C*h) multiply-adds; the backward re-runs it and adds
// about as much again. At 2d-rolling (T = 100, h = 128) the token loop is
// 87% of that, and most of it multiplies exact zeros: the kernels below do
// the token work only for the live columns.
//
// Live columns (exact). At step k a column is a pair (instance, token t)
// whose instance has an action (act >= 0) and whose mask allows t in some
// container. Every other token's masked score is -1e9, exp(-1e9 - max) is
// exactly 0 in f32, and its g = scale * (onehot - p) * mask / temp is
// exactly 0, so it adds nothing to logp, d_se, d_ctx or any weight gradient;
// an instance-step without an action (scale 0) adds nothing at all, and a
// tile-step without one is skipped whole. Warp 0 lists the step's columns
// in (instance, token) order; the softmax walks each instance's columns in
// action order, so its sums are the full version's less exact zeros.
//
// Design, float32 (SIMT, f32 fused multiply-adds throughout at h <= 128;
// no approximate intrinsics); the bfloat16 instantiations, and the float32
// ones above hidden 128, share it but for the products (below):
// - one block per tile of TB = 32 instances (lane = instance in the
//   encoder/query phases), NWARP = 16 warps; a loop over the block's steps
//   takes the place of the TPU's sequential step axis.
// - token work runs over groups of G = 64 columns that may mix instances:
//   x8 [8][G] -> h1 = relu(W8 x8 + b8) [32][G] -> dyn = Wp h1 [h][G] as
//   register tiles (a warp owns 4 columns, a lane 4 rows j = lane + 32 r:
//   one shared load of Wp feeds 4 columns, one float4 of h1 feeds 4 rows);
//   se is gathered per column from a [B, T, h] copy (a warp reads one
//   column's row, coalesced) and a column's score is a warp sum, so a group
//   costs 3 barriers (forward) or 5 (backward) where a token cost 8.
// - backward per group: d_dyn [G][h+4] in shared memory; from it, in one
//   barrier interval, dq (per instance: a fixed-order sum over the
//   instance's columns in the group), gWp += d_dyn h1^T (8 accumulators per
//   thread, in registers for the whole block), dh1 = Wp^T d_dyn (float4
//   rows) masked by h1 > 0; then gW8 and gb8 (registers). gv accumulates in
//   registers per (warp, row) and is summed over warps in order at the end.
// - token-loop weights (Wp^T [32][h], W8, b8, v: 17.5 KB at h = 128) are
//   staged in shared memory once per block. The encoder/query products run
//   over the tile's 32 instances at once with register tiles: the forward
//   ones (W1, W2, Wq, from transposed copies) stream 64-row slices of the
//   weight through shared memory, a thread owning h/16 rows of one
//   instance (one load of the instance vector feeds 8 multiply-adds); the
//   transposed ones (Wq^T dq, W2^T d_hm) stream 32-row slices, a thread
//   owning 3h/16 or h/16 outputs; the weight-gradient contractions give a
//   thread 8 rows x 4 columns (12 loads per 32 multiply-adds).
// - containers run one at a time (query c, its forward pass; its backward
//   pass, then its encoder/query backward), so q and dq are one [h][LD]
//   array each in shared memory for any C: no global read-modify-write in
//   the token loop. The encoder/query weight-gradient partials are added
//   into the block's row of a [tiles, P] buffer once per (step, container);
//   the token-loop ones are stored once at the end; `reduce_tiles` sums the
//   rows in tile order. No float atomics: two launches are bit-identical.
// - d_se is accumulated per live column into a [chunks, B, T, h] partial
//   (zeroed by its block, rows written coalesced) and `sum_transpose` sums
//   the chunks in order into [T, h, B].
// - shared memory at 2d-rolling, h = 128, backward: ~219 KB (one block, 16
//   warps, per SM; the encoder's [feature][lane] arrays are ~86 KB of it).
//   With 16 warps and a barrier per weight slice and per token-group stage
//   the kernel is bound by instruction issue and barrier waits, ~14x its
//   operations bound counted over live columns (PERF.md §6).
//   Configs above the 227 KB a block may hold are refused by the wrapper;
//   h must be a multiple of 32 up to 256, of 64 up to 512 (WX, below).
// - hidden widths above 128 (WH, h = 160..256): the tile stays 32
//   instances (phase 0, the column list, the softmax, the partial rows,
//   the chunks and the records' count are the ones above), and the head
//   runs per step in two passes of TP = 16 instances each (Geo): q, dq,
//   the encoder view and the token view hold one pass, which halves the
//   [feature][instance] arrays that grow with h. A pass fills its own
//   rows of qin, scores its columns cols[off[p0] .. off[p0 + 16]), writes
//   q, qin, e1 and feats to its record, and in the backward reads q and
//   e1 back (no re-run of the encoder and query), then runs its token
//   backward, its query and encoder backward and its share of phase F
//   (the lanes that share an embedding row are chained within the pass).
//   A virtual warp of 16 lanes (vw, vl) fills and clears a pass's
//   [feature][instance] rows and owns h/32 <= 8 rows of one instance in
//   W1 feats (mv_tiled); token groups are 32 columns of 2 a warp, 8 rows
//   a lane; the other float32 products read their weights from L2
//   (mm_tf32, below), the bfloat16 ones stream them through the weight
//   ring (below); Wq^T runs a third of its rows at a time; a grad_outer
//   record holds one part per pass, and a grad_outer stage both passes of
//   a (step, container). Each sum keeps one owner and one order.
//
// Design, float32 above hidden 128 (TF: WH and E = float). At h = 256 the
// SIMT body spent 0.89 of a block in the encoder/query products (A/B 0.31)
// and their backward (E 0.57: each (step, container, pass) added the
// weight-gradient contractions into the block's partial row in device
// memory, gWq alone 794 KB read and written), a barrier per weight slice
// copied through registers (PERF.md §6, PR 15). So:
// - the contractions are deferred, as the bfloat16 ones: each (step,
//   container, pass) writes dq, d_hm, de1 and qin, e1, feats as f32 to a
//   record (rec_off), and `grad_outer_tf32`, a second launch, contracts
//   each partial row over all its steps with the accumulators in
//   registers (one owner, one order, no atomics). The bias row sums stay.
// - W2 e1, Wq qin, Wq^T dq (a third of its rows at a time) and W2^T d_hm
//   run on the tensor cores as 3xTF32 (mma_tf32.cuh: mma.sync m16n8k8,
//   each f32 operand split in registers into tf32 hi + lo, three passes
//   summed in f32). Each warp reads its 16 rows of the f32 weight straight
//   from L2 (16-byte loads, the next 16-column chunk in flight), with no
//   barrier. The weights, not the tensor cores, bound these products: a
//   pass streams ~1 MB of them per product set, and every design moved
//   them at ~5-8 B a cycle an SM (SIMT slices, cp.async slabs through the
//   token view with a barrier each, direct loads; PERF.md §6, PR 16).
// - so the backward does not re-run the encoder and query in D (the
//   weights a second time): A/B writes q, qin, e1 and feats of each
//   (step, container, pass) to its record, and D reads q and e1 back.
// - W1 feats (K = W*D + 2: ~1% of the products) stays the SIMT mv_tiled:
//   e1 = relu(W1 feats + b1) keeps its bits, and with them its ReLU
//   gates. Under 3xTF32 one gate whose pre-activation lay within rounding
//   of 0 shut where the plain version's opened on a multi-container record
//   (W1's gradient 3.9e-3 of its max from the plain one; PERF.md §6).
// - the token work (D), the softmax (C), phase F and the order of every
//   sum there stay the SIMT f32 code above (gv's sum cancels: an
//   instance's g sums to 0).
// - a product is f32's to a few units of its last place (mma_tf32.cuh):
//   q, enc and the gradients can differ from the SIMT body's in their
//   last bits.
// Design, bfloat16 (TC = the E = __nv_bfloat16 instantiations): every
// product of the head runs on the tensor cores, mma.sync.m16n8k16 bf16 x
// bf16 -> f32 (the JAX kernel's `preferred_element_type=f32` dots), with
// every fragment built from shared memory: the weights' A fragments by
// ldmatrix from bfloat16 copies, the activations' and gradients' from
// float arrays (packed, or split, to bfloat16 pairs on load). W8 x8 (K =
// 8) and the softmax, tanh and bias work stay SIMT, as above.
// - operands: a forward product multiplies two bfloat16 values (the
//   weights; feats, e1, qin and h1, rounded by `rnd` where JAX casts): one
//   pass is exact products summed in f32. A backward product multiplies an
//   f32 gradient (d_dyn, dh1, dq, d_hm, de1) by a bfloat16 value, as
//   `_bwd_step` does in f32: the gradient is split, x = hi + lo with hi =
//   bf16(x) and lo = bf16(x - hi), and both passes go into one f32
//   accumulator (x to a relative 2^-16; never one bfloat16 rounding).
// - tiles: the encoder/query forward (W1, W2, Wq: [h][K] . [K][32 lanes])
//   gives a warp one 16-row tile and 16 lanes; the transposed ones (Wq^T
//   dq, W2^T d_hm: from the [in][h] copies) a warp 16 lanes and up to 3
//   row tiles, the split B fragments shared by them. Their weights stream
//   through the token view in slabs of 64 columns (16 for the 3h rows of
//   Wq^T), bfloat16 rows padded by 8 so that ldmatrix meets no bank
//   conflict, copied with 16-byte cp.async (element loads where the rows
//   are not 16-byte aligned: W1 unless W*D + 2 is a multiple of 8),
//   double-buffered: one barrier a slab, the next slab's copy under this
//   slab's products (`stream_a`). Reading the A fragments from L2
//   instead, each warp waiting on its own round trips, made the backward
//   1.12x (2d-basic) and 1.06x (2d-rolling) slower (PERF.md §6). The encoder/query weight gradients (gWq, gW2, gW1 += grad .
//   x^T) are not contracted per step: K = 32 lanes a step made each step
//   read and write the block's whole partial row (gWq alone is 50K floats
//   at h = 128), 40% of the kernel at 2d-basic. Each (step, container)
//   writes its operands once to a record (rec_off: dq, d_hm, de1 f32; qin,
//   e1, feats bfloat16) and `grad_outer`, a second launch (on wgmma,
//   below), contracts each partial row over all its steps (K = 32 x steps)
//   with the accumulators in registers, storing each element once. Token groups: dyn = Wp
//   h1 into a [G][h+4] array (a warp: one column tile, up to 4 row tiles),
//   read back per column by the SIMT score code; gWp^T += h1 d_dyn (K =
//   the group's columns; accumulators in registers for the whole block,
//   2 tiles a warp), dh1 = Wp^T d_dyn (K = h, one tile a warp), gW8 += dh1
//   x8^T and gb8 += dh1 . 1 (warps 0-1), and dq += d_dyn^T M with M the
//   0/1 membership of the group's columns in the tile's instances (the
//   per-instance sums; K = the columns). Wp is staged once as bfloat16 rows of
//   WPS = 40 (the A operand of dyn, and of dh1 by pairs of rows); h1 rows
//   are padded to G + 4. K is padded to 16 with zeros (WD + 2, 3h + 8),
//   the ragged batch edge masked as above.
// - order: every accumulator has one owner and one order of k-steps (hi
//   before lo); no float atomics, `reduce_tiles` and `sum_transpose` as
//   above: two launches are bit-identical. The tensor core adds in its own
//   order, so a forward value can land one bfloat16 ulp from the plain
//   version's.
// - shared memory: the float plan above less the float Wp^T (16 KB at h =
//   128) plus Wp as bfloat16 (10 KB) and the h1 padding; the two weight
//   slabs (72 h floats) fit in the token view: 213.6 KB at 2d-rolling, h
//   = 128 (219.3 KB in f32); one block per SM either way. The activations
//   (feats, e1, qin, h1) stay float: the SIMT epilogues read them, and E
//   writes f32 gradients over them in place (d_hm over qin's enc rows,
//   de1 over e1).
// - what runs on the tensor cores (`python -m tapnet_torch.ops._build
//   --sass replay`, the sm_90a build): 138 HMMA in each bfloat16 backward
//   instantiation, 30 in each bfloat16 forward; none in the float32 ones
//   at h <= 128 (above: the 3xTF32 design); grad_outer and
//   grad_outer_tf32 on wgmma: HGMMA, no HMMA.
//
// Design, bfloat16 above hidden 128 (RG = TC && WH). Two passes of 16
// instances halve the MMA work behind each weight byte, and at h = 256
// the design above moved the weights at ~3 B a cycle an SM: one block
// barrier per 16- or 32-column slab, the backward re-running the encoder
// and query in D (a third of its weight traffic). So:
// - no re-run: A/B writes q (a half-width part of the record, rec_off),
//   qin, e1 and feats to the record; D reads q and e1 back (plain loads:
//   this launch wrote them). All are bfloat16 values, so exact.
// - the weight ring (ring_bf16.cuh): W1, W2, Wq (A/B) and Wq^T's thirds,
//   W2^T (E) stream as two chains of slabs of 32 columns and all h rows
//   (16 KB at h = 256), laid out by the wrapper (ops/replay.py
//   `ring_operands`: one contiguous run a slab, 16-byte chunks swizzled
//   instead of padded), one cp.async.bulk a slab into RING_S = 3 stages
//   in the token view, each completing on its own mbarrier; the last warp
//   to release a stage starts the copy of the slab 3 further on, so a
//   chain holds one block barrier, not one per slab.
// - the B operands by ldmatrix .trans from bfloat16 copies [K][16]
//   (ring_bf16.cuh `xs_at`) that the operands' writers keep beside the
//   float arrays (A/B: in d_prev and dq, free until D; E: the gradients
//   split into hi and lo once, in qin's rows past h): from the float
//   arrays the fragments' loads met up to 4 ways on a bank in all 16
//   warps and bound the products.
// - the products keep mv_mma's and mvt_mma's k-steps, their order and
//   their operand values, so every output is the same, bit for bit, as
//   the slab design's (kernel_times --expect; PERF.md §6).
// - bound: the copies alone stream ~17 B a cycle an SM (every SM reading
//   the same weights from L2; PERF.md §6), and both passes stream them;
//   the token backward (D) and the scores are the SIMT code above.
// - shared memory: the ring's stages (48 KB at h = 256) in the token view
//   in place of the two padded slabs, its mbarriers and counts behind it;
//   d_prev and dq in the forward too: 222.8 KB at 2d-rolling, h = 256.
//
// Hidden widths above 256 (WX, h = 320..512, a multiple of 64; other
// widths reach the kernels padded with zeros, ops/replay.py `ReplayLogp`).
// The WH design above, with three changes so that the plan fits a block
// (the WH plan would take 391-417 KB at h = 512):
// - the products whose warps own 16-row tiles (RG's ring_mv and ring_mvt,
//   TF's mm_tf32) run over the weights' two row halves of HR = h / 2 rows
//   in turn, each a WH product of HR rows (`rg_mv`, `rg_mvt`, `tf_mm`);
//   the ring's slabs hold a row half (`ring_operands` lays each matrix,
//   and each of Wq^T's blocks, out as its halves' slabs in turn);
// - q, dq and the encoder view (feats, e1, qin, d_prev) live in a scratch
//   of the block's own in device memory (`wx_scratch`, laid out as the
//   shared-memory arrays), read back through L1 / L2; RG's bfloat16
//   copies that ldmatrix reads keep shared memory of their own (`wx_xs`:
//   A/B's and E's in turn);
// - token groups of G = 16 columns, one a warp, 16 rows a lane (geo.cuh);
//   the float32 W1 feats stages KS = 16 rows of W1^T.
// grad_outer_tf32 and grad_outer give a block one row half of G
// (`go_rows`, blockIdx.z), so their plans and warpgroups stay those of
// h = 256. A simple design that is right; its speed is work for later
// (PERF.md §6).
//
// Step-grid schedule (STEPS instantiations; rolling windows, N <= 62). The
// TPU ran a grid (batch tiles, S) in order and carried logp, d_se and d_ctx
// across the step axis and the weight gradients across the whole grid. CUDA
// blocks run in no order, so here the grid is (batch tiles, step chunks):
// block (i, j) walks steps [j*len, (j+1)*len) of tile i and writes partials
// of its own: logp [chunks, B], d_se [chunks, B, T, h], d_ctx [chunks, h,
// B], one weight-gradient row per (tile, chunk); `reduce_tiles` and
// `sum_transpose` then sum each over its rows in a fixed order. The bit
// words of a block set are 64-bit (flags of up to 62 blocks) and the
// previous action arrives as its own operand `prev` [S, B] (a chunk's first
// step needs the step before it).
//
// Compute dtype (the JAX kernels' `dtype_name`): the element type E of the
// float operands se, ctx, statp, statm and the weights other than v, float
// or __nv_bfloat16. The bfloat16 instantiations read bfloat16 from device
// memory and accumulate in f32, rounding to bfloat16 (`rnd`) where the JAX
// `_head_fwd` casts to its compute dtype (as actor_step.cu does); the
// backward works in f32 from that rounded forward (which it re-runs) and the
// f32 values of the bfloat16 weights, as `_bwd_step` does, and writes f32
// gradients (the wrapper casts each to its operand's dtype). Shared memory
// holds the rounded values as float in both (the bfloat16 plan differs only
// as said above), and in float every `rnd` is the identity.
//
// The head's SIMT device code is a copy of actor_step.cu's, not a shared
// header: the layouts differ, and K2's results stay as they were. The
// tensor-core pieces (mma_bf16.cuh: mma, the fragments, stream_a, mv_mma)
// are shared with K2's bfloat16 instantiations; the 3xTF32 ones
// (mma_tf32.cuh) are the replay's own.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "geo.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "ring_bf16.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TB = 32;      // instances per block
constexpr int LD = TB + 1;  // padded row stride of [feature][lane] arrays
constexpr int NWARP = 16;   // warps per block
constexpr int NT = TB * NWARP;
constexpr int MAX_H = 512;  // hidden: a multiple of 32 up to 256, of 64 above
constexpr int GO_MAXR = 256;  // rows of G a grad_outer block takes
constexpr int WPS = 40;    // tc: bf16 row stride of Wp [h][32] staged
constexpr int MAX_C = 4;
constexpr int MAX_N_MONO = 31;   // monolithic: one 32-bit word per block set
constexpr int MAX_N_STEPS = 62;  // step-grid: 64-bit words
constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

struct Dims {
  int B, N, W, D, R, C, h;
};

using tapnet::Geo;  // the head's passes (geo.cuh)
static_assert(TB == tapnet::GEO_TB && NWARP == tapnet::GEO_NWARP,
              "geo.cuh's block geometry");

using bf16 = __nv_bfloat16;
using tapnet::frag_au;
using tapnet::frag_b;
using tapnet::ldsm_a;
using tapnet::mma;
using tapnet::mv_mma;
using tapnet::pack;
using tapnet::stream_a;
using tapnet::mm_tf32;
using tapnet::Chain;
using tapnet::Ring;
using tapnet::RING_K;
using tapnet::RING_S;
static_assert(NT == tapnet::MMA_NT && LD == tapnet::MMA_LD,
              "mma_bf16.cuh's block geometry");

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }

// a read-only load as float
template <class E>
__device__ __forceinline__ float ldg(const E* p) {
  return f32(__ldg(p));
}

// x rounded to E and back: the JAX kernels' cast to their compute dtype
template <class E>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (std::is_same_v<E, float>) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

template <class E>
struct HeadW {
  const E *w8t, *b8, *wpt, *w1t, *b1, *w2t, *b2, *et, *wqt, *bq;
  const float* v;
  const E *w1T, *w2T, *wqT;  // W1, W2, Wq transposed: [in][h]
  // bfloat16 above hidden 128: W1, W2, Wq, Wq^T's first 3h rows (three
  // [h][h] blocks) and W2^T as ring slabs (ring_bf16.cuh)
  const bf16 *w1r, *w2r, *wqr, *wqTr, *w2Tr;
};

template <class E>
struct ReplayIn {
  const int* flags;    // [S, N, B]
  const int* hms;      // [S, C*W*D, B]
  const int* masks;    // [S, A, B]
  const int* acts;     // [S, B]
  const int* prev;     // [S, B], acts shifted by a step (step-grid only)
  const E* se;         // [B, T, h]
  const E* ctx;        // [h, B]
  const E* statp;      // [4, T, B]
  const E* statm;      // [4, B]
  const float* dlp;    // [B] (backward only)
};

// Offsets of the 11 weight gradients in one partial row, in kernel order.
struct GOff {
  int w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v, P;
};

__host__ __device__ inline GOff goff(const Dims& d) {
  const int h = d.h, WD = d.W * d.D, A = d.N * d.R * d.C, FQ = 3 * h + 8;
  GOff o;
  o.w8t = 0;
  o.b8 = o.w8t + 32 * 8;
  o.wpt = o.b8 + 32;
  o.w1t = o.wpt + h * 32;
  o.b1 = o.w1t + h * (WD + 2);
  o.w2t = o.b1 + h;
  o.b2 = o.w2t + h * h;
  o.et = o.b2 + h;
  o.wqt = o.et + h * (A + 1);
  o.bq = o.wqt + h * FQ;
  o.v = o.bq + h;
  o.P = o.v + h;
  return o;
}

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

// Shared-memory plan, in floats from the base (every region 16-byte
// aligned); the ints follow the floats. `tc`: the tensor-core plan of the
// bfloat16 instantiations (Wp itself as bfloat16 [h][WPS] in place of the
// float Wp^T [32][h]; h1 rows padded to GS = G + 4 floats so that a B
// fragment's column reads hit 32 banks; a [G][h+4] dyn array in the
// forward too; the staged weight slices as bfloat16, two slabs of 72 h at
// h <= 128). WH: the head's arrays (q, dq, the encoder view, the token
// view) hold a pass of TP = 16 instances (Geo); tc: the weight ring's
// RING_S stages of h RING_K bfloat16 in the token view and its mbarriers
// and counts (`bar`, ring_bf16.cuh).
struct Lay {
  int ws, w8, b8, v, q, dq, sc, enc, xs, tok, bar, floats;
};

template <int WC>
__host__ __device__ inline int h1_stride(bool tc) {
  return tc ? Geo<WC>::G + 4 : Geo<WC>::G;
}

// WX: the floats of a block's scratch in device memory, q [h][LP], dq
// [h][LP], then the encoder view feats [WD+2][LP], e1 [h][LP], qin
// [3h+8][LP], d_prev [h][LP] (the shared-memory plan's arrays, laid out
// alike)
__host__ __device__ inline int wx_scratch(const Dims& d) {
  constexpr int LP = Geo<2>::LP;
  const int h = d.h;
  return 2 * up4(h * LP) + up4((d.W * d.D + 2 + h + 3 * h + 8 + h) * LP);
}

// WX, tc: the floats of the bfloat16 copies of the products' B operands
// (ring_bf16.cuh xs_at), 16-byte aligned: A/B's qin [FQ16][16] and e1
// [h][16], or E's four [h][16] (dq and d_hm split into hi and lo)
__host__ __device__ inline int wx_xs(int h) {
  const int ab = 16 * (((3 * h + 8 + 15) & ~15) + h), e = 64 * h;
  return (ab > e ? ab : e) / 2 + 4;
}

template <int WC>
__host__ __device__ inline Lay layout(const Dims& d, bool bwd, bool tc) {
  using Q = Geo<WC>;
  constexpr bool WH = Q::WH, WX = Q::WX;
  constexpr int LD = Q::LP, G = Q::G;
  const int h = d.h, T = d.N * d.R, WD = d.W * d.D, FQ = 3 * h + 8;
  Lay L;
  int o = 0;
  L.ws = o;  o += tc ? up4(h * WPS / 2) : up4(32 * h);  // Wp^T / Wp
  L.w8 = o;  o += 32 * 8;             // W8 [32][8]
  L.b8 = o;  o += 32;
  L.v = o;   o += up4(h);
  // tc above 128: dq behind d_prev, in the forward too; together they
  // hold the bfloat16 copies of the products' B operands in A/B
  const bool rg = tc && WH;
  // (WX: q, dq and the encoder view in the block's scratch, `wx_scratch`;
  // tc the bfloat16 copies of the B operands in `xs`)
  L.q = o;   o += WX ? 0 : up4(h * LD);        // q_c [h][LD]
  L.dq = o;  o += bwd && !rg && !WX ? up4(h * LD) : 0;
  L.sc = o;  o += up4(TB * T * d.C);  // scores, then g, [column][C]
  // encoder view: feats [WD+2][LD], e1 [h][LD], qin [3h+8][LD], d_prev
  L.enc = o; o += WX ? 0 : up4((WD + 2 + h + FQ + (bwd || rg ? h : 0)) * LD);
  if (rg) {
    L.dq = o;  o += WX ? 0 : up4(h * LD);
  }
  L.xs = o;  o += WX && rg ? wx_xs(h) : 0;
  // token view: x8 [8][G], h1 [32][GS]; d_dyn (tc: dyn first) [G][h+4];
  // backward dh1 [32][G] (and the staged weight slices of the
  // encoder/query products: float, or tc bfloat16 slabs)
  const int tok = 8 * G + 32 * h1_stride<WC>(tc)
                  + (bwd || tc ? G * (h + 4) : 0) + (bwd ? 32 * G : 0);
  // (and phase 0's flag rows and live bits)
  const int flg = (d.N + T) * TB;
  // stream_a: mv_mma's two slabs of h (KSL + 8) bfloat16 and mvt_mma's
  // of 3h x 24 or h x 72; WH: the ring's stages; mv_tiled: KS h floats
  // (the backward's mvt_tiled stages JS 3h: within tok at h <= 128;
  // above, the float32 products but W1's read their weights from L2:
  // mm_tf32)
  const int slabs =
      tc ? (WH ? RING_S * (h / Q::NH) * RING_K / 2 : 72 * h) : Q::KS * h;
  const int stage = slabs > flg ? slabs : flg;
  L.tok = o; o += tok > stage ? tok : stage;
  L.bar = o; o += tc && WH ? up4(3 * RING_S) : 0;  // 8-byte mbarriers, ints
  L.floats = o;
  return L;
}

// ints behind the floats: 4 bit words per lane (packed, acc0, accr, win;
// 64-bit in the step-grid), 4 ints per lane (the previous action's row,
// the action, the lanes sharing the row), the column offsets [TB+1], a flag
// and the column list [TB*T].
__host__ __device__ inline int n_ints(const Dims& d, bool steps) {
  return (steps ? 8 : 4) * TB + 4 * TB + TB + 1 + 1 + TB * d.N * d.R;
}

// The 16 bytes v as float at dst (4 floats, or 8 bfloat16 converted).
template <class E>
__device__ __forceinline__ void put16(float* dst, const uint4& v) {
  if constexpr (std::is_same_v<E, float>) {
    *reinterpret_cast<float4*>(dst) = reinterpret_cast<const float4&>(v);
  } else {
    const bf16* p = reinterpret_cast<const bf16*>(&v);
    float4 a, b;
    a.x = f32(p[0]); a.y = f32(p[1]); a.z = f32(p[2]); a.w = f32(p[3]);
    b.x = f32(p[4]); b.y = f32(p[5]); b.z = f32(p[6]); b.w = f32(p[7]);
    reinterpret_cast<float4*>(dst)[0] = a;
    reinterpret_cast<float4*>(dst)[1] = b;
  }
}

// out[j] = sum_k W[j, k] x[k][n] for every row j < h and instance n of
// the pass (a virtual warp vw of TP lanes owns the RW = h/NVW rows vw*RW
// ..): W given transposed, WT [cols][h]; slices of KS of its rows are
// staged in shared memory S as float (16-byte loads) and read as float2
// (RW odd, h = 160 or 224: float) broadcasts, so one load of x feeds RW
// multiply-adds. emit(j, n, acc) stores row j. The caller follows with a
// barrier before S or the outputs are reused.
template <int WC, class E, class Emit>
__device__ void mv_tiled(const E* __restrict__ WT, int h, int cols,
                         const float* x, float* S, int n, int vw, int tid,
                         Emit emit) {
  using Q = Geo<WC>;
  constexpr bool WH = Q::WH;
  constexpr int PV = 16 / sizeof(E);  // elements per 16 bytes
  constexpr int KS = Q::KS, LP = Q::LP, RM = Q::RWMAX;
  // 2 (h = 32) .. 8 (h = 128); 5 .. 8 (WH); 10 .. 16 (WX)
  const int RW = h / Q::NVW;
  float acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < cols; k0 += KS) {
    const int nk = min(KS, cols - k0);
    __syncthreads();  // S is free
    const uint4* src = reinterpret_cast<const uint4*>(WT + (size_t)k0 * h);
    for (int e = tid; e < nk * h / PV; e += NT)
      put16<E>(S + e * PV, __ldg(src + e));
    __syncthreads();
    for (int kk = 0; kk < nk; ++kk) {
      const float xv = x[(k0 + kk) * LP + n];
      const float* sw = S + kk * h + vw * RW;
      if (!WH || RW % 2 == 0) {
#pragma unroll
        for (int r = 0; r < RM; r += 2) {
          if (r < RW) {
            const float2 w2 = *reinterpret_cast<const float2*>(sw + r);
            acc[r] = fmaf(w2.x, xv, acc[r]);
            acc[r + 1] = fmaf(w2.y, xv, acc[r + 1]);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < RM; ++r)
          if (r < RW) acc[r] = fmaf(sw[r], xv, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RM; ++r)
    if (r < RW) emit(vw * RW + r, n, acc[r]);
}

// out[k] = sum_j W[j, k] g[j][n] for every k < cols (a multiple of 32)
// and instance n of the tile (warp vw owns cols/NWARP <= MAXCW of them;
// float32 at h <= 128), W row-major with `ld` columns: slices of JS rows
// are staged in S (JS * cols floats: the backward's token view holds
// them), one load of g feeds cols/NWARP multiply-adds (float2 reads of W).
template <int MAXCW, class E, class Emit>
__device__ void mvt_tiled(const E* __restrict__ Wm, int rows, int cols,
                          int ld, const float* g, float* S, int n, int vw,
                          int tid, Emit emit) {
  using Q = Geo<0>;
  constexpr int JS = Q::JS, LP = Q::LP;
  const int CW = cols / Q::NVW;
  float acc[MAXCW];
#pragma unroll
  for (int c = 0; c < MAXCW; ++c) acc[c] = 0.f;
  for (int j0 = 0; j0 < rows; j0 += JS) {
    const int nj = min(JS, rows - j0);
    __syncthreads();  // S is free
    for (int e = tid; e < nj * cols; e += NT) {
      const int jj = e / cols, k = e - jj * cols;
      S[e] = ldg(Wm + (size_t)(j0 + jj) * ld + k);
    }
    __syncthreads();
    for (int jj = 0; jj < nj; ++jj) {
      const float gv = g[(j0 + jj) * LP + n];
      const float* sw = S + jj * cols + vw * CW;
#pragma unroll
      for (int c = 0; c < MAXCW; c += 2) {
        if (c < CW) {
          const float2 w2 = *reinterpret_cast<const float2*>(sw + c);
          acc[c] = fmaf(w2.x, gv, acc[c]);
          acc[c + 1] = fmaf(w2.y, gv, acc[c + 1]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < MAXCW; ++c)
    if (c < CW) emit(vw * CW + c, n, acc[c]);
}

// dst[j*cols + m] += sum_l A[j][l] Bm[m][l] over the pass's TP lanes, for
// j < h and m < cols (float32 at h <= 128). Whole passes of 128 columns:
// a thread owns rows wy*h/16 .. (in runs of 8) and the columns m0 + lane +
// 32 i (i < 4), so one load of Bm feeds up to 8 multiply-adds and one of A
// (a broadcast) four; the last cols % 128 columns: one element per thread
// at a time. Every element has the same owner at every call, and each sum
// runs over l in order.
template <int TP>
__device__ void outer_tiled(float* dst, const float* A, const float* Bm,
                            int h, int cols, int lane, int wy, int tid) {
  constexpr int LP = TP + 1;
  const int RW = h / NWARP;
  const int full = cols & ~127;
  for (int m0 = 0; m0 < full; m0 += 128) {
    for (int r0 = 0; r0 < RW; r0 += 8) {
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
      for (int l = 0; l < TP; ++l) {
        float bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = Bm[(m0 + lane + 32 * i) * LP + l];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (r0 + r < RW) {
            const float a = A[(wy * RW + r0 + r) * LP + l];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(a, bv[i], acc[r][i]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r0 + r < RW) {
          float* dr = dst + (size_t)(wy * RW + r0 + r) * cols + m0 + lane;
#pragma unroll
          for (int i = 0; i < 4; ++i) dr[32 * i] += acc[r][i];
        }
      }
    }
  }
  const int rem = cols - full;
  for (int e = tid; e < h * rem; e += NT) {
    const int j = e / rem, m = full + e - j * rem;
    const float* a = A + j * LP;
    const float* bm = Bm + m * LP;
    float acc = 0.f;
#pragma unroll 8
    for (int l = 0; l < TP; ++l) acc = fmaf(a[l], bm[l], acc);
    dst[(size_t)j * cols + m] += acc;
  }
}

// dst[j] += sum_l A[j*lda + l] over the pass's TP lanes
template <int TP>
__device__ void rowsum_acc(float* dst, const float* A, int lda, int rows,
                           int tid) {
  for (int j = tid; j < rows; j += NT) {
    float acc = 0.f;
    for (int l = 0; l < TP; ++l) acc += A[(size_t)j * lda + l];
    dst[j] += acc;
  }
}

__device__ inline float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ int popw(int x) { return __popc((unsigned)x); }
__device__ __forceinline__ int popw(unsigned long long x) {
  return __popcll(x);
}

// ---- tensor-core products (the bfloat16 instantiations; the fragment
// layouts in mma_bf16.cuh) ----

// an f32 pair as hi = bf16(x) and lo = bf16(x - hi): hi + lo is x to a
// relative 2^-16, and both are exact bfloat16 operands
__device__ __forceinline__ void split(float2 x, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x.x, x.y);
  const float2 f = __bfloat1622float2(v);
  hi = *reinterpret_cast<const unsigned*>(&v);
  lo = pack(x.x - f.x, x.y - f.y);
}

// A fragment from f(r, k) = {A[r][k], A[r][k+1]} (k even); the values are
// exact in bfloat16
template <class F>
__device__ __forceinline__ void frag_a(unsigned (&a)[4], int g, int t, F f) {
  float2 v = f(g, 2 * t);
  a[0] = pack(v.x, v.y);
  v = f(g + 8, 2 * t);
  a[1] = pack(v.x, v.y);
  v = f(g, 2 * t + 8);
  a[2] = pack(v.x, v.y);
  v = f(g + 8, 2 * t + 8);
  a[3] = pack(v.x, v.y);
}

// the same for f32 values: the hi and lo fragments of the split
template <class F>
__device__ __forceinline__ void frag_a2(unsigned (&hi)[4], unsigned (&lo)[4],
                                        int g, int t, F f) {
  split(f(g, 2 * t), hi[0], lo[0]);
  split(f(g + 8, 2 * t), hi[1], lo[1]);
  split(f(g, 2 * t + 8), hi[2], lo[2]);
  split(f(g + 8, 2 * t + 8), hi[3], lo[3]);
}

template <class F>
__device__ __forceinline__ void frag_b2(unsigned (&hi)[2], unsigned (&lo)[2],
                                        int g, int t, F f) {
  split(f(2 * t, g), hi[0], lo[0]);
  split(f(2 * t + 8, g), hi[1], lo[1]);
}

// out[m][n] = sum_j W[j, m] g[j][n] for m < M (a multiple of 16), the
// 32 lanes of the tile and j < h (a multiple of 32; h <= 128): WT = W
// transposed, row-major [M][h] bfloat16, streamed through S in slabs of
// KSL columns (stream_a; 16 for the 3h rows of Wq^T, 64 for the h of
// W2^T: 72 h floats of S either way); g [h][LD] f32 in shared memory,
// split into hi and lo passes. Warp wy owns the lanes 16 (wy % 2) .. + 15
// and the row tiles wy / 2 + 8 i (i < MAXU), so its B fragments serve all
// of them. The caller follows with a barrier.
template <int MAXU, int KSL, class Emit>
__device__ void mvt_mma(const bf16* __restrict__ WT, int M, int h,
                        const float* gs, unsigned short* S, int lane, int wy,
                        int tid, Emit emit) {
  constexpr int LP = LD, NH = 2, WR = NWARP / NH;
  const int g = lane >> 2, t = lane & 3, n0 = (wy & (NH - 1)) * 16;
  const int MT = M / 16;
  float acc[MAXU][2][4] = {};
  stream_a<KSL>(S, WT, M, h, tid, [&](const unsigned short* slab, int kb) {
#pragma unroll
    for (int c = 0; c < KSL / 16; ++c) {
      const int k0 = kb + 16 * c;
      if (k0 < h) {
        unsigned bh[2][2], bl[2][2];
#pragma unroll
        for (int s = 0; s < 2; ++s)
          frag_b2(bh[s], bl[s], g, t, [&](int k, int n) {
            const float* p = gs + (k0 + k) * LP + n0 + 8 * s + n;
            return make_float2(p[0], p[LP]);
          });
#pragma unroll
        for (int i = 0; i < MAXU; ++i) {
          const int mt = (wy >> (NH - 1)) + WR * i;
          if (mt < MT) {
            unsigned a[4];
            ldsm_a(a, slab + mt * 16 * (KSL + 8) + 16 * c, KSL + 8, lane);
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              mma(acc[i][s], a, bh[s]);
              mma(acc[i][s], a, bl[s]);
            }
          }
        }
      }
    }
  });
#pragma unroll
  for (int i = 0; i < MAXU; ++i) {
    const int m = ((wy >> (NH - 1)) + WR * i) * 16 + g;
    if (m < M) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int n = n0 + 8 * s + 2 * t;
        emit(m, n, acc[i][s][0]);
        emit(m, n + 1, acc[i][s][1]);
        emit(m + 8, n, acc[i][s][2]);
        emit(m + 8, n + 1, acc[i][s][3]);
      }
    }
  }
}

// The bfloat16 products above hidden 128 (TC && WH), on the weight ring
// (ring_bf16.cuh): the pass's TP = 16 instances, warp wy < nw = h / 16
// owning the row tile 16 wy .. + 15 and both column tiles of 8, as
// mv_mma and mvt_mma did for a pass of 16 before the ring,
// with the same k-steps in the same order and the same operand values (so
// the same sums, bit for bit). The
// A fragments come from the ring's swizzled slabs; the B fragments by
// one ldmatrix .trans a k-step from a bfloat16 copy of the operand
// (ring_bf16.cuh `xs_at`), which its writers keep beside the float array:
// from the float [k][17] arrays, 8 32-bit loads a k-step that met in up
// to 4 ways on a bank, in all 16 warps, bound these products (PERF.md).

// out[j][n] = sum_k W[j, k] x[k][n]: slabs a .. of chain c hold W [h][K]
// (K padded to RING_K), xs the bfloat16 x [K16][16] (rows K .. K16 zero).
// emit(j, n, acc).
template <class Emit>
__device__ void ring_mv(const Ring& R, const Chain& c, int a, int K,
                        const unsigned short* xs, int nw, int lane, int wy,
                        Emit emit) {
  const int g = lane >> 2, t = lane & 3, m0 = 16 * wy;
  float acc[2][4] = {};
  tapnet::ring_take(R, c, a, (K + RING_K - 1) / RING_K, nw, wy, lane,
                    [&](const unsigned short* slab, int s) {
#pragma unroll
    for (int kc = 0; kc < RING_K / 16; ++kc) {
      const int k0 = s * RING_K + 16 * kc;
      if (k0 < K) {
        unsigned av[4], bx[4];
        tapnet::ldsm_slab(av, slab, m0, kc, lane);
        tapnet::ldsm_xs(bx, xs, k0, lane);
        const unsigned b0[2] = {bx[0], bx[1]}, b1[2] = {bx[2], bx[3]};
        mma(acc[0], av, b0);
        mma(acc[1], av, b1);
      }
    }
  });
  if (wy >= nw) return;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int n = 8 * u + 2 * t;
    emit(m0 + g, n, acc[u][0]);
    emit(m0 + g, n + 1, acc[u][1]);
    emit(m0 + g + 8, n, acc[u][2]);
    emit(m0 + g + 8, n + 1, acc[u][3]);
  }
}

// out_p[m][n] = sum_j W_p[j, m] g[j][n] for `parts` consecutive [h][h]
// blocks p of transposed weights (Wq^T's thirds; W2^T): slabs a .. of
// chain c hold each W_p^T [h][h] in turn; xh, xl the bfloat16 copies
// [h][16] of the f32 gradient g split as hi = bf16(g), lo = bf16(g - hi)
// (`split`). At the end of each block emit(p, m, t, acc) stores a
// thread's 8 outputs: acc[u][i] is out_p[m + 8 (i / 2)][8 u + 2 t + i % 2].
template <class Emit>
__device__ void ring_mvt(const Ring& R, const Chain& c, int a, int parts,
                         int h, const unsigned short* xh,
                         const unsigned short* xl, int nw, int lane, int wy,
                         Emit emit) {
  const int g = lane >> 2, t = lane & 3, nsp = h / RING_K;
  float acc[2][4] = {};
  tapnet::ring_take(R, c, a, parts * nsp, nw, wy, lane,
                    [&](const unsigned short* slab, int s) {
    const int kb = (s % nsp) * RING_K;
#pragma unroll
    for (int kc = 0; kc < RING_K / 16; ++kc) {
      const int k0 = kb + 16 * kc;
      unsigned av[4], bh[4], bl[4];
      tapnet::ldsm_xs(bh, xh, k0, lane);
      tapnet::ldsm_xs(bl, xl, k0, lane);
      tapnet::ldsm_slab(av, slab, 16 * wy, kc, lane);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const unsigned h2[2] = {bh[2 * u], bh[2 * u + 1]};
        const unsigned l2[2] = {bl[2 * u], bl[2 * u + 1]};
        mma(acc[u], av, h2);
        mma(acc[u], av, l2);
      }
    }
    if ((s + 1) % nsp == 0) {  // the block's last slab
      emit(s / nsp, 16 * wy + g, t, acc);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[u][i] = 0.f;
    }
  });
}

// the split of an f32 gradient value into xh, xl at (k, n) (`split`)
__device__ __forceinline__ void put_split(unsigned short* xh,
                                          unsigned short* xl, int k, int n,
                                          float x) {
  const bf16 hi = __float2bfloat16_rn(x);
  xh[tapnet::xs_at(k, n)] = __bfloat16_as_ushort(hi);
  xl[tapnet::xs_at(k, n)] = tapnet::bf16_bits(x - __bfloat162float(hi));
}

// The bfloat16 backward, and the float32 one above hidden 128, defer the
// encoder/query weight-gradient contractions (gWq += dq qin^T, gW2 += d_hm
// e1^T, gW1 += de1 feats^T, K = TP lanes a pass) to `grad_outer` (float32:
// `grad_outer_tf32`): each (step, container) of a block writes one record
// of their operands, one part per head pass of TP instances, in floats
// from the part's start: dq, d_hm, de1 [h][TP] f32; qin [3h+8][TP], e1
// [h][TP], feats [WD+2][TP] bfloat16 (`half`), else f32; above hidden 128
// followed by q [h][TP] (bfloat16 or f32 as the others: the backward
// writes them in A/B and reads q and e1 back in D). `pass` is a part's
// floats, `size` the record's (Geo<WH>::NP parts).
struct RecOff {
  int dq, dhm, de1, qin, e1, feats, q, pass, size;
};

template <int WC>
__host__ __device__ inline RecOff rec_off(const Dims& d, bool half) {
  constexpr bool WH = WC > 0;
  constexpr int TP = Geo<WC>::TP;
  const int h = d.h, FQ = 3 * h + 8, WD2 = d.W * d.D + 2;
  const int XP = half ? TP / 2 : TP;  // floats of an activation row
  RecOff r;
  int o = 0;
  r.dq = o;    o += h * TP;
  r.dhm = o;   o += h * TP;
  r.de1 = o;   o += h * TP;
  r.qin = o;   o += FQ * XP;
  r.e1 = o;    o += h * XP;
  r.feats = o; o += WD2 * XP;
  r.q = o;     o += WH ? h * XP : 0;  // q, for the backward's D
  r.pass = o;
  r.size = o * Geo<WC>::NP;
  return r;
}

// a [rows][TP + 1] float array as [rows][TP] f32 at dst (coalesced stores)
template <int TP>
__device__ void put_f32(float* dst, const float* a, int rows, int tid) {
  for (int e = tid; e < rows * TP; e += NT)
    dst[e] = a[((unsigned)e / TP) * (TP + 1) + (unsigned)e % TP];
}

// the same as [rows][TP] bfloat16 (its values are bfloat16: exact)
template <int TP>
__device__ void put_bf16(float* dst, const float* a, int rows, int tid) {
  unsigned* d = reinterpret_cast<unsigned*>(dst);
  for (int e = tid; e < rows * TP / 2; e += NT) {
    const float* p =
        a + ((unsigned)e / (TP / 2)) * (TP + 1) + 2 * ((unsigned)e % (TP / 2));
    d[e] = pack(p[0], p[1]);
  }
}

// put_f32's rows back into a [rows][TP + 1] float array (plain loads: the
// block wrote them in this launch)
template <int TP>
__device__ void get_f32(float* a, const float* src, int rows, int tid) {
  for (int e = tid; e < rows * TP; e += NT)
    a[((unsigned)e / TP) * (TP + 1) + (unsigned)e % TP] = src[e];
}

// put_bf16's rows back the same way
template <int TP>
__device__ void get_bf16(float* a, const float* src, int rows, int tid) {
  const __nv_bfloat162* s = reinterpret_cast<const __nv_bfloat162*>(src);
  for (int e = tid; e < rows * TP / 2; e += NT) {
    const float2 v = __bfloat1622float2(s[e]);
    float* p =
        a + ((unsigned)e / (TP / 2)) * (TP + 1) + 2 * ((unsigned)e % (TP / 2));
    p[0] = v.x;
    p[1] = v.y;
  }
}

// an activation's rows to a record as bfloat16 (HALF: its values are
// bfloat16) or f32, and back
template <bool HALF, int TP>
__device__ void put_act(float* dst, const float* a, int rows, int tid) {
  if constexpr (HALF)
    put_bf16<TP>(dst, a, rows, tid);
  else
    put_f32<TP>(dst, a, rows, tid);
}

template <bool HALF, int TP>
__device__ void get_act(float* a, const float* src, int rows, int tid) {
  if constexpr (HALF)
    get_bf16<TP>(a, src, rows, tid);
  else
    get_f32<TP>(a, src, rows, tid);
}

// STEPS: the step-grid schedule; blockIdx.y is the step chunk and `len` the
// steps per chunk. Monolithic: one chunk of all S steps. The backward
// writes d_se into `dse_o` [chunks, B, T, h] (zeroed here) and d_ctx into
// `dctx_o` (its chunk's [h, B], zeroed here).
template <bool BWD, bool STEPS, int WC, class E>
__global__ void __launch_bounds__(NT)
replay_kernel(Dims d, ReplayIn<E> in, HeadW<E> w, float inv_s,
              float temperature, float inv_temp, float* logp_o, float* dse_o,
              float* dctx_o, float* part_o, int len, float* rec_o,
              int* sflag_o, float* scr_o) {
  // the width class (geo.cuh): WH above hidden 128, WX above 256
  constexpr bool WH = WC > 0, WX = WC > 1;
  using Word = std::conditional_t<STEPS, unsigned long long, int>;
  // bfloat16: the products on the tensor cores (the design note)
  constexpr bool TC = std::is_same_v<E, bf16>;
  // float32 above hidden 128: the encoder/query products as 3xTF32 on the
  // tensor cores (mm_tf32); with TC, the weight-gradient contractions
  // deferred to a second launch through records (rec_off)
  constexpr bool TF = WH && !TC;
  constexpr bool DEFER = TC || TF;
  // mm_tf32: weight chunks in flight ahead of the one in use, a warp (2
  // and 4 hold more registers, spill more and ran 1.06-1.15x slower)
  constexpr int PF = 1;
  // the head's passes (Geo): TP instances each, LP their arrays' stride
  using Q = Geo<WC>;
  constexpr int TP = Q::TP, LP = Q::LP, NVW = Q::NVW, CPW = Q::CPW;
  // WX: the products over the weights' NH row halves of HR rows in turn
  constexpr int NH = Q::NH;
  constexpr int G = Q::G, MAXR = Q::MAXR;
  extern __shared__ __align__(16) float smem[];
  const int N = d.N, R = d.R, C = d.C, h = d.h, B = d.B;
  const int WD = d.W * d.D, T = N * R, A = T * C, FQ = 3 * h + 8, S = N;
  const int HP = h + 4, RPL = h / 32, GS = h1_stride<WC>(TC), HR = h / NH;
  const int lane = threadIdx.x, wy = threadIdx.y, tid = wy * TB + lane;
  const int g8 = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  // a pass's instance and virtual warp (lane and warp when TP = TB)
  const int vl = TP == TB ? lane : lane % TP;
  const int vw = TP == TB ? wy : wy * (TB / TP) + lane / TP;
  const int tile0 = blockIdx.x * TB;
  const int b = tile0 + lane;
  const bool active = b < B;
  const int bb = active ? b : 0;  // clamped index for loads
  const GOff go = goff(d);
  const Lay L = layout<WC>(d, BWD, TC);
  // WX: this block's scratch in device memory (`wx_scratch`)
  float* const scr =
      WX ? scr_o + ((size_t)blockIdx.x * gridDim.y + blockIdx.y)
                       * wx_scratch(d)
         : nullptr;
  const int chunk = STEPS ? blockIdx.y : 0;
  const int k0 = STEPS ? chunk * len : 0;
  const int k1 = STEPS ? min(k0 + len, S) : S;
  if (STEPS) {  // this chunk's partial outputs
    if (BWD) {
      dse_o += (size_t)chunk * B * T * h;
      dctx_o += (size_t)chunk * h * B;
    } else {
      logp_o += (size_t)chunk * B;
    }
  }

  float* Ws = smem + L.ws;   // Ws[k*h + j] = Wp[j, k]
  float* W8s = smem + L.w8;
  float* b8s = smem + L.b8;
  float* vs = smem + L.v;
  // the pass's instances: q_c [h][LP], dq [h][LP] (bwd), feats [WD+2][LP],
  // e1 [h][LP] (de1 in place, bwd), qin [3h+8][LP]: enc, ctx, prev, dsum;
  // d_prev [h][LP] (bwd)
  float* qs = WX ? scr : smem + L.q;
  float* dqs = WX ? scr + up4(h * LP) : smem + L.dq;
  float* sc = smem + L.sc;   // [column][C]
  float* feats = WX ? scr + 2 * up4(h * LP) : smem + L.enc;
  float* e1 = feats + (WD + 2) * LP;
  float* qin = e1 + h * LP;
  float* d_prev = qin + FQ * LP;
  float* d_hm = qin;                  // enc rows, after the Wq product
  // tc above 128 (the ring's products): the bfloat16 copies of their B
  // operands (ring_bf16.cuh xs_at), 16-byte aligned. A/B: qin [FQ16][16],
  // then e1 [h][16], from d_prev on (d_prev and dq are free until D); feats
  // [WD16][16] over qin's enc rows, which W2's emit writes after W1 has
  // read feats. E: dq and then d_hm split into hi and lo [h][16] each, in
  // qin's rows from h on (there E keeps only d_hm, in its enc rows).
  auto al16 = [](float* p) {
    return reinterpret_cast<unsigned short*>(
        (reinterpret_cast<size_t>(p) + 15) & ~(size_t)15);
  };
  // (WX: both in `xs`, E's over A/B's, which D and E no longer read)
  unsigned short* xsq = al16(WX ? smem + L.xs : d_prev);
  unsigned short* xse = xsq + 16 * ((FQ + 15) & ~15);
  unsigned short* xsf = xsq;
  unsigned short* xdh = WX ? xsq : al16(qin + h * LP);
  unsigned short* xdl = xdh + 16 * h;
  unsigned short* xmh = xdl + 16 * h;
  unsigned short* xml = xmh + 16 * h;
  float* stg = smem + L.tok;          // staged weight slices
  // tc: the same as bfloat16 (stream_a's double-buffered slabs)
  unsigned short* stgb = reinterpret_cast<unsigned short*>(stg);
  float* x8 = smem + L.tok;           // [8][G]
  float* h1 = x8 + 8 * G;             // [32][GS]
  float* DD = h1 + 32 * GS;           // [G][HP] d_dyn (bwd); tc: dyn first
  float* DH1 = DD + G * HP;           // [32][G] (bwd)
  int* ib = (int*)(smem + L.floats);
  Word* wb = reinterpret_cast<Word*>(ib);  // [4][TB] words
  // [4][TB]: prev row, act, the next lane with the same prev row (-1),
  // whether no earlier lane has it
  int* ia = ib + (STEPS ? 8 : 4) * TB;
  int* off = ia + 4 * TB;                  // [TB+1] column offsets
  int* flag = off + TB + 1;                // the tile has an action
  int* cols = flag + 1;                    // [TB*T]: t << 5 | lane
  // the block's partial row: its tile and step chunk
  const size_t prow_i = (size_t)blockIdx.x * (STEPS ? gridDim.y : 1) + chunk;
  float* prow = BWD ? part_o + prow_i * go.P : nullptr;
  const RecOff ro = rec_off<WC>(d, TC);
  // the record of step k, container c and the pass of instances p0 ..
  auto rec_at = [&](int k, int c, int p0) {
    return rec_o + ((prow_i * len + (k - k0)) * C + c) * (size_t)ro.size
           + (p0 / TP) * ro.pass;
  };

  // tc: Wp [h][32] as bfloat16 rows of WPS (the A operand of dyn, and of
  // dh1 as its transpose)
  unsigned short* wps = reinterpret_cast<unsigned short*>(Ws);
  if constexpr (TC) {
    const unsigned short* src =
        reinterpret_cast<const unsigned short*>(w.wpt);
    for (int e = tid; e < 32 * h; e += NT)
      wps[(e >> 5) * WPS + (e & 31)] = __ldg(src + e);
  } else {
    for (int e = tid; e < 32 * h; e += NT) {
      const int k = e / h, j = e - k * h;
      Ws[e] = ldg(w.wpt + j * 32 + k);
    }
  }
  for (int e = tid; e < 256; e += NT) W8s[e] = ldg(w.w8t + e);
  if (tid < 32) b8s[tid] = ldg(w.b8 + tid);
  for (int e = tid; e < h; e += NT) vs[e] = __ldg(w.v + e);
  if (BWD) {
    for (int e = tid; e < go.P; e += NT) prow[e] = 0.f;
    const size_t nb = (size_t)min(TB, B - tile0) * T * h;
    float* dse_t = dse_o + (size_t)tile0 * T * h;
    for (size_t e = tid; e < nb; e += NT) dse_t[e] = 0.f;
    for (int e = tid; e < h * TB; e += NT) {
      const int j = e / TB, l = e - j * TB;
      if (tile0 + l < B) dctx_o[(size_t)j * B + tile0 + l] = 0.f;
    }
  }
  const float dlp = (BWD && active) ? in.dlp[b] : 0.f;
  float lp_sum = 0.f;
  // token-loop weight gradients, in registers for the whole block: gWp
  // rows lane + 32 r, columns 2 wy and 2 wy + 1; gW8 / gb8 element tid;
  // gv partials of this warp's columns
  float gwp[MAXR][2], dvr[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) gwp[r][0] = gwp[r][1] = dvr[r] = 0.f;
  float gw8 = 0.f;
  // tc: gWp^T [32][h] as mma tiles (row tile wy % 2, column tiles wy / 2
  // + 8 u, u < NUW), gW8 [32][8] and gb8 (column 0 of g8b) on warps 0 and
  // 1 (row tile wy)
  constexpr int NUW = MAXR / 2;
  float gwa[NUW][4] = {}, g8a[4] = {}, g8b[4] = {};
  // tc above hidden 128: the encoder/query weights on the ring
  // (ring_bf16.cuh; its stages in the token view), h / 16 warps consuming;
  // A/B streams W1, W2, Wq as one chain, E Wq^T's thirds and W2^T
  constexpr bool RG = TC && WH;
  const int NWR = HR / 16;
  Ring ring{};
  Chain chain{};
  if constexpr (RG) {
    ring = Ring{stgb, reinterpret_cast<unsigned long long*>(smem + L.bar),
                reinterpret_cast<int*>(smem + L.bar + 2 * RING_S),
                HR * RING_K, 0u};
    if (tid == 0) tapnet::ring_init(ring);
  }
  __syncthreads();

  // the products by row halves (one at h <= 256): RG's ring_mv over slabs
  // a .. of chain (each half's in turn), TF's mm_tf32 over A [h][K], RG's
  // ring_mvt over `parts` [h][h] blocks (each block's halves in turn)
  auto rg_mv = [&](int a, int K, const unsigned short* xs, auto emit) {
    const int ns = (K + RING_K - 1) / RING_K;
    for (int hr = 0; hr < NH; ++hr)
      ring_mv(ring, chain, a + hr * ns, K, xs, NWR, lane, wy,
              [&](int j, int n, float acc) { emit(hr * HR + j, n, acc); });
  };
  auto tf_mm = [&](const auto* A, int K, const float* x, auto emit) {
    for (int hr = 0; hr < NH; ++hr)
      mm_tf32<PF>(A + (size_t)hr * HR * K, HR, K, x, lane, wy,
                  [&](int m, int n, float acc) { emit(hr * HR + m, n, acc); });
  };
  auto rg_mvt = [&](int a, int parts, const unsigned short* xh,
                    const unsigned short* xl, auto emit) {
    if constexpr (NH == 1) {
      ring_mvt(ring, chain, a, parts, h, xh, xl, NWR, lane, wy, emit);
    } else {
      const int nsh = h / RING_K;
      for (int u = 0; u < parts; ++u)
        for (int hr = 0; hr < NH; ++hr)
          ring_mvt(ring, chain, a + (u * NH + hr) * nsh, 1, h, xh, xl, NWR,
                   lane, wy,
                   [&](int, int m, int t, const float (&acc)[2][4]) {
                     emit(u, hr * HR + m, t, acc);
                   });
    }
  };

  // shared rows of qin for the pass of instances p0 ..: ctx, the previous
  // action's embedding, dsum
  auto fill_qin = [&](int k, int p0) {
    const int l = p0 + vl;
    const int bq = TP == TB ? bb : tile0 + l < B ? tile0 + l : 0;  // clamped
    const int idx = ia[l];
    // row j of qin (and, tc above 128, of its bfloat16 copy)
    auto put = [&](int j, float v) {
      qin[j * LP + vl] = v;
      if constexpr (RG) xsq[tapnet::xs_at(j, vl)] = tapnet::bf16_bits(v);
    };
    for (int j = vw; j < h; j += NVW) {
      put(h + j, f32(in.ctx[(size_t)j * B + bq]));
      put(2 * h + j, ldg(w.et + (size_t)j * (A + 1) + idx));
    }
    if (vw == 0) {
      const float fpk = (float)popw(wb[l]);
      const float fa0 = (float)popw(wb[TB + l]);
      const float far = (float)popw(wb[2 * TB + l]);
      const float fwn = (float)popw(wb[3 * TB + l]);
      put(3 * h, rnd<E>(fpk / (float)N));
      put(3 * h + 1,
          rnd<E>(R == 2 ? (fa0 + far) / (float)T : fa0 / (float)N));
      put(3 * h + 2, rnd<E>(fwn / (float)N));
      put(3 * h + 3, rnd<E>((float)k / (float)S));
      for (int r = 0; r < 4; ++r)
        put(3 * h + 4 + r, f32(in.statm[(size_t)r * B + bq]));
      if constexpr (RG)  // the copy's rows up to FQ16: zeros
        for (int j = FQ; j < ((FQ + 15) & ~15); ++j)
          xsq[tapnet::xs_at(j, vl)] = 0;
    }
  };

  // feats -> e1 -> enc (qin rows 0..h) of container c at step k for the
  // pass of instances p0 ..; ends in a barrier
  auto encode = [&](int k, int c, int p0) {
    const int bq = TP == TB ? bb  // clamped
                            : tile0 + p0 + vl < B ? tile0 + p0 + vl : 0;
    const int* hk = in.hms + ((size_t)k * C * WD + (size_t)c * WD) * B;
    for (int x = vw; x < WD; x += NVW) {
      feats[x * LP + vl] = rnd<E>((float)hk[(size_t)x * B + bq] * inv_s);
      if constexpr (RG)
        xsf[tapnet::xs_at(x, vl)] = tapnet::bf16_bits(feats[x * LP + vl]);
    }
    if constexpr (RG)  // the barrier, then W1, W2, Wq's first slabs
      chain = tapnet::ring_open(
          ring, HR, w.w1r, NH * ((WD + 2 + RING_K - 1) / RING_K), w.w2r,
          NH * (h / RING_K), w.wqr, NH * ((FQ + RING_K - 1) / RING_K), tid);
    else
      __syncthreads();
    if (vw == 0) {
      float mx = feats[vl], sm = 0.f;
      for (int x = 0; x < WD; ++x) {
        mx = fmaxf(mx, feats[x * LP + vl]);
        sm += feats[x * LP + vl];
      }
      feats[WD * LP + vl] = mx;
      feats[(WD + 1) * LP + vl] = rnd<E>(sm / (float)WD);
      if constexpr (RG) {  // the copy's last rows, zeros to WD16
        xsf[tapnet::xs_at(WD, vl)] = tapnet::bf16_bits(mx);
        xsf[tapnet::xs_at(WD + 1, vl)] =
            tapnet::bf16_bits(feats[(WD + 1) * LP + vl]);
        for (int x = WD + 2; x < ((WD + 17) & ~15); ++x)
          xsf[tapnet::xs_at(x, vl)] = 0;
      }
    }
    __syncthreads();
    auto e1_out = [&](int j, int n, float acc) {
      e1[j * LP + n] = fmaxf(rnd<E>(rnd<E>(acc) + ldg(w.b1 + j)), 0.f);
      if constexpr (RG) xse[tapnet::xs_at(j, n)] = tapnet::bf16_bits(e1[j * LP + n]);
    };
    if constexpr (RG)
      rg_mv(0, WD + 2, xsf, e1_out);
    else if constexpr (TC)
      mv_mma<Q::KSL>(w.w1t, h, WD + 2, feats, stgb, lane, wy, tid,
                         e1_out);
    else  // float32: SIMT (TF too, so that e1's ReLU gates stay as they were)
      mv_tiled<WC>(w.w1T, h, WD + 2, feats, stg, vl, vw, tid, e1_out);
    __syncthreads();
    auto enc_out = [&](int j, int n, float acc) {
      qin[j * LP + n] = rnd<E>(rnd<E>(acc) + ldg(w.b2 + j));
      if constexpr (RG) xsq[tapnet::xs_at(j, n)] = tapnet::bf16_bits(qin[j * LP + n]);
    };
    if constexpr (RG)
      rg_mv(chain.ns[0], h, xse, enc_out);
    else if constexpr (TC)
      mv_mma<Q::KSL>(w.w2t, h, h, e1, stgb, lane, wy, tid, enc_out);
    else if constexpr (TF)
      tf_mm(w.w2t, h, e1, enc_out);
    else
      mv_tiled<WC>(w.w2T, h, h, e1, stg, vl, vw, tid, enc_out);
    __syncthreads();
  };

  // q_c = Wq qin + bq into qs; ends in a barrier
  auto query = [&]() {
    auto q_out = [&](int j, int n, float acc) {
      qs[j * LP + n] = rnd<E>(rnd<E>(acc) + ldg(w.bq + j));
    };
    if constexpr (RG)
      rg_mv(chain.ns[0] + chain.ns[1], FQ, xsq, q_out);
    else if constexpr (TC)
      mv_mma<Q::KSL>(w.wqt, h, FQ, qin, stgb, lane, wy, tid, q_out);
    else if constexpr (TF)
      tf_mm(w.wqt, FQ, qin, q_out);
    else
      mv_tiled<WC>(w.wqT, h, FQ, qin, stg, vl, vw, tid, q_out);
    __syncthreads();
  };

  // x8 and h1 = relu(W8 x8 + b8) of columns [g0, g0 + ng); two barriers
  auto group_h1 = [&](int k, int g0, int ng) {
    if (tid < G) {
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (tid < ng) {
        const int e = cols[g0 + tid], l = e & 31, t = e >> 5;
        const int i = t / R, r = t - i * R;
        f[0] = (float)((wb[l] >> i) & 1);
        f[1] = (float)((wb[(r == 0 ? 1 : 2) * TB + l] >> i) & 1);
        f[2] = (float)((wb[3 * TB + l] >> i) & 1);
        f[3] = rnd<E>((float)k / (float)S);
        for (int m = 0; m < 4; ++m)
          f[4 + m] = f32(in.statp[((size_t)m * T + t) * B + tile0 + l]);
      }
      for (int m = 0; m < 8; ++m) x8[m * G + tid] = f[m];
    }
    __syncthreads();
    {
      // 32 rows x 16 runs of G/16 columns
      const int m = tid >> 4, c4 = (tid & 15) * (G / 16);
      for (int i = 0; i < G / 16; ++i) {
        float acc = 0.f;
        for (int f = 0; f < 8; ++f)
          acc = fmaf(W8s[m * 8 + f], x8[f * G + c4 + i], acc);
        h1[m * GS + c4 + i] = fmaxf(rnd<E>(rnd<E>(acc) + b8s[m]), 0.f);
      }
    }
    __syncthreads();
  };

  // dyn = Wp h1 for this warp's CPW columns, rows lane + 32 r. tc: the
  // group's dyn [G][HP] into DD on the tensor cores (A = Wp staged, B = h1;
  // warp wy owns the column tile wy % NCT and the row tiles wy / NCT +
  // (NWARP / NCT) i of the column tiles that hold a column), a barrier,
  // then this warp's columns read back from DD.
  auto group_dyn = [&](float (&dyn)[CPW][MAXR], int ng) {
    if constexpr (TC) {
      constexpr int NCT = G / 8;
      constexpr int LN = NCT == 8 ? 3 : NCT == 4 ? 2 : 1;  // log2 NCT
      const int nt = wy & (NCT - 1);
      if (8 * nt < ng) {
        const int col = 8 * nt + g8;
        unsigned bf[2][2];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          frag_b(bf[ks], g8, t4, [&](int k, int) {
            const float* p = h1 + (16 * ks + k) * GS + col;
            return make_float2(p[0], p[GS]);
          });
        for (int mt = wy >> LN; mt < h / 16; mt += NWARP / NCT) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            unsigned a[4];
            frag_au(a, g8, t4, [&](int r, int k) {
              return *reinterpret_cast<const unsigned*>(
                  wps + (16 * mt + r) * WPS + 16 * ks + k);
            });
            mma(acc, a, bf[ks]);
          }
          const int j = 16 * mt + g8, c = 8 * nt + 2 * t4;
          DD[c * HP + j] = acc[0];
          DD[(c + 1) * HP + j] = acc[1];
          DD[c * HP + j + 8] = acc[2];
          DD[(c + 1) * HP + j + 8] = acc[3];
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < CPW; ++i) {
        const int cc = wy * CPW + i;
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          dyn[i][r] = (r < RPL && cc < ng)
                          ? rnd<E>(DD[cc * HP + lane + 32 * r]) : 0.f;
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < CPW; ++i)
#pragma unroll
      for (int r = 0; r < MAXR; ++r) dyn[i][r] = 0.f;
    for (int k = 0; k < 32; ++k) {
      if constexpr (CPW == 4) {
        const float4 hv =
            *reinterpret_cast<const float4*>(h1 + k * GS + wy * CPW);
        float wv[MAXR];
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          wv[r] = r < RPL ? Ws[k * h + lane + 32 * r] : 0.f;
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          dyn[0][r] = fmaf(wv[r], hv.x, dyn[0][r]);
          dyn[1][r] = fmaf(wv[r], hv.y, dyn[1][r]);
          dyn[2][r] = fmaf(wv[r], hv.z, dyn[2][r]);
          dyn[3][r] = fmaf(wv[r], hv.w, dyn[3][r]);
        }
      } else if constexpr (CPW == 2) {  // two columns a warp (WH)
        const float2 hv =
            *reinterpret_cast<const float2*>(h1 + k * GS + wy * CPW);
        float wv[MAXR];
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          wv[r] = r < RPL ? Ws[k * h + lane + 32 * r] : 0.f;
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          dyn[0][r] = fmaf(wv[r], hv.x, dyn[0][r]);
          dyn[1][r] = fmaf(wv[r], hv.y, dyn[1][r]);
        }
      } else {  // one column a warp (WX)
        const float hv = h1[k * GS + wy];
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          if (r < RPL)
            dyn[0][r] = fmaf(Ws[k * h + lane + 32 * r], hv, dyn[0][r]);
      }
    }
#pragma unroll
    for (int i = 0; i < CPW; ++i)
#pragma unroll
      for (int r = 0; r < MAXR; ++r) dyn[i][r] = rnd<E>(dyn[i][r]);
  };

  // se rows of this warp's columns of a group, loaded before the group's
  // barriers so that their latency overlaps them
  auto group_se = [&](int g0, int ng, float (&sev)[CPW][MAXR]) {
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const int cc = wy * CPW + i;
      const int e = cols[g0 + min(cc, ng - 1)], l = e & 31, t = e >> 5;
      const E* sep = in.se + ((size_t)(tile0 + l) * T + t) * h;
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        sev[i][r] = (r < RPL && cc < ng) ? f32(sep[lane + 32 * r]) : 0.f;
    }
  };

  // forward over the columns [c0, n) of a pass of instances p0 .. for
  // container c: sc[col*C + c]
  auto scores = [&](int k, int c, int p0, int c0, int n) {
    for (int g0 = c0; g0 < n; g0 += G) {
      const int ng = min(G, n - g0);
      float sev[CPW][MAXR];
      group_se(g0, ng, sev);
      group_h1(k, g0, ng);
      float dyn[CPW][MAXR];
      group_dyn(dyn, ng);
#pragma unroll
      for (int i = 0; i < CPW; ++i) {
        const int cc = wy * CPW + i;
        if (cc >= ng) break;  // warp-uniform
        const int l = (cols[g0 + cc] & 31) - p0;
        float ps = 0.f;
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < RPL) {
            const int j = lane + 32 * r;
            const float sd = rnd<E>(sev[i][r] + dyn[i][r]);
            const float act = rnd<E>(tanhf(rnd<E>(sd + qs[j * LP + l])));
            ps = fmaf(act, vs[j], ps);
          }
        }
        ps = warp_sum(ps);
        if (lane == 0) sc[(g0 + cc) * C + c] = rnd<E>(ps);
      }
    }
    __syncthreads();
  };

  // backward over the columns [c0, n) of a pass of instances p0 .. for
  // container c, from g in sc: d_se, dq (into dqs), gWp, gW8, gb8, gv
  auto token_bwd = [&](int k, int c, int p0, int c0, int n) {
    for (int g0 = c0; g0 < n; g0 += G) {
      const int ng = min(G, n - g0);
      float sev[CPW][MAXR];
      group_se(g0, ng, sev);
      group_h1(k, g0, ng);
      float dyn[CPW][MAXR];
      group_dyn(dyn, ng);
#pragma unroll
      for (int i = 0; i < CPW; ++i) {
        const int cc = wy * CPW + i;
        float* ddc = DD + cc * HP;
        if (cc >= ng) {  // zero d_dyn of the unused columns
#pragma unroll
          for (int r = 0; r < MAXR; ++r)
            if (r < RPL) ddc[lane + 32 * r] = 0.f;
          continue;
        }
        const int e = cols[g0 + cc], l = e & 31, t = e >> 5;
        float* dsep = dse_o + ((size_t)(tile0 + l) * T + t) * h;
        const float ds = sc[(g0 + cc) * C + c];
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < RPL) {
            const int j = lane + 32 * r;
            const float sd = rnd<E>(sev[i][r] + dyn[i][r]);
            const float act =
                rnd<E>(tanhf(rnd<E>(sd + qs[j * LP + l - p0])));
            dvr[r] = fmaf(act, ds, dvr[r]);
            const float dpre = (vs[j] * ds) * (1.f - act * act);
            ddc[j] = dpre;
            dsep[j] += dpre;
          }
        }
      }
      __syncthreads();
      if constexpr (TC) {
        // dq[j][l] += sum over the group's columns cc of d_dyn[cc][j] where
        // cc is instance l's: M = h, N = the pass's TP lanes, K = the
        // columns, B the 0/1 membership, d_dyn split; warp wy owns the
        // lane tile wy % NLT and the row tiles wy / NLT + (NWARP / NLT) u
        constexpr int NLT = TP / 8, LL = NLT == 4 ? 2 : 1;  // LL: log2 NLT
        constexpr int NDU = WX ? 4 : 2;  // row tiles a warp
        const int nt = wy & (NLT - 1);
        float dacc[NDU][4] = {};
        for (int c0 = 0; c0 < ng; c0 += 16) {
          unsigned bo[2];
          frag_b(bo, g8, t4, [&](int k, int n) {
            const int l = p0 + 8 * nt + n, ca = c0 + k;
            const bool a0 = ca < ng && (cols[g0 + ca] & 31) == l;
            const bool a1 = ca + 1 < ng && (cols[g0 + ca + 1] & 31) == l;
            return make_float2(a0 ? 1.f : 0.f, a1 ? 1.f : 0.f);
          });
#pragma unroll
          for (int u = 0; u < NDU; ++u) {
            const int mt = (wy >> LL) + (NWARP / NLT) * u;
            if (mt < h / 16) {
              unsigned ah[4], al[4];
              frag_a2(ah, al, g8, t4, [&](int r, int k) {
                const float* p = DD + (c0 + k) * HP + 16 * mt + r;
                return make_float2(p[0], p[HP]);
              });
              mma(dacc[u], ah, bo);
              mma(dacc[u], al, bo);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < NDU; ++u) {
          const int mt = (wy >> LL) + (NWARP / NLT) * u;
          if (mt < h / 16) {
            float* dq0 = dqs + (16 * mt + g8) * LP + 8 * nt + 2 * t4;
            dq0[0] += dacc[u][0];
            dq0[1] += dacc[u][1];
            dq0[8 * LP] += dacc[u][2];
            dq0[8 * LP + 1] += dacc[u][3];
          }
        }
      }
      // dq: per instance of the pass, its columns of this group in order
      for (int e = tid; e < (TC ? 0 : h * TP); e += NT) {
        const int j = e / TP, v = e - j * TP, l = p0 + v;
        const int lo = max(off[l], g0) - g0;
        const int hi = min(off[l + 1], g0 + ng) - g0;
        if (hi > lo) {
          float s = 0.f;
          for (int cc = lo; cc < hi; ++cc) s += DD[cc * HP + j];
          dqs[j * LP + v] += s;
        }
      }
      if constexpr (TC) {
        // gWp^T += h1 d_dyn over the group's columns (K), d_dyn split:
        // row tile wy % 2 of h1, column tiles wy / 2 + 8 u of d_dyn^T
        const int mt = wy & 1;
        for (int c0 = 0; c0 < ng; c0 += 16) {
          unsigned a[4];
          frag_a(a, g8, t4, [&](int r, int k) {
            return *reinterpret_cast<const float2*>(
                h1 + (16 * mt + r) * GS + c0 + k);
          });
#pragma unroll
          for (int u = 0; u < NUW; ++u) {
            const int nt = (wy >> 1) + 8 * u;
            if (nt * 8 < h) {
              unsigned bh[2], bl[2];
              frag_b2(bh, bl, g8, t4, [&](int k, int n) {
                const float* p = DD + (c0 + k) * HP + nt * 8 + n;
                return make_float2(p[0], p[HP]);
              });
              mma(gwa[u], a, bh);
              mma(gwa[u], a, bl);
            }
          }
        }
        // dh1 = (Wp^T d_dyn) * (h1 > 0), K = h, d_dyn split: row tile
        // wy % 2, column tile wy / 2 (G = 32: warps 8.. idle); A = Wp^T
        // from the staged Wp
        const int nt = wy >> 1;
        if (G == 64 || nt < G / 8) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int j0 = 0; j0 < h; j0 += 16) {
            unsigned a[4], bh[2], bl[2];
            frag_au(a, g8, t4, [&](int r, int k) {
              const int m = 16 * mt + r, j = j0 + k;
              return (unsigned)wps[j * WPS + m]
                     | (unsigned)wps[(j + 1) * WPS + m] << 16;
            });
            frag_b2(bh, bl, g8, t4, [&](int k, int n) {
              return *reinterpret_cast<const float2*>(
                  DD + (8 * nt + n) * HP + j0 + k);
            });
            mma(acc, a, bh);
            mma(acc, a, bl);
          }
          const int m = 16 * mt + g8, cc = 8 * nt + 2 * t4;
          DH1[m * G + cc] = h1[m * GS + cc] > 0.f ? acc[0] : 0.f;
          DH1[m * G + cc + 1] = h1[m * GS + cc + 1] > 0.f ? acc[1] : 0.f;
          DH1[(m + 8) * G + cc] =
              h1[(m + 8) * GS + cc] > 0.f ? acc[2] : 0.f;
          DH1[(m + 8) * G + cc + 1] =
              h1[(m + 8) * GS + cc + 1] > 0.f ? acc[3] : 0.f;
        }
        __syncthreads();
        if (wy < 2) {  // gW8 += dh1 x8^T, dh1 split: row tile wy
          for (int c0 = 0; c0 < ng; c0 += 16) {
            unsigned ah[4], al[4], bx[2];
            frag_a2(ah, al, g8, t4, [&](int r, int k) {
              return *reinterpret_cast<const float2*>(
                  DH1 + (16 * wy + r) * G + c0 + k);
            });
            frag_b(bx, g8, t4, [&](int k, int n) {
              return *reinterpret_cast<const float2*>(x8 + n * G + c0 + k);
            });
            mma(g8a, ah, bx);
            mma(g8a, al, bx);
            // gb8 += rowsum dh1: B = a column of ones (column 0 of a tile)
            const unsigned one = g8 == 0 ? 0x3F803F80u : 0u;  // bf16 1, 1
            const unsigned bo[2] = {one, one};
            mma(g8b, ah, bo);
            mma(g8b, al, bo);
          }
        }
        __syncthreads();
        continue;
      }
      {  // gWp += d_dyn h1^T
        const int m0 = 2 * wy;
        for (int cc = 0; cc < ng; ++cc) {
          const float ha = h1[m0 * GS + cc], hb = h1[(m0 + 1) * GS + cc];
#pragma unroll
          for (int r = 0; r < MAXR; ++r) {
            if (r < RPL) {
              const float dv = DD[cc * HP + lane + 32 * r];
              gwp[r][0] = fmaf(dv, ha, gwp[r][0]);
              gwp[r][1] = fmaf(dv, hb, gwp[r][1]);
            }
          }
        }
      }
      {  // dh1 = (Wp^T d_dyn) * (h1 > 0): column tid % G, rows RT (tid /
         // G) .. + RT - 1 (G = 64: RT = 4; G = 32: RT = 2; G = 16: RT = 1)
        constexpr int RT = 32 * G / NT;
        const int cc = tid % G, m0 = RT * (tid / G);
        float acc[RT];
#pragma unroll
        for (int mi = 0; mi < RT; ++mi) acc[mi] = 0.f;
        for (int j = 0; j < h; j += 4) {
          const float4 dv = *reinterpret_cast<const float4*>(DD + cc * HP + j);
#pragma unroll
          for (int mi = 0; mi < RT; ++mi) {
            const float4 wv =
                *reinterpret_cast<const float4*>(Ws + (m0 + mi) * h + j);
            acc[mi] = fmaf(wv.x, dv.x, acc[mi]);
            acc[mi] = fmaf(wv.y, dv.y, acc[mi]);
            acc[mi] = fmaf(wv.z, dv.z, acc[mi]);
            acc[mi] = fmaf(wv.w, dv.w, acc[mi]);
          }
        }
#pragma unroll
        for (int mi = 0; mi < RT; ++mi) {
          const int m = m0 + mi;
          DH1[m * G + cc] = h1[m * GS + cc] > 0.f ? acc[mi] : 0.f;
        }
      }
      __syncthreads();
      if (tid < 256) {  // gW8 += dh1 x8^T
        const int m = tid >> 3, f = tid & 7;
        for (int cc = 0; cc < ng; ++cc)
          gw8 = fmaf(DH1[m * G + cc], x8[f * G + cc], gw8);
      } else if (tid < 288) {  // gb8 += rowsum dh1
        const int m = tid - 256;
        for (int cc = 0; cc < ng; ++cc) gw8 += DH1[m * G + cc];
      }
      __syncthreads();
    }
  };

  for (int k = k0; k < k1; ++k) {
    // ---- phase 0: flags -> bits, prev, action; the step's live columns.
    // Every warp loads a share of the flag rows and of the mask's live bits
    // into the token view; then warp 0 builds words, offsets and the list.
    {
      int* fl = reinterpret_cast<int*>(x8);  // [N][TB] flags
      int* lvb = fl + N * TB;                // [T][TB] live token bits
      const int actw = active ? in.acts[(size_t)k * B + b] : -1;
      for (int i = wy; i < N; i += NWARP)
        fl[i * TB + lane] = in.flags[((size_t)k * N + i) * B + bb];
      const int* mk = in.masks + (size_t)k * A * B + bb;
      for (int t = wy; t < T; t += NWARP) {
        int live = 0;
        if (actw >= 0)
          for (int c = 0; c < C; ++c) live |= mk[(size_t)(t * C + c) * B] == 1;
        lvb[t * TB + lane] = live;
      }
      __syncthreads();
      if (wy == 0) {
        Word pk = 0, a0 = 0, ar = 0, wn = 0;
        for (int i = 0; i < N; ++i) {
          const int f = fl[i * TB + lane];
          pk |= (Word)(f & 1) << i;
          a0 |= (Word)((f >> 1) & 1) << i;
          ar |= (Word)((f >> 2) & 1) << i;
          wn |= (Word)((f >> 3) & 1) << i;
        }
        wb[lane] = pk;
        wb[TB + lane] = a0;
        wb[2 * TB + lane] = ar;
        wb[3 * TB + lane] = wn;
        const int prev = STEPS ? in.prev[(size_t)k * B + bb]
                       : k > 0 ? in.acts[(size_t)(k - 1) * B + bb] : -1;
        const int idx = min(max(prev + 1, 0), A);
        ia[lane] = idx;
        ia[TB + lane] = actw;
        // lanes of this lane's pass that share an embedding row: the next
        // one, and the first
        int nxt = -1, head = 1;
        for (int m = 0; m < TB; ++m) {
          const int other = __shfl_sync(FULL, idx, m);
          if (TP < TB && m / TP != lane / TP) continue;
          if (other == idx && m < lane) head = 0;
          if (other == idx && m > lane && nxt < 0) nxt = m;
        }
        ia[2 * TB + lane] = nxt;
        ia[3 * TB + lane] = head;
        int n = 0;
        for (int t = 0; t < T; ++t) n += lvb[t * TB + lane];
        int x = n;  // inclusive scan over the lanes
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, x, o);
          if (lane >= o) x += y;
        }
        int p = x - n;
        off[lane] = p;
        if (lane == 31) off[TB] = x;
        const unsigned any = __ballot_sync(FULL, actw >= 0);
        if (lane == 0) *flag = any != 0u;
        for (int t = 0; t < T; ++t)
          if (lvb[t * TB + lane]) cols[p++] = (t << 5) | lane;
      }
    }
    __syncthreads();
    if constexpr (DEFER && BWD) {  // grad_outer's record of the step
      if (tid == 0) sflag_o[prow_i * len + (k - k0)] = *flag;
    }
    if (!*flag) continue;  // no action in the tile: adds nothing
    const int n = off[TB];

    // ---- phases A, B: per pass and container its query, then its scores
    for (int p0 = 0; p0 < TB; p0 += TP) {
      fill_qin(k, p0);
      for (int c = 0; c < C; ++c) {
        encode(k, c, p0);
        query();
        if constexpr (WH && BWD) {  // for D and E: q, e1, and the record
          float* rc = rec_at(k, c, p0);
          put_act<TC, TP>(rc + ro.q, qs, h, tid);
          put_act<TC, TP>(rc + ro.qin, qin, FQ, tid);
          put_act<TC, TP>(rc + ro.e1, e1, h, tid);
          put_act<TC, TP>(rc + ro.feats, feats, WD + 2, tid);
        }
        scores(k, c, p0, TP == TB ? 0 : off[p0], TP == TB ? n : off[p0 + TP]);
      }
    }

    // ---- phase C: log pi at the recorded action; the backward's g
    if (wy == 0) {
      const int act = ia[TB + lane];
      const int p0 = off[lane], p1 = off[lane + 1];
      const int* mk = in.masks + (size_t)k * A * B + bb;
      float mx = NEG, se = 0.f, la = NEG;
      for (int p = p0; p < p1; ++p) {
        const int t = cols[p] >> 5;
        for (int c = 0; c < C; ++c) {
          const float m = mk[(size_t)(t * C + c) * B] == 1
                              ? sc[p * C + c] / temperature : NEG;
          sc[p * C + c] = m;
          mx = (p == p0 && c == 0) ? m : fmaxf(mx, m);
          if (t * C + c == act) la = m;
        }
      }
      for (int p = p0; p < p1; ++p)
        for (int c = 0; c < C; ++c) se += expf(sc[p * C + c] - mx);
      if (p1 == p0) se = (float)A;  // every score masked: all A equal
      const float lp = (la - mx) - logf(se);
      lp_sum += act >= 0 ? lp : 0.f;
      if (BWD) {
        const float scale = act >= 0 ? dlp : 0.f;
        for (int p = p0; p < p1; ++p) {
          const int t = cols[p] >> 5;
          for (int c = 0; c < C; ++c) {
            const int a = t * C + c;
            const float pr = expf(sc[p * C + c] - mx) / se;
            const float oh = a == act ? 1.f : 0.f;
            const float mf = mk[(size_t)a * B] == 1 ? 1.f : 0.f;
            sc[p * C + c] = ((scale * (oh - pr)) * mf) * inv_temp;
          }
        }
      }
    }
    __syncthreads();
    if (!BWD) continue;

    // ---- phases D, E, F per pass: per container the token backward, then
    // the query and encoder backward (one pass: qin's shared rows are still
    // in place)
    for (int p0 = 0; p0 < TB; p0 += TP) {
      for (int j = vw; j < h; j += NVW) d_prev[j * LP + vl] = 0.f;
      for (int c = 0; c < C; ++c) {
        // C == 1 in one pass: feats, e1, enc and q_0 are still in place;
        // two passes: q and e1 back from the record that A/B wrote (the
        // weights streamed again for their re-run cost more than the reads)
        if constexpr (WH) {
          const float* rc = rec_at(k, c, p0);
          get_act<TC, TP>(qs, rc + ro.q, h, tid);
          get_act<TC, TP>(e1, rc + ro.e1, h, tid);
        } else if (C > 1) {
          encode(k, c, p0);
          query();
        }
        for (int j = vw; j < h; j += NVW) dqs[j * LP + vl] = 0.f;
        __syncthreads();
        token_bwd(k, c, p0, TP == TB ? 0 : off[p0],
                  TP == TB ? n : off[p0 + TP]);
        // tc, tf: the transposed products on the tensor cores (mvt_mma,
        // mm_tf32), the weight-gradient operands to grad_outer's record,
        // with the barrier that mvt_tiled's staging gave (qin's enc rows are
        // read before dqin overwrites them)
        auto dqin_out = [&](int m, int l, float acc) {
          if (m < h) {
            d_hm[m * LP + l] = acc;  // qin's enc rows: read above, done
            if constexpr (RG) put_split(xmh, xml, m, l, acc);
          } else if (m < 2 * h) {
            const int bl = tile0 + p0 + l;
            if (bl < B) dctx_o[(size_t)(m - h) * B + bl] += acc;
          } else {
            d_prev[(m - 2 * h) * LP + l] += acc;
          }
        };
        auto de1_out = [&](int m, int l, float acc) {
          e1[m * LP + l] = e1[m * LP + l] > 0.f ? acc : 0.f;  // de1
        };
        if constexpr (DEFER) {
          // the weight-gradient contractions go to grad_outer: this (step,
          // container, pass)'s operands to its record (two passes: the
          // activations are there since A/B)
          float* rc = rec_at(k, c, p0);
          put_f32<TP>(rc + ro.dq, dqs, h, tid);
          if constexpr (!WH) put_bf16<TP>(rc + ro.qin, qin, FQ, tid);
          rowsum_acc<TP>(prow + go.bq, dqs, LP, h, tid);
          if constexpr (RG) {  // the barrier; Wq^T's thirds, then W2^T
            for (int e = tid; e < h * TP; e += NT)
              put_split(xdh, xdl, e / TP, e % TP, dqs[(e / TP) * LP + e % TP]);
            const int nsh = h / RING_K;
            chain = tapnet::ring_open(ring, HR, w.wqTr, 3 * NH * nsh, w.w2Tr,
                                      NH * nsh, nullptr, 0, tid);
            rg_mvt(0, 3, xdh, xdl,
                   [&](int u, int m, int t, const float (&a)[2][4]) {
#pragma unroll
              for (int v = 0; v < 2; ++v)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  dqin_out(u * h + m + 8 * (i >> 1), 8 * v + 2 * t + (i & 1),
                           a[v][i]);
            });
            __syncthreads();
          } else if constexpr (WH) {  // Wq^T a third of its rows at a time
            __syncthreads();
            for (int u = 0; u < 3; ++u) {
              tf_mm(w.wqT + (size_t)u * h * h, h, dqs,
                    [&](int m, int l, float acc) {
                      dqin_out(u * h + m, l, acc);
                    });
              __syncthreads();
            }
          } else {
            __syncthreads();
            mvt_mma<3, 16>(w.wqT, 3 * h, h, dqs, stgb, lane, wy, tid,
                               dqin_out);
            __syncthreads();
          }
          put_f32<TP>(rc + ro.dhm, d_hm, h, tid);
          if constexpr (!WH) put_bf16<TP>(rc + ro.e1, e1, h, tid);
          rowsum_acc<TP>(prow + go.b2, d_hm, LP, h, tid);
          __syncthreads();
          if constexpr (RG)
            rg_mvt(3 * NH * (h / RING_K), 1, xmh, xml,
                   [&](int, int m, int t, const float (&a)[2][4]) {
#pragma unroll
              for (int v = 0; v < 2; ++v)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  de1_out(m + 8 * (i >> 1), 8 * v + 2 * t + (i & 1), a[v][i]);
            });
          else if constexpr (TC)
            mvt_mma<1, 64>(w.w2T, h, h, d_hm, stgb, lane, wy, tid,
                               de1_out);
          else
            tf_mm(w.w2T, h, d_hm, de1_out);
          __syncthreads();
          put_f32<TP>(rc + ro.de1, e1, h, tid);
          if constexpr (!WH) put_bf16<TP>(rc + ro.feats, feats, WD + 2, tid);
        } else {
          outer_tiled<TP>(prow + go.wqt, dqs, qin, h, FQ, lane, wy, tid);
          rowsum_acc<TP>(prow + go.bq, dqs, LP, h, tid);
          mvt_tiled<24>(w.wqt, h, 3 * h, FQ, dqs, stg, vl, vw, tid,
                        dqin_out);
          __syncthreads();
          outer_tiled<TP>(prow + go.w2t, d_hm, e1, h, h, lane, wy, tid);
          rowsum_acc<TP>(prow + go.b2, d_hm, LP, h, tid);
          __syncthreads();
          mvt_tiled<8>(w.w2t, h, h, h, d_hm, stg, vl, vw, tid, de1_out);
          __syncthreads();
          outer_tiled<TP>(prow + go.w1t, e1, feats, h, WD + 2, lane, wy, tid);
        }
        rowsum_acc<TP>(prow + go.b1, e1, LP, h, tid);
        __syncthreads();
      }

      // ---- phase F: the previous-action embedding's gradient (one-hot): per
      // row j and embedding row a, the pass's lanes with that row in lane
      // order
      for (int e = tid; e < h * TP; e += NT) {
        const int j = e / TP, l = p0 + e - j * TP;
        if (ia[3 * TB + l]) {
          float acc = 0.f;
          for (int m = l; m >= 0; m = ia[2 * TB + m])
            acc += d_prev[j * LP + m - p0];
          prow[go.et + (size_t)j * (A + 1) + ia[l]] += acc;
        }
      }
      __syncthreads();
    }
  }

  if (!BWD) {
    if (wy == 0 && active) logp_o[b] = lp_sum;
    return;
  }
  // the token-loop weight gradients: each element owned by one thread
  if constexpr (TC) {
#pragma unroll
    for (int u = 0; u < NUW; ++u) {
      const int nt = (wy >> 1) + 8 * u;
      if (nt * 8 < h) {  // gWp^T tile: rows m, columns j
        const int m = 16 * (wy & 1) + g8, j = nt * 8 + 2 * t4;
        float* dst = prow + go.wpt;
        dst[j * 32 + m] = gwa[u][0];
        dst[(j + 1) * 32 + m] = gwa[u][1];
        dst[j * 32 + m + 8] = gwa[u][2];
        dst[(j + 1) * 32 + m + 8] = gwa[u][3];
      }
    }
    if (wy < 2) {
      float* dst = prow + go.w8t + (16 * wy + g8) * 8 + 2 * t4;
      dst[0] = g8a[0];
      dst[1] = g8a[1];
      dst[64] = g8a[2];
      dst[65] = g8a[3];
      if (t4 == 0) {
        prow[go.b8 + 16 * wy + g8] = g8b[0];
        prow[go.b8 + 16 * wy + g8 + 8] = g8b[2];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < RPL) {
        float* dst = prow + go.wpt + (lane + 32 * r) * 32 + 2 * wy;
        dst[0] = gwp[r][0];
        dst[1] = gwp[r][1];
      }
    }
    if (tid < 256) prow[go.w8t + tid] = gw8;
    else if (tid < 288) prow[go.b8 + tid - 256] = gw8;
  }
  float* red = feats;  // [NWARP][h]: gv partials per warp, summed in order
#pragma unroll
  for (int r = 0; r < MAXR; ++r)
    if (r < RPL) red[wy * h + lane + 32 * r] = dvr[r];
  __syncthreads();
  for (int j = tid; j < h; j += NT) {
    float s = 0.f;
    for (int v = 0; v < NWARP; ++v) s += red[v * h + j];
    prow[go.v + j] = s;
  }
}

// The deferred weight-gradient contractions of the float32 backward above
// hidden 128 (rec_off, f32 records) on wgmma (wgmma.cuh), as 3xTF32:
// part[row][off + j cols + n] = the sum over the row's steps with an
// action (sflag), their containers and the record's two passes of 16
// lanes of G[j][l] X[n][l] (G = dq, d_hm, de1; X = qin, e1, feats: a part
// of the record is a K-major tile of each, [rows][16] f32).
//
// Bound: operations, 3 tf32 products a multiply-add (~0.66 ms of tensor
// work at 2d-rolling, hidden 256, batch 4096, against ~0.45 ms to read the
// records once). An mma.sync body, each warp loading and splitting its
// own fragments from L2 (16 warps re-splitting the same X columns, each
// 64-column slice re-reading the row's G), reached 0.2 of the bound.
//
// A block owns one partial row and a tile of GO_NT = 128 columns of one
// section (the last tile of a section takes the rest: 32, 64 or 128 wide,
// or GO_NX = 136 where 8 columns are left over, as of Wq's 3h + 8 at h =
// 256; N = the wgmma width) and all h rows of G: ceil(h / 64) warpgroups
// of 64 rows each (rows h .. of the last one read whatever follows G in
// shared memory and are never stored; every output element depends on its
// own row and column only). The tiles of a row are neighbours in the grid
// (blockIdx.x), so the row's G parts, which every tile reads, come from
// L2 after the first read. The steps of the row with an action are listed
// once (warp 0, a ballot); each (step, container, pass) is a stage: thread
// 0 copies its G part (h x 64 bytes) and its tile of X (one contiguous run
// of rows) with two cp.async.bulk into a ring of GO_RS raw stages, each
// completing on its mbarrier. Per stage every thread splits its share of
// X once into tf32 hi and lo (cvt.rna) in the swizzled B tile, then loads
// its A fragments (G rows j, j + 8, lanes 4t .. 4t + 3: one 16-byte load
// each, no bank conflict) and splits them in registers; after one barrier
// thread 0 refills the stage's raw slot (GO_RS stages on) and each
// warpgroup issues 6 wgmma (two k-steps x lo.hi, hi.lo, hi.hi) and
// commits them without waiting. A k-step takes the lanes 4t + 2ks (as k
// = t) and 4t + 2ks + 1 (as k = t + 4), so the split puts lane 4q + c of
// an X row at position q of its chunk c. A warpgroup waits for its
// products of stage s - 2 only, before it writes stage s's fragments: the
// tensor cores run stage s - 1 across the barrier, the B tiles rotate
// through three buffers, the A fragments through two register sets. The
// copies bind it beside the products (each tile block copies the row's
// whole G part): refilling a slot a stage later was 1.04-1.06x slower,
// after the products are issued 1.09-1.14x, and blocks that walk two rows
// or many (row, tile) items as one stream of stages 1.1-1.4x (the tiles of
// a row no longer ran side by side: PERF.md §6). The accumulators stay in
// registers until one store, through a small staging array a warp so that
// the rows leave as 16-byte runs: one owner and one order per element
// (stages in step, container, pass order; k-steps; the three products),
// no atomics.
constexpr int GO_NT = 128;  // columns of a tile
constexpr int GO_NX = 136;  // at most, the last tile of a section
constexpr int GO_RS = 5;    // raw stages
constexpr int GO_NB = 3;    // B tile buffers
constexpr int GO_KP = 16;   // lanes of a record part (Geo<true>::TP)
constexpr int GO_SL = 40;   // floats of a staging row (32 columns and 8)
static_assert(GO_KP == Geo<true>::TP, "a record part is [rows][16]");

// The shared-memory plan of grad_outer_tf32 at hidden h, in bytes from a
// 1024-byte aligned base (`bytes` includes the slack of that alignment):
// the raw ring, the B tiles, the mbarriers, the acting steps, and a
// [16][GO_SL] float staging array a warp for the stores.
struct GoPlan {
  int wg, raw_g, stage, b, bar, cnt, act, stg, bytes;
};

__host__ __device__ constexpr GoPlan go_plan(int h) {
  GoPlan p{};
  p.wg = (h + 63) / 64;             // warpgroups
  p.raw_g = h * GO_KP * 4;          // a G part; X's tile follows
  p.stage = (p.raw_g + GO_NX * GO_KP * 4 + 1023) & ~1023;
  p.b = GO_NX * GO_KP * 4;          // a B tile, hi (then lo)
  p.bar = GO_RS * p.stage + GO_NB * 2 * p.b;  // GO_RS mbarriers
  p.cnt = p.bar + 8 * GO_RS;        // the count of acting steps
  p.act = p.cnt + 16;               // their list: MAX_N_STEPS ints
  p.stg = p.act + 4 * MAX_N_STEPS;
  p.bytes = p.stg + 4 * p.wg * 16 * GO_SL * 4 + 1024;
  return p;
}

// A block fits at every width the kernel takes (160 .. 256, the widest
// plan the largest; above 256 a block takes one row half of G, `go_rows`);
// ops/replay.py::grad_outer_smem mirrors the plan, and
// tests/test_torch_grad_outer.py holds its hidden-256 size to this one.
static_assert(go_plan(GO_MAXR).bytes <= 227 * 1024, "grad_outer_tf32 plan");
static_assert(go_plan(256).bytes == 222512, "ops/replay.py grad_outer_smem");

// The tiles of a section of `cols` columns: GO_NT wide, the last one up
// to GO_NX (a rest of 8 columns, as Wq's 3h + 8 at h = 256, joins the
// tile before it instead of costing a block that copies all of G for 8
// columns).
__host__ __device__ inline int go_ntiles(int cols) {
  return cols <= GO_NX ? 1 : (cols - (GO_NX - GO_NT) + GO_NT - 1) / GO_NT;
}

// Block (tile, row): the tiles of a row are Wq's section's (3h + 8
// columns), then W2's (h), then W1's (W*D + 2).
__host__ __device__ inline int go_tiles(const Dims& d) {
  return go_ntiles(3 * d.h + 8) + go_ntiles(d.h) + go_ntiles(d.W * d.D + 2);
}

// The rows of G a block of grad_outer_tf32 or grad_outer takes: all h up
// to GO_MAXR, above (h = 320 .. 512) one of the two row halves
// (blockIdx.z), so that the plan and the warpgroups stay those of h / 2.
__host__ __device__ inline int go_rows(int h) {
  return h > GO_MAXR ? h / 2 : h;
}

// A block's tile: columns n0 .. n0 + width of a section of `cols`
// columns, the section's offset in a partial row (`off`) and its G and X
// parts' offsets in a record part (`gof`, `xof`, floats); the block's
// rows r0 .. r0 + rows of G and of the gradient
struct GoTile {
  int cols, off, gof, xof, n0, width, rows, r0;
};

__device__ inline GoTile go_tile_of(const Dims& d, const RecOff& ro,
                                    int tile) {
  const GOff go = goff(d);
  const int h = d.h, FQ = 3 * h + 8;
  const int tq = go_ntiles(FQ), t2 = go_ntiles(h);
  GoTile t;
  if (tile < tq) {
    t = {FQ, go.wqt, ro.dq, ro.qin, 0, 0};
  } else if (tile < tq + t2) {
    tile -= tq;
    t = {h, go.w2t, ro.dhm, ro.e1, 0, 0};
  } else {
    tile -= tq + t2;
    t = {d.W * d.D + 2, go.w1t, ro.de1, ro.feats, 0, 0};
  }
  t.n0 = GO_NT * tile;
  t.width = tile + 1 == go_ntiles(t.cols) ? t.cols - t.n0 : GO_NT;
  t.rows = go_rows(h);
  t.r0 = blockIdx.z * t.rows;
  return t;
}

// The steps of partial row `row` with an action, in order (warp 0, a
// ballot), into act and their count into *cnt; thread 0 then inits the
// ring's `rs` mbarriers. Ends with a block barrier.
__device__ void go_begin(const int* __restrict__ sflag, size_t row, int len,
                         int* cnt, int* act, unsigned long long* bar,
                         int rs) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    int n = 0;
    for (int s0 = 0; s0 < len; s0 += 32) {
      const int st = s0 + tid;
      const bool on = st < len && sflag[row * len + st] != 0;
      const unsigned m = __ballot_sync(~0u, on);
      if (on) act[n + __popc(m & ((1u << tid) - 1))] = st;
      n += __popc(m);
    }
    if (tid == 0) {
      *cnt = n;
      for (int i = 0; i < rs; ++i) tapnet::mbar_init(bar + i, 1);
      tapnet::mbar_init_fence();
    }
  }
  __syncthreads();
}

// the block's dynamic shared memory from a 1024-byte aligned base
__device__ __forceinline__ unsigned char* go_base(unsigned char* dyn) {
  return dyn + ((1024 - (tapnet::smem_addr(dyn) & 1023)) & 1023);
}

// keeps the compiler from moving writes of a fragment set across the
// products that read it
__device__ __forceinline__ void go_fence_a(unsigned (&a)[2][4]) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// The accumulators of a tile of N columns (n0 .., `cols` in the section;
// this thread's rows j, j + 8 of the 64 of its warpgroup, those below h
// kept) stored to dst (the section's gradient in the row: [h][cols])
// through this warp's [16][GO_SL] staging rows stg, 32 columns at a time,
// each row written back as 16-byte runs where the section's rows allow
// (scattered 4-byte stores straight from the fragments took a sixth of
// the time at 2d-basic, PERF.md §6)
template <int N>
__device__ __forceinline__ void go_store(float (&acc)[N / 2], float* stg,
                                         float* __restrict__ dst, int h,
                                         int j, int n0, int cols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = j - g;
  const bool vec = (cols & 3) == 0;
#pragma unroll
  for (int c0 = 0; c0 < N; c0 += 32) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = c0 / 8 + u;
      if (i < N / 8) {
        *reinterpret_cast<float2*>(stg + g * GO_SL + 8 * u + 2 * t) =
            make_float2(acc[4 * i], acc[4 * i + 1]);
        *reinterpret_cast<float2*>(stg + (g + 8) * GO_SL + 8 * u + 2 * t) =
            make_float2(acc[4 * i + 2], acc[4 * i + 3]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = (lane >> 3) + 4 * p, jj = wr + r;
      const int nn = n0 + c0 + 4 * (lane & 7);
      const float4 v = *reinterpret_cast<const float4*>(stg + r * GO_SL
                                                        + 4 * (lane & 7));
      if (jj < h && nn < min(cols, n0 + N)) {
        float* o = dst + (size_t)jj * cols + nn;
        if (vec && nn + 3 < cols) {
          *reinterpret_cast<float4*>(o) = v;
        } else {
          o[0] = v.x;
          if (nn + 1 < cols) o[1] = v.y;
          if (nn + 2 < cols) o[2] = v.z;
          if (nn + 3 < cols) o[3] = v.w;
        }
      }
    }
    __syncwarp();
  }
}

// chunk q (lanes 4q .. 4q + 3) of row r of a raw [rows][16] f32 X part
// split into tf32 hi and lo: lane 4q + c to position q of chunk c
__device__ __forceinline__ void go_split(const unsigned char* raw,
                                         unsigned char* hi,
                                         unsigned char* lo, int i) {
  const int r = i >> 2, q = i & 3;
  const float4 v = *reinterpret_cast<const float4*>(raw + 64 * r + 16 * q);
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    unsigned xh, xl;
    tapnet::split_tf32(x[c], xh, xl);
    const int o = tapnet::sw64(r, c) + 4 * q;
    *reinterpret_cast<unsigned*>(hi + o) = xh;
    *reinterpret_cast<unsigned*>(lo + o) = xl;
  }
}

// one block's tile (tl) of N columns, summed over the ns stages of `act`,
// stored to dst (the section's gradient in the row: [h][cols])
template <int N>
__device__ void go_tile(const Dims& d, const float* __restrict__ rec,
                        const RecOff& ro, size_t row, int len,
                        const GoTile& tl, float* __restrict__ dst,
                        unsigned char* sm, const GoPlan& pl,
                        unsigned long long* bar, const int* act, int ns) {
  using namespace tapnet;
  constexpr int NP = Geo<true>::NP;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int j = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + g;  // and j + 8
  const int h = tl.rows, C = d.C;  // the block's rows of G
  const unsigned gbytes = h * GO_KP * 4, xbytes = tl.width * GO_KP * 4;
  auto issue = [&](int s) {
    const int st = act[s / (C * NP)], c = (s / NP) % C, pp = s % NP;
    const float* r = rec + ((row * len + st) * C + c) * (size_t)ro.size
                     + pp * ro.pass;
    unsigned char* raw = sm + (s % GO_RS) * pl.stage;
    unsigned long long* b = bar + s % GO_RS;
    mbar_expect(b, gbytes + xbytes);
    bulk_copy(raw, r + tl.gof + (size_t)tl.r0 * GO_KP, gbytes, b);
    bulk_copy(raw + pl.raw_g, r + tl.xof + (size_t)tl.n0 * GO_KP, xbytes, b);
  };
  if (tid == 0)
    for (int s = 0; s < min(ns, GO_RS); ++s) issue(s);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  unsigned ah0[2][4], al0[2][4], ah1[2][4], al1[2][4];
  auto stage = [&](int s, unsigned (&ah)[2][4], unsigned (&al)[2][4]) {
    const unsigned char* raw = sm + (s % GO_RS) * pl.stage;
    unsigned char* bh = sm + GO_RS * pl.stage + (s % GO_NB) * 2 * pl.b;
    unsigned char* bl = bh + pl.b;
    mbar_wait(bar + s % GO_RS, (s / GO_RS) & 1);
    for (int i = tid; i < 4 * N; i += nthr)
      go_split(raw + pl.raw_g, bh, bl, i);
    fence_proxy_async();  // the splits, before the tensor cores read them
    wg_wait<1>();         // this warpgroup's products of stage s - 2
    const float4 u = *reinterpret_cast<const float4*>(raw + 64 * j + 16 * t);
    const float4 v =
        *reinterpret_cast<const float4*>(raw + 64 * (j + 8) + 16 * t);
    go_fence_a(ah);
    go_fence_a(al);
    split_tf32(u.x, ah[0][0], al[0][0]);
    split_tf32(v.x, ah[0][1], al[0][1]);
    split_tf32(u.y, ah[0][2], al[0][2]);
    split_tf32(v.y, ah[0][3], al[0][3]);
    split_tf32(u.z, ah[1][0], al[1][0]);
    split_tf32(v.z, ah[1][1], al[1][1]);
    split_tf32(u.w, ah[1][2], al[1][2]);
    split_tf32(v.w, ah[1][3], al[1][3]);
    __syncthreads();  // every split of s, every read of raw stage s, every
                      // product of s - 2
    if (tid == 0 && s + GO_RS < ns) issue(s + GO_RS);
    wg_fence_acc(acc);
    wg_fence();
    wg_mma3<N>(acc, ah, al, bh, bl);
    wg_commit();
    go_fence_a(ah);
    go_fence_a(al);
  };
  for (int s = 0; s < ns; s += 2) {
    stage(s, ah0, al0);
    if (s + 1 < ns) stage(s + 1, ah1, al1);
  }
  wg_wait<0>();
  wg_fence_acc(acc);
  go_store<N>(acc,
              reinterpret_cast<float*>(sm + pl.stg) + (tid >> 5) * 16 * GO_SL,
              dst, h, j, tl.n0, tl.cols);
}

__global__ void __launch_bounds__(512, 1)
grad_outer_tf32(Dims d, const float* __restrict__ rec,
                const int* __restrict__ sflag, int len,
                float* __restrict__ part) {
  extern __shared__ unsigned char go_dyn[];
  unsigned char* sm = go_base(go_dyn);
  const GoPlan pl = go_plan(go_rows(d.h));
  const RecOff ro = rec_off<1>(d, false);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(sm + pl.bar);
  int* cnt = reinterpret_cast<int*>(sm + pl.cnt);
  int* act = reinterpret_cast<int*>(sm + pl.act);
  const size_t row = blockIdx.y;
  go_begin(sflag, row, len, cnt, act, bar, GO_RS);
  const int ns = *cnt * d.C * Geo<true>::NP;
  const GoTile tl = go_tile_of(d, ro, blockIdx.x);
  float* dst = part + row * goff(d).P + tl.off + (size_t)tl.r0 * tl.cols;
  if (tl.width > GO_NT)
    go_tile<GO_NX>(d, rec, ro, row, len, tl, dst, sm, pl, bar, act, ns);
  else if (tl.width > 64)
    go_tile<128>(d, rec, ro, row, len, tl, dst, sm, pl, bar, act, ns);
  else if (tl.width > 32)
    go_tile<64>(d, rec, ro, row, len, tl, dst, sm, pl, bar, act, ns);
  else
    go_tile<32>(d, rec, ro, row, len, tl, dst, sm, pl, bar, act, ns);
}

// The deferred weight-gradient contractions of the bfloat16 backward
// (rec_off, bfloat16 records; every hidden width 32 .. 256) on wgmma
// (wgmma.cuh): part[row][off + j cols + n] = the sum over the row's steps
// with an action (sflag), their containers, the record's passes and lanes
// l of G[j][l] X[n][l] (G = dq, d_hm, de1 f32, split into bf16 hi + lo; X
// = qin, e1, feats bfloat16), as hi.X + lo.X summed in f32 (`split`: x to
// a relative 2^-16, each product exact).
//
// Bound: bytes (the records read once: at 2d-rolling, hidden 256, batch
// 4096, ~0.40 ms against ~0.25 ms of bf16 tensor work). An mma.sync body
// ran at 0.22-0.25 of the bound: every
// warp loaded its own fragments straight from L2 (the X columns of a slice
// fed by all h / 16 warps), each 64-column slice re-read the row's G, the
// slices of a row ran apart at h <= 128 (grid (rows, slices)) so that the
// re-reads came from device memory, and the stores were scattered 4-byte
// writes.
//
// The design is grad_outer_tf32's (above): a block owns a partial row,
// one tile (GoTile: up to GO_NT columns, GO_NX for the last) of one
// section and all h rows of G, ceil(h / 64) warpgroups; the tiles of a row
// are neighbours in the grid (blockIdx.x), at every width; the acting
// steps listed once; a ring of raw stages filled by cp.async.bulk, each
// on its mbarrier, refilled right after the barrier of the stage that read
// it; `wait_group 1` with three B buffers and two register sets; the
// stores through go_store. What differs:
// - a stage is one acting (step, container) with both passes above hidden
//   128, so K = 32 lanes at every width: two k-steps of 16. Its G is [h]
//   rows of 32 lanes f32 (h <= 128: one copy of the record's part; above:
//   the two passes' [h][16] parts, one after the other), its X the tile's
//   rows of 32 bf16 (above: the two passes' rows of 16, each its own run
//   of the raw stage, the second 64 bytes further on so that a quarter
//   warp reading a row of each meets no bank conflict).
// - B: the raw X rows moved in 16-byte chunks into the swizzled tile
//   [N][32] bf16 (a k-step of 16 lanes is 32 bytes of a row, as tf32's 8:
//   `sw64`, `wg_desc`); above 128 pass p's chunks become chunks 2p, 2p +
//   1 of the row. No split: X is bfloat16 already.
// - A: a thread's fragment holds rows j, j + 8 and, per k-step, lanes 2t,
//   2t + 1 and 2t + 8, 2t + 9 (in the record's order, so that X needs no
//   permutation): four 8-byte loads a row, (k-step, half) = q. Rows of 128
//   bytes (h <= 128) put a lane on the same bank in every row, rows of 64
//   bytes in every other one, so load i of a thread reads q = i ^ rot (rot
//   = g & 3, or (g >> 1) & 1 above 128): the 16 threads of a half warp meet
//   no bank conflict. Two conditional swaps put the values back in q
//   order; each is split in registers into hi and lo (`split`) in wgmma's
//   fragment layout.
// - products: per k-step lo.X, then hi.X (wg_mma2), 4 wgmma a stage.
// - the shared-memory plan (gb_plan): 3 raw stages at h <= 128, so that
//   two blocks (8 warps each at h = 128) share an SM, 4 above; the stores'
//   staging arrays reuse the raw ring once every stage is read.
// Each output element has one owner and one order (stages in step,
// container order; k-steps; lo before hi), no atomics: two launches are
// bit-identical.

// The shared-memory plan of grad_outer at hidden h, in bytes from a
// 1024-byte aligned base (`bytes` includes the slack of that alignment):
// the raw ring (rs stages of G [h][32] f32, then X's raw rows, up to
// GO_NX of 64 bytes and 64 bytes between the two passes' runs), the B
// tiles, the mbarriers, the count and the list of acting steps. A's reads
// of the last warpgroup's rows h .. 64 wg stay in the stage (they run into
// X at most 64 wg - h <= 32 rows of 128 bytes, or, in the second pass of
// 64-byte rows, into X by 32 rows); the staging arrays of the stores (wg x
// 4 warps x [16][GO_SL] floats) fit in the ring they reuse.
struct GbPlan {
  int wg, rs, g, stage, b, bar, cnt, act, bytes;
};

__host__ __device__ constexpr GbPlan gb_plan(int h) {
  GbPlan p{};
  p.wg = (h + 63) / 64;
  p.rs = h <= 128 ? 3 : 4;
  p.g = h * 32 * 4;
  p.stage = (p.g + GO_NX * 64 + 64 + 1023) & ~1023;
  p.b = GO_NX * 64;
  p.bar = p.rs * p.stage + GO_NB * p.b;
  p.cnt = p.bar + 8 * p.rs;
  p.act = p.cnt + 16;
  p.bytes = p.act + 4 * MAX_N_STEPS + 1024;
  return p;
}

// A block fits at every width (the widest plan the largest), two an SM
// (228 KB, 1 KB of it reserved a block) at h <= 128, and the staging
// arrays fit in the ring; ops/replay.py::grad_outer_bf16_smem mirrors the
// plan, and tests/test_torch_grad_outer_bf16.py holds its sizes at hidden
// 128 and 256 to these.
static_assert(gb_plan(GO_MAXR).bytes <= 227 * 1024, "grad_outer plan");
static_assert(2 * (gb_plan(128).bytes + 1024) <= 228 * 1024,
              "two grad_outer blocks an SM at h <= 128");
static_assert(4 * gb_plan(GO_MAXR).wg * 16 * GO_SL * 4
                  <= gb_plan(GO_MAXR).rs * gb_plan(GO_MAXR).stage,
              "grad_outer's staging in the ring");
static_assert(gb_plan(128).bytes == 104224 && gb_plan(256).bytes == 195368,
              "ops/replay.py grad_outer_bf16_smem");

// a conditional swap (no local memory: the selects stay in registers)
__device__ __forceinline__ void gb_swap(float2& a, float2& b, bool s) {
  const float2 x = s ? b : a, y = s ? a : b;
  a = x;
  b = y;
}

// one block's tile (tl) of N columns, summed over the ns stages of `act`,
// stored to dst (the section's gradient in the row: [h][cols])
template <int N, bool WH>
__device__ void gb_tile(const Dims& d, const float* __restrict__ rec,
                        const RecOff& ro, size_t row, int len,
                        const GoTile& tl, float* __restrict__ dst,
                        unsigned char* sm, const GbPlan& pl,
                        unsigned long long* bar, const int* act, int ns) {
  using namespace tapnet;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int j = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + g;  // and j + 8
  const int h = tl.rows, C = d.C, rs = pl.rs;  // the block's rows of G
  // X's second pass's run in a raw stage (above 128)
  constexpr int X1 = GO_NX * 32 + 64;
  auto issue = [&](int s) {
    const int st = act[s / C], c = s % C;
    const float* r = rec + ((row * len + st) * C + c) * (size_t)ro.size;
    unsigned char* raw = sm + (s % rs) * pl.stage;
    unsigned long long* b = bar + s % rs;
    mbar_expect(b, pl.g + tl.width * 64);
    if (WH) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        bulk_copy(raw + p * h * 64,
                  r + p * ro.pass + tl.gof + (size_t)tl.r0 * 16, h * 64, b);
        bulk_copy(raw + pl.g + p * X1,
                  r + p * ro.pass + tl.xof + (size_t)tl.n0 * 8,
                  tl.width * 32, b);
      }
    } else {
      bulk_copy(raw, r + tl.gof, pl.g, b);
      bulk_copy(raw + pl.g, r + tl.xof + (size_t)tl.n0 * 16, tl.width * 64,
                b);
    }
  };
  if (tid == 0)
    for (int s = 0; s < min(ns, rs); ++s) issue(s);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  unsigned ah0[2][4], al0[2][4], ah1[2][4], al1[2][4];
  // A's load i of a row reads (k-step, half) q = i ^ rot
  const int rot = WH ? (g >> 1) & 1 : g & 3;
  const int xrows = (tl.width + 7) & ~7;  // B rows that reach a stored
                                          // column
  auto stage = [&](int s, unsigned (&ah)[2][4], unsigned (&al)[2][4]) {
    const unsigned char* raw = sm + (s % rs) * pl.stage;
    unsigned char* bt = sm + rs * pl.stage + (s % GO_NB) * pl.b;
    mbar_wait(bar + s % rs, (s / rs) & 1);
    for (int i = tid; i < 4 * xrows; i += nthr) {  // X's rows to the B tile
      const int n = i >> 2, c = i & 3;
      const unsigned char* x = WH ? raw + pl.g + (c >> 1) * X1 + 32 * n
                                        + 16 * (c & 1)
                                  : raw + pl.g + 64 * n + 16 * c;
      *reinterpret_cast<uint4*>(bt + sw64(n, c)) =
          *reinterpret_cast<const uint4*>(x);
    }
    fence_proxy_async();  // the B tile, before the tensor cores read it
    wg_wait<1>();         // this warpgroup's products of stage s - 2
    go_fence_a(ah);
    go_fence_a(al);
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // rows j, j + 8
      const int jr = j + 8 * u;
      float2 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = i ^ rot;
        v[i] = *reinterpret_cast<const float2*>(
            WH ? raw + (q >> 1) * h * 64 + 64 * jr + 32 * (q & 1) + 8 * t
               : raw + 128 * jr + 32 * q + 8 * t);
      }
      if (!WH) {
        gb_swap(v[0], v[2], rot & 2);
        gb_swap(v[1], v[3], rot & 2);
      }
      gb_swap(v[0], v[1], rot & 1);
      gb_swap(v[2], v[3], rot & 1);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split(v[q], ah[q >> 1][u + 2 * (q & 1)], al[q >> 1][u + 2 * (q & 1)]);
    }
    __syncthreads();  // every B row of s, every read of raw stage s, every
                      // product of s - 2
    if (tid == 0 && s + rs < ns) issue(s + rs);
    wg_fence_acc(acc);
    wg_fence();
    wg_mma2<N>(acc, ah, al, bt);
    wg_commit();
    go_fence_a(ah);
    go_fence_a(al);
  };
  for (int s = 0; s < ns; s += 2) {
    stage(s, ah0, al0);
    if (s + 1 < ns) stage(s + 1, ah1, al1);
  }
  wg_wait<0>();
  wg_fence_acc(acc);
  // the raw ring is read: every stage passed its barrier
  go_store<N>(acc, reinterpret_cast<float*>(sm) + (tid >> 5) * 16 * GO_SL,
              dst, h, j, tl.n0, tl.cols);
}

template <bool WH>
__global__ void __launch_bounds__(512, 1)
grad_outer(Dims d, const float* __restrict__ rec,
           const int* __restrict__ sflag, int len, float* __restrict__ part) {
  extern __shared__ unsigned char go_dyn[];
  unsigned char* sm = go_base(go_dyn);
  const GbPlan pl = gb_plan(go_rows(d.h));
  const RecOff ro = rec_off<WH>(d, true);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(sm + pl.bar);
  int* cnt = reinterpret_cast<int*>(sm + pl.cnt);
  int* act = reinterpret_cast<int*>(sm + pl.act);
  const size_t row = blockIdx.y;
  go_begin(sflag, row, len, cnt, act, bar, pl.rs);
  const int ns = *cnt * d.C;
  const GoTile tl = go_tile_of(d, ro, blockIdx.x);
  float* dst = part + row * goff(d).P + tl.off + (size_t)tl.r0 * tl.cols;
  if (tl.width > GO_NT)
    gb_tile<GO_NX, WH>(d, rec, ro, row, len, tl, dst, sm, pl, bar, act, ns);
  else if (tl.width > 64)
    gb_tile<128, WH>(d, rec, ro, row, len, tl, dst, sm, pl, bar, act, ns);
  else if (tl.width > 32)
    gb_tile<64, WH>(d, rec, ro, row, len, tl, dst, sm, pl, bar, act, ns);
  else
    gb_tile<32, WH>(d, rec, ro, row, len, tl, dst, sm, pl, bar, act, ns);
}

// Launches of the helper kernels since the library was loaded, counted
// where each is launched: grad_outer_tf32, reduce_tiles with 1-, 2- and
// 4-float loads, then grad_outer (tapnet_replay_helper_launches reads
// them).
long long helper_launches[5] = {0, 0, 0, 0, 0};

// grad_outer_tf32 (bf = false) or grad_outer over `rows` partial rows of
// `len` steps (its own attribute and block shape: ceil(h / 64)
// warpgroups)
static cudaError_t launch_grad_outer(const Dims& d, bool bf,
                                     const float* rec, const int* sflag,
                                     int rows, int len, float* part,
                                     cudaStream_t st) {
  // (above GO_MAXR: blockIdx.z takes a row half of G)
  const dim3 grid(go_tiles(d), rows, d.h / go_rows(d.h));
  cudaError_t err;
  if (!bf) {
    const GoPlan pl = go_plan(go_rows(d.h));
    err = cudaFuncSetAttribute(grad_outer_tf32,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               pl.bytes);
    if (err != cudaSuccess) return err;
    grad_outer_tf32<<<grid, 128 * pl.wg, pl.bytes, st>>>(d, rec, sflag, len,
                                                         part);
  } else {
    const GbPlan pl = gb_plan(go_rows(d.h));
    auto kernel = d.h > 128 ? grad_outer<true> : grad_outer<false>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, 128 * pl.wg, pl.bytes, st>>>(d, rec, sflag, len, part);
  }
  err = cudaGetLastError();
  if (err == cudaSuccess) ++helper_launches[bf ? 4 : 0];
  return err;
}

// out[e] = sum over tiles, in tile order, of part[tile, e]: each element a
// left-to-right f32 sum (the bits of `acc += x` from 0 in tile order),
// bound by bytes. V = 4, 2 or 1 columns a thread (16-, 8- or 4-byte
// loads; P a multiple of V, so every row starts aligned) and 32 / V tile
// rows loaded before their adds (32 values in flight a thread), which
// stay in tile order; the loads read each byte once, so they skip L1 and
// ask L2 for 256-byte runs. A column a thread with one load at a time
// lost to torch.sum(part, 0) by up to 1.24x.
constexpr int RT_UV = 32;

template <int V>
struct RtVec;
template <>
struct RtVec<1> {
  using T = float;
  static __device__ T zero() { return 0.f; }
};
template <>
struct RtVec<2> {
  using T = float2;
  static __device__ T zero() { return make_float2(0.f, 0.f); }
};
template <>
struct RtVec<4> {
  using T = float4;
  static __device__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }

__device__ __forceinline__ void add_to(float2& a, const float2& b) {
  a.x += b.x;
  a.y += b.y;
}

__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ void ld_stream(float& v, const float* p) {
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.f32 %0, [%1];"
               : "=f"(v)
               : "l"(p));
}

__device__ __forceinline__ void ld_stream(float2& v, const float2* p) {
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "l"(p));
}

__device__ __forceinline__ void ld_stream(float4& v, const float4* p) {
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 "
               "{%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
}

template <int V>
__global__ void __launch_bounds__(128)
reduce_tiles(const float* __restrict__ part, int tiles, int P,
             float* __restrict__ out) {
  using T = typename RtVec<V>::T;
  constexpr int RT_U = RT_UV / V;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (e >= P) return;
  const T* p = reinterpret_cast<const T*>(part + e);
  const size_t stride = (size_t)P / V;
  T acc = RtVec<V>::zero();
  for (int t = 0; t < tiles; t += RT_U) {
    T v[RT_U];
#pragma unroll
    for (int u = 0; u < RT_U; ++u)
      if (t + u < tiles) ld_stream(v[u], p + (t + u) * stride);
#pragma unroll
    for (int u = 0; u < RT_U; ++u)
      if (t + u < tiles) add_to(acc, v[u]);
  }
  *reinterpret_cast<T*>(out + e) = acc;
}

// reduce_tiles on [tiles, P] at `part`. The widths, from the fastest of
// those timed on the backward's sums and on the library's input (PERF.md
// §6): 16-byte loads where they still give 16 warps an SM (132 of them:
// the weight-gradient rows above hidden 128, d_ctx's chunks); below that,
// 8-byte loads where the rows exceed ~40 MB, which L2 (50 MB) does not
// keep (hidden 128 on 2d-rolling), else 4-byte loads of 32 rows, which
// wait on L2 round trips and want the most of them in flight (hidden 128
// on 2d-basic, the logp chunks). Blocks of 128 threads halved down to 32
// until there are two an SM, so that small sums spread over the card.
static cudaError_t launch_reduce_tiles(const float* part, int tiles, int P,
                                       float* out, cudaStream_t st) {
  constexpr int WANT = 132 * 16 * 32;  // threads
  const bool dram = 4ll * tiles * P > (40ll << 20);
  const int V = P % 4 == 0 && P / 4 >= WANT ? 4
                : P % 2 == 0 && dram        ? 2
                                            : 1;
  const int threads = P / V;
  int bs = 128;
  while (bs > 32 && (threads + bs - 1) / bs < 2 * 132) bs /= 2;
  const int blocks = (threads + bs - 1) / bs;
  if (V == 4)
    reduce_tiles<4><<<blocks, bs, 0, st>>>(part, tiles, P, out);
  else if (V == 2)
    reduce_tiles<2><<<blocks, bs, 0, st>>>(part, tiles, P, out);
  else
    reduce_tiles<1><<<blocks, bs, 0, st>>>(part, tiles, P, out);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++helper_launches[V == 4 ? 3 : V];
  return err;
}

// out[e, b] = sum over chunks, in chunk order, of part[chunk, b, e] for
// e < E: 32 x 32 tiles through shared memory, coalesced both ways.
__global__ void sum_transpose(const float* __restrict__ part, int nc, int B,
                              int E, float* __restrict__ out) {
  __shared__ float tile[32][33];
  const int e0 = blockIdx.x * 32, b0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int bq = b0 + i, e = e0 + tx;
    float acc = 0.f;
    if (bq < B && e < E)
      for (int c = 0; c < nc; ++c) acc += part[((size_t)c * B + bq) * E + e];
    tile[i][tx] = acc;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int e = e0 + i, bq = b0 + tx;
    if (e < E && bq < B) out[(size_t)e * B + bq] = tile[tx][i];
  }
}

}  // namespace

// Dynamic shared memory of one block of the forward (bwd = 0) or backward
// (bwd = 1) kernel, in bytes (tc: the bfloat16 instantiations' plan; h >
// 128: the plan of two head passes, Geo); the wrapper refuses configs above
// the limit.
static long long smem_bytes(const Dims& d, int bwd, bool steps, bool tc) {
  const int wc = tapnet::geo_class(d.h);
  const int floats = wc == 2   ? layout<2>(d, bwd != 0, tc).floats
                     : wc == 1 ? layout<1>(d, bwd != 0, tc).floats
                               : layout<0>(d, bwd != 0, tc).floats;
  return 4ll * (floats + n_ints(d, steps));
}

// 0 where the instantiation keeps no records (float32 at h <= 128)
static int record_floats(const Dims& d, bool bf) {
  if (d.h > 128) return rec_off<1>(d, bf).size;
  return bf ? rec_off<0>(d, true).size : 0;
}

template <bool STEPS, int WC, class E>
static int launch(int bwd, void* const* p, const Dims& d, int chunks,
                  float inv_s, float temperature, float inv_temp,
                  void* stream) {
  const ReplayIn<E> in{(const int*)p[0],  (const int*)p[1],
                       (const int*)p[2],  (const int*)p[3],
                       (const int*)p[25], (const E*)p[4],
                       (const E*)p[5],    (const E*)p[6],
                       (const E*)p[7],    (const float*)p[8]};
  const HeadW<E> w{(const E*)p[9],  (const E*)p[10], (const E*)p[11],
                   (const E*)p[12], (const E*)p[13], (const E*)p[14],
                   (const E*)p[15], (const E*)p[16], (const E*)p[17],
                   (const E*)p[18], (const float*)p[19], (const E*)p[29],
                   (const E*)p[30], (const E*)p[31], (const bf16*)p[34],
                   (const bf16*)p[35], (const bf16*)p[36], (const bf16*)p[37],
                   (const bf16*)p[38]};
  const size_t smem =
      (size_t)smem_bytes(d, bwd, STEPS, std::is_same_v<E, bf16>);
  const int tiles = (d.B + TB - 1) / TB;
  const int S = d.N;
  const int len = (S + chunks - 1) / chunks;  // steps per chunk
  const int nc = (S + len - 1) / len;         // chunks that hold a step
  const dim3 grid(tiles, STEPS ? nc : 1);
  const dim3 block(TB, NWARP);
  cudaStream_t st = (cudaStream_t)stream;
  const int T = d.N * d.R;
  cudaError_t err;
  if (!bwd) {
    auto kernel = replay_kernel<false, STEPS, WC, E>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    // one chunk writes logp itself; more write partials [nc, B] to p[26]
    float* lp = nc > 1 ? (float*)p[26] : (float*)p[20];
    kernel<<<grid, block, smem, st>>>(d, in, w, inv_s, temperature, inv_temp,
                                      lp, nullptr, nullptr, nullptr, len,
                                      nullptr, nullptr, (float*)p[39]);
    err = cudaGetLastError();
    if (err != cudaSuccess || nc == 1) return (int)err;
    return (int)launch_reduce_tiles(lp, nc, d.B, (float*)p[20], st);
  }
  auto kernel = replay_kernel<true, STEPS, WC, E>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // d_se partials [nc, B, T, h] in p[27]; one chunk writes d_ctx itself,
  // more write partials [nc, h, B] to p[28]
  float* dctx = nc > 1 ? (float*)p[28] : (float*)p[22];
  constexpr bool tc = std::is_same_v<E, bf16>;
  constexpr bool defer = tc || WC > 0;  // the records (rec_off)
  kernel<<<grid, block, smem, st>>>(d, in, w, inv_s, temperature, inv_temp,
                                    nullptr, (float*)p[27], dctx,
                                    (float*)p[23], len,
                                    defer ? (float*)p[32] : nullptr,
                                    defer ? (int*)p[33] : nullptr,
                                    (float*)p[39]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (defer) {  // the deferred weight-gradient contractions
    err = launch_grad_outer(d, tc, (const float*)p[32], (const int*)p[33],
                            tiles * nc, len, (float*)p[23], st);
    if (err != cudaSuccess) return (int)err;
  }
  const int P = goff(d).P;
  err = launch_reduce_tiles((const float*)p[23], tiles * nc, P,
                            (float*)p[24], st);
  if (err != cudaSuccess) return (int)err;
  const int rows = T * d.h;
  sum_transpose<<<dim3((rows + 31) / 32, (d.B + 31) / 32), dim3(32, 8), 0,
                  st>>>((const float*)p[27], nc, d.B, rows, (float*)p[21]);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 1) return (int)err;
  return (int)launch_reduce_tiles(dctx, nc, d.h * d.B, (float*)p[22], st);
}

// the instantiation of the schedule (steps), the dtype (bf) and the head's
// width class (WC, geo.cuh)
template <int WC>
static int pick(int steps, int bf, int bwd, void* const* p, const Dims& d,
                int chunks, float inv_s, float temperature, float inv_temp,
                void* stream) {
  if (bf)
    return steps ? launch<true, WC, bf16>(bwd, p, d, chunks, inv_s,
                                          temperature, inv_temp, stream)
                 : launch<false, WC, bf16>(bwd, p, d, 1, inv_s, temperature,
                                           inv_temp, stream);
  return steps ? launch<true, WC, float>(bwd, p, d, chunks, inv_s,
                                         temperature, inv_temp, stream)
               : launch<false, WC, float>(bwd, p, d, 1, inv_s, temperature,
                                          inv_temp, stream);
}

// The floats of one block's scratch (pointer 39) at ints = B, N, W, D, R,
// C, h: what ops/replay.py::wx_scratch mirrors; 0 at h <= 256.
extern "C" long long tapnet_replay_scratch(const int* ints) {
  const Dims d{ints[0], ints[1], ints[2], ints[3], ints[4], ints[5], ints[6]};
  return tapnet::geo_class(d.h) == 2 ? wx_scratch(d) : 0;
}

// Shared memory of one block in bytes for ints = B, N, W, D, R, C, h (as
// tapnet_replay_logp takes them), the kernel (bwd), the schedule (steps)
// and the instantiation (bf16): what ops/replay.py::smem_bytes mirrors.
extern "C" long long tapnet_replay_smem_bytes(const int* ints, int bwd,
                                              int steps, int bf16) {
  const Dims d{ints[0], ints[1], ints[2], ints[3], ints[4], ints[5], ints[6]};
  return smem_bytes(d, bwd, steps != 0, bf16 != 0);
}

// Floats of one grad_outer record (rec_off) at ints = B, N, W, D, R, C, h
// of the instantiation (bf16); 0 for float32 at h <= 128, which keeps none.
extern "C" int tapnet_replay_record_floats(const int* ints, int bf16) {
  const Dims d{ints[0], ints[1], ints[2], ints[3], ints[4], ints[5], ints[6]};
  return record_floats(d, bf16 != 0);
}

// out[0 .. 4] = the launches since the library was loaded of
// grad_outer_tf32, of reduce_tiles with 1-, 2- and 4-float loads and of
// grad_outer, on the backward's and forward's paths and through the
// entries below alike.
extern "C" void tapnet_replay_helper_launches(long long* out) {
  for (int i = 0; i < 5; ++i) out[i] = helper_launches[i];
}

// grad_outer_tf32 (bf16 = 0) or grad_outer (bf16 = 1) alone: from the
// records rec [rows, len, C, record_floats(ints, bf16)] of that backward
// and sflag [rows, len] (nonzero: the step has an action), write the W1,
// W2 and Wq gradient columns of part [rows, P] (goff: P and the offsets;
// the other columns untouched). ints = B, N, W, D, R, C, h with h a
// multiple of 32 in 160 .. 256 (bf16: 32 .. 256) or of 64 up to 512;
// len <= 62.
extern "C" int tapnet_replay_grad_outer(const float* rec, const int* sflag,
                                        const int* ints, int rows, int len,
                                        int bf16, float* part,
                                        void* stream) {
  const Dims d{ints[0], ints[1], ints[2], ints[3], ints[4], ints[5], ints[6]};
  if (d.h < (bf16 ? 32 : 160) || d.h > MAX_H || d.h % 32 != 0 ||
      (d.h > 256 && d.h % 64 != 0) || d.C < 1 ||
      d.C > MAX_C || rows < 1 || len < 1 || len > MAX_N_STEPS)
    return (int)cudaErrorInvalidValue;
  return (int)launch_grad_outer(d, bf16 != 0, rec, sflag, rows, len, part,
                                (cudaStream_t)stream);
}

// reduce_tiles alone: out [P] = the sum over rows, in row order, of part
// [tiles, P] (float32).
extern "C" int tapnet_replay_reduce_tiles(const float* part, int tiles,
                                          int P, float* out, void* stream) {
  if (tiles < 1 || P < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_reduce_tiles(part, tiles, P, out,
                                  (cudaStream_t)stream);
}

// ptrs: flags, hms, masks, acts, se [B, T, h], ctx, statp, statm, dlp (0-8)
//       w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v,              (9-19)
//       logp_o, dse_o, dctx_o, part, grads_o, prev, logp_part,       (20-26)
//       dse_part, dctx_part, w1t^T, w2t^T, wqt^T                     (27-31)
//       bfloat16 backward, and float32 at h > 128: rec [rows, len, C,
//       rec_off(d).size] f32, sflag [rows, len] i32 zeroed (grad_outer's
//       records)                                                    (32-33)
//       bfloat16 at h > 128: w1t, w2t, wqt, wqt^T rows 0..3h as [3][h][h]
//       and w2t^T as ring slabs (ops/replay.py ring_operands)         (34-38)
//       h > 256: the blocks' scratch, tiles x chunks blocks of
//       tapnet_replay_scratch floats (f32)                             (39)
// ints: B, N, W, D, R, C, h, steps, chunks, bf16 (1: se, ctx, statp, statm
// and the weights other than v are bfloat16; 0: float; the outputs are
// float either way). Forward (bwd = 0) writes logp_o
// [B]; backward writes dse_o [T, h, B], dctx_o [h, B], part [rows, P] and
// grads_o [P], rows = tiles x chunks, through dse_part [chunks, B, T, h].
// steps = 0: the monolithic schedule (chunks ignored, prev unused); steps =
// 1: the step-grid schedule over `chunks` step chunks with prev [S, B] and,
// for more than one chunk, the partials logp_part [chunks, B] (forward) and
// dctx_part [chunks, h, B] (backward). h: a multiple of 32 up to 256, of
// 64 up to 512.
// Launches on `stream`; returns the first CUDA error of the launches.
extern "C" int tapnet_replay_logp(int bwd, void* const* p, const int* ints,
                                  float inv_s, float temperature,
                                  float inv_temp, void* stream) {
  const Dims d{ints[0], ints[1], ints[2], ints[3], ints[4], ints[5], ints[6]};
  const int steps = ints[7], chunks = ints[8], bf = ints[9];
  if (d.N > (steps ? MAX_N_STEPS : MAX_N_MONO) || d.C > MAX_C || d.B <= 0 ||
      d.h % 32 != 0 || d.h <= 0 || d.h > MAX_H ||
      (d.h > 256 && d.h % 64 != 0) ||
      (steps && (chunks < 1 || chunks > d.N)))
    return (int)cudaErrorInvalidValue;
  if ((long long)d.N * d.R * d.h * d.B >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int wc = tapnet::geo_class(d.h);
  if (wc == 2) return pick<2>(steps, bf, bwd, p, d, chunks, inv_s,
                              temperature, inv_temp, stream);
  if (wc == 1) return pick<1>(steps, bf, bwd, p, d, chunks, inv_s,
                              temperature, inv_temp, stream);
  return pick<0>(steps, bf, bwd, p, d, chunks, inv_s, temperature,
                 inv_temp, stream);
}
