// actor_select_step: one whole sampled decode step of the learned policy.
//
// Replaces: tapnet_tpu/ops/pallas_actor_step.py::actor_select_step (kernel
// body `_kernel`): accessibility from precedence bitmasks (one or two 31-bit
// limbs, N <= 62), the rolling-window cut, flags, the action mask, the
// heightmap encoder, the previous-action embedding, the query, the
// per-token dyn MLP, additive attention v.tanh(key + dyn + q), masked
// (tempered) logits + gumbel, select/place (the placement body of
// select_place.cuh, shared with K1 and K4) and log pi of the chosen action.
//
// Two modes, a template flag each: LOGITS = true is the full function,
// every token of every instance scored and the logits [A, B] written (the
// parity checks, a caller that asks for logits); LOGITS = false is the
// decode loop's mode (train/rollout.py `_rollout_record_actorfused`): no
// logits, and the token work only for the live columns below. Flags, mask,
// env state, action and log pi are written in both.
//
// Live columns (exact). A column is a pair (instance, token t) whose mask
// allows t in some container (the mask is per (block, rotation), the same
// over containers), which implies that the instance has a valid action.
// Every other action scores -1e9 masked: exp(-1e9 - max) is exactly 0 in
// f32, so it adds nothing to the softmax, and it never wins the gumbel
// argmax while any action is valid. So the action, the placement, flags,
// mask and env state are those of the full formula, and log pi is its sum
// less exact zeros: the max and the sum run over the instance's valid
// actions in action order. An instance with no valid action gets act = -1
// and log pi 0 and has no column; a tile of 32 without a column skips the
// encoder, the query and the token work whole.
//
// Bound: the f32 multiply-adds. Per acting instance at hidden h, W*D cells
// and C containers the encoder and query are C*(h*(W*D+2) + h*h + h*(3h+8))
// (68,864 at 2d-rolling and h = 128); per live column the dyn MLP and the
// attention are 32*8 + 32*h + C*h (4,480). At 2d-rolling, batch 4096, a
// step has ~2,900 acting instances and ~19,000 live columns of 409,600
// (instance, token) pairs: ~0.63 GFLOP, 9 us at 67 TFLOP/s, against
// 4.3 GFLOP over all tokens. The bytes it must move (the env state and
// graphs, the static token features, the keys of the live columns, the
// gumbel of the valid actions) are 41 MB there (12 us at 3.35 TB/s) and
// 12 MB at 2d-basic, where the operations bound it (10 us).
//
// Design, float32 (SIMT, f32 fused multiply-adds throughout; no TF32, no
// approximate intrinsics); the bfloat16 instantiations share it but for
// the products (below):
// - one block per tile of TB = 32 instances (lane = instance in the
//   encoder and query), NWARP = 16 warps.
// - phase 0: every warp loads a share of the packed rows, the precedence
//   limbs and the fit planes into shared memory (eight loads in flight per
//   thread) and forms the accessibility and fit bits of its share of the
//   blocks, OR-ed into the tile's bit words (64-bit in the WIDE
//   instantiation); warp 0 cuts the window (the first `window` accessible
//   blocks in index order: the lowest set bits of the accessible word),
//   forms the token bits (the two rotations' words interleaved), the count
//   summary and the list of the tile's columns in (instance, token) order;
//   then every warp writes its share of flags and mask.
// - phase 1, per container: the encoder feats -> e1 -> enc and the query
//   q_c = Wq [enc, ctx, E[:, prev+1], dsum] + bq as register tiles over the
//   tile's 32 instances: 64-column slices of W1, W2, Wq (transposed copies
//   made once per rollout) are copied to shared memory, the next slice's
//   loads in flight meanwhile, and read as broadcasts, a thread owning h/16
//   rows of one instance (one load of the instance vector feeds h/16
//   multiply-adds).
// - phase 2: the token work over groups of G = 64 columns that may mix
//   instances: x8 [8][G] -> h1 = relu(W8 x8 + b8) [32][G] -> dyn = Wp h1
//   [h][G] as register tiles (a warp owns 4 columns, a lane the rows
//   j = lane + 32 r: one shared load of Wp feeds 4 columns, one float4 of
//   h1 feeds 4 rows); the keys of a column are one row of a [B, T, h] copy
//   of se (a warp reads it coalesced); a column's C scores are warp sums.
//   A group costs 2 barriers where a per-token loop costs 4 per token.
//   Wp^T [32][h], W8, b8 and v are staged once per block.
// - phase 3: every warp forms its share of the masked, tempered scores
//   and of the selection scores (+ gumbel, read only for valid actions)
//   with its partial max and argmax, and loads the tile's heightmaps and
//   dims into shared memory; warp 0 joins the partials per instance (the
//   lowest action attaining the max, as select_place's scan) and sums log
//   pi over the instance's columns in action order; every warp then walks
//   a share of the candidate offsets (select_place.cuh `place_part`: the
//   candidates are totally ordered, so the warps' winners join into the
//   winner over all offsets), warp 0 joins them (`place_gather`,
//   `place_resolve`), and every warp writes a share of the new state rows
//   (packed, heightmap, placements), as K1 and K4 do. `python -m
//   tapnet_torch.profile_phases` gives every phase's share of a launch.
// - 128 registers, no spills (ptxas); shared memory 142,680 B at 2d-basic
//   and 178,552 B at 2d-rolling (h = 128; bfloat16: 172,632 B and
//   196,472 B): one block of 16 warps per SM, which the launch bound
//   tells ptxas (without it, ptxas may trade registers for a second block
//   that can never be resident, and spill).
//   The wrapper refuses a plan above the 227 KB a block may hold; h must
//   be a multiple of 32 up to 256, of 64 up to 512 (WX, below).
//
// Hidden widths above 128 (WH, h = 160..256). The tile stays 32
// instances and phases 0 and 3, the column list and the placement are the
// ones above; the head's products run once over the whole tile, so that a
// block streams each weight once per container and step:
// - the query's step-invariant part is made once per rollout by
//   `query_parts_kernel` (below): Wq_ctx ctx [h][B] and Wq_emb E [h][A+1]
//   (the ctx and previous-action columns of Wq against the mean static key
//   and the embedding table) on the tensor cores: in bfloat16 f32 sums of
//   exact products, in float32 3xTF32 sums (each product to ~2^-22). A step
//   streams only W1, W2 and Wq's enc and dsum columns (Wq', K = h + 8)
//   and starts the query's accumulators at Wq_ctx ctx + Wq_emb E[:, prev
//   + 1], then adds Wq' [enc, dsum] and, as before, the bias: about half
//   of the weights of the full qin (K = 3h + 8), and qin shrinks to h + 8
//   rows, which is what lets one pass of 32 instances fit the plan.
// - the weights arrive through the weight ring (ring_bf16.cuh): 16 KB
//   slabs (h rows x 32 bfloat16 columns, or 16 float32 columns: W1's as
//   16 rows of W1^T, W2's and Wq''s in A-fragment order), laid out once
//   per rollout by ops/actor_step.py `ring_slabs`, one bulk copy a slab
//   into 3 stages with an mbarrier each: no block barrier per slab, and a
//   container's chain W1, W2, Wq' finds the next matrix's first slabs in
//   flight.
// - float32: W1 feats SIMT (it decides e1's ReLU gates): a thread owns RW
//   = h / 16 rows (10..16) of one instance (lane = instance, warp = row
//   group), one load of the instance's x feeding RW multiply-adds with the
//   weights read as float4 / float2 broadcasts; W2 e1 and Wq' [enc, dsum]
//   as 3xTF32 mma.sync (mma_tf32.cuh), warp wy < h / 16 owning a row tile
//   and all four column tiles, its A fragments two 16-byte loads a lane
//   from slabs laid out in fragment order: the SIMT form issued ~190
//   cycles a k-row (two shared loads per four multiply-adds), 3x the
//   ring's stream (PERF.md §6).
// - bfloat16: warp wy < h / 16 owns the row tile 16 wy .. + 15 and all four
//   column tiles of 8 instances, so each A fragment (ldmatrix from the
//   swizzled slab) feeds four mma; the B operands are bfloat16 copies
//   [K16][32] (`xs32_at`, chunks swizzled) read by ldmatrix .trans. feats,
//   e1 and [enc, dsum] live only as those copies (each value is rounded to
//   bfloat16 where the JAX kernel casts, so the copy is exact).
// - the token groups run over the tile's columns in groups of G = 32 (a
//   warp 2 columns, a lane 8 rows), q [C][h][33] holding the whole tile.
// Every sum keeps one owner and one order, so two launches are
// bit-identical and both modes give an acting instance the same scores.
// At h <= 128 the instantiations are the ones above.
//
// Hidden widths above 256 (WX, h = 320..512, a multiple of 64; the
// wrapper's callers pad other widths with zeros, ops/actor_step.py
// `kernel_width`). The WH design, with three changes so that the plan
// fits a block (at h = 512 the WH plan would take 376 KB in float32):
// - each product runs over its weight's two row halves of HR = h / 2 rows
//   in turn, each half a WH product of HR rows (warps wy < HR / 16 own its
//   row tiles): `ring_slabs` lays each matrix out as its two halves' slabs
//   one after the other, so a slab is HR x 32 bfloat16 (16 KB at h = 512)
//   and a container's chain streams 2 (n1 + n2 + n3) of them;
// - the C queries q [C][h][LD] (and, in float32, the encoder view X and
//   e1) live in a scratch of the block's own in device memory (`scr`,
//   `wx_scratch` floats a block), read back through L1 / L2; the bfloat16
//   copies that ldmatrix reads stay in shared memory;
// - the token groups are G = 16 columns, one a warp, MAXR = 16 rows a
//   lane (geo.cuh);
// - float32: W2 e1 and Wq' as 3xTF32 with each slab's sums in an
//   accumulator of their own, added into the sum in f32 (ring_mm_tf32's
//   CH), and `query_parts_kernel` alike for each 16 columns of K: one
//   accumulator over K = 512 (192 mma) put K2's logits 1.35e-5 from the
//   plain version's, past the 1e-5 they are held to (mma_tf32.cuh).
// A simple design that is right; its speed is work for later (PERF.md).
//
// Compute dtype (the JAX kernel's static `dtype`): the element type E of
// the float operands, float or __nv_bfloat16 (v, the gumbel, t/N, the
// logits and log pi are float in both). The bfloat16 instantiations read
// bfloat16 from device memory (half the bytes of se, the static features
// and the weights) and round to bfloat16 (to nearest even, `rnd`) exactly
// where the JAX kernel casts to its compute dtype: the count summary and
// t/N, the normalised heightmap and its mean, each Dense product before
// and after its bias, dyn, se + dyn, + q, tanh and each score. Shared
// memory holds the activations as float (the SIMT epilogues read them);
// in float every `rnd` is the identity and the code is the float kernel's.
//
// Design, bfloat16 (TC = the E = __nv_bfloat16 instantiations): every
// product of the head runs on the tensor cores, mma.sync.m16n8k16 bf16 x
// bf16 -> f32 (the JAX kernel's `preferred_element_type=f32` dots), one
// pass each: both factors are exact bfloat16 values (the weights; feats,
// e1, qin and h1, rounded by `rnd` where JAX casts), so each product is
// exact and the sums are f32.
// - encoder and query (W1 feats, W2 e1, Wq qin: [h][K] . [K][32 lanes]):
//   mv_mma (mma_bf16.cuh, shared with the replay) streams the row-major
//   weights (the [h][K] operands themselves; the transposed copies are
//   not read) through the token view in slabs of 64 columns, bfloat16 rows
//   padded by 8 so that ldmatrix meets no bank conflict, copied with
//   16-byte cp.async (element loads where the rows are not 16-byte
//   aligned: W1 unless W*D + 2 is a multiple of 8), double-buffered; K is
//   padded to 16 with zeros. A warp owns one 16-row tile and 16 lanes.
//   The B operand (feats, e1, qin) is first copied as bfloat16 pairs into
//   rows of 40 words, so that a fragment is two 32-bit loads on 32 banks:
//   read from the [k][33] floats themselves (four loads, lanes up to four
//   ways in one bank, by the eight warps of a column half alike) the
//   fragments' shared-memory traffic held the products back (PERF.md §6);
//   a ring of three slabs in flight in place of two changed nothing.
// - the token groups: dyn = Wp h1 (K = 32) with Wp staged once per block
//   as bfloat16 rows of WPS = 40 and h1 rows padded to G + 4; the group's
//   dyn goes through a [G][h+4] float array, read back per column by the
//   SIMT epilogue, so the tanh / v sums keep the float32 order (a lane the
//   rows lane + 32 r, then the warp sum). W8 x8 (K = 8) stays SIMT.
// - order: every accumulator has one owner and one order of k-steps, and a
//   column's or a lane's products do not depend on which other columns
//   share its tile: two launches are bit-identical, and both modes give
//   an acting instance the same scores. The tensor core adds in its own
//   order, so a score can land one bfloat16 ulp from the plain version's.
// - shared memory: the float plan less the float Wp^T plus Wp as bfloat16,
//   the h1 padding and the dyn array in the token view, which also holds
//   the two weight slabs (72 h floats) and the B pairs (`xb_words`).
//
// The SIMT device code of phases 1-2 follows replay.cu's forward (K5f) and
// is a copy, not a shared header: K5 stays bit-identical to itself. The
// tensor-core pieces are mma_bf16.cuh's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "geo.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "ring_bf16.cuh"
#include "select_place.cuh"

namespace {

constexpr int TB = 32;      // instances per block
constexpr int LD = TB + 1;  // padded row stride of [feature][lane] arrays
constexpr int NWARP = 16;   // warps per block
constexpr int NT = TB * NWARP;
constexpr int MAX_H = 512;  // hidden: a multiple of 32 up to 256, of 64 above
constexpr int WPS = 40;     // tc: bfloat16 row stride of Wp [h][32]
constexpr int MAX_C = 4;        // containers
constexpr int MAX_N = 62;       // blocks: two 31-bit precedence limbs
constexpr int TOKW = 4;         // 32-bit words of token bits: T <= 128
constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

using tapnet::Geo;  // the head's passes (geo.cuh)
static_assert(TB == tapnet::GEO_TB && NWARP == tapnet::GEO_NWARP,
              "geo.cuh's block geometry");

using bf16 = __nv_bfloat16;
using tapnet::frag_au;
using tapnet::frag_b;
using tapnet::mma;
using tapnet::mv_mma;
static_assert(NT == tapnet::MMA_NT && LD == tapnet::MMA_LD,
              "mma_bf16.cuh's block geometry");

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }

// a read-only load as float
template <class E>
__device__ __forceinline__ float ldg(const E* p) {
  return f32(__ldg(p));
}

// x rounded to E and back: the JAX kernel's cast to its compute dtype
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
  // WH: Wq_ctx ctx [h][B] and Wq_emb E [h][A+1] (once per rollout), and
  // the ring slabs of W1, W2, Wq' (`ring_slabs`; float32 slabs as pairs)
  const float *qctx, *qemb;
  const bf16* slabs;
  float* scr;  // WX: the blocks' scratch, `wx_scratch` floats each
};

template <class E>
struct ActorIO {
  const float* tf;     // [1]
  const int* prev;     // [B]
  const int* upm;      // [L*N, B] column bitmasks of the up graph, L limbs
  const int* rotm;     // [L*N, B]
  const int* fits;     // [R*N, B]
  const float* g;      // [A, B] gumbel (zeros = greedy)
  const E* se;         // [B, T, h] static keys, one row per column
  const E* ctx;        // [h, B] mean static key
  const E* statp;      // [4, T, B] static token features
  const E* statm;      // [4, B] their mean over tokens
  int* flags_o;        // [N, B]
  int* mask_o;         // [A, B]
  float* logits_o;     // [A, B] (LOGITS only)
  float* logp_o;       // [B]
};

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

// 32-bit words of the tensor-core plan's B operand as bfloat16 pairs (h <=
// 128): the longest k of the encoder/query products (W*D + 2, 3h + 8)
// padded to 16
__host__ __device__ inline int xb_words(int WD, int h) {
  const int k = WD + 2 > 3 * h + 8 ? WD + 2 : 3 * h + 8;
  return (k + 15) / 16 * 8 * tapnet::MMA_XS;
}

// Shared-memory plan, in floats from the base (every region 16-byte
// aligned); the ints follow the floats. `tc`: the tensor-core plan of the
// bfloat16 instantiations (Wp itself as bfloat16 [h][WPS] in place of the
// float Wp^T [32][h]; h1 rows padded to G + 4 floats so that a B
// fragment's column reads hit 32 banks; the group's dyn [G][h+4]; the
// encoder/query weights as two bfloat16 slabs of h (KSL + 8) / 2 floats
// each, and the product's B operand as bfloat16 pairs, `xb_words`). WH:
// `layout_wh`.
struct Lay {
  int ws, w8, b8, v, q, sc, enc, tok, bar, floats;
};

template <int WC>
__host__ __device__ inline int h1_stride(bool tc) {
  return tc ? Geo<WC>::G + 4 : Geo<WC>::G;
}

// rows of the WH encoder view X: feats [WD+2], then [enc, dsum] [h+8]
__host__ __device__ inline int wh_rows(int WD, int h) {
  return WD + 2 > h + 8 ? WD + 2 : h + 8;
}

// The WH plan (the design note): Wp, W8, b8, v as below; q [C][h][LD]; the
// scores; the encoder view X [wh_rows][LD] and e1 [h][LD] as float or, tc,
// as bfloat16 copies [rows16][32] (`xs32_at`); then the token view, the
// weight ring's stages or phase 0's and 3's rows; then the ring's
// mbarriers and release counts and each instance's column of the
// query's embedding part (prev + 1). WX (WC = 2): q and the float X and
// e1 in the block's scratch (`wx_scratch`), the ring's stages of HR = h /
// 2 rows.
template <int WC>
__host__ __device__ inline Lay layout_wh(int N, int R, int C, int WD, int h,
                                         bool tc) {
  using Q = Geo<WC>;
  constexpr int G = Q::G;
  const int T = N * R, A = T * C, L = (N + 30) / 31, XR = wh_rows(WD, h);
  Lay y;
  int o = 0;
  y.ws = o;  o += tc ? up4(h * WPS / 2) : up4(32 * h);
  y.w8 = o;  o += 32 * 8;
  y.b8 = o;  o += 32;
  y.v = o;   o += up4(h);
  y.q = o;   o += Q::WX ? 0 : up4(C * h * LD);
  y.sc = o;  o += A * TB;
  y.enc = o; o += tc ? ((XR + 15) / 16 * 16 + h) * 16
                     : Q::WX ? 0 : up4((XR + h) * LD);
  const int tok = 8 * G + 32 * h1_stride<WC>(tc) + (tc ? G * (h + 4) : 0);
  const int ring = tapnet::RING_S * (h / Q::NH) * tapnet::RING_K / 2;
  const int rows0 = (N + 2 * L * N + R * N) * TB;
  const int rows3 = (13 + 8 * NWARP + C * WD + 3 * N) * TB;
  const int a = tok > ring ? tok : ring, r = rows0 > rows3 ? rows0 : rows3;
  y.tok = o; o += a > r ? a : r;
  y.bar = o; o += up4(3 * tapnet::RING_S + TB);
  y.floats = o;
  return y;
}

// WX: the floats of a block's scratch in device memory, q [C][h][LD], then
// in float32 X [wh_rows][LD] and e1 [h][LD] (the bfloat16 instantiations,
// tc, keep their copies in shared memory)
__host__ __device__ inline int wx_scratch(int C, int WD, int h, bool tc) {
  return up4(C * h * LD) + (tc ? 0 : up4((wh_rows(WD, h) + h) * LD));
}

template <int WC>
__host__ __device__ inline Lay layout(int N, int R, int C, int WD, int h,
                                      bool tc) {
  if constexpr (WC > 0) return layout_wh<WC>(N, R, C, WD, h, tc);
  using Q = Geo<0>;
  constexpr int LP = Q::LP, G = Q::G;
  const int T = N * R, A = T * C, FQ = 3 * h + 8, L = (N + 30) / 31;
  Lay y;
  int o = 0;
  y.ws = o;  o += tc ? up4(h * WPS / 2) : up4(32 * h);  // Wp^T / Wp
  y.w8 = o;  o += 32 * 8;              // W8 [32][8]
  y.b8 = o;  o += 32;
  y.v = o;   o += up4(h);
  y.q = o;   o += up4(C * h * LP);     // q [C][h][LP]
  y.sc = o;  o += A * TB;              // scores, then masked [A][TB]
  // encoder view: feats [WD+2][LP], e1 [h][LP], qin [3h+8][LP]
  y.enc = o; o += up4((WD + 2 + h + FQ) * LP);
  // token view: x8 [8][G], h1 [32][GS] (tc: and dyn [G][h+4]); or the
  // staged weight slices (float [KS][h], tc: bfloat16 slabs); or phase 0's
  // rows (packed, limbs, fits) as ints; or phase 3's decisions [13][TB],
  // the warps' partial results [8][NWARP][TB] and rows (heightmaps
  // [C*W*D], dims [3N]) as ints
  const int tok = 8 * G + 32 * h1_stride<0>(tc) + (tc ? G * (h + 4) : 0);
  const int stage = tc ? h * (Q::KSL + 8) + xb_words(WD, h)  // mv_mma
                       : Q::KS * h;                            // mv_tiled
  const int rows0 = (N + 2 * L * N + R * N) * TB;
  const int rows3 = (13 + 8 * NWARP + C * WD + 3 * N) * TB;
  const int big = tok > stage ? tok : stage;
  const int rows = rows0 > rows3 ? rows0 : rows3;
  y.tok = o; o += big > rows ? big : rows;
  y.floats = o;
  return y;
}

// ints behind the floats: 6 bit words per lane (packed, acc0, accr, win
// and the fits of the two rotations; room for 64 bits), TOKW words of
// token bits per lane, the column offsets [TB+1], a flag and the column
// list [TB*T].
__host__ __device__ inline int n_ints(int N, int R) {
  return 12 * TB + TOKW * TB + TB + 1 + 1 + TB * N * R;
}

// The float32 products at h <= 128 (the bfloat16 instantiations run
// mv_mma; WH the ring products below).
// out[j] = sum_k W[j, k] x[k][n] for every row j < h and instance n (warp
// vw owns the RW = h/NWARP rows vw*RW ..), W given transposed, WT
// [cols][h]: slices of KS of its rows are copied to shared memory S as
// they lie (16-byte loads, the next slice's loads in flight while this one
// is multiplied) and read as float4 (h = 64, 128) or float2 broadcasts, so
// one load of x feeds RW multiply-adds. emit(j, n, acc) stores row j. The
// caller follows with a barrier before S or the outputs are reused.
template <class Emit>
__device__ void mv_tiled(const float* __restrict__ WT, int h, int cols,
                         const float* x, float* S, int n, int vw, int tid,
                         Emit emit) {
  using Q = Geo<false>;
  constexpr int PV = 4;                      // floats per 16 bytes
  constexpr int KS = Q::KS, LP = Q::LP;
  constexpr int NV = KS * 32 * Q::MAXR / PV / NT;  // a slice of KS * h
  const int RW = h / Q::NVW;  // 2 (h = 32) .. 8 (h = 128)
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const uint4* src = reinterpret_cast<const uint4*>(WT);
  uint4 v[NV];
  auto load = [&](int k0) {
    const int nv = min(KS, cols - k0) * h / PV;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int e = tid + u * NT;
      if (e < nv) v[u] = __ldg(src + (size_t)k0 * h / PV + e);
    }
  };
  load(0);
  for (int k0 = 0; k0 < cols; k0 += KS) {
    const int nk = min(KS, cols - k0);
    __syncthreads();  // S is free
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int e = tid + u * NT;
      if (e < nk * h / PV)
        *reinterpret_cast<uint4*>(S + e * PV) = v[u];
    }
    __syncthreads();
    if (k0 + KS < cols) load(k0 + KS);
    if (RW % 4 == 0) {
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        const float xv = x[(k0 + kk) * LP + n];
        const float* sw = S + kk * h + vw * RW;
#pragma unroll
        for (int r = 0; r < 8; r += 4) {
          if (r < RW) {
            const float4 w4 = *reinterpret_cast<const float4*>(sw + r);
            acc[r] = fmaf(w4.x, xv, acc[r]);
            acc[r + 1] = fmaf(w4.y, xv, acc[r + 1]);
            acc[r + 2] = fmaf(w4.z, xv, acc[r + 2]);
            acc[r + 3] = fmaf(w4.w, xv, acc[r + 3]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        const float xv = x[(k0 + kk) * LP + n];
        const float* sw = S + kk * h + vw * RW;
#pragma unroll
        for (int r = 0; r < 8; r += 2) {
          if (r < RW) {
            const float2 w2 = *reinterpret_cast<const float2*>(sw + r);
            acc[r] = fmaf(w2.x, xv, acc[r]);
            acc[r + 1] = fmaf(w2.y, xv, acc[r + 1]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (r < RW) emit(vw * RW + r, n, acc[r]);
}

// ---- the WH products on the weight ring (the design note)
using tapnet::Chain;
using tapnet::Ring;
using tapnet::RING_K;
constexpr int KR = RING_K / 2;  // float32: rows of W^T in a slab

// The bfloat16 copy [K16][32] of a B operand (the tile's 32 instances):
// row k's four 16-byte chunks swizzled (chunk c at c ^ ((k >> 1) & 3)), so
// that the 8 rows of an ldmatrix matrix (row stride 64 bytes) fall in 8
// different bank groups. The element (k, n):
__device__ __forceinline__ int xs32_at(int k, int n) {
  return 32 * k + 8 * ((n >> 3) ^ ((k >> 1) & 3)) + (n & 7);
}

// out[j][n] = init(j, n) + sum_k W[j, k] x[k][n], j < h, n < 32: float32,
// slabs a .. of chain c hold W^T [K][h] in KR rows each; x [K][LD]. Warp wy
// owns the rows wy RW .. + RW - 1 (RW = h / 16), lane n the instance; every
// k in order, one fused multiply-add each. emit(j, n, acc).
template <class Init, class Emit>
__device__ void ring_mv_f32(const Ring& rg, const Chain& c, int a, int K,
                            int h, const float* x, int lane, int wy,
                            Init init, Emit emit) {
  const int RW = h / NWARP, j0 = wy * RW;
  float acc[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r] = r < RW ? init(j0 + r, lane) : 0.f;
  tapnet::ring_take(rg, c, a, (K + KR - 1) / KR, NWARP, wy, lane,
                    [&](const unsigned short* slab, int s) {
    const float* S = reinterpret_cast<const float*>(slab) + j0;
    const float* xk = x + s * KR * LD + lane;
    const int nk = min(KR, K - s * KR);
    if (RW % 4 == 0) {  // h = 192, 256
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        const float xv = xk[kk * LD];
#pragma unroll
        for (int r = 0; r < 16; r += 4) {
          if (r < RW) {
            const float4 w = *reinterpret_cast<const float4*>(S + kk * h + r);
            acc[r] = fmaf(w.x, xv, acc[r]);
            acc[r + 1] = fmaf(w.y, xv, acc[r + 1]);
            acc[r + 2] = fmaf(w.z, xv, acc[r + 2]);
            acc[r + 3] = fmaf(w.w, xv, acc[r + 3]);
          }
        }
      }
    } else {  // h = 160, 224: RW = 10, 14
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        const float xv = xk[kk * LD];
#pragma unroll
        for (int r = 0; r < 16; r += 2) {
          if (r < RW) {
            const float2 w = *reinterpret_cast<const float2*>(S + kk * h + r);
            acc[r] = fmaf(w.x, xv, acc[r]);
            acc[r + 1] = fmaf(w.y, xv, acc[r + 1]);
          }
        }
      }
    }
  });
#pragma unroll
  for (int r = 0; r < 16; ++r)
    if (r < RW) emit(j0 + r, lane, acc[r]);
}

// The same as 3xTF32 on the tensor cores (mma_tf32.cuh: each f32 operand
// split into tf32 hi + lo, three passes into an f32 accumulator), for W2
// and Wq' in float32: slabs a .. of chain c hold W [h][K] in 16 columns
// each, laid out in the A fragments' order (`ring_slabs`): for the row tile
// m and lane 4 g + t, the columns 4 t .. 4 t + 3 of row 16 m + g (u), then
// of row 16 m + 8 + g (v), 16 bytes each, so a warp's A fragments of a slab
// are two conflict-free 16-byte loads a lane. The two k-steps of a slab
// take its columns in the order 4 t, 4 t + 1 (the fragment's columns t, t
// + 4) and 4 t + 2, 4 t + 3, x's rows alike (mm_tf32's order). Warp wy <
// h / 16 owns the row tile 16 wy .. + 15 and the four column tiles.
// CH (WX): each slab's products go into an accumulator of their own, from
// zero, that is added into the sum in f32 after the slab (`mma_tf32.cuh`).
template <bool CH, class Init, class Emit>
__device__ void ring_mm_tf32(const Ring& rg, const Chain& c, int a, int K,
                             int h, const float* x, int lane, int wy,
                             Init init, Emit emit) {
  const int nw = h / 16, g = lane >> 2, t = lane & 3, m0 = 16 * wy;
  if (wy >= nw) return;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int n = 8 * u + 2 * t;
    acc[u][0] = init(m0 + g, n);
    acc[u][1] = init(m0 + g, n + 1);
    acc[u][2] = init(m0 + g + 8, n);
    acc[u][3] = init(m0 + g + 8, n + 1);
  }
  tapnet::ring_take(rg, c, a, (K + 15) / 16, nw, wy, lane,
                    [&](const unsigned short* slab, int s) {
    const float* S = reinterpret_cast<const float*>(slab) + 256 * wy + 4 * lane;
    const float4 u = *reinterpret_cast<const float4*>(S);
    const float4 v = *reinterpret_cast<const float4*>(S + 128);
    float p[4][4] = {};  // CH: the slab's sums
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      unsigned ah[4], al[4];
      tapnet::split_tf32(st ? u.z : u.x, ah[0], al[0]);
      tapnet::split_tf32(st ? v.z : v.x, ah[1], al[1]);
      tapnet::split_tf32(st ? u.w : u.y, ah[2], al[2]);
      tapnet::split_tf32(st ? v.w : v.y, ah[3], al[3]);
      const int k = 16 * s + 4 * t + 2 * st;  // x's rows k and k + 1
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned bh[2], bl[2];
        const float* xp = x + k * LD + 8 * q + g;
        tapnet::split_tf32(k < K ? xp[0] : 0.f, bh[0], bl[0]);
        tapnet::split_tf32(k + 1 < K ? xp[LD] : 0.f, bh[1], bl[1]);
        tapnet::mma3(CH ? p[q] : acc[q], ah, al, bh, bl);
      }
    }
    if constexpr (CH) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] += p[q][e];
    }
  });
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int n = 8 * u + 2 * t;
    emit(m0 + g, n, acc[u][0]);
    emit(m0 + g, n + 1, acc[u][1]);
    emit(m0 + g + 8, n, acc[u][2]);
    emit(m0 + g + 8, n + 1, acc[u][3]);
  }
}

// The same in bfloat16 on the tensor cores: slabs a .. of chain c hold W
// [h][K] (ring_bf16.cuh's swizzled slabs of RING_K columns), xs the copy
// [K16][32] of x (rows K .. K16 zero). Warp wy < h / 16 owns the row tile
// 16 wy .. + 15 and the four column tiles: per 16 columns of W one A
// fragment, two ldmatrix .trans of B (column tiles 0-1, 2-3), four mma.
template <class Init, class Emit>
__device__ void ring_mv_tc(const Ring& rg, const Chain& c, int a, int K,
                           int h, const unsigned short* xs, int lane, int wy,
                           Init init, Emit emit) {
  const int nw = h / 16, g = lane >> 2, t = lane & 3, m0 = 16 * wy;
  if (wy >= nw) return;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int n = 8 * u + 2 * t;
    acc[u][0] = init(m0 + g, n);
    acc[u][1] = init(m0 + g, n + 1);
    acc[u][2] = init(m0 + g + 8, n);
    acc[u][3] = init(m0 + g + 8, n + 1);
  }
  tapnet::ring_take(rg, c, a, (K + RING_K - 1) / RING_K, nw, wy, lane,
                    [&](const unsigned short* slab, int s) {
#pragma unroll
    for (int kc = 0; kc < RING_K / 16; ++kc) {
      const int k0 = s * RING_K + 16 * kc;
      if (k0 < K) {
        unsigned av[4], b01[4], b23[4];
        tapnet::ldsm_slab(av, slab, m0, kc, lane);
        const int k = k0 + (lane & 15), c0 = lane >> 4;
        tapnet::ldsm_t(b01, xs + 32 * k + 8 * (c0 ^ ((k >> 1) & 3)));
        tapnet::ldsm_t(b23, xs + 32 * k + 8 * ((2 + c0) ^ ((k >> 1) & 3)));
        const unsigned b0[2] = {b01[0], b01[1]}, b1[2] = {b01[2], b01[3]};
        const unsigned b2[2] = {b23[0], b23[1]}, b3[2] = {b23[2], b23[3]};
        mma(acc[0], av, b0);
        mma(acc[1], av, b1);
        mma(acc[2], av, b2);
        mma(acc[3], av, b3);
      }
    }
  });
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int n = 8 * u + 2 * t;
    emit(m0 + g, n, acc[u][0]);
    emit(m0 + g, n + 1, acc[u][1]);
    emit(m0 + g + 8, n, acc[u][2]);
    emit(m0 + g + 8, n + 1, acc[u][3]);
  }
}

__device__ inline float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ int popw(unsigned x) { return __popc(x); }
__device__ __forceinline__ int popw(unsigned long long x) {
  return __popcll(x);
}

// a / C for an action index a < 2^15 and C <= 4
__device__ __forceinline__ int tok_of(int a, int C) {
  return C == 1 ? a
       : C == 2 ? a >> 1
       : C == 4 ? a >> 2
                : (int)(((unsigned)a * 43691u) >> 17);
}

// The low 16 bits of x at the even bit positions of the result.
__device__ __forceinline__ unsigned spread16(unsigned x) {
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

// Column bitmask of block i over the unpacked-set word, from the staged
// rows [L*N][TB]: one 31-bit limb, or two joined into 62 bits (the layout
// of ops/actor_step.py precedence_bitmasks).
template <class Word>
__device__ __forceinline__ Word column(const int* m, int i, int N, int lane) {
  Word v = (unsigned)m[i * TB + lane];
  if (sizeof(Word) == 8 && N > 31)
    v |= (Word)(unsigned)m[(N + i) * TB + lane] << 31;
  return v;
}

using tapnet::PlacePart;

// Phase marks for `python -m tapnet_torch.profile_phases`: K2_MARK(k)
// ends phase k (K2_PHASES there names them). They expand to nothing here;
// the profiler's copy defines them as clock reads.
#ifndef K2_MARK
#define K2_MARK(k)
#endif

template <bool MCS, bool WIDE, bool LOGITS, int WC, class E>
__global__ void __launch_bounds__(NT, 1)
actor_step_kernel(tapnet::EnvCfg c, tapnet::StepIO io, ActorIO<E> ai,
                  HeadW<E> hw, int B, int h, float inv_s, float temperature,
                  int window) {
  using Word = std::conditional_t<WIDE, unsigned long long, unsigned>;
  // bfloat16: the products on the tensor cores (the design note)
  constexpr bool TC = std::is_same_v<E, bf16>;
  // the width class (geo.cuh): WH above hidden 128, WX above 256
  constexpr bool WH = WC > 0, WX = WC > 1;
  // the token groups (Geo): G columns, CPW a warp, MAXR rows a lane
  using Q = Geo<WC>;
  constexpr int CPW = Q::CPW, G = Q::G, MAXR = Q::MAXR;
  // the products run over the tile's 32 instances at every h
  constexpr int TP = TB, LP = LD, NVW = NWARP;
  extern __shared__ __align__(16) float smem[];
  const int N = c.N, R = c.R, C = c.C, WD = c.W * c.D;
  const int T = N * R, A = T * C, FQ = 3 * h + 8, NL = (N + 30) / 31;
  const int RPL = h / 32, GS = h1_stride<WC>(TC), HP = h + 4;
  const int lane = threadIdx.x, wy = threadIdx.y, tid = wy * TB + lane;
  const int g8 = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int vl = lane, vw = wy;  // an instance and a row group (mv_tiled)
  const int tile0 = blockIdx.x * TB;
  const int b = tile0 + lane;
  const bool active = b < B;
  const int bb = active ? b : 0;  // clamped index for loads
  const Lay L = layout<WC>(N, R, C, WD, h, TC);
  // WX: this block's scratch in device memory (q, then the float X and e1)
  float* const scr =
      WX ? hw.scr + (size_t)blockIdx.x * wx_scratch(C, WD, h, TC) : nullptr;

  float* Ws = smem + L.ws;  // Ws[k*h + j] = Wp[j, k]
  // tc: Wp [h][32] as bfloat16 rows of WPS (the A operand of dyn)
  unsigned short* wps = reinterpret_cast<unsigned short*>(Ws);
  float* W8s = smem + L.w8;
  float* b8s = smem + L.b8;
  float* vs = smem + L.v;
  float* qs = WX ? scr : smem + L.q;  // [C][h][LP]
  float* sc = smem + L.sc;    // [A][TB]
  // feats [WD+2][LP], e1 [h][LP], qin [3h+8][LP]: enc, ctx, prev, dsum
  float* feats = smem + L.enc;
  float* e1 = feats + (WD + 2) * LP;
  float* qin = e1 + h * LP;
  float* stg = smem + L.tok;          // staged weight slices
  // tc: the same as bfloat16 (mv_mma's double-buffered slabs), then the
  // product's B operand as bfloat16 pairs
  unsigned short* stgb = reinterpret_cast<unsigned short*>(stg);
  unsigned* xbp = reinterpret_cast<unsigned*>(stg + h * (Q::KSL + 8));
  float* x8 = smem + L.tok;           // [8][G]
  float* h1 = x8 + 8 * G;             // [32][GS]
  float* DD = h1 + 32 * GS;           // tc: the group's dyn [G][HP]
  int* ib = (int*)(smem + L.floats);
  // [6][TB] words: packed, acc0, accr, win, fits of rotation 0 and 1
  Word* wb = reinterpret_cast<Word*>(ib);
  unsigned* tw = (unsigned*)(ib + 12 * TB);  // [TOKW][TB] token bits
  int* off = (int*)(tw + TOKW * TB);        // [TB+1] column offsets
  int* flag = off + TB + 1;                 // the tile has a column
  int* cols = flag + 1;                     // [TB*T]: t << 5 | lane
  // WH: the encoder view X [wh_rows][LD] (feats, then [enc, dsum]) and e1
  // [h][LD]; tc: their bfloat16 copies [rows16][32] only; the weight ring
  // (stages in the token view) and each instance's query column prev + 1
  const int XR = wh_rows(WD, h), XR16 = (XR + 15) & ~15;
  float* X = WX && !TC ? scr + up4(C * h * LD) : smem + L.enc;
  float* e1w = X + XR * LD;
  unsigned short* Xs = reinterpret_cast<unsigned short*>(smem + L.enc);
  unsigned short* E1s = Xs + XR16 * 32;
  int* qcol = nullptr;
  Ring ring{};
  if constexpr (WH) {
    constexpr int NS = tapnet::RING_S;
    qcol = reinterpret_cast<int*>(smem + L.bar) + 3 * NS;
    ring = Ring{stgb, reinterpret_cast<unsigned long long*>(smem + L.bar),
                reinterpret_cast<int*>(smem + L.bar + 2 * NS),
                h / Q::NH * RING_K, 0u};
    if (tid == 0) tapnet::ring_init(ring);
  }

  const float tf = ai.tf[0];

  // ---- phase 0: stage the block's rows; every warp the bit words of its
  // blocks; warp 0 the window, the token bits, the count summary and the
  // column list
  {
    int* pkS = reinterpret_cast<int*>(stg);  // [N][TB] packed
    int* upS = pkS + N * TB;                 // [L*N][TB]
    int* rtS = upS + NL * N * TB;            // [L*N][TB]
    int* ftS = rtS + NL * N * TB;            // [R*N][TB]
    // rows: packed, the two graphs' limbs, the fits; then ctx and the
    // previous action's embedding into qin
    const int nr = N + 2 * NL * N + R * N;
    tapnet::rows8<NWARP>(nr, wy, [&](int j) {
      if (j < N) return active ? io.packed[j * B + b] : 1;
      j -= N;
      if (j < NL * N) return ai.upm[(size_t)j * B + bb];
      j -= NL * N;
      if (j < NL * N) return ai.rotm[(size_t)j * B + bb];
      return ai.fits[(size_t)(j - NL * N) * B + bb];
    }, [&](int j, int v) { pkS[j * TB + lane] = v; });
    // qin's rows of ctx, the previous action's embedding and (below) the
    // count summary, filled here once, their loads in flight beside the
    // rows above and behind phase 0's barriers (WH: the query's
    // step-invariant part comes from the rollout, dsum per container)
    if constexpr (!WH) {
      const int idx = min(max((active ? ai.prev[b] : -1) + 1, 0), A);
      tapnet::rows8<NWARP>(2 * h, wy, [&](int j) {
        return j < h ? f32(ai.ctx[(size_t)j * B + bb])
                     : ldg(hw.et + (size_t)(j - h) * (A + 1) + idx);
      }, [&](int j, float v) { qin[(h + j) * LD + lane] = v; });
    }
    constexpr int UW = 32 * 32 * MAXR / NT;  // Wp: 32 h <= UW NT elements
    if constexpr (TC) {
      const unsigned short* src =
          reinterpret_cast<const unsigned short*>(hw.wpt);
      unsigned short v[UW];
#pragma unroll
      for (int u = 0; u < UW; ++u) {  // Wp as it lies
        const int e = tid + u * NT;
        v[u] = e < 32 * h ? __ldg(src + e) : (unsigned short)0;
      }
#pragma unroll
      for (int u = 0; u < UW; ++u) {
        const int e = tid + u * NT;
        if (e < 32 * h) wps[(e >> 5) * WPS + (e & 31)] = v[u];
      }
    } else {
      float v[UW];
#pragma unroll
      for (int u = 0; u < UW; ++u) {  // Wp^T
        const int e = tid + u * NT, k = e / h, j = e - k * h;
        v[u] = e < 32 * h ? ldg(hw.wpt + j * 32 + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UW; ++u)
        if (tid + u * NT < 32 * h) Ws[tid + u * NT] = v[u];
    }
    if (tid < 256) W8s[tid] = ldg(hw.w8t + tid);
    if (tid < 32) b8s[tid] = ldg(hw.b8 + tid);
    if (tid < h) vs[tid] = __ldg(hw.v + tid);
    if (wy == 0)
      for (int k = 1; k < 6; ++k) wb[k * TB + lane] = 0;
    __syncthreads();
    K2_MARK(0);
    // every warp: the packed word, then the accessibility and fit bits of
    // its blocks i = wy + NWARP m, OR-ed into the tile's words
    {
      Word pk = 0, ub = 0, a0 = 0, ar = 0, f0 = 0, f1 = 0;
#pragma unroll 8
      for (int j = 0; j < N; ++j) {
        const int p = pkS[j * TB + lane];
        pk |= (Word)(p != 0) << j;
        ub |= (Word)(p == 0) << j;
      }
      for (int i = wy; i < N; i += NWARP) {
        const bool unpk = !((pk >> i) & 1);
        const bool acc0 = unpk && (column<Word>(upS, i, N, lane) & ub) == 0;
        const bool accr = acc0 && (column<Word>(rtS, i, N, lane) & ub) == 0;
        a0 |= (Word)acc0 << i;
        ar |= (Word)accr << i;
        f0 |= (Word)(ftS[i * TB + lane] != 0) << i;
        if (R == 2) f1 |= (Word)(ftS[(N + i) * TB + lane] != 0) << i;
      }
      if (wy == 0) wb[lane] = pk;
      if (a0) atomicOr(&wb[TB + lane], a0);
      if (ar) atomicOr(&wb[2 * TB + lane], ar);
      if (f0) atomicOr(&wb[4 * TB + lane], f0);
      if (f1) atomicOr(&wb[5 * TB + lane], f1);
    }
    __syncthreads();
    K2_MARK(1);
    if (wy == 0) {
      const Word pk = wb[lane], a0m = wb[TB + lane], arm = wb[2 * TB + lane];
      // the window: the first `window` accessible blocks in index order
      Word wnm = a0m;
      if (WIDE && window > 0) {
        wnm = 0;
        Word m = a0m;
        for (int k = 0; k < window && m; ++k) {
          const Word low = m & (~m + 1);
          wnm |= low;
          m ^= low;
        }
      }
      wb[3 * TB + lane] = wnm;
      // token bits: t = (i, r) is allowed in every container iff
      // (r == 0 ? win : win & accr) and the rotated block fits
      const Word ok0 = wnm & wb[4 * TB + lane];
      const Word ok1 = wnm & arm & wb[5 * TB + lane];
      int n = 0;
      for (int q = 0; q * 32 < T; ++q) {
        const unsigned u = R == 1 ? (unsigned)(ok0 >> (32 * q))
                                  : spread16((unsigned)(ok0 >> (16 * q))) |
                                        spread16((unsigned)(ok1 >> (16 * q)))
                                            << 1;
        tw[q * TB + lane] = u;
        n += __popc(u);
      }
      if (LOGITS) n = active ? T : 0;
      if constexpr (WH)
        qcol[lane] = min(max((active ? ai.prev[b] : -1) + 1, 0), A);
      else {
        const float fpk = (float)popw(pk), fa0 = (float)popw(a0m);
        const float far = (float)popw(arm);
        const float acc_mean =
            R == 2 ? (fa0 + far) / (float)T : fa0 / (float)N;
        float* ds = qin + 3 * h * LD;
        ds[0 * LD + lane] = rnd<E>(fpk / (float)N);
        ds[1 * LD + lane] = rnd<E>(acc_mean);
        ds[2 * LD + lane] = rnd<E>((float)popw(wnm) / (float)N);
        ds[3 * LD + lane] = rnd<E>(tf);
        for (int k = 0; k < 4; ++k)
          ds[(4 + k) * LD + lane] = f32(ai.statm[(size_t)k * B + bb]);
      }
      int x = n;  // inclusive scan over the lanes
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
      }
      int p = x - n;
      off[lane] = p;
      if (lane == 31) {
        off[TB] = x;
        *flag = x > 0;
      }
      if (LOGITS) {
        for (int t = 0; t < n; ++t) cols[p++] = (t << 5) | lane;
      } else {
        for (int q = 0; q * 32 < T; ++q) {
          for (unsigned m = tw[q * TB + lane]; m; m &= m - 1)
            cols[p++] = ((q * 32 + __ffs(m) - 1) << 5) | lane;
        }
      }
    }
    __syncthreads();
    K2_MARK(2);
  }
  // flags and mask, every warp a share of the rows
  if (active) {
    const Word pk = wb[lane], a0m = wb[TB + lane];
    const Word arm = wb[2 * TB + lane], wnm = wb[3 * TB + lane];
    for (int i = wy; i < N; i += NWARP)
      ai.flags_o[i * B + b] = (int)((pk >> i) & 1) + 2 * (int)((a0m >> i) & 1)
                            + 4 * (int)((arm >> i) & 1)
                            + 8 * (int)((wnm >> i) & 1);
    for (int t = wy; t < T; t += NWARP) {
      const int ok = (int)((tw[(t >> 5) * TB + lane] >> (t & 31)) & 1u);
      for (int cc = 0; cc < C; ++cc) ai.mask_o[(t * C + cc) * B + b] = ok;
    }
  }

  K2_MARK(3);
  if (*flag) {
    // ---- phase 1: heightmap encoder and query, per container
    if constexpr (WH) {
      // X row k of instance n (tc: its bfloat16 copy; the value is
      // bfloat16-exact there)
      auto xput = [&](int k, int n, float v) {
        if constexpr (TC) Xs[xs32_at(k, n)] = tapnet::bf16_bits(v);
        else X[k * LD + n] = v;
      };
      auto xget = [&](int k, int n) {
        if constexpr (TC)
          return __bfloat162float(__ushort_as_bfloat16(Xs[xs32_at(k, n)]));
        else return X[k * LD + n];
      };
      // a container's chain: the slabs of W1, W2 and Wq' (`ring_slabs`),
      // n1, n2, n3 of each row half of HR rows (WX: two halves, one after
      // the other)
      constexpr int SK = TC ? RING_K : KR;  // columns of W in a slab
      constexpr int NH = Q::NH;
      const int HR = h / NH;
      const int n1 = (WD + 2 + SK - 1) / SK, n2 = h / SK;
      const int n3 = (h + 8 + SK - 1) / SK;
      const bf16* s1 = hw.slabs;
      const bf16* s2 = s1 + (size_t)n1 * h * RING_K;
      const bf16* s3 = s2 + (size_t)n2 * h * RING_K;
      auto none = [](int, int) { return 0.f; };
      // the query's step-invariant part (once per rollout)
      auto q_init = [&](int j, int n) {
        const int bn = tile0 + n < B ? tile0 + n : 0;
        return hw.qctx[(size_t)j * B + bn] +
               hw.qemb[(size_t)j * (A + 1) + qcol[n]];
      };
      // float32: W1 feats SIMT (it decides e1's ReLU gates, as in the
      // replay: `simt`), W2 and Wq' as 3xTF32
      // (each row half in turn: slabs a + hr ns .., rows hr HR ..)
      auto product = [&](auto simt, const Chain& ch, int a, int K, int xrow,
                         auto init, auto emit) {
        const int ns = (K + SK - 1) / SK;
        for (int hr = 0; hr < NH; ++hr) {
          const int j0 = hr * HR, ah = a + hr * ns;
          auto in = [&](int j, int n) { return init(j0 + j, n); };
          auto out = [&](int j, int n, float acc) { emit(j0 + j, n, acc); };
          if constexpr (TC)
            ring_mv_tc(ring, ch, ah, K, HR, xrow ? E1s : Xs, lane, wy, in,
                       out);
          else if constexpr (decltype(simt)::value)
            ring_mv_f32(ring, ch, ah, K, HR, X, lane, wy, in, out);
          else
            ring_mm_tf32<WX>(ring, ch, ah, K, HR, xrow ? e1w : X, lane, wy,
                             in, out);
        }
      };
      const std::true_type simt;
      const std::false_type mma;
      for (int cc = 0; cc < C; ++cc) {
        for (int k = wy; k < WD; k += NWARP)
          xput(k, lane, rnd<E>((float)io.hm[(cc * WD + k) * B + bb] * inv_s));
        // the barrier; then the chain's first slabs
        const Chain ch = tapnet::ring_open(ring, HR, s1, NH * n1, s2,
                                           NH * n2, s3, NH * n3, tid);
        if (wy == 0) {
          float mx = xget(0, lane), sm = 0.f;
          for (int k = 0; k < WD; ++k) {
            mx = fmaxf(mx, xget(k, lane));
            sm += xget(k, lane);
          }
          xput(WD, lane, mx);
          xput(WD + 1, lane, rnd<E>(sm / (float)WD));
          if constexpr (TC)  // zeros to the next 16 rows
            for (int k = WD + 2; k < ((WD + 17) & ~15); ++k) xput(k, lane, 0.f);
        }
        __syncthreads();
        K2_MARK(5);
        product(simt, ch, 0, WD + 2, 0, none, [&](int j, int n, float acc) {
          const float v = fmaxf(rnd<E>(rnd<E>(acc) + ldg(hw.b1 + j)), 0.f);
          if constexpr (TC) E1s[xs32_at(j, n)] = tapnet::bf16_bits(v);
          else e1w[j * LD + n] = v;
        });
        __syncthreads();
        K2_MARK(6);
        if (wy == 0) {  // dsum, X rows h .. h + 8 (feats are consumed)
          const float fpk = (float)popw(wb[lane]);
          const float fa0 = (float)popw(wb[TB + lane]);
          const float far = (float)popw(wb[2 * TB + lane]);
          xput(h, lane, rnd<E>(fpk / (float)N));
          xput(h + 1, lane,
               rnd<E>(R == 2 ? (fa0 + far) / (float)T : fa0 / (float)N));
          xput(h + 2, lane, rnd<E>((float)popw(wb[3 * TB + lane]) / (float)N));
          xput(h + 3, lane, rnd<E>(tf));
          for (int k = 0; k < 4; ++k)
            xput(h + 4 + k, lane, f32(ai.statm[(size_t)k * B + bb]));
          if constexpr (TC)
            for (int k = h + 8; k < h + 16; ++k) xput(k, lane, 0.f);
        }
        product(mma, ch, NH * n1, h, 1, none, [&](int j, int n, float acc) {
          xput(j, n, rnd<E>(rnd<E>(acc) + ldg(hw.b2 + j)));
        });
        __syncthreads();
        K2_MARK(7);
        float* qc = qs + cc * h * LD;
        product(mma, ch, NH * (n1 + n2), h + 8, 0, q_init,
                [&](int j, int n, float acc) {
          qc[j * LD + n] = rnd<E>(rnd<E>(acc) + ldg(hw.bq + j));
        });
        __syncthreads();
        K2_MARK(8);
      }
    } else {
      K2_MARK(4);
      for (int cc = 0; cc < C; ++cc) {
        for (int k = vw; k < WD; k += NVW)
          feats[k * LP + vl] =
              rnd<E>((float)io.hm[(cc * WD + k) * B + bb] * inv_s);
        __syncthreads();
        if (vw == 0) {
          float mx = feats[vl], sm = 0.f;
          for (int k = 0; k < WD; ++k) {
            mx = fmaxf(mx, feats[k * LP + vl]);
            sm += feats[k * LP + vl];
          }
          feats[WD * LP + vl] = mx;
          feats[(WD + 1) * LP + vl] = rnd<E>(sm / (float)WD);
        }
        __syncthreads();
        K2_MARK(5);
        auto e1_out = [&](int j, int n, float acc) {
          e1[j * LP + n] = fmaxf(rnd<E>(rnd<E>(acc) + ldg(hw.b1 + j)), 0.f);
        };
        if constexpr (TC)
          mv_mma<Q::KSL>(hw.w1t, h, WD + 2, feats, stgb, lane, wy, tid,
                             e1_out, xbp);
        else
          mv_tiled(hw.w1T, h, WD + 2, feats, stg, vl, vw, tid, e1_out);
        __syncthreads();
        K2_MARK(6);
        auto enc_out = [&](int j, int n, float acc) {
          qin[j * LP + n] = rnd<E>(rnd<E>(acc) + ldg(hw.b2 + j));
        };
        if constexpr (TC)
          mv_mma<Q::KSL>(hw.w2t, h, h, e1, stgb, lane, wy, tid, enc_out,
                             xbp);
        else
          mv_tiled(hw.w2T, h, h, e1, stg, vl, vw, tid, enc_out);
        __syncthreads();
        K2_MARK(7);
        float* qc = qs + cc * h * LP;
        auto q_out = [&](int j, int n, float acc) {
          qc[j * LP + n] = rnd<E>(rnd<E>(acc) + ldg(hw.bq + j));
        };
        if constexpr (TC)
          mv_mma<Q::KSL>(hw.wqt, h, FQ, qin, stgb, lane, wy, tid, q_out,
                             xbp);
        else
          mv_tiled(hw.wqT, h, FQ, qin, stg, vl, vw, tid, q_out);
        __syncthreads();
        K2_MARK(8);
      }
    }

    // ---- phase 2: the token work over the tile's columns, groups of G
    {
      const int n = off[TB];
      for (int g0 = 0; g0 < n; g0 += G) {
        const int ng = min(G, n - g0);
        // the keys of this warp's columns, loaded before the group's
        // barriers so that their latency overlaps them
        float sev[CPW][MAXR];
#pragma unroll
        for (int i = 0; i < CPW; ++i) {
          const int cc = wy * CPW + i;
          const int e = cols[g0 + min(cc, ng - 1)], l = e & 31, t = e >> 5;
          const E* sep = ai.se + ((size_t)(tile0 + l) * T + t) * h;
#pragma unroll
          for (int r = 0; r < MAXR; ++r)
            sev[i][r] = (r < RPL && cc < ng) ? f32(sep[lane + 32 * r]) : 0.f;
        }
        // x8 and h1 = relu(W8 x8 + b8) of the group's columns
        if (tid < G) {
          float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (tid < ng) {
            const int e = cols[g0 + tid], l = e & 31, t = e >> 5;
            const int i = t / R, r = t - i * R;
            f[0] = (float)((wb[l] >> i) & 1);
            f[1] = (float)((wb[(r == 0 ? 1 : 2) * TB + l] >> i) & 1);
            f[2] = (float)((wb[3 * TB + l] >> i) & 1);
            f[3] = rnd<E>(tf);
            for (int m = 0; m < 4; ++m)
              f[4 + m] = f32(ai.statp[((size_t)m * T + t) * B + tile0 + l]);
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
        // dyn = Wp h1 for this warp's CPW columns, rows lane + 32 r
        float dyn[CPW][MAXR];
        if constexpr (TC) {
          // the group's dyn [G][HP] into DD on the tensor cores (A = Wp
          // staged, B = h1; warp wy owns the column tile wy % NCT and the
          // row tiles wy / NCT + (NWARP / NCT) i of the column tiles that
          // hold a column), a barrier, then this warp's columns read back
          // from DD
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
              const int j = 16 * mt + g8, cl = 8 * nt + 2 * t4;
              DD[cl * HP + j] = acc[0];
              DD[(cl + 1) * HP + j] = acc[1];
              DD[cl * HP + j + 8] = acc[2];
              DD[(cl + 1) * HP + j + 8] = acc[3];
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
        } else {
#pragma unroll
          for (int i = 0; i < CPW; ++i)
#pragma unroll
            for (int r = 0; r < MAXR; ++r) dyn[i][r] = 0.f;
          for (int k = 0; k < 32; ++k) {
            if constexpr (CPW == 4) {
              const float4 hv =
                  *reinterpret_cast<const float4*>(h1 + k * G + wy * CPW);
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
                  *reinterpret_cast<const float2*>(h1 + k * G + wy * CPW);
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
              const float hv = h1[k * G + wy];
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
        }
        // the attention epilogue: a column's score per container, a warp sum
#pragma unroll
        for (int i = 0; i < CPW; ++i) {
          const int cc = wy * CPW + i;
          if (cc >= ng) break;  // warp-uniform
          const int e = cols[g0 + cc], l = e & 31, t = e >> 5;
          for (int k = 0; k < C; ++k) {
            const float* qc = qs + k * h * LP;
            float ps = 0.f;
#pragma unroll
            for (int r = 0; r < MAXR; ++r) {
              if (r < RPL) {
                const int j = lane + 32 * r;
                const float sd = rnd<E>(sev[i][r] + dyn[i][r]);
                const float act =
                    rnd<E>(tanhf(rnd<E>(sd + qc[j * LP + l])));
                ps = fmaf(act, vs[j], ps);
              }
            }
            ps = warp_sum(ps);
            if (lane == 0) sc[(t * C + k) * TB + l] = rnd<E>(ps);
          }
        }
      }
    }
  }
  __syncthreads();
  K2_MARK(9);

  // ---- phase 3: masked logits and selection scores, every warp a share of
  // the actions with its partial max and argmax, and the rows the
  // placement reads; then per instance on warp 0: the max and the argmax,
  // the placement, log pi over the valid actions in action order
  // decisions [13][TB]: block, container, rotation, w, d, h, valid, then
  // x, y, landing height, stable, top (under MCS first the score context)
  // and do
  int* dec = reinterpret_cast<int*>(stg);
  // the warps' partial max and argmax [3][NWARP][TB], later their partial
  // placements [8][NWARP][TB]
  float* pmx = reinterpret_cast<float*>(dec + 13 * TB);
  float* pbest = pmx + NWARP * TB;
  int* pidx = reinterpret_cast<int*>(pbest + NWARP * TB);
  int* ppl = reinterpret_cast<int*>(pmx);
  int* hmS = ppl + 8 * NWARP * TB;  // [C*W*D][TB] heightmaps
  int* dS = hmS + C * WD * TB;      // [3N][TB] dims w, d, h
  if (active) {
    float mx = NEG, best = 0.f;
    int idx = -1;  // the lowest of this warp's actions attaining `best`
    tapnet::rows8<NWARP>(A, wy, [&](int a) {
      const int t = tok_of(a, C);
      return (tw[(t >> 5) * TB + lane] >> (t & 31)) & 1u ? ai.g[a * B + b]
                                                         : NEG;
    }, [&](int a, float gv) {
      const int t = tok_of(a, C);
      const bool ok = (tw[(t >> 5) * TB + lane] >> (t & 31)) & 1u;
      const float s = sc[a * TB + lane];
      if (LOGITS) ai.logits_o[a * B + b] = s;
      const float m = ok ? s / temperature : NEG;
      const float v = ok ? m + gv : NEG;
      sc[a * TB + lane] = m;
      mx = fmaxf(mx, m);
      if (idx < 0 || v > best) {
        best = v;
        idx = a;
      }
    });
    pmx[wy * TB + lane] = mx;
    pbest[wy * TB + lane] = best;
    pidx[wy * TB + lane] = idx;
    tapnet::rows8<NWARP>(C * WD + 3 * N, wy, [&](int j) {
      if (j < C * WD) return io.hm[j * B + b];
      j -= C * WD;
      return j < N ? io.dims_w[j * B + b]
           : j < 2 * N ? io.dims_d[(j - N) * B + b]
                       : io.dims_h[(j - 2 * N) * B + b];
    }, [&](int j, int v) { hmS[j * TB + lane] = v; });
  }
  __syncthreads();
  K2_MARK(10);
  // per instance on warp 0: the max, the argmax, the block and log pi
  if (wy == 0 && active) {
    float mx = NEG, best = 0.f;
    int a_sel = -1;
    for (int w = 0; w < NWARP; ++w) {
      mx = fmaxf(mx, pmx[w * TB + lane]);
      const float v = pbest[w * TB + lane];
      const int i = pidx[w * TB + lane];
      if (i >= 0 && (a_sel < 0 || v > best || (v == best && i < a_sel))) {
        best = v;
        a_sel = i;
      }
    }
    bool valid = false;
    for (int q = 0; q * 32 < T; ++q) valid |= tw[q * TB + lane] != 0u;
    const int blk = a_sel / (R * C), r = (a_sel / C) % R, cs = a_sel % C;
    int w = dS[blk * TB + lane];
    int d = dS[(N + blk) * TB + lane];
    int hb = dS[(2 * N + blk) * TB + lane];
    tapnet::rotate_dims(c, r, w, d, hb);
    const int v[6] = {blk, cs, r, w, d, hb};
    for (int k = 0; k < 6; ++k) dec[k * TB + lane] = v[k];
    dec[6 * TB + lane] = valid;
    if (MCS) {
      const tapnet::ScoreCtx s = tapnet::score_ctx(
          c, io.hm, io.plc, io.dims_w, io.dims_d, io.dims_h, B, b);
      const int sv[5] = {s.vol, s.denc, s.denp, s.snum, s.sden};
      for (int k = 0; k < 5; ++k) dec[(7 + k) * TB + lane] = sv[k];
    }
    const int act = valid ? a_sel : -1;
    io.act_o[b] = act;
    float se = 0.f;  // over the instance's columns, in action order
    for (int p = off[lane]; p < off[lane + 1]; ++p) {
      const int t = cols[p] >> 5;
      if ((tw[(t >> 5) * TB + lane] >> (t & 31)) & 1u)
        for (int k = 0; k < C; ++k)
          se += expf(sc[(t * C + k) * TB + lane] - mx);
    }
    const float lp = (sc[max(act, 0) * TB + lane] - mx) - logf(se);
    ai.logp_o[b] = act >= 0 ? lp : 0.f;
  }
  __syncthreads();
  K2_MARK(11);
  // the placement: every warp a share of the candidate offsets
  if (active) {
    const int cs = dec[TB + lane], w = dec[3 * TB + lane];
    const int d = dec[4 * TB + lane], hb = dec[5 * TB + lane];
    tapnet::ScoreCtx s{0, 0, 0, 0, 0};
    if (MCS)
      s = tapnet::ScoreCtx{dec[7 * TB + lane], dec[8 * TB + lane],
                           dec[9 * TB + lane], dec[10 * TB + lane],
                           dec[11 * TB + lane]};
    tapnet::place_put<MCS, TB, NWARP>(
        ppl, wy, lane,
        tapnet::place_part<MCS, TB, NWARP>(c, hmS + cs * WD * TB + lane, w,
                                           d, hb, s, wy));
  }
  __syncthreads();
  K2_MARK(12);
  if (wy == 0 && active) {
    PlacePart pb = tapnet::place_gather<MCS, TB, NWARP>(ppl, lane);
    const tapnet::Placement p = tapnet::place_resolve<MCS>(c, pb);
    const int pv[6] = {p.x, p.y, p.l, p.stable, p.l + dec[5 * TB + lane],
                       dec[6 * TB + lane] && p.any_valid};
    for (int k = 0; k < 6; ++k) dec[(7 + k) * TB + lane] = pv[k];
  }
  __syncthreads();
  K2_MARK(13);
  // the state writes of select_place, every warp a share of the rows
  if (active) {
    const int blk = dec[lane], cs = dec[TB + lane], w = dec[3 * TB + lane];
    const int d = dec[4 * TB + lane], xs = dec[7 * TB + lane];
    const int ys = dec[8 * TB + lane], top = dec[11 * TB + lane];
    const bool dop = dec[12 * TB + lane] != 0;
    for (int k = wy; k < C * WD; k += NWARP) {
      const int cc = k / WD, x = (k % WD) / c.D, y = k % c.D;
      const bool fp = dop && cc == cs && x >= xs && x < xs + w && y >= ys &&
                      y < ys + d;
      io.hm_o[k * B + b] = fp ? top : hmS[k * TB + lane];
    }
    // packed rows, then the placement rows: container, rotation, x, y,
    // landing height, stable
    tapnet::rows8<NWARP>(N + N * 6, wy, [&](int k) {
      return k < N ? io.packed[k * B + b] : io.plc[(k - N) * B + b];
    }, [&](int k, int v) {
      if (k < N) {
        io.packed_o[k * B + b] = v + (dop && k == blk);
      } else {
        k -= N;
        const int f = k % 6;  // container, rotation, x, y, l, stable
        const int row = f < 2 ? dec[(f + 1) * TB + lane]
                              : dec[(f + 5) * TB + lane];
        io.plc_o[k * B + b] = dop && k / 6 == blk ? row : v;
      }
    });
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes (ops/actor_step.py
// smem_bytes mirrors it); tc: the bfloat16 instantiations; h > 128: the
// single-pass plan on the weight ring (`layout_wh`).
static size_t smem_bytes(int N, int R, int C, int WD, int h, bool tc) {
  const int wc = tapnet::geo_class(h);
  const int floats = wc == 2   ? layout<2>(N, R, C, WD, h, tc).floats
                     : wc == 1 ? layout<1>(N, R, C, WD, h, tc).floats
                               : layout<0>(N, R, C, WD, h, tc).floats;
  return 4 * (size_t)(floats + n_ints(N, R));
}

template <class E>
using KernelFn = void (*)(tapnet::EnvCfg, tapnet::StepIO, ActorIO<E>,
                          HeadW<E>, int, int, float, float, int);

template <bool MCS, bool WIDE, int WC, class E>
static KernelFn<E> pick(bool logits) {
  if (logits) return actor_step_kernel<MCS, WIDE, true, WC, E>;
  return actor_step_kernel<MCS, WIDE, false, WC, E>;
}

template <int WC, class E>
static KernelFn<E> pick(bool mcs, bool wide, bool logits) {
  return wide ? (mcs ? pick<true, true, WC, E>(logits)
                     : pick<false, true, WC, E>(logits))
              : (mcs ? pick<true, false, WC, E>(logits)
                     : pick<false, false, WC, E>(logits));
}

template <class E>
static int launch(void* const* p, const tapnet::EnvCfg& c, int B, int h,
                  int window, bool logits, float inv_s, float temperature,
                  void* stream) {
  const bool wide = window > 0 || c.N > 31;
  const tapnet::StepIO io{
      (const int*)p[0], (const int*)p[1], (const int*)p[2],
      (const int*)p[3], (const int*)p[4], (const int*)p[5],
      (int*)p[27],      (int*)p[28],      (int*)p[29],      (int*)p[30]};
  const ActorIO<E> ai{(const float*)p[6], (const int*)p[7],
                      (const int*)p[8],   (const int*)p[9],
                      (const int*)p[10],  (const float*)p[11],
                      (const E*)p[12],    (const E*)p[13],
                      (const E*)p[14],    (const E*)p[15],
                      (int*)p[31],        (int*)p[32],
                      (float*)p[33],      (float*)p[34]};
  const HeadW<E> hw{(const E*)p[16], (const E*)p[17], (const E*)p[18],
                    (const E*)p[19], (const E*)p[20], (const E*)p[21],
                    (const E*)p[22], (const E*)p[23], (const E*)p[24],
                    (const E*)p[25], (const float*)p[26], (const E*)p[35],
                    (const E*)p[36], (const E*)p[37], (const float*)p[38],
                    (const float*)p[39], (const bf16*)p[40], (float*)p[41]};
  const size_t smem =
      smem_bytes(c.N, c.R, c.C, c.W * c.D, h, std::is_same_v<E, bf16>);
  const int wc = tapnet::geo_class(h);
  const KernelFn<E> kernel = wc == 2   ? pick<2, E>(c.mcs, wide, logits)
                             : wc == 1 ? pick<1, E>(c.mcs, wide, logits)
                                       : pick<0, E>(c.mcs, wide, logits);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TB, NWARP);
  kernel<<<(B + TB - 1) / TB, block, smem, (cudaStream_t)stream>>>(
      c, io, ai, hw, B, h, inv_s, temperature, window);
  return (int)cudaGetLastError();
}

// ptrs: packed, hm, plc, dims_w, dims_d, dims_h,                       (0-5)
//       tf, prev, upm, rotm, fits, g, se [B, T, h], ctx, statp, statm, (6-15)
//       w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v,                (16-26)
//       packed_o, hm_o, plc_o, act_o, flags_o, mask_o, logits_o, logp_o (27-34)
//       w1t^T, w2t^T, wqt^T                                            (35-37)
//       h > 128: qctx [h, B], qemb [h, A+1] (f32, query_parts) and the
//       ring slabs of W1, W2, Wq' (ops/actor_step.py ring_slabs)       (38-40)
//       h > 256: the blocks' scratch, ceil(B / 32) tapnet_actor_scratch
//       floats (f32; made once a rollout, `wide_operands`)             (41)
// ints: B, the EnvCfg fields (select_place.cuh env_cfg), h, window, logits
// (1: the full mode, logits_o written; 0: live columns, logits_o unused),
// bf16 (1: se, ctx, statp, statm and the weights other than v are
// bfloat16; 0: float). h: a multiple of 32 up to 256, of 64 up to 512.
// Launches on `stream`; returns cudaGetLastError() after the launch.
// The dynamic shared memory of one block for the ints of a launch (below)
// and the instantiation (bf16): what ops/actor_step.py::smem_bytes mirrors.
extern "C" long long tapnet_actor_smem_bytes(const int* ints, int bf16) {
  const tapnet::EnvCfg c = tapnet::env_cfg(ints + 1);
  return (long long)smem_bytes(c.N, c.R, c.C, c.W * c.D,
                               ints[1 + tapnet::ENV_INTS], bf16 != 0);
}

// The floats of one block's scratch (pointer 41) for the ints of a launch
// (the bf16 flag included): what ops/actor_step.py::wx_scratch mirrors; 0
// at h <= 256.
extern "C" long long tapnet_actor_scratch(const int* ints) {
  const tapnet::EnvCfg c = tapnet::env_cfg(ints + 1);
  const int h = ints[1 + tapnet::ENV_INTS];
  const bool bf = ints[4 + tapnet::ENV_INTS] != 0;
  return tapnet::geo_class(h) == 2 ? wx_scratch(c.C, c.W * c.D, h, bf) : 0;
}

extern "C" int tapnet_actor_select_step(void* const* p, const int* ints,
                                        float inv_s, float temperature,
                                        void* stream) {
  const int B = ints[0], h = ints[1 + tapnet::ENV_INTS];
  const int window = ints[2 + tapnet::ENV_INTS];
  const bool logits = ints[3 + tapnet::ENV_INTS] != 0;
  const bool bf = ints[4 + tapnet::ENV_INTS] != 0;
  const tapnet::EnvCfg c = tapnet::env_cfg(ints + 1);
  if (c.N > MAX_N || c.C > MAX_C || c.W * c.D > tapnet::MAX_WD ||
      h % 32 != 0 || h <= 0 || h > MAX_H || (h > 256 && h % 64 != 0) ||
      B <= 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)c.N * c.R * h * B >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  return bf ? launch<bf16>(p, c, B, h, window, logits, inv_s, temperature,
                           stream)
            : launch<float>(p, c, B, h, window, logits, inv_s, temperature,
                            stream);
}

// ---- the query's step-invariant part, once per rollout (WH)
//
// qctx [h][B] = Wq[:, h:2h] ctx and qemb [h][A+1] = Wq[:, 2h:3h] E: the
// columns of Wq that meet the mean static key and the previous action's
// embedding (qin's rows h .. 3h of the JAX kernel's query,
// tapnet_tpu/ops/pallas_actor_step.py:242-243, whose values do not change
// over a rollout). No TPU kernel of its own: K2's WH steps start their
// query accumulators from qctx + qemb (the note above `launch`).
//
// Bound: at h = 256, B = 4096 it is 2 h h (B + A + 1) = 0.54 GFLOP. In
// bfloat16 the bytes bind (Wq's two column blocks, ctx and E read once,
// the float32 outputs written once: 6.3 MB, ~1.9 us at 3.35 TB/s; the
// products take 0.55 us at the dense bf16 peak); in float32 the products
// as 3xTF32 (~3.3 us at 495/3 TFLOP/s) against ~2.7 us of bytes.
//
// Design: one block of 8 warps per 64 x 128 tile of an output, on the
// tensor cores. The grid is one flat list of tiles, the emb product's
// ceil(h/64) x ceil((A+1)/128) first, then the ctx product's ceil(h/64) x
// ceil(B/128) (132 blocks at h = 256, B = 4096: one wave); a tile's
// blocks share its row tile of Wq and walk the columns. K runs in stages
// (64 rows in bfloat16, 32 in float32) through a ring of QP_NB buffers,
// one barrier a stage; the cp.async copies run QP_NB - 1 stages ahead of
// the products (at h = 256 in bfloat16 the whole of K at once), those
// that pass through registers (float32 A, B by element) one stage ahead.
// Warp w owns rows 32 (w & 1) .. + 31 and columns 32 (w >> 1) .. + 31 of
// the tile: two m-tiles by four n-tiles, so an A fragment feeds four
// products and a B fragment two.
// - A (Wq's rows, [m][k]) lies in rows of 8 chunks of 16 bytes, chunk c
//   of row r at c ^ (r & 7), read by ldmatrix: the 8 rows of an ldmatrix
//   matrix fall in 8 bank groups.
// - bfloat16: mma.sync m16n8k16 bf16 x bf16 -> f32 (exact products, f32
//   sums). A comes by 16-byte cp.async; B (ctx or E, [k][n] row-major)
//   into [KS][128] rows of 16 chunks, chunk c of row k at c ^ (k & 7),
//   read by ldmatrix.trans.
// - float32: 3xTF32 (mma_tf32.cuh: mma.sync m16n8k8 on x = hi + lo, the
//   small terms first, lo.lo dropped). A is loaded into registers a stage
//   ahead and split once as it is staged, hi and lo in two arrays that
//   ldmatrix reads (its 8 x 8 b16 matrices are 8 x 4 f32 in the tf32 A
//   fragment's order); B comes by cp.async into [32][136] rows (136 = 8
//   mod 32: the fragment's 32 loads hit 32 banks) and is split on load.
//   (Splitting A as its fragment is read, with A on the cp.async ring,
//   took 0.0248 ms a launch against this body's 0.0209 at h = 256, B =
//   4096 on an H100 SXM: the four warps of a row tile split the same A.)
// - Edges: rows >= h are zeros and not stored; columns past B or A + 1
//   are zeros and not stored; a bfloat16 stage past K (h = 160, 224)
//   skips its k-steps. Where a row of ctx or E is not a whole number of
//   16-byte chunks (B = 100, A + 1 = 11) B is loaded by element into
//   registers a stage ahead. Outputs are stored as float2 from the
//   accumulators, 32 bytes of a row per 4 lanes.
// Every output is one warp's, summed in k order (a stage's k-steps in
// order, each mma's sum the tensor core's), so two launches are
// bit-identical. Launches on the caller's stream and allocates nothing
// (a CUDA graph captures it).
namespace {

constexpr int QP_BM = 64, QP_BN = 128;  // rows, columns of a block's tile
constexpr int QP_NT = 256;              // threads: 8 warps
constexpr int QP_NB = 4;                // buffers of the stage ring
constexpr int QP_BLD = QP_BN + 8;       // float32 B stage row stride

template <class E>
struct QpPlan {
  static constexpr bool BF = std::is_same_v<E, bf16>;
  static constexpr int KS = BF ? 64 : 32;  // k rows of a stage
  static constexpr int VEC = 16 / sizeof(E);  // elements of a chunk
  // A: bfloat16 as copied; float32 split, hi then lo
  static constexpr int A_BYTES = QP_BM * KS * (BF ? 2 : 8);
  static constexpr int STAGE =
      A_BYTES + KS * (BF ? 2 * QP_BN : 4 * QP_BLD);
  static constexpr int SMEM = QP_NB * STAGE;
};

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <class E, bool CH>
__global__ void __launch_bounds__(QP_NT)
query_parts_kernel(const E* __restrict__ wq, const E* __restrict__ ctx,
                   const E* __restrict__ et, float* __restrict__ qctx,
                   float* __restrict__ qemb, int h, int B, int A1) {
  using Plan = QpPlan<E>;
  constexpr bool BF = Plan::BF;
  constexpr int KS = Plan::KS, VEC = Plan::VEC;
  extern __shared__ __align__(128) unsigned char qp_smem[];
  const int nrb = (h + QP_BM - 1) / QP_BM, ne = (A1 + QP_BN - 1) / QP_BN;
  int bid = blockIdx.x;
  const bool emb = bid < nrb * ne;
  if (!emb) bid -= nrb * ne;
  const int ncol = emb ? A1 : B, koff = emb ? 2 * h : h, FQ = 3 * h + 8;
  const int ncb = (ncol + QP_BN - 1) / QP_BN;
  const int r0 = bid / ncb * QP_BM, c0 = bid % ncb * QP_BN;
  const E* x = emb ? et : ctx;
  float* out = emb ? qemb : qctx;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 32 * (w & 1), wn = 32 * (w >> 1);
  // B's rows as whole 16-byte chunks (else element loads)
  const bool bal =
      ncol % VEC == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
  const int ns = (h + KS - 1) / KS;
  auto stage_of = [&](int s) {
    return qp_smem + s % QP_NB * Plan::STAGE;
  };
  // where chunk c (VEC columns) of B's stage row k goes
  auto b_at = [&](int s, int k, int c) {
    unsigned char* b = stage_of(s) + Plan::A_BYTES;
    return BF ? b + 2 * (k * QP_BN + 8 * (c ^ (k & 7)))
              : b + 4 * (k * QP_BLD + 4 * c);
  };

  // stage s's copies: in bfloat16 A (Wq's rows r0 .., columns koff + KS s
  // ..) and, where its rows are whole chunks, B (rows KS s .., the tile's
  // columns)
  auto copy = [&](int s) {
    const int k0 = KS * s;
    if constexpr (BF) {
      unsigned char* as = stage_of(s);
      for (int e = tid; e < QP_BM * 8; e += QP_NT) {
        const int r = e >> 3, c = e & 7, k = k0 + VEC * c;
        const bool in = r0 + r < h && k < h;
        tapnet::cp16(as + 16 * (r * 8 + (c ^ (r & 7))),
                     in ? wq + (size_t)(r0 + r) * FQ + koff + k : wq,
                     in ? 16 : 0);
      }
    }
    if (!bal) return;
    for (int e = tid; e < KS * (QP_BN / VEC); e += QP_NT) {
      const int k = e / (QP_BN / VEC), c = e % (QP_BN / VEC);
      const int n = c0 + VEC * c;
      const bool in = k0 + k < h && n < ncol;
      tapnet::cp16(b_at(s, k, c),
                   in ? x + (size_t)(k0 + k) * ncol + n : x, in ? 16 : 0);
    }
  };
  // B by element (rows not whole chunks): this thread's 4 chunks of stage
  // s into registers, zeros past the edges, and from there to the ring
  uint4 rb[4];
  auto load_b = [&](int s) {
    const int k0 = KS * s;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + QP_NT * i;
      const int k = e / (QP_BN / VEC), c = e % (QP_BN / VEC);
      const int n = c0 + VEC * c;
      const E* src = x + (size_t)(k0 + k) * ncol + n;
      unsigned v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (BF) {
          const bool in = k0 + k < h;
          const unsigned lo = in && n + 2 * j < ncol
                                  ? __bfloat16_as_ushort(src[2 * j]) : 0u;
          const unsigned hi = in && n + 2 * j + 1 < ncol
                                  ? __bfloat16_as_ushort(src[2 * j + 1])
                                  : 0u;
          v[j] = lo | hi << 16;
        } else {
          v[j] = n + j < ncol ? __float_as_uint(src[j]) : 0u;
        }
      }
      rb[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };
  auto put_b = [&](int s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + QP_NT * i;
      *reinterpret_cast<uint4*>(
          b_at(s, e / (QP_BN / VEC), e % (QP_BN / VEC))) = rb[i];
    }
  };

  // float32 A: this thread's two chunks of stage s into registers, then
  // split into hi and lo as they go to the ring (once for the block)
  float4 ra[2];
  auto load_a = [&](int s) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + QP_NT * i, r = e >> 3, c = e & 7;
      ra[i] = r0 + r < h
                  ? __ldg(reinterpret_cast<const float4*>(
                        wq + (size_t)(r0 + r) * FQ + koff + KS * s + 4 * c))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto put_a = [&](int s) {
    unsigned* hi = reinterpret_cast<unsigned*>(stage_of(s));
    unsigned* lo = hi + QP_BM * KS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + QP_NT * i, r = e >> 3, c = e & 7;
      const float v[4] = {ra[i].x, ra[i].y, ra[i].z, ra[i].w};
      unsigned uh[4], ul[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) tapnet::split_tf32(v[j], uh[j], ul[j]);
      const int at = 4 * (r * 8 + (c ^ (r & 7)));
      *reinterpret_cast<uint4*>(hi + at) =
          make_uint4(uh[0], uh[1], uh[2], uh[3]);
      *reinterpret_cast<uint4*>(lo + at) =
          make_uint4(ul[0], ul[1], ul[2], ul[3]);
    }
  };

  float acc[2][4][4] = {};
  // stage s's products: KS / 16 (bf16) or KS / 8 (f32) k-steps
  auto products = [&](int s) {
    const unsigned short* as =
        reinterpret_cast<const unsigned short*>(stage_of(s));
    const unsigned char* bs = stage_of(s) + Plan::A_BYTES;
    // lane l's ldmatrix row of A's m-tile mt at chunk pair kk: row
    // wm + 16 mt + l % 16, chunk 2 kk + l / 16
    auto a_row = [&](int mt, int kk) {
      const int r = wm + 16 * mt + (lane & 15);
      return as + 8 * (r * 8 + ((2 * kk + (lane >> 4)) ^ (r & 7)));
    };
    if constexpr (BF) {
      const unsigned short* b16 =
          reinterpret_cast<const unsigned short*>(bs);
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        if (KS * s + 16 * kk >= h) break;
        unsigned a[2][4], b[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) tapnet::ldsm(a[mt], a_row(mt, kk));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int k = 16 * kk + (lane & 15);
          const int c = (wn + 16 * np) / 8 + (lane >> 4);
          tapnet::ldsm_t(b[np], b16 + k * QP_BN + 8 * (c ^ (k & 7)));
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const unsigned bb[2] = {b[nt >> 1][2 * (nt & 1)],
                                    b[nt >> 1][2 * (nt & 1) + 1]};
            mma(acc[mt][nt], a[mt], bb);
          }
      }
    } else {
      const float* b32 = reinterpret_cast<const float*>(bs);
      float p[2][4][4];  // CH: the sums of 16 columns of K (two k-steps)
#pragma unroll
      for (int kk = 0; kk < KS / 8; ++kk) {
        if constexpr (CH) {
          if (kk % 2 == 0) {
#pragma unroll
            for (int e = 0; e < 32; ++e) (&p[0][0][0])[e] = 0.f;
          }
        }
        unsigned ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          tapnet::ldsm(ah[mt], a_row(mt, kk));
          tapnet::ldsm(al[mt], a_row(mt, kk) + 2 * QP_BM * KS);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* bp = b32 + (8 * kk + t) * QP_BLD + wn + 8 * nt + g;
          unsigned bh[2], bl[2];
          tapnet::split_tf32(bp[0], bh[0], bl[0]);
          tapnet::split_tf32(bp[4 * QP_BLD], bh[1], bl[1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            tapnet::mma3(CH ? p[mt][nt] : acc[mt][nt], ah[mt], al[mt], bh,
                         bl);
        }
        if constexpr (CH) {
          if (kk % 2 == 1) {
#pragma unroll
            for (int e = 0; e < 32; ++e)
              (&acc[0][0][0])[e] += (&p[0][0][0])[e];
          }
        }
      }
    }
  };

  // the ring: stages 0 .. QP_NB - 2 in flight before the first products;
  // a commit group a stage, empty past K, so that wait_group counts hold
  if constexpr (!BF) {
    load_a(0);
    put_a(0);
  }
  if (!bal) {
    load_b(0);
    put_b(0);
  }
#pragma unroll
  for (int s = 0; s < QP_NB - 1; ++s) {
    if (s < ns) copy(s);
    tapnet::cp_commit();
  }
  for (int s = 0; s < ns; ++s) {
    cp_wait<QP_NB - 2>();  // this thread's copies of stage s have landed
    __syncthreads();       // ... everyone's, and stage s - 1 is read
    if (s + QP_NB - 1 < ns) copy(s + QP_NB - 1);  // into s - 1's buffer
    tapnet::cp_commit();
    // the register stages of s + 1, read after the next barrier
    const bool more = s + 1 < ns;
    if constexpr (!BF)
      if (more) load_a(s + 1);
    if (more && !bal) load_b(s + 1);
    products(s);
    if constexpr (!BF)
      if (more) put_a(s + 1);
    if (more && !bal) put_b(s + 1);
  }

  const bool pair = ncol % 2 == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = c0 + wn + 8 * nt + 2 * t;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int r = r0 + wm + 16 * mt + g + 8 * f;
        if (r >= h) continue;
        float* o = out + (size_t)r * ncol + c;
        const float v0 = acc[mt][nt][2 * f], v1 = acc[mt][nt][2 * f + 1];
        if (pair && c + 1 < ncol) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (c < ncol) o[0] = v0;
          if (c + 1 < ncol) o[1] = v1;
        }
      }
    }
}

template <class E>
static int launch_query_parts(void* const* p, int B, int h, int A1,
                              void* stream) {
  // float32 above hidden 256: the sums of 16 columns added in f32 (CH)
  auto kernel = query_parts_kernel<E, false>;
  if constexpr (std::is_same_v<E, float>)
    if (h > 256) kernel = query_parts_kernel<E, true>;
  const int smem = QpPlan<E>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nrb = (h + QP_BM - 1) / QP_BM;
  const int blocks =
      nrb * ((B + QP_BN - 1) / QP_BN + (A1 + QP_BN - 1) / QP_BN);
  kernel<<<blocks, QP_NT, smem, (cudaStream_t)stream>>>(
      (const E*)p[0], (const E*)p[1], (const E*)p[2], (float*)p[3],
      (float*)p[4], h, B, A1);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: wq [h, 3h+8] (16-byte aligned), ctx [h, B], et [h, A+1] (float
// or, bf16, bfloat16), qctx [h, B], qemb [h, A+1] (float). ints: B, h,
// A + 1, bf16; h a multiple of 32. Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int tapnet_actor_query_parts(void* const* p, const int* ints,
                                        void* stream) {
  const int B = ints[0], h = ints[1], A1 = ints[2];
  if (B <= 0 || h <= 0 || h % 32 != 0 || A1 <= 0 ||
      (reinterpret_cast<size_t>(p[0]) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  return ints[3] ? launch_query_parts<bf16>(p, B, h, A1, stream)
                 : launch_query_parts<float>(p, B, h, A1, stream);
}
