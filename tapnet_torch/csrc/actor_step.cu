// actor_select_step: one whole sampled decode step of the learned policy.
//
// Replaces: tapnet_tpu/ops/pallas_actor_step.py::actor_select_step (kernel
// body `_kernel`): accessibility from precedence bitmasks (one or two 31-bit
// limbs, N <= 62), the rolling-window cut, flags, the action mask, the
// heightmap encoder, the previous-action embedding, the query, the
// per-token dyn MLP, additive attention v.tanh(key + dyn + q), masked
// (tempered) logits + gumbel, select/place (the placement body
// select_place.cuh's place_block, shared with K1 and K4) and log pi of the
// chosen action.
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
// Design (SIMT, f32 fused multiply-adds throughout; no TF32, no
// approximate intrinsics):
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
//   a share of the candidate offsets of place_block (`place_part`: the
//   candidates are totally ordered, so the warps' winners join into
//   place_block's) and writes a share of the new state rows (packed,
//   heightmap, placements). select_place.cuh does all of this from one
//   thread per instance, which at 2d-rolling costs ~0.17 ms per launch
//   (K1). `python -m tapnet_torch.profile_phases` gives every phase's
//   share of a launch.
// - 128 registers, no spills (ptxas); shared memory 142,680 B at 2d-basic
//   and 178,552 B at 2d-rolling (h = 128): one block of 16 warps per SM.
//   The wrapper refuses a plan above the 227 KB a block may hold; h must
//   be a multiple of 32, at most 128.
//
// The device code of phases 1-2 follows replay.cu's forward (K5f) and is a
// copy, not a shared header: K5 stays bit-identical to itself.
#include <cuda_runtime.h>

#include <type_traits>

#include "select_place.cuh"

namespace {

constexpr int TB = 32;      // instances per block
constexpr int LD = TB + 1;  // padded row stride of [feature][lane] arrays
constexpr int NWARP = 16;   // warps per block
constexpr int NT = TB * NWARP;
constexpr int CPW = 4;          // columns per warp in a token group
constexpr int G = CPW * NWARP;  // columns per token group
constexpr int MAXR = 4;         // rows per lane: h <= 32 * MAXR
constexpr int KS = 64;          // weight columns per staged slice
constexpr int MAX_C = 4;        // containers
constexpr int MAX_N = 62;       // blocks: two 31-bit precedence limbs
constexpr int TOKW = 4;         // 32-bit words of token bits: T <= 128
constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

struct HeadW {
  const float *w8t, *b8, *wpt, *w1t, *b1, *w2t, *b2, *et, *wqt, *bq, *v;
  const float *w1T, *w2T, *wqT;  // W1, W2, Wq transposed: [in][h]
};

struct ActorIO {
  const float* tf;     // [1]
  const int* prev;     // [B]
  const int* upm;      // [L*N, B] column bitmasks of the up graph, L limbs
  const int* rotm;     // [L*N, B]
  const int* fits;     // [R*N, B]
  const float* g;      // [A, B] gumbel (zeros = greedy)
  const float* se;     // [B, T, h] static keys, one row per column
  const float* ctx;    // [h, B] mean static key
  const float* statp;  // [4, T, B] static token features
  const float* statm;  // [4, B] their mean over tokens
  int* flags_o;        // [N, B]
  int* mask_o;         // [A, B]
  float* logits_o;     // [A, B] (LOGITS only)
  float* logp_o;       // [B]
};

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

// Shared-memory plan, in floats from the base (every region 16-byte
// aligned); the ints follow the floats.
struct Lay {
  int ws, w8, b8, v, q, sc, enc, tok, floats;
};

__host__ __device__ inline Lay layout(int N, int R, int C, int WD, int h) {
  const int T = N * R, A = T * C, FQ = 3 * h + 8, L = (N + 30) / 31;
  Lay y;
  int o = 0;
  y.ws = o;  o += up4(32 * h);         // Wp^T [32][h]
  y.w8 = o;  o += 32 * 8;              // W8 [32][8]
  y.b8 = o;  o += 32;
  y.v = o;   o += up4(h);
  y.q = o;   o += up4(C * h * LD);     // q [C][h][LD]
  y.sc = o;  o += A * TB;              // scores, then masked [A][TB]
  // encoder view: feats [WD+2][LD], e1 [h][LD], qin [3h+8][LD]
  y.enc = o; o += up4((WD + 2 + h + FQ) * LD);
  // token view: x8 [8][G], h1 [32][G]; or a staged weight slice
  // [KS][h]; or phase 0's rows (packed, limbs, fits) as ints; or phase
  // 3's decisions [13][TB], the warps' partial results [8][NWARP][TB] and
  // rows (heightmaps [C*W*D], dims [3N]) as ints
  const int tok = 40 * G, stage = KS * h;
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

// out[j] = sum_k W[j, k] x[k][lane] for every row j < h (a warp owns the
// h/16 rows wy*h/16 ..), W given transposed, WT [cols][h]: slices of KS of
// its rows are copied to shared memory S as they lie (float4, the next
// slice's loads in flight while this one is multiplied) and read as
// float4 (h = 64, 128) or float2 broadcasts, so one load of x feeds h/16
// multiply-adds. emit(j, acc) stores row j. The caller follows with a
// barrier before S or the outputs are reused.
template <class Emit>
__device__ void mv_tiled(const float* __restrict__ WT, int h, int cols,
                         const float* x, float* S, int lane, int wy, int tid,
                         Emit emit) {
  const int RW = h / NWARP;  // 2 (h = 32) .. 8 (h = 128)
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float4* src = reinterpret_cast<const float4*>(WT);
  float4 v[KS * 128 / 4 / NT];  // a slice of at most KS * 128 floats
  auto load = [&](int k0) {
    const int n4 = min(KS, cols - k0) * h / 4;
#pragma unroll
    for (int u = 0; u < KS * 128 / 4 / NT; ++u) {
      const int e = tid + u * NT;
      if (e < n4) v[u] = __ldg(src + (size_t)k0 * h / 4 + e);
    }
  };
  load(0);
  for (int k0 = 0; k0 < cols; k0 += KS) {
    const int nk = min(KS, cols - k0);
    __syncthreads();  // S is free
#pragma unroll
    for (int u = 0; u < KS * 128 / 4 / NT; ++u) {
      const int e = tid + u * NT;
      if (e < nk * h / 4) reinterpret_cast<float4*>(S)[e] = v[u];
    }
    __syncthreads();
    if (k0 + KS < cols) load(k0 + KS);
    if (RW % 4 == 0) {
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        const float xv = x[(k0 + kk) * LD + lane];
        const float* sw = S + kk * h + wy * RW;
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
        const float xv = x[(k0 + kk) * LD + lane];
        const float* sw = S + kk * h + wy * RW;
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
    if (r < RW) emit(wy * RW + r, acc[r]);
}

// store(r, load(r)) for the rows r = wy, wy + NWARP, ... < n of a warp,
// eight loads in flight at a time.
template <class Load, class Store>
__device__ __forceinline__ void rows8(int n, int wy, Load load, Store store) {
  using V = decltype(load(0));
  for (int r0 = wy; r0 < n; r0 += 8 * NWARP) {
    V v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = r0 + u * NWARP;
      v[u] = r < n ? load(r) : V();
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = r0 + u * NWARP;
      if (r < n) store(r, v[u]);
    }
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

// select_place.cuh's place_block over the candidate offsets x = x0,
// x0 + NWARP, ... of a (w, d, h) block on the heightmap hm[k*TB] (a column
// of the tile's rows in shared memory): the best soft and hard lb
// candidates (key, stable; the key (l*W + x)*D + y gives l, x, y), or under
// MCS the best (class, exact score, key). The order is total, so the
// winners of the warps' shares combine (`place_join`) into place_block's.
struct PlacePart {
  int ks, ss, kh, cls;
  unsigned long long n, d;
};

template <bool MCS>
__device__ PlacePart place_part(const tapnet::EnvCfg& c, const int* hm,
                                int w, int d, int h,
                                const tapnet::ScoreCtx& sc, int x0) {
  const int W = c.W, D = c.D;
  PlacePart b{tapnet::BIG, 0, tapnet::BIG, 0, 0ull, 0ull};
  int cur_maxh = 0;
  if (MCS)
    for (int k = 0; k < W * D; ++k) cur_maxh = max(cur_maxh, hm[k * TB]);
  for (int x = x0; x + w <= W; x += NWARP) {
    for (int y = 0; y + d <= D; ++y) {
      int l = 0;
      for (int i = x; i < x + w; ++i)
        for (int j = y; j < y + d; ++j) l = max(l, hm[(i * D + j) * TB]);
      if (l + h > c.cap) continue;
      bool st = true;
      if (l > 0) {
        int imin = tapnet::BIG, imax = -tapnet::BIG;
        int jmin = tapnet::BIG, jmax = -tapnet::BIG;
        for (int i = x; i < x + w; ++i)
          for (int j = y; j < y + d; ++j)
            if (hm[(i * D + j) * TB] == l) {
              imin = min(imin, i);
              imax = max(imax, i);
              jmin = min(jmin, j);
              jmax = max(jmax, j);
            }
        const int cx2 = 2 * x + w - 1, cy2 = 2 * y + d - 1;
        st = 2 * imin <= cx2 && cx2 <= 2 * imax && 2 * jmin <= cy2 &&
             cy2 <= 2 * jmax;
      }
      const int key = (l * W + x) * D + y;
      if (MCS) {
        int fpsum = 0;
        for (int i = x; i < x + w; ++i)
          for (int j = y; j < y + d; ++j) fpsum += hm[(i * D + j) * TB];
        const int top = l + h;
        unsigned long long n, dn;
        tapnet::mcs_fraction(c.terms, sc.vol + w * d * h,
                             sc.denc + W * D * (max(cur_maxh, top) - cur_maxh),
                             sc.denp + w * d * top - fpsum, sc.snum + (int)st,
                             sc.sden + 1, n, dn);
        const int cls = 1 + (c.hard && st);
        bool gt, eq;
        tapnet::frac_cmp(n, dn, b.n, b.d, gt, eq);
        if (cls > b.cls || (cls == b.cls && (gt || (eq && key < b.ks))))
          b = PlacePart{key, st, tapnet::BIG, cls, n, dn};
      } else {
        if (key < b.ks) {
          b.ks = key;
          b.ss = st;
        }
        if (st && key < b.kh) b.kh = key;
      }
    }
  }
  return b;
}

// Whether partial winner q beats the running winner b (place_part's
// order); the soft and hard lb candidates are taken apart.
template <bool MCS>
__device__ void place_join(PlacePart& b, const PlacePart& q) {
  if (MCS) {
    if (q.ks >= tapnet::BIG) return;
    bool gt, eq;
    tapnet::frac_cmp(q.n, q.d, b.n, b.d, gt, eq);
    if (q.cls > b.cls || (q.cls == b.cls && (gt || (eq && q.ks < b.ks))))
      b = q;
  } else {
    if (q.ks < b.ks) {
      b.ks = q.ks;
      b.ss = q.ss;
    }
    if (q.kh < b.kh) b.kh = q.kh;
  }
}

template <bool MCS, bool WIDE, bool LOGITS>
__global__ void __launch_bounds__(NT)
actor_step_kernel(tapnet::EnvCfg c, tapnet::StepIO io, ActorIO ai, HeadW hw,
                  int B, int h, float inv_s, float temperature, int window) {
  using Word = std::conditional_t<WIDE, unsigned long long, unsigned>;
  extern __shared__ __align__(16) float smem[];
  const int N = c.N, R = c.R, C = c.C, WD = c.W * c.D;
  const int T = N * R, A = T * C, FQ = 3 * h + 8, NL = (N + 30) / 31;
  const int RPL = h / 32;
  const int lane = threadIdx.x, wy = threadIdx.y, tid = wy * TB + lane;
  const int tile0 = blockIdx.x * TB;
  const int b = tile0 + lane;
  const bool active = b < B;
  const int bb = active ? b : 0;  // clamped index for loads
  const Lay L = layout(N, R, C, WD, h);

  float* Ws = smem + L.ws;  // Ws[k*h + j] = Wp[j, k]
  float* W8s = smem + L.w8;
  float* b8s = smem + L.b8;
  float* vs = smem + L.v;
  float* qs = smem + L.q;     // [C][h][LD]
  float* sc = smem + L.sc;    // [A][TB]
  float* feats = smem + L.enc;        // [WD+2][LD]
  float* e1 = feats + (WD + 2) * LD;  // [h][LD]
  float* qin = e1 + h * LD;           // [3h+8][LD]: enc, ctx, prev, dsum
  float* stg = smem + L.tok;          // staged weight slices
  float* x8 = smem + L.tok;           // [8][G]
  float* h1 = x8 + 8 * G;             // [32][G]
  int* ib = (int*)(smem + L.floats);
  // [6][TB] words: packed, acc0, accr, win, fits of rotation 0 and 1
  Word* wb = reinterpret_cast<Word*>(ib);
  unsigned* tw = (unsigned*)(ib + 12 * TB);  // [TOKW][TB] token bits
  int* off = (int*)(tw + TOKW * TB);        // [TB+1] column offsets
  int* flag = off + TB + 1;                 // the tile has a column
  int* cols = flag + 1;                     // [TB*T]: t << 5 | lane

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
    rows8(nr, wy, [&](int j) {
      if (j < N) return active ? io.packed[j * B + b] : 1;
      j -= N;
      if (j < NL * N) return ai.upm[(size_t)j * B + bb];
      j -= NL * N;
      if (j < NL * N) return ai.rotm[(size_t)j * B + bb];
      return ai.fits[(size_t)(j - NL * N) * B + bb];
    }, [&](int j, int v) { pkS[j * TB + lane] = v; });
    const int idx = min(max((active ? ai.prev[b] : -1) + 1, 0), A);
    rows8(2 * h, wy, [&](int j) {
      return j < h ? ai.ctx[(size_t)j * B + bb]
                   : __ldg(hw.et + (size_t)(j - h) * (A + 1) + idx);
    }, [&](int j, float v) { qin[(h + j) * LD + lane] = v; });
    {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {  // Wp^T: 32 h <= 8 NT elements
        const int e = tid + u * NT, k = e / h, j = e - k * h;
        v[u] = e < 32 * h ? __ldg(hw.wpt + j * 32 + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (tid + u * NT < 32 * h) Ws[tid + u * NT] = v[u];
    }
    if (tid < 256) W8s[tid] = __ldg(hw.w8t + tid);
    if (tid < 32) b8s[tid] = __ldg(hw.b8 + tid);
    if (tid < h) vs[tid] = __ldg(hw.v + tid);
    if (wy == 0)
      for (int k = 1; k < 6; ++k) wb[k * TB + lane] = 0;
    __syncthreads();
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
      const float fpk = (float)popw(pk), fa0 = (float)popw(a0m);
      const float far = (float)popw(arm);
      const float acc_mean = R == 2 ? (fa0 + far) / (float)T : fa0 / (float)N;
      float* ds = qin + 3 * h * LD;
      ds[0 * LD + lane] = fpk / (float)N;
      ds[1 * LD + lane] = acc_mean;
      ds[2 * LD + lane] = (float)popw(wnm) / (float)N;
      ds[3 * LD + lane] = tf;
      for (int k = 0; k < 4; ++k)
        ds[(4 + k) * LD + lane] = ai.statm[(size_t)k * B + bb];
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

  if (*flag) {
    // ---- phase 1: heightmap encoder and query, per container
    for (int cc = 0; cc < C; ++cc) {
      for (int k = wy; k < WD; k += NWARP)
        feats[k * LD + lane] = (float)io.hm[(cc * WD + k) * B + bb] * inv_s;
      __syncthreads();
      if (wy == 0) {
        float mx = feats[lane], sm = 0.f;
        for (int k = 0; k < WD; ++k) {
          mx = fmaxf(mx, feats[k * LD + lane]);
          sm += feats[k * LD + lane];
        }
        feats[WD * LD + lane] = mx;
        feats[(WD + 1) * LD + lane] = sm / (float)WD;
      }
      __syncthreads();
      mv_tiled(hw.w1T, h, WD + 2, feats, stg, lane, wy, tid,
               [&](int j, float acc) {
        e1[j * LD + lane] = fmaxf(acc + __ldg(hw.b1 + j), 0.f);
      });
      __syncthreads();
      mv_tiled(hw.w2T, h, h, e1, stg, lane, wy, tid, [&](int j, float acc) {
        qin[j * LD + lane] = acc + __ldg(hw.b2 + j);
      });
      __syncthreads();
      float* qc = qs + cc * h * LD;
      mv_tiled(hw.wqT, h, FQ, qin, stg, lane, wy, tid, [&](int j, float acc) {
        qc[j * LD + lane] = acc + __ldg(hw.bq + j);
      });
      __syncthreads();
    }

    // ---- phase 2: the token work over the tile's columns, groups of G
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
        const float* sep = ai.se + ((size_t)(tile0 + l) * T + t) * h;
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          sev[i][r] = (r < RPL && cc < ng) ? sep[lane + 32 * r] : 0.f;
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
          f[3] = tf;
          for (int m = 0; m < 4; ++m)
            f[4 + m] = ai.statp[((size_t)m * T + t) * B + tile0 + l];
        }
        for (int m = 0; m < 8; ++m) x8[m * G + tid] = f[m];
      }
      __syncthreads();
      {
        const int m = tid >> 4, c4 = (tid & 15) * 4;  // 32 rows x 16 quads
        for (int i = 0; i < 4; ++i) {
          float acc = 0.f;
          for (int f = 0; f < 8; ++f)
            acc = fmaf(W8s[m * 8 + f], x8[f * G + c4 + i], acc);
          h1[m * G + c4 + i] = fmaxf(acc + b8s[m], 0.f);
        }
      }
      __syncthreads();
      // dyn = Wp h1 for this warp's CPW columns, rows lane + 32 r
      float dyn[CPW][MAXR];
#pragma unroll
      for (int i = 0; i < CPW; ++i)
#pragma unroll
        for (int r = 0; r < MAXR; ++r) dyn[i][r] = 0.f;
      for (int k = 0; k < 32; ++k) {
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
      }
      // the attention epilogue: a column's score per container, a warp sum
#pragma unroll
      for (int i = 0; i < CPW; ++i) {
        const int cc = wy * CPW + i;
        if (cc >= ng) break;  // warp-uniform
        const int e = cols[g0 + cc], l = e & 31, t = e >> 5;
        for (int k = 0; k < C; ++k) {
          const float* qc = qs + k * h * LD;
          float ps = 0.f;
#pragma unroll
          for (int r = 0; r < MAXR; ++r) {
            if (r < RPL) {
              const int j = lane + 32 * r;
              const float sd = sev[i][r] + dyn[i][r];
              ps = fmaf(tanhf(sd + qc[j * LD + l]), vs[j], ps);
            }
          }
          ps = warp_sum(ps);
          if (lane == 0) sc[(t * C + k) * TB + l] = ps;
        }
      }
    }
  }
  __syncthreads();

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
    rows8(A, wy, [&](int a) {
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
    rows8(C * WD + 3 * N, wy, [&](int j) {
      if (j < C * WD) return io.hm[j * B + b];
      j -= C * WD;
      return j < N ? io.dims_w[j * B + b]
           : j < 2 * N ? io.dims_d[(j - N) * B + b]
                       : io.dims_h[(j - 2 * N) * B + b];
    }, [&](int j, int v) { hmS[j * TB + lane] = v; });
  }
  __syncthreads();
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
  // the placement: every warp a share of the candidate offsets
  if (active) {
    const int cs = dec[TB + lane], w = dec[3 * TB + lane];
    const int d = dec[4 * TB + lane], hb = dec[5 * TB + lane];
    tapnet::ScoreCtx s{0, 0, 0, 0, 0};
    if (MCS)
      s = tapnet::ScoreCtx{dec[7 * TB + lane], dec[8 * TB + lane],
                           dec[9 * TB + lane], dec[10 * TB + lane],
                           dec[11 * TB + lane]};
    const PlacePart q =
        place_part<MCS>(c, hmS + cs * WD * TB + lane, w, d, hb, s, wy);
    const int pv[8] = {q.ks, q.ss, q.kh, q.cls, (int)(unsigned)q.n,
                       (int)(unsigned)(q.n >> 32), (int)(unsigned)q.d,
                       (int)(unsigned)(q.d >> 32)};
    for (int k = 0; k < 8; ++k) ppl[(k * NWARP + wy) * TB + lane] = pv[k];
  }
  __syncthreads();
  if (wy == 0 && active) {
    PlacePart pb{tapnet::BIG, 0, tapnet::BIG, 0, 0ull, 0ull};
    for (int w = 0; w < NWARP; ++w) {
      int pv[8];
      for (int k = 0; k < 8; ++k) pv[k] = ppl[(k * NWARP + w) * TB + lane];
      const PlacePart q{pv[0], pv[1], pv[2], pv[3],
                        (unsigned long long)(unsigned)pv[4] |
                            (unsigned long long)(unsigned)pv[5] << 32,
                        (unsigned long long)(unsigned)pv[6] |
                            (unsigned long long)(unsigned)pv[7] << 32};
      place_join<MCS>(pb, q);
    }
    // place_block's result: the hard variant prefers the stable candidate
    const bool hard = !MCS && c.hard && pb.kh < tapnet::BIG;
    const int key = hard ? pb.kh : pb.ks, W = c.W, D = c.D;
    const int valid = dec[6 * TB + lane];
    const int pv[6] = {(key / D) % W, key % D, key / (W * D), hard || pb.ss,
                       key / (W * D) + dec[5 * TB + lane],
                       valid && pb.ks < tapnet::BIG};
    if (pb.ks >= tapnet::BIG) {  // no candidate: place_block's zeros
      for (int k = 0; k < 4; ++k) dec[(7 + k) * TB + lane] = 0;
      dec[11 * TB + lane] = dec[5 * TB + lane];
    } else {
      for (int k = 0; k < 5; ++k) dec[(7 + k) * TB + lane] = pv[k];
    }
    dec[12 * TB + lane] = pv[5];
  }
  __syncthreads();
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
    rows8(N + N * 6, wy, [&](int k) {
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
// smem_bytes mirrors it).
static size_t smem_bytes(int N, int R, int C, int WD, int h) {
  return 4 * (size_t)(layout(N, R, C, WD, h).floats + n_ints(N, R));
}

using KernelFn = void (*)(tapnet::EnvCfg, tapnet::StepIO, ActorIO, HeadW,
                         int, int, float, float, int);

template <bool MCS, bool WIDE>
static KernelFn pick(bool logits) {
  if (logits) return actor_step_kernel<MCS, WIDE, true>;
  return actor_step_kernel<MCS, WIDE, false>;
}

// ptrs: packed, hm, plc, dims_w, dims_d, dims_h,                       (0-5)
//       tf, prev, upm, rotm, fits, g, se [B, T, h], ctx, statp, statm, (6-15)
//       w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v,                (16-26)
//       packed_o, hm_o, plc_o, act_o, flags_o, mask_o, logits_o, logp_o (27-34)
//       w1t^T, w2t^T, wqt^T                                            (35-37)
// ints: B, the EnvCfg fields (select_place.cuh env_cfg), h, window, logits
// (1: the full mode, logits_o written; 0: live columns, logits_o unused).
// h: a multiple of 32, at most 128. Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int tapnet_actor_select_step(void* const* p, const int* ints,
                                        float inv_s, float temperature,
                                        void* stream) {
  const int B = ints[0], h = ints[1 + tapnet::ENV_INTS];
  const int window = ints[2 + tapnet::ENV_INTS];
  const bool logits = ints[3 + tapnet::ENV_INTS] != 0;
  const tapnet::EnvCfg c = tapnet::env_cfg(ints + 1);
  if (c.N > MAX_N || c.C > MAX_C || c.W * c.D > tapnet::MAX_WD ||
      h % 32 != 0 || h <= 0 || h > 32 * MAXR || B <= 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)c.N * c.R * h * B >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const bool wide = window > 0 || c.N > 31;
  const tapnet::StepIO io{
      (const int*)p[0], (const int*)p[1], (const int*)p[2],
      (const int*)p[3], (const int*)p[4], (const int*)p[5],
      (int*)p[27],      (int*)p[28],      (int*)p[29],      (int*)p[30]};
  const ActorIO ai{(const float*)p[6],  (const int*)p[7],
                   (const int*)p[8],    (const int*)p[9],
                   (const int*)p[10],   (const float*)p[11],
                   (const float*)p[12], (const float*)p[13],
                   (const float*)p[14], (const float*)p[15],
                   (int*)p[31],         (int*)p[32],
                   (float*)p[33],       (float*)p[34]};
  const HeadW hw{(const float*)p[16], (const float*)p[17], (const float*)p[18],
                 (const float*)p[19], (const float*)p[20], (const float*)p[21],
                 (const float*)p[22], (const float*)p[23], (const float*)p[24],
                 (const float*)p[25], (const float*)p[26], (const float*)p[35],
                 (const float*)p[36], (const float*)p[37]};
  const size_t smem = smem_bytes(c.N, c.R, c.C, c.W * c.D, h);
  const KernelFn kernel = wide ? (c.mcs ? pick<true, true>(logits)
                              : pick<false, true>(logits))
                     : (c.mcs ? pick<true, false>(logits)
                              : pick<false, false>(logits));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TB, NWARP);
  kernel<<<(B + TB - 1) / TB, block, smem, (cudaStream_t)stream>>>(
      c, io, ai, hw, B, h, inv_s, temperature, window);
  return (int)cudaGetLastError();
}
