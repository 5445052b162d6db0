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
// Design (SIMT, f32 fused multiply-adds throughout; no TF32, no approximate
// intrinsics):
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
//   h must be a multiple of 32, at most 128.
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
// The head's device code is a copy of actor_step.cu's, not a shared header:
// the layouts differ, and K2's results stay as they were.
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int TB = 32;      // instances per block
constexpr int LD = TB + 1;  // padded row stride of [feature][lane] arrays
constexpr int NWARP = 16;   // warps per block
constexpr int NT = TB * NWARP;
constexpr int CPW = 4;            // columns per warp in a token group
constexpr int G = CPW * NWARP;    // columns per token group
constexpr int MAXR = 4;           // rows per lane: h <= 32 * MAXR
constexpr int KS = 64;     // k rows of a transposed weight slice (mv_tiled)
constexpr int JS = 32;     // j rows of a weight slice (mvt_tiled)
constexpr int MAX_C = 4;
constexpr int MAX_N_MONO = 31;   // monolithic: one 32-bit word per block set
constexpr int MAX_N_STEPS = 62;  // step-grid: 64-bit words
constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

struct Dims {
  int B, N, W, D, R, C, h;
};

struct HeadW {
  const float *w8t, *b8, *wpt, *w1t, *b1, *w2t, *b2, *et, *wqt, *bq, *v;
  const float *w1T, *w2T, *wqT;  // W1, W2, Wq transposed: [in][h]
};

struct ReplayIn {
  const int* flags;    // [S, N, B]
  const int* hms;      // [S, C*W*D, B]
  const int* masks;    // [S, A, B]
  const int* acts;     // [S, B]
  const int* prev;     // [S, B], acts shifted by a step (step-grid only)
  const float* se;     // [B, T, h]
  const float* ctx;    // [h, B]
  const float* statp;  // [4, T, B]
  const float* statm;  // [4, B]
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
// aligned); the ints follow the floats.
struct Lay {
  int ws, w8, b8, v, q, dq, sc, enc, tok, floats;
};

__host__ __device__ inline Lay layout(const Dims& d, bool bwd) {
  const int h = d.h, T = d.N * d.R, WD = d.W * d.D, FQ = 3 * h + 8;
  Lay L;
  int o = 0;
  L.ws = o;  o += up4(32 * h);        // Wp^T [32][h]
  L.w8 = o;  o += 32 * 8;             // W8 [32][8]
  L.b8 = o;  o += 32;
  L.v = o;   o += up4(h);
  L.q = o;   o += up4(h * LD);        // q_c [h][LD]
  L.dq = o;  o += bwd ? up4(h * LD) : 0;
  L.sc = o;  o += up4(TB * T * d.C);  // scores, then g, [column][C]
  // encoder view: feats [WD+2][LD], e1 [h][LD], qin [3h+8][LD], d_prev
  L.enc = o; o += up4((WD + 2 + h + FQ + (bwd ? h : 0)) * LD);
  // token view: x8 [8][G], h1 [32][G]; backward d_dyn [G][h+4], dh1 [32][G]
  // (and the staged weight slices of the encoder/query products)
  const int tok = 8 * G + 32 * G + (bwd ? G * (h + 4) + 32 * G : 0);
  // (and phase 0's flag rows and live bits)
  const int stage = KS * h > (d.N + T) * TB ? KS * h : (d.N + T) * TB;
  L.tok = o; o += tok > stage ? tok : stage;
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

// out[j] = sum_k W[j, k] x[k][lane] for every row j < h (a warp owns the
// h/16 rows wy*h/16 ..): W given transposed, WT [cols][h]; slices of KS of
// its rows are staged in shared memory S and read as float2 broadcasts, so
// one load of x feeds h/16 multiply-adds. emit(j, acc) stores row j. The
// caller follows with a barrier before S or the outputs are reused.
template <class Emit>
__device__ void mv_tiled(const float* __restrict__ WT, int h, int cols,
                         const float* x, float* S, int lane, int wy, int tid,
                         Emit emit) {
  const int RW = h / NWARP;  // 2 (h = 32) .. 8 (h = 128)
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < cols; k0 += KS) {
    const int nk = min(KS, cols - k0);
    __syncthreads();  // S is free
    const float4* src = reinterpret_cast<const float4*>(WT + (size_t)k0 * h);
    float4* dst = reinterpret_cast<float4*>(S);
    for (int e = tid; e < nk * h / 4; e += NT) dst[e] = __ldg(src + e);
    __syncthreads();
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
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (r < RW) emit(wy * RW + r, acc[r]);
}

// out[k] = sum_j W[j, k] g[j][lane] for every k < cols (a multiple of 32;
// a warp owns cols/16 <= MAXCW of them), W row-major with `ld` columns:
// slices of JS rows are staged in S (JS * cols floats: the backward's
// token view holds them), one load of g feeds cols/16 multiply-adds.
template <int MAXCW, class Emit>
__device__ void mvt_tiled(const float* __restrict__ Wm, int rows, int cols,
                          int ld, const float* g, float* S, int lane, int wy,
                          int tid, Emit emit) {
  const int CW = cols / NWARP;
  float acc[MAXCW];
#pragma unroll
  for (int c = 0; c < MAXCW; ++c) acc[c] = 0.f;
  for (int j0 = 0; j0 < rows; j0 += JS) {
    const int nj = min(JS, rows - j0);
    __syncthreads();  // S is free
    for (int e = tid; e < nj * cols; e += NT) {
      const int jj = e / cols, k = e - jj * cols;
      S[e] = __ldg(Wm + (size_t)(j0 + jj) * ld + k);
    }
    __syncthreads();
    for (int jj = 0; jj < nj; ++jj) {
      const float gv = g[(j0 + jj) * LD + lane];
      const float* sw = S + jj * cols + wy * CW;
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
    if (c < CW) emit(wy * CW + c, acc[c]);
}

// dst[j*cols + m] += sum_l A[j][l] Bm[m][l] over the block's lanes, for
// j < h and m < cols. Whole passes of 128 columns: a thread owns rows
// wy*h/16 .. and the columns m0 + lane + 32 i (i < 4), so one load of Bm
// feeds h/16 multiply-adds and one of A (a broadcast) four; the last
// cols % 128 columns: one element per thread at a time. Every element has
// the same owner at every call, and each sum runs over l in order.
__device__ void outer_tiled(float* dst, const float* A, const float* Bm,
                            int h, int cols, int lane, int wy, int tid) {
  const int RW = h / NWARP;
  const int full = cols & ~127;
  for (int m0 = 0; m0 < full; m0 += 128) {
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
    for (int l = 0; l < TB; ++l) {
      float bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = Bm[(m0 + lane + 32 * i) * LD + l];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r < RW) {
          const float a = A[(wy * RW + r) * LD + l];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(a, bv[i], acc[r][i]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r < RW) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dst[(size_t)(wy * RW + r) * cols + m0 + lane + 32 * i] += acc[r][i];
      }
    }
  }
  const int rem = cols - full;
  for (int e = tid; e < h * rem; e += NT) {
    const int j = e / rem, m = full + e - j * rem;
    const float* a = A + j * LD;
    const float* bm = Bm + m * LD;
    float acc = 0.f;
#pragma unroll 8
    for (int l = 0; l < TB; ++l) acc = fmaf(a[l], bm[l], acc);
    dst[(size_t)j * cols + m] += acc;
  }
}

// dst[j] += sum_l A[j*lda + l]
__device__ void rowsum_acc(float* dst, const float* A, int lda, int rows,
                           int tid) {
  for (int j = tid; j < rows; j += NT) {
    float acc = 0.f;
    for (int l = 0; l < TB; ++l) acc += A[(size_t)j * lda + l];
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

// STEPS: the step-grid schedule; blockIdx.y is the step chunk and `len` the
// steps per chunk. Monolithic: one chunk of all S steps. The backward
// writes d_se into `dse_o` [chunks, B, T, h] (zeroed here) and d_ctx into
// `dctx_o` (its chunk's [h, B], zeroed here).
template <bool BWD, bool STEPS>
__global__ void __launch_bounds__(NT)
replay_kernel(Dims d, ReplayIn in, HeadW w, float inv_s, float temperature,
              float inv_temp, float* logp_o, float* dse_o, float* dctx_o,
              float* part_o, int len) {
  using Word = std::conditional_t<STEPS, unsigned long long, int>;
  extern __shared__ __align__(16) float smem[];
  const int N = d.N, R = d.R, C = d.C, h = d.h, B = d.B;
  const int WD = d.W * d.D, T = N * R, A = T * C, FQ = 3 * h + 8, S = N;
  const int HP = h + 4, RPL = h / 32;
  const int lane = threadIdx.x, wy = threadIdx.y, tid = wy * TB + lane;
  const int tile0 = blockIdx.x * TB;
  const int b = tile0 + lane;
  const bool active = b < B;
  const int bb = active ? b : 0;  // clamped index for loads
  const GOff go = goff(d);
  const Lay L = layout(d, BWD);
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
  float* qs = smem + L.q;    // [h][LD]
  float* dqs = smem + L.dq;  // [h][LD] (bwd)
  float* sc = smem + L.sc;   // [column][C]
  float* feats = smem + L.enc;        // [WD+2][LD]
  float* e1 = feats + (WD + 2) * LD;  // [h][LD]; de1 in place (bwd)
  float* qin = e1 + h * LD;           // [3h+8][LD]: enc, ctx, prev, dsum
  float* d_prev = qin + FQ * LD;      // [h][LD] (bwd)
  float* d_hm = qin;                  // enc rows, after the Wq product
  float* stg = smem + L.tok;          // staged weight slices
  float* x8 = smem + L.tok;           // [8][G]
  float* h1 = x8 + 8 * G;             // [32][G]
  float* DD = h1 + 32 * G;            // [G][HP] d_dyn (bwd)
  float* DH1 = DD + G * HP;           // [32][G] (bwd)
  int* ib = (int*)(smem + L.floats);
  Word* wb = reinterpret_cast<Word*>(ib);  // [4][TB] words
  // [4][TB]: prev row, act, the next lane with the same prev row (-1),
  // whether no earlier lane has it
  int* ia = ib + (STEPS ? 8 : 4) * TB;
  int* off = ia + 4 * TB;                  // [TB+1] column offsets
  int* flag = off + TB + 1;                // the tile has an action
  int* cols = flag + 1;                    // [TB*T]: t << 5 | lane
  float* prow = BWD ? part_o + ((size_t)blockIdx.x * (STEPS ? gridDim.y : 1)
                                + chunk) * go.P
                    : nullptr;

  for (int e = tid; e < 32 * h; e += NT) {
    const int k = e / h, j = e - k * h;
    Ws[e] = __ldg(w.wpt + j * 32 + k);
  }
  for (int e = tid; e < 256; e += NT) W8s[e] = __ldg(w.w8t + e);
  if (tid < 32) b8s[tid] = __ldg(w.b8 + tid);
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
  __syncthreads();

  // shared rows of qin: ctx, the previous action's embedding, dsum
  auto fill_qin = [&](int k) {
    const int idx = ia[lane];
    for (int j = wy; j < h; j += NWARP) {
      qin[(h + j) * LD + lane] = in.ctx[(size_t)j * B + bb];
      qin[(2 * h + j) * LD + lane] = __ldg(w.et + (size_t)j * (A + 1) + idx);
    }
    if (wy == 0) {
      const float fpk = (float)popw(wb[lane]);
      const float fa0 = (float)popw(wb[TB + lane]);
      const float far = (float)popw(wb[2 * TB + lane]);
      const float fwn = (float)popw(wb[3 * TB + lane]);
      float* ds = qin + 3 * h * LD;
      ds[0 * LD + lane] = fpk / (float)N;
      ds[1 * LD + lane] = R == 2 ? (fa0 + far) / (float)T : fa0 / (float)N;
      ds[2 * LD + lane] = fwn / (float)N;
      ds[3 * LD + lane] = (float)k / (float)S;
      for (int r = 0; r < 4; ++r)
        ds[(4 + r) * LD + lane] = in.statm[(size_t)r * B + bb];
    }
  };

  // feats -> e1 -> enc (qin rows 0..h) of container c at step k; ends in a
  // barrier
  auto encode = [&](int k, int c) {
    const int* hk = in.hms + ((size_t)k * C * WD + (size_t)c * WD) * B;
    for (int x = wy; x < WD; x += NWARP)
      feats[x * LD + lane] = (float)hk[(size_t)x * B + bb] * inv_s;
    __syncthreads();
    if (wy == 0) {
      float mx = feats[lane], sm = 0.f;
      for (int x = 0; x < WD; ++x) {
        mx = fmaxf(mx, feats[x * LD + lane]);
        sm += feats[x * LD + lane];
      }
      feats[WD * LD + lane] = mx;
      feats[(WD + 1) * LD + lane] = sm / (float)WD;
    }
    __syncthreads();
    mv_tiled(w.w1T, h, WD + 2, feats, stg, lane, wy, tid,
             [&](int j, float acc) {
      e1[j * LD + lane] = fmaxf(acc + __ldg(w.b1 + j), 0.f);
    });
    __syncthreads();
    mv_tiled(w.w2T, h, h, e1, stg, lane, wy, tid, [&](int j, float acc) {
      qin[j * LD + lane] = acc + __ldg(w.b2 + j);
    });
    __syncthreads();
  };

  // q_c = Wq qin + bq into qs; ends in a barrier
  auto query = [&]() {
    mv_tiled(w.wqT, h, FQ, qin, stg, lane, wy, tid, [&](int j, float acc) {
      qs[j * LD + lane] = acc + __ldg(w.bq + j);
    });
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
        f[3] = (float)k / (float)S;
        for (int m = 0; m < 4; ++m)
          f[4 + m] = in.statp[((size_t)m * T + t) * B + tile0 + l];
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
  };

  // dyn = Wp h1 for this warp's CPW columns, rows lane + 32 r
  auto group_dyn = [&](float (&dyn)[CPW][MAXR]) {
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
  };

  // se rows of this warp's columns of a group, loaded before the group's
  // barriers so that their latency overlaps them
  auto group_se = [&](int g0, int ng, float (&sev)[CPW][MAXR]) {
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const int cc = wy * CPW + i;
      const int e = cols[g0 + min(cc, ng - 1)], l = e & 31, t = e >> 5;
      const float* sep = in.se + ((size_t)(tile0 + l) * T + t) * h;
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        sev[i][r] = (r < RPL && cc < ng) ? sep[lane + 32 * r] : 0.f;
    }
  };

  // forward over the step's columns for container c: sc[col*C + c]
  auto scores = [&](int k, int c, int n) {
    for (int g0 = 0; g0 < n; g0 += G) {
      const int ng = min(G, n - g0);
      float sev[CPW][MAXR];
      group_se(g0, ng, sev);
      group_h1(k, g0, ng);
      float dyn[CPW][MAXR];
      group_dyn(dyn);
#pragma unroll
      for (int i = 0; i < CPW; ++i) {
        const int cc = wy * CPW + i;
        if (cc >= ng) break;  // warp-uniform
        const int l = cols[g0 + cc] & 31;
        float ps = 0.f;
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < RPL) {
            const int j = lane + 32 * r;
            const float sd = sev[i][r] + dyn[i][r];
            ps = fmaf(tanhf(sd + qs[j * LD + l]), vs[j], ps);
          }
        }
        ps = warp_sum(ps);
        if (lane == 0) sc[(g0 + cc) * C + c] = ps;
      }
    }
    __syncthreads();
  };

  // backward over the step's columns for container c, from g in sc:
  // d_se, dq (into dqs), gWp, gW8, gb8, gv
  auto token_bwd = [&](int k, int c, int n) {
    for (int g0 = 0; g0 < n; g0 += G) {
      const int ng = min(G, n - g0);
      float sev[CPW][MAXR];
      group_se(g0, ng, sev);
      group_h1(k, g0, ng);
      float dyn[CPW][MAXR];
      group_dyn(dyn);
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
            const float sd = sev[i][r] + dyn[i][r];
            const float act = tanhf(sd + qs[j * LD + l]);
            dvr[r] = fmaf(act, ds, dvr[r]);
            const float dpre = (vs[j] * ds) * (1.f - act * act);
            ddc[j] = dpre;
            dsep[j] += dpre;
          }
        }
      }
      __syncthreads();
      // dq: per instance, its columns of this group in order
      for (int e = tid; e < h * TB; e += NT) {
        const int j = e / TB, l = e - j * TB;
        const int lo = max(off[l], g0) - g0;
        const int hi = min(off[l + 1], g0 + ng) - g0;
        if (hi > lo) {
          float s = 0.f;
          for (int cc = lo; cc < hi; ++cc) s += DD[cc * HP + j];
          dqs[j * LD + l] += s;
        }
      }
      {  // gWp += d_dyn h1^T
        const int m0 = 2 * wy;
        for (int cc = 0; cc < ng; ++cc) {
          const float ha = h1[m0 * G + cc], hb = h1[(m0 + 1) * G + cc];
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
      {  // dh1 = (Wp^T d_dyn) * (h1 > 0): column lane + 32 (wy & 1), rows
         // 4 (wy >> 1) .. + 3
        const int cc = lane + 32 * (wy & 1), m0 = 4 * (wy >> 1);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j < h; j += 4) {
          const float4 dv = *reinterpret_cast<const float4*>(DD + cc * HP + j);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            const float4 wv =
                *reinterpret_cast<const float4*>(Ws + (m0 + mi) * h + j);
            acc[mi] = fmaf(wv.x, dv.x, acc[mi]);
            acc[mi] = fmaf(wv.y, dv.y, acc[mi]);
            acc[mi] = fmaf(wv.z, dv.z, acc[mi]);
            acc[mi] = fmaf(wv.w, dv.w, acc[mi]);
          }
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int m = m0 + mi;
          DH1[m * G + cc] = h1[m * G + cc] > 0.f ? acc[mi] : 0.f;
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
        // lanes that share an embedding row: the next one, and the first
        int nxt = -1, head = 1;
        for (int m = 0; m < TB; ++m) {
          const int other = __shfl_sync(FULL, idx, m);
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
    if (!*flag) continue;  // no action in the tile: adds nothing
    const int n = off[TB];

    // ---- phases A, B: per container its query, then its scores
    fill_qin(k);
    for (int c = 0; c < C; ++c) {
      encode(k, c);
      query();
      scores(k, c, n);
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

    // ---- phases D, E: per container the token backward, then the query
    // and encoder backward (qin's shared rows are still in place)
    for (int j = wy; j < h; j += NWARP) d_prev[j * LD + lane] = 0.f;
    for (int c = 0; c < C; ++c) {
      if (C > 1) {  // C == 1: feats, e1, enc and q_0 are still in place
        encode(k, c);
        query();
      }
      for (int j = wy; j < h; j += NWARP) dqs[j * LD + lane] = 0.f;
      __syncthreads();
      token_bwd(k, c, n);
      outer_tiled(prow + go.wqt, dqs, qin, h, FQ, lane, wy, tid);
      rowsum_acc(prow + go.bq, dqs, LD, h, tid);
      mvt_tiled<24>(w.wqt, h, 3 * h, FQ, dqs, stg, lane, wy, tid,
                [&](int m, float acc) {
        if (m < h) {
          d_hm[m * LD + lane] = acc;  // qin's enc rows: read above, done
        } else if (m < 2 * h) {
          if (active) dctx_o[(size_t)(m - h) * B + b] += acc;
        } else {
          d_prev[(m - 2 * h) * LD + lane] += acc;
        }
      });
      __syncthreads();
      outer_tiled(prow + go.w2t, d_hm, e1, h, h, lane, wy, tid);
      rowsum_acc(prow + go.b2, d_hm, LD, h, tid);
      __syncthreads();
      mvt_tiled<8>(w.w2t, h, h, h, d_hm, stg, lane, wy, tid,
                [&](int m, float acc) {
        e1[m * LD + lane] = e1[m * LD + lane] > 0.f ? acc : 0.f;  // de1
      });
      __syncthreads();
      outer_tiled(prow + go.w1t, e1, feats, h, WD + 2, lane, wy, tid);
      rowsum_acc(prow + go.b1, e1, LD, h, tid);
      __syncthreads();
    }

    // ---- phase F: the previous-action embedding's gradient (one-hot): per
    // row j and embedding row a, the lanes with that row in lane order
    for (int e = tid; e < h * TB; e += NT) {
      const int j = e / TB, l = e - j * TB;
      if (ia[3 * TB + l]) {
        float acc = 0.f;
        for (int m = l; m >= 0; m = ia[2 * TB + m]) acc += d_prev[j * LD + m];
        prow[go.et + (size_t)j * (A + 1) + ia[l]] += acc;
      }
    }
    __syncthreads();
  }

  if (!BWD) {
    if (wy == 0 && active) logp_o[b] = lp_sum;
    return;
  }
  // the token-loop weight gradients: each element owned by one thread
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

// out[e] = sum over tiles, in tile order, of part[tile, e].
__global__ void reduce_tiles(const float* __restrict__ part, int tiles, int P,
                             float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P) return;
  float acc = 0.f;
  for (int t = 0; t < tiles; ++t) acc += part[(size_t)t * P + e];
  out[e] = acc;
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
// (bwd = 1) kernel, in bytes; the wrapper refuses configs above the limit.
static long long smem_bytes(const Dims& d, int bwd, bool steps) {
  return 4ll * (layout(d, bwd != 0).floats + n_ints(d, steps));
}

template <bool STEPS>
static int launch(int bwd, void* const* p, const Dims& d, int chunks,
                  float inv_s, float temperature, float inv_temp,
                  void* stream) {
  const ReplayIn in{(const int*)p[0],   (const int*)p[1],
                    (const int*)p[2],   (const int*)p[3],
                    (const int*)p[25],  (const float*)p[4],
                    (const float*)p[5], (const float*)p[6],
                    (const float*)p[7], (const float*)p[8]};
  const HeadW w{(const float*)p[9],  (const float*)p[10], (const float*)p[11],
                (const float*)p[12], (const float*)p[13], (const float*)p[14],
                (const float*)p[15], (const float*)p[16], (const float*)p[17],
                (const float*)p[18], (const float*)p[19], (const float*)p[29],
                (const float*)p[30], (const float*)p[31]};
  const size_t smem = (size_t)smem_bytes(d, bwd, STEPS);
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
    auto kernel = replay_kernel<false, STEPS>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    // one chunk writes logp itself; more write partials [nc, B] to p[26]
    float* lp = nc > 1 ? (float*)p[26] : (float*)p[20];
    kernel<<<grid, block, smem, st>>>(d, in, w, inv_s, temperature, inv_temp,
                                      lp, nullptr, nullptr, nullptr, len);
    err = cudaGetLastError();
    if (err != cudaSuccess || nc == 1) return (int)err;
    reduce_tiles<<<(d.B + 255) / 256, 256, 0, st>>>(lp, nc, d.B,
                                                    (float*)p[20]);
    return (int)cudaGetLastError();
  }
  auto kernel = replay_kernel<true, STEPS>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // d_se partials [nc, B, T, h] in p[27]; one chunk writes d_ctx itself,
  // more write partials [nc, h, B] to p[28]
  float* dctx = nc > 1 ? (float*)p[28] : (float*)p[22];
  kernel<<<grid, block, smem, st>>>(d, in, w, inv_s, temperature, inv_temp,
                                    nullptr, (float*)p[27], dctx,
                                    (float*)p[23], len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int P = goff(d).P;
  reduce_tiles<<<(P + 255) / 256, 256, 0, st>>>((const float*)p[23],
                                                tiles * nc, P, (float*)p[24]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int E = T * d.h;
  sum_transpose<<<dim3((E + 31) / 32, (d.B + 31) / 32), dim3(32, 8), 0, st>>>(
      (const float*)p[27], nc, d.B, E, (float*)p[21]);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 1) return (int)err;
  const int n_ctx = d.h * d.B;
  reduce_tiles<<<(n_ctx + 255) / 256, 256, 0, st>>>(dctx, nc, n_ctx,
                                                    (float*)p[22]);
  return (int)cudaGetLastError();
}

// ptrs: flags, hms, masks, acts, se [B, T, h], ctx, statp, statm, dlp (0-8)
//       w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v,              (9-19)
//       logp_o, dse_o, dctx_o, part, grads_o, prev, logp_part,       (20-26)
//       dse_part, dctx_part, w1t^T, w2t^T, wqt^T                     (27-31)
// ints: B, N, W, D, R, C, h, steps, chunks. Forward (bwd = 0) writes logp_o
// [B]; backward writes dse_o [T, h, B], dctx_o [h, B], part [rows, P] and
// grads_o [P], rows = tiles x chunks, through dse_part [chunks, B, T, h].
// steps = 0: the monolithic schedule (chunks ignored, prev unused); steps =
// 1: the step-grid schedule over `chunks` step chunks with prev [S, B] and,
// for more than one chunk, the partials logp_part [chunks, B] (forward) and
// dctx_part [chunks, h, B] (backward). h: a multiple of 32, at most 128.
// Launches on `stream`; returns the first CUDA error of the launches.
extern "C" int tapnet_replay_logp(int bwd, void* const* p, const int* ints,
                                  float inv_s, float temperature,
                                  float inv_temp, void* stream) {
  const Dims d{ints[0], ints[1], ints[2], ints[3], ints[4], ints[5], ints[6]};
  const int steps = ints[7], chunks = ints[8];
  if (d.N > (steps ? MAX_N_STEPS : MAX_N_MONO) || d.C > MAX_C || d.B <= 0 ||
      d.h % 32 != 0 || d.h <= 0 || d.h > 32 * MAXR ||
      (steps && (chunks < 1 || chunks > d.N)))
    return (int)cudaErrorInvalidValue;
  if ((long long)d.N * d.R * d.h * d.B >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  return steps ? launch<true>(bwd, p, d, chunks, inv_s, temperature, inv_temp,
                              stream)
               : launch<false>(bwd, p, d, 1, inv_s, temperature, inv_temp,
                               stream);
}
