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
// T*(32*8 + 32*h + C*h) multiply-adds (1.1e5 at 2d-basic, h = 128); the
// backward re-runs it (the encoder twice) and adds as many again for the
// weight gradients and most of that for the input gradients.
//
// Design (a simple kernel first; wgmma/TMA formulations come later):
// - one block per tile of TB = 32 instances, lane = instance, NWARP = 16
//   warps; every batch-last row is read coalesced. A loop over the S decode
//   steps inside the block takes the place of the TPU's unrolled steps.
// - matrix-vector products split their output rows over the warps; each
//   warp reads one weight row at a time through the read-only path (one
//   address per warp, a broadcast) against instance vectors in shared
//   memory, [feature][LD] with LD = 33 so that the weight-gradient
//   contractions below read without bank conflicts. The head weights
//   (~298 KB at h = 128) never sit in shared memory.
// - per-instance outputs (logp, d_se, d_ctx) are owned by one thread each
//   and accumulated over the steps in place.
// - weight gradients are sums over instances. Each block forms its tile's
//   partial of every weight gradient as contractions over its 32 lanes
//   (thread-owned output elements, a fixed order) and keeps them in its own
//   row of a [tiles, P] buffer (P = 74,400 floats at 2d-basic, h = 128);
//   the token-loop ones (Wp, W8, b8, v) live in shared memory until the end.
//   A second kernel sums the rows in tile order. No float atomics: two
//   launches give bit-identical outputs.
// - shared memory (floats, bwd): the scores/g [A][LD], the token-loop
//   gradients h*32 + 256 + 32 + h, and one union region reused by phase:
//   {feats, e1, qin, d_hm, de1, d_prev} for the encoder and query steps,
//   {x8, h1, d_dyn, dh1, partial scores} for the token loops: 141,048 B
//   at 2d-basic and h = 128, 152,136 B at multi-container (W*D = 64). The C
//   queries and their gradients ([C*h] per instance) live in a global
//   scratch [C*h, Bp] (L2-resident) so that shared memory does not grow
//   with C; configs above the 227 KB a block may hold are refused by the
//   wrapper. All sums are f32 multiply-adds, never TF32.
//
// Step-grid schedule (STEPS instantiations; rolling windows, N <= 62). The
// TPU ran a grid (batch tiles, S) in order and carried logp, d_se and d_ctx
// across the step axis and the weight gradients across the whole grid. CUDA
// blocks run in no order, so here the grid is (batch tiles, step chunks):
// block (i, j) walks steps [j*len, (j+1)*len) of tile i with the step body
// above and writes partials of its own: logp [chunks, B], d_se
// [chunks, T, h, B], d_ctx [chunks, h, B], one weight-gradient row per
// (tile, chunk); `reduce_tiles` then sums each over its rows in a fixed
// order (no atomics: two launches are bit-identical). The wrapper picks the
// number of chunks (enough blocks to fill the card, scratch kept small:
// a d_se partial is 210 MB per chunk at 2d-rolling, batch 4096, h = 128).
// Differences from the monolithic kernel: the bit words of a block set are
// 64-bit (flags of up to 62 blocks), the previous action arrives as its own
// operand `prev` [S, B] (a chunk's first step needs the step before it),
// and the per-block scratch of queries is per chunk as well.
//
// The head's device code is a copy of actor_step.cu's, not a shared header:
// the padded layout and the saved-activation buffers differ, and K2's
// results stay as they were.
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int TB = 32;      // instances per block
constexpr int LD = TB + 1;  // padded row stride of [feature][lane] arrays
constexpr int NWARP = 16;   // warps per block
constexpr int NT = TB * NWARP;
constexpr int MAX_C = 4;
constexpr int MAX_N_MONO = 31;   // monolithic: one 32-bit word per block set
constexpr int MAX_N_STEPS = 62;  // step-grid: 64-bit words
constexpr float NEG = -1e9f;

struct Dims {
  int B, N, W, D, R, C, h;
};

struct HeadW {
  const float *w8t, *b8, *wpt, *w1t, *b1, *w2t, *b2, *et, *wqt, *bq, *v;
};

struct ReplayIn {
  const int* flags;    // [S, N, B]
  const int* hms;      // [S, C*W*D, B]
  const int* masks;    // [S, A, B]
  const int* acts;     // [S, B]
  const int* prev;     // [S, B], acts shifted by a step (step-grid only)
  const float* se;     // [T, h, B]
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

__host__ __device__ inline int union_rows(const Dims& d, bool bwd) {
  const int h = d.h, WD = d.W * d.D, FQ = 3 * h + 8;
  const int enc = WD + 2 + h + FQ + (bwd ? 3 * h : 0);
  const int tok = 8 + 32 + h + 32 + NWARP * d.C;
  return enc > tok ? enc : tok;
}

__host__ __device__ inline int token_grad_floats(const Dims& d) {
  return d.h * 32 + 32 * 8 + 32 + d.h;
}

// out[j] = sum_k W[j, k] x[k] for the rows j this warp owns; x is
// [k][LD] in shared memory; emit(j, acc) stores row j.
template <class Emit>
__device__ void matvec(const float* __restrict__ Wm, int rows, int cols,
                       const float* x, int lane, int wy, Emit emit) {
  for (int j = wy; j < rows; j += NWARP) {
    const float* wr = Wm + (size_t)j * cols;
    float acc = 0.f;
    for (int k = 0; k < cols; ++k)
      acc = fmaf(__ldg(wr + k), x[k * LD + lane], acc);
    emit(j, acc);
  }
}

// out[k] = sum_j W[j, k] g[j*gld + lane] for k < cols this warp owns (W
// has `ld` columns, of which the first `cols` are used).
template <class Emit>
__device__ void matvec_t(const float* __restrict__ Wm, int rows, int cols,
                         int ld, const float* g, int gld, int lane, int wy,
                         Emit emit) {
  for (int k = wy; k < cols; k += NWARP) {
    float acc = 0.f;
    for (int j = 0; j < rows; ++j)
      acc = fmaf(__ldg(Wm + (size_t)j * ld + k), g[(size_t)j * gld + lane],
                 acc);
    emit(k, acc);
  }
}

// dst[j*cols + m] += sum_l A[j*lda + l] Bm[m][l] over the block's lanes,
// each element owned by thread e % NT (the same thread at every call).
__device__ void outer_acc(float* dst, const float* A, int lda,
                          const float* Bm, int rows, int cols, int tid) {
  const int n = rows * cols;
  for (int e = tid; e < n; e += NT) {
    const int j = e / cols, m = e - j * cols;
    const float* a = A + (size_t)j * lda;
    const float* b = Bm + m * LD;
    float acc = 0.f;
#pragma unroll 8
    for (int l = 0; l < TB; ++l) acc = fmaf(a[l], b[l], acc);
    dst[e] += acc;
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
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int popw(int x) { return __popc((unsigned)x); }
__device__ __forceinline__ int popw(unsigned long long x) {
  return __popcll(x);
}

// Shared-memory ints behind the float regions: four words per lane (packed,
// acc0, accr, win), the previous action's embedding row and the action.
__host__ __device__ inline int tail_ints(bool steps) {
  return (steps ? 8 : 4) * TB + 2 * TB;
}

// STEPS: the step-grid schedule; blockIdx.y is the step chunk and `len` the
// steps per chunk. Monolithic: one chunk of all S steps.
template <bool BWD, bool STEPS>
__global__ void __launch_bounds__(NT)
replay_kernel(Dims d, ReplayIn in, HeadW w, float inv_s, float temperature,
              float inv_temp, float* logp_o, float* dse_o, float* dctx_o,
              float* part_o, float* qg, float* dqg, int len) {
  using Word = std::conditional_t<STEPS, unsigned long long, int>;
  extern __shared__ float smem[];
  const int N = d.N, R = d.R, C = d.C, h = d.h, B = d.B;
  const int WD = d.W * d.D, T = N * R, A = T * C, FQ = 3 * h + 8, S = N;
  const int lane = threadIdx.x, wy = threadIdx.y, tid = wy * TB + lane;
  const int b = blockIdx.x * TB + lane;
  const bool active = b < B;
  const int bb = active ? b : 0;  // clamped index for loads
  const GOff go = goff(d);
  const int chunk = STEPS ? blockIdx.y : 0;
  const int k0 = STEPS ? chunk * len : 0;
  const int k1 = STEPS ? min(k0 + len, S) : S;
  // queries and their gradients, [C*h][Bp] in global scratch (L1/L2
  // resident), Bp = the batch padded to whole tiles; this block's columns
  // (of this chunk's slab)
  const size_t Bp = (size_t)gridDim.x * TB;
  const size_t slab = (size_t)chunk * C * h * Bp + (size_t)blockIdx.x * TB;
  float* q = qg + slab;
  float* dq = BWD ? dqg + slab : nullptr;
  if (STEPS) {  // this chunk's partial outputs
    if (BWD) {
      dse_o += (size_t)chunk * T * h * B;
      dctx_o += (size_t)chunk * h * B;
    } else {
      logp_o += (size_t)chunk * B;
    }
  }

  float* gs = smem;                                  // [A][LD]
  float* gW = gs + A * LD;                           // token-loop grads
  float* U = gW + (BWD ? token_grad_floats(d) : 0);  // union region
  int* ib = (int*)(U + union_rows(d, BWD) * LD);
  if (STEPS && ((ib - (int*)smem) & 1)) ++ib;        // 8-byte aligned words
  Word* wb = reinterpret_cast<Word*>(ib);            // [4][TB] words
  int* ia = ib + (STEPS ? 8 : 4) * TB;               // [2][TB]: prev row, act
  // encoder / query view of U
  float* feats = U;                   // [WD+2][LD]
  float* e1 = feats + (WD + 2) * LD;  // [h][LD]
  float* qin = e1 + h * LD;           // [3h+8][LD]: enc, ctx, prev, dsum
  float* d_hm = qin + FQ * LD;        // [h][LD] (bwd)
  float* de1 = d_hm + h * LD;         // [h][LD] (bwd)
  float* d_prev = de1 + h * LD;       // [h][LD] (bwd)
  // token view of U
  float* x8 = U;                      // [8][LD]
  float* h1 = x8 + 8 * LD;            // [32][LD]
  float* d_dyn = h1 + 32 * LD;        // [h][LD] (bwd)
  float* dh1 = d_dyn + h * LD;        // [32][LD] (bwd)
  float* part = dh1 + 32 * LD;        // [NWARP*C][LD]
  float* g_wp = gW;                   // [h*32]
  float* g_w8 = g_wp + h * 32;        // [32*8]
  float* g_b8 = g_w8 + 32 * 8;        // [32]
  float* g_v = g_b8 + 32;             // [h]
  float* prow = BWD ? part_o + ((size_t)blockIdx.x * (STEPS ? gridDim.y : 1)
                                + chunk) * go.P
                    : nullptr;

  if (BWD) {
    for (int e = tid; e < go.P; e += NT) prow[e] = 0.f;
    for (int e = tid; e < token_grad_floats(d); e += NT) gW[e] = 0.f;
  }
  const float dlp = (BWD && active) ? in.dlp[b] : 0.f;
  float lp_sum = 0.f;

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

  // feats -> e1 -> enc (qin rows 0..h) of container c at step k
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
    matvec(w.w1t, h, WD + 2, feats, lane, wy, [&](int j, float acc) {
      e1[j * LD + lane] = fmaxf(acc + __ldg(w.b1 + j), 0.f);
    });
    __syncthreads();
    matvec(w.w2t, h, h, e1, lane, wy, [&](int j, float acc) {
      qin[j * LD + lane] = acc + __ldg(w.b2 + j);
    });
    __syncthreads();
  };

  // x8 of token t at step k (warp 0), then h1 = relu(W8 x8 + b8)
  auto token_h1 = [&](int k, int t) {
    if (wy == 0) {
      const int i = t / R, r = t % R;
      x8[0 * LD + lane] = (float)((wb[lane] >> i) & 1);
      x8[1 * LD + lane] = (float)((wb[(r == 0 ? 1 : 2) * TB + lane] >> i) & 1);
      x8[2 * LD + lane] = (float)((wb[3 * TB + lane] >> i) & 1);
      x8[3 * LD + lane] = (float)k / (float)S;
      for (int m = 0; m < 4; ++m)
        x8[(4 + m) * LD + lane] = in.statp[((size_t)m * T + t) * B + bb];
    }
    __syncthreads();
    matvec(w.w8t, 32, 8, x8, lane, wy, [&](int j, float acc) {
      h1[j * LD + lane] = fmaxf(acc + __ldg(w.b8 + j), 0.f);
    });
    __syncthreads();
  };

  for (int k = k0; k < k1; ++k) {
    // ---- phase 0: flags -> bits (packed, acc0, accr, win), prev, action
    if (wy == 0) {
      Word pk = 0, a0 = 0, ar = 0, wn = 0;
      for (int i = 0; i < N; ++i) {
        const int f = in.flags[((size_t)k * N + i) * B + bb];
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
      ia[lane] = min(max(prev + 1, 0), A);
      ia[TB + lane] = active ? in.acts[(size_t)k * B + b] : -1;
    }
    __syncthreads();

    // ---- phase A: the C queries
    fill_qin(k);
    for (int c = 0; c < C; ++c) {
      encode(k, c);
      matvec(w.wqt, h, FQ, qin, lane, wy, [&](int j, float acc) {
        q[(c * h + j) * Bp + lane] = acc + __ldg(w.bq + j);
      });
      __syncthreads();
    }

    // ---- phase B: per token, dyn MLP + additive attention scores
    for (int t = 0; t < T; ++t) {
      token_h1(k, t);
      float ps[MAX_C] = {0.f, 0.f, 0.f, 0.f};
      const float* se_t = in.se + (size_t)t * h * B;
      matvec(w.wpt, h, 32, h1, lane, wy, [&](int j, float dyn) {
        const float sd = se_t[(size_t)j * B + bb] + dyn;
        const float vj = __ldg(w.v + j);
        for (int c = 0; c < C; ++c)
          ps[c] = fmaf(tanhf(sd + q[(c * h + j) * Bp + lane]), vj, ps[c]);
      });
      for (int c = 0; c < C; ++c) part[(wy * C + c) * LD + lane] = ps[c];
      __syncthreads();
      if (wy == 0) {
        for (int c = 0; c < C; ++c) {
          float s = 0.f;
          for (int v = 0; v < NWARP; ++v) s += part[(v * C + c) * LD + lane];
          gs[(t * C + c) * LD + lane] = s;
        }
      }
    }
    __syncthreads();

    // ---- phase C: log pi at the recorded action; the backward's g
    if (wy == 0) {
      const int* mk = in.masks + (size_t)k * A * B;
      float mx = NEG;
      for (int a = 0; a < A; ++a) {
        const float m = mk[(size_t)a * B + bb] == 1
                            ? gs[a * LD + lane] / temperature : NEG;
        gs[a * LD + lane] = m;
        mx = a == 0 ? m : fmaxf(mx, m);
      }
      float se = 0.f;
      for (int a = 0; a < A; ++a) se += expf(gs[a * LD + lane] - mx);
      const int act = ia[TB + lane];
      const float lp = (gs[max(act, 0) * LD + lane] - mx) - logf(se);
      lp_sum += act >= 0 ? lp : 0.f;
      if (BWD) {
        const float scale = act >= 0 ? dlp : 0.f;
        for (int a = 0; a < A; ++a) {
          const float p = expf(gs[a * LD + lane] - mx) / se;
          const float oh = a == act ? 1.f : 0.f;
          const float mf = mk[(size_t)a * B + bb] == 1 ? 1.f : 0.f;
          gs[a * LD + lane] = ((scale * (oh - p)) * mf) * inv_temp;
        }
      }
    }
    __syncthreads();
    if (!BWD) continue;

    // ---- phase D: token loop backward
    for (int c = 0; c < C; ++c)
      for (int j = wy; j < h; j += NWARP) dq[(c * h + j) * Bp + lane] = 0.f;
    for (int t = 0; t < T; ++t) {
      token_h1(k, t);
      const float* se_t = in.se + (size_t)t * h * B;
      float* dse_t = dse_o + (size_t)t * h * B;
      matvec(w.wpt, h, 32, h1, lane, wy, [&](int j, float dyn) {
        const float sd = se_t[(size_t)j * B + bb] + dyn;
        const float vj = __ldg(w.v + j);
        float dd = 0.f, dv = 0.f;
        for (int c = 0; c < C; ++c) {
          const float act = tanhf(sd + q[(c * h + j) * Bp + lane]);
          const float ds = gs[(t * C + c) * LD + lane];
          dv = fmaf(act, ds, dv);
          const float dpre = (vj * ds) * (1.f - act * act);
          dd += dpre;
          dq[(c * h + j) * Bp + lane] += dpre;
        }
        if (active) {
          float* p = dse_t + (size_t)j * B + b;
          *p = (k == k0 ? 0.f : *p) + dd;
        }
        d_dyn[j * LD + lane] = dd;
        dv = warp_sum(dv);
        if (lane == 0) g_v[j] += dv;
      });
      __syncthreads();
      outer_acc(g_wp, d_dyn, LD, h1, h, 32, tid);
      matvec_t(w.wpt, h, 32, 32, d_dyn, LD, lane, wy, [&](int m, float acc) {
        dh1[m * LD + lane] = h1[m * LD + lane] > 0.f ? acc : 0.f;
      });
      __syncthreads();
      outer_acc(g_w8, dh1, LD, x8, 32, 8, tid);
      rowsum_acc(g_b8, dh1, LD, 32, tid);
      __syncthreads();
    }

    // ---- phase E: query and encoder backward, per container
    fill_qin(k);
    for (int j = wy; j < h; j += NWARP) d_prev[j * LD + lane] = 0.f;
    for (int c = 0; c < C; ++c) {
      encode(k, c);  // ends in a barrier
      const float* dqc = dq + (size_t)c * h * Bp;
      outer_acc(prow + go.wqt, dqc, (int)Bp, qin, h, FQ, tid);
      rowsum_acc(prow + go.bq, dqc, (int)Bp, h, tid);
      matvec_t(w.wqt, h, 3 * h, FQ, dqc, (int)Bp, lane, wy,
               [&](int m, float acc) {
        if (m < h) {
          d_hm[m * LD + lane] = acc;
        } else if (m < 2 * h) {
          if (active) {
            float* p = dctx_o + (size_t)(m - h) * B + b;
            *p = (k == k0 && c == 0 ? 0.f : *p) + acc;
          }
        } else {
          d_prev[(m - 2 * h) * LD + lane] += acc;
        }
      });
      __syncthreads();
      outer_acc(prow + go.w2t, d_hm, LD, e1, h, h, tid);
      rowsum_acc(prow + go.b2, d_hm, LD, h, tid);
      matvec_t(w.w2t, h, h, h, d_hm, LD, lane, wy, [&](int m, float acc) {
        de1[m * LD + lane] = e1[m * LD + lane] > 0.f ? acc : 0.f;
      });
      __syncthreads();
      outer_acc(prow + go.w1t, de1, LD, feats, h, WD + 2, tid);
      rowsum_acc(prow + go.b1, de1, LD, h, tid);
      __syncthreads();
    }

    // ---- phase F: the previous-action embedding's gradient (one-hot)
    for (int e = tid; e < h * (A + 1); e += NT) {
      const int j = e / (A + 1), a = e - j * (A + 1);
      float acc = 0.f;
      for (int l = 0; l < TB; ++l)
        if (ia[l] == a) acc += d_prev[j * LD + l];
      prow[go.et + e] += acc;
    }
    __syncthreads();
  }

  if (!BWD) {
    if (wy == 0 && active) logp_o[b] = lp_sum;
    return;
  }
  __syncthreads();
  for (int e = tid; e < token_grad_floats(d); e += NT) {
    float* dst = e < h * 32 ? prow + go.wpt + e
               : e < h * 32 + 256 ? prow + go.w8t + (e - h * 32)
               : e < h * 32 + 288 ? prow + go.b8 + (e - h * 32 - 256)
               : prow + go.v + (e - h * 32 - 288);
    *dst = gW[e];
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

}  // namespace

// Dynamic shared memory of one block of the forward (bwd = 0) or backward
// (bwd = 1) kernel, in bytes; the wrapper refuses configs above the limit.
// The step-grid kernels hold 64-bit words (and a word of padding).
static long long smem_bytes(const Dims& d, int bwd, bool steps) {
  const int A = d.N * d.R * d.C;
  const long long rows = A + union_rows(d, bwd != 0);
  const long long floats = rows * LD + (bwd ? token_grad_floats(d) : 0);
  return 4 * (floats + tail_ints(steps) + (steps ? 1 : 0));
}

template <bool STEPS>
static int launch(int bwd, void* const* p, const Dims& d, int chunks,
                  float inv_s, float temperature, float inv_temp,
                  void* stream) {
  const ReplayIn in{(const int*)p[0],   (const int*)p[1],
                    (const int*)p[2],   (const int*)p[3],
                    (const int*)p[27],  (const float*)p[4],
                    (const float*)p[5], (const float*)p[6],
                    (const float*)p[7], (const float*)p[8]};
  const HeadW w{(const float*)p[9],  (const float*)p[10], (const float*)p[11],
                (const float*)p[12], (const float*)p[13], (const float*)p[14],
                (const float*)p[15], (const float*)p[16], (const float*)p[17],
                (const float*)p[18], (const float*)p[19]};
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
    // one chunk writes logp itself; more write partials [nc, B] to p[21]
    float* lp = nc > 1 ? (float*)p[21] : (float*)p[20];
    kernel<<<grid, block, smem, st>>>(d, in, w, inv_s, temperature, inv_temp,
                                      lp, nullptr, nullptr, nullptr,
                                      (float*)p[25], nullptr, len);
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
  // one chunk writes d_se and d_ctx itself; more write partials
  // [nc, T, h, B] to p[28] and [nc, h, B] to p[29]
  float* dse = nc > 1 ? (float*)p[28] : (float*)p[21];
  float* dctx = nc > 1 ? (float*)p[29] : (float*)p[22];
  kernel<<<grid, block, smem, st>>>(d, in, w, inv_s, temperature, inv_temp,
                                    nullptr, dse, dctx, (float*)p[23],
                                    (float*)p[25], (float*)p[26], len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int P = goff(d).P;
  reduce_tiles<<<(P + 255) / 256, 256, 0, st>>>((const float*)p[23],
                                                tiles * nc, P, (float*)p[24]);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 1) return (int)err;
  const long long n_se = (long long)T * d.h * d.B, n_ctx = (long long)d.h * d.B;
  reduce_tiles<<<(unsigned)((n_se + 255) / 256), 256, 0, st>>>(
      dse, nc, (int)n_se, (float*)p[21]);
  reduce_tiles<<<(unsigned)((n_ctx + 255) / 256), 256, 0, st>>>(
      dctx, nc, (int)n_ctx, (float*)p[22]);
  return (int)cudaGetLastError();
}

// ptrs: flags, hms, masks, acts, se, ctx, statp, statm, dlp,          (0-8)
//       w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v,              (9-19)
//       logp_o, dse_o, dctx_o, part, grads_o, q_scratch, dq_scratch, (20-26)
//       prev, dse_part, dctx_part                                    (27-29)
// ints: B, N, W, D, R, C, h, steps, chunks. Forward (bwd = 0) writes logp_o
// [B]; backward writes dse_o [T, h, B], dctx_o [h, B], part [rows, P] and
// grads_o [P], rows = tiles x chunks. The scratches are [chunks, C*h,
// tiles*32] floats (dq_scratch backward only). steps = 0: the monolithic
// schedule (chunks ignored, 27-29 unused, the forward's 21 unused);
// steps = 1: the step-grid schedule over `chunks` step chunks, with prev
// [S, B] and, for more than one chunk, the forward's partials [chunks, B] in
// slot 21 and the backward's in slots 28 and 29.
// Launches on `stream`; returns the first CUDA error of the launches.
extern "C" int tapnet_replay_logp(int bwd, void* const* p, const int* ints,
                                  float inv_s, float temperature,
                                  float inv_temp, void* stream) {
  const Dims d{ints[0], ints[1], ints[2], ints[3], ints[4], ints[5], ints[6]};
  const int steps = ints[7], chunks = ints[8];
  if (d.N > (steps ? MAX_N_STEPS : MAX_N_MONO) || d.C > MAX_C || d.B <= 0 ||
      (steps && (chunks < 1 || chunks > d.N)))
    return (int)cudaErrorInvalidValue;
  if ((long long)d.N * d.R * d.h * d.B >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  return steps ? launch<true>(bwd, p, d, chunks, inv_s, temperature, inv_temp,
                              stream)
               : launch<false>(bwd, p, d, 1, inv_s, temperature, inv_temp,
                               stream);
}
