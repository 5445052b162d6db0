// actor_select_step: one whole sampled decode step of the learned policy.
//
// Replaces: tapnet_tpu/ops/pallas_actor_step.py::actor_select_step (kernel
// body `_kernel`): accessibility from precedence bitmasks (one or two 31-bit
// limbs, N <= 62), the rolling-window cut, flags, the action mask, the
// heightmap encoder, the previous-action embedding, the query, the
// per-token dyn MLP, additive attention v.tanh(key + dyn + q), masked
// (tempered) logits + gumbel, select/place (select_place.cuh, shared with
// the select_step kernel) and log pi of the chosen action.
//
// Bound: the f32 matrix-vector work. Per instance and step, at hidden h,
// W*D cells, T tokens and C containers: C*(h*(W*D+2) + h*h + h*(3h+8)) +
// T*(32*8 + 32*h + C*h) multiply-adds, 1.1e5 at 2d-basic and h = 128, so
// 0.92 GFLOP per step at batch 4096 (14 us at 67 TFLOP/s of f32 FMA). The
// bytes are dominated by the static keys [T, h, B], 21 MB per step at that
// shape (6 us at 3.35 TB/s).
//
// Design: one block per tile of 32 instances, lane = instance (every
// batch-last row is read coalesced), 16 warps. Warp 0 does the integer work
// of its 32 instances (flags, mask, the count summary, select/place, logp).
// The matrix-vector products split the h output rows over the 16 warps:
// each warp reads one weight row at a time (the same address in every lane,
// a broadcast from L1/L2) against the instance vectors held in shared
// memory, [feature, lane]. The head weights (about 296 KB at h = 128) never
// sit in shared memory at once: they are read through the read-only path as
// each phase needs them, and shared memory holds only live intermediates:
// the encoder input, the query input [3h+8], the C queries, one token's
// dyn-MLP hidden layer, the per-warp partial scores and the A scores, 94 KB
// at 2d-basic and h = 128 (131 KB at 2d-rolling: A = 100). All sums are f32
// multiply-adds, never TF32.
//
// Window and limbs: the packed / accessible / window sets of an instance are
// bit words held by its thread of warp 0. Configs with a rolling window or
// N > 31 run the WIDE instantiation, whose words are 64-bit; the window is a
// running count over the accessible blocks in index order (the TPU kernel's
// strictly-lower-triangular matmul was a prefix sum for lanes without one).
// The others keep the 32-bit instantiation, whose window word is acc0.
#include <type_traits>

#include "select_place.cuh"

namespace {

constexpr int TB = 32;      // instances per block
constexpr int NWARP = 16;   // warps per block
constexpr int MAX_C = 4;    // containers
constexpr int MAX_N = 62;   // blocks: two 31-bit precedence limbs
constexpr float NEG = -1e9f;

struct HeadW {
  const float *w8t, *b8, *wpt, *w1t, *b1, *w2t, *b2, *et, *wqt, *bq, *v;
};

struct ActorIO {
  const float* tf;     // [1]
  const int* prev;     // [B]
  const int* upm;      // [L*N, B] column bitmasks of the up graph, L limbs
  const int* rotm;     // [L*N, B]
  const int* fits;     // [R*N, B]
  const float* g;      // [A, B] gumbel (zeros = greedy)
  const float* se;     // [T, h, B] static keys
  const float* ctx;    // [h, B] mean static key
  const float* statp;  // [4, T, B] static token features
  const float* statm;  // [4, B] their mean over tokens
  int* flags_o;        // [N, B]
  int* mask_o;         // [A, B]
  float* logits_o;     // [A, B]
  float* logp_o;       // [B]
};

struct SScore {
  const float* p;
  int lane;
  __device__ float operator()(int a) const { return p[a * TB + lane]; }
};

struct SMask {
  const int* p;
  int lane;
  __device__ int operator()(int a) const { return p[a * TB + lane]; }
};

// out[j] = sum_k W[j, k] * x[k] over rows j owned by this warp, x in shared
// memory as [k, lane]. Returns nothing; `emit(j, acc)` stores row j.
template <class Emit>
__device__ void matvec(const float* __restrict__ Wm, int rows, int cols,
                       const float* x, int lane, int wy, Emit emit) {
  for (int j = wy; j < rows; j += NWARP) {
    const float* wr = Wm + (size_t)j * cols;
    float acc = 0.f;
    for (int k = 0; k < cols; ++k) acc = fmaf(__ldg(wr + k), x[k * TB + lane], acc);
    emit(j, acc);
  }
}

__device__ __forceinline__ int popw(unsigned x) { return __popc(x); }
__device__ __forceinline__ int popw(unsigned long long x) {
  return __popcll(x);
}

// Column bitmask of block i over the unpacked-set word: one 31-bit limb, or
// two joined into 62 bits (the layout of ops/actor_step.py
// precedence_bitmasks).
template <class Word>
__device__ __forceinline__ Word column(const int* m, int i, int N, int B,
                                       int b) {
  Word v = (unsigned)m[i * B + b];
  if (sizeof(Word) == 8 && N > 31)
    v |= (Word)(unsigned)m[(N + i) * B + b] << 31;
  return v;
}

// One instantiation per placement rule (MCS), as in policy_step.cu, and per
// word width (WIDE: a rolling window or N > 31).
template <bool MCS, bool WIDE>
__global__ void __launch_bounds__(TB * NWARP)
actor_step_kernel(tapnet::EnvCfg c, tapnet::StepIO io, ActorIO ai, HeadW hw,
                  int B, int h, float inv_s, float temperature, int window) {
  using Word = std::conditional_t<WIDE, unsigned long long, unsigned>;
  extern __shared__ float smem[];
  const int N = c.N, R = c.R, C = c.C, WD = c.W * c.D;
  const int T = N * R, A = T * C, FQ = 3 * h + 8;
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int b = blockIdx.x * TB + lane;
  const bool active = b < B;
  const int bb = active ? b : 0;  // clamped index for loads

  float* feats = smem;                  // [WD+2, TB]
  float* e1 = feats + (WD + 2) * TB;    // [h, TB]
  float* qin = e1 + h * TB;             // [3h+8, TB]: hm_enc, ctx, prev, dsum
  float* q = qin + FQ * TB;             // [C, h, TB]
  float* x8 = q + C * h * TB;           // [8, TB]
  float* h1 = x8 + 8 * TB;              // [32, TB]
  float* part = h1 + 32 * TB;           // [NWARP, C, TB]
  float* scores = part + NWARP * C * TB;  // [A, TB]
  float* sel = scores + A * TB;         // [A, TB]
  int* maskS = (int*)(sel + A * TB);    // [A, TB]
  // [4, TB] words: packed, acc0, accr, win
  Word* bits = reinterpret_cast<Word*>(maskS + A * TB);

  const float tf = ai.tf[0];

  // ---- phase 0: accessibility, flags, mask, count summary (warp 0)
  if (wy == 0) {
    Word pk = 0, a0m = 0, arm = 0, wnm = 0, ub = 0;
    for (int j = 0; j < N; ++j) {
      const int p = active ? io.packed[j * B + b] : 1;
      pk |= (Word)(p != 0) << j;
      ub |= (Word)(p == 0) << j;
    }
    int seen = 0;  // accessible blocks before i (WIDE: the window rank)
    for (int i = 0; i < N; ++i) {
      const bool unpk = !((pk >> i) & 1);
      const bool acc0 =
          unpk && (column<Word>(ai.upm, i, N, B, bb) & ub) == 0;
      const bool accr =
          acc0 && (column<Word>(ai.rotm, i, N, B, bb) & ub) == 0;
      bool win = acc0;
      if (WIDE) {
        win = acc0 && (window == 0 || seen < window);
        seen += acc0;
      }
      a0m |= (Word)acc0 << i;
      arm |= (Word)accr << i;
      wnm |= (Word)win << i;
      const int p = (int)((pk >> i) & 1);
      if (active) ai.flags_o[i * B + b] = p + 2 * acc0 + 4 * accr + 8 * win;
      for (int r = 0; r < R; ++r) {
        const int ok = (r == 0 ? win : (win && accr)) *
                       ai.fits[(r * N + i) * B + bb];
        for (int cc = 0; cc < C; ++cc) {
          const int a = (i * R + r) * C + cc;
          maskS[a * TB + lane] = ok;
          if (active) ai.mask_o[a * B + b] = ok;
        }
      }
    }
    bits[lane] = pk;
    bits[TB + lane] = a0m;
    bits[2 * TB + lane] = arm;
    bits[3 * TB + lane] = wnm;
    const float fpk = (float)popw(pk), fa0 = (float)popw(a0m);
    const float far = (float)popw(arm);
    const float acc_mean = R == 2 ? (fa0 + far) / (float)T : fa0 / (float)N;
    float* ds = qin + 3 * h * TB;
    ds[0 * TB + lane] = fpk / (float)N;
    ds[1 * TB + lane] = acc_mean;
    ds[2 * TB + lane] = (float)popw(wnm) / (float)N;
    ds[3 * TB + lane] = tf;
    for (int k = 0; k < 4; ++k) ds[(4 + k) * TB + lane] = ai.statm[k * B + bb];
  }
  {
    const int idx = min(max((active ? ai.prev[b] : -1) + 1, 0), A);
    for (int j = wy; j < h; j += NWARP) {
      qin[(h + j) * TB + lane] = ai.ctx[j * B + bb];
      qin[(2 * h + j) * TB + lane] = __ldg(hw.et + (size_t)j * (A + 1) + idx);
    }
  }
  __syncthreads();

  // ---- phase 1: heightmap encoder and query, per container
  for (int cc = 0; cc < C; ++cc) {
    for (int k = wy; k < WD; k += NWARP)
      feats[k * TB + lane] = (float)io.hm[(cc * WD + k) * B + bb] * inv_s;
    __syncthreads();
    if (wy == 0) {
      float mx = feats[lane], sm = 0.f;
      for (int k = 0; k < WD; ++k) {
        mx = fmaxf(mx, feats[k * TB + lane]);
        sm += feats[k * TB + lane];
      }
      feats[WD * TB + lane] = mx;
      feats[(WD + 1) * TB + lane] = sm / (float)WD;
    }
    __syncthreads();
    matvec(hw.w1t, h, WD + 2, feats, lane, wy, [&](int j, float acc) {
      e1[j * TB + lane] = fmaxf(acc + __ldg(hw.b1 + j), 0.f);
    });
    __syncthreads();
    matvec(hw.w2t, h, h, e1, lane, wy, [&](int j, float acc) {
      qin[j * TB + lane] = acc + __ldg(hw.b2 + j);
    });
    __syncthreads();
    matvec(hw.wqt, h, FQ, qin, lane, wy, [&](int j, float acc) {
      q[(cc * h + j) * TB + lane] = acc + __ldg(hw.bq + j);
    });
    __syncthreads();
  }

  // ---- phase 2: per token, dyn MLP + additive attention scores
  const Word pk = bits[lane], a0m = bits[TB + lane];
  const Word arm = bits[2 * TB + lane], wnm = bits[3 * TB + lane];
  for (int t = 0; t < T; ++t) {
    const int i = t / R, r = t % R;
    if (wy == 0) {
      x8[0 * TB + lane] = (float)((pk >> i) & 1);
      x8[1 * TB + lane] = (float)(((r == 0 ? a0m : arm) >> i) & 1);
      x8[2 * TB + lane] = (float)((wnm >> i) & 1);
      x8[3 * TB + lane] = tf;
      for (int k = 0; k < 4; ++k)
        x8[(4 + k) * TB + lane] = ai.statp[(k * T + t) * B + bb];
    }
    __syncthreads();
    matvec(hw.w8t, 32, 8, x8, lane, wy, [&](int j, float acc) {
      h1[j * TB + lane] = fmaxf(acc + __ldg(hw.b8 + j), 0.f);
    });
    __syncthreads();
    float ps[MAX_C] = {0.f, 0.f, 0.f, 0.f};
    const float* se_t = ai.se + (size_t)t * h * B;
    matvec(hw.wpt, h, 32, h1, lane, wy, [&](int j, float dyn) {
      const float sd = se_t[(size_t)j * B + bb] + dyn;
      const float vj = __ldg(hw.v + j);
      for (int cc = 0; cc < C; ++cc)
        ps[cc] = fmaf(tanhf(sd + q[(cc * h + j) * TB + lane]), vj, ps[cc]);
    });
    for (int cc = 0; cc < C; ++cc) part[(wy * C + cc) * TB + lane] = ps[cc];
    __syncthreads();
    if (wy == 0) {
      for (int cc = 0; cc < C; ++cc) {
        float s = 0.f;
        for (int w = 0; w < NWARP; ++w) s += part[(w * C + cc) * TB + lane];
        scores[(t * C + cc) * TB + lane] = s;
      }
    }
  }

  // ---- phase 3: masked logits, gumbel argmax, select/place, log pi
  if (wy == 0 && active) {
    float mx = NEG;
    for (int a = 0; a < A; ++a) {
      const float s = scores[a * TB + lane];
      ai.logits_o[a * B + b] = s;
      const float m = maskS[a * TB + lane] == 1 ? s / temperature : NEG;
      scores[a * TB + lane] = m;
      sel[a * TB + lane] = m + ai.g[a * B + b];
      mx = a == 0 ? m : fmaxf(mx, m);
    }
    const int act = tapnet::select_place<MCS>(c, SScore{sel, lane},
                                              SMask{maskS, lane}, io, B, b);
    float se = 0.f;
    for (int a = 0; a < A; ++a) se += expf(scores[a * TB + lane] - mx);
    const float lp = (scores[max(act, 0) * TB + lane] - mx) - logf(se);
    ai.logp_o[b] = act >= 0 ? lp : 0.f;
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes.
static size_t smem_bytes(int N, int R, int C, int WD, int h) {
  const int A = N * R * C;
  const size_t floats = (size_t)TB * ((WD + 2) + h + (3 * h + 8) + C * h + 8 +
                                      32 + NWARP * C + 2 * A);
  const size_t ints = (size_t)TB * (A + 8);  // mask, then 4 words of 64 bits
  return 4 * (floats + ints);
}

// ptrs: packed, hm, plc, dims_w, dims_d, dims_h,                       (0-5)
//       tf, prev, upm, rotm, fits, g, se, ctx, statp, statm,           (6-15)
//       w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v,                (16-26)
//       packed_o, hm_o, plc_o, act_o, flags_o, mask_o, logits_o, logp_o (27-34)
// ints: B, the EnvCfg fields (select_place.cuh env_cfg), h, window
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int tapnet_actor_select_step(void* const* p, const int* ints,
                                        float inv_s, float temperature,
                                        void* stream) {
  const int B = ints[0], h = ints[1 + tapnet::ENV_INTS];
  const int window = ints[2 + tapnet::ENV_INTS];
  const tapnet::EnvCfg c = tapnet::env_cfg(ints + 1);
  if (c.N > MAX_N || c.C > MAX_C || c.W * c.D > tapnet::MAX_WD)
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
                 (const float*)p[25], (const float*)p[26]};
  const size_t smem = smem_bytes(c.N, c.R, c.C, c.W * c.D, h);
  auto kernel = wide ? (c.mcs ? actor_step_kernel<true, true>
                              : actor_step_kernel<false, true>)
                     : (c.mcs ? actor_step_kernel<true, false>
                              : actor_step_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TB, NWARP);
  kernel<<<(B + TB - 1) / TB, block, smem, (cudaStream_t)stream>>>(
      c, io, ai, hw, B, h, inv_s, temperature, window);
  return (int)cudaGetLastError();
}
