// reward_kernel: the whole C/P/S reward of a batch in one launch, and the
// per-container heightmap reductions it is built on.
//
// Replaces: tapnet_tpu/ops/pallas_reward.py::heightmap_reductions (kernel
// body `_reduce_kernel`: int32 max and sum of every container's cells) and
// the composition the JAX package runs around it (`batched_reward_terms`,
// `batched_reward`): the five integer terms vol, denom_c, denom_p, s_num,
// s_den and the float32 reward, the sum of the configured C/P/S fractions.
//
// Bound: bytes, and at the main path's sizes the launch. At 2d-basic, batch
// 4096, one launch reads 164 KB of heightmaps, the two placement columns it
// needs (328 KB) and the dims (492 KB) and writes 130 KB: ~0.33 us at 3.35
// TB/s, well under one launch's latency. What the launch replaces is the ~40
// small PyTorch launches that composed the terms and the reward around the
// reductions.
//
// Design: a segment of S lanes (a power of two up to 32, the smallest that
// covers a container's W*D cells and the N blocks) per instance, so a warp
// covers 32 / S instances and neighbouring lanes read neighbouring cells:
// loads coalesce. Max and sum over a container's cells reduce with
// __shfl_xor_sync inside the segment; the sums over containers and blocks
// stay in registers. Integer arithmetic is modulo 2^32 (unsigned), as the
// reference's int32 results are, so every integer output is bit-equal to it
// in any order. The reward uses one IEEE int->float conversion per operand,
// a correctly rounded divide and left-to-right adds in the configured term
// order: bit-equal to `env.core.reward_from_terms`.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct RewardIO {
  const int* hm;    // [B, C, WD]
  const int* plc;   // [B, N, 6]; null: the reductions alone
  const int* dims;  // [B, N, 3]
  int* maxh;        // [B, C]
  int* under;       // [B, C]
  int* terms;       // [5, B]: vol, denom_c, denom_p, s_num, s_den; or null
  float* reward;    // [B]; null: no reward terms asked for
};

template <int S>
__device__ __forceinline__ int seg_max(int v) {
#pragma unroll
  for (int o = S / 2; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int S>
__device__ __forceinline__ unsigned seg_sum(unsigned v) {
#pragma unroll
  for (int o = S / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// n / max(d, 1) in float32 where d > 0, else 0 (env.core.reward_from_terms)
__device__ __forceinline__ float frac(unsigned n, unsigned d) {
  const int di = (int)d;
  return di > 0 ? __fdiv_rn(__int2float_rn((int)n), __int2float_rn(di))
                : 0.0f;
}

template <int S>
__global__ void __launch_bounds__(THREADS)
reward_kernel(RewardIO io, int B, int C, int WD, int N, int nterms, int t0,
              int t1, int t2) {
  const int l = threadIdx.x & (S - 1);
  const int b = (blockIdx.x * THREADS + threadIdx.x) / S;
  const bool live = b < B;
  // every lane of a warp runs the same loops and shuffles: a dead instance
  // (b >= B) carries neutral values
  unsigned dc = 0, dp = 0;
  for (int c = 0; c < C; ++c) {
    int mx = INT_MIN;
    unsigned sm = 0;
    if (live) {
      const int* row = io.hm + ((size_t)b * C + c) * WD;
      for (int k = l; k < WD; k += S) {
        const int v = row[k];
        mx = max(mx, v);
        sm += (unsigned)v;
      }
    }
    mx = seg_max<S>(mx);
    sm = seg_sum<S>(sm);
    if (live && l == 0) {
      io.maxh[(size_t)b * C + c] = mx;
      io.under[(size_t)b * C + c] = (int)sm;
    }
    if (mx > 0) {
      dc += (unsigned)WD * (unsigned)mx;
      dp += sm;
    }
  }
  if (io.terms == nullptr) return;  // the reductions alone: the same grid-wide
  unsigned vol = 0, sn = 0, sd = 0;
  if (live) {
    for (int j = l; j < N; j += S) {
      const int* p = io.plc + ((size_t)b * N + j) * 6;
      if (p[0] >= 0) {
        const int* d = io.dims + ((size_t)b * N + j) * 3;
        vol += (unsigned)d[0] * (unsigned)d[1] * (unsigned)d[2];
        sn += (unsigned)p[5];
        sd += 1u;
      }
    }
  }
  vol = seg_sum<S>(vol);
  sn = seg_sum<S>(sn);
  sd = seg_sum<S>(sd);
  if (!live || l != 0) return;
  io.terms[b] = (int)vol;
  io.terms[(size_t)B + b] = (int)dc;
  io.terms[(size_t)2 * B + b] = (int)dp;
  io.terms[(size_t)3 * B + b] = (int)sn;
  io.terms[(size_t)4 * B + b] = (int)sd;
  if (io.reward == nullptr) return;
  const float v[3] = {frac(vol, dc), frac(vol, dp), frac(sn, sd)};
  float r = v[t0];
  if (nterms > 1) r = __fadd_rn(r, v[t1]);
  if (nterms > 2) r = __fadd_rn(r, v[t2]);
  io.reward[b] = r;
}

template <int S>
cudaError_t launch(const RewardIO& io, const int* n, cudaStream_t stream) {
  const long long threads = (long long)n[0] * S;
  const int blocks = (int)((threads + THREADS - 1) / THREADS);
  reward_kernel<S><<<blocks, THREADS, 0, stream>>>(io, n[0], n[1], n[2], n[3],
                                                   n[4], n[5], n[6], n[7]);
  return cudaGetLastError();
}

}  // namespace

// p: hm, plc, dims, maxh, under, terms, reward (device pointers). plc, dims
//    and terms null: the reductions alone (maxh, under); reward null: the
//    terms without a reward.
// ints: B, C, WD, N, nterms, t0, t1, t2 (terms in order; C = 0, P = 1,
//    S = 2). Launches on `stream`; returns cudaGetLastError() after it.
extern "C" int tapnet_reward(void* const* p, const int* ints, void* stream) {
  const int B = ints[0], C = ints[1], WD = ints[2], N = ints[3];
  const int nterms = ints[4];
  if (B <= 0 || C <= 0 || WD <= 0 || N < 0 || nterms < 0 || nterms > 3)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nterms; ++i)
    if (ints[5 + i] < 0 || ints[5 + i] > 2) return (int)cudaErrorInvalidValue;
  const bool with_terms = p[5] != nullptr;
  if (with_terms && (p[1] == nullptr || p[2] == nullptr))
    return (int)cudaErrorInvalidValue;
  if (p[6] != nullptr && (!with_terms || nterms == 0))
    return (int)cudaErrorInvalidValue;
  const RewardIO io{(const int*)p[0], (const int*)p[1], (const int*)p[2],
                    (int*)p[3],       (int*)p[4],       (int*)p[5],
                    (float*)p[6]};
  const int span = with_terms && N > WD ? N : WD;
  int S = 1;
  while (S < span && S < 32) S *= 2;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: return (int)launch<1>(io, ints, st);
    case 2: return (int)launch<2>(io, ints, st);
    case 4: return (int)launch<4>(io, ints, st);
    case 8: return (int)launch<8>(io, ints, st);
    case 16: return (int)launch<16>(io, ints, st);
    default: return (int)launch<32>(io, ints, st);
  }
}
