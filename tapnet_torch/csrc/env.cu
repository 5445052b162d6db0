// fused_rollout_batch: the whole N-step heuristic rollout in one launch.
//
// Replaces: tapnet_tpu/ops/pallas_env.py::fused_rollout_batch (kernel bodies
// `_kernel2d` and `_kernel3d`): for every instance and every step,
// accessibility from the precedence graphs -> rolling-window cut -> target
// fit and, under a finite height cap, placeability per (block, rot,
// container) -> the (draw mod count)-th feasible action in flat (block, rot,
// container) order (`first` is draw 0) -> candidate scan -> lb or mcs
// placement -> heightmap, packed set, action and placement row updated.
// One kernel covers 2D (D = 1) and 3D, both rules, soft/hard, any window,
// container count and cap.
//
// Bound: bytes at the main path's shape. An instance reads its dims (3N
// words), its precedence limbs (2LN), n_total and N draws and writes the
// heightmaps (C*W*D), packed and actions (2N) and placements (6N): 0.96 KB
// at 2d-basic, 3.9 MB at batch 4096; its integer work is a few thousand
// adds, compares and max per rollout (chip_smoke.py counts them from the
// run's own placements), which at the card's int32 rate takes less time
// than the bytes do. What the kernel really waits on is latency: N dependent
// steps of small loops in one thread.
//
// Design: one thread per instance, 32 threads per block so that a batch of
// 4096 spreads over 128 blocks; every operand is batch-last, so neighbouring
// threads read and write neighbouring addresses. The state lives where it
// ends up: heightmaps and placements in the output buffers (each thread
// reads back only what it wrote itself), the unpacked set in a 64-bit
// register, the chosen container's heightmap copied into the thread's own
// array for the scan. The TPU kernel's stacked shifts, prefix sums, one-hot
// row updates and per-rotation mask planes were devices for 128 lanes
// without scatter or cumsum; a thread indexes, counts and branches. The
// precedence graphs arrive as column bitmasks in 31-bit limbs (two limbs
// cover N <= 62), so accessibility of a block is one AND against the
// unpacked set. A finite cap makes feasibility depend on the container: each
// (block, rot, container) is tested by a scan that stops at the first offset
// that fits under the cap, and the per-block feasibility bits are ranked in
// flat order, which is the reference's `_select_general` and its
// container-invariant shortcut at once. The placement itself is
// select_place.cuh's place_block, shared with the two decode-step kernels.
#include "select_place.cuh"

namespace {

constexpr int MAX_N = 62;   // blocks: two 31-bit precedence limbs
constexpr int MAX_RC = 16;  // rot x container feasibility bits per block

typedef unsigned long long u64;

struct RolloutIO {
  const int* dims_w;       // [N, B]
  const int* dims_d;
  const int* dims_h;
  const int* upm;          // [L*N, B] column bitmasks of the up graph
  const int* rotm;         // [L*N, B]
  const int* ntot;         // [B]
  const unsigned* rbits;   // [N, B] policy draws (zeros = first-fit)
  int* hm_o;               // [C*W*D, B]
  int* packed_o;           // [N, B]
  int* act_o;              // [N, B]
  int* plc_o;              // [N*6, B]
};

// Some offset of a (w, d, h) block lands with l + h <= cap.
__device__ bool can_place(const tapnet::EnvCfg& c, const int* hm, int w,
                          int d, int h) {
  for (int x = 0; x + w <= c.W; ++x)
    for (int y = 0; y + d <= c.D; ++y) {
      int l = 0;
      for (int i = x; i < x + w; ++i)
        for (int j = y; j < y + d; ++j) l = max(l, hm[i * c.D + j]);
      if (l + h <= c.cap) return true;
    }
  return false;
}

__device__ __forceinline__ u64 limbs(const int* m, int i, int N, int B,
                                     int b) {
  u64 v = (unsigned)m[i * B + b];
  if (N > 31) v |= (u64)(unsigned)m[(N + i) * B + b] << 31;
  return v;
}

template <bool MCS>
__global__ void rollout_kernel(tapnet::EnvCfg c, RolloutIO io, int window,
                               int capped, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int N = c.N, R = c.R, C = c.C, W = c.W, D = c.D;
  const int WD = W * D, RC = R * C;

  for (int k = 0; k < C * WD; ++k) io.hm_o[k * B + b] = 0;
  for (int k = 0; k < N * 6; ++k) io.plc_o[k * B + b] = -1;
  for (int t = 0; t < N; ++t) io.act_o[t * B + b] = -1;

  const int nt = io.ntot[b];
  u64 unp = (1ull << nt) - 1;  // real blocks not packed yet (padding never)
  int hm[tapnet::MAX_WD];
  unsigned short feas[MAX_N];

  for (int t = 0; t < N; ++t) {
    // accessibility, cut to the first `window` accessible blocks
    u64 acc0 = 0, accr = 0;
    int seen = 0;
    for (int i = 0; i < N; ++i) {
      if (!(unp >> i & 1)) continue;
      if (limbs(io.upm, i, N, B, b) & unp) continue;
      acc0 |= 1ull << i;
      if (R == 2 && !(limbs(io.rotm, i, N, B, b) & unp)) accr |= 1ull << i;
      if (window > 0 && ++seen >= window) break;
    }

    // feasibility bits of each block, bit r*C + container
    int count = 0;
    for (int i = 0; i < N; ++i) feas[i] = 0;
    if (!capped) {
      const unsigned all_c = (1u << C) - 1;
      for (int i = 0; i < N; ++i) {
        if (!(acc0 >> i & 1)) continue;
        unsigned f = 0;
        for (int r = 0; r < R; ++r) {
          if (r == 1 && !(accr >> i & 1)) continue;
          int w = io.dims_w[i * B + b], d = io.dims_d[i * B + b];
          int h = io.dims_h[i * B + b];
          tapnet::rotate_dims(c, r, w, d, h);
          if (w <= W && d <= D) f |= all_c << (r * C);
        }
        feas[i] = (unsigned short)f;
        count += __popc(f);
      }
    } else {
      for (int cc = 0; cc < C; ++cc) {
        for (int k = 0; k < WD; ++k) hm[k] = io.hm_o[(cc * WD + k) * B + b];
        for (int i = 0; i < N; ++i) {
          if (!(acc0 >> i & 1)) continue;
          for (int r = 0; r < R; ++r) {
            if (r == 1 && !(accr >> i & 1)) continue;
            int w = io.dims_w[i * B + b], d = io.dims_d[i * B + b];
            int h = io.dims_h[i * B + b];
            tapnet::rotate_dims(c, r, w, d, h);
            if (can_place(c, hm, w, d, h)) {
              feas[i] |= (unsigned short)(1u << (r * C + cc));
              ++count;
            }
          }
        }
      }
    }
    // an empty mask stays empty: the state no longer changes
    if (count == 0) break;

    // the sel-th feasible action in flat (block, rot, container) order
    unsigned sel = io.rbits[t * B + b] % (unsigned)count;
    int blk = 0;
    for (; blk < N; ++blk) {
      const unsigned p = __popc((unsigned)feas[blk]);
      if (sel < p) break;
      sel -= p;
    }
    int k = 0;
    for (;; ++k)
      if (feas[blk] >> k & 1) {
        if (sel == 0) break;
        --sel;
      }
    const int r = k / C, cs = k % C;

    int w = io.dims_w[blk * B + b], d = io.dims_d[blk * B + b];
    int h = io.dims_h[blk * B + b];
    tapnet::rotate_dims(c, r, w, d, h);
    for (int q = 0; q < WD; ++q) hm[q] = io.hm_o[(cs * WD + q) * B + b];
    tapnet::ScoreCtx sc{0, 0, 0, 0, 0};
    if (MCS)
      sc = tapnet::score_ctx(c, io.hm_o, io.plc_o, io.dims_w, io.dims_d,
                             io.dims_h, B, b);
    const tapnet::Placement p = tapnet::place_block<MCS>(c, hm, w, d, h, sc);
    if (!p.any_valid) continue;  // nothing is written, the action stays -1

    const int top = p.l + h;
    for (int i = p.x; i < p.x + w; ++i)
      for (int j = p.y; j < p.y + d; ++j)
        io.hm_o[(cs * WD + i * D + j) * B + b] = top;
    unp &= ~(1ull << blk);
    io.act_o[t * B + b] = blk * RC + k;
    const int row[6] = {cs, r, p.x, p.y, p.l, p.stable};
    for (int q = 0; q < 6; ++q) io.plc_o[(blk * 6 + q) * B + b] = row[q];
  }

  for (int i = 0; i < N; ++i) io.packed_o[i * B + b] = !(unp >> i & 1);
}

}  // namespace

// ptrs: dims_w, dims_d, dims_h, upm, rotm, ntot, rbits,      (0-6)
//       hm_o, packed_o, act_o, plc_o                         (7-10)
// ints: B, the EnvCfg fields (select_place.cuh env_cfg), window, capped
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int tapnet_fused_rollout(void* const* p, const int* ints,
                                    void* stream) {
  const int B = ints[0];
  const tapnet::EnvCfg c = tapnet::env_cfg(ints + 1);
  const int window = ints[1 + tapnet::ENV_INTS];
  const int capped = ints[2 + tapnet::ENV_INTS];
  if (c.N > MAX_N || c.R * c.C > MAX_RC || c.W * c.D > tapnet::MAX_WD)
    return (int)cudaErrorInvalidValue;
  const RolloutIO io{(const int*)p[0], (const int*)p[1], (const int*)p[2],
                     (const int*)p[3], (const int*)p[4], (const int*)p[5],
                     (const unsigned*)p[6], (int*)p[7], (int*)p[8],
                     (int*)p[9], (int*)p[10]};
  const int threads = 32, blocks = (B + threads - 1) / threads;
  if (c.mcs)
    rollout_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        c, io, window, capped, B);
  else
    rollout_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        c, io, window, capped, B);
  return (int)cudaGetLastError();
}
