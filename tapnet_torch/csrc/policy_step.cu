// select_step: one greedy/sampled decode step's select + place, batch-last.
//
// Replaces: tapnet_tpu/ops/pallas_policy_step.py::select_step (its kernel
// body `select_place`), the TPU kernel that ran argmax, the candidate scan,
// lb or mcs placement and the state update for a 128-instance lane tile.
//
// Bound: bytes. Per instance and step it reads the score and mask rows
// (2*A words), packed, placements and dims (10*N words) and the heightmaps
// (C*W*D words) and writes packed, heightmaps, placements and the action,
// about 0.85 KB at 2d-basic, 3.5 MB at batch 4096; the integer work is a few
// hundred operations per instance. What a launch waits on is latency: four
// dependent rounds (scores, the chosen container, the placement, the rows).
//
// Design: a block is a tile of TB = 32 instances, one per lane (every
// batch-last row is read and written coalesced), with NW = 16 warps, so
// that no phase runs on one thread per instance:
// - every warp takes a share of the A actions with its partial (max, the
//   lowest index at the max) and partial `valid`; under mcs also a share of
//   the score context (blocks, containers); every warp joins the partials
//   in warp order (the lowest index attaining the max, as torch.argmax) and
//   stages a share of the chosen container's heightmap column in shared
//   memory;
// - every warp walks a share of the candidate offsets (select_place.cuh
//   place_part), warp 0 joins the winners and resolves the placement;
// - every warp copies through and updates a share of the state rows
//   (heightmaps of all C containers, packed, placements).
// No atomics: two launches on the same operands give the same bits. The
// launch bound asks for one block per SM (the main path's 128 blocks fill
// the card once): without it ptxas trades registers for a second resident
// block and spills.
#include "select_place.cuh"

namespace {

constexpr int TB = 32;  // instances per block
constexpr int NW = 16;  // warps per block
constexpr int NT = TB * NW;

// Shared-memory plan in rows of TB ints: argmax partials [3][NW] (best,
// index, valid), mcs context partials [5][NW], placement partials [7][NW],
// the decision [6] (x, y, l, stable, top, do), the chosen container's
// heightmap column [W*D].
constexpr int PCTX = 3 * NW, PPL = PCTX + 5 * NW, DEC = PPL + 7 * NW;
constexpr int HMS = DEC + 6;
inline size_t smem_bytes(int WD) { return 4 * (size_t)(HMS + WD) * TB; }

struct ScoreMask {
  float s;
  int m;
};

template <bool MCS>
__global__ void __launch_bounds__(NT, 1)
select_step_kernel(tapnet::EnvCfg c, const float* score, const int* mask,
                   tapnet::StepIO io, int B) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int b = blockIdx.x * TB + lane;
  const bool active = b < B;
  const int N = c.N, R = c.R, C = c.C, D = c.D, WD = c.W * c.D;
  const int A = N * R * C;
  float* pbest = reinterpret_cast<float*>(smem);  // [NW][TB]
  int* pidx = smem + NW * TB;                      // [NW][TB]
  int* pval = smem + 2 * NW * TB;                  // [NW][TB]
  int* pctx = smem + PCTX * TB;                    // [5][NW][TB]
  int* ppl = smem + PPL * TB;                      // [7][NW][TB]
  int* dec = smem + DEC * TB;                      // [6][TB]
  int* hmS = smem + HMS * TB;                      // [W*D][TB]

  // ---- every warp: its actions' partial argmax and valid; under mcs its
  // share of the score context
  if (active) {
    float best = 0.f;
    int idx = -1, val = 0;
    tapnet::rows8<NW>(A, wy, [&](int a) {
      return ScoreMask{score[a * B + b], mask[a * B + b]};
    }, [&](int a, ScoreMask v) {
      if (idx < 0 || v.s > best) {
        best = v.s;
        idx = a;
      }
      val |= v.m > 0;
    });
    pbest[wy * TB + lane] = best;
    pidx[wy * TB + lane] = idx;
    pval[wy * TB + lane] = val;
    if (MCS) {
      int s[5] = {0, 0, 0, 0, 0};  // vol, denc, denp, snum, sden
      for (int i = wy; i < N; i += NW) {
        if (io.plc[(i * 6) * B + b] < 0) continue;
        s[0] += io.dims_w[i * B + b] * io.dims_d[i * B + b] *
                io.dims_h[i * B + b];
        s[3] += io.plc[(i * 6 + 5) * B + b];
        s[4] += 1;
      }
      for (int cc = wy; cc < C; cc += NW) {
        int mx = 0;
        for (int k = 0; k < WD; ++k) {
          const int v = io.hm[(cc * WD + k) * B + b];
          mx = max(mx, v);
          s[2] += v;
        }
        s[1] += WD * mx;
      }
      for (int k = 0; k < 5; ++k) pctx[(k * NW + wy) * TB + lane] = s[k];
    }
  }
  __syncthreads();

  // ---- every warp: the join (lowest action at the max), the chosen block
  // and container; a share of that container's column into shared memory
  int a_sel = -1, blk = 0, r = 0, cs = 0, w = 0, d = 0, h = 0;
  bool valid = false;
  tapnet::ScoreCtx sc{0, 0, 0, 0, 0};
  if (active) {
    float best = 0.f;
    for (int q = 0; q < NW; ++q) {
      const float v = pbest[q * TB + lane];
      const int i = pidx[q * TB + lane];
      if (i >= 0 && (a_sel < 0 || v > best || (v == best && i < a_sel))) {
        best = v;
        a_sel = i;
      }
      valid |= pval[q * TB + lane] != 0;
    }
    blk = a_sel / (R * C);
    r = (a_sel / C) % R;
    cs = a_sel % C;
    w = io.dims_w[blk * B + b];
    d = io.dims_d[blk * B + b];
    h = io.dims_h[blk * B + b];
    tapnet::rotate_dims(c, r, w, d, h);
    if (MCS) {
      int s[5] = {0, 0, 0, 0, 0};
      for (int k = 0; k < 5; ++k)
        for (int q = 0; q < NW; ++q) s[k] += pctx[(k * NW + q) * TB + lane];
      sc = tapnet::ScoreCtx{s[0], s[1], s[2], s[3], s[4]};
    }
    tapnet::rows8<NW>(WD, wy, [&](int k) {
      return io.hm[(cs * WD + k) * B + b];
    }, [&](int k, int v) { hmS[k * TB + lane] = v; });
  }
  __syncthreads();

  // ---- every warp: a share of the candidate offsets
  if (active)
    tapnet::place_put<MCS, TB, NW>(
        ppl, wy, lane,
        tapnet::place_part<MCS, TB, NW>(c, hmS + lane, w, d, h, sc, wy));
  __syncthreads();

  // ---- warp 0: the join of the winners, the placement, the action
  if (wy == 0 && active) {
    const tapnet::Placement p = tapnet::place_resolve<MCS>(
        c, tapnet::place_gather<MCS, TB, NW>(ppl, lane));
    dec[lane] = p.x;
    dec[TB + lane] = p.y;
    dec[2 * TB + lane] = p.l;
    dec[3 * TB + lane] = p.stable;
    dec[4 * TB + lane] = p.l + h;
    dec[5 * TB + lane] = valid && p.any_valid;
    io.act_o[b] = valid ? a_sel : -1;
  }
  __syncthreads();

  // ---- every warp: a share of the state rows
  if (active) {
    const int xs = dec[lane], ys = dec[TB + lane], top = dec[4 * TB + lane];
    const bool dop = dec[5 * TB + lane] != 0;
    const int ls = dec[2 * TB + lane], st = dec[3 * TB + lane];
    tapnet::rows8<NW>(C * WD, wy, [&](int k) { return io.hm[k * B + b]; },
                      [&](int k, int v) {
      const int cc = k / WD, x = (k - cc * WD) / D, y = k % D;
      const bool fp = dop && cc == cs && x >= xs && x < xs + w && y >= ys &&
                      y < ys + d;
      io.hm_o[k * B + b] = fp ? top : v;
    });
    // packed rows, then the placement rows: container, rotation, x, y,
    // landing height, stable
    tapnet::rows8<NW>(N + N * 6, wy, [&](int k) {
      return k < N ? io.packed[k * B + b] : io.plc[(k - N) * B + b];
    }, [&](int k, int v) {
      if (k < N) {
        io.packed_o[k * B + b] = v + (dop && k == blk);
      } else {
        k -= N;
        const int f = k % 6;
        io.plc_o[k * B + b] = !(dop && k / 6 == blk) ? v
                            : f == 0 ? cs : f == 1 ? r : f == 2 ? xs
                            : f == 3 ? ys : f == 4 ? ls : st;
      }
    });
  }
}

}  // namespace

// ptrs: score, mask, packed, hm, plc, dims_w, dims_d, dims_h,
//       packed_o, hm_o, plc_o, act_o (device pointers)
// ints: B, then the EnvCfg fields (select_place.cuh env_cfg)
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int tapnet_select_step(void* const* ptrs, const int* ints,
                                  void* stream) {
  const int B = ints[0];
  const tapnet::EnvCfg c = tapnet::env_cfg(ints + 1);
  if (c.W * c.D > tapnet::MAX_WD || B <= 0)
    return (int)cudaErrorInvalidValue;
  const tapnet::StepIO io{
      (const int*)ptrs[2], (const int*)ptrs[3], (const int*)ptrs[4],
      (const int*)ptrs[5], (const int*)ptrs[6], (const int*)ptrs[7],
      (int*)ptrs[8],       (int*)ptrs[9],       (int*)ptrs[10],
      (int*)ptrs[11]};
  const float* score = (const float*)ptrs[0];
  const int* mask = (const int*)ptrs[1];
  const size_t smem = smem_bytes(c.W * c.D);
  auto kernel = c.mcs ? select_step_kernel<true> : select_step_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + TB - 1) / TB, dim3(TB, NW), smem, (cudaStream_t)stream>>>(
      c, score, mask, io, B);
  return (int)cudaGetLastError();
}
