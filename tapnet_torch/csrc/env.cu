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
// than the bytes do. What the kernel waits on is latency: N dependent steps.
//
// Design: a block is a tile of TB = 32 instances, one per lane, with NW =
// 16 warps; the N steps stay in one launch and the instance's state stays
// on chip:
// - staged once in shared memory: the dims, the draws, the two precedence
//   graphs as column words (one or two 31-bit limbs joined into 64 bits)
//   and transposed into row words (the blocks each block blocks);
// - the heightmaps of all C containers in shared memory for the whole
//   rollout where they fit beside the rest (plan "on chip"); otherwise in
//   hm_o, the chosen container's column staged per step;
// - warp 0 owns the selection: the unpacked set (a 64-bit register), the
//   fit words per rotation (capped: the placeable words per rotation and
//   container), the decision of each step. Accessibility is the unpacked
//   set less the OR of the unpacked blocks' row words (loads that do not
//   wait on each other); the window keeps the lowest `window` accessible
//   bits, in block order; the draw is ranked in flat (block, rot,
//   container) order by a binary search over blocks on popcounts (the
//   reference's `_select_general`);
// - a step: the 12 warps off warp 0's scheduler each walk a share of the
//   candidate offsets (select_place.cuh place_part); uncapped, a block
//   that fits always lands, so warp 0 meanwhile selects the next step;
//   then warp 0 joins the winners, resolves the placement and records it,
//   while (lb) each placing warp resolves it too and writes a share of its
//   footprint's rows. Two barriers a step;
// - capped feasibility by min-landing tables, as the JAX kernel does it:
//   minland[w][d] = the least landing height of a w x d footprint over all
//   offsets; a (block, rot, container) is placeable iff the block fits and
//   minland[w][d] + h <= cap. After a step only the container that changed
//   is rebuilt (the warps take its widths; per offset row the column
//   maxima and running maxima in 16-wide register rows) and warp 0 renews
//   only its words, then selects;
// - under mcs the score context (vol, the C and P denominators, the
//   stability counts) is kept up to date on chip from each placement;
// - at the end the warps write the heightmaps (on chip plan), packed,
//   actions and placements once.
// No atomics: two launches on the same operands give the same bits. The
// launch bound asks for one block per SM: without it ptxas trades registers
// for a second resident block and spills.
#include "select_place.cuh"

namespace {

constexpr int TB = 32;      // instances per block
constexpr int NW = 16;      // warps per block
constexpr int NT = TB * NW;
// The warps that place: those not on warp 0's scheduler (wy % 4 != 0), so
// that warp 0's selection, which runs beside the placement, issues alone.
constexpr int NP = NW - NW / 4;
constexpr int MAX_N = 62;   // blocks: two 31-bit precedence limbs
constexpr int MAX_RC = 16;  // rot x container placeability words
constexpr int SMEM_MAX = 232448;           // bytes a block may hold

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

// Shared-memory plan, in rows of TB ints from the base (the u64 regions
// first, each an even number of rows).
struct Plan {
  int pw, up, rot, dn, rdn, unp, dims, draw, ppl, sel, act, rec, ctx, minl,
      hm, rows;
};

__host__ __device__ inline Plan plan(int N, int R, int C, int WD, bool capped,
                                     bool mcs, bool onchip) {
  Plan p;
  int o = 0;
  p.pw = o;   o += capped ? 2 * R * C : 0;  // u64 [R*C][TB] placeable words
  p.up = o;   o += 2 * N;                   // u64 [N][TB] column words, up
  p.rot = o;  o += 2 * N;                   // u64 [N][TB] column words, rot
  p.dn = o;   o += 2 * N;                   // u64 [N][TB] row words, up
  p.rdn = o;  o += 2 * N;                   // u64 [N][TB] row words, rot
  p.unp = o;  o += 2;                       // u64 [TB] the final unpacked set
  p.dims = o; o += 3 * N;                   // [3N][TB] w, d, h
  p.draw = o; o += N;                       // [N][TB] the policy's draws
  p.ppl = o;  o += (mcs ? 7 : 3) * NP;      // placement partials
  p.sel = o;  o += 16;                      // [2][8] decisions, t & 1
  p.act = o;  o += N;                       // [N][TB] action per step
  p.rec = o;  o += 3 * N;                   // per block: x | y << 16,
                                            // l*2 + stable, r | cs << 8
  p.ctx = o;  o += mcs ? 5 + C : 0;         // score context, max per container
  p.minl = o; o += capped ? WD : 0;         // [W*D][TB] min-landing table
  p.hm = o;   o += onchip ? C * WD : WD;    // heightmaps, or the staged one
  p.rows = o;
  return p;
}

inline size_t plan_bytes(const Plan& p) { return 4 * (size_t)p.rows * TB; }

__device__ __forceinline__ u64 limbs(const int* m, int i, int N, int B,
                                     int b) {
  u64 v = (unsigned)m[i * B + b];
  if (N > 31) v |= (u64)(unsigned)m[(N + i) * B + b] << 31;
  return v;
}

// The decision rows of a step: live (the mask was not empty), block,
// rotation, container, the rotated (w, d, h), the container the last step
// changed (capped; -1: none).
enum { LIVE, BLK, ROT, CS, SW, SD, SH, CHG };

template <bool MCS>
__global__ void __launch_bounds__(NT, 1)
rollout_kernel(tapnet::EnvCfg c, RolloutIO io, int window, int capped,
               int onchip, int B) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int b = blockIdx.x * TB + lane;
  const bool active = b < B;
  const int N = c.N, R = c.R, C = c.C, W = c.W, D = c.D;
  const int WD = W * D, RC = R * C;
  const Plan P = plan(N, R, C, WD, capped, MCS, onchip);
  u64* pw = reinterpret_cast<u64*>(smem + P.pw * TB) + lane;    // [R*C]
  u64* upS = reinterpret_cast<u64*>(smem + P.up * TB) + lane;   // [N]
  u64* rtS = reinterpret_cast<u64*>(smem + P.rot * TB) + lane;  // [N]
  u64* dnS = reinterpret_cast<u64*>(smem + P.dn * TB) + lane;   // [N]
  u64* rdnS = reinterpret_cast<u64*>(smem + P.rdn * TB) + lane; // [N]
  u64* unpS = reinterpret_cast<u64*>(smem + P.unp * TB) + lane;
  int* dimS = smem + P.dims * TB + lane;  // [3][N]
  int* drawS = smem + P.draw * TB + lane;  // [N]
  int* ppl = smem + P.ppl * TB;
  int* sel = smem + P.sel * TB + lane;    // [2][8]
  int* actS = smem + P.act * TB + lane;   // [N]
  int* rec = smem + P.rec * TB + lane;    // [3][N]
  int* ctxS = smem + P.ctx * TB + lane;   // [5 + C]
  int* minl = smem + P.minl * TB + lane;  // [W*D]
  int* hmS = smem + P.hm * TB;            // [C*W*D][TB] or [W*D][TB]

  // ---- every warp: a share of the dims, draws and column words; actions
  // -1, heightmaps 0
  if (active) {
    tapnet::rows8<NW>(4 * N, wy, [&](int j) {
      return j < N ? io.dims_w[j * B + b]
           : j < 2 * N ? io.dims_d[(j - N) * B + b]
           : j < 3 * N ? io.dims_h[(j - 2 * N) * B + b]
                       : (int)io.rbits[(j - 3 * N) * B + b];
    }, [&](int j, int v) {
      if (j < 3 * N)
        dimS[j * TB] = v;
      else
        drawS[(j - 3 * N) * TB] = v;
    });
    for (int i = wy; i < N; i += NW) {
      upS[i * TB] = limbs(io.upm, i, N, B, b);
      rtS[i * TB] = R == 2 ? limbs(io.rotm, i, N, B, b) : 0;
    }
    for (int t = wy; t < N; t += NW) actS[t * TB] = -1;
    for (int k = wy; k < C * WD; k += NW) {
      if (onchip)
        hmS[k * TB + lane] = 0;
      else
        io.hm_o[k * B + b] = 0;
    }
  }
  __syncthreads();

  // ---- every warp: a share of the row words, the graphs transposed: bit
  // i of dn[j] is bit j of up[i] (the blocks that j blocks)
  if (active)
    for (int j = wy; j < N; j += NW) {
      u64 dn = 0, rdn = 0;
#pragma unroll 4
      for (int i = 0; i < N; ++i) {
        dn |= (upS[i * TB] >> j & 1) << i;
        rdn |= (rtS[i * TB] >> j & 1) << i;
      }
      dnS[j * TB] = dn;
      rdnS[j * TB] = rdn;
    }
  __syncthreads();

  // ---- warp 0 owns the instance's selection state: the unpacked set, the
  // fit words (capped: the placeable words per container in pw), the score
  // context
  u64 unp = 0, fit0 = 0, fit1 = 0;
  // The next step's decision: accessibility (a block is blocked where an
  // unpacked block blocks it: the OR of the unpacked blocks' rows, loads
  // that do not wait on each other), the window (the first `window`
  // accessible blocks), the feasible words and the (draw mod count)-th
  // feasible action in flat (block, rot, container) order, by a binary
  // search over blocks on popcounts (the reference's `_select_general`).
  auto select = [&](int t) {
    int* nx = sel + (t & 1) * 8 * TB;
    u64 bl0 = 0, blr = 0;
#pragma unroll 8
    for (int j = 0; j < N; ++j) {
      const u64 on = 0ull - (unp >> j & 1);
      bl0 |= dnS[j * TB] & on;
      blr |= rdnS[j * TB] & on;
    }
    const u64 a0 = unp & ~bl0, ar = a0 & ~blr;
    u64 w0 = a0;
    if (window > 0) {
      u64 m = a0;
      w0 = 0;
      for (int j = 0; j < window && m; ++j) {
        const u64 low = m & (~m + 1);
        w0 |= low;
        m ^= low;
      }
    }
    const u64 wr = ar & w0;
    int lo = 0, r = 0, cs = 0;
    if (!capped) {
      // every container takes a block alike: rank over (block, rot), then
      // spread over the C containers
      const u64 f0 = w0 & fit0, f1 = wr & fit1;
      const int n = __popcll(f0) + __popcll(f1);
      nx[LIVE * TB] = n > 0;
      if (n == 0) return;  // an empty mask stays empty: the state is final
      const int s = (int)((unsigned)drawS[t * TB] % (unsigned)(n * C));
      const int q = s / C;
      cs = s - q * C;
      int hi = N;  // pairs below lo <= q < pairs below hi
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        const u64 m = (1ull << mid) - 1;
        if (__popcll(f0 & m) + __popcll(f1 & m) <= q)
          lo = mid;
        else
          hi = mid;
      }
      const u64 m = (1ull << lo) - 1;
      const int rem = q - __popcll(f0 & m) - __popcll(f1 & m);
      r = (f0 >> lo & 1) && rem == 0 ? 0 : 1;
    } else {
      const auto word = [&](int rr, int cc) -> u64 {
        return (rr ? wr : w0) & pw[(rr * C + cc) * TB];
      };
      const auto below = [&](u64 lowmask) {
        int n = 0;
        for (int rr = 0; rr < R; ++rr)
          for (int cc = 0; cc < C; ++cc)
            n += __popcll(word(rr, cc) & lowmask);
        return n;
      };
      const int count = below(~0ull);
      nx[LIVE * TB] = count > 0;
      if (count == 0) return;  // an empty mask stays empty: the state is final
      const int s = (int)((unsigned)drawS[t * TB] % (unsigned)count);
      int hi = N;  // below(lo) <= s < below(hi)
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (below((1ull << mid) - 1) <= s)
          lo = mid;
        else
          hi = mid;
      }
      // the rank within the block, over its (rot, container) pairs
      int rem = s - below((1ull << lo) - 1);
      for (int rr = 0, done = 0; rr < R && !done; ++rr)
        for (int cc = 0; cc < C; ++cc)
          if (word(rr, cc) >> lo & 1) {
            if (rem == 0) {
              r = rr;
              cs = cc;
              done = 1;
              break;
            }
            --rem;
          }
    }
    int w = dimS[lo * TB], d = dimS[(N + lo) * TB];
    int h = dimS[(2 * N + lo) * TB];
    tapnet::rotate_dims(c, r, w, d, h);
    nx[BLK * TB] = lo;
    nx[ROT * TB] = r;
    nx[CS * TB] = cs;
    nx[SW * TB] = w;
    nx[SD * TB] = d;
    nx[SH * TB] = h;
  };
  // the blocks that fit in rotation r and, capped, land under the cap on
  // a container with min-landing table ml (nullptr: an empty container,
  // where every landing height is 0)
  const auto placeable = [&](int r, const int* ml) {
    u64 f = 0;
#pragma unroll 4
    for (int i = 0; i < N; ++i) {
      int w = dimS[i * TB], d = dimS[(N + i) * TB];
      int h = dimS[(2 * N + i) * TB];
      tapnet::rotate_dims(c, r, w, d, h);
      if (w > W || d > D) continue;
      const int l = ml ? ml[((w - 1) * D + d - 1) * TB] : 0;
      if (!capped || l + h <= c.cap) f |= 1ull << i;
    }
    return f;
  };
  if (wy == 0 && active) {
    unp = (1ull << io.ntot[b]) - 1;  // real blocks not packed yet
    fit0 = placeable(0, nullptr);
    fit1 = R == 2 ? placeable(1, nullptr) : 0;
    if (capped)
      for (int q = 0; q < RC; ++q) pw[q * TB] = q < C ? fit0 : fit1;
    if (MCS)
      for (int k = 0; k < 5 + C; ++k) ctxS[k * TB] = 0;
    select(0);
  } else if (wy == 0) {
    sel[LIVE * TB] = 0;
  }
  __syncthreads();

  for (int t = 0; t < N; ++t) {
    int* cur = sel + (t & 1) * 8 * TB;   // this step's decision
    int* nxt = sel + (~t & 1) * 8 * TB;  // the next one's
    const bool live = cur[LIVE * TB] != 0;
    const int blk = cur[BLK * TB], r = cur[ROT * TB];
    const int cs = live ? cur[CS * TB] : 0, w = cur[SW * TB];
    const int d = cur[SD * TB], h = cur[SH * TB];
    int* hc = hmS + (onchip ? cs * WD * TB : 0) + lane;  // chosen container
    if (!onchip) {  // stage the chosen container's column
      if (live)
        tapnet::rows8<NW>(WD, wy, [&](int q) {
          return io.hm_o[(cs * WD + q) * B + b];
        }, [&](int q, int v) { hmS[q * TB + lane] = v; });
      __syncthreads();
    }

    // ---- the placing warps (wy % 4 != 0): a share of the candidate
    // offsets each; warp 0, uncapped, meanwhile the next step's decision
    // (without a cap a block that fits always lands, so the step packs blk
    // whatever the offset)
    if (wy == 0) {
      if (!live)
        nxt[LIVE * TB] = 0;  // an empty mask stays empty
      else if (!capped) {
        unp &= ~(1ull << blk);
        if (t + 1 < N) select(t + 1);
      }
    } else if (live && (wy & 3)) {
      const int pi = wy - (wy >> 2) - 1;  // 0 .. NP-1
      tapnet::ScoreCtx sc{0, 0, 0, 0, 0};
      if (MCS)
        sc = tapnet::ScoreCtx{ctxS[0], ctxS[TB], ctxS[2 * TB], ctxS[3 * TB],
                              ctxS[4 * TB]};
      tapnet::place_put<MCS, TB, NP>(
          ppl, pi, lane,
          tapnet::place_part<MCS, TB, NP>(c, hc, w, d, h, sc, pi));
    }
    if (!__syncthreads_or(live)) break;  // every lane's mask is empty

    // ---- the join and the placement: warp 0 records it (under mcs it
    // also writes the footprint, whose old cells give the new score
    // context); under lb each placing warp writes the footprint's rows
    // x + pi, x + pi + NP, ...; capped, the next step's decision comes
    // after the changed container's min-landing table
    if (live && (wy == 0 || (!MCS && (wy & 3)))) {
      const tapnet::Placement p = tapnet::place_resolve<MCS>(
          c, tapnet::place_gather<MCS, TB, NP>(ppl, lane));
      const int top = p.l + h;
      if (wy != 0) {
        if (p.any_valid)
          for (int i = p.x + wy - (wy >> 2) - 1; i < p.x + w; i += NP)
            for (int j = p.y; j < p.y + d; ++j) {
              hc[(i * D + j) * TB] = top;
              if (!onchip) io.hm_o[(cs * WD + i * D + j) * B + b] = top;
            }
      } else {
        cur[CHG * TB] = p.any_valid ? cs : -1;
        if (p.any_valid) {  // else nothing is written, the action stays -1
          actS[t * TB] = blk * RC + r * C + cs;
          rec[blk * TB] = p.x | p.y << 16;
          rec[(N + blk) * TB] = p.l * 2 + p.stable;
          rec[(2 * N + blk) * TB] = r | cs << 8;
          if (MCS) {
            int fpsum = 0;
            for (int i = p.x; i < p.x + w; ++i)
              for (int j = p.y; j < p.y + d; ++j) {
                fpsum += hc[(i * D + j) * TB];
                hc[(i * D + j) * TB] = top;
                if (!onchip) io.hm_o[(cs * WD + i * D + j) * B + b] = top;
              }
            int* mx = ctxS + (5 + cs) * TB;
            ctxS[0] += w * d * h;
            ctxS[TB] += WD * (max(*mx, top) - *mx);
            ctxS[2 * TB] += w * d * top - fpsum;
            ctxS[3 * TB] += p.stable;
            ctxS[4 * TB] += 1;
            *mx = max(*mx, top);
          }
          if (capped) unp &= ~(1ull << blk);
        }
      }
    }
    if (capped) {
      // every warp: the changed container's min-landing table, the warps
      // taking its footprint widths i + 1; then warp 0 renews that
      // container's placeable words and selects
      __syncthreads();
      const int chg = live ? cur[CHG * TB] : -1;
      if (chg >= 0 && D <= 16)
        for (int i = wy; i < W; i += NW) {
          // per x the column maxima over rows x..x+i, then the running
          // maxima along y: 16-wide register rows
          int tr[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) tr[j] = tapnet::BIG;
          for (int x = 0; x + i < W; ++x) {
            int cm[16];
#pragma unroll
            for (int y = 0; y < 16; ++y) cm[y] = 0;
            for (int q = x; q <= x + i; ++q)
#pragma unroll
              for (int y = 0; y < 16; ++y)
                if (y < D) cm[y] = max(cm[y], hc[(q * D + y) * TB]);
#pragma unroll
            for (int y = 0; y < 16; ++y) {
              int m = 0;
#pragma unroll
              for (int j = 0; j < 16; ++j)
                if (y + j < 16 && y + j < D) {
                  m = max(m, cm[y + j]);
                  tr[j] = min(tr[j], m);
                }
            }
          }
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (j < D) minl[(i * D + j) * TB] = tr[j];
        }
      else if (chg >= 0)
        for (int i = wy; i < W; i += NW) {
          for (int j = 0; j < D; ++j) minl[(i * D + j) * TB] = tapnet::BIG;
          for (int x = 0; x + i < W; ++x)
            for (int y = 0; y < D; ++y) {
              int m = 0;
              for (int j = 0; y + j < D; ++j) {
                for (int q = x; q <= x + i; ++q)
                  m = max(m, hc[(q * D + y + j) * TB]);
                int* e = minl + (i * D + j) * TB;
                *e = min(*e, m);
              }
            }
        }
      __syncthreads();
      if (wy == 0 && live) {
        if (chg >= 0)
          for (int rr = 0; rr < R; ++rr)
            pw[(rr * C + chg) * TB] = placeable(rr, minl);
        if (t + 1 < N) select(t + 1);
      }
    }
    __syncthreads();
  }

  // ---- the final state, every warp a share of the rows
  if (wy == 0) *unpS = unp;
  __syncthreads();
  if (!active) return;
  const u64 left = *unpS;
  const u64 placed = ~left & ((1ull << io.ntot[b]) - 1);
  for (int t = wy; t < N; t += NW) io.act_o[t * B + b] = actS[t * TB];
  for (int i = wy; i < N; i += NW) io.packed_o[i * B + b] = !(left >> i & 1);
  for (int q = wy; q < 6 * N; q += NW) {
    const int i = q / 6, f = q - 6 * i;
    int v = -1;
    if (placed >> i & 1) {
      const int e = rec[((f < 2 ? 2 * N : f < 4 ? 0 : N) + i) * TB];
      v = f == 0 ? e >> 8 : f == 1 ? e & 255 : f == 2 ? e & 0xffff
        : f == 3 ? e >> 16 : f == 4 ? e >> 1 : e & 1;
    }
    io.plc_o[q * B + b] = v;
  }
  if (onchip)
    tapnet::rows8<NW>(C * WD, wy, [&](int q) { return hmS[q * TB + lane]; },
                      [&](int q, int v) { io.hm_o[q * B + b] = v; });
}

bool plan_onchip(const tapnet::EnvCfg& c, bool capped) {
  return plan_bytes(plan(c.N, c.R, c.C, c.W * c.D, capped, c.mcs, true)) <=
         SMEM_MAX;
}

}  // namespace

// ints: B, the EnvCfg fields (select_place.cuh env_cfg), window, capped.
// 1 where the rollout keeps every heightmap in shared memory, 0 where it
// keeps them in hm_o and stages the chosen container per step.
extern "C" int tapnet_rollout_onchip(const int* ints) {
  return plan_onchip(tapnet::env_cfg(ints + 1),
                     ints[2 + tapnet::ENV_INTS] != 0);
}

// ptrs: dims_w, dims_d, dims_h, upm, rotm, ntot, rbits,      (0-6)
//       hm_o, packed_o, act_o, plc_o                         (7-10)
// ints: B, the EnvCfg fields (select_place.cuh env_cfg), window, capped
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int tapnet_fused_rollout(void* const* p, const int* ints,
                                    void* stream) {
  const int B = ints[0];
  const tapnet::EnvCfg c = tapnet::env_cfg(ints + 1);
  const int window = ints[1 + tapnet::ENV_INTS];
  const bool capped = ints[2 + tapnet::ENV_INTS] != 0;
  if (c.N > MAX_N || c.R * c.C > MAX_RC || c.W * c.D > tapnet::MAX_WD ||
      B <= 0)
    return (int)cudaErrorInvalidValue;
  const bool onchip = plan_onchip(c, capped);
  const size_t smem =
      plan_bytes(plan(c.N, c.R, c.C, c.W * c.D, capped, c.mcs, onchip));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const RolloutIO io{(const int*)p[0], (const int*)p[1], (const int*)p[2],
                     (const int*)p[3], (const int*)p[4], (const int*)p[5],
                     (const unsigned*)p[6], (int*)p[7], (int*)p[8],
                     (int*)p[9], (int*)p[10]};
  auto kernel = c.mcs ? rollout_kernel<true> : rollout_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + TB - 1) / TB, dim3(TB, NW), smem, (cudaStream_t)stream>>>(
      c, io, window, (int)capped, (int)onchip, B);
  return (int)cudaGetLastError();
}
