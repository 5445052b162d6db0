// Placing one block per instance over a tile's warps: the placement body
// shared by the select_step kernel (policy_step.cu), the actor_select_step
// kernel (actor_step.cu) and the heuristic whole-rollout kernel (env.cu),
// kept once as tapnet_tpu/ops/pallas_policy_step.py keeps `select_place`
// once.
//
// Semantics (bit-equal to pallas_policy_step.select_place and to
// env.core.choose_placement / step):
// - the action is the lowest index attaining the f32 max of the score;
//   `valid` = any mask bit set;
// - candidate offsets (x, y) with x <= W - w, y <= D - d and l + h <= cap,
//   l the footprint's maximum height.
//   `lb` rule: keyed (l*W + x)*D + y, the minimum wins; the hard variant
//   prefers stable offsets and falls back to soft when none is stable.
//   `mcs` rule: the candidate whose placement gives the highest score wins,
//   the score being the sum of the configured C/P/S fractions after the
//   placement, compared exactly; class first (stable above unstable under
//   hard), ties to the lowest lb key;
// - stable: l == 0, or the footprint's cells at height l span the block's
//   centre along x and along y, in doubled coordinates;
// - do = valid & any candidate; heightmap, packed and placements are
//   updated only where do; act = valid ? a : -1.
//
// The TPU kernels scored every offset at once with stacked shifts of the
// heightmap (a layout device for 128 lanes) and found the mcs winner by a
// pairwise tournament over u32 limbs. Here a block of the kernels is a tile
// of TB instances, one per lane (every batch-last row is read and written
// coalesced), with NW warps: the chosen container's heightmap column lies
// in shared memory ([cell][TB]), each warp walks its share of the candidate
// offsets (`place_part`), writes its winner (`place_put`), and one warp
// joins the winners (`place_gather`) and resolves the placement
// (`place_resolve`). The order (class, exact score, lowest key) is total,
// so the join of the warps' winners over disjoint offsets is the winner
// over all of them. An mcs score is two 64-bit integers and a comparison
// two 64x64 -> 128-bit products (`__umul64hi`).
#pragma once

#include <cuda_runtime.h>

namespace tapnet {

constexpr int BIG = 1 << 30;
constexpr int MAX_WD = 256;  // W*D cells of one container (the kernels'
                             // shared-memory plans assume at most this)

struct EnvCfg {
  int N, W, D, R, C;  // blocks, target width, depth, rotations, containers
  int hard;           // hard variant (prefer stable offsets)
  int cap;            // height cap (height_cap of the config)
  int two_d;          // 2D: rotation swaps (w, h); 3D: rotation swaps (w, d)
  int mcs;            // placement rule: 0 = lb, 1 = mcs
  int terms;          // mcs reward terms, a bit each: C = 1, P = 2, S = 4
};

// ints: N, W, D, R, C, hard, cap, two_d, mcs, terms (ops/policy_step.py
// env_ints)
constexpr int ENV_INTS = 10;
inline EnvCfg env_cfg(const int* v) {
  return EnvCfg{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9]};
}

// Env state, batch-last: element (row, b) lives at row * B + b.
struct StepIO {
  const int* packed;  // [N, B]
  const int* hm;      // [C*W*D, B]
  const int* plc;     // [N*6, B]
  const int* dims_w;  // [N, B]
  const int* dims_d;
  const int* dims_h;
  int* packed_o;
  int* hm_o;
  int* plc_o;
  int* act_o;         // [B]
};

// Reward aggregates of a state (env.core.reward_terms), the context an mcs
// score is formed from.
struct ScoreCtx {
  int vol, denc, denp, snum, sden;
};

struct Placement {
  int x, y, l, stable;
  bool any_valid;
};

// (w, d, h) of a block under rotation state r.
__device__ __forceinline__ void rotate_dims(const EnvCfg& c, int r, int& w,
                                            int& d, int& h) {
  if (r == 1) {
    const int w0 = w;
    if (c.two_d) {
      w = h;
      h = w0;
    } else {
      w = d;
      d = w0;
    }
  }
}

// Aggregates of instance b's state: placed blocks are those with
// plc[i*6] >= 0 (blocks pre-packed as padding never are).
__device__ inline ScoreCtx score_ctx(const EnvCfg& c, const int* hm,
                                     const int* plc, const int* dims_w,
                                     const int* dims_d, const int* dims_h,
                                     int B, int b) {
  ScoreCtx s{0, 0, 0, 0, 0};
  for (int i = 0; i < c.N; ++i) {
    if (plc[(i * 6) * B + b] < 0) continue;
    s.vol += dims_w[i * B + b] * dims_d[i * B + b] * dims_h[i * B + b];
    s.snum += plc[(i * 6 + 5) * B + b];
    s.sden += 1;
  }
  const int WD = c.W * c.D;
  for (int cc = 0; cc < c.C; ++cc) {
    int mx = 0;
    for (int k = 0; k < WD; ++k) {
      const int v = hm[(cc * WD + k) * B + b];
      mx = max(mx, v);
      s.denp += v;
    }
    s.denc += WD * mx;
  }
  return s;
}

// The sum of the configured terms C = vol/dc, P = vol/dp, S = sn/sd as one
// exact fraction n/d. The config's guard keeps n and d below 2^63.
__device__ __forceinline__ void mcs_fraction(int terms, int vol, int dc,
                                             int dp, int sn, int sd,
                                             unsigned long long& n,
                                             unsigned long long& d) {
  n = 0;
  d = 1;
  const int tn[3] = {vol, vol, sn}, td[3] = {dc, dp, sd};
  for (int k = 0; k < 3; ++k)
    if (terms >> k & 1) {
      n = n * (unsigned long long)td[k] + (unsigned long long)tn[k] * d;
      d *= (unsigned long long)td[k];
    }
}

// n1/d1 > n2/d2 (gt) or == (eq), exactly: n1*d2 against n2*d1 in 128 bits.
__device__ __forceinline__ void frac_cmp(unsigned long long n1,
                                         unsigned long long d1,
                                         unsigned long long n2,
                                         unsigned long long d2, bool& gt,
                                         bool& eq) {
  const unsigned long long ah = __umul64hi(n1, d2), al = n1 * d2;
  const unsigned long long bh = __umul64hi(n2, d1), bl = n2 * d1;
  gt = ah > bh || (ah == bh && al > bl);
  eq = ah == bh && al == bl;
}

// store(r, load(r)) for the rows r = wy, wy + NW, ... < n of a warp, eight
// loads in flight at a time.
template <int NW, class Load, class Store>
__device__ __forceinline__ void rows8(int n, int wy, Load load, Store store) {
  using V = decltype(load(0));
  for (int r0 = wy; r0 < n; r0 += 8 * NW) {
    V v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = r0 + u * NW;
      v[u] = r < n ? load(r) : V();
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = r0 + u * NW;
      if (r < n) store(r, v[u]);
    }
  }
}

// A warp's winner over its share of the candidate offsets: the best soft
// and hard lb candidates (key, stable of the soft one; the key
// (l*W + x)*D + y gives l, x, y), or under MCS the best (class, exact
// score, key) and its stable flag.
struct PlacePart {
  int ks, ss, kh, cls;
  unsigned long long n, d;
};

// f(v, i, j) for the cells (i, j) of the footprint (x, y, w, d) on the
// heightmap column hm[k*TB], four loads in flight at a time, while go()
// holds (checked every four cells). A footprint one cell deep (every 2D
// one) is walked along x.
template <int TB, class F, class Go>
__device__ __forceinline__ void footprint(const int* hm, int D, int x, int y,
                                          int w, int d, F f, Go go) {
  const bool along_x = d == 1;
  const int no = along_x ? 1 : w, ni = along_x ? w : d;
  const int si = along_x ? D * TB : TB;
  for (int a = 0; a < no && go(); ++a) {
    const int* p = hm + ((x + a) * D + y) * TB;
    for (int e = 0; e < ni && go(); e += 4) {
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = e + u < ni ? p[(e + u) * si] : 0;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e + u < ni)
          f(v[u], along_x ? x + e + u : x + a, along_x ? y : y + e + u);
    }
  }
}

// The winner over the candidate offsets o = wy, wy + NW, ... (o = x*ny + y,
// ny = D - d + 1) of a (w, d, h) block on the heightmap column hm[k*TB]
// (cell k = x*D + y of one container, the lane's column of a [cell][TB]
// array in shared memory). Under lb a candidate is dropped as soon as its
// running landing height puts its key at or above the key it would have to
// beat (the hard candidate's under the hard variant, else the soft one's),
// and only a candidate that could win is tested for support; under mcs one
// pass gives the landing height, the footprint sum and the support.
template <bool MCS, int TB, int NW>
__device__ __forceinline__ PlacePart place_part(const EnvCfg& c,
                                                const int* hm, int w, int d,
                                                int h, const ScoreCtx& sc,
                                                int wy) {
  const int W = c.W, D = c.D;
  PlacePart b{BIG, 0, BIG, 0, 0ull, 0ull};
  const int nx = W - w + 1, ny = D - d + 1;
  if (nx <= 0 || ny <= 0 || wy >= nx * ny) return b;
  int cur_maxh = 0;
  if (MCS)
    for (int k = 0; k < W * D; ++k) cur_maxh = max(cur_maxh, hm[k * TB]);
  const int sx = NW / ny, sy = NW - sx * ny;  // the stride in (x, y)
  int x = wy / ny, y = wy - (wy / ny) * ny;
  const auto always = [] { return true; };
  for (; x < nx; x += sx, y += sy) {
    if (y >= ny) {
      y -= ny;
      ++x;
      if (x >= nx) break;
    }
    int l = 0;
    if (MCS) {
      int fpsum = 0, imin = BIG, imax = -BIG, jmin = BIG, jmax = -BIG;
      footprint<TB>(hm, D, x, y, w, d, [&](int v, int i, int j) {
        fpsum += v;
        if (v > l) {
          l = v;
          imin = imax = i;
          jmin = jmax = j;
        } else if (v == l) {
          imin = min(imin, i);
          imax = max(imax, i);
          jmin = min(jmin, j);
          jmax = max(jmax, j);
        }
      }, always);
      if (l + h > c.cap) continue;
      const int cx2 = 2 * x + w - 1, cy2 = 2 * y + d - 1;
      const bool st = l == 0 || (2 * imin <= cx2 && cx2 <= 2 * imax &&
                                 2 * jmin <= cy2 && cy2 <= 2 * jmax);
      const int key = (l * W + x) * D + y, top = l + h;
      unsigned long long n, dn;
      mcs_fraction(c.terms, sc.vol + w * d * h,
                   sc.denc + W * D * (max(cur_maxh, top) - cur_maxh),
                   sc.denp + w * d * top - fpsum, sc.snum + (int)st,
                   sc.sden + 1, n, dn);
      const int cls = 1 + (c.hard && st);
      bool gt, eq;
      frac_cmp(n, dn, b.n, b.d, gt, eq);
      if (cls > b.cls || (cls == b.cls && (gt || (eq && key < b.ks))))
        b = PlacePart{key, st, BIG, cls, n, dn};
    } else {
      // the key to beat, and the landing height at which it is reached
      const int kt = c.hard ? b.kh : b.ks;
      const int lt = kt >= BIG ? BIG : (kt - x * D - y + W * D - 1) / (W * D);
      const int lmax = min(c.cap - h, lt - 1);
      footprint<TB>(hm, D, x, y, w, d,
                    [&](int v, int, int) { l = max(l, v); },
                    [&] { return l <= lmax; });
      if (l > lmax) continue;
      const int key = (l * W + x) * D + y;
      bool st = true;
      if (l > 0) {
        int imin = BIG, imax = -BIG, jmin = BIG, jmax = -BIG;
        footprint<TB>(hm, D, x, y, w, d, [&](int v, int i, int j) {
          if (v == l) {
            imin = min(imin, i);
            imax = max(imax, i);
            jmin = min(jmin, j);
            jmax = max(jmax, j);
          }
        }, always);
        const int cx2 = 2 * x + w - 1, cy2 = 2 * y + d - 1;
        st = 2 * imin <= cx2 && cx2 <= 2 * imax && 2 * jmin <= cy2 &&
             cy2 <= 2 * jmax;
      }
      if (key < b.ks) {
        b.ks = key;
        b.ss = st;
      }
      if (st && key < b.kh) b.kh = key;
    }
  }
  return b;
}

// Joins partial winner q into the running winner b (place_part's order);
// the soft and hard lb candidates are taken apart.
template <bool MCS>
__device__ __forceinline__ void place_join(PlacePart& b, const PlacePart& q) {
  if (MCS) {
    if (q.ks >= BIG) return;
    bool gt, eq;
    frac_cmp(q.n, q.d, b.n, b.d, gt, eq);
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

// Warp wy's winner into ppl [k][NW][TB] (k < 3 under lb, < 8 under mcs).
template <bool MCS, int TB, int NW>
__device__ __forceinline__ void place_put(int* ppl, int wy, int lane,
                                          const PlacePart& q) {
  int* p = ppl + wy * TB + lane;
  p[0] = q.ks;
  p[NW * TB] = q.ss;
  p[2 * NW * TB] = MCS ? q.cls : q.kh;
  if (MCS) {
    p[3 * NW * TB] = (int)(unsigned)q.n;
    p[4 * NW * TB] = (int)(unsigned)(q.n >> 32);
    p[5 * NW * TB] = (int)(unsigned)q.d;
    p[6 * NW * TB] = (int)(unsigned)(q.d >> 32);
  }
}

// The join of the NW winners in ppl, in warp order.
template <bool MCS, int TB, int NW>
__device__ __forceinline__ PlacePart place_gather(const int* ppl, int lane) {
  PlacePart b{BIG, 0, BIG, 0, 0ull, 0ull};
  for (int w = 0; w < NW; ++w) {
    const int* p = ppl + w * TB + lane;
    PlacePart q{p[0], p[NW * TB], BIG, 0, 0ull, 0ull};
    if (MCS) {
      q.cls = p[2 * NW * TB];
      q.n = (unsigned long long)(unsigned)p[3 * NW * TB] |
            (unsigned long long)(unsigned)p[4 * NW * TB] << 32;
      q.d = (unsigned long long)(unsigned)p[5 * NW * TB] |
            (unsigned long long)(unsigned)p[6 * NW * TB] << 32;
    } else {
      q.kh = p[2 * NW * TB];
    }
    place_join<MCS>(b, q);
  }
  return b;
}

// The placement of the joined winner: the hard lb variant prefers the
// stable candidate, else the soft one; no candidate gives zeros and
// any_valid = false.
template <bool MCS>
__device__ __forceinline__ Placement place_resolve(const EnvCfg& c,
                                                   const PlacePart& b) {
  if (b.ks >= BIG) return Placement{0, 0, 0, 0, false};
  const bool hard = !MCS && c.hard && b.kh < BIG;
  const int key = hard ? b.kh : b.ks, W = c.W, D = c.D;
  return Placement{(key / D) % W, key % D, key / (W * D), hard || b.ss,
                   true};
}

}  // namespace tapnet
