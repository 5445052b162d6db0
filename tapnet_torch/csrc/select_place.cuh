// Placing one block for one instance: the bodies shared by the select_step
// kernel (policy_step.cu), the actor_select_step kernel (actor_step.cu) and
// the heuristic whole-rollout kernel (env.cu), kept once as
// tapnet_tpu/ops/pallas_policy_step.py keeps `select_place` once.
//
// Semantics (bit-equal to pallas_policy_step.select_place and to
// env.core.choose_placement / step):
// - select_place: the action is the lowest index attaining the f32 max of
//   the score; `valid` = any mask bit set;
// - place_block: candidate offsets (x, y) with x <= W - w, y <= D - d and
//   l + h <= cap, l the footprint's maximum height.
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
// pairwise tournament over u32 limbs. Here one thread owns one instance and
// walks only the valid offsets; the support test scans the footprint for
// cells at the landing height, which is what the stacked rowmax/colmax
// compare computed; an mcs score is two 64-bit integers and a comparison is
// two 64x64 -> 128-bit products (`__umul64hi`). The order (class, exact
// score, lowest key) is total, so a running best over the walk finds the
// tournament's winner.
#pragma once

#include <cuda_runtime.h>

namespace tapnet {

constexpr int BIG = 1 << 30;
constexpr int MAX_WD = 256;  // W*D cells of one container held per thread

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

// Where a (w, d, h) block goes on the heightmap hm[W*D] of its container.
// `sc` is read only under MCS.
template <bool MCS>
__device__ __forceinline__ Placement place_block(const EnvCfg& c,
                                                 const int* hm, int w, int d,
                                                 int h, const ScoreCtx& sc) {
  const int W = c.W, D = c.D;
  // lb: best soft / hard candidate: key, x, y, landing, stable
  int ks = BIG, xs = 0, ys = 0, ls = 0, ss = 0;
  int kh = BIG, xh = 0, yh = 0, lh = 0;
  // mcs: the running best's class and score
  int bcls = 0, cur_maxh = 0;
  unsigned long long bn = 0, bd = 0;
  if (MCS)
    for (int k = 0; k < W * D; ++k) cur_maxh = max(cur_maxh, hm[k]);
  for (int x = 0; x + w <= W; ++x) {
    for (int y = 0; y + d <= D; ++y) {
      int l = 0;
      for (int i = x; i < x + w; ++i)
        for (int j = y; j < y + d; ++j) l = max(l, hm[i * D + j]);
      if (l + h > c.cap) continue;
      bool st = true;
      if (l > 0) {
        int imin = BIG, imax = -BIG, jmin = BIG, jmax = -BIG;
        for (int i = x; i < x + w; ++i)
          for (int j = y; j < y + d; ++j)
            if (hm[i * D + j] == l) {
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
          for (int j = y; j < y + d; ++j) fpsum += hm[i * D + j];
        const int top = l + h;
        unsigned long long n, dn;
        mcs_fraction(c.terms, sc.vol + w * d * h,
                     sc.denc + W * D * (max(cur_maxh, top) - cur_maxh),
                     sc.denp + w * d * top - fpsum, sc.snum + (int)st,
                     sc.sden + 1, n, dn);
        const int cls = 1 + (c.hard && st);
        bool gt, eq;
        frac_cmp(n, dn, bn, bd, gt, eq);
        if (cls > bcls || (cls == bcls && (gt || (eq && key < ks)))) {
          bcls = cls; bn = n; bd = dn;
          ks = key; xs = x; ys = y; ls = l; ss = st;
        }
      } else {
        if (key < ks) {
          ks = key; xs = x; ys = y; ls = l; ss = st;
        }
        if (st && key < kh) {
          kh = key; xh = x; yh = y; lh = l;
        }
      }
    }
  }
  if (!MCS && c.hard && kh < BIG) {
    xs = xh; ys = yh; ls = lh; ss = 1;
  }
  return Placement{xs, ys, ls, ss, ks < BIG};
}

// Score(a) -> float and Mask(a) -> int read the instance's action row.
template <bool MCS, class Score, class Mask>
__device__ int select_place(const EnvCfg& c, const Score& score,
                            const Mask& mask, const StepIO& io, int B, int b) {
  const int A = c.N * c.R * c.C;
  float best = score(0);
  int a_sel = 0;
  bool valid = mask(0) > 0;
  for (int a = 1; a < A; ++a) {
    const float s = score(a);
    if (s > best) {
      best = s;
      a_sel = a;
    }
    valid |= mask(a) > 0;
  }

  const int blk = a_sel / (c.R * c.C);
  const int r = (a_sel / c.C) % c.R;
  const int cs = a_sel % c.C;
  int w = io.dims_w[blk * B + b];
  int d = io.dims_d[blk * B + b];
  int h = io.dims_h[blk * B + b];
  rotate_dims(c, r, w, d, h);

  const int D = c.D, WD = c.W * c.D;
  int hm[MAX_WD];
  for (int k = 0; k < WD; ++k) hm[k] = io.hm[(cs * WD + k) * B + b];

  ScoreCtx sc{0, 0, 0, 0, 0};
  if (MCS)
    sc = score_ctx(c, io.hm, io.plc, io.dims_w, io.dims_d, io.dims_h, B, b);
  const Placement p = place_block<MCS>(c, hm, w, d, h, sc);
  const int xs = p.x, ys = p.y;
  const bool dop = valid && p.any_valid;

  for (int i = 0; i < c.N; ++i)
    io.packed_o[i * B + b] = io.packed[i * B + b] + (dop && i == blk);
  const int top = p.l + h;
  for (int k = 0; k < c.C * WD; ++k) {
    const int cc = k / WD, x = (k % WD) / D, y = k % D;
    const bool fp = dop && cc == cs && x >= xs && x < xs + w && y >= ys &&
                    y < ys + d;
    io.hm_o[k * B + b] = fp ? top : io.hm[k * B + b];
  }
  const int row[6] = {cs, r, xs, ys, p.l, p.stable};
  for (int k = 0; k < c.N * 6; ++k) {
    const bool wr = dop && k / 6 == blk;
    io.plc_o[k * B + b] = wr ? row[k % 6] : io.plc[k * B + b];
  }
  const int act = valid ? a_sel : -1;
  io.act_o[b] = act;
  return act;
}

}  // namespace tapnet
