// select/place for one instance: the body shared by the select_step kernel
// (policy_step.cu) and the actor_select_step kernel (actor_step.cu), kept
// once as tapnet_tpu/ops/pallas_policy_step.py keeps `select_place` once.
//
// Semantics (bit-equal to pallas_policy_step.select_place for the lb rule):
// - the action is the lowest index attaining the f32 max of the score;
//   `valid` = any mask bit set;
// - candidate offsets (x, y) with x <= W - w, y <= D - d and l + h <= cap are
//   keyed (l*W + x)*D + y, the minimum wins; the hard variant prefers stable
//   offsets and falls back to soft when none is stable;
// - stable: l == 0, or the footprint's cells at height l span the block's
//   centre along x and along y, in doubled coordinates;
// - do = valid & any candidate; heightmap, packed and placements are
//   updated only where do; act = valid ? a : -1.
//
// The TPU kernel scored every offset at once with stacked shifts of the
// heightmap (a layout device for 128 lanes). Here one thread owns one
// instance and walks only the valid offsets; the support test scans the
// footprint for cells at the landing height, which is what the stacked
// rowmax/colmax compare computed.
#pragma once

#include <cuda_runtime.h>

namespace tapnet {

constexpr int BIG = 1 << 30;
constexpr int MAX_WD = 256;  // W*D cells of one container held per thread

struct EnvCfg {
  int N, W, D, R, C;  // blocks, target width, depth, rotations, containers
  int hard;           // lb-hard variant
  int cap;            // height cap (height_cap of the config)
  int two_d;          // 2D: rotation swaps (w, h); 3D: rotation swaps (w, d)
};

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

// Score(a) -> float and Mask(a) -> int read the instance's action row.
template <class Score, class Mask>
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
  const int w0 = io.dims_w[blk * B + b];
  const int d0 = io.dims_d[blk * B + b];
  const int h0 = io.dims_h[blk * B + b];
  int w = w0, d = d0, h = h0;
  if (r == 1) {
    if (c.two_d) {
      w = h0;
      h = w0;
    } else {
      w = d0;
      d = w0;
    }
  }

  const int W = c.W, D = c.D, WD = c.W * c.D;
  int hm[MAX_WD];
  for (int k = 0; k < WD; ++k) hm[k] = io.hm[(cs * WD + k) * B + b];

  // best soft / hard candidate: key, x, y, landing, stable
  int ks = BIG, xs = 0, ys = 0, ls = 0, ss = 0;
  int kh = BIG, xh = 0, yh = 0, lh = 0;
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
      if (key < ks) {
        ks = key; xs = x; ys = y; ls = l; ss = st;
      }
      if (st && key < kh) {
        kh = key; xh = x; yh = y; lh = l;
      }
    }
  }
  if (c.hard && kh < BIG) {
    xs = xh; ys = yh; ls = lh; ss = 1;
  }
  const bool any_valid = ks < BIG;
  const bool dop = valid && any_valid;

  for (int i = 0; i < c.N; ++i)
    io.packed_o[i * B + b] = io.packed[i * B + b] + (dop && i == blk);
  const int top = ls + h;
  for (int k = 0; k < c.C * WD; ++k) {
    const int cc = k / WD, x = (k % WD) / D, y = k % D;
    const bool fp = dop && cc == cs && x >= xs && x < xs + w && y >= ys &&
                    y < ys + d;
    io.hm_o[k * B + b] = fp ? top : io.hm[k * B + b];
  }
  const int row[6] = {cs, r, xs, ys, ls, ss};
  for (int k = 0; k < c.N * 6; ++k) {
    const bool wr = dop && k / 6 == blk;
    io.plc_o[k * B + b] = wr ? row[k % 6] : io.plc[k * B + b];
  }
  const int act = valid ? a_sel : -1;
  io.act_o[b] = act;
  return act;
}

}  // namespace tapnet
