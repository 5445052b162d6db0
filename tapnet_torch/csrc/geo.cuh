// The head's geometry, shared by the actor step (actor_step.cu) and the
// replay kernels (replay.cu). Both run blocks of GEO_NWARP warps over a
// tile of GEO_TB instances, one a lane; each includer checks that its own
// constants agree.
//
// Three width classes WC (`geo_class`): at h <= 128 (WC = 0) the head (K2's
// phases 1-2; the replay's encoder, query, token work and their backward)
// runs in one pass over the tile's 32 instances; above (WH, WC = 1, h =
// 160..256) in NP = 2 passes of TP = 16 instances each, so that the
// [feature][instance] arrays, q, dq and the token view fit a block's shared
// memory with a thread's register tile as at h = 128: a thread of the
// encoder/query products owns h / NVW <= 8 rows of one instance (NVW
// virtual warps of TP lanes), a lane of the token work MAXR = 8 rows of
// CPW = 2 columns. Above 256 (WX, WC = 2, h = 320..512, a multiple of 64)
// the passes stay those of WH; the products whose warps own 16-row tiles
// run over the weights' two row halves of HR = h / 2 rows in turn (each
// half as a WH product of HR rows), the [feature][instance] arrays that
// grow with h (q, dq, the encoder view) move to a per-block scratch in
// device memory (read back through L1 / L2), and a lane of the token work
// owns MAXR = 16 rows of CPW = 1 column (G = 16 columns a group).
#pragma once

namespace tapnet {

constexpr int GEO_TB = 32;     // instances of a block's tile
constexpr int GEO_NWARP = 16;  // warps of a block

// the width class of hidden width h
__host__ __device__ constexpr int geo_class(int h) {
  return h <= 128 ? 0 : h <= 256 ? 1 : 2;
}

template <int WC>
struct Geo {
  static constexpr bool WH = WC > 0;           // above hidden 128
  static constexpr bool WX = WC > 1;           // above hidden 256
  static constexpr int TP = WH ? 16 : GEO_TB;  // instances of a head pass
  static constexpr int LP = TP + 1;            // their arrays' row stride
  static constexpr int NP = GEO_TB / TP;       // passes
  static constexpr int NVW = GEO_TB * GEO_NWARP / TP;  // virtual warps
  static constexpr int CPW = WX ? 1 : WH ? 2 : 4;  // columns per warp
  static constexpr int G = CPW * GEO_NWARP;  // columns per token group
  static constexpr int MAXR = WX ? 16 : WH ? 8 : 4;  // rows per lane
  static constexpr int RWMAX = WX ? 16 : 8;  // f32: rows of a thread (mv)
  static constexpr int KS = WX ? 16 : WH ? 32 : 64;  // f32: k rows a slice
  static constexpr int JS = WH ? 8 : 32;     // f32: j rows of a slice (mvt)
  static constexpr int KSL = WH ? 32 : 64;   // tc: columns of a weight slab
  static constexpr int NH = WX ? 2 : 1;      // row halves of the products
};

}  // namespace tapnet
