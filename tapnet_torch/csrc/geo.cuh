// The head's geometry, shared by the actor step (actor_step.cu) and the
// replay kernels (replay.cu). Both run blocks of GEO_NWARP warps over a
// tile of GEO_TB instances, one a lane; each includer checks that its own
// constants agree.
//
// At h <= 128 the head (K2's phases 1-2; the replay's encoder, query,
// token work and their backward) runs in one pass over the tile's 32
// instances; above (WH, h = 160..256) in NP = 2 passes of TP = 16
// instances each, so that the [feature][instance] arrays, q, dq and the
// token view fit a block's shared memory with a thread's register tile as
// at h = 128: a thread of the encoder/query products owns h / NVW <= 8
// rows of one instance (NVW virtual warps of TP lanes), a lane of the
// token work MAXR = 8 rows of CPW = 2 columns.
#pragma once

namespace tapnet {

constexpr int GEO_TB = 32;     // instances of a block's tile
constexpr int GEO_NWARP = 16;  // warps of a block

template <bool WH>
struct Geo {
  static constexpr int TP = WH ? 16 : GEO_TB;  // instances of a head pass
  static constexpr int LP = TP + 1;            // their arrays' row stride
  static constexpr int NP = GEO_TB / TP;       // passes
  static constexpr int NVW = GEO_TB * GEO_NWARP / TP;  // virtual warps
  static constexpr int CPW = WH ? 2 : 4;     // columns per warp in a group
  static constexpr int G = CPW * GEO_NWARP;  // columns per token group
  static constexpr int MAXR = WH ? 8 : 4;    // rows per lane: h <= 32 MAXR
  static constexpr int KS = WH ? 32 : 64;    // f32: k rows of a staged slice
  static constexpr int JS = WH ? 8 : 32;     // f32: j rows of a slice (mvt)
  static constexpr int KSL = WH ? 32 : 64;   // tc: columns of a weight slab
};

}  // namespace tapnet
