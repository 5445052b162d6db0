// heightmap_reductions: per-container int32 max and sum of the heightmaps.
//
// Replaces: tapnet_tpu/ops/pallas_reward.py::heightmap_reductions (kernel
// body `_reduce_kernel`), the two reductions behind the compactness and
// pyramidality denominators of the C/P/S reward.
//
// Bound: bytes. It reads B*C*W*D int32 cells once and writes 2*B*C int32
// (168 KB at 2d-basic, batch 4096: 0.05 us at 3.35 TB/s), so on this card it
// is bound by the launch itself, not by the memory.
//
// Design: one thread per (instance, container) row of the batch-major
// heightmap [B*C, W*D]; each thread walks its row's cells, so neighbouring
// threads read neighbouring rows and every cache line a warp touches is used
// by that warp. Integer max and sum in int32: bit-equal to the reference.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
reduce_kernel(const int* __restrict__ hm, int rows, int cells,
              int* __restrict__ mx_o, int* __restrict__ sum_o) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= rows) return;
  const int* p = hm + (size_t)r * cells;
  int mx = p[0], sm = 0;
  for (int k = 0; k < cells; ++k) {
    const int v = p[k];
    mx = max(mx, v);
    sm += v;
  }
  mx_o[r] = mx;
  sum_o[r] = sm;
}

}  // namespace

// hm: int32 [rows, cells] (rows = B*C, cells = W*D); mx_o, sum_o: int32
// [rows]. Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int tapnet_heightmap_reductions(const void* hm, int rows,
                                           int cells, void* mx_o,
                                           void* sum_o, void* stream) {
  if (rows <= 0 || cells <= 0) return (int)cudaErrorInvalidValue;
  reduce_kernel<<<(rows + THREADS - 1) / THREADS, THREADS, 0,
                  (cudaStream_t)stream>>>((const int*)hm, rows, cells,
                                          (int*)mx_o, (int*)sum_o);
  return (int)cudaGetLastError();
}
