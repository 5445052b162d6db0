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
// hundred operations per instance.
//
// Design: one thread per instance (neighbouring threads take neighbouring
// instances, so every batch-last row is read and written coalesced), 32
// threads per block so that a batch of 4096 spreads over 128 blocks. The
// heightmap of the chosen container is copied into the thread's own array
// once; the scan then walks only valid offsets. No shared memory.
#include "select_place.cuh"

namespace {

struct GScore {
  const float* p;
  int B, b;
  __device__ float operator()(int a) const { return p[a * B + b]; }
};

struct GMask {
  const int* p;
  int B, b;
  __device__ int operator()(int a) const { return p[a * B + b]; }
};

// One instantiation per placement rule, so that the lb kernel carries none
// of the mcs scoring.
template <bool MCS>
__global__ void select_step_kernel(tapnet::EnvCfg c, const float* score,
                                   const int* mask, tapnet::StepIO io, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  tapnet::select_place<MCS>(c, GScore{score, B, b}, GMask{mask, B, b}, io, B,
                            b);
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
  const tapnet::StepIO io{
      (const int*)ptrs[2], (const int*)ptrs[3], (const int*)ptrs[4],
      (const int*)ptrs[5], (const int*)ptrs[6], (const int*)ptrs[7],
      (int*)ptrs[8],       (int*)ptrs[9],       (int*)ptrs[10],
      (int*)ptrs[11]};
  const int threads = 32, blocks = (B + threads - 1) / threads;
  const float* score = (const float*)ptrs[0];
  const int* mask = (const int*)ptrs[1];
  if (c.mcs)
    select_step_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        c, score, mask, io, B);
  else
    select_step_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        c, score, mask, io, B);
  return (int)cudaGetLastError();
}
