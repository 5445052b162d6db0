// Warpgroup matrix products (wgmma, sm_90a only) for the replay's deferred
// weight-gradient contractions: of float32 operands as 3xTF32 above hidden
// 128 (replay.cu `grad_outer_tf32`) and of the bfloat16 backward's split
// f32 gradients by bfloat16 activations (replay.cu `grad_outer`).
//
// wgmma.mma_async: the four warps of a warpgroup (128 threads) issue one
// asynchronous product D [64][N] += A [64][K] B [K][N] with D in
// registers (N/2 floats a thread), B read by the tensor cores from shared
// memory through a 64-bit descriptor and A from registers (4 registers a
// thread: 4 tf32, K = 8; or 8 bf16, K = 16). B is K-major (tf32 has no
// transpose): [N rows][k], k contiguous. Here B is a tile of 64-byte rows,
// [N][16] tf32 or [N][32] bf16 (two k-steps of 32 bytes either way), with
// wgmma's 64-byte swizzle: row r's 16-byte chunk c lies at byte 64 r + 16
// (c ^ ((r >> 1) & 3)) of a tile whose start is 512-byte aligned (8-row
// atoms; the hardware swizzles the absolute address bits 4-5 by bits
// 7-8), so that a warp's stores of 8 rows' chunks meet no bank conflict
// and the tensor cores read conflict-free. tf32 operands are values made
// by `cvt.rna` (mma_tf32.cuh `split_tf32`): raw float32 bits would have
// their low 13 bits ignored, not rounded.
//
// Fragments (PTX ISA; mma.sync m16n8k8's (tf32) or m16n8k16's (bf16) per
// warp, the warps of the warpgroup stacked by 16 rows): thread tid, warp w
// = tid / 32, lane = 4 g + t, holds tf32 A's a[0..3] = A[16 w + g][t],
// A[16 w + g + 8][t], A[16 w + g][t + 4], A[16 w + g + 8][t + 4] (bf16:
// below, `WgBf16`), and D's d[4i + q] = D[16 w + g + 8 (q >> 1)][8 i + 2 t
// + (q & 1)] for i < N / 8.
//
// Order: a warpgroup's products complete in issue order into D, so each
// element of D sums its k-steps in the order issued; no atomics. The A
// registers of a product must not change until a wait covers it
// (`wg_wait`): the caller alternates two sets.
#pragma once

#include <cuda_runtime.h>

#include "ring_bf16.cuh"  // smem_addr

namespace tapnet {

// byte offset of chunk c (4 tf32 or 8 bf16 values) of row r in a swizzled
// tile
__device__ __forceinline__ int sw64(int r, int c) {
  return 64 * r + 16 * (c ^ ((r >> 1) & 3));
}

// the descriptor of k-step ks (bytes 32 ks .. 32 ks + 31 of each row: tf32
// values 8 ks .., bf16 16 ks ..) of a swizzled tile at p: start address >> 4 (bits 0-13; k-step 1 starts 32 bytes on, within
// the swizzle atom), leading byte offset 1 (unused by a swizzled K-major
// tile), stride byte offset 512 >> 4 (from one 8-row atom to the next,
// bits 32-45), base offset 0 (the tile is atom-aligned), layout type 2 =
// 64-byte swizzle (bits 62-63)
__device__ __forceinline__ unsigned long long wg_desc(const void* p,
                                                      int ks) {
  const unsigned a = smem_addr(p) + 32 * ks;
  return (unsigned long long)((a & 0x3FFFF) >> 4) | (1ull << 16)
         | ((unsigned long long)(512 >> 4) << 32) | (2ull << 62);
}

// orders this warpgroup's register writes before the wgmma that read them
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// closes the group of the wgmma issued since the last commit
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across an
// asynchronous product
template <int R>
__device__ __forceinline__ void wg_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator operands of the products below: WG_Dn(i) the n floats
// d[i ..] as "+f" operands, WG_Ln their numbers in the instruction
#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D16(i) WG_D4(i), WG_D4(i + 4), WG_D4(i + 8), WG_D4(i + 12)
#define WG_L16                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                                \
  "%10, %11, %12, %13, %14, %15"
#define WG_L32                                                              \
  WG_L16 ", %16, %17, %18, %19, %20, %21, %22, %23"                         \
         ", %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_L64                                                              \
  WG_L32 ", %32, %33, %34, %35, %36, %37, %38, %39"                         \
         ", %40, %41, %42, %43, %44, %45, %46, %47"                         \
         ", %48, %49, %50, %51, %52, %53, %54, %55"                         \
         ", %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_L68 WG_L64 ", %64, %65, %66, %67"

// S<N>::mma(d, a, b): D [64][N] += A B^T by one wgmma of the shape and
// types SHAPE with A's fragment a in registers and B at descriptor b; AL,
// BN and PN number a, b and the scale flag after the N / 2 accumulators
// (TAIL: bf16's imm-trans-b, 0 = B K-major)
#define WG_MMA(S, N, SHAPE, DL, AL, BN, PN, TAIL, ...)                      \
  template <>                                                               \
  struct S<N> {                                                             \
    static __device__ __forceinline__ void mma(float (&d)[N / 2],           \
                                               const unsigned (&a)[4],      \
                                               unsigned long long b) {      \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PN ", 0;\n"          \
                   "wgmma.mma_async.sync.aligned." SHAPE " {" DL "}, {" AL  \
                   "}, " BN ", p, 1, 1" TAIL ";\n}\n"                       \
                   : __VA_ARGS__                                            \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),    \
                     "r"(1));                                               \
    }                                                                       \
  };

// tf32 A [64][8] (a thread's fragment a, above) and B [N][8]
template <int N>
struct WgTf32;
WG_MMA(WgTf32, 32, "m64n32k8.f32.tf32.tf32", WG_L16, "%16, %17, %18, %19",
       "%20", "%21", "", WG_D16(0))
WG_MMA(WgTf32, 64, "m64n64k8.f32.tf32.tf32", WG_L32, "%32, %33, %34, %35",
       "%36", "%37", "", WG_D16(0), WG_D16(16))
WG_MMA(WgTf32, 128, "m64n128k8.f32.tf32.tf32", WG_L64,
       "%64, %65, %66, %67", "%68", "%69", "", WG_D16(0), WG_D16(16),
       WG_D16(32), WG_D16(48))
WG_MMA(WgTf32, 136, "m64n136k8.f32.tf32.tf32", WG_L68,
       "%68, %69, %70, %71", "%72", "%73", "", WG_D16(0), WG_D16(16),
       WG_D16(32), WG_D16(48), WG_D4(64))

// bf16 A [64][16] (a thread's fragment: a[0] = {A[r][2t], A[r][2t+1]},
// a[1] the same of row r + 8, a[2], a[3] of columns 2t + 8, 2t + 9, with
// r = 16 w + g; the lower column in the low half) and B [N][16]
template <int N>
struct WgBf16;
WG_MMA(WgBf16, 32, "m64n32k16.f32.bf16.bf16", WG_L16,
       "%16, %17, %18, %19", "%20", "%21", ", 0", WG_D16(0))
WG_MMA(WgBf16, 64, "m64n64k16.f32.bf16.bf16", WG_L32,
       "%32, %33, %34, %35", "%36", "%37", ", 0", WG_D16(0),
       WG_D16(16))
WG_MMA(WgBf16, 128, "m64n128k16.f32.bf16.bf16", WG_L64,
       "%64, %65, %66, %67", "%68", "%69", ", 0", WG_D16(0),
       WG_D16(16), WG_D16(32), WG_D16(48))
WG_MMA(WgBf16, 136, "m64n136k16.f32.bf16.bf16", WG_L68,
       "%68, %69, %70, %71", "%72", "%73", ", 0", WG_D16(0),
       WG_D16(16), WG_D16(32), WG_D16(48), WG_D4(64))

#undef WG_MMA
#undef WG_L68
#undef WG_L64
#undef WG_L32
#undef WG_L16
#undef WG_D16
#undef WG_D4

// d += a b^T in three tf32 passes, the small terms first (mma_tf32.cuh
// `mma3`'s order) for each k-step of 8: lo.hi, hi.lo, hi.hi, with A's
// fragments hi and lo in registers and B a swizzled [N][16] tile (hi at
// bh, lo at bl)
template <int N>
__device__ __forceinline__ void wg_mma3(float (&d)[N / 2],
                                        const unsigned (&ah)[2][4],
                                        const unsigned (&al)[2][4],
                                        const void* bh, const void* bl) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    WgTf32<N>::mma(d, al[ks], wg_desc(bh, ks));
    WgTf32<N>::mma(d, ah[ks], wg_desc(bl, ks));
    WgTf32<N>::mma(d, ah[ks], wg_desc(bh, ks));
  }
}

// d += a b^T for an f32 A split into bf16 hi + lo (fragments ah, al in
// registers) and a swizzled bf16 B tile [N][32] at b: for each k-step of
// 16, lo.b then hi.b (the small terms first)
template <int N>
__device__ __forceinline__ void wg_mma2(float (&d)[N / 2],
                                        const unsigned (&ah)[2][4],
                                        const unsigned (&al)[2][4],
                                        const void* b) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    WgBf16<N>::mma(d, al[ks], wg_desc(b, ks));
    WgBf16<N>::mma(d, ah[ks], wg_desc(b, ks));
  }
}

}  // namespace tapnet
