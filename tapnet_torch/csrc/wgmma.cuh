// Warpgroup matrix products (wgmma, sm_90a only) of float32 operands as
// 3xTF32, for the replay's deferred weight-gradient contractions above
// hidden 128 (replay.cu `grad_outer_tf32`).
//
// wgmma.mma_async: the four warps of a warpgroup (128 threads) issue one
// asynchronous product D [64][N] += A [64][8] B [8][N] with D in
// registers (N/2 floats a thread), B read by the tensor cores from shared
// memory through a 64-bit descriptor and A from registers (4 tf32 a
// thread). tf32 operands must be K-major (tf32 has no transpose): B as [N
// rows][k], k contiguous. Here B is a tile [N][16] tf32 (two k-steps of
// 8) with wgmma's 64-byte swizzle: row r's 16-byte chunk c (values 4c ..
// 4c + 3) lies at byte 64 r + 16 (c ^ ((r >> 1) & 3)) of a tile whose
// start is 512-byte aligned (8-row atoms; the hardware swizzles the
// absolute address bits 4-5 by bits 7-8), so that a warp's 4-byte stores
// of 8 rows' chunks meet no bank conflict and the tensor cores read
// conflict-free. The operands are tf32 values made by `cvt.rna`
// (mma_tf32.cuh `split_tf32`): raw float32 bits would have their low 13
// bits ignored, not rounded.
//
// Fragments (PTX ISA, wgmma .m64nNk8 .tf32; mma.sync m16n8k8's per warp,
// the warps of the warpgroup stacked by 16 rows): thread tid, warp w =
// tid / 32, lane = 4 g + t, holds A's a[0..3] = A[16 w + g][t], A[16 w +
// g + 8][t], A[16 w + g][t + 4], A[16 w + g + 8][t + 4], and D's d[4i + q]
// = D[16 w + g + 8 (q >> 1)][8 i + 2 t + (q & 1)] for i < N / 8.
//
// Order: a warpgroup's products complete in issue order into D, so each
// element of D sums its k-steps in the order issued; no atomics. The A
// registers of a product must not change until a wait covers it
// (`wg_wait`): the caller alternates two sets.
#pragma once

#include <cuda_runtime.h>

#include "ring_bf16.cuh"  // smem_addr

namespace tapnet {

// byte offset of chunk c (4 tf32 values) of row r in a swizzled tile
__device__ __forceinline__ int sw64(int r, int c) {
  return 64 * r + 16 * (c ^ ((r >> 1) & 3));
}

// the descriptor of k-step ks (values 8 ks .. 8 ks + 7) of a swizzled tile
// at p: start address >> 4 (bits 0-13; k-step 1 starts 32 bytes on, within
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

// D [64][N] += A B^T for tf32 A [64][8] in registers (a thread's
// fragment a, below) and B [N][8] at descriptor b
template <int N>
struct WgTf32;

#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

template <>
struct WgTf32<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                          const unsigned (&a)[4],
                                          unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgTf32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                          const unsigned (&a)[4],
                                          unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20),
          WG_D4(24), WG_D4(28)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgTf32<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                          const unsigned (&a)[4],
                                          unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20),
          WG_D4(24), WG_D4(28), WG_D4(32), WG_D4(36), WG_D4(40), WG_D4(44),
          WG_D4(48), WG_D4(52), WG_D4(56), WG_D4(60)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgTf32<136> {
  static __device__ __forceinline__ void mma(float (&d)[68],
                                          const unsigned (&a)[4],
                                          unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %73, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67"
        "}, {%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
        : WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20),
          WG_D4(24), WG_D4(28), WG_D4(32), WG_D4(36), WG_D4(40), WG_D4(44),
          WG_D4(48), WG_D4(52), WG_D4(56), WG_D4(60), WG_D4(64)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

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

}  // namespace tapnet
