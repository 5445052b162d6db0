// Float32 products on the tensor cores as 3xTF32, for the replay kernels'
// float32 instantiations above hidden 128 (replay.cu): mma.sync m16n8k8
// tf32 x tf32 + f32 -> f32, each f32 operand split in registers as x = hi
// + lo with hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: to nearest, ties
// away), and the three passes lo.hi, hi.lo, hi.hi added into one f32
// accumulator. hi + lo is x to a relative 2^-22, and the dropped lo.lo term
// is below 2^-22 of the product, so a product is f32's to a few units of
// its last place; the sums stay f32 (the tensor core's order). The tensor
// core adds into its accumulator by aligning the terms to the largest and
// dropping the bits below f32's (toward zero, not to nearest as an FMA
// rounds), so that error grows with the mma that add into one
// accumulator, and all one way. Over K = 512 (192 mma) it took K2's
// logits past their tolerance, so the callers at such K (actor_step.cu,
// hidden above 256) sum each 16 columns of K from zero into an
// accumulator of their own and add those into the sum in f32.
//
// Blocks of 32 lanes x 16 warps; the B operand is a head pass of 16
// instances held as a [k][17] float array in shared memory. With lane =
// 4 g + t a warp's fragments hold (PTX ISA, m16n8k8 .tf32): A [16][8] rows
// g, g + 8 and
// columns t, t + 4 (registers {(g, t), (g+8, t), (g, t+4), (g+8, t+4)});
// B [8][8] rows t, t + 4 of column g; C [16][8] rows g, g + 8 and columns
// 2t, 2t+1, as m16n8k16's.
#pragma once

#include <cuda_runtime.h>

namespace tapnet {

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in three passes, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4],
                                     const unsigned (&bh)[2],
                                     const unsigned (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// out[m][n] = sum_k A[m][k] x[k][n] for m < M (a multiple of 16, at most
// 256) and the n < 16 instances of a head pass: A row-major [M][K] float32,
// x [K][17] float in shared memory, emit(m, n, acc) storing an output.
// Warp wy owns rows 16 wy .. + 15 and both n-tiles (M < 256 leaves warps
// M/16.. without products) and reads its rows of A straight from global
// memory (the weights, a few MB, stay in L2 for every block): in chunks of
// 16 columns, a thread loads 4 consecutive columns of rows g and g + 8
// (one 16-byte load each; element loads where A's rows are not 16-byte
// aligned), PF chunks in flight ahead of the one in use. A chunk's two
// k-steps take its columns in the order k0 + 4t, + 1 (k-step 0: the
// fragment's columns t, t + 4) and k0 + 4t + 2, + 3 (k-step 1), x's rows
// alike: the same sum over k, in another order. Columns >= K add zeros.
// No barrier and no shared memory for A: the caller follows with a barrier
// before the outputs are read.
template <int PF, class Emit>
__device__ void mm_tf32(const float* __restrict__ A, int M, int K,
                        const float* x, int lane, int wy, Emit emit) {
  constexpr int LD = 17;
  if (wy >= M / 16) return;
  const int g = lane >> 2, t = lane & 3, m0 = wy * 16;
  const int nc = (K + 15) / 16;
  const bool al = (K & 3) == 0 && (reinterpret_cast<size_t>(A) & 15) == 0;
  const float* ra = A + (size_t)(m0 + g) * K;
  const float* rb = ra + (size_t)8 * K;
  // columns 16 c + 4 t .. + 3 of rows g (u) and g + 8 (v)
  auto load = [&](int c, float4& u, float4& v) {
    const int k = 16 * c + 4 * t;
    if (al) {
      const bool in = k < K;
      u = in ? __ldg(reinterpret_cast<const float4*>(ra + k))
             : make_float4(0.f, 0.f, 0.f, 0.f);
      v = in ? __ldg(reinterpret_cast<const float4*>(rb + k))
             : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      u.x = k < K ? __ldg(ra + k) : 0.f;
      u.y = k + 1 < K ? __ldg(ra + k + 1) : 0.f;
      u.z = k + 2 < K ? __ldg(ra + k + 2) : 0.f;
      u.w = k + 3 < K ? __ldg(ra + k + 3) : 0.f;
      v.x = k < K ? __ldg(rb + k) : 0.f;
      v.y = k + 1 < K ? __ldg(rb + k + 1) : 0.f;
      v.z = k + 2 < K ? __ldg(rb + k + 2) : 0.f;
      v.w = k + 3 < K ? __ldg(rb + k + 3) : 0.f;
    }
  };
  float4 ring[PF][2];
#pragma unroll
  for (int i = 0; i < PF; ++i) load(i, ring[i][0], ring[i][1]);
  float acc[2][4] = {};
  for (int c0 = 0; c0 < nc; c0 += PF) {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int c = c0 + i;
      if (c < nc) {
        const float4 u = ring[i][0], v = ring[i][1];
        load(c + PF, ring[i][0], ring[i][1]);
        const int kb = 16 * c + 4 * t;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          unsigned ah[4], al4[4];
          split_tf32(s ? u.z : u.x, ah[0], al4[0]);
          split_tf32(s ? v.z : v.x, ah[1], al4[1]);
          split_tf32(s ? u.w : u.y, ah[2], al4[2]);
          split_tf32(s ? v.w : v.y, ah[3], al4[3]);
          const int k = kb + 2 * s;  // x's rows k and k + 1
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            unsigned bh[2], bl[2];
            const float* xp = x + k * LD + 8 * h + g;
            split_tf32(k < K ? xp[0] : 0.f, bh[0], bl[0]);
            split_tf32(k + 1 < K ? xp[LD] : 0.f, bh[1], bl[1]);
            mma3(acc[h], ah, al4, bh, bl);
          }
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = 8 * h + 2 * t;
    emit(m0 + g, n, acc[h][0]);
    emit(m0 + g, n + 1, acc[h][1]);
    emit(m0 + g + 8, n, acc[h][2]);
    emit(m0 + g + 8, n + 1, acc[h][3]);
  }
}

}  // namespace tapnet
