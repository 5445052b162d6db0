// Tensor-core products of the bfloat16 instantiations, shared by the replay
// kernels (replay.cu) and the actor step (actor_step.cu): mma.sync
// m16n8k16 bf16 x bf16 + f32 -> f32, the fragments built from shared
// memory, and a row-major bfloat16 weight streamed through shared memory
// by cp.async, double-buffered, and read by ldmatrix.
//
// Both kernels run blocks of 32 lanes x 16 warps (MMA_NT threads) and keep
// their activations as [k][lane] float arrays of row stride MMA_LD (32
// lanes); each includer checks that its own constants agree.
//
// With lane = 4 g + t a warp's fragments hold (PTX ISA): A [16][16] rows
// g, g + 8 and columns 2t, 2t+1, 2t+8, 2t+9 (registers {(g, 2t..),
// (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}); B [16][8] rows 2t, 2t+1,
// 2t+8, 2t+9 of column g; C [16][8] rows g, g + 8 and columns 2t, 2t+1
// (c0 c1 on row g, c2 c3 on row g + 8). A pair of bfloat16 holds the lower
// index in its low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tapnet {

constexpr int MMA_NT = 512;  // threads per block: 32 lanes x 16 warps
constexpr int MMA_LD = 33;   // row stride of the [k][lane] float arrays
// row stride, in 32-bit words, of a B operand held as bfloat16 pairs
// [k / 2][32 lanes] (mv_mma's xb): 8 mod 32, so that the lanes (g, t) of
// a fragment's load hit 32 different banks
constexpr int MMA_XS = 40;

__device__ __forceinline__ unsigned pack(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment from f(r, k) = the bfloat16 pair {A[r][k], A[r][k+1]}
template <class F>
__device__ __forceinline__ void frag_au(unsigned (&a)[4], int g, int t, F f) {
  a[0] = f(g, 2 * t);
  a[1] = f(g + 8, 2 * t);
  a[2] = f(g, 2 * t + 8);
  a[3] = f(g + 8, 2 * t + 8);
}

// B fragment from f(k, n) = {B[k][n], B[k+1][n]} (k even), exact values
template <class F>
__device__ __forceinline__ void frag_b(unsigned (&b)[2], int g, int t, F f) {
  float2 v = f(2 * t, g);
  b[0] = pack(v.x, v.y);
  v = f(2 * t + 8, g);
  b[1] = pack(v.x, v.y);
}

// 16 bytes from global memory to shared memory without a register
// (cp.async, bypassing L1), as zeros where `bytes` is 0
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until this thread's cp.async groups have landed
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the A fragment of a [16][16] tile of a row-major bfloat16 array in shared
// memory with row stride sp: lane l gives the address of row l % 16,
// column 8 (l / 16), so ldmatrix's four matrices are A's a[0] .. a[3]
__device__ __forceinline__ void ldsm_a(unsigned (&a)[4],
                                       const unsigned short* tile, int sp,
                                       int lane) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(
      tile + (lane & 15) * sp + (lane >> 4) * 8);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// Rows [0, M) and columns [k0, k0 + KSL) of the row-major [M][K] bfloat16
// matrix W into S ([M][KSL + 8]: the 8 rows of an ldmatrix matrix fall in
// 8 different 16-byte bank groups), columns >= K as zeros: 16-byte
// cp.async where W's rows are 16-byte aligned (`al`), else element loads
// stored as 16 bytes.
template <int KSL>
__device__ void stage_a(unsigned short* S, const __nv_bfloat16* W, int M,
                        int K, int k0, int tid, bool al) {
  constexpr int CH = KSL / 8, SP = KSL + 8;
  const unsigned short* w = reinterpret_cast<const unsigned short*>(W);
  for (int e = tid; e < M * CH; e += MMA_NT) {
    const int r = e / CH, c = e - r * CH, k = k0 + 8 * c;
    unsigned short* dst = S + r * SP + 8 * c;
    if (al) {
      cp16(dst, k < K ? w + (size_t)r * K + k : w, k < K ? 16 : 0);
    } else {
      unsigned v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = k + 2 * i;
        const unsigned lo = kk < K ? __ldg(w + (size_t)r * K + kk) : 0u;
        const unsigned hi =
            kk + 1 < K ? __ldg(w + (size_t)r * K + kk + 1) : 0u;
        v[i] = lo | hi << 16;
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The A operand W [M][K] (row-major bfloat16, K padded with zeros) streamed
// through shared memory S in slabs of KSL columns, double-buffered: one
// barrier a slab, the copy of slab s + 1 (cp.async) running under the
// products of slab s. body(slab, kb) runs every warp's products of the
// columns kb .. kb + KSL, its A fragments read from `slab` (row stride
// KSL + 8) with ldsm_a. S holds 2 M (KSL + 8) bfloat16 and is free at
// entry; the caller follows with a barrier before S is reused.
template <int KSL, class Body>
__device__ void stream_a(unsigned short* S, const __nv_bfloat16* W, int M,
                         int K, int tid, Body body) {
  const int SZ = M * (KSL + 8), ns = (K + KSL - 1) / KSL;
  const bool al = (K & 7) == 0 && (reinterpret_cast<size_t>(W) & 15) == 0;
  stage_a<KSL>(S, W, M, K, 0, tid, al);
  cp_commit();
  for (int s = 0; s < ns; ++s) {
    cp_wait_all();    // this thread's copies of slab s have landed
    __syncthreads();  // everyone's; and slab s - 1 is consumed
    if (s + 1 < ns) {
      stage_a<KSL>(S + ((s + 1) & 1) * SZ, W, M, K, (s + 1) * KSL, tid, al);
      cp_commit();
    }
    body(S + (s & 1) * SZ, s * KSL);
  }
}

// out[j][n] = sum_k W[j, k] x[k][n] for j < h (at most 128), n < 32: W
// row-major [h][K] bfloat16, x [K][MMA_LD] (bfloat16 values held as float),
// K padded to a multiple of 16 with zeros. W streams through S in slabs of
// KSL columns (stream_a: h (KSL + 8) floats of S). Warp wy owns rows
// 16 (wy / 2) .. + 15 and the lanes 16 (wy % 2) .. + 15 (two column tiles
// sharing each A fragment); h = 32..96 leave warps 2h/16.. without
// products. emit(j, n, acc) stores an output. The caller follows with a
// barrier.
//
// The B fragments: from x itself (four 32-bit loads and two packs each,
// lanes t and t' of one load up to four ways in one bank), or, given xb,
// from a copy of x as bfloat16 pairs [K16 / 2][MMA_XS] that every thread
// writes first (ordered before the products by stream_a's first barrier):
// two 32-bit loads each on 32 banks. The warps of a column half load the
// same fragments, so the copy cuts the shared-memory wavefronts of the
// product several-fold; it needs K16 / 2 * MMA_XS words at xb.
template <int KSL = 64, class Emit>
__device__ void mv_mma(const __nv_bfloat16* __restrict__ W, int h, int K,
                       const float* x, unsigned short* S, int lane, int wy,
                       int tid, Emit emit, unsigned* xb = nullptr) {
  constexpr int LD = MMA_LD, XS = MMA_XS;
  const bool on = wy < h / 8;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (wy >> 1) * 16, n0 = (wy & 1) * 16;
  float acc[2][4] = {};
  if (xb) {  // rows k, k + 1 of x as pairs, zeros past K
    const int kp = (K + 15) / 16 * 8;
    for (int e = tid; e < kp * 32; e += MMA_NT) {
      const int k = 2 * (e >> 5), n = e & 31;
      xb[(e >> 5) * XS + n] = pack(k < K ? x[k * LD + n] : 0.f,
                                   k + 1 < K ? x[(k + 1) * LD + n] : 0.f);
    }
  }
  stream_a<KSL>(S, W, h, K, tid, [&](const unsigned short* slab, int kb) {
    if (!on) return;
#pragma unroll
    for (int c = 0; c < KSL / 16; ++c) {
      const int k0 = kb + 16 * c;
      if (k0 < K) {
        unsigned a[4];
        ldsm_a(a, slab + m0 * (KSL + 8) + 16 * c, KSL + 8, lane);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          unsigned b[2];
          if (xb) {
            const unsigned* p = xb + (k0 / 2 + t) * XS + n0 + 8 * s + g;
            b[0] = p[0];
            b[1] = p[4 * XS];
          } else {
            frag_b(b, g, t, [&](int k, int n) {
              const int kk = k0 + k;
              const float* p = x + kk * LD + n0 + 8 * s + n;
              return make_float2(kk < K ? p[0] : 0.f,
                                 kk + 1 < K ? p[LD] : 0.f);
            });
          }
          mma(acc[s], a, b);
        }
      }
    }
  });
  if (!on) return;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int n = n0 + 8 * s + 2 * t;
    emit(m0 + g, n, acc[s][0]);
    emit(m0 + g, n + 1, acc[s][1]);
    emit(m0 + g + 8, n, acc[s][2]);
    emit(m0 + g + 8, n + 1, acc[s][3]);
  }
}

}  // namespace tapnet
