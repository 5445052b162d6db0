// The weight ring of the bfloat16 replay above hidden 128 (replay.cu, TC &&
// WH) and of the actor step above hidden 128 (actor_step.cu, WH, both
// dtypes): the encoder/query weights streamed from device memory into shared
// memory by bulk asynchronous copies (cp.async.bulk, the copy engine of
// TMA), each slab completing on its own mbarrier, with no block-wide
// barrier per slab.
//
// A slab is RING_K columns of all `rows` rows of a row-major [rows][K]
// bfloat16 matrix, laid out by the wrapper (ops/replay.py `ring_operands`)
// as one contiguous run of rows x RING_K bfloat16: row r's 16-byte chunk
// ch at r RING_K + 8 (ch ^ ((r >> 1) & 3)), K padded to a multiple of
// RING_K with zeros. The swizzle puts the 8 rows of an ldmatrix matrix in
// 8 different 16-byte bank groups without a pad, so one copy fills a
// stage and a stage is 16 KB at h = 256 (a pad of 8 would be 20 KB, and
// three of them do not fit beside the 2d-rolling plan).
//
// The ring: RING_S stages in shared memory, a `full` mbarrier and a
// release count per stage. A chain (`ring_open`) is up to three matrices'
// slabs streamed back to back; thread 0 starts the first RING_S of them.
// Each consumer warp waits on the stage's mbarrier (the copy's bytes
// landed), runs its products, and its lane 0 counts the warp done; the
// last of the `nw` warps to release a stage starts the copy of the slab
// RING_S further along the chain into it. So a warp waits only for the
// bytes it reads, copies run RING_S - 1 slabs ahead of the slowest warp,
// and the products of a chain's next matrix find their first slabs in
// flight.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tapnet {

constexpr int RING_K = 32;  // columns of a slab
constexpr int RING_S = 3;   // stages

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// orders the mbarrier inits before their use by other threads (with a
// barrier after it)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of copies to complete on `bar`
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of `bar` with this parity has completed; a wait
// past ~2^34 cycles (seconds: a copy that never lands) traps, so that a
// fault ends the launch with an error instead of hanging it
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// memory to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// orders this thread's (and, after a barrier, the block's) generic
// accesses to shared memory before later asynchronous-proxy ones
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ldmatrix x4 at this lane's address
__device__ __forceinline__ void ldsm(unsigned (&a)[4],
                                     const unsigned short* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// ldmatrix x4 .trans at this lane's address
__device__ __forceinline__ void ldsm_t(unsigned (&a)[4],
                                       const unsigned short* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// The products' B operand (a head pass's 16 instances) as a bfloat16
// array [K16][16] in shared memory, 16-byte aligned: row k's two 16-byte
// chunks swizzled (chunk c at c ^ ((k >> 2) & 1)), so that the 8 rows of
// an ldmatrix matrix fall in 8 bank groups. xs_at: the element (k, n).
__device__ __forceinline__ int xs_at(int k, int n) {
  return 16 * k + 8 * ((n >> 3) ^ ((k >> 2) & 1)) + (n & 7);
}

// The B fragments (mma_bf16.cuh's layout) of rows k0 .. k0 + 15 of such an
// array for both column tiles: b[0], b[1] of columns 0 .. 7, b[2], b[3] of
// columns 8 .. 15 (lane l reads row k0 + l % 16, chunk l / 16, transposed)
__device__ __forceinline__ void ldsm_xs(unsigned (&b)[4],
                                        const unsigned short* xs, int k0,
                                        int lane) {
  const int k = k0 + (lane & 15), c = lane >> 4;
  ldsm_t(b, xs + 16 * k + 8 * (c ^ ((k >> 2) & 1)));
}

// the bits of x rounded to bfloat16
__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// The A fragment (mma_bf16.cuh's layout) of rows m0 .. m0 + 15 and the
// columns 16 c .. 16 c + 15 of a slab: lane l reads row m0 + l % 16,
// chunk 2 c + l / 16, swizzled.
__device__ __forceinline__ void ldsm_slab(unsigned (&a)[4],
                                          const unsigned short* slab, int m0,
                                          int c, int lane) {
  const int r = m0 + (lane & 15), ch = 2 * c + (lane >> 4);
  ldsm(a, slab + r * RING_K + 8 * (ch ^ ((r >> 1) & 3)));
}

struct Ring {
  unsigned short* buf;       // RING_S stages of `stage` bfloat16
  unsigned long long* full;  // RING_S mbarriers: a stage's slab landed
  int* done;                 // RING_S counts of the warps done with a stage
  int stage;                 // bfloat16 of a stage: rows x RING_K
  unsigned seq;              // slabs streamed so far (the same in every
                             // thread)
};

// thread 0, once per block before a barrier: the mbarriers (one arrival:
// the copy's issuer) and the counts
__device__ __forceinline__ void ring_init(Ring& r) {
  for (int i = 0; i < RING_S; ++i) {
    mbar_init(r.full + i, 1);
    r.done[i] = 0;
  }
  mbar_init_fence();
}

struct Chain {
  const __nv_bfloat16* src[3];  // the matrices' slabs, in stream order
  int ns[3];                    // slabs of each
  int total;                    // slabs of the chain
  int elems;                    // bfloat16 of a slab
  unsigned base;                // ring sequence number of its first slab
};

__device__ __forceinline__ void ring_issue(const Ring& r, const Chain& c,
                                           int i) {
  const int st = (c.base + i) % RING_S;
  const __nv_bfloat16* p =
      i < c.ns[0] ? c.src[0] + (size_t)i * c.elems
      : i < c.ns[0] + c.ns[1]
          ? c.src[1] + (size_t)(i - c.ns[0]) * c.elems
          : c.src[2] + (size_t)(i - c.ns[0] - c.ns[1]) * c.elems;
  mbar_expect(r.full + st, 2u * c.elems);
  bulk_copy(r.buf + st * r.stage, p, 2u * c.elems, r.full + st);
}

// Every thread, where all of them arrive and the ring is free (no warp
// still reads it, and the copies of the previous chain have all been
// consumed): a chain of the slabs of up to three matrices of `rows` rows,
// n0, n1, n2 slabs each (0 for none). It holds the block's barrier (after
// every thread's proxy fence: the ring's earlier generic writes, the
// token view's, come before the copies), then thread 0 starts the first
// RING_S slabs.
__device__ __forceinline__ Chain ring_open(Ring& r, int rows,
                                           const __nv_bfloat16* m0, int n0,
                                           const __nv_bfloat16* m1, int n1,
                                           const __nv_bfloat16* m2, int n2,
                                           int tid) {
  const Chain c{{m0, m1, m2}, {n0, n1, n2}, n0 + n1 + n2, rows * RING_K,
                r.seq};
  r.seq += c.total;
  fence_proxy_async();
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < RING_S && i < c.total; ++i) ring_issue(r, c, i);
  return c;
}

// Warps 0 .. nw - 1 consume the slabs a .. a + n - 1 of the chain in
// order: body(slab, s) runs the warp's products of slab a + s (`slab` its
// stage in shared memory). The last warp to release a stage starts the
// copy of the chain's slab RING_S further into it. The other warps
// return at once; the caller follows with a barrier before the outputs
// are read.
template <class Body>
__device__ void ring_take(const Ring& r, const Chain& c, int a, int n,
                          int nw, int wy, int lane, Body body) {
  if (wy >= nw) return;
  for (int s = 0; s < n; ++s) {
    const int i = a + s;
    const unsigned q = c.base + i;
    const int st = q % RING_S;
    mbar_wait(r.full + st, (q / RING_S) & 1);
    __syncwarp();  // converged for the body's .aligned ldmatrix and mma
    body(r.buf + st * r.stage, s);
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();  // the warp's reads of the stage come first
      if (atomicAdd(r.done + st, 1) == nw - 1) {
        r.done[st] = 0;
        if (i + RING_S < c.total) {
          fence_proxy_async();
          ring_issue(r, c, i + RING_S);
        }
      }
    }
  }
}

}  // namespace tapnet
