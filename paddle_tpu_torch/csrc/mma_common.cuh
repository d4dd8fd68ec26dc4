// The tensor-core and copy helpers shared by the hand-written matrix
// kernels (fused_resnet.cu, the 1x1 conv + BN-stats pair, fused_conv3x3.cu,
// the 3x3 pair, fused_ce.cu, the fused linear + cross entropy, and the
// tensor-core flash-attention forward and backward of flash_mma.cuh):
// asynchronous 16-byte copies from global to shared memory (cp.async, and
// its commit groups), ldmatrix fragment loads, the warp-level
// mma.sync.m16n8k16 bf16 and fp16 products with fp32 accumulation, and the
// same fragment layout computed with fp32 FMAs for float32 inputs; and
// the thread-block cluster's rank, barrier and distributed-shared-memory
// load, by which the split-key decode (flash_decode_split.cuh) and the
// bf16 CE forward fold their splits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously and without a
// register round trip; zeros when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(bf16* dst, const bf16* src,
                                          bool ok) {
  cp_async16(dst, src, ok);
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src,
                                          bool ok) {
  cp_async16(dst, src, ok);
  cp_async16(dst + 4, src + 4, ok);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// close this thread's copies issued since the last commit into a group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ products

// four (two) 8x8 b16 matrices from shared memory: lane l gives the address
// of row l%8 of matrix l/8; kTrans delivers each matrix transposed
template <bool kTrans>
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}
template <bool kTrans>
__device__ __forceinline__ void ldsm(uint32_t (&r)[2], const void* p) {
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(smem_u32(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p)));
}

// d += a @ b for one m16n8k16 tile, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a @ b for one m16n8k16 tile, fp16 in, fp32 accumulate
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The fragments of one 16-deep step, loaded with ldmatrix. pa(mi) is this
// lane's row address for A's m16 tile mi, pb(np) for B's n8 tiles 2np and
// 2np+1 (tile 0 alone when NI == 1). Lane l gives row l%8 of matrix j =
// l/8: of A, rows 8(j&1).. at depths 8(j>>1)..; of B, n8 tile j>>1 of the
// pair at depths 8(j&1)... kTA / kTB: the operand is stored depth-major
// (rows of depth), so ldmatrix transposes it into the fragment.
template <int MI, bool kTA, class PA>
__device__ __forceinline__ void load_a(uint32_t (&af)[MI][4], const PA& pa) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) ldsm<kTA>(af[mi], pa(mi));
}

template <int NI, bool kTB, class PB>
__device__ __forceinline__ void load_b(uint32_t (&bfr)[NI][2], const PB& pb) {
  if constexpr (NI == 1) {
    ldsm<kTB>(bfr[0], pb(0));
  } else {
#pragma unroll
    for (int np = 0; np < NI / 2; ++np) {
      uint32_t r[4];
      ldsm<kTB>(r, pb(np));
      bfr[2 * np][0] = r[0], bfr[2 * np][1] = r[1];
      bfr[2 * np + 1][0] = r[2], bfr[2 * np + 1][1] = r[3];
    }
  }
}

// acc[mi][ni] += A tile mi @ B tile ni; acc[mi][ni][2h + j] is row
// mi*16 + 8h + lane/4, column ni*8 + 2(lane%4) + j of the warp's tile
template <int MI, int NI>
__device__ __forceinline__ void mma_tile(float (&acc)[MI][NI][4],
                                         const uint32_t (&af)[MI][4],
                                         const uint32_t (&bfr)[NI][2]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
}

// The same outputs in fp32 on the CUDA cores, for float32 inputs: a(mi, h,
// k) points at A's element (row mi*16 + 8h + lane/4, depth k), b(n, k) at
// B's (column n, depth k), both within the warp's tile.
template <int MI, int NI, class FA, class FB>
__device__ __forceinline__ void fma_step(float (&acc)[MI][NI][4], const FA& a,
                                         const FB& b) {
  const int t = threadIdx.x & 3;
#pragma unroll 4
  for (int k = 0; k < 16; ++k) {
    float av[MI][2], bv[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) av[mi][h] = *a(mi, h, k);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) bv[ni][j] = *b(ni * 8 + 2 * t + j, k);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[mi][ni][r] = fmaf(av[mi][r >> 1], bv[ni][r & 1], acc[mi][ni][r]);
  }
}

// this block's rank in its thread-block cluster
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// Every thread of every block of the cluster arrives, then waits for the
// others: the writes before it (shared memory included) are visible to
// the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The float at p in the shared memory of the cluster's block ``rank``
// (p is an address in this block's shared memory).
__device__ __forceinline__ float cluster_load(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

}  // namespace
