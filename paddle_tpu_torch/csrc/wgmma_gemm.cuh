// The port's warpgroup matrix-product body for bf16 on Hopper (sm_90a):
// wgmma.mma_async m64n128k16 (bf16 in, fp32 accumulate) on operands that
// TMA copies into shared memory in the 128-byte swizzled layout wgmma
// reads, through a ring of kStages slices guarded by mbarriers.
//
// A block owns one kBM x kBN (128 x 128) output tile and is 160 threads:
// one consumer warpgroup (warps 0-3), which issues the products of both
// 64-row halves of the tile and keeps the 2 x 64 fp32 accumulators of a
// thread in registers, and one producer warp (warp 4), whose first lane
// keeps the ring full: for slice i it waits until the consumers have
// released ring slot i % kStages, then asks TMA for the slice's two
// operand boxes, which report their bytes to the slot's "full" barrier.
// The consumers wait on that barrier, issue the slice's eight wgmma (four
// 16-deep steps, two row halves), commit them as one group, and release
// the previous slice's slot once at most this group is still in flight,
// so loads, products and the next slice's wait overlap. Two blocks fit
// an SM (96 KB of ring each), so one block's epilogue runs beside the
// other's products. The fused CE forward's persistent blocks walk runs
// of 128 x 256 tiles on a wider ring instead (WideRing, below).
//
// Both operands may lie either way, which is what the fused CE backward's
// three products need: K-major (the contraction contiguous: one TMA box
// of 64 depth x 128 rows a slice) or MN-major (the rows contiguous: two
// boxes of 64 rows x 64 depth, transposed by wgmma's trans flags). TMA
// fills everything outside the matrix with zeros, so ragged edges add
// exact zeros to every sum and only the epilogue masks. The tensor maps
// are made on the host (make_map) with libcuda's encoder, fetched at
// run time through the runtime's entry-point query, so the library links
// against nothing new.
//
// The accumulators: acc[h][i] of consumer thread t is the tile's row
// 64h + 16(t/32) + 8((i/2)%2) + (t%32)/4 and column 8(i/4) + 2(t%4) +
// i%2 (frag_row, frag_col).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {
namespace paddle_wgmma {

constexpr int kBM = 128;       // tile rows
constexpr int kBN = 128;       // tile columns: one m64n128 product a half
constexpr int kBK = 64;        // contraction slice: 128 bytes of bf16
constexpr int kStages = 3;     // ring slots
constexpr int kConsumers = 128;              // one warpgroup
constexpr int kThreads = kConsumers + 32;    // and the producer warp
constexpr int kBox = 64 * kBK * 2;           // a 64 x 64 bf16 box: 8 KB
constexpr int kOperand = 2 * kBox;           // an operand's slice: 16 KB
constexpr int kSlot = 2 * kOperand;          // a ring slot: 32 KB
// the ring (1024-byte aligned for the swizzle), then 2 * kStages barriers
constexpr size_t kSmem = (size_t)kStages * kSlot + 1024 + 2 * kStages * 8;

// ------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, or nullptr
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The bf16 matrix [rows][cols] at base (row stride ld elements, cols
// contiguous) as a TMA map whose box is 64 columns x box_rows rows,
// 128-byte swizzled, zeros outside the matrix. False when libcuda
// refuses it (base or ld*2 not a multiple of 16 bytes, an empty side).
inline bool make_map(CUtensorMap* map, const void* base, int64_t rows,
                     int64_t cols, int64_t ld, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr || rows < 1 || cols < 1) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the map of an operand as the body reads it: K-major, one box of 64
// depth x kBM rows; MN-major, boxes of 64 rows x 64 depth
inline bool operand_map(CUtensorMap* map, const void* base, int64_t rows,
                        int64_t cols, int64_t ld, bool mn_major) {
  return make_map(map, base, rows, cols, ld, mn_major ? kBK : kBM);
}

// ------------------------------------------------------------ barriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// the box at (c0 columns, c1 rows) of map into dst, its bytes reported
// to bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// ------------------------------------------------------------ products

// the shared-memory descriptor of a 128-byte swizzled operand at p: lbo
// and sbo in bytes (K-major: sbo the 8-row step, lbo unused; MN-major:
// lbo the step between 64-row atoms, sbo the 8-deep step)
__device__ __forceinline__ uint64_t descriptor(const void* p, int lbo,
                                               int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of d across the asynchronous
// products
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16) @ B (16 x 128); kTA / kTB: the operand is MN-major
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// tile row and column of accumulator i of half h, consumer thread t
__device__ __forceinline__ int frag_row(int h, int i, int t) {
  return 64 * h + 16 * (t >> 5) + 8 * ((i >> 1) & 1) + ((t & 31) >> 2);
}
__device__ __forceinline__ int frag_col(int i, int t) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

// ------------------------------------------------------------ the ring

struct Ring {
  unsigned char* base;   // kStages slots of kSlot bytes, 1024-aligned
  uint64_t* full;        // [kStages]: the slot's boxes have landed
  uint64_t* empty;       // [kStages]: the consumers are done with it

  // the ring in this block's dynamic shared memory, its barriers made
  // (every thread calls it, before the roles part)
  static __device__ Ring make(unsigned char* smem) {
    Ring r;
    r.base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
    r.full = reinterpret_cast<uint64_t*>(r.base + kStages * kSlot);
    r.empty = r.full + kStages;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&r.full[s], 1);
        mbar_init(&r.empty[s], kConsumers);
      }
      mbar_fence_init();
    }
    __syncthreads();
    return r;
  }
  __device__ unsigned char* a(int s) const { return base + s * kSlot; }
  __device__ unsigned char* b(int s) const {
    return base + s * kSlot + kOperand;
  }
};

// one operand's slice at depth k for rows [r0, r0 + 128): K-major, one box
// at (k, r0); MN-major, two boxes at (r0, k) and (r0 + 64, k)
template <bool kMN>
__device__ __forceinline__ void load_operand(unsigned char* dst,
                                             const CUtensorMap* map,
                                             uint64_t* bar, int r0, int k) {
  if (kMN) {
    tma_load(dst, map, bar, r0, k);
    tma_load(dst + kBox, map, bar, r0 + 64, k);
  } else {
    tma_load(dst, map, bar, k, r0);
  }
}

// The producer (one thread): slices 0 .. slices-1 of the tile whose A
// rows start at m0 and B rows at n0, depth from k0.
template <bool kAMN, bool kBMN>
__device__ void produce(const Ring& r, const CUtensorMap* ma,
                        const CUtensorMap* mb, int m0, int n0, int k0,
                        int slices) {
  for (int i = 0; i < slices; ++i) {
    const int s = i % kStages;
    if (i >= kStages) mbar_wait(&r.empty[s], (i / kStages - 1) & 1);
    mbar_expect_tx(&r.full[s], kSlot);
    const int k = k0 + i * kBK;
    load_operand<kAMN>(r.a(s), ma, &r.full[s], m0, k);
    load_operand<kBMN>(r.b(s), mb, &r.full[s], n0, k);
  }
}

// The consumers (one warpgroup): acc = the tile's product over the
// slices, fp32, summed in slice order and within a slice in depth order.
template <bool kAMN, bool kBMN>
__device__ void consume(const Ring& r, float (&acc)[2][64], int slices) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  for (int i = 0; i < slices; ++i) {
    const int s = i % kStages;
    mbar_wait(&r.full[s], (i / kStages) & 1);
    fence_operands(acc[0]);
    fence_operands(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = kBMN ? descriptor(r.b(s) + kk * 2048, kBox, 1024)
                               : descriptor(r.b(s) + kk * 32, 16, 1024);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned char* pa = r.a(s) + h * kBox;
        const uint64_t da = kAMN ? descriptor(pa + kk * 2048, kBox, 1024)
                                 : descriptor(pa + kk * 32, 16, 1024);
        wgmma_m64n128<kAMN, kBMN>(acc[h], da, db);
      }
    }
    wgmma_commit();
    fence_operands(acc[0]);
    fence_operands(acc[1]);
    wgmma_wait<1>();   // the slice before this one is done
    if (i > 0) mbar_arrive(&r.empty[(i - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_operands(acc[0]);
  fence_operands(acc[1]);
}

// ------------------------------------- wide runs of tiles (persistent)
//
// The fused CE forward's variant of the body: a block walks a run of
// 128 x 256 output tiles that share A's rows, on one ring that runs on
// across them (the producer fills the next tile's slices while the
// consumers finish this one, and the ring never drains between tiles).
// A slot holds A's 128 x 64 slice (one box) and B's 256 x 64 (one box of
// 256 rows); two consumer warpgroups, warpgroup w the A rows 64w .. over
// all 256 columns, two m64n128k16 products a 16-deep step: twice the
// product per byte brought into shared memory of the 128 x 128 tile.
// Ring position i counts the slices of every tile before it, so slot and
// phase follow from i alone. kWideStages slots of 48 KB: one block an SM.

constexpr int kWideBN = 2 * kBN;                   // tile columns: 256
constexpr int kWideStages = 4;
constexpr int kWideConsumers = 2 * kConsumers;     // two warpgroups
constexpr int kWideThreads = kWideConsumers + 32;  // and the producer warp
constexpr int kWideSlot = kOperand + kWideBN * kBK * 2;   // 48 KB
constexpr size_t kWideSmem =
    (size_t)kWideStages * kWideSlot + 1024 + 2 * kWideStages * 8;

struct WideRing {
  unsigned char* base;   // kWideStages slots of kWideSlot bytes, aligned
  uint64_t* full;        // [kWideStages]: the slot's boxes have landed
  uint64_t* empty;       // [kWideStages]: both warpgroups are done with it

  // as Ring::make
  static __device__ WideRing make(unsigned char* smem) {
    WideRing r;
    r.base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
    r.full = reinterpret_cast<uint64_t*>(r.base + kWideStages * kWideSlot);
    r.empty = r.full + kWideStages;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kWideStages; ++s) {
        mbar_init(&r.full[s], 1);
        mbar_init(&r.empty[s], kWideConsumers);
      }
      mbar_fence_init();
    }
    __syncthreads();
    return r;
  }
  __device__ unsigned char* a(int s) const { return base + s * kWideSlot; }
  __device__ unsigned char* b(int s) const {
    return base + s * kWideSlot + kOperand;
  }
};

// The producer of a run, both operands K-major: tile j < tiles has A
// rows at m0 and B rows at n0 + j * kWideBN (B's map boxes kWideBN
// rows); its slices are ring positions j * slices ..
__device__ void produce_wide_run(const WideRing& r, const CUtensorMap* ma,
                                 const CUtensorMap* mb, int m0, int n0,
                                 int tiles, int slices) {
  for (int j = 0; j < tiles; ++j)
    for (int k = 0; k < slices; ++k) {
      const int i = j * slices + k, s = i % kWideStages;
      if (i >= kWideStages)
        mbar_wait(&r.empty[s], (i / kWideStages - 1) & 1);
      mbar_expect_tx(&r.full[s], kWideSlot);
      tma_load(r.a(s), ma, &r.full[s], k * kBK, m0);
      tma_load(r.b(s), mb, &r.full[s], k * kBK, n0 + j * kWideBN);
    }
}

// The consumers of one tile of a run, whose slices are ring positions i0
// .. i0 + slices - 1: warpgroup w = threadIdx.x / 128 gets acc[c] = its
// 64 rows against the tile's columns 128c .., summed as consume sums;
// every slot the tile used is released before it returns.
__device__ void consume_wide_at(const WideRing& r, float (&acc)[2][64],
                                int i0, int slices) {
  const int w = threadIdx.x / kConsumers;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[c][i] = 0.f;
  for (int k = 0; k < slices; ++k) {
    const int i = i0 + k, s = i % kWideStages;
    mbar_wait(&r.full[s], (i / kWideStages) & 1);
    fence_operands(acc[0]);
    fence_operands(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = descriptor(r.a(s) + w * kBox + kk * 32, 16, 1024);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // B's rows 128c ..: 128 rows of 128 bytes further on
        const uint64_t db =
            descriptor(r.b(s) + c * kBN * 128 + kk * 32, 16, 1024);
        wgmma_m64n128<false, false>(acc[c], da, db);
      }
    }
    wgmma_commit();
    fence_operands(acc[0]);
    fence_operands(acc[1]);
    wgmma_wait<1>();   // the slice before this one is done
    if (k > 0) mbar_arrive(&r.empty[(i - 1) % kWideStages]);
  }
  wgmma_wait<0>();
  fence_operands(acc[0]);
  fence_operands(acc[1]);
  mbar_arrive(&r.empty[(i0 + slices - 1) % kWideStages]);
}

}  // namespace paddle_wgmma
}  // namespace
