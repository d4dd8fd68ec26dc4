// Row-invariant y = x @ W + b, hand-written for Hopper (sm_90a): the
// products of a cached (generation) forward. It replaces no TPU kernel:
// the JAX package leaves these products to XLA, whose GEMM gives a row the
// same bits whatever the batch. cuBLAS picks its kernel (tile, split, and
// so the order of the sums) by the row count, so on the card a row of a
// 40-row verify window got other bits than the same row in a 5-row one,
// and the engine's streams parted from batch-1 generate's (ROADMAP C12).
//
// x is [M, K] row-major, W Paddle's [K, N] (kNK = 0) or its transpose
// stored [N, K] (kNK = 1: the tied LM head's embedding), b an optional
// [N]; y [M, N] in x's type. Products and sums are fp32, the bias is
// added in fp32 after the last partial, and y is rounded once.
//
// The one rule: nothing about a launch depends on M or on x's address.
// The route, the tile, the contraction order (slices in order, 16-deep
// steps in order inside a slice), the split count, the cluster shape and
// the number of kernels (one) come from K, N, the dtype, W's layout and
// W's alignment alone (kernels/row_linear.py plan, passed in as one int).
// Rows past M in the last row tile read zeros and are not stored; they
// take no other path. x must be 16-byte aligned: the wrapper copies a
// view that is not into fresh memory first, so no choice reads its
// address. A row's bits are the same alone or among 4,095 others,
// whatever those hold, and repeat from run to run: no atomics, and the
// splits fold in a fixed order.
//
// What bounds it on the H100: at a decode step's few rows, W's bytes
// (768 x 3072 bf16 is 4.7 MB, 1.4 us at 3.35 TB/s; the head's 77 MB, 23
// us) and, below a few MB, the fixed cost of a launch and one trip to
// device memory (about 4 us a call, measured); at a prefill's hundreds
// of rows, the tensor cores and the operands' trips through L2.
//
// The warpgroup route (bf16 and fp16, row_gemm_wgmma): a 64 x 128 tile,
// 64 deep a slice, on wgmma_gemm.cuh's m64n128k16 products with fp32
// accumulators. One producer warp keeps a ring of kStages slots full
// with TMA boxes of x (64 rows: at M 8 the box holds 8 live rows, the
// rest TMA's zero fill) and W (W [K, N] is MN-major, two 64-column boxes
// that wgmma transposes; W [N, K] one K-major box); one consumer
// warpgroup waits on each slot's mbarrier, issues the slice's four
// 16-deep products and releases the slot once the next slice's products
// are in flight. Three blocks fit an SM (73 KB each). At decode the
// answer to W's bytes is the K split: each column tile's contraction is
// cut into `splits` runs of slices, the blocks of one tile form a
// thread-block cluster (at most 8, the portable size), so column tiles x
// splits stream W through up to 132 SMs at once; each block leaves its
// fp32 partial in its own shared memory (over its ring, which it no
// longer needs), and rank r folds columns [r, r + 1) x 128 / splits of
// the tile, reading the partials of ranks 0, 1, ... in that order through
// distributed shared memory, ((p0 + p1) + p2) + ..., then adds the bias
// and rounds once. One launch a product: no scratch in device memory, no
// second kernel. The fold moves splits x M x N x 4 bytes between SMs, so
// at a prefill more splits cost more than the SMs they fill: each split
// walks at least 3 slices. Launches use programmatic dependent launch:
// a kernel's launch and barrier set-up run beside the stream's previous
// kernel, and grid_dependency_wait holds every device-memory access until
// that kernel is done (about 1.3 us a call, measured). At prefill the
// answer to the tensor cores is wgmma fed by TMA, so no thread spends an
// instruction on a copy.
//
// The CUDA-core route (row_gemm_fma): float32 (ERNIE's fp32 encode), and
// bf16/fp16 where TMA cannot take W (K or, for [K, N], N not a multiple
// of 8, or W not 16-byte aligned): a 64 x 64 tile, 32 deep a slice, a
// two-stage cp.async ring, 4 x 4 fp32 FMAs a thread, the same K split
// (at least 4 slices each) and in-cluster fold. Its loads are 16-byte
// copies when K (and N for [K, N]) are multiples of 8 and W is aligned,
// else element by element, which changes how the data arrives and not
// the arithmetic. fp16 runs on the warpgroup route, as bf16 does.
#include <cuda_fp16.h>

#include <atomic>
#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "mma_common.cuh"
#include "wgmma_gemm.cuh"

namespace {
namespace paddle_row_gemm {

namespace pw = paddle_wgmma;

constexpr int kMaxSplits = 8;    // the largest portable cluster

template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else if constexpr (std::is_same<T, __half>::value) return __half2float(v);
  else return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else if constexpr (std::is_same<T, __half>::value) return __float2half_rn(v);
  else return __float2bfloat16_rn(v);
}

// the bits of a 2-byte element
template <typename T>
__device__ __forceinline__ uint32_t bits(T v) {
  if constexpr (std::is_same<T, __half>::value) return __half_as_ushort(v);
  else return __bfloat16_as_ushort(v);
}

// the 4 floats at p in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float4 cluster_load4(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// Programmatic dependent launch (the kernels launch with it): wait until
// the stream's previous kernel has finished and its writes are visible;
// and let the stream's next kernel, if it launched with it too, be
// scheduled (it still waits for this one to finish in its own wait).
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename T>
struct Args {
  const T* bias;   // [N] or nullptr
  T* y;            // [M, N]
  int M, N, K, splits;
};

// y[row, col .. col + 3] = T(s[j] + bias[col + j]), the columns below N
template <typename T>
__device__ __forceinline__ void store4(const Args<T>& a, int row, int col,
                                       const float (&s)[4]) {
  T* out = a.y + (int64_t)row * a.N + col;
  T o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = from_f<T>(a.bias != nullptr && col + j < a.N
                         ? __fadd_rn(s[j], to_f(a.bias[col + j]))
                         : s[j]);
  if (a.N % 4 == 0) {   // four in bounds, 4-element aligned: one store
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<uint2*>(out) = make_uint2(
          bits(o[0]) | bits(o[1]) << 16, bits(o[2]) | bits(o[3]) << 16);
    else
      *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < a.N) out[j] = o[j];
  }
}

// The fold of one tile (rows m0 .., kCols columns from n0) whose split
// partials lie at `part` (row stride kStride floats) in each block of the
// cluster: this block (rank `split`) takes columns [split * cw, (split +
// 1) * cw) of the tile, cw = kCols / splits, for the rows below M, sums the
// ranks' partials in rank order, adds the bias and writes y. Every
// thread of the block calls it between two cluster barriers.
template <typename T, int kCols, int kStride, int kBlock>
__device__ __forceinline__ void fold(const float* part, const Args<T>& a,
                                     int m0, int n0, int split) {
  const int splits = a.splits, cw = kCols / splits, groups = cw / 4;
  const int rows = min(64, a.M - m0);
  for (int e = threadIdx.x; e < rows * groups; e += kBlock) {
    const int r = e / groups, c = split * cw + (e % groups) * 4;
    const int col = n0 + c;
    if (col >= a.N) continue;
    const float* p = part + r * kStride + c;
    float4 v[kMaxSplits];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < splits) v[q] = cluster_load4(p, q);
    float s[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
    for (int q = 1; q < kMaxSplits; ++q)
      if (q < splits) {
        s[0] = __fadd_rn(s[0], v[q].x);
        s[1] = __fadd_rn(s[1], v[q].y);
        s[2] = __fadd_rn(s[2], v[q].z);
        s[3] = __fadd_rn(s[3], v[q].w);
      }
    store4(a, m0 + r, col, s);
  }
}

// ------------------------------------------------ the warpgroup route

constexpr int kBM = 64;          // tile rows: one m64 product
constexpr int kBK = 64;          // contraction slice: 128 bytes of 2-byte T
constexpr int kStages = 3;       // ring slots: three blocks an SM
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kXBox = kBM * kBK * 2;        // x's slice: 8 KB
constexpr int kWBox = 64 * kBK * 2;         // a 64 x 64 box of W: 8 KB

constexpr int kBN = 128;         // tile columns: one m64n128 product
constexpr int kSlot = kXBox + kBN * kBK * 2;   // x's slice, then W's
constexpr int kLd = kBN + 8;     // the partial's row stride, in floats
// the ring (1024-byte aligned for the swizzle), then 2 * kStages barriers
constexpr size_t kSmem = (size_t)kStages * kSlot + 1024 + 2 * kStages * 8;
static_assert(kBM * kLd * 4 <= kStages * kSlot,
              "the partial lies over the ring");

struct Maps {
  CUtensorMap x;   // [M][K], boxes of 64 depth x 64 rows
  CUtensorMap w;   // [N][K]: 64 depth x kBN rows; [K][N]: 64 x 64
};

// Block (split blockIdx.x, row tile blockIdx.y, column tile blockIdx.z);
// the blocks of one tile are one cluster, rank = split.
template <typename T, bool kNK>
__global__ void __launch_bounds__(kThreads, 3)
    row_gemm_wgmma(const __grid_constant__ Maps maps, const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kSlot);
  uint64_t* empty = full + kStages;
  const int t = threadIdx.x;
  if (t == kConsumers) {   // the producer fetches both maps early
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&maps.x))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&maps.w))
                 : "memory");
  }
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      pw::mbar_init(&full[s], 1);
      pw::mbar_init(&empty[s], kConsumers);
    }
    pw::mbar_fence_init();
  }
  __syncthreads();
  // programmatic dependent launch: the launch and the set-up above ran
  // beside the stream's previous kernel; nothing before this line touches
  // device memory, everything after it sees all the previous kernel wrote
  grid_dependency_wait();
  const int split = cluster_rank();
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.z * kBN;
  const int slices = (a.K + kBK - 1) / kBK;
  const int s0 = (int)((int64_t)slices * split / a.splits);
  const int n = (int)((int64_t)slices * (split + 1) / a.splits) - s0;
  float* part = reinterpret_cast<float*>(ring);
  if (t == kConsumers) {
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      if (i >= kStages) pw::mbar_wait(&empty[st], (i / kStages - 1) & 1);
      pw::mbar_expect_tx(&full[st], kSlot);
      unsigned char* sx = ring + st * kSlot;
      unsigned char* sw = sx + kXBox;
      const int k = (s0 + i) * kBK;
      pw::tma_load(sx, &maps.x, &full[st], k, m0);
      if constexpr (kNK) {
        pw::tma_load(sw, &maps.w, &full[st], k, n0);
      } else {
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j)
          pw::tma_load(sw + j * kWBox, &maps.w, &full[st], n0 + 64 * j, k);
      }
    }
  } else if (t < kConsumers) {
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      pw::mbar_wait(&full[st], (i / kStages) & 1);
      const unsigned char* sx = ring + st * kSlot;
      const unsigned char* sw = sx + kXBox;
      pw::fence_operands(acc);
      pw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = pw::descriptor(sx + kk * 32, 16, 1024);
        const uint64_t db = kNK ? pw::descriptor(sw + kk * 32, 16, 1024)
                                : pw::descriptor(sw + kk * 2048, kWBox, 1024);
        pw::wgmma_m64n128<0, kNK ? 0 : 1, std::is_same<T, __half>::value>(
            acc, da, db);
      }
      pw::wgmma_commit();
      pw::fence_operands(acc);
      pw::wgmma_wait<1>();   // the slice before this one is done
      if (i > 0) pw::mbar_arrive(&empty[(i - 1) % kStages]);
    }
    pw::wgmma_wait<0>();
    pw::fence_operands(acc);
    // every consumer's products have read the ring: the partial goes
    // over it, row frag_row, column frag_col
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2)
      *reinterpret_cast<float2*>(part + pw::frag_row(0, i, t) * kLd +
                                 pw::frag_col(i, t)) =
          make_float2(acc[i], acc[i + 1]);
  }
  __syncwarp();
  cluster_sync();   // every split's partial is in its block
  launch_dependents();
  fold<T, kBN, kLd, kThreads>(part, a, m0, n0, split);
  cluster_sync();   // no block leaves while another reads its partial
}

// --------------------------------------------- the CUDA-core route

constexpr int kFThreads = 128;   // 4 warps, 2 x 2 over the tile
constexpr int kFM = 64, kFN = 64, kFK = 32;
constexpr int kMI = 2, kNI = 4;  // m16 and n8 tiles of a warp

template <typename T>
struct FTile {
  static constexpr int kPad = 16 / (int)sizeof(T);   // 16 bytes a row
  static constexpr int kSA = kFK + kPad;    // x [m][k]
  static constexpr int kSB = kFN + kPad;    // W [k][n]
  static constexpr int kSBT = kFK + kPad;   // W [n][k]
  static constexpr int kA = kFM * kSA;
  static constexpr int kB = (kFK * kSB > kFN * kSBT) ? kFK * kSB : kFN * kSBT;
  static constexpr int kLd = kFN + 8;       // the partial's row stride
  static constexpr int kRing = 2 * (kA + kB) * (int)sizeof(T);
  static constexpr int kBytes =
      kRing > kFM * kLd * 4 ? kRing : kFM * kLd * 4;
};

// 8 consecutive elements of a row-major source into shared memory: one
// (2-byte T) or two (fp32) 16-byte cp.async copies when kVec, else
// element by element, each in bounds (col < cols) or zero; !row_ok rows
// are zeros
template <typename T, bool kVec>
__device__ __forceinline__ void stage8(T* dst, const T* src, int64_t ld,
                                       int row, bool row_ok, int col,
                                       int cols) {
  if constexpr (kVec) {
    const bool ok = row_ok && col < cols;
    const T* p = src + (ok ? (int64_t)row * ld + col : 0);
    cp_async16(dst, p, ok);
    if constexpr (sizeof(T) == 4) cp_async16(dst + 4, p + 4, ok);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = (row_ok && col + e < cols) ? src[(int64_t)row * ld + col + e]
                                          : from_f<T>(0.f);
  }
}

// Block (split blockIdx.x, row tile blockIdx.y, column tile blockIdx.z),
// as row_gemm_wgmma's.
template <typename T, bool kNK, bool kVec>
__global__ void __launch_bounds__(kFThreads)
    row_gemm_fma(const T* __restrict__ x, const T* __restrict__ w,
                 const Args<T> a) {
  using L = FTile<T>;
  grid_dependency_wait();   // as row_gemm_wgmma's
  __shared__ __align__(16) unsigned char smem[L::kBytes];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + 2 * L::kA;
  float* part = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t4 = lane & 3;
  const int split = cluster_rank();
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.z * kFN;
  const int M = a.M, N = a.N, K = a.K;
  const int slices = (K + kFK - 1) / kFK;
  const int s0 = (int)((int64_t)slices * split / a.splits);
  const int s1 = (int)((int64_t)slices * (split + 1) / a.splits);

  // slice i's copies into stage st: x as 64 rows of 4 chunks, W [k][n] as
  // 32 rows of 8 chunks, W [n][k] as 64 rows of 4 chunks; 2 a thread each
  auto issue = [&](int i, int st) {
    const int k0 = i * kFK;
    T* A = sa + st * L::kA;
    T* B = sb + st * L::kB;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = tid / 4 + 32 * u, c = tid % 4 * 8;
      stage8<T, kVec>(A + r * L::kSA + c, x, K, m0 + r, m0 + r < M, k0 + c, K);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if constexpr (kNK) {
        const int r = tid / 4 + 32 * u, c = tid % 4 * 8;
        stage8<T, kVec>(B + r * L::kSBT + c, w, K, n0 + r, n0 + r < N,
                        k0 + c, K);
      } else {
        const int r = tid / 8 + 16 * u, c = tid % 8 * 8;
        stage8<T, kVec>(B + r * L::kSB + c, w, N, k0 + r, k0 + r < K,
                        n0 + c, N);
      }
    }
  };

  // acc[mi][ni][2h + j]: tile row wm*32 + mi*16 + 8h + g, column
  // wn*32 + ni*8 + 2*t4 + j
  float acc[kMI][kNI][4] = {};
  if (s0 < s1) issue(s0, 0);
  cp_async_commit();
  for (int i = s0; i < s1; ++i) {
    const int st = (i - s0) & 1;
    if (i + 1 < s1) issue(i + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // slice i is in
    __syncthreads();
    const T* A = sa + st * L::kA;
    const T* B = sb + st * L::kB;
#pragma unroll 4
    for (int k = 0; k < kFK; ++k) {
      float av[kMI][2], bv[kNI][2];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          av[mi][h] = to_f(A[(wm * 32 + mi * 16 + 8 * h + g) * L::kSA + k]);
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = wn * 32 + ni * 8 + 2 * t4 + j;
          bv[ni][j] = to_f(kNK ? B[c * L::kSBT + k] : B[k * L::kSB + c]);
        }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[mi][ni][r] =
                fmaf(av[mi][r >> 1], bv[ni][r & 1], acc[mi][ni][r]);
    }
    __syncthreads();   // stage st is free for slice i + 2
  }
  cp_async_wait_all();
  __syncthreads();     // the ring is free: the partial goes over it
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            part + (wm * 32 + mi * 16 + 8 * h + g) * L::kLd + wn * 32 +
            ni * 8 + 2 * t4) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  cluster_sync();   // every split's partial is in its block
  fold<T, kFN, L::kLd, kFThreads>(part, a, m0, n0, split);
  cluster_sync();   // no block leaves while another reads its partial
}

// ------------------------------------------------------------ host side

// one attribute pass a kernel and device: the dynamic shared memory and
// the shared-memory carveout
template <auto kKernel>
cudaError_t prepare(size_t smem) {
  static std::atomic<int> done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < 64;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  if (smem > 0)
    err = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // all of L1 that may be shared memory: three warpgroup blocks an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kKernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && known)
    done[dev].store(1, std::memory_order_release);
  return err;
}

// kKernel on a grid whose x is the splits, one cluster a tile
template <auto kKernel, class... P>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   P... params) {
  cudaError_t err = prepare<kKernel>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // programmatic dependent launch: the kernel may start beside the
  // stream's previous kernel and waits for it in grid_dependency_wait
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kKernel, params...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The tensor map of a contiguous [rows][cols] matrix at p, boxes of 64
// columns x box_rows rows, kept by (p, rows, cols, box_rows, type): a map
// is a function of those alone. A layer's weight does not move between
// steps, and the caching allocator hands a step's activations the
// addresses of the step before, so most calls encode nothing.
struct MapKey {
  const void* p;
  int64_t rows, cols;
  int box_rows, type;
  bool operator==(const MapKey& o) const {
    return p == o.p && rows == o.rows && cols == o.cols &&
           box_rows == o.box_rows && type == o.type;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& key) const {
    size_t h = std::hash<const void*>()(key.p);
    for (int64_t v : {key.rows, key.cols, (int64_t)key.box_rows,
                      (int64_t)key.type})
      h = h * 1000003u ^ (size_t)v;
    return h;
  }
};

constexpr size_t kMaxMaps = 4096;   // then the cache starts again

bool cached_map(CUtensorMap* out, const void* p, int64_t rows, int64_t cols,
                int box_rows, CUtensorMapDataType type) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{p, rows, cols, box_rows, (int)type};
  std::lock_guard<std::mutex> lock(mu);
  auto it = maps.find(key);
  if (it == maps.end()) {
    CUtensorMap m;
    if (!pw::make_map(&m, p, rows, cols, cols, box_rows, type)) return false;
    if (maps.size() >= kMaxMaps) maps.clear();
    it = maps.emplace(key, m).first;
  }
  *out = it->second;
  return true;
}

template <typename T, bool kNK>
cudaError_t run_wgmma(const void* x, const void* w, const Args<T>& a,
                      cudaStream_t stream) {
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  Maps maps;
  if (!cached_map(&maps.x, x, a.M, a.K, kBM, type) ||
      !(kNK ? cached_map(&maps.w, w, a.N, a.K, kBN, type)
            : cached_map(&maps.w, w, a.K, a.N, 64, type)))
    return cudaErrorInvalidValue;
  const dim3 grid(a.splits, (a.M + kBM - 1) / kBM, (a.N + kBN - 1) / kBN);
  return launch<row_gemm_wgmma<T, kNK>>(grid, kThreads, kSmem, stream,
                                        maps, a);
}

template <typename T>
cudaError_t fma_dispatch(const void* x, const void* w, const Args<T>& a,
                         bool nk, bool vec, cudaStream_t s) {
  const dim3 grid(a.splits, (a.M + kFM - 1) / kFM, (a.N + kFN - 1) / kFN);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  if (nk)
    return vec ? launch<row_gemm_fma<T, true, true>>(grid, kFThreads, 0, s,
                                                     xt, wt, a)
               : launch<row_gemm_fma<T, true, false>>(grid, kFThreads, 0, s,
                                                      xt, wt, a);
  return vec ? launch<row_gemm_fma<T, false, true>>(grid, kFThreads, 0, s,
                                                    xt, wt, a)
             : launch<row_gemm_fma<T, false, false>>(grid, kFThreads, 0, s,
                                                     xt, wt, a);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* b, void* y,
                     int M, int N, int K, bool nk, bool wgmma, int splits,
                     bool vec, cudaStream_t s) {
  const Args<T> a{static_cast<const T*>(b), static_cast<T*>(y), M, N, K,
                  splits};
  if constexpr (sizeof(T) == 2)
    if (wgmma)
      return nk ? run_wgmma<T, true>(x, w, a, s)
                : run_wgmma<T, false>(x, w, a, s);
  return fma_dispatch<T>(x, w, a, nk, vec, s);
}

}  // namespace paddle_row_gemm
}  // namespace

extern "C" {

// y[M, N] = x[M, K] @ W + b; b may be null; x 16-byte aligned. plan
// (kernels/row_linear.py Plan.code), from K, N, the dtype, W's layout and
// alignment alone: bits 0-1 the dtype (0 fp32, 1 bf16, 2 fp16, for x, W,
// b and y alike), bit 2 W stored [N, K] (else [K, N]), bit 3 the
// warpgroup route (else the CUDA-core one), bits 8-15 the splits: the
// cluster's blocks, a power of two up to 8.
// Returns the launch's error, or cudaErrorInvalidValue for a plan that
// does not fit the arguments.
int paddle_row_gemm(const void* x, const void* w, const void* b, void* y,
                    int M, int N, int K, int plan, void* stream) {
  using namespace paddle_row_gemm;
  const int dtype = plan & 3, splits = (plan >> 8) & 0xff;
  const bool nk = (plan >> 2) & 1, wgmma = (plan >> 3) & 1;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool shapes8 = K % 8 == 0 && (nk || N % 8 == 0);
  if (M <= 0 || N <= 0 || K < 0 || dtype > 2 || splits < 1 ||
      splits > kMaxSplits || (splits & (splits - 1)) != 0 || !aligned(x) ||
      (M + 63) / 64 > 65535 || (wgmma && (dtype == 0 || K == 0 || !shapes8 ||
                                          !aligned(w))))
    return (int)cudaErrorInvalidValue;
  const bool vec = shapes8 && aligned(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch<float>(x, w, b, y, M, N, K, nk, false, splits,
                                  vec, s);
    case 1:
      return (int)dispatch<__nv_bfloat16>(x, w, b, y, M, N, K, nk, wgmma,
                                          splits, vec, s);
    default:
      return (int)dispatch<__half>(x, w, b, y, M, N, K, nk, wgmma, splits,
                                   vec, s);
  }
}

}  // extern "C"
