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
// The one rule: nothing about the launch depends on M. The tile (kBM x
// kBN, kBK deep), the contraction order (slices in order, 16-deep steps
// in order inside a slice) and the split count (from K and N alone:
// kernels/row_linear.py split_count, passed in) are fixed before M is
// looked at. Rows past M in the last row tile read zeros and are not
// stored; they take no other path. Splits write fp32 partials that
// row_gemm_combine_kernel folds in split order; no atomics. So a row's
// bits are the same alone or among 4,095 others.
//
// What bounds it on the H100: at a decode step's few rows, the bytes of
// W (768 x 3072 bf16 is 4.7 MB, 1.4 us at 3.35 TB/s); at a prefill's
// thousands of rows, the tensor cores. The design's answer at decode is
// the K split: a grid of ceil(M/64) x ceil(N/64) blocks leaves most of
// the 132 SMs idle at M <= 64, so each column tile's contraction is cut
// into up to TARGET_BLOCKS / (N / 64) contiguous runs of slices (at least
// 4 slices each; kernels/row_linear.py), each a block, and W streams
// through many SMs at once. It is a first, simple
// kernel: a two-stage cp.async ring and warp-level mma.sync.m16n8k16
// (bf16 and fp16; fp32 runs the same tile with FMAs on the CUDA cores).
// Loads are 16-byte copies when K (and N for [K, N]) are multiples of 8
// and x and W are 16-byte aligned; otherwise the same tile is staged
// element by element, which changes how the data arrives and not the
// arithmetic.
#include <cuda_fp16.h>
#include <type_traits>

#include "mma_common.cuh"

namespace {
namespace paddle_row_gemm {

constexpr int kThreads = 128;   // 4 warps, 2 x 2 over the tile
constexpr int kBM = 64;         // tile rows (of M)
constexpr int kBN = 64;         // tile columns (of N)
constexpr int kBK = 32;         // contraction slice
constexpr int kMI = 2;          // m16 tiles of a warp (32 rows)
constexpr int kNI = 4;          // n8 tiles of a warp (32 columns)

template <typename T>
__host__ __device__ constexpr int pad_of() {
  return 16 / (int)sizeof(T);   // 16 bytes: fragment loads on distinct banks
}

template <typename T>
struct Tile {
  static constexpr int kSA = kBK + pad_of<T>();   // A [m][k]
  static constexpr int kSB = kBN + pad_of<T>();   // B [k][n]
  static constexpr int kSBT = kBK + pad_of<T>();  // B [n][k]
  static constexpr int kA = kBM * kSA;
  static constexpr int kB = (kBK * kSB > kBN * kSBT) ? kBK * kSB : kBN * kSBT;
};

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

// 8 consecutive elements of a row-major source into shared memory: one
// (bf16/fp16) or two (fp32) 16-byte cp.async copies when kVec, else
// element by element, each in bounds (col < cols) or zero; !row_ok rows
// are zeros
template <typename T, bool kVec>
__device__ __forceinline__ void stage8(T* dst, const T* src, int64_t ld,
                                       int row, bool row_ok, int col,
                                       int cols) {
  if constexpr (kVec) {
    const bool ok = row_ok && col < cols;
    const T* p = src + (ok ? (int64_t)row * ld + col : 0);
    if constexpr (sizeof(T) == 2) {
      cp_async16(dst, p, ok);
    } else {
      cp_async16(dst, p, ok);
      cp_async16(dst + 4, p + 4, ok);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = (row_ok && col + e < cols) ? src[(int64_t)row * ld + col + e]
                                          : from_f<T>(0.f);
  }
}

template <typename T>
__device__ __forceinline__ void mma_t(float (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __half>::value) mma_f16(d, a, b);
  else mma_bf16(d, a, b);
}

// One block: rows [m0, m0 + kBM) and columns [n0, n0 + kBN) of y, over
// contraction slices [s0, s1) (split blockIdx.z of `splits`). splits ==
// 1 writes y with the bias; else the split's fp32 partial goes to
// part[blockIdx.z][M][N].
template <typename T, bool kNK, bool kVec>
__global__ void __launch_bounds__(kThreads)
    row_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, T* __restrict__ y,
                    float* __restrict__ part, int M, int N, int K,
                    int splits) {
  using L = Tile<T>;
  __shared__ __align__(16) T sa[2 * L::kA];
  __shared__ __align__(16) T sb[2 * L::kB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int lj = lane >> 3, lr = lane & 7, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int slices = (K + kBK - 1) / kBK;
  const int s0 = (int)((int64_t)slices * blockIdx.z / splits);
  const int s1 = (int)((int64_t)slices * (blockIdx.z + 1) / splits);

  // slice i's copies into stage st: A as 64 rows of 4 chunks, B [k][n] as
  // 32 rows of 8 chunks, B [n][k] as 64 rows of 4 chunks; 2 a thread each
  auto issue = [&](int i, int st) {
    const int k0 = i * kBK;
    T* A = sa + st * L::kA;
    T* B = sb + st * L::kB;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = tid / 4 + 32 * u, c = tid % 4 * 8;
      stage8<T, kVec>(A + r * L::kSA + c, x, K, m0 + r, m0 + r < M, k0 + c, K);
    }
    if constexpr (kNK) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = tid / 4 + 32 * u, c = tid % 4 * 8;
        stage8<T, kVec>(B + r * L::kSBT + c, w, K, n0 + r, n0 + r < N,
                        k0 + c, K);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = tid / 8 + 16 * u, c = tid % 8 * 8;
        stage8<T, kVec>(B + r * L::kSB + c, w, N, k0 + r, k0 + r < K, n0 + c,
                        N);
      }
    }
  };

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
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      if constexpr (sizeof(T) == 2) {
        uint32_t af[kMI][4], bfr[kNI][2];
        load_a<kMI, false>(af, [&](int mi) {
          return A + (wm * 32 + mi * 16 + 8 * (lj & 1) + lr) * L::kSA + ks +
                 8 * (lj >> 1);
        });
        if constexpr (kNK)
          load_b<kNI, false>(bfr, [&](int np) {
            return B + (wn * 32 + 16 * np + 8 * (lj >> 1) + lr) * L::kSBT +
                   ks + 8 * (lj & 1);
          });
        else
          load_b<kNI, true>(bfr, [&](int np) {
            return B + (ks + 8 * (lj & 1) + lr) * L::kSB + wn * 32 + 16 * np +
                   8 * (lj >> 1);
          });
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNI; ++ni) mma_t<T>(acc[mi][ni], af[mi], bfr[ni]);
      } else {
        fma_step<kMI, kNI>(
            acc,
            [&](int mi, int h, int k) {
              return A + (wm * 32 + mi * 16 + 8 * h + g) * L::kSA + ks + k;
            },
            [&](int n, int k) {
              return kNK ? B + (wn * 32 + n) * L::kSBT + ks + k
                         : B + (ks + k) * L::kSB + wn * 32 + n;
            });
      }
    }
    __syncthreads();   // stage st is free for slice i + 2
  }
  cp_async_wait_all();

  // acc[mi][ni][2h + j]: tile row wm*32 + mi*16 + 8h + g, column
  // wn*32 + ni*8 + 2t + j
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t + j;
      if (col >= N) continue;
      const float bv = (splits == 1 && bias != nullptr) ? to_f(bias[col]) : 0.f;
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 32 + mi * 16 + 8 * h + g;
          if (row >= M) continue;
          const float v = acc[mi][ni][2 * h + j];
          if (splits == 1)
            y[(int64_t)row * N + col] =
                from_f<T>(bias != nullptr ? __fadd_rn(v, bv) : v);
          else
            part[((int64_t)blockIdx.z * M + row) * N + col] = v;
        }
    }
}

// y = T(((part[0] + part[1]) + ...) + b), the splits in order
template <typename T>
__global__ void row_gemm_combine_kernel(const float* __restrict__ part,
                                        const T* __restrict__ bias,
                                        T* __restrict__ y, int64_t MN, int N,
                                        int splits) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < MN;
       i += (int64_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < splits; ++s) v = __fadd_rn(v, part[s * MN + i]);
    if (bias != nullptr) v = __fadd_rn(v, to_f(bias[i % N]));
    y[i] = from_f<T>(v);
  }
}

template <typename T, bool kNK>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   float* part, int M, int N, int K, int splits, bool vec,
                   cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, stream>>>((const T*)x, (const T*)w,
                                          (const T*)b, (T*)y, part, M, N, K,
                                          splits);
  };
  if (vec) args(row_gemm_kernel<T, kNK, true>);
  else args(row_gemm_kernel<T, kNK, false>);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t mn = (int64_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 132 * 16 ? (mn + 255) / 256
                                                        : 132 * 16);
  row_gemm_combine_kernel<T><<<blocks, 256, 0, stream>>>(
      part, (const T*)b, (T*)y, mn, N, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* b, void* y,
                     float* part, int M, int N, int K, int w_nk, int splits,
                     bool vec, cudaStream_t stream) {
  return w_nk ? launch<T, true>(x, w, b, y, part, M, N, K, splits, vec, stream)
              : launch<T, false>(x, w, b, y, part, M, N, K, splits, vec,
                                 stream);
}

}  // namespace paddle_row_gemm
}  // namespace

extern "C" {

// y[M, N] = x[M, K] @ W + b. w_nk: W stored [N, K] (else [K, N]); b may
// be null; part: splits * M * N floats when splits > 1 (else unused);
// dtype 0 fp32, 1 bf16, 2 fp16 for x, W, b and y alike. Returns the
// launch's cudaGetLastError().
int paddle_row_gemm(const void* x, const void* w, const void* b, void* y,
                    float* part, int M, int N, int K, int w_nk, int splits,
                    int dtype, void* stream) {
  using namespace paddle_row_gemm;
  if (M <= 0 || N <= 0 || K < 0 || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool vec = K % 8 == 0 && (w_nk || N % 8 == 0) && aligned(x) &&
                   aligned(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch<float>(x, w, b, y, part, M, N, K, w_nk, splits,
                                  vec, s);
    case 1:
      return (int)dispatch<__nv_bfloat16>(x, w, b, y, part, M, N, K, w_nk,
                                          splits, vec, s);
    case 2:
      return (int)dispatch<__half>(x, w, b, y, part, M, N, K, w_nk, splits,
                                   vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
