// Fused LayerNorm / RMSNorm over the last dim, forward and input
// gradient, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/kernels/fused_norm.py:
//   paddle_norm_fwd   _norm_2d_fwd_pallas :66 (_fwd_kernel :43, _stats :33)
//   paddle_norm_dx    _norm_2d_dx_pallas :83 (_bwd_kernel :51)
//
// What they compute, per row of x [rows, D] (fp32 math whatever the
// storage type, one rounding to x's type at the end):
//   statistics  LayerNorm: mean = sum(x)/D, then ms = sum((x-mean)^2)/D
//               (two passes over the row, as _stats does, not Welford);
//               RMSNorm: mean = 0, ms = sum(x^2)/D; rstd = rsqrt(ms + eps)
//   forward     xhat = (x - mean)*rstd, y = xhat*w + b
//   dx          g = dy*w, c1 = sum(g)/D (LayerNorm only),
//               c2 = sum(g*xhat)/D, dx = rstd*(g - c1 - xhat*c2)
// dw and db are not here: they are reductions over rows, plain PyTorch in
// the caller, as they are plain XLA in the JAX package.
//
// What bounds them on the H100: bytes. The forward reads x and writes y,
// dx reads x and dy and writes dx, a few operations per element (about
// 0.1 of the fp32 rate at 3.35 TB/s). So each element is read from
// device memory once: a row up to 1024 wide lives in one warp's registers
// (8 rows a block), a wider row in one block's shared memory (fp32), and
// both passes of the statistics and the output run from there. Rows whose
// fp32 copy would not fit in 47 KB of shared memory (D > 12032 forward,
// > 6016 dx) are re-read from device memory for each pass instead. Loads
// and stores are 16 bytes a thread where every row start is 16-byte
// aligned and D a multiple of the vector; otherwise one element a thread
// (still coalesced across the warp). The TPU grid's 256-row blocks are
// tiling, not semantics: any rows, any D, 64-bit offsets.
//
// The row sums are warp butterflies and a fixed-order sum of the warps'
// partials: no atomics, the same bits run to run. The elementwise steps
// use __fmul_rn/__fadd_rn/__fsub_rn, so nvcc cannot contract them into an
// fma and they round where the plain PyTorch version rounds; only the sum
// order of the statistics differs from it.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using half = __half;

constexpr int kWarpRows = 8;           // rows (one a warp) of a warp kernel's block
constexpr int kWarpMaxD = 1024;        // widest row a warp keeps in registers
constexpr int kBlockThreads = 256;     // threads of a row-per-block kernel
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kStageBytes = 47 * 1024; // fp32 row bytes staged in shared memory

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ half from_f<half>(float v) {
  return __float2half_rn(v);
}

// V elements moved as one access of V * sizeof(T) bytes
template <typename T, int V> struct alignas(V * sizeof(T)) Pack { T e[V]; };

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float* v) {
  const Pack<T, V> u = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = to_f(u.e[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* v) {
  Pack<T, V> u;
#pragma unroll
  for (int j = 0; j < V; ++j) u.e[j] = from_f<T>(v[j]);
  *reinterpret_cast<Pack<T, V>*>(p) = u;
}

// Butterfly sum: every lane ends with the same bits (a + b == b + a).
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Sum over the block, the warps' partials added in a fixed order; every
// thread gets the same value. red: kBlockWarps floats of shared memory.
__device__ __forceinline__ float block_sum(float s, float* red) {
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kBlockWarps; ++i) t += red[i];
  __syncthreads();  // red is written again by the next sum
  return t;
}

__device__ __forceinline__ float xhat_of(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}

__device__ __forceinline__ float affine(float xh, float w, float b) {
  return __fadd_rn(__fmul_rn(xh, w), b);
}

// rstd * (g - c1 - xhat*c2), c1 = 0 for RMSNorm
__device__ __forceinline__ float dx_of(float g, float xh, float c1, float c2,
                                       float rstd, bool rms) {
  const float t = rms ? g : __fsub_rn(g, c1);
  return __fmul_rn(rstd, __fsub_rn(t, __fmul_rn(xh, c2)));
}

// ------------------------------------------------------------ one warp a row

// Lane l holds chunks l, l+32, ... of V elements: kC chunks of registers.
template <typename T, int V>
__global__ void __launch_bounds__(kWarpRows * 32)
norm_fwd_warp(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, T* __restrict__ y, int64_t rows,
              int d, int64_t ldx, float eps, bool rms) {
  constexpr int kC = kWarpMaxD / 32 / V;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * ldx;
  const int n = d / V;
  float v[kC][V];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int k = c * 32 + lane;
    if (k < n) {
      load<T, V>(xr + (int64_t)k * V, v[c]);
#pragma unroll
      for (int j = 0; j < V; ++j) s += v[c][j];
    }
  }
  const float mean = rms ? 0.f : warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    if (c * 32 + lane < n) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = v[c][j] - mean;
        q += t * t;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / d + eps);
  T* yr = y + row * d;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int k = c * 32 + lane;
    if (k < n) {
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int col = k * V + j;
        o[j] = affine(xhat_of(v[c][j], mean, rstd), __ldg(w + col),
                      __ldg(b + col));
      }
      store<T, V>(yr + (int64_t)k * V, o);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kWarpRows * 32)
norm_dx_warp(const T* __restrict__ x, const float* __restrict__ w,
             const T* __restrict__ dy, T* __restrict__ dx, int64_t rows,
             int d, int64_t ldx, int64_t lddy, float eps, bool rms) {
  constexpr int kC = kWarpMaxD / 32 / V;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * ldx;
  const T* dyr = dy + row * lddy;
  const int n = d / V;
  float v[kC][V], g[kC][V];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int k = c * 32 + lane;
    if (k < n) {
      load<T, V>(xr + (int64_t)k * V, v[c]);
      load<T, V>(dyr + (int64_t)k * V, g[c]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s += v[c][j];
        g[c][j] = __fmul_rn(g[c][j], __ldg(w + k * V + j));
      }
    }
  }
  const float mean = rms ? 0.f : warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    if (c * 32 + lane < n) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = v[c][j] - mean;
        q += t * t;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / d + eps);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    if (c * 32 + lane < n) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[c][j] = xhat_of(v[c][j], mean, rstd);   // x is not needed again
        s1 += g[c][j];
        s2 += g[c][j] * v[c][j];
      }
    }
  }
  const float c1 = rms ? 0.f : warp_sum(s1) / d;
  const float c2 = warp_sum(s2) / d;
  T* dxr = dx + row * d;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int k = c * 32 + lane;
    if (k < n) {
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = dx_of(g[c][j], v[c][j], c1, c2, rstd, rms);
      store<T, V>(dxr + (int64_t)k * V, o);
    }
  }
}

// ------------------------------------------------------------ one block a row

// Chunk k (V elements at k*V) of a row: staged in shared memory as fp32,
// or read again from device memory.
template <typename T, int V, bool kStage>
__device__ __forceinline__ void chunk(const T* row, const float* staged,
                                      int k, float* v) {
  if (kStage) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = staged[k * V + j];
  } else {
    load<T, V>(row + (int64_t)k * V, v);
  }
}

template <typename T, int V, bool kStage>
__global__ void __launch_bounds__(kBlockThreads)
norm_fwd_block(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, T* __restrict__ y, int d,
               int64_t ldx, float eps, bool rms) {
  extern __shared__ float sx[];  // [d] when kStage
  __shared__ float red[kBlockWarps];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * ldx;
  const int n = d / V;
  float s = 0.f;
  for (int k = threadIdx.x; k < n; k += kBlockThreads) {
    float v[V];
    load<T, V>(xr + (int64_t)k * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s += v[j];
      if (kStage) sx[k * V + j] = v[j];  // read back by this thread only
    }
  }
  const float mean = rms ? 0.f : block_sum(s, red) / d;
  float q = 0.f;
  for (int k = threadIdx.x; k < n; k += kBlockThreads) {
    float v[V];
    chunk<T, V, kStage>(xr, sx, k, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = v[j] - mean;
      q += t * t;
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) / d + eps);
  T* yr = y + row * d;
  for (int k = threadIdx.x; k < n; k += kBlockThreads) {
    float v[V];
    chunk<T, V, kStage>(xr, sx, k, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int col = k * V + j;
      v[j] = affine(xhat_of(v[j], mean, rstd), __ldg(w + col),
                    __ldg(b + col));
    }
    store<T, V>(yr + (int64_t)k * V, v);
  }
}

template <typename T, int V, bool kStage>
__global__ void __launch_bounds__(kBlockThreads)
norm_dx_block(const T* __restrict__ x, const float* __restrict__ w,
              const T* __restrict__ dy, T* __restrict__ dx, int d,
              int64_t ldx, int64_t lddy, float eps, bool rms) {
  extern __shared__ float sx[];  // [2d] when kStage: x, then g = dy*w
  __shared__ float red[kBlockWarps];
  float* sg = sx + d;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * ldx;
  const T* dyr = dy + row * lddy;
  const int n = d / V;
  float s = 0.f;
  for (int k = threadIdx.x; k < n; k += kBlockThreads) {
    float v[V], g[V];
    load<T, V>(xr + (int64_t)k * V, v);
    if (kStage) load<T, V>(dyr + (int64_t)k * V, g);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s += v[j];
      if (kStage) {
        sx[k * V + j] = v[j];
        sg[k * V + j] = __fmul_rn(g[j], __ldg(w + k * V + j));
      }
    }
  }
  const float mean = rms ? 0.f : block_sum(s, red) / d;
  float q = 0.f;
  for (int k = threadIdx.x; k < n; k += kBlockThreads) {
    float v[V];
    chunk<T, V, kStage>(xr, sx, k, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = v[j] - mean;
      q += t * t;
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) / d + eps);
  // g of chunk k: staged, or dy read again and multiplied by w
  auto grad = [&](int k, float* g) {
    if (kStage) {
#pragma unroll
      for (int j = 0; j < V; ++j) g[j] = sg[k * V + j];
    } else {
      load<T, V>(dyr + (int64_t)k * V, g);
#pragma unroll
      for (int j = 0; j < V; ++j) g[j] = __fmul_rn(g[j], __ldg(w + k * V + j));
    }
  };
  float s1 = 0.f, s2 = 0.f;
  for (int k = threadIdx.x; k < n; k += kBlockThreads) {
    float v[V], g[V];
    chunk<T, V, kStage>(xr, sx, k, v);
    grad(k, g);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1 += g[j];
      s2 += g[j] * xhat_of(v[j], mean, rstd);
    }
  }
  const float c1 = rms ? 0.f : block_sum(s1, red) / d;
  const float c2 = block_sum(s2, red) / d;
  T* dxr = dx + row * d;
  for (int k = threadIdx.x; k < n; k += kBlockThreads) {
    float v[V], g[V];
    chunk<T, V, kStage>(xr, sx, k, v);
    grad(k, g);
#pragma unroll
    for (int j = 0; j < V; ++j)
      v[j] = dx_of(g[j], xhat_of(v[j], mean, rstd), c1, c2, rstd, rms);
    store<T, V>(dxr + (int64_t)k * V, v);
  }
}

// ------------------------------------------------------------ launch

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// 16-byte accesses when every row start is aligned and D a multiple of
// the vector width
template <typename T>
bool vector_rows(int d, const void* a, int64_t lda, const void* b,
                 int64_t ldb) {
  constexpr int V = 16 / sizeof(T);
  return d % V == 0 && aligned16(a) && aligned16(b) &&
         (lda * (int64_t)sizeof(T)) % 16 == 0 &&
         (ldb * (int64_t)sizeof(T)) % 16 == 0;
}

template <typename T, int V>
void fwd_launch(const T* x, const float* w, const float* b, T* y,
                int64_t rows, int d, int64_t ldx, float eps, bool rms,
                cudaStream_t st) {
  if (d <= kWarpMaxD) {
    const unsigned grid = (unsigned)((rows + kWarpRows - 1) / kWarpRows);
    norm_fwd_warp<T, V><<<grid, kWarpRows * 32, 0, st>>>(x, w, b, y, rows, d,
                                                         ldx, eps, rms);
  } else if ((int64_t)d * 4 <= kStageBytes) {
    norm_fwd_block<T, V, true><<<(unsigned)rows, kBlockThreads, d * 4, st>>>(
        x, w, b, y, d, ldx, eps, rms);
  } else {
    norm_fwd_block<T, V, false><<<(unsigned)rows, kBlockThreads, 0, st>>>(
        x, w, b, y, d, ldx, eps, rms);
  }
}

template <typename T, int V>
void dx_launch(const T* x, const float* w, const T* dy, T* dx, int64_t rows,
               int d, int64_t ldx, int64_t lddy, float eps, bool rms,
               cudaStream_t st) {
  if (d <= kWarpMaxD) {
    const unsigned grid = (unsigned)((rows + kWarpRows - 1) / kWarpRows);
    norm_dx_warp<T, V><<<grid, kWarpRows * 32, 0, st>>>(x, w, dy, dx, rows, d,
                                                        ldx, lddy, eps, rms);
  } else if ((int64_t)d * 8 <= kStageBytes) {
    norm_dx_block<T, V, true><<<(unsigned)rows, kBlockThreads, d * 8, st>>>(
        x, w, dy, dx, d, ldx, lddy, eps, rms);
  } else {
    norm_dx_block<T, V, false><<<(unsigned)rows, kBlockThreads, 0, st>>>(
        x, w, dy, dx, d, ldx, lddy, eps, rms);
  }
}

template <typename T>
int forward(const void* x, const float* w, const float* b, void* y,
            int64_t rows, int d, int64_t ldx, float eps, bool rms,
            cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vector_rows<T>(d, x, ldx, y, d))
    fwd_launch<T, 16 / sizeof(T)>(xt, w, b, yt, rows, d, ldx, eps, rms, st);
  else
    fwd_launch<T, 1>(xt, w, b, yt, rows, d, ldx, eps, rms, st);
  return cudaGetLastError();
}

template <typename T>
int backward(const void* x, const float* w, const void* dy, void* dx,
             int64_t rows, int d, int64_t ldx, int64_t lddy, float eps,
             bool rms, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (vector_rows<T>(d, x, ldx, dy, lddy) && aligned16(dx))
    dx_launch<T, 16 / sizeof(T)>(xt, w, dyt, dxt, rows, d, ldx, lddy, eps,
                                 rms, st);
  else
    dx_launch<T, 1>(xt, w, dyt, dxt, rows, d, ldx, lddy, eps, rms, st);
  return cudaGetLastError();
}

bool shapes_ok(long long rows, int d, long long ldx) {
  // the row-per-block kernels put rows on grid.x (at most 2^31 - 1)
  return rows > 0 && rows <= 0x7fffffffLL && d > 0 && ldx >= d;
}

}  // namespace

// Forward. x [rows, d] with row stride ldx (elements; the last dim
// contiguous), y [rows, d] contiguous, both of dtype 0 (float32),
// 1 (bfloat16) or 2 (float16); w, b fp32 [d]. rms 1: RMSNorm (b is still
// added: the callers pass zeros). One launch. Returns its cudaError_t.
extern "C" int paddle_norm_fwd(const void* x, const float* w, const float* b,
                               void* y, long long rows, int d, long long ldx,
                               float eps, int rms, int dtype, void* stream) {
  if (!shapes_ok(rows, d, ldx)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return forward<float>(x, w, b, y, rows, d, ldx, eps, rms, st);
  if (dtype == 1) return forward<bf16>(x, w, b, y, rows, d, ldx, eps, rms, st);
  if (dtype == 2) return forward<half>(x, w, b, y, rows, d, ldx, eps, rms, st);
  return cudaErrorInvalidValue;
}

// Input gradient. x [rows, d] (row stride ldx), dy [rows, d] (row stride
// lddy), dx [rows, d] contiguous, all of one dtype as above; w fp32 [d].
// One launch. Returns its cudaError_t.
extern "C" int paddle_norm_dx(const void* x, const float* w, const void* dy,
                              void* dx, long long rows, int d, long long ldx,
                              long long lddy, float eps, int rms, int dtype,
                              void* stream) {
  if (!shapes_ok(rows, d, ldx) || lddy < d) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(x, w, dy, dx, rows, d, ldx, lddy, eps, rms, st);
  if (dtype == 1)
    return backward<bf16>(x, w, dy, dx, rows, d, ldx, lddy, eps, rms, st);
  if (dtype == 2)
    return backward<half>(x, w, dy, dx, rows, d, ldx, lddy, eps, rms, st);
  return cudaErrorInvalidValue;
}
