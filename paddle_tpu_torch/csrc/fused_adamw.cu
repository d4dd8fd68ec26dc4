// Fused AdamW update of one tensor, in place, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of paddle_tpu/kernels/fused_adamw.py:
//   paddle_adamw   fused_adamw_update :46 (_adamw_kernel :30)
//
// What it computes, per element, operation for operation as _adamw_kernel
// (fp32 math; p and g of any float type, m and v fp32):
//   m = b1*m + (1-b1)*g
//   v = b2*v + ((1-b2)*g)*g
//   update = (m/bc1) / (sqrt(v/bc2) + eps) + wd*p
//   p = p - lr*update            (rounded once to p's type)
// with bc1 = 1 - b1^step and bc2 = 1 - b2^step. Every step is an _rn
// intrinsic: nvcc would otherwise contract a*b + c into an fma, and the
// plain PyTorch version, which rounds after each operation, would no
// longer give the same bits.
//
// The seven hyperparameters (lr, b1, b2, eps, wd, bc1, bc2, all fp32)
// arrive as kernel arguments when the caller has them on the host, or as a
// device vector of seven floats when lr or step is a tensor (the TPU
// kernel's scalar prefetch): no host sync, no rebuild across a schedule.
//
// What bounds it on the H100: bytes. p, m, v are read and written, g is
// read: 26 bytes a value for fp32 p and bf16 g, against about 15
// operations. A grid-stride loop moves 4 values a thread per iteration
// with one 16-byte access for each fp32 array (8 bytes for a 2-byte type)
// where all four arrays are aligned to that, one value a thread
// otherwise, and the tail of n % 4 values one a thread.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using half = __half;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks an SM of an H100

struct Hyper {
  float lr, b1, b2, eps, wd, bc1, bc2;
};

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

__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v,
                                      const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(__fsub_rn(1.f, h.b1), g));
  v = __fadd_rn(__fmul_rn(h.b2, v),
                __fmul_rn(__fmul_rn(__fsub_rn(1.f, h.b2), g), g));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps);
  const float update =
      __fadd_rn(__fdiv_rn(__fdiv_rn(m, h.bc1), denom), __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, update));
}

// V values at element i of each array
template <typename P, typename G, int V>
__device__ __forceinline__ void step_at(P* p, const G* g, float* m, float* v,
                                        int64_t i, const Hyper& h) {
  float pf[V], gf[V], mf[V], vf[V];
  load<P, V>(p + i, pf);
  load<G, V>(g + i, gf);
  load<float, V>(m + i, mf);
  load<float, V>(v + i, vf);
#pragma unroll
  for (int j = 0; j < V; ++j) adamw(pf[j], gf[j], mf[j], vf[j], h);
  store<P, V>(p + i, pf);
  store<float, V>(m + i, mf);
  store<float, V>(v + i, vf);
}

template <typename P, typename G, int V>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(P* __restrict__ p, const G* __restrict__ g,
             float* __restrict__ m, float* __restrict__ v, int64_t n,
             Hyper h, const float* __restrict__ hyper) {
  if (hyper != nullptr)
    h = Hyper{hyper[0], hyper[1], hyper[2], hyper[3],
              hyper[4], hyper[5], hyper[6]};
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t nv = n / V;
  for (int64_t i = tid; i < nv; i += stride) step_at<P, G, V>(p, g, m, v, i * V, h);
  for (int64_t i = nv * V + tid; i < n; i += stride)
    step_at<P, G, 1>(p, g, m, v, i, h);
}

bool aligned(const void* ptr, int bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

template <typename P, typename G>
int launch(void* p, const void* g, float* m, float* v, int64_t n,
           const Hyper& h, const float* hyper, cudaStream_t st) {
  constexpr int V = 4;
  const bool vec = aligned(p, V * sizeof(P)) && aligned(g, V * sizeof(G)) &&
                   aligned(m, 16) && aligned(v, 16);
  const int64_t work = vec ? (n + V - 1) / V : n;
  const unsigned grid = (unsigned)(
      work / kThreads + 1 < kMaxBlocks ? work / kThreads + 1 : kMaxBlocks);
  P* pt = static_cast<P*>(p);
  const G* gt = static_cast<const G*>(g);
  if (vec)
    adamw_kernel<P, G, V><<<grid, kThreads, 0, st>>>(pt, gt, m, v, n, h, hyper);
  else
    adamw_kernel<P, G, 1><<<grid, kThreads, 0, st>>>(pt, gt, m, v, n, h, hyper);
  return cudaGetLastError();
}

template <typename P>
int launch_g(void* p, const void* g, float* m, float* v, int64_t n,
             int g_dtype, const Hyper& h, const float* hyper,
             cudaStream_t st) {
  if (g_dtype == 0) return launch<P, float>(p, g, m, v, n, h, hyper, st);
  if (g_dtype == 1) return launch<P, bf16>(p, g, m, v, n, h, hyper, st);
  if (g_dtype == 2) return launch<P, half>(p, g, m, v, n, h, hyper, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// One AdamW step on n values, in place. p of dtype p_dtype and g of
// g_dtype (0 float32, 1 bfloat16, 2 float16), m and v fp32, all
// contiguous. hyper: a device vector of 7 fp32 (lr, b1, b2, eps, wd, bc1,
// bc2), or null to use the values passed after it. One launch. Returns its
// cudaError_t.
extern "C" int paddle_adamw(void* p, const void* g, float* m, float* v,
                            long long n, int p_dtype, int g_dtype,
                            const float* hyper, float lr, float b1, float b2,
                            float eps, float wd, float bc1, float bc2,
                            void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const Hyper h{lr, b1, b2, eps, wd, bc1, bc2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0) return launch_g<float>(p, g, m, v, n, g_dtype, h, hyper, st);
  if (p_dtype == 1) return launch_g<bf16>(p, g, m, v, n, g_dtype, h, hyper, st);
  if (p_dtype == 2) return launch_g<half>(p, g, m, v, n, g_dtype, h, hyper, st);
  return cudaErrorInvalidValue;
}
