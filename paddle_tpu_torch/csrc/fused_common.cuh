// Helpers shared by the fused ResNet kernels (fused_resnet.cu, the 1x1
// convolutions, and fused_conv3x3.cu, the 3x3): vector loads and stores of
// 2, 4 and 8 elements in float32 or bfloat16 (and 8 held as loaded, for
// fills that keep their loads in flight), the roundings the plain PyTorch
// versions make (the BN-apply + ReLU prologue, the effective output
// gradient), Chan's combine of per-tile (count, mean, M2) and the
// fixed-order column sums that finish every cross-block reduction. Nothing
// here uses an atomic, so the kernels give the same bits run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSumGroups = 32;  // row groups of the fixed-order reductions
constexpr int kSumBatch = 8;    // rows a group loads before it combines

inline int tiles_of(int n, int t) { return (n + t - 1) / t; }

// ------------------------------------------------------------ elements

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float v[4]) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  store4(p, v);
  store4(p + 4, v + 4);
}

__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void load2(const float* p, float v[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x, v[1] = a.y;
}
__device__ __forceinline__ void load2(const bf16* p, float v[2]) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = a.x, v[1] = a.y;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 8 elements held as loaded, converted to fp32 later: a fill issues all of
// a batch's loads before it waits on the first
template <typename T>
struct Vec8;
template <>
struct Vec8<bf16> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float v[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void get(float v[8]) const {
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
};

// v rounded to the storage type T, back in fp32
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// relu(x*scale + shift) in fp32 (two roundings), before its rounding to
// T: for a caller whose store to T rounds it once (store8)
__device__ __forceinline__ float prologue_unrounded(float x, float s,
                                                    float t) {
  return fmaxf(__fadd_rn(__fmul_rn(x, s), t), 0.f);
}

// dy + perch + dvar2*(y - mean) in fp32, before its rounding to T
__device__ __forceinline__ float effective_unrounded(float dy, float y,
                                                     float perch,
                                                     float dvar2,
                                                     float mean) {
  return __fadd_rn(__fadd_rn(dy, perch),
                   __fmul_rn(dvar2, __fsub_rn(y, mean)));
}

// the prologue rounded to T, as the plain version computes it
template <typename T>
__device__ __forceinline__ float prologue(float x, float s, float t) {
  return round_to(prologue_unrounded(x, s, t),
                  static_cast<const T*>(nullptr));
}

// e = T(dy + perch + dvar2*(y - mean))
template <typename T>
__device__ __forceinline__ float effective(float dy, float y, float perch,
                                           float dvar2, float mean) {
  return round_to(effective_unrounded(dy, y, perch, dvar2, mean),
                  static_cast<const T*>(nullptr));
}

// ------------------------------------------------------------ reductions

// Chan's pairwise update of (count, mean, M2) with another group's
__device__ __forceinline__ void chan(float& n_a, float& mu_a, float& q_a,
                                     float n_b, float mu_b, float q_b) {
  if (n_b == 0.f) return;
  const float n = n_a + n_b, d = mu_b - mu_a, f = n_b / n;
  mu_a += d * f;
  q_a += q_b + d * d * n_a * f;
  n_a = n;
}

// The cross-tile reductions below give each of 32 columns a block of
// sum_groups(rows) thread groups (blockDim.y); group g takes a contiguous
// range of the rows, loading kSumBatch rows before it combines them, and
// group 0 then takes the groups in turn. A fixed order for a given shape,
// and every load of a batch is in flight before the first is used: a
// column may sum thousands of tiles.

// thread groups per column for `rows` rows: a batch or more each
inline int sum_groups(int rows) {
  const int g = tiles_of(rows, kSumBatch);
  return g < 1 ? 1 : g > kSumGroups ? kSumGroups : g;
}

// mean, var [N] from the tiles' (mean, M2) [tiles, N], tile t holding
// count(t) rows. var = M2 / count, clamped at 0.
template <class Count>
__global__ void __launch_bounds__(32 * kSumGroups)
stats_finish_kernel(const float* __restrict__ pmean,
                    const float* __restrict__ pm2, int tiles, int N,
                    Count count, float* __restrict__ mean,
                    float* __restrict__ var) {
  __shared__ float sn[kSumGroups][32], sm[kSumGroups][32], sq[kSumGroups][32];
  const int tx = threadIdx.x, g = threadIdx.y, c = blockIdx.x * 32 + tx;
  const int groups = blockDim.y, per = (tiles + groups - 1) / groups;
  const int t1 = min(tiles, (g + 1) * per);
  float n_a = 0.f, mu_a = 0.f, q_a = 0.f;
  if (c < N) {
    for (int t0 = g * per; t0 < t1; t0 += kSumBatch) {
      float n[kSumBatch], m[kSumBatch], q[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        const int t = t0 + u;
        n[u] = t < t1 ? count(t) : 0.f;
        m[u] = t < t1 ? pmean[(size_t)t * N + c] : 0.f;
        q[u] = t < t1 ? pm2[(size_t)t * N + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) chan(n_a, mu_a, q_a, n[u], m[u], q[u]);
    }
  }
  sn[g][tx] = n_a, sm[g][tx] = mu_a, sq[g][tx] = q_a;
  __syncthreads();
  if (g == 0 && c < N) {
    for (int h = 1; h < groups; ++h)
      chan(n_a, mu_a, q_a, sn[h][tx], sm[h][tx], sq[h][tx]);
    mean[c] = mu_a;
    var[c] = fmaxf(q_a / n_a, 0.f);
  }
}

// out[c] = sum over t of part[t][c] [T, C]
__global__ void __launch_bounds__(32 * kSumGroups)
column_total_kernel(const float* __restrict__ part, int T, int C,
                    float* __restrict__ out) {
  __shared__ float red[kSumGroups][32];
  const int tx = threadIdx.x, g = threadIdx.y;
  const int64_t c = (int64_t)blockIdx.x * 32 + tx;
  const int groups = blockDim.y, per = (T + groups - 1) / groups;
  const int t1 = min(T, (g + 1) * per);
  float v = 0.f;
  if (c < C) {
    for (int t0 = g * per; t0 < t1; t0 += kSumBatch) {
      float p[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        p[u] = t0 + u < t1 ? part[(size_t)(t0 + u) * C + c] : 0.f;
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) v += p[u];
    }
  }
  red[g][tx] = v;
  __syncthreads();
  if (g == 0 && c < C) {
    for (int h = 1; h < groups; ++h) v += red[h][tx];
    out[c] = v;
  }
}

// launch column_total_kernel over C columns on stream st
inline cudaError_t column_total(const float* part, int T, int C, float* out,
                                cudaStream_t st) {
  column_total_kernel<<<tiles_of(C, 32), dim3(32, sum_groups(T)), 0, st>>>(
      part, T, C, out);
  return cudaGetLastError();
}

// launch stats_finish_kernel over N columns of `tiles` tiles on stream st
template <class Count>
cudaError_t stats_finish(const float* pmean, const float* pm2, int tiles,
                         int N, Count count, float* mean, float* var,
                         cudaStream_t st) {
  stats_finish_kernel<<<tiles_of(N, 32), dim3(32, sum_groups(tiles)), 0,
                        st>>>(pmean, pm2, tiles, N, count, mean, var);
  return cudaGetLastError();
}

}  // namespace
