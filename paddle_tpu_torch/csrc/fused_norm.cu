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
// device memory once, and the design keeps those reads in flight:
//   - One launch a call. w and b are read in their own dtype (fp32, bf16
//     or fp16) and widened to fp32 in the kernel, which is exact.
//   - Persistent blocks, as many as stay resident, walk over the rows.
//     The threads cover the same columns in every row, so a block reads
//     w and b once, into shared memory as fp32, for every row it handles.
//   - A row lives in registers, four 16-byte chunks a thread: one warp a
//     row up to 1024 bf16 / 512 fp32 elements (4 rows a block at a
//     time), a block of up to 8 warps a row up to 8192 / 4096. Both
//     passes of the statistics and the output run from the registers; a
//     block's sum crosses its warps once, through shared memory, at one
//     barrier (dx's c1 and c2 as one pair).
//   - The next rows arrive while a row reduces and stores: each thread
//     copies its own chunks of its next rows (three of x forward, two
//     of x and dy for dx) with cp.async into a ring in shared memory and
//     takes a row out of the ring into registers when it starts it,
//     refilling that stage with the row as far ahead. A thread reads
//     back only what it copied, so the ring needs no barrier, and it
//     holds no registers. Rows that are not 16-byte aligned are loaded
//     when they start.
//   - Wider rows are re-read from device memory for each pass, one block
//     a row.
// Chunk k of a row is always its elements [k*V, k*V + V), V = 16 bytes of
// x's type, and thread t of a group of n threads holds chunks t, t+n, ...
// A row whose start or stride is not 16-byte aligned, or whose D is not a
// multiple of V, loads the same chunks one element at a time. So the sum
// order, and with it every bit of a row's result, depends on D and the
// dtypes only: not on the alignment, the number of rows, the grid or the
// SM count. 64-bit offsets.
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

#include "mma_common.cuh"   // cp_async16, cp_async_commit, cp_async_wait

namespace {

using bf16 = __nv_bfloat16;
using half = __half;

constexpr int kChunks = 4;           // 16-byte chunks of a row a thread holds
constexpr int kFwdStages = 3;        // rows a thread has in flight (its ring):
constexpr int kDxStages = 2;         //   measured best on the H100 for each
constexpr int kNarrowWarps = 4;      // warps of a one-warp-a-row block
constexpr int kMaxRowWarps = 8;      // widest block that holds a row
constexpr int kRereadThreads = 256;  // threads of a block that re-reads a row
constexpr int kRereadWarps = kRereadThreads / 32;

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

// One 16-byte chunk of a row, as stored
template <typename T> struct alignas(16) Pack {
  static constexpr int V = 16 / (int)sizeof(T);
  T e[V];
};

// Element j of chunk k lies in a row of d (kVec: d is a multiple of V)
template <typename T, bool kVec>
__device__ __forceinline__ bool in_row(int k, int j, int d) {
  constexpr int V = Pack<T>::V;
  return kVec ? k * V < d : k * V + j < d;
}

// Chunk k of a row: one 16-byte load (kVec: the row start is 16-byte
// aligned and d a multiple of V) or one load an element, zero past d.
template <typename T, bool kVec>
__device__ __forceinline__ void load_chunk(const T* row, int k, int d,
                                           Pack<T>& p) {
  constexpr int V = Pack<T>::V;
  if (kVec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + k * V));
    p = *reinterpret_cast<const Pack<T>*>(&u);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      p.e[j] = k * V + j < d ? row[k * V + j] : from_f<T>(0.f);
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_chunk(T* row, int k, int d,
                                            const float* v) {
  constexpr int V = Pack<T>::V;
  if (kVec) {
    Pack<T> p;
#pragma unroll
    for (int j = 0; j < V; ++j) p.e[j] = from_f<T>(v[j]);
    *reinterpret_cast<Pack<T>*>(row + k * V) = p;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (k * V + j < d) row[k * V + j] = from_f<T>(v[j]);
  }
}

// Element i of a weight or bias of dtype 0 (fp32), 1 (bf16) or 2 (fp16),
// widened to fp32 (exact)
__device__ __forceinline__ float param(const void* p, int code, int i) {
  if (code == 1) return __bfloat162float(static_cast<const bf16*>(p)[i]);
  if (code == 2) return __half2float(static_cast<const half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// Butterfly sum: every lane ends with the same bits (a + b == b + a).
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
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

// ------------------------------------------------- a row in registers

// The threads that hold a row: one warp (kWide false; a block runs
// kNarrowWarps rows at a time) or the whole block. Each group walks rows
// first, first + stride, ...
template <bool kWide> struct Group {
  int t, n;               // rank in the group, threads of the group
  int64_t first, stride;
  __device__ __forceinline__ Group() {
    const int warps = blockDim.x >> 5;
    t = kWide ? threadIdx.x : threadIdx.x & 31;
    n = kWide ? blockDim.x : 32;
    first = kWide ? blockIdx.x
                  : (int64_t)blockIdx.x * warps + (threadIdx.x >> 5);
    stride = kWide ? gridDim.x : (int64_t)gridDim.x * warps;
  }
  __device__ __forceinline__ int chunk(int c) const { return c * n + t; }
};

// Sum over a group: the warp's butterfly, then (kWide) the warps'
// partials through red (a float a warp) in warp order, at one barrier.
// Every thread gets the same bits. A row uses a slot of red for each
// sum, and rows alternate between two sets of slots: a slot is written
// again only after every thread has passed a later barrier.
template <bool kWide>
__device__ __forceinline__ float group_sum(float s, float* red) {
  s = warp_sum(s);
  if (!kWide) return s;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += red[i];
  return total;
}

// Two sums at one barrier
template <bool kWide>
__device__ __forceinline__ void group_sum2(float& a, float& b, float* ra,
                                           float* rb) {
  a = warp_sum(a);
  b = warp_sum(b);
  if (!kWide) return;
  if ((threadIdx.x & 31) == 0) {
    ra[threadIdx.x >> 5] = a;
    rb[threadIdx.x >> 5] = b;
  }
  __syncthreads();
  a = b = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
    a += ra[i];
    b += rb[i];
  }
}

// V parameters of chunk k from p of element type P, widened (exact), zero
// past d
template <typename T, typename P>
__device__ __forceinline__ void param_chunk(const P* p, int k, int d,
                                            float* v) {
#pragma unroll
  for (int j = 0; j < Pack<T>::V; ++j)
    v[j] = k * Pack<T>::V + j < d ? to_f(p[k * Pack<T>::V + j]) : 0.f;
}

// ... of a weight or bias of dtype 0 (fp32), 1 (bf16) or 2 (fp16)
template <typename T>
__device__ __forceinline__ void param_chunk(const void* p, int code, int k,
                                            int d, float* v) {
  if (code == 1)
    param_chunk<T>(static_cast<const bf16*>(p), k, d, v);
  else if (code == 2)
    param_chunk<T>(static_cast<const half*>(p), k, d, v);
  else
    param_chunk<T>(static_cast<const float*>(p), k, d, v);
}

// w (and b, unless null) widened to fp32 in shared memory, once a block.
// Chunk k's V values are V/4 float4 words; word h of every chunk lies in
// its own run of `chunks` words, so a warp reading a chunk a lane reads
// consecutive words (no bank conflict). Every load of a thread's chunks
// is issued before the first store. The caller syncs before use.
template <typename T>
__device__ __forceinline__ void stage_params(const void* w, int wcode,
                                             const void* b, int bcode, int d,
                                             int chunks, float4* ws,
                                             float4* bs) {
  constexpr int V = Pack<T>::V, kBatch = 4;
  for (int k0 = threadIdx.x; k0 < chunks; k0 += kBatch * blockDim.x) {
    float wv[kBatch][V], bv[kBatch][V];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u * blockDim.x;
      param_chunk<T>(w, wcode, k, k < chunks ? d : 0, wv[u]);
      if (b) param_chunk<T>(b, bcode, k, k < chunks ? d : 0, bv[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k >= chunks) break;
#pragma unroll
      for (int h = 0; h < V / 4; ++h) {
        ws[h * chunks + k] = make_float4(wv[u][4 * h], wv[u][4 * h + 1],
                                         wv[u][4 * h + 2], wv[u][4 * h + 3]);
        if (b)
          bs[h * chunks + k] = make_float4(bv[u][4 * h], bv[u][4 * h + 1],
                                           bv[u][4 * h + 2], bv[u][4 * h + 3]);
      }
    }
  }
}

// The V staged values of chunk k
template <typename T>
__device__ __forceinline__ void staged(const float4* s, int k, int chunks,
                                       float* v) {
#pragma unroll
  for (int h = 0; h < Pack<T>::V / 4; ++h) {
    const float4 q = s[h * chunks + k];
    v[4 * h] = q.x;
    v[4 * h + 1] = q.y;
    v[4 * h + 2] = q.z;
    v[4 * h + 3] = q.w;
  }
}

// A thread's ring in shared memory: stages of `arrays` rows (x,
// and dy for dx) of cpl 16-byte chunks, chunk-major over the block's
// threads, so consecutive threads touch consecutive words (no bank
// conflict). A thread copies (cp.async) only the words it reads back
// itself, so the ring needs cp.async's own waits and no barrier.
struct Ring {
  uint4* base;
  int arrays, cpl;
  __device__ __forceinline__ uint4* at(int stage, int a, int c) const {
    return base + ((stage * arrays + a) * cpl + c) * (int)blockDim.x +
           threadIdx.x;
  }
};

// Start copying the thread's chunks of a row into (stage, a)
template <typename T, bool kWide>
__device__ __forceinline__ void fetch(const T* row, const Group<kWide>& g,
                                      int d, const Ring& r, int stage,
                                      int a) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (c < r.cpl && g.chunk(c) * Pack<T>::V < d)
      cp_async16(r.at(stage, a, c), row + g.chunk(c) * Pack<T>::V, true);
}

// The thread's chunks of (stage, a) as fp32 (kVec), or of the row itself,
// loaded now (one element at a time)
template <typename T, bool kVec, bool kWide>
__device__ __forceinline__ void take(const T* row, const Group<kWide>& g,
                                     int d, const Ring& r, int stage, int a,
                                     float (*v)[Pack<T>::V]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c >= r.cpl) break;
    Pack<T> p;
    if (kVec)
      p = *reinterpret_cast<const Pack<T>*>(r.at(stage, a, c));
    else if (g.chunk(c) * Pack<T>::V < d)
      load_chunk<T, false>(row, g.chunk(c), d, p);
#pragma unroll
    for (int j = 0; j < Pack<T>::V; ++j) v[c][j] = to_f(p.e[j]);
  }
}

// (mean, rstd) of the row in x (RMSNorm: mean 0), sums in slots 0 and 1
template <typename T, bool kVec, bool kWide>
__device__ __forceinline__ void row_stats(const float (*x)[Pack<T>::V],
                                          const Group<kWide>& g, int d,
                                          float eps, bool rms,
                                          float (*red)[kMaxRowWarps],
                                          float& mean, float& rstd) {
  constexpr int V = Pack<T>::V;
  mean = 0.f;
  if (!rms) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (in_row<T, kVec>(g.chunk(c), j, d)) s += x[c][j];
    mean = group_sum<kWide>(s, red[0]) / d;
  }
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (in_row<T, kVec>(g.chunk(c), j, d)) {
        const float t = x[c][j] - mean;
        q += t * t;
      }
  rstd = rsqrtf(group_sum<kWide>(q, red[1]) / d + eps);
}

// y = xhat*w + b of the row in x (fp32), stored
template <typename T, bool kVec, bool kWide>
__device__ __forceinline__ void out_fwd(const float (*x)[Pack<T>::V],
                                        const Group<kWide>& g, int d,
                                        int chunks, const float4* ws,
                                        const float4* bs, float mean,
                                        float rstd, T* yr) {
  constexpr int V = Pack<T>::V;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int k = g.chunk(c);
    if (!in_row<T, kVec>(k, 0, d)) continue;
    float wk[V], bk[V], o[V];
    staged<T>(ws, k, chunks, wk);
    staged<T>(bs, k, chunks, bk);
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = affine(xhat_of(x[c][j], mean, rstd), wk[j], bk[j]);
    store_chunk<T, kVec>(yr, k, d, o);
  }
}

// g = dy*w, in place of the row's dy (fp32)
template <typename T, bool kWide>
__device__ __forceinline__ void times_w(float (*gv)[Pack<T>::V],
                                        const Group<kWide>& g, int chunks,
                                        const float4* ws) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float wk[Pack<T>::V];
    staged<T>(ws, min(g.chunk(c), chunks - 1), chunks, wk);
#pragma unroll
    for (int j = 0; j < Pack<T>::V; ++j) gv[c][j] = __fmul_rn(gv[c][j], wk[j]);
  }
}

// dx of the row from x and g (fp32) and its statistics: c1 and c2 as one
// pair (slots 2 and 3), then the output, stored
template <typename T, bool kVec, bool kWide>
__device__ __forceinline__ void dx_out(const float (*x)[Pack<T>::V],
                                       const float (*gv)[Pack<T>::V],
                                       const Group<kWide>& g, int d,
                                       float mean, float rstd, bool rms,
                                       float (*red)[kMaxRowWarps], T* dxr) {
  constexpr int V = Pack<T>::V;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (in_row<T, kVec>(g.chunk(c), j, d)) {
        s1 += gv[c][j];
        s2 += gv[c][j] * xhat_of(x[c][j], mean, rstd);
      }
  group_sum2<kWide>(s1, s2, red[2], red[3]);
  const float c1 = rms ? 0.f : s1 / d;
  const float c2 = s2 / d;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (!in_row<T, kVec>(g.chunk(c), 0, d)) continue;
    float o[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = dx_of(gv[c][j], xhat_of(x[c][j], mean, rstd), c1, c2, rstd, rms);
    store_chunk<T, kVec>(dxr, g.chunk(c), d, o);
  }
}

// Shared memory: w, b (stage_params), then the ring of x (kVec only)
template <typename T, bool kVec, bool kWide>
__global__ void __launch_bounds__(kWide ? kMaxRowWarps * 32
                                        : kNarrowWarps * 32)
norm_fwd_rows(const T* __restrict__ x, const void* __restrict__ w, int wcode,
              const void* __restrict__ b, int bcode, T* __restrict__ y,
              int64_t rows, int d, int64_t ldx, float eps, bool rms) {
  constexpr int V = Pack<T>::V;
  extern __shared__ float4 smem[];
  __shared__ float red[2][2][kMaxRowWarps];  // [row parity][sum][warp]
  const Group<kWide> g;
  const int chunks = (d + V - 1) / V;
  float4* ws = smem;
  float4* bs = ws + chunks * (V / 4);
  const Ring ring{reinterpret_cast<uint4*>(bs + chunks * (V / 4)), 1,
                  (chunks + g.n - 1) / g.n};
  // the first rows in flight before w and b are staged
  for (int s = 0; kVec && s < kFwdStages; ++s) {
    if (g.first + s * g.stride < rows)
      fetch(x + (g.first + s * g.stride) * ldx, g, d, ring, s, 0);
    cp_async_commit();
  }
  stage_params<T>(w, wcode, b, bcode, d, chunks, ws, bs);
  __syncthreads();
  int stage = 0, par = 0;
  for (int64_t row = g.first; row < rows; row += g.stride, par ^= 1) {
    const T* xr = x + row * ldx;
    float xv[kChunks][V];
    if (kVec) cp_async_wait<kFwdStages - 1>();
    take<T, kVec>(xr, g, d, ring, stage, 0, xv);
    if (kVec) {   // the row kFwdStages ahead, into the stage just read
      const int64_t ahead = row + kFwdStages * g.stride;
      if (ahead < rows) fetch(x + ahead * ldx, g, d, ring, stage, 0);
      cp_async_commit();
      stage = stage == kFwdStages - 1 ? 0 : stage + 1;
    }
    float mean, rstd;
    row_stats<T, kVec>(xv, g, d, eps, rms, red[par], mean, rstd);
    out_fwd<T, kVec>(xv, g, d, chunks, ws, bs, mean, rstd, y + row * d);
  }
}

// Shared memory: w (stage_params), then the ring of x and dy (kVec only)
template <typename T, bool kVec, bool kWide>
__global__ void __launch_bounds__(kWide ? kMaxRowWarps * 32
                                        : kNarrowWarps * 32)
norm_dx_rows(const T* __restrict__ x, const void* __restrict__ w, int wcode,
             const T* __restrict__ dy, T* __restrict__ dx, int64_t rows,
             int d, int64_t ldx, int64_t lddy, float eps, bool rms) {
  constexpr int V = Pack<T>::V;
  extern __shared__ float4 smem[];
  __shared__ float red[2][4][kMaxRowWarps];  // [row parity][sum][warp]
  const Group<kWide> g;
  const int chunks = (d + V - 1) / V;
  const Ring ring{reinterpret_cast<uint4*>(smem + chunks * (V / 4)), 2,
                  (chunks + g.n - 1) / g.n};
  auto fetch_row = [&](int64_t r, int s) {
    fetch(x + r * ldx, g, d, ring, s, 0);
    fetch(dy + r * lddy, g, d, ring, s, 1);
  };
  for (int s = 0; kVec && s < kDxStages; ++s) {
    if (g.first + s * g.stride < rows) fetch_row(g.first + s * g.stride, s);
    cp_async_commit();
  }
  stage_params<T>(w, wcode, nullptr, 0, d, chunks, smem, nullptr);
  __syncthreads();
  int stage = 0, par = 0;
  for (int64_t row = g.first; row < rows; row += g.stride, par ^= 1) {
    float xv[kChunks][V], gv[kChunks][V];   // x, and g = dy*w
    if (kVec) cp_async_wait<kDxStages - 1>();
    take<T, kVec>(x + row * ldx, g, d, ring, stage, 0, xv);
    take<T, kVec>(dy + row * lddy, g, d, ring, stage, 1, gv);
    if (kVec) {
      const int64_t ahead = row + kDxStages * g.stride;
      if (ahead < rows) fetch_row(ahead, stage);
      cp_async_commit();
      stage = stage == kDxStages - 1 ? 0 : stage + 1;
    }
    times_w<T>(gv, g, chunks, smem);
    float mean, rstd;
    row_stats<T, kVec>(xv, g, d, eps, rms, red[par], mean, rstd);
    dx_out<T, kVec>(xv, gv, g, d, mean, rstd, rms, red[par], dx + row * d);
  }
}

// ------------------------------------------------- a row re-read

// Sum over the block, the warps' partials added in a fixed order; every
// thread gets the same value. red: kRereadWarps floats of shared memory.
__device__ __forceinline__ float block_sum(float s, float* red) {
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kRereadWarps; ++i) t += red[i];
  __syncthreads();  // red is written again by the next sum
  return t;
}

// (mean, rstd) of a row read twice from device memory
template <typename T, bool kVec>
__device__ __forceinline__ void reread_stats(const T* xr, int d, float eps,
                                             bool rms, float* red,
                                             float& mean, float& rstd) {
  constexpr int V = Pack<T>::V;
  const int n = (d + V - 1) / V;
  mean = 0.f;
  if (!rms) {
    float s = 0.f;
    for (int k = threadIdx.x; k < n; k += kRereadThreads) {
      Pack<T> p;
      load_chunk<T, kVec>(xr, k, d, p);
#pragma unroll
      for (int j = 0; j < V; ++j) s += to_f(p.e[j]);  // zeros past d
    }
    mean = block_sum(s, red) / d;
  }
  float q = 0.f;
  for (int k = threadIdx.x; k < n; k += kRereadThreads) {
    Pack<T> p;
    load_chunk<T, kVec>(xr, k, d, p);
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (k * V + j < d) {
        const float t = to_f(p.e[j]) - mean;
        q += t * t;
      }
  }
  rstd = rsqrtf(block_sum(q, red) / d + eps);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kRereadThreads)
norm_fwd_reread(const T* __restrict__ x, const void* __restrict__ w,
                int wcode, const void* __restrict__ b, int bcode,
                T* __restrict__ y, int d, int64_t ldx, float eps, bool rms) {
  constexpr int V = Pack<T>::V;
  __shared__ float red[kRereadWarps];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * ldx;
  float mean, rstd;
  reread_stats<T, kVec>(xr, d, eps, rms, red, mean, rstd);
  T* yr = y + row * d;
  for (int k = threadIdx.x; k * V < d; k += kRereadThreads) {
    Pack<T> p;
    load_chunk<T, kVec>(xr, k, d, p);
    float o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int col = k * V + j;
      o[j] = col < d ? affine(xhat_of(to_f(p.e[j]), mean, rstd),
                              param(w, wcode, col), param(b, bcode, col))
                     : 0.f;
    }
    store_chunk<T, kVec>(yr, k, d, o);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kRereadThreads)
norm_dx_reread(const T* __restrict__ x, const void* __restrict__ w,
               int wcode, const T* __restrict__ dy, T* __restrict__ dx,
               int d, int64_t ldx, int64_t lddy, float eps, bool rms) {
  constexpr int V = Pack<T>::V;
  __shared__ float red[kRereadWarps];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * ldx;
  const T* dyr = dy + row * lddy;
  float mean, rstd;
  reread_stats<T, kVec>(xr, d, eps, rms, red, mean, rstd);
  // g and xhat of chunk k, read again from device memory
  auto chunk = [&](int k, float* gk, float* xh) {
    Pack<T> px, pg;
    load_chunk<T, kVec>(xr, k, d, px);
    load_chunk<T, kVec>(dyr, k, d, pg);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int col = k * V + j;
      gk[j] = col < d ? __fmul_rn(to_f(pg.e[j]), param(w, wcode, col)) : 0.f;
      xh[j] = col < d ? xhat_of(to_f(px.e[j]), mean, rstd) : 0.f;
    }
  };
  float s1 = 0.f, s2 = 0.f;
  for (int k = threadIdx.x; k * V < d; k += kRereadThreads) {
    float gk[V], xh[V];
    chunk(k, gk, xh);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1 += gk[j];
      s2 += gk[j] * xh[j];
    }
  }
  const float c1 = rms ? 0.f : block_sum(s1, red) / d;
  const float c2 = block_sum(s2, red) / d;
  T* dxr = dx + row * d;
  for (int k = threadIdx.x; k * V < d; k += kRereadThreads) {
    float gk[V], xh[V], o[V];
    chunk(k, gk, xh);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = dx_of(gk[j], xh[j], c1, c2, rstd, rms);
    store_chunk<T, kVec>(dxr, k, d, o);
  }
}

// ------------------------------------------------------------ launch

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// 16-byte accesses when every row start is aligned and D a multiple of
// the vector width
template <typename T>
bool vector_rows(int d, const void* a, int64_t lda, const void* b,
                 int64_t ldb) {
  constexpr int V = Pack<T>::V;
  return d % V == 0 && aligned16(a) && aligned16(b) &&
         (lda * (int64_t)sizeof(T)) % 16 == 0 &&
         (ldb * (int64_t)sizeof(T)) % 16 == 0;
}

// Warps of the group that holds a row of d in registers (kChunks chunks a
// thread); more than kMaxRowWarps: the row is re-read instead
template <typename T> int64_t row_warps(int d) {
  constexpr int V = Pack<T>::V;
  const int64_t chunks = (d + V - 1) / V;
  return (chunks + 32 * kChunks - 1) / (32 * kChunks);
}

// Blocks of a persistent launch: as many as stay resident on the card at
// once, at most one a group of rows. Lets the kernel have `smem` bytes of
// dynamic shared memory first (near 48 KB with its static shared memory,
// it has to ask).
template <typename K>
unsigned resident_grid(K kernel, int threads, size_t smem, int64_t groups) {
  int dev = 0, sms = 0, per_sm = 0;
  if (smem + 1024 > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const int64_t most = (int64_t)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return (unsigned)(groups < most ? groups : most);
}

// Dynamic shared memory of a row kernel: `params` fp32 copies of w or b
// (stage_params), and (kVec) the ring of `stages` x `arrays` rows for
// `threads`
template <typename T, bool kVec>
size_t rows_smem(int d, int threads, int group, int params, int stages,
                 int arrays) {
  constexpr int V = Pack<T>::V;
  const int64_t chunks = (d + V - 1) / V;
  const int64_t cpl = (chunks + group - 1) / group;
  return (size_t)(chunks * V * sizeof(float) * params +
                  (kVec ? stages * arrays * cpl * 16 * threads : 0));
}

template <typename T, bool kVec>
void fwd_launch(const T* x, const void* w, int wcode, const void* b,
                int bcode, T* y, int64_t rows, int d, int64_t ldx, float eps,
                bool rms, cudaStream_t st) {
  const int64_t warps = row_warps<T>(d);
  if (warps == 1) {
    auto kernel = norm_fwd_rows<T, kVec, false>;
    const int threads = kNarrowWarps * 32;
    const size_t smem = rows_smem<T, kVec>(
        d, threads, 32, 2, kFwdStages, 1);
    const unsigned grid = resident_grid(
        kernel, threads, smem, (rows + kNarrowWarps - 1) / kNarrowWarps);
    kernel<<<grid, threads, smem, st>>>(x, w, wcode, b, bcode, y, rows, d,
                                        ldx, eps, rms);
  } else if (warps <= kMaxRowWarps) {
    auto kernel = norm_fwd_rows<T, kVec, true>;
    const int threads = (int)warps * 32;
    const size_t smem = rows_smem<T, kVec>(
        d, threads, threads, 2, kFwdStages, 1);
    kernel<<<resident_grid(kernel, threads, smem, rows), threads, smem, st>>>(
        x, w, wcode, b, bcode, y, rows, d, ldx, eps, rms);
  } else {
    norm_fwd_reread<T, kVec><<<(unsigned)rows, kRereadThreads, 0, st>>>(
        x, w, wcode, b, bcode, y, d, ldx, eps, rms);
  }
}

template <typename T, bool kVec>
void dx_launch(const T* x, const void* w, int wcode, const T* dy, T* dx,
               int64_t rows, int d, int64_t ldx, int64_t lddy, float eps,
               bool rms, cudaStream_t st) {
  const int64_t warps = row_warps<T>(d);
  if (warps == 1) {
    auto kernel = norm_dx_rows<T, kVec, false>;
    const int threads = kNarrowWarps * 32;
    const size_t smem = rows_smem<T, kVec>(
        d, threads, 32, 1, kDxStages, 2);
    const unsigned grid = resident_grid(
        kernel, threads, smem, (rows + kNarrowWarps - 1) / kNarrowWarps);
    kernel<<<grid, threads, smem, st>>>(x, w, wcode, dy, dx, rows, d, ldx,
                                        lddy, eps, rms);
  } else if (warps <= kMaxRowWarps) {
    auto kernel = norm_dx_rows<T, kVec, true>;
    const int threads = (int)warps * 32;
    const size_t smem = rows_smem<T, kVec>(
        d, threads, threads, 1, kDxStages, 2);
    kernel<<<resident_grid(kernel, threads, smem, rows), threads, smem, st>>>(
        x, w, wcode, dy, dx, rows, d, ldx, lddy, eps, rms);
  } else {
    norm_dx_reread<T, kVec><<<(unsigned)rows, kRereadThreads, 0, st>>>(
        x, w, wcode, dy, dx, d, ldx, lddy, eps, rms);
  }
}

template <typename T>
int forward(const void* x, const void* w, int wcode, const void* b,
            int bcode, void* y, int64_t rows, int d, int64_t ldx, float eps,
            bool rms, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vector_rows<T>(d, x, ldx, y, d))
    fwd_launch<T, true>(xt, w, wcode, b, bcode, yt, rows, d, ldx, eps, rms,
                        st);
  else
    fwd_launch<T, false>(xt, w, wcode, b, bcode, yt, rows, d, ldx, eps, rms,
                         st);
  return cudaGetLastError();
}

template <typename T>
int backward(const void* x, const void* w, int wcode, const void* dy,
             void* dx, int64_t rows, int d, int64_t ldx, int64_t lddy,
             float eps, bool rms, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (vector_rows<T>(d, x, ldx, dy, lddy) && aligned16(dx))
    dx_launch<T, true>(xt, w, wcode, dyt, dxt, rows, d, ldx, lddy, eps, rms,
                       st);
  else
    dx_launch<T, false>(xt, w, wcode, dyt, dxt, rows, d, ldx, lddy, eps, rms,
                        st);
  return cudaGetLastError();
}

bool shapes_ok(long long rows, int d, long long ldx) {
  // the re-reading kernels put rows on grid.x (at most 2^31 - 1)
  return rows > 0 && rows <= 0x7fffffffLL && d > 0 && ldx >= d;
}

bool dtype_ok(int code) { return code >= 0 && code <= 2; }

}  // namespace

// Forward. x [rows, d] with row stride ldx (elements; the last dim
// contiguous), y [rows, d] contiguous, both of dtype 0 (float32),
// 1 (bfloat16) or 2 (float16); w [d] of dtype wdtype and b [d] of dtype
// bdtype, each contiguous, in any of the three. rms 1: RMSNorm (b is still
// added: the callers pass zeros). One launch. Returns its cudaError_t.
extern "C" int paddle_norm_fwd(const void* x, const void* w, const void* b,
                               void* y, long long rows, int d, long long ldx,
                               float eps, int rms, int dtype, int wdtype,
                               int bdtype, void* stream) {
  if (!shapes_ok(rows, d, ldx) || !dtype_ok(wdtype) || !dtype_ok(bdtype))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float>(x, w, wdtype, b, bdtype, y, rows, d, ldx, eps, rms,
                          st);
  if (dtype == 1)
    return forward<bf16>(x, w, wdtype, b, bdtype, y, rows, d, ldx, eps, rms,
                         st);
  if (dtype == 2)
    return forward<half>(x, w, wdtype, b, bdtype, y, rows, d, ldx, eps, rms,
                         st);
  return cudaErrorInvalidValue;
}

// Input gradient. x [rows, d] (row stride ldx), dy [rows, d] (row stride
// lddy), dx [rows, d] contiguous, all of one dtype as above; w [d]
// contiguous, of dtype wdtype. One launch. Returns its cudaError_t.
extern "C" int paddle_norm_dx(const void* x, const void* w, const void* dy,
                              void* dx, long long rows, int d, long long ldx,
                              long long lddy, float eps, int rms, int dtype,
                              int wdtype, void* stream) {
  if (!shapes_ok(rows, d, ldx) || lddy < d || !dtype_ok(wdtype))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(x, w, wdtype, dy, dx, rows, d, ldx, lddy, eps, rms,
                           st);
  if (dtype == 1)
    return backward<bf16>(x, w, wdtype, dy, dx, rows, d, ldx, lddy, eps, rms,
                          st);
  if (dtype == 2)
    return backward<half>(x, w, wdtype, dy, dx, rows, d, ldx, lddy, eps, rms,
                          st);
  return cudaErrorInvalidValue;
}
