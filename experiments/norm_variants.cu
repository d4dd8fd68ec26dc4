// Two variants of the row kernels of paddle_tpu_torch/csrc/fused_norm.cu,
// for timing against them only (python3 experiments/norm_probe.py
// --variants). Both keep the kernels' chunks, sums and rounding, so they
// give the same bits; they differ in how the next rows arrive while a row
// reduces and stores:
//   regs  the next row's x (and dy) are loaded into a second set of
//         registers (one row ahead), rows of one warp or of a block;
//   bulk  rows of a block only: one thread copies whole rows into a
//         two-stage ring of shared memory with cp.async.bulk (the TMA
//         unit's 1-D bulk copy), completing on an mbarrier, and refills a
//         stage once every thread has read it (after the row's first
//         barrier).
// The kernels themselves use a per-thread cp.async ring (three stages
// forward, two for dx).
// bf16, contiguous 16-byte-aligned rows, D a multiple of 8, as wide as
// the kernels hold in registers (bulk: wider than a warp holds); other
// calls return cudaErrorInvalidValue. Built by the probe with
// nvcc ... -I paddle_tpu_torch/csrc.
#include "fused_norm.cu"

namespace {

// ------------------------------------------------------------ regs

template <bool kWide>
__device__ __forceinline__ void load_row(const bf16* row,
                                         const Group<kWide>& g, int d,
                                         Pack<bf16>* p) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (g.chunk(c) * 8 < d) load_chunk<bf16, true>(row, g.chunk(c), d, p[c]);
}

__device__ __forceinline__ void widen(const Pack<bf16>* cur, float (*v)[8]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) v[c][j] = to_f(cur[c].e[j]);
}

template <bool kWide>
__global__ void __launch_bounds__(kWide ? kMaxRowWarps * 32
                                        : kNarrowWarps * 32,
                                  kWide ? 1 : 4)
norm_fwd_regs(const bf16* __restrict__ x, const void* __restrict__ w,
              int wcode, const void* __restrict__ b, int bcode,
              bf16* __restrict__ y, int64_t rows, int d, float eps,
              bool rms) {
  using T = bf16;
  constexpr int V = Pack<T>::V;
  extern __shared__ float4 smem[];
  __shared__ float red[2][2][kMaxRowWarps];
  const Group<kWide> g;
  const int chunks = d / V;
  float4* ws = smem;
  float4* bs = ws + chunks * (V / 4);
  stage_params<T>(w, wcode, b, bcode, d, chunks, ws, bs);
  __syncthreads();
  Pack<T> cur[kChunks];
  int64_t row = g.first;
  if (row < rows) load_row(x + row * d, g, d, cur);
  for (int par = 0; row < rows; row += g.stride, par ^= 1) {
    Pack<T> nxt[kChunks];
    if (row + g.stride < rows)
      load_row(x + (row + g.stride) * d, g, d, nxt);
    float xv[kChunks][V];
    widen(cur, xv);
    float mean, rstd;
    row_stats<T, true>(xv, g, d, eps, rms, red[par], mean, rstd);
    out_fwd<T, true>(xv, g, d, chunks, ws, bs, mean, rstd, y + row * d);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) cur[c] = nxt[c];
  }
}

template <bool kWide>
__global__ void __launch_bounds__(kWide ? kMaxRowWarps * 32
                                        : kNarrowWarps * 32,
                                  kWide ? 1 : 4)
norm_dx_regs(const bf16* __restrict__ x, const void* __restrict__ w,
             int wcode, const bf16* __restrict__ dy, bf16* __restrict__ dx,
             int64_t rows, int d, float eps, bool rms) {
  using T = bf16;
  constexpr int V = Pack<T>::V;
  extern __shared__ float4 smem[];
  __shared__ float red[2][4][kMaxRowWarps];
  const Group<kWide> g;
  const int chunks = d / V;
  stage_params<T>(w, wcode, nullptr, 0, d, chunks, smem, nullptr);
  __syncthreads();
  Pack<T> xc[kChunks], gc[kChunks];
  int64_t row = g.first;
  if (row < rows) {
    load_row(x + row * d, g, d, xc);
    load_row(dy + row * d, g, d, gc);
  }
  for (int par = 0; row < rows; row += g.stride, par ^= 1) {
    Pack<T> xn[kChunks], gn[kChunks];
    if (row + g.stride < rows) {
      load_row(x + (row + g.stride) * d, g, d, xn);
      load_row(dy + (row + g.stride) * d, g, d, gn);
    }
    float xv[kChunks][V], gv[kChunks][V];
    widen(xc, xv);
    widen(gc, gv);
    times_w<T>(gv, g, chunks, smem);
    float mean, rstd;
    row_stats<T, true>(xv, g, d, eps, rms, red[par], mean, rstd);
    dx_out<T, true>(xv, gv, g, d, mean, rstd, rms, red[par], dx + row * d);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      xc[c] = xn[c];
      gc[c] = gn[c];
    }
  }
}

// ------------------------------------------------------------ bulk

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread: bytes from src into dst, completing on bar's current phase
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=: mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The generic proxy's reads of a stage come before the copy that refills it
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// This thread's chunks of a row held in a stage, as fp32
__device__ __forceinline__ void from_stage(const bf16* sr,
                                           const Group<true>& g, int chunks,
                                           float (*v)[8]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (g.chunk(c) < chunks) {
      const Pack<bf16> p = reinterpret_cast<const Pack<bf16>*>(sr)[g.chunk(c)];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[c][j] = to_f(p.e[j]);
    }
}

// Shared memory: w (and b) as fp32 (stage_params), then the two stages
// of `arrays` rows
template <bool kDx>
__global__ void __launch_bounds__(kMaxRowWarps * 32, 1)
norm_bulk(const bf16* __restrict__ x, const void* __restrict__ w, int wcode,
          const void* __restrict__ b, int bcode,
          const bf16* __restrict__ dy, bf16* __restrict__ out, int64_t rows,
          int d, float eps, bool rms) {
  constexpr int V = 8, kArrays = kDx ? 2 : 1;
  extern __shared__ float4 smem[];
  __shared__ float red[2][4][kMaxRowWarps];
  __shared__ uint64_t bar[2];
  const Group<true> g;
  const int chunks = d / V;
  float4* ws = smem;
  float4* bs = ws + chunks * (V / 4);
  bf16* ring = reinterpret_cast<bf16*>(ws + (kDx ? 1 : 2) * chunks * (V / 4));
  const uint32_t bytes = (uint32_t)(d * sizeof(bf16));
  auto issue = [&](int64_t r, int s) {
    bar_expect(&bar[s], kArrays * bytes);
    bulk_copy(ring + kArrays * s * d, x + r * d, bytes, &bar[s]);
    if (kDx) bulk_copy(ring + (2 * s + 1) * d, dy + r * d, bytes, &bar[s]);
  };
  if (threadIdx.x == 0) {
    bar_init(&bar[0]);
    bar_init(&bar[1]);
    if (g.first < rows) issue(g.first, 0);
    if (g.first + g.stride < rows) issue(g.first + g.stride, 1);
  }
  stage_params<bf16>(w, wcode, kDx ? nullptr : b, bcode, d, chunks, ws, bs);
  __syncthreads();
  int it = 0;
  for (int64_t row = g.first; row < rows; row += g.stride, ++it) {
    const int s = it & 1;
    bar_wait(&bar[s], (it >> 1) & 1);
    float xv[kChunks][V], gv[kChunks][V];
    from_stage(ring + kArrays * s * d, g, chunks, xv);
    if (kDx) {
      from_stage(ring + (2 * s + 1) * d, g, chunks, gv);
      times_w<bf16>(gv, g, chunks, ws);
    }
    float mean, rstd;   // its first barrier: every thread has read stage s
    row_stats<bf16, true>(xv, g, d, eps, rms, red[s], mean, rstd);
    if (threadIdx.x == 0 && row + 2 * g.stride < rows) {
      fence_async();
      issue(row + 2 * g.stride, s);
    }
    if (kDx)
      dx_out<bf16, true>(xv, gv, g, d, mean, rstd, rms, red[s], out + row * d);
    else
      out_fwd<bf16, true>(xv, g, d, chunks, ws, bs, mean, rstd, out + row * d);
  }
}

bool variant_ok(int d, const void* a, long long lda, const void* b,
                long long ldb, int dtype) {
  return dtype == 1 && lda == d && ldb == d &&
         vector_rows<bf16>(d, a, lda, b, ldb) && row_warps<bf16>(d) <= kMaxRowWarps;
}

}  // namespace

// variant 0: regs, 1: bulk. The arguments of paddle_norm_fwd / _dx.
extern "C" int paddle_norm_variant_fwd(int variant, const void* x,
                                       const void* w, const void* b, void* y,
                                       long long rows, int d, long long ldx,
                                       float eps, int rms, int dtype,
                                       int wdtype, int bdtype, void* stream) {
  const int warps = (int)row_warps<bf16>(d);
  if (!shapes_ok(rows, d, ldx) || !variant_ok(d, x, ldx, y, d, dtype) ||
      (variant == 1 && warps == 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xt = static_cast<const bf16*>(x);
  bf16* yt = static_cast<bf16*>(y);
  const size_t params = 2 * (size_t)d * sizeof(float);
  if (variant == 1) {
    auto k = norm_bulk<false>;
    const size_t smem = params + 2 * (size_t)d * sizeof(bf16);
    k<<<resident_grid(k, warps * 32, smem, rows), warps * 32, smem, st>>>(
        xt, w, wdtype, b, bdtype, nullptr, yt, rows, d, eps, rms);
  } else if (warps == 1) {
    auto k = norm_fwd_regs<false>;
    const unsigned grid = resident_grid(k, kNarrowWarps * 32, params,
                                        (rows + kNarrowWarps - 1) / kNarrowWarps);
    k<<<grid, kNarrowWarps * 32, params, st>>>(xt, w, wdtype, b, bdtype, yt,
                                               rows, d, eps, rms);
  } else {
    auto k = norm_fwd_regs<true>;
    k<<<resident_grid(k, warps * 32, params, rows), warps * 32, params, st>>>(
        xt, w, wdtype, b, bdtype, yt, rows, d, eps, rms);
  }
  return cudaGetLastError();
}

extern "C" int paddle_norm_variant_dx(int variant, const void* x,
                                      const void* w, const void* dy, void* dx,
                                      long long rows, int d, long long ldx,
                                      long long lddy, float eps, int rms,
                                      int dtype, int wdtype, void* stream) {
  const int warps = (int)row_warps<bf16>(d);
  if (!shapes_ok(rows, d, ldx) || !variant_ok(d, x, ldx, dy, lddy, dtype) ||
      !aligned16(dx) || (variant == 1 && warps == 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* dyt = static_cast<const bf16*>(dy);
  bf16* dxt = static_cast<bf16*>(dx);
  const size_t params = (size_t)d * sizeof(float);
  if (variant == 1) {
    auto k = norm_bulk<true>;
    const size_t smem = params + 4 * (size_t)d * sizeof(bf16);
    k<<<resident_grid(k, warps * 32, smem, rows), warps * 32, smem, st>>>(
        xt, w, wdtype, nullptr, 0, dyt, dxt, rows, d, eps, rms);
  } else if (warps == 1) {
    auto k = norm_dx_regs<false>;
    const unsigned grid = resident_grid(k, kNarrowWarps * 32, params,
                                        (rows + kNarrowWarps - 1) / kNarrowWarps);
    k<<<grid, kNarrowWarps * 32, params, st>>>(xt, w, wdtype, dyt, dxt, rows,
                                               d, eps, rms);
  } else {
    auto k = norm_dx_regs<true>;
    k<<<resident_grid(k, warps * 32, params, rows), warps * 32, params, st>>>(
        xt, w, wdtype, dyt, dxt, rows, d, eps, rms);
  }
  return cudaGetLastError();
}
