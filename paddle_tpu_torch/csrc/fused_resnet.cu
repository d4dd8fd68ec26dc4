// Fused ResNet training kernels, hand-written for Hopper (sm_90a): a 1x1
// convolution computed as a matrix product whose epilogue also gives the
// batch-norm statistics of its output, optionally with a BN-apply + ReLU
// prologue on its input, and the two backwards.
//
// Replaces the TPU kernels of paddle_tpu/kernels/fused_resnet.py:
//   paddle_mm_bn_stats, prologue 0   _mm_stats_pallas :267
//                                    (_mm_stats_kernel :53)
//   paddle_mm_bn_stats, prologue 1   _bn_relu_mm_stats_pallas :297
//                                    (_bn_relu_mm_stats_kernel :74)
//   paddle_mm_bn_stats_bwd, prol. 0  _mm_stats_bwd_pallas :192
//                                    (_mm_stats_bwd_kernel :136)
//   paddle_mm_bn_stats_bwd, prol. 1  _bn_relu_mm_stats_bwd_pallas :225
//                                    (_bn_relu_mm_stats_bwd_kernel :162)
//
// What they compute, for x [M,K], w [K,N] and y [M,N] (M = N*H*W rows of
// an NHWC activation, channels contiguous):
//   forward   a = x, or bf16(relu(x*scale + shift)) with scale, shift fp32
//             [K]; y = bf16(a @ w) (fp32 sums); mean, var fp32 [N] of the
//             bf16-ROUNDED y, which is what the unfused path would compute
//             from the stored conv output.
//   backward  e = bf16(dy + perch + dvar2*(y - mean)) (the cotangents of the
//             mean and var outputs folded in; the dvar2 term multiplies the
//             CENTERED y, so it never cancels when |mean| >> std);
//             prologue 0: dx = bf16(e @ w^T), dw = fp32(x^T @ e);
//             prologue 1: da = e @ w^T (fp32), gated = da where pre > 0,
//             dx = bf16(gated*scale), dscale = sum_m gated*x,
//             dshift = sum_m gated, dw = a^T @ e with a recomputed from x.
// The activation a and the effective gradient e never reach device
// memory: each is recomputed from x (or dy, y) while a tile is loaded.
// That is the byte cut the TPU kernels exist for.
//
// Design for a card whose blocks run in parallel and in no order. The TPU
// grid runs in order and anchors a shifted one-pass variance on block 0's
// means; here no block can wait for another. So each 128-row tile writes
// its own (mean, M2) per channel, taken two-pass over the tile's rounded
// outputs in registers, and a second small launch combines the tiles in a
// fixed order with Chan's formula. dw sums over up to 401,408 rows: the
// rows are cut into chunks, each block writes an fp32 partial for its
// chunk, and a fixed-order column sum adds them. dscale and dshift take
// the same route over the row tiles. There is no atomic anywhere, so the
// kernels give the same bits run to run.
//
// Elementwise steps that end in a rounding to the storage type (the
// prologue, e, the gated dx) use __fmul_rn/__fadd_rn, so nvcc cannot fuse
// them into an fma and they round where the plain PyTorch version rounds.
//
// What bounds them on the H100: these products are compute-heavy at the
// wide layers (K, N up to 2048) and bandwidth-heavy at layer1 (K = 64), and
// this first version is bound by neither: it multiplies on the fp32 CUDA
// cores (67 TFLOP/s), not the bf16 tensor cores (989). Each block computes
// a 128 x 64 output tile from 16-deep slices of both operands staged as
// fp32 in shared memory, 8 x 4 outputs a thread. Tensor-core tiles
// (mma.sync, then wgmma with TMA) are the next step.
//
// Shapes: any M >= 1; K and N multiples of 8 (row starts stay 16-byte
// aligned). Ragged edges are masked in the kernels. Element types:
// float32 and bfloat16 (dtype 0 / 1), the same for x, w, y, dy and dx.
#include "fused_common.cuh"

namespace {

constexpr int kBM = 128;      // output tile rows
constexpr int kBN = 64;       // output tile columns
constexpr int kBK = 16;       // contraction slice
constexpr int kTM = 8;        // rows a thread owns
constexpr int kTN = 4;        // columns a thread owns
constexpr int kThreads = 256; // (kBM / kTM) x (kBN / kTN)
constexpr int kWarps = kThreads / 32;

// ------------------------------------------------------------ the tile

struct Smem {
  float a[kBK][kBM];   // a[k][row]: the A slice, transposed
  float b[kBK][kBN];   // b[k][col]
  float red[kWarps][kBN];
};

// acc[i][j] += sum_k a[k][ty*8+i] * b[k][tx*4+j] over one slice
__device__ __forceinline__ void tile_fma(const Smem& s, int tx, int ty,
                                         float acc[kTM][kTN]) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&s.a[k][ty * kTM]);
    const float4 a1 =
        *reinterpret_cast<const float4*>(&s.a[k][ty * kTM + 4]);
    const float4 b = *reinterpret_cast<const float4*>(&s.b[k][tx * kTN]);
    const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// v[j] summed over the tile's 128 rows (each thread holds its 8), in a
// fixed order: the two row groups of a warp by shuffle, then the 8 warps
// in turn. Every thread gets the column totals of its 4 columns.
__device__ __forceinline__ void column_sum(Smem& s, int tx, float v[kTN]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kTN; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], 16);
  if (lane < 16) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) s.red[warp][tx * kTN + j] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s.red[w][tx * kTN + j];
    v[j] = t;
  }
  __syncthreads();
}

// ------------------------------------------------------------ forward

// y tile [128 rows, 64 channels] of a @ w, then the tile's per-channel
// mean and M2 of the rounded y into pmean/pm2 [row tile, N]
template <typename T, bool kPro>
__global__ void __launch_bounds__(kThreads)
mm_stats_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ shift, const T* __restrict__ w,
                T* __restrict__ y, float* __restrict__ pmean,
                float* __restrict__ pm2, int M, int K, int N) {
  __shared__ __align__(16) Smem s;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ar = tid >> 1, ak = (tid & 1) * 8;       // A: 128 rows x 16
  const int bk = tid >> 4, bn = (tid & 15) * 4;      // B: 16 x 64 columns
  float acc[kTM][kTN] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    float av[8] = {};
    const int m = m0 + ar, k = k0 + ak;
    if (m < M && k < K) {
      load8(x + (size_t)m * K + k, av);
      if (kPro) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = prologue<T>(av[i], scale[k + i], shift[k + i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) s.a[ak + i][ar] = av[i];
    float bv[4] = {};
    if (k0 + bk < K && n0 + bn < N)
      load4(w + (size_t)(k0 + bk) * N + n0 + bn, bv);
    *reinterpret_cast<float4*>(&s.b[bk][bn]) =
        make_float4(bv[0], bv[1], bv[2], bv[3]);
    __syncthreads();
    tile_fma(s, tx, ty, acc);
    __syncthreads();
  }
  const int nc = n0 + tx * kTN;
  const bool col_ok = nc < N;   // N % 4 == 0: all four columns or none
  const int rows = min(kBM, M - m0);
  float sum[kTN] = {};
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty * kTM + i;
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      acc[i][j] = round_to(acc[i][j], static_cast<const T*>(nullptr));
    if (r < rows) {
      if (col_ok) store4(y + (size_t)(m0 + r) * N + nc, acc[i]);
#pragma unroll
      for (int j = 0; j < kTN; ++j) sum[j] += acc[i][j];
    }
  }
  column_sum(s, tx, sum);
  float mean[kTN], q[kTN] = {};
#pragma unroll
  for (int j = 0; j < kTN; ++j) mean[j] = sum[j] / rows;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (ty * kTM + i < rows) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float d = acc[i][j] - mean[j];
        q[j] = fmaf(d, d, q[j]);
      }
    }
  }
  column_sum(s, tx, q);
  if (ty == 0 && col_ok) {
    store4(pmean + (size_t)blockIdx.y * N + nc, mean);
    store4(pm2 + (size_t)blockIdx.y * N + nc, q);
  }
}

// the rows of row tile t, for stats_finish_kernel
struct RowTiles {
  int M;
  __device__ float operator()(int t) const {
    return (float)min(kBM, M - t * kBM);
  }
};

// ------------------------------------------------------------ backward

// dx tile [128 rows, 64 of K] of e @ w^T, contracting over N: e is built
// from dy, y while the A slice is loaded, w^T is read as wt [N, K] (the
// conv weight's own [O, I] layout). With the prologue, the epilogue gates
// by pre = x*scale + shift and writes the tile's dscale/dshift partials
// [row tile, K].
template <typename T, bool kPro>
__global__ void __launch_bounds__(kThreads)
mm_stats_dx_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                   const float* __restrict__ perch,
                   const float* __restrict__ dvar2,
                   const float* __restrict__ mean, const T* __restrict__ wt,
                   const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ shift, T* __restrict__ dx,
                   float* __restrict__ pdscale, float* __restrict__ pdshift,
                   int M, int K, int N) {
  __shared__ __align__(16) Smem s;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, k0 = blockIdx.x * kBN;
  const int ar = tid >> 1, ac = (tid & 1) * 8;       // A: 128 rows x 16
  const int bc = tid >> 4, bk = (tid & 15) * 4;      // B: 16 x 64 of K
  float acc[kTM][kTN] = {};
  for (int c0 = 0; c0 < N; c0 += kBK) {
    float ev[8] = {};
    const int m = m0 + ar, c = c0 + ac;
    if (m < M && c < N) {
      float yv[8];
      load8(dy + (size_t)m * N + c, ev);
      load8(y + (size_t)m * N + c, yv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        ev[i] = effective<T>(ev[i], yv[i], perch[c + i], dvar2[c + i],
                             mean[c + i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) s.a[ac + i][ar] = ev[i];
    float bv[4] = {};
    if (c0 + bc < N && k0 + bk < K)
      load4(wt + (size_t)(c0 + bc) * K + k0 + bk, bv);
    *reinterpret_cast<float4*>(&s.b[bc][bk]) =
        make_float4(bv[0], bv[1], bv[2], bv[3]);
    __syncthreads();
    tile_fma(s, tx, ty, acc);
    __syncthreads();
  }
  const int kc = k0 + tx * kTN;
  const bool col_ok = kc < K;
  const int rows = min(kBM, M - m0);
  float sc[kTN] = {}, sh[kTN] = {}, ds[kTN] = {}, dt[kTN] = {};
  if (kPro && col_ok) load4(scale + kc, sc), load4(shift + kc, sh);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty * kTM + i;
    if (r >= rows || !col_ok) continue;
    float out[kTN];
    if (kPro) {
      float xv[kTN];
      load4(x + (size_t)(m0 + r) * K + kc, xv);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float pre = __fadd_rn(__fmul_rn(xv[j], sc[j]), sh[j]);
        const float gated = pre > 0.f ? acc[i][j] : 0.f;
        out[j] = __fmul_rn(gated, sc[j]);
        ds[j] = fmaf(gated, xv[j], ds[j]);
        dt[j] += gated;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j) out[j] = acc[i][j];
    }
    store4(dx + (size_t)(m0 + r) * K + kc, out);
  }
  if (kPro) {
    column_sum(s, tx, ds);
    column_sum(s, tx, dt);
    if (ty == 0 && col_ok) {
      store4(pdscale + (size_t)blockIdx.y * K + kc, ds);
      store4(pdshift + (size_t)blockIdx.y * K + kc, dt);
    }
  }
}

// dw partial [128 of K, 64 of N] = sum over this block's chunk of rows of
// a[m][k] * e[m][n], a and e rebuilt from x and (dy, y) while loading;
// written to part[chunk][K][N]
template <typename T, bool kPro>
__global__ void __launch_bounds__(kThreads)
mm_stats_dw_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                   const float* __restrict__ perch,
                   const float* __restrict__ dvar2,
                   const float* __restrict__ mean, const T* __restrict__ x,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, float* __restrict__ part,
                   int M, int K, int N, int chunk_rows) {
  __shared__ __align__(16) Smem s;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kBN, k0 = blockIdx.y * kBM;
  const int r0 = blockIdx.z * chunk_rows;
  const int r1 = min(M, r0 + chunk_rows);
  const int am = tid >> 4, ak = (tid & 15) * 8;      // A: 16 rows x 128 K
  const int bm = tid >> 4, bn = (tid & 15) * 4;      // B: 16 rows x 64 N
  float sc[8] = {}, sh[8] = {};
  if (kPro && k0 + ak < K) {
    load8(scale + k0 + ak, sc);
    load8(shift + k0 + ak, sh);
  }
  float acc[kTM][kTN] = {};
  for (int m0 = r0; m0 < r1; m0 += kBK) {
    float av[8] = {};
    const int ma = m0 + am;
    if (ma < r1 && k0 + ak < K) {
      load8(x + (size_t)ma * K + k0 + ak, av);
      if (kPro) {
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = prologue<T>(av[i], sc[i], sh[i]);
      }
    }
    *reinterpret_cast<float4*>(&s.a[am][ak]) =
        make_float4(av[0], av[1], av[2], av[3]);
    *reinterpret_cast<float4*>(&s.a[am][ak + 4]) =
        make_float4(av[4], av[5], av[6], av[7]);
    float ev[4] = {};
    const int mb = m0 + bm, c = n0 + bn;
    if (mb < r1 && c < N) {
      float yv[4];
      load4(dy + (size_t)mb * N + c, ev);
      load4(y + (size_t)mb * N + c, yv);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ev[j] = effective<T>(ev[j], yv[j], perch[c + j], dvar2[c + j],
                             mean[c + j]);
    }
    *reinterpret_cast<float4*>(&s.b[bm][bn]) =
        make_float4(ev[0], ev[1], ev[2], ev[3]);
    __syncthreads();
    tile_fma(s, tx, ty, acc);
    __syncthreads();
  }
  const int nc = n0 + tx * kTN;
  if (nc >= N) return;
  float* out = part + (size_t)blockIdx.z * K * N;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int k = k0 + ty * kTM + i;
    if (k < K) store4(out + (size_t)k * N + nc, acc[i]);
  }
}

// ------------------------------------------------------------ launches

template <typename T>
int forward(const void* x, const float* scale, const float* shift,
            const void* w, void* y, float* pmean, float* pm2, float* mean,
            float* var, bool pro, int M, int K, int N, cudaStream_t st) {
  const dim3 grid(tiles_of(N, kBN), tiles_of(M, kBM));
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (pro)
    mm_stats_kernel<T, true><<<grid, kThreads, 0, st>>>(
        xt, scale, shift, wt, yt, pmean, pm2, M, K, N);
  else
    mm_stats_kernel<T, false><<<grid, kThreads, 0, st>>>(
        xt, scale, shift, wt, yt, pmean, pm2, M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return stats_finish(pmean, pm2, tiles_of(M, kBM), N, RowTiles{M}, mean,
                      var, st);
}

template <typename T>
int backward(const void* dy, const void* y, const void* x,
             const float* scale, const float* shift, const void* wt,
             const float* perch, const float* dvar2, const float* mean,
             void* dx, float* dw, float* dw_part, float* dscale,
             float* dshift, float* ds_part, float* dt_part, bool pro, int M,
             int K, int N, int chunks, int chunk_rows, cudaStream_t st) {
  const T* dyt = static_cast<const T*>(dy);
  const T* yt = static_cast<const T*>(y);
  const T* xt = static_cast<const T*>(x);
  const T* wtt = static_cast<const T*>(wt);
  T* dxt = static_cast<T*>(dx);
  const dim3 gx(tiles_of(K, kBN), tiles_of(M, kBM));
  if (pro)
    mm_stats_dx_kernel<T, true><<<gx, kThreads, 0, st>>>(
        dyt, yt, perch, dvar2, mean, wtt, xt, scale, shift, dxt, ds_part,
        dt_part, M, K, N);
  else
    mm_stats_dx_kernel<T, false><<<gx, kThreads, 0, st>>>(
        dyt, yt, perch, dvar2, mean, wtt, xt, scale, shift, dxt, ds_part,
        dt_part, M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // one chunk writes dw itself; more write partials for the column total
  float* out = chunks == 1 ? dw : dw_part;
  const dim3 gw(tiles_of(N, kBN), tiles_of(K, kBM), chunks);
  if (pro)
    mm_stats_dw_kernel<T, true><<<gw, kThreads, 0, st>>>(
        dyt, yt, perch, dvar2, mean, xt, scale, shift, out, M, K, N,
        chunk_rows);
  else
    mm_stats_dw_kernel<T, false><<<gw, kThreads, 0, st>>>(
        dyt, yt, perch, dvar2, mean, xt, scale, shift, out, M, K, N,
        chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (chunks > 1 &&
      (err = column_total(dw_part, chunks, K * N, dw, st)) != cudaSuccess)
    return err;
  if (pro) {
    const int tiles = tiles_of(M, kBM);
    if ((err = column_total(ds_part, tiles, K, dscale, st)) != cudaSuccess)
      return err;
    return column_total(dt_part, tiles, K, dshift, st);
  }
  return cudaSuccess;
}

bool shapes_ok(int M, int K, int N) {
  return M > 0 && K > 0 && N > 0 && K % 8 == 0 && N % 8 == 0;
}

}  // namespace

// The tile height the callers size their partial buffers by.
extern "C" int paddle_mm_bn_stats_block_rows() { return kBM; }

// Forward. x [M,K], w [K,N], y [M,N] contiguous, of dtype 0 (float32) or
// 1 (bfloat16); scale, shift fp32 [K] (read only when prologue is 1);
// part_mean, part_m2 fp32 scratch [ceil(M/128), N]; mean, var fp32 [N].
// Two launches (the product with its tile statistics, then the fixed-order
// combine). Returns the cudaError_t of the launches.
extern "C" int paddle_mm_bn_stats(const void* x, const float* scale,
                                  const float* shift, const void* w, void* y,
                                  float* part_mean, float* part_m2,
                                  float* mean, float* var, int dtype,
                                  int prologue, int M, int K, int N,
                                  void* stream) {
  if (!shapes_ok(M, K, N)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float>(x, scale, shift, w, y, part_mean, part_m2, mean,
                          var, prologue != 0, M, K, N, st);
  if (dtype == 1)
    return forward<bf16>(x, scale, shift, w, y, part_mean, part_m2, mean,
                         var, prologue != 0, M, K, N, st);
  return cudaErrorInvalidValue;
}

// Backward. dy, y [M,N]; x [M,K]; wt [N,K] (w transposed: the conv
// weight's [O, I]); perch, dvar2, mean fp32 [N]; scale, shift fp32 [K]
// (prologue 1 only). Outputs dx [M,K] (the input dtype), dw fp32 [K,N],
// and with the prologue dscale, dshift fp32 [K]. Scratch: dw_part fp32
// [chunks, K, N] when chunks > 1; ds_part, dt_part fp32 [ceil(M/128), K]
// with the prologue. chunk_rows: rows per dw chunk, a multiple of 16, with
// chunks * chunk_rows >= M. Returns the cudaError_t of the launches.
extern "C" int paddle_mm_bn_stats_bwd(
    const void* dy, const void* y, const void* x, const float* scale,
    const float* shift, const void* wt, const float* perch,
    const float* dvar2, const float* mean, void* dx, float* dw,
    float* dw_part, float* dscale, float* dshift, float* ds_part,
    float* dt_part, int dtype, int prologue, int M, int K, int N,
    int chunks, int chunk_rows, void* stream) {
  if (!shapes_ok(M, K, N) || chunks < 1 || chunk_rows % kBK ||
      (int64_t)chunks * chunk_rows < M)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(dy, y, x, scale, shift, wt, perch, dvar2, mean,
                           dx, dw, dw_part, dscale, dshift, ds_part, dt_part,
                           prologue != 0, M, K, N, chunks, chunk_rows, st);
  if (dtype == 1)
    return backward<bf16>(dy, y, x, scale, shift, wt, perch, dvar2, mean,
                          dx, dw, dw_part, dscale, dshift, ds_part, dt_part,
                          prologue != 0, M, K, N, chunks, chunk_rows, st);
  return cudaErrorInvalidValue;
}
