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
// memory: each is recomputed from x (or dy, y) while a slice is staged
// into shared memory. That is the byte cut the TPU kernels exist for.
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
// One tile body serves all three products: mm_stats_kernel of
// conv_gemm.cuh (see its note), which the 3x3 backward's implicit GEMM
// route shares. A block of 8 warps owns a 128 x 128 output tile and walks
// the contraction in 32-deep slices through a ring of three cp.async
// groups; an operand with an elementwise step (the prologue's a, the
// effective e) lands raw and takes its step after the previous slice's
// products. The forward is y = a @ w, dx is e @ wt (wt [N,K], the conv
// weight's own layout), dw is a^T @ e contracting over the rows.
//
// Products: bfloat16 runs on the tensor cores through warp-level
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) on bf16 fragments loaded
// from shared memory with ldmatrix (transposed for every depth-major
// operand: w, wt, and both operands of dw): route "mma". float32 runs the
// same tile body, the same fragments computed with fp32 FMAs on the CUDA
// cores (fma_step): route "fma"; the fp32 card tests hold this indexing
// at one fp32 ulp. Elementwise steps that end in a rounding to the
// storage type (the prologue, e, the gated dx) use __fmul_rn/__fadd_rn,
// so nvcc cannot fuse them into an fma and they round where the plain
// PyTorch version rounds.
//
// What bounds them on the H100: at ResNet-50's layer1 (K = 64, M =
// 401,408) the bytes (x, y, dy, dx: 0.077 ms forward, 0.153 backward at
// 3.35 TB/s); at layer4 (K, N up to 2048) the products (0.013 ms forward,
// 0.027 backward at 989 TFLOP/s). This version is bound by neither:
// mma.sync with ldmatrix reaches a fraction of the wgmma rate, the
// backward reads dy and y twice (dx and dw are two kernels; a one-pass
// kernel would fit only layer1's small K x N), and a block's loads wait
// while it writes its tile. wgmma with TMA is the next step.
//
// Shapes: any M >= 1; K and N multiples of 8 (row starts stay 16-byte
// aligned). Ragged edges are zero-filled in shared memory and masked in
// the epilogues. Element types: float32 and bfloat16 (dtype 0 / 1), the
// same for x, w, y, dy and dx.
#include "conv_gemm.cuh"

namespace {

using namespace paddle_gemm;

// the rows of row tile t, for stats_finish_kernel
struct RowTiles {
  int M;
  __device__ float operator()(int t) const {
    return (float)min(kBM, M - t * kBM);
  }
};

// ------------------------------------------------------------ launches

template <typename T, int kKind, bool kPro>
cudaError_t start(const Args<T>& a, dim3 grid, cudaStream_t st) {
  auto kernel = mm_stats_kernel<T, kKind, kPro>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<T, kKind, kPro>::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, Layout<T, kKind, kPro>::kBytes, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int kKind>
cudaError_t launch(const Args<T>& a, bool pro, dim3 grid, cudaStream_t st) {
  return pro ? start<T, kKind, true>(a, grid, st)
             : start<T, kKind, false>(a, grid, st);
}

template <typename T>
int forward(const void* x, const float* scale, const float* shift,
            const void* w, void* y, float* pmean, float* pm2, float* mean,
            float* var, bool pro, int M, int K, int N, cudaStream_t st) {
  const Args<T> a{static_cast<const T*>(x), scale, shift,
                  static_cast<const T*>(w), nullptr, nullptr, nullptr,
                  nullptr, nullptr, y, pmean, pm2, M, K, N, 0};
  cudaError_t err = launch<T, kFwd>(
      a, pro, dim3(tiles_of(N, kBN), tiles_of(M, kBM)), st);
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
  Args<T> a{static_cast<const T*>(x), scale, shift,
            static_cast<const T*>(wt), static_cast<const T*>(dy),
            static_cast<const T*>(y), perch, dvar2, mean, dx, ds_part,
            dt_part, M, K, N, chunk_rows};
  cudaError_t err = launch<T, kDx>(
      a, pro, dim3(tiles_of(K, kBN), tiles_of(M, kBM)), st);
  if (err != cudaSuccess) return err;
  // one chunk writes dw itself; more write partials for the column total
  a.out = chunks == 1 ? dw : dw_part;
  err = launch<T, kDw>(a, pro,
                       dim3(tiles_of(N, kBN), tiles_of(K, kBM), chunks), st);
  if (err != cudaSuccess) return err;
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

// The tile geometry the callers size their buffers and dw chunks by:
// g[0] the statistics' row tile (partials [ceil(M/g[0]), ...]), g[1] x
// g[2] the dw tile (of K x of N), g[3] the dw row step (a chunk's rows
// are a multiple of it).
extern "C" void paddle_mm_bn_stats_geometry(int* g) {
  g[0] = kBM, g[1] = kBM, g[2] = kBN, g[3] = kBK;
}

// 1 where dtype's products run on the tensor cores (mma.sync: bfloat16),
// 0 where on the fp32 CUDA cores (float32).
extern "C" int paddle_mm_bn_stats_route(int dtype) { return dtype == 1; }

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
// with the prologue. chunk_rows: rows per dw chunk, a multiple of the dw
// row step (paddle_mm_bn_stats_geometry), with chunks * chunk_rows >= M.
// Returns the cudaError_t of the launches.
extern "C" int paddle_mm_bn_stats_bwd(
    const void* dy, const void* y, const void* x, const float* scale,
    const float* shift, const void* wt, const float* perch,
    const float* dvar2, const float* mean, void* dx, float* dw,
    float* dw_part, float* dscale, float* dshift, float* ds_part,
    float* dt_part, int dtype, int prologue, int M, int K, int N,
    int chunks, int chunk_rows, void* stream) {
  if (!shapes_ok(M, K, N) || chunks < 1 || chunks > 65535 ||
      chunk_rows < 1 || chunk_rows % kBK ||
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
