// The fused LM head + cross entropy, hand-written for Hopper (sm_90a): the
// per-row cross entropy of softmax(h @ W^T) against integer labels, and its
// gradients for h and W, without the [N, V] logits ever reaching device
// memory.
//
// Replaces the TPU kernels of paddle_tpu/kernels/fused_ce.py:
//   paddle_ce_fwd  _fwd :101 (_fwd_kernel :58)
//   paddle_ce_bwd  _bwd :223 (_bwd_dh_kernel :154, _bwd_dw_kernel :188)
//
// What they compute, for h [N, H], W [V, H] (vocab-major; the wrapper hands
// an [H, V] weight over transposed) and labels y [N] (y < 0: ignored):
//   forward   logits = h @ W^T in fp32; lse = m + log(l) of the row's
//             natural-exp softmax (l == 0 taken as 1); gold = the logit of
//             column y, 0 when y is no column (y < 0 or y >= V, as the TPU
//             kernel's sum over the tile that holds the label gives);
//             ce = lse - gold, 0 where y < 0. Writes lse and ce [N] fp32.
//   backward  from the forward's lse and s = where(y >= 0, dce, 0) [N]:
//             d = (exp(logit - lse) - [col == y]) * s, recomputed from h
//             and W; dh = T(d) @ W and dW = T(d)^T @ h, d rounded to the
//             element type T before each product, fp32 sums, each output
//             written once in T. A row with y < 0 has s = 0, so its d and
//             its dh row are exactly 0.
//
// The forward, bfloat16 (ce_fwd_wgmma): the product on the port's
// warpgroup body (wgmma_gemm.cuh), the online softmax in the consumers'
// registers, the vocabulary split over the blocks of a thread-block
// cluster. The TPU kernel walks a (row block, vocab block) grid in order
// and carries its sums in VMEM scratch from step to step; here:
// - Tiles: 128 token rows x kFwdTile (256) W rows, h and W both K-major,
//   TMA feeding a 4-slot mbarrier ring of 64-deep slices; two consumer
//   warpgroups, each 64 rows over the 256 columns in two m64n128k16
//   products into fp32, and one producer warp (WideRing). TMA zero-fills
//   past N, V and H, so any H (a multiple of 8) takes this one kernel;
//   the epilogue leaves out columns v >= V.
// - Splits: row tile r is kFwdSplits blocks, one cluster. Block (split s,
//   row tile r) walks the W tiles of split s, [s * per, (s + 1) * per)
//   with per = ceil(tiles / kFwdSplits), in order, on one ring that runs
//   on across its tiles (produce_wide_run, consume_wide_at: the producer
//   is a tile ahead while the consumers finish one). Clusters start in
//   row-tile order, so the blocks resident at once walk the same splits
//   side by side and each W tile comes from device memory about once a
//   wave.
// - Softmax: each consumer thread keeps a running (max, sum-exp) for
//   each of its 2 token rows over its own 32 columns of each 128-column
//   product half (kFwdStep), in registers beside the accumulators
//   (fwd_step: e^(x - m) as 2^(x log2 e - m log2 e) by ex2.approx on the
//   special-function unit, lse's error about 2^-22 + 2^-24 |m|; four
//   partial chains for the max and the sum, the mask only where V cuts
//   the half); the one thread that meets a row's label column writes the
//   gold logit to shared memory. At the end the 4 lanes of a row merge
//   (xor shuffles, merge) and the block leaves its rows' partials (max,
//   sum-exp, gold) in shared memory.
// - Fold: split 0's block merges the partials of splits 0 .. kFwdSplits-1
//   in rank order through distributed shared memory and writes lse and
//   ce. A split with no columns (V < kFwdSplits * 256) leaves (-1e30, 0,
//   0), which folds to nothing.
// One launch, no scratch, no atomics: the bits repeat, and a row's bits
// depend on its own h row, W and label only, not on N or its neighbours.
// What bounds it: at gpt2-small's LM head (N 16,368, H 768, V 50,257)
// the product is 1.26e12 FLOPs, 1.278 ms at 989 TFLOP/s. The 128 x 256
// tile brings 85 FLOPs a byte into shared memory (a 128 x 128 tile 64,
// and it ran 1.25x slower; PERF.md section 6). One block fills an SM, so
// its softmax, one ex2 a logit, runs while its tensor cores wait: about
// a seventh of the time (experiments/ce_conv3x3_probe.py
// --fwd-variant=product-only).
//
// The forward, float32 (ce_kernel): a block owns kOwn rows of h and walks
// every kOth-row tile of W in a fixed order, both tiles held over the full
// hidden width in shared memory (cp.async copies, zero past the edge). A
// tile's logits [kOwn, kOth] come from one product over H (fp32 FMAs on
// mma_common.cuh's fragments); each thread keeps an online (max, sum-exp,
// gold) for its rows over its own columns, and at the end the four lanes
// of a row and the four column warps combine them in a fixed order.
// Hidden sizes past kMaxH (768, the widest a tile pair holds in shared
// memory) take the wide instantiation (kWide), which streams H in slices
// of kMaxH through the same tiles, summing the slices' products in fp32 in
// slice order before the softmax step.
//
// The backward: three products, the least it can do. The vocabulary is
// taken in fixed chunks of vc columns (kChunkV at most; the wrapper's
// plan), in order, and for chunk c with columns [v0, v0 + len):
//   (a) logits  h @ W_c^T over K = H; the epilogue turns each logit into
//       d, rounded to T, and writes d_c [N, vc] to a scratch buffer
//       (zeros past V);
//   (b) dW_c    d_c^T @ h over K = N, written once in T: each W row
//       belongs to one chunk;
//   (c) dh      acc += d_c @ W_c over K = len, into an fp32 [N, H]
//       accumulator, the chunks added in chunk order; the last chunk
//       rounds to T and writes dh instead.
// Two launches a chunk: (a), then (b) and (c) in one grid, dW tiles first
// (their K, N, is the longer). Every sum runs in a fixed order and no
// atomic is used: the bits repeat run to run. At the LM head the scratch
// is d_c (N x 8192 bf16, 268 MB) and the accumulator (N x H fp32, 50 MB).
//
// Products of the backward: bfloat16 runs on the port's warpgroup body
// (wgmma_gemm.cuh: wgmma m64n128k16 from 128-byte swizzled shared memory
// that TMA fills through a 3-slot mbarrier ring, one producer warp and one
// consumer warpgroup on a 128 x 128 tile, two blocks an SM). Each product
// reads its operands as they lie: (a) h and W_c K-major, (b) d_c and h
// MN-major (wgmma transposes them), (c) d_c K-major and W_c MN-major.
// float32 runs the same three products and epilogues on a CUDA-core tile
// (64 x 64, 4 x 4 fp32 FMAs a thread, fma_tile). What bounds the backward
// on the H100: three products of 1.26e12 FLOPs at the LM head, 3.83 ms at
// 989 TFLOP/s; d's traffic (1.6 GB written once and read twice, about
// 1.5 ms at 3.35 TB/s) comes beside them.
//
// Shapes: any N and V >= 1; H a multiple of 8 (the wrapper pads another H
// with zero columns, which add exact zeros to every product); h, W
// contiguous, 16-byte aligned, of one element type: float32 or bfloat16
// (dtype 0 / 1). 64-bit offsets throughout.
#include "mma_common.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 over owner rows x 4 over others
constexpr int kMaxH = 768;     // the widest H slice the forward's tiles hold
constexpr float kNegInf = -1e30f;
// the bf16 forward's W tile, and its splits of the vocabulary: a cluster
// of kFwdSplits blocks a row tile (the fold's order, so the bits, follow
// them; 4 ran slower, PERF.md section 6)
constexpr int kFwdTile = 256;
constexpr int kFwdSplits = 8;
static_assert(kFwdSplits >= 1 && kFwdSplits <= 8,
              "a portable cluster holds at most 8 blocks");
// the backward's vocabulary chunk: at most kChunkV columns, a multiple of
// kChunkStep (kernels/fused_ce.py's _CHUNK_V and _CHUNK_STEP)
constexpr int kChunkV = 8192;
constexpr int kChunkStep = 128;
// the float32 backward's tile: kFM x kFN outputs, kFK deep a step
constexpr int kFM = 64, kFN = 64, kFK = 16;

enum Mode { kFwd = 0 };

__host__ __device__ inline int64_t tiles_of(int64_t n, int64_t t) {
  return (n + t - 1) / t;
}

// the float32 forward's tiles
template <typename T, int kMode>
struct Tile {
  static_assert(sizeof(T) == 4, "bfloat16 takes ce_fwd_wgmma");
  static constexpr int kOwn = 32;
  static constexpr int kOth = 32;
  static constexpr int kStride = kMaxH + 16 / (int)sizeof(T);  // O and X
  static constexpr int kLMI = kOwn / 32;  // m16 tiles of a warp's logits
  static constexpr int kLNI = kOth / 32;  // n8 tiles of a warp's logits
  static constexpr int kStats = 64;       // label slots
  // the tile pair, 3 * kStats statistic slots (the labels are the last
  // kStats), the combine's [4][kStats][3]
  static constexpr size_t kSmem =
      (size_t)(kOwn + kOth) * kStride * sizeof(T) +
      3 * kStats * sizeof(float) + 4 * kStats * 3 * sizeof(float);
};

// The entries' arguments: the forward writes out_lse and out_ce, the
// backward reads lse and s and writes dh into out.
template <typename T>
struct CeArgs {
  const T* h;         // [N, H]
  const T* w;         // [V, H]
  const int* y;       // [N]
  const float* lse;   // backward: the forward's lse [N]
  const float* s;     // backward: where(y >= 0, dce, 0) [N]
  float* out_lse;     // forward: lse [N]
  float* out_ce;      // forward: ce [N]
  T* out;             // backward: dh [N, H]
  int64_t N, V;
  int H;
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------- forward, float32

// rows [r0, r0 + rows) of src [nrows, H] into dst [rows][stride], columns
// [0, hk) with hk = H rounded up to 16; zeros past H and past nrows
template <typename T>
__device__ __forceinline__ void fill(T* dst, const T* src, int64_t r0,
                                     int rows, int64_t nrows, int H, int hk,
                                     int stride) {
  const int per = hk / 8;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, c = (i - r * per) * 8;
    const bool ok = r0 + r < nrows && c < H;
    cp_async8(dst + r * stride + c, src + (ok ? (r0 + r) * H + c : 0), ok);
  }
}

// H slice sl of kMaxH columns (the last one shorter), as the wide kernel
// streams it: columns [c0, c0 + w), w rounded up to 16
struct HSlice {
  int c0, w, wk;
  __device__ __forceinline__ HSlice(int sl, int H)
      : c0(sl * kMaxH), w(min(kMaxH, H - sl * kMaxH)),
        wk((w + 15) / 16 * 16) {}
};

// fill() of the columns of slice hs: src offset by hs.c0, still [nrows, H]
template <typename T>
__device__ __forceinline__ void fill_slice(T* dst, const T* src, int64_t r0,
                                           int rows, int64_t nrows, int H,
                                           const HSlice& hs, int stride) {
  const int per = hs.wk / 8;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, c = (i - r * per) * 8;
    const bool ok = r0 + r < nrows && c < hs.w;
    cp_async8(dst + r * stride + c,
              src + (ok ? (r0 + r) * H + hs.c0 + c : 0), ok);
  }
}

// the labels of rows [t0, t0 + n) into slots [0, n), -1 past N
__device__ __forceinline__ void labels(const int* y, int64_t t0, int n,
                                       int64_t N, int* sy) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int64_t t = t0 + i;
    sy[i] = t < N ? y[t] : -1;
  }
}

// acc = logits of the warp's [kLMI*16, kLNI*8] piece of the tile: the owner
// rows os against the other rows xs over depth [0, hk) (kZero), or acc +=
// that (an H slice's share, the wide kernel)
template <typename T, int kMode, bool kZero = true>
__device__ __forceinline__ void tile_logits(
    float (&acc)[Tile<T, kMode>::kLMI][Tile<T, kMode>::kLNI][4],
    const T* os, const T* xs, int hk, int wm, int wn) {
  using G = Tile<T, kMode>;
  constexpr int S = G::kStride;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int m0 = wm * (G::kOwn / 2), n0 = wn * (G::kOth / 4);
  if constexpr (kZero) {
#pragma unroll
    for (int mi = 0; mi < G::kLMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::kLNI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
  }
#pragma unroll 2
  for (int ks = 0; ks < hk; ks += 16) {
    fma_step<G::kLMI, G::kLNI>(
        acc,
        [&](int mi, int hh, int k) {
          return os + (m0 + mi * 16 + 8 * hh + g) * S + ks + k;
        },
        [&](int n, int k) { return xs + (n0 + n) * S + ks + k; });
  }
}

// (m, l) merged with another running (max, sum-exp)
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

// The forward (kMode kFwd). kWide: H > kMaxH, streamed in slices (see the
// note above); otherwise the whole H is one tile width.
template <typename T, int kMode, bool kWide>
__global__ void __launch_bounds__(kThreads, 1) ce_kernel(const CeArgs<T> a) {
  using G = Tile<T, kMode>;
  constexpr int S = G::kStride;
  constexpr int LMI = G::kLMI, LNI = G::kLNI;
  extern __shared__ __align__(16) unsigned char smem[];
  T* os = reinterpret_cast<T*>(smem);
  T* xs = os + G::kOwn * S;
  float* stats = reinterpret_cast<float*>(xs + G::kOth * S);
  int* sy = reinterpret_cast<int*>(stats + 2 * G::kStats);
  float* comb = reinterpret_cast<float*>(sy + G::kStats);  // [4][64][3]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  const int H = a.H, hk = (H + 15) / 16 * 16;
  const int64_t own0 = (int64_t)blockIdx.x * G::kOwn;

  if constexpr (!kWide) fill(os, a.h, own0, G::kOwn, a.N, H, hk, S);
  labels(a.y, own0, G::kOwn, a.N, sy);

  // running (max, sum-exp, gold) of this thread's rows
  float rm[LMI][2], rl[LMI][2], rg[LMI][2];
#pragma unroll
  for (int mi = 0; mi < LMI; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      rm[mi][hh] = kNegInf, rl[mi][hh] = 0.f, rg[mi][hh] = 0.f;

  const int64_t tiles = tiles_of(a.V, G::kOth);
  for (int64_t it = 0; it < tiles; ++it) {
    const int64_t oth0 = it * G::kOth;
    float acc[LMI][LNI][4];
    if constexpr (!kWide) {
      fill(xs, a.w, oth0, G::kOth, a.V, H, hk, S);
      cp_async_wait_all();
      __syncthreads();
      tile_logits<T, kMode>(acc, os, xs, hk, wm, wn);
    } else {
      // the tile's logits summed over the H slices in order, the owner
      // tile reloaded with each
#pragma unroll
      for (int mi = 0; mi < LMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < LNI; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
      const int slices = (H + kMaxH - 1) / kMaxH;
      for (int sl = 0; sl < slices; ++sl) {
        const HSlice hs(sl, H);
        if (sl > 0) __syncthreads();   // every warp is done with slice sl-1
        fill_slice(os, a.h, own0, G::kOwn, a.N, H, hs, S);
        fill_slice(xs, a.w, oth0, G::kOth, a.V, H, hs, S);
        cp_async_wait_all();
        __syncthreads();
        tile_logits<T, kMode, false>(acc, os, xs, hs.wk, wm, wn);
      }
    }

#pragma unroll
    for (int mi = 0; mi < LMI; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = wm * (G::kOwn / 2) + mi * 16 + 8 * hh + g;
        const int yl = sy[row];
        float x[LNI][2], tmax = kNegInf;
#pragma unroll
        for (int ni = 0; ni < LNI; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int64_t v = oth0 + wn * (G::kOth / 4) + ni * 8 + 2 * t + j;
            const float lg = acc[mi][ni][2 * hh + j];
            x[ni][j] = v < a.V ? lg : kNegInf;
            tmax = fmaxf(tmax, x[ni][j]);
            if (v < a.V && v == (int64_t)yl) rg[mi][hh] += lg;
          }
        if (tmax > kNegInf) {
          const float mn = fmaxf(rm[mi][hh], tmax);
          float sum = 0.f;
#pragma unroll
          for (int ni = 0; ni < LNI; ++ni)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (x[ni][j] > kNegInf) sum += expf(x[ni][j] - mn);
          rl[mi][hh] = rl[mi][hh] * expf(rm[mi][hh] - mn) + sum;
          rm[mi][hh] = mn;
        }
      }
    __syncthreads();  // xs is rewritten next tile
  }

  // the four lanes of a row, then the four column warps, in order
#pragma unroll
  for (int mi = 0; mi < LMI; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float m = rm[mi][hh], l = rl[mi][hh], gd = rg[mi][hh];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
        const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
        gd += __shfl_xor_sync(0xffffffffu, gd, o);
        merge(m, l, m2, l2);
      }
      const int row = wm * (G::kOwn / 2) + mi * 16 + 8 * hh + g;
      if (t == 0) {
        float* c = comb + (wn * G::kStats + row) * 3;
        c[0] = m, c[1] = l, c[2] = gd;
      }
    }
  __syncthreads();
  if (tid < G::kOwn && own0 + tid < a.N) {
    float m = kNegInf, l = 0.f, gd = 0.f;
    for (int q = 0; q < 4; ++q) {
      const float* c = comb + (q * G::kStats + tid) * 3;
      merge(m, l, c[0], c[1]);
      gd += c[2];
    }
    const float lse = m + logf(l == 0.f ? 1.f : l);
    a.out_lse[own0 + tid] = lse;
    a.out_ce[own0 + tid] = sy[tid] >= 0 ? lse - gd : 0.f;
  }
}

template <typename T, bool kWide>
cudaError_t start_forward(const CeArgs<T>& a, cudaStream_t st) {
  using G = Tile<T, kFwd>;
  auto kernel = ce_kernel<T, kFwd, kWide>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = tiles_of(a.N, G::kOwn);
  kernel<<<dim3((unsigned)blocks, 1), kThreads, G::kSmem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const CeArgs<T>& a, cudaStream_t st) {
  return a.H > kMaxH ? start_forward<T, true>(a, st)
                     : start_forward<T, false>(a, st);
}

// --------------------------------------------------- forward, bfloat16

namespace pw = paddle_wgmma;

// h [N][H] and W [V][H] (or the backward's chunk W_c [len][H]), both
// K-major: the operands of the logits (the forward's W map boxes
// kWideBN rows)
struct LogitMaps {
  CUtensorMap h, w;
};

// the block's shared memory: the ring, then its rows' partials [kBM][3]
// (max, sum-exp, gold) and labels [kBM]
constexpr size_t kFwdSmem = pw::kWideSmem + pw::kBM * 4 * sizeof(float);
static_assert(kFwdTile == pw::kWideBN, "a W tile is one wide ring tile");
// the softmax's step: the columns of one m64n128 product
constexpr int kFwdStep = pw::kBN;

// split s's W tiles [t0, t1) of a V-column vocabulary: contiguous runs of
// ceil(tiles / kFwdSplits), the last ones shorter or empty
__device__ __forceinline__ void split_tiles(int V, int s, int& t0, int& t1) {
  const int tiles = (V + kFwdTile - 1) / kFwdTile;
  const int per = (tiles + kFwdSplits - 1) / kFwdSplits;
  t0 = min(tiles, s * per);
  t1 = min(tiles, t0 + per);
}

// 2^x by the special-function unit (ex2.approx, flushing denormals)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// One softmax step, the 128 columns of one product half acc, into a
// token row's running (max m, sum-exp l): consumer thread t's 32 columns
// (frag_col) of its row hh (frag_row(0, 2hh, t)). kMask (where V cuts the
// step): columns at or past lim (V less the step's first column) are
// left out. e^(x - m) is taken as 2^(x log2(e) - m log2(e)); the max and
// the sum run in four partial chains (columns j % 4), joined in a fixed
// order. The thread that holds the label's column yc (the label less the
// step's first column, or -1) writes its logit to *gold: no other thread
// of any split holds it.
template <bool kMask>
__device__ __forceinline__ void fwd_step(const float (&acc)[64], int hh,
                                         int t, int lim, int yc, float& m,
                                         float& l, float* gold) {
  float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 4 * j + 2 * hh + e;
      if (!kMask || pw::frag_col(i, t) < lim)
        mx[j & 3] = fmaxf(mx[j & 3], acc[i]);
    }
  if (yc >= 0 && yc < lim) {
#pragma unroll
    for (int i = 2 * hh; i < 64; i += 4)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (pw::frag_col(i + e, t) == yc) *gold = acc[i + e];
  }
  const float tmax = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
  if (tmax > kNegInf) {
    const float mn = fmaxf(m, tmax), nb = -mn * kLog2e;
    float sm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hh + e;
        if (!kMask || pw::frag_col(i, t) < lim)
          sm[j & 3] += ex2(fmaf(acc[i], kLog2e, nb));
      }
    l = fmaf(l, ex2(fmaf(m, kLog2e, nb)), (sm[0] + sm[1]) + (sm[2] + sm[3]));
    m = mn;
  }
}

// The bfloat16 forward: block x is split x % kFwdSplits (its cluster
// rank) of token rows 128 (x / kFwdSplits) ..; see the note at the top.
__global__ void __launch_bounds__(pw::kWideThreads, 1)
ce_fwd_wgmma(const __grid_constant__ LogitMaps maps, const CeArgs<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const pw::WideRing r = pw::WideRing::make(smem);
  float* part = reinterpret_cast<float*>(r.empty + pw::kWideStages);
  int* sy = reinterpret_cast<int*>(part + 3 * pw::kBM);
  // N and V below 2^30 (forward_bf16): 32-bit rows and columns
  const int split = cluster_rank(), t = threadIdx.x, V = (int)a.V;
  const int m0 = blockIdx.x / kFwdSplits * pw::kBM, rows = (int)a.N - m0;
  int t0, t1;
  split_tiles(V, split, t0, t1);
  const int slices = (a.H + pw::kBK - 1) / pw::kBK;
  if (t == pw::kWideConsumers) {
    pw::produce_wide_run(r, &maps.h, &maps.w, m0, t0 * kFwdTile, t1 - t0,
                         slices);
  } else if (t < pw::kWideConsumers) {
    // warpgroup w's thread tw holds rows 64w + frag_row(0, 2hh, tw): their
    // running (max, sum-exp) in registers, labels and gold logits in
    // shared memory
    const int tw = t % pw::kConsumers, w64 = 64 * (t / pw::kConsumers);
    auto row = [&](int hh) { return w64 + pw::frag_row(0, 2 * hh, tw); };
    float rm[2], rl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rm[hh] = kNegInf, rl[hh] = 0.f;
      if ((t & 3) == 0) {
        sy[row(hh)] = row(hh) < rows ? a.y[m0 + row(hh)] : -1;
        part[3 * row(hh) + 2] = 0.f;
      }
    }
    __syncwarp();   // a row's four lanes are one warp's
    float acc[2][64];
    for (int j = t0; j < t1; ++j) {
      pw::consume_wide_at(r, acc, (j - t0) * slices, slices);
      // the tile's two product halves in column order, each a softmax
      // step; a half wholly past V is no step
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n0 = j * kFwdTile + c * kFwdStep;
        const int lim = min(V - n0, kFwdStep);
        if (lim <= 0) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int y = sy[row(hh)], yc = y >= n0 ? y - n0 : -1;
          float* gold = part + 3 * row(hh) + 2;
          if (lim == kFwdStep)
            fwd_step<false>(acc[c], hh, tw, lim, yc, rm[hh], rl[hh], gold);
          else
            fwd_step<true>(acc[c], hh, tw, lim, yc, rm[hh], rl[hh], gold);
        }
      }
    }
    // the four lanes of a row, in a fixed order; lane 0 of the four
    // leaves the row's (max, sum-exp)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float m = rm[hh], l = rl[hh];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
        const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
        merge(m, l, m2, l2);
      }
      if ((t & 3) == 0) {
        part[3 * row(hh)] = m;
        part[3 * row(hh) + 1] = l;
      }
    }
  }
  __syncwarp();
  cluster_sync();   // every split's partials are in its block
  if (split == 0 && t < min(rows, pw::kBM)) {
    const float* p = part + 3 * t;
    float m = kNegInf, l = 0.f, gd = 0.f;
    for (int q = 0; q < kFwdSplits; ++q) {
      merge(m, l, cluster_load(p, q), cluster_load(p + 1, q));
      gd += cluster_load(p + 2, q);
    }
    const float lse = m + logf(l == 0.f ? 1.f : l);
    a.out_lse[m0 + t] = lse;
    a.out_ce[m0 + t] = sy[t] >= 0 ? lse - gd : 0.f;
  }
  cluster_sync();   // no block leaves while split 0 reads its partials
}

// the bfloat16 forward's one launch: clusters of kFwdSplits blocks, one
// a row tile
cudaError_t forward_bf16(const CeArgs<bf16>& a, cudaStream_t st) {
  LogitMaps maps;
  // TMA coordinates are 32-bit
  if (a.N > (1ll << 30) || a.V > (1ll << 30) ||
      !pw::operand_map(&maps.h, a.h, a.N, a.H, a.H, false) ||
      !pw::make_map(&maps.w, a.w, a.V, a.H, a.H, pw::kWideBN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFwdSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles_of(a.N, pw::kBM) * kFwdSplits));
  cfg.blockDim = dim3(pw::kWideThreads);
  cfg.dynamicSmemBytes = kFwdSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kFwdSplits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ce_fwd_wgmma, maps, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ------------------------------------------------------------ backward

// One vocabulary chunk of the backward: columns [v0, v0 + len).
template <typename T>
struct Chunk {
  T* d;          // scratch [N][vc]: d of the chunk's columns
  float* acc;    // [N][H] fp32: dh over the chunks before this one
  T* dw;         // dW [V][H]
  int64_t v0;
  int len, vc;
  int first, last;   // the chunk is the first / the last
  int dw_tiles;      // the gradient launch's blocks [0, dw_tiles): dW
};

// d of one logit lg at chunk column v of a token row (lse, s, label yl):
// (p - onehot) * s, 0 past V
__device__ __forceinline__ float d_of(float lg, int64_t v, int64_t V,
                                      float lse, float s, int yl) {
  if (v >= V) return 0.f;
  const float p = expf(lg - lse);
  const float oh = v == (int64_t)yl ? 1.f : 0.f;
  return __fmul_rn(__fsub_rn(p, oh), s);
}

// a token row's (lse, s, label); s 0 past N, so its d is 0
template <typename T>
__device__ __forceinline__ void token(const CeArgs<T>& a, int64_t row,
                                      float& lse, float& s, int& yl) {
  const bool ok = row < a.N;
  lse = ok ? a.lse[row] : 0.f;
  s = ok ? a.s[row] : 0.f;
  yl = ok ? a.y[row] : -1;
}

// dh's epilogue for a column pair (col, col + 1) of token row `row`: the
// chunks before this one added, then fp32 into the accumulator, or T
// into dh on the last chunk
template <typename T>
__device__ __forceinline__ void dh_pair(const CeArgs<T>& a,
                                        const Chunk<T>& c, int64_t row,
                                        int col, float v0, float v1) {
  const int64_t at = row * a.H + col;
  if (!c.first) {
    const float2 p = *reinterpret_cast<const float2*>(c.acc + at);
    v0 = p.x + v0;
    v1 = p.y + v1;
  }
  if (c.last) store2(a.out + at, v0, v1);
  else store2(c.acc + at, v0, v1);
}

// (b)'s d_c [N][len] and h [N][H], both MN-major; (c)'s d_c K-major and
// W_c [len][H] MN-major
struct GradMaps {
  CUtensorMap d_mn, h_mn, d_k, w_mn;
};

// (a) on the warpgroup body: block (x, y) is chunk columns 128x.. and
// token rows 128y..; writes d_c
__global__ void __launch_bounds__(pw::kThreads, 2)
ce_logits_wgmma(const __grid_constant__ LogitMaps maps,
                const CeArgs<bf16> a, const Chunk<bf16> c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const pw::Ring r = pw::Ring::make(smem);
  const int n0 = blockIdx.x * pw::kBN, m0 = blockIdx.y * pw::kBM;
  const int slices = (int)tiles_of(a.H, pw::kBK);
  const int t = threadIdx.x;
  if (t >= pw::kConsumers) {
    if (t == pw::kConsumers)
      pw::produce<false, false>(r, &maps.h, &maps.w, m0, n0, 0, slices);
    return;
  }
  float acc[2][64];
  pw::consume<false, false>(r, acc, slices);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t row = m0 + pw::frag_row(h, 2 * hh, t);
      float lse, s;
      int yl;
      token(a, row, lse, s, yl);
      if (row >= a.N) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = 4 * j + 2 * hh, col = n0 + pw::frag_col(i, t);
        const int64_t v = c.v0 + col;
        store2(c.d + row * c.vc + col,
               d_of(acc[h][i], v, a.V, lse, s, yl),
               d_of(acc[h][i + 1], v + 1, a.V, lse, s, yl));
      }
    }
}

// (b) and (c) on the warpgroup body: blocks [0, dw_tiles) are dW tiles
// (chunk rows 128.. x H columns 128..), the rest dh tiles (token rows x
// H columns)
__global__ void __launch_bounds__(pw::kThreads, 2)
ce_grads_wgmma(const __grid_constant__ GradMaps maps, const CeArgs<bf16> a,
               const Chunk<bf16> c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const pw::Ring r = pw::Ring::make(smem);
  const int hn = (int)tiles_of(a.H, pw::kBN);
  const bool dw = (int)blockIdx.x < c.dw_tiles;
  const int tile = dw ? blockIdx.x : blockIdx.x - c.dw_tiles;
  const int m0 = tile / hn * pw::kBM, n0 = tile % hn * pw::kBN;
  const int t = threadIdx.x;
  float acc[2][64];
  if (dw) {
    const int slices = (int)tiles_of(a.N, pw::kBK);
    if (t >= pw::kConsumers) {
      if (t == pw::kConsumers)
        pw::produce<true, true>(r, &maps.d_mn, &maps.h_mn, m0, n0, 0,
                                slices);
      return;
    }
    pw::consume<true, true>(r, acc, slices);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + pw::frag_row(h, 2 * hh, t);
        if (row >= c.len) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int i = 4 * j + 2 * hh, col = n0 + pw::frag_col(i, t);
          if (col < a.H)
            store2(c.dw + (c.v0 + row) * a.H + col, acc[h][i],
                   acc[h][i + 1]);
        }
      }
  } else {
    const int slices = (int)tiles_of(c.len, pw::kBK);
    if (t >= pw::kConsumers) {
      if (t == pw::kConsumers)
        pw::produce<false, true>(r, &maps.d_k, &maps.w_mn, m0, n0, 0,
                                 slices);
      return;
    }
    pw::consume<false, true>(r, acc, slices);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t row = m0 + pw::frag_row(h, 2 * hh, t);
        if (row >= a.N) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int i = 4 * j + 2 * hh, col = n0 + pw::frag_col(i, t);
          if (col < a.H) dh_pair(a, c, row, col, acc[h][i], acc[h][i + 1]);
        }
      }
  }
}

// The float32 tile: acc[i][j] = sum over k < K of A(m0 + 4ty + i, k) *
// B(k, n0 + 4tx + j) (ty, tx = thread / 16, thread % 16), in depth order,
// zeros outside [M, N]. A(m, k) lies at A[kAMN ? k*lda + m : m*lda + k],
// B(k, n) at B[kBMN ? k*ldb + n : n*ldb + k].
template <bool kAMN, bool kBMN>
__device__ __forceinline__ void fma_tile(float (&acc)[4][4], const float* A,
                                         int64_t lda, const float* B,
                                         int64_t ldb, int64_t m0, int64_t n0,
                                         int64_t M, int64_t N, int64_t K) {
  __shared__ float as[kFK][kFM + 4], bs[kFK][kFN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int64_t k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int u = 0; u < kFM * kFK / 256; ++u) {
      const int e = tid + u * 256;
      // neighbouring threads on the operand's contiguous side
      const int am = kAMN ? e % kFM : e / kFK, ak = kAMN ? e / kFM : e % kFK;
      const int bn = kBMN ? e % kFN : e / kFK, bk = kBMN ? e / kFN : e % kFK;
      const int64_t gm = m0 + am, gak = k0 + ak, gn = n0 + bn, gbk = k0 + bk;
      as[ak][am] = gm < M && gak < K
                       ? A[kAMN ? gak * lda + gm : gm * lda + gak]
                       : 0.f;
      bs[bk][bn] = gn < N && gbk < K
                       ? B[kBMN ? gbk * ldb + gn : gn * ldb + gbk]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[k][4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[k][4 * tx + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// (a) in float32: block (x, y) is chunk columns 64x.. and token rows 64y..
__global__ void __launch_bounds__(256)
ce_logits_fma(const CeArgs<float> a, const Chunk<float> c) {
  const int64_t n0 = (int64_t)blockIdx.x * kFN, m0 = (int64_t)blockIdx.y * kFM;
  float acc[4][4];
  fma_tile<false, false>(acc, a.h, a.H, a.w + c.v0 * a.H, a.H, m0, n0, a.N,
                         c.len, a.H);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = m0 + 4 * ty + i;
    float lse, s;
    int yl;
    token(a, row, lse, s, yl);
    if (row >= a.N) continue;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int64_t col = n0 + 4 * tx + j;
      store2(c.d + row * c.vc + col,
             d_of(acc[i][j], c.v0 + col, a.V, lse, s, yl),
             d_of(acc[i][j + 1], c.v0 + col + 1, a.V, lse, s, yl));
    }
  }
}

// (b) and (c) in float32: blocks [0, dw_tiles) are dW tiles, the rest dh
__global__ void __launch_bounds__(256)
ce_grads_fma(const CeArgs<float> a, const Chunk<float> c) {
  const int hn = (int)tiles_of(a.H, kFN);
  const bool dw = (int)blockIdx.x < c.dw_tiles;
  const int tile = dw ? blockIdx.x : blockIdx.x - c.dw_tiles;
  const int64_t m0 = (int64_t)(tile / hn) * kFM, n0 = (tile % hn) * kFN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
  if (dw) {
    fma_tile<true, true>(acc, c.d, c.vc, a.h, a.H, m0, n0, c.len, a.H, a.N);
  } else {
    fma_tile<false, true>(acc, c.d, c.vc, a.w + c.v0 * a.H, a.H, m0, n0,
                          a.N, a.H, c.len);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = m0 + 4 * ty + i;
    if (row >= (dw ? c.len : a.N)) continue;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int col = (int)n0 + 4 * tx + j;
      if (col >= a.H) continue;
      if (dw) store2(c.dw + (c.v0 + row) * a.H + col, acc[i][j], acc[i][j + 1]);
      else dh_pair(a, c, row, col, acc[i][j], acc[i][j + 1]);
    }
  }
}

// let kernel take the warpgroup body's shared memory
template <class K>
cudaError_t allow_ring(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)pw::kSmem);
}

// chunk c's two launches, bfloat16
cudaError_t chunk_bf16(const CeArgs<bf16>& a, Chunk<bf16> c,
                       cudaStream_t st) {
  LogitMaps lm;
  GradMaps gm;
  const bf16* wc = a.w + c.v0 * a.H;
  if (!pw::operand_map(&lm.h, a.h, a.N, a.H, a.H, false) ||
      !pw::operand_map(&lm.w, wc, c.len, a.H, a.H, false) ||
      !pw::operand_map(&gm.d_mn, c.d, a.N, c.len, c.vc, true) ||
      !pw::operand_map(&gm.h_mn, a.h, a.N, a.H, a.H, true) ||
      !pw::operand_map(&gm.d_k, c.d, a.N, c.len, c.vc, false) ||
      !pw::operand_map(&gm.w_mn, wc, c.len, a.H, a.H, true))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_ring(ce_logits_wgmma);
  if (err != cudaSuccess) return err;
  ce_logits_wgmma<<<dim3((unsigned)tiles_of(c.len, pw::kBN),
                         (unsigned)tiles_of(a.N, pw::kBM)),
                    pw::kThreads, pw::kSmem, st>>>(lm, a, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t hn = tiles_of(a.H, pw::kBN);
  c.dw_tiles = (int)(tiles_of(c.len, pw::kBM) * hn);
  if ((err = allow_ring(ce_grads_wgmma)) != cudaSuccess)
    return err;
  ce_grads_wgmma<<<(unsigned)(c.dw_tiles + tiles_of(a.N, pw::kBM) * hn),
                   pw::kThreads, pw::kSmem, st>>>(gm, a, c);
  return cudaGetLastError();
}

// chunk c's two launches, float32
cudaError_t chunk_f32(const CeArgs<float>& a, Chunk<float> c,
                      cudaStream_t st) {
  ce_logits_fma<<<dim3((unsigned)tiles_of(c.len, kFN),
                       (unsigned)tiles_of(a.N, kFM)),
                  256, 0, st>>>(a, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t hn = tiles_of(a.H, kFN);
  c.dw_tiles = (int)(tiles_of(c.len, kFM) * hn);
  ce_grads_fma<<<(unsigned)(c.dw_tiles + tiles_of(a.N, kFM) * hn), 256, 0,
                 st>>>(a, c);
  return cudaGetLastError();
}

// every chunk in order, two launches each
template <typename T, class F>
int backward(const CeArgs<T>& a, T* dw, T* d, float* acc, int vc,
             const F& run_chunk, cudaStream_t st) {
  const int64_t chunks = tiles_of(a.V, vc);
  for (int64_t i = 0; i < chunks; ++i) {
    const int64_t v0 = i * vc;
    const Chunk<T> c{d, acc, dw, v0, (int)(a.V - v0 < vc ? a.V - v0 : vc), vc,
                     i == 0, i == chunks - 1, 0};
    const cudaError_t err = run_chunk(a, c, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// lse, ce [N] fp32 of h [N, H] against W [V, H] and labels y [N] (int32):
// one launch, float32 on ce_kernel, bfloat16 on ce_fwd_wgmma
int paddle_ce_fwd(const void* h, const void* w, const int* y, float* lse,
                  float* ce, long long N, long long V, int H, int dtype,
                  void* stream) {
  if (H <= 0 || H % 8 != 0 || N < 1 || V < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)forward(
        CeArgs<float>{static_cast<const float*>(h),
                      static_cast<const float*>(w), y, nullptr, nullptr, lse,
                      ce, nullptr, N, V, H},
        st);
  if (dtype == 1)
    return (int)forward_bf16(
        CeArgs<bf16>{static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                     y, nullptr, nullptr, lse, ce, nullptr, N, V, H},
        st);
  return (int)cudaErrorInvalidValue;
}

// dh [N, H] in h's type and dW [V, H] in W's from the forward's lse and s
// = where(y >= 0, dce, 0), over vocabulary chunks of vc columns (a
// multiple of kChunkStep, at most kChunkV). Scratch: d [N, vc] of h's
// type; acc fp32 [N, H] when V > vc (else unused). 2 * ceil(V / vc)
// launches.
int paddle_ce_bwd(const void* h, const void* w, const int* y,
                  const float* lse, const float* s, void* dh, void* dw,
                  void* d, float* acc, long long N, long long V, int H,
                  int vc, int dtype, void* stream) {
  if (H <= 0 || H % 8 != 0 || N < 1 || V < 1 || vc < kChunkStep ||
      vc > kChunkV || vc % kChunkStep != 0 || d == nullptr ||
      (V > vc && acc == nullptr) || tiles_of(N, kFM) > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward(
        CeArgs<float>{static_cast<const float*>(h),
                      static_cast<const float*>(w), y, lse, s, nullptr,
                      nullptr, static_cast<float*>(dh), N, V, H},
        static_cast<float*>(dw), static_cast<float*>(d), acc, vc, chunk_f32,
        st);
  if (dtype == 1)
    return backward(
        CeArgs<bf16>{static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                     y, lse, s, nullptr, nullptr, static_cast<bf16*>(dh), N,
                     V, H},
        static_cast<bf16*>(dw), static_cast<bf16*>(d), acc, vc, chunk_bf16,
        st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
