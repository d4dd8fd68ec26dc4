// The fused LM head + cross entropy, hand-written for Hopper (sm_90a): the
// per-row cross entropy of softmax(h @ W^T) against integer labels, and its
// gradients for h and W, without the [N, V] logits ever reaching device
// memory.
//
// Replaces the TPU kernels of paddle_tpu/kernels/fused_ce.py:
//   paddle_ce_fwd     _fwd :101 (_fwd_kernel :58)
//   paddle_ce_bwd_dh  _bwd :223, _bwd_dh_kernel :154
//   paddle_ce_bwd_dw  _bwd :223, _bwd_dw_kernel :188
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
// Design for a card whose blocks run in parallel and in no order. The TPU
// kernels walk a (row block, vocab block) grid in order and carry their
// sums in VMEM scratch from step to step. Here every kernel is one body:
// a block owns a tile of kOwn rows of one operand ("owner": h rows for the
// forward and dh, W rows for dW) and walks every kOth-row tile of the other
// operand in a fixed order. Both tiles are held over the full hidden width
// in shared memory (cp.async copies, zero past the edge), so the owner tile
// is read once and each other tile once per block. A tile's logits
// [kOwn, kOth] come from one product over H; then
//   forward  each thread keeps an online (max, sum-exp, gold) for its rows
//            over its own columns; at the end the four lanes of a row and
//            the four column warps combine them in a fixed order;
//   dh, dW   d goes to shared memory rounded to T, and each warp adds
//            d @ (its 96-column slice of the other tile) to the owner's
//            [kOwn, H] gradient rows, held in registers over the whole walk.
// dW's block walks all the row tiles of h, so no partial sums cross blocks:
// no atomics anywhere, and the bits repeat run to run.
//
// Hidden sizes past kMaxH (768, the widest a tile pair holds in shared
// memory) take the kernels' wide instantiation (kWide), which streams H
// in slices of kMaxH through the same tiles: each tile's logits sum the
// slices' products in fp32, in slice order, before the softmax step, the
// owner tile reloaded with each slice. dh and dW take one kMaxH-column
// slice of their output per block, on a second grid dimension, and each
// such block recomputes the tile's logits over the whole H, so the
// backward's two logit products become 2 * ceil(H / 768) (at H 1024, six
// products in all, against the four of the narrow kernels and the three
// a minimal backward needs). A block whose output columns are not the
// last slice reloads the other tile's columns it multiplies. At H <= 768
// the narrow instantiation runs, the code of the kernels before slices.
//
// Products: bfloat16 runs on the tensor cores through warp-level
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate; mma_common.cuh), the
// fragments loaded with ldmatrix (transposed for the other tile in the
// second product, which it reads depth-major). float32 computes the same
// fragments with fp32 FMAs on the CUDA cores.
//
// What bounds them on the H100: at gpt2-small's LM head (N 16,368, H 768,
// V 50,257, bf16) the forward's one product is 1.26e12 FLOPs, 1.278 ms at
// 989 TFLOP/s; the backward needs three products at least (one recompute
// of the logits, dh, dW), 3.83 ms; the TPU design, kept here, recomputes
// the logits in both backward kernels, four products. The bytes (h and W
// once, 102 MB) take 0.031 ms. This version is bound by neither: with a
// full-width tile pair filling shared memory, one block of 8 warps runs on
// an SM, too few to hide the latency of the ldmatrix -> mma chains and of
// the softmax between them (bringing each tile in four cp.async groups
// under the products measured no gain on an H100), and mma.sync reaches
// about two thirds of the wgmma rate at best. Larger warp tiles with
// double-buffered fragments, then wgmma with TMA multicast, are the next
// steps.
//
// Shapes: any N and V >= 1; H a multiple of 8 (the wrapper pads another H
// with zero columns, which add exact zeros to every product); h, W
// contiguous, 16-byte aligned, of one element type: float32 or bfloat16
// (dtype 0 / 1). 64-bit offsets throughout.
#include "mma_common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 over owner rows x 4 over others
constexpr int kNI = 12;        // n8 tiles of gradient columns a warp keeps
constexpr int kSlice = 8 * kNI;         // 96 gradient columns a warp
constexpr int kMaxH = 8 * kSlice;       // 768: the widest H slice
constexpr float kNegInf = -1e30f;

enum Mode { kFwd = 0, kDh = 1, kDw = 2 };

__host__ __device__ inline int64_t tiles_of(int64_t n, int64_t t) {
  return (n + t - 1) / t;
}

template <typename T, int kMode>
struct Tile {
  static constexpr bool kBf = sizeof(T) == 2;
  static constexpr int kOwn = (kBf && kMode == kFwd) ? 64 : 32;
  static constexpr int kOth = kBf ? 64 : 32;
  static constexpr int kStride = kMaxH + 16 / (int)sizeof(T);  // O and X
  static constexpr int kDStride = kOth + 16 / (int)sizeof(T);   // d
  static constexpr int kLMI = kOwn / 32;  // m16 tiles of a warp's logits
  static constexpr int kLNI = kOth / 32;  // n8 tiles of a warp's logits
  static constexpr int kStats = 64;       // token statistics slots
  static constexpr size_t kSmem =
      (size_t)(kOwn + kOth) * kStride * sizeof(T) +
      (kMode == kFwd ? 0 : (size_t)kOwn * kDStride * sizeof(T)) +
      3 * kStats * sizeof(float) + 4 * kStats * 3 * sizeof(float);
};

template <typename T>
struct CeArgs {
  const T* h;         // [N, H]
  const T* w;         // [V, H]
  const int* y;       // [N]
  const float* lse;   // backward: the forward's lse [N]
  const float* s;     // backward: where(y >= 0, dce, 0) [N]
  float* out_lse;     // forward: lse [N]
  float* out_ce;      // forward: ce [N]
  T* out;             // dh [N, H] or dW [V, H]
  int64_t N, V;
  int H;
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

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

// H slice sl of kMaxH columns (the last one shorter), as the wide kernels
// stream it: columns [c0, c0 + w), w rounded up to 16
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

// the token statistics of rows [t0, t0 + n) into slots [0, n): label (-1
// past N) and, for the backward, lse and s (0 past N, so d is 0 there)
template <int kMode>
__device__ __forceinline__ void token_stats(const int* y, const float* lse,
                                            const float* s, int64_t t0,
                                            int n, int64_t N, int* sy,
                                            float* slse, float* ss) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int64_t t = t0 + i;
    const bool ok = t < N;
    sy[i] = ok ? y[t] : -1;
    if (kMode != kFwd) {
      slse[i] = ok ? lse[t] : 0.f;
      ss[i] = ok ? s[t] : 0.f;
    }
  }
}

// acc = logits of the warp's [kLMI*16, kLNI*8] piece of the tile: the owner
// rows os against the other rows xs over depth [0, hk) (kZero), or acc +=
// that (an H slice's share, the wide kernels)
template <typename T, int kMode, bool kZero = true>
__device__ __forceinline__ void tile_logits(
    float (&acc)[Tile<T, kMode>::kLMI][Tile<T, kMode>::kLNI][4],
    const T* os, const T* xs, int hk, int wm, int wn) {
  using G = Tile<T, kMode>;
  constexpr int S = G::kStride;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int lj = lane >> 3, lr = lane & 7;
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
    if constexpr (G::kBf) {
      uint32_t af[G::kLMI][4], bfr[G::kLNI][2];
      load_a<G::kLMI, false>(af, [&](int mi) {
        return os + (m0 + mi * 16 + 8 * (lj & 1) + lr) * S + ks +
               8 * (lj >> 1);
      });
      load_b<G::kLNI, false>(bfr, [&](int np) {
        return xs + (n0 + 16 * np + 8 * (lj >> 1) + lr) * S + ks +
               8 * (lj & 1);
      });
      mma_tile(acc, af, bfr);
    } else {
      fma_step<G::kLMI, G::kLNI>(
          acc,
          [&](int mi, int hh, int k) {
            return os + (m0 + mi * 16 + 8 * hh + g) * S + ks + k;
          },
          [&](int n, int k) { return xs + (n0 + n) * S + ks + k; });
    }
  }
}

// (m, l) merged with another running (max, sum-exp)
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

// kWide: H > kMaxH, streamed in slices (see the note above); otherwise
// the whole H is one tile width.
template <typename T, int kMode, bool kWide>
__global__ void __launch_bounds__(kThreads, 1) ce_kernel(const CeArgs<T> a) {
  using G = Tile<T, kMode>;
  constexpr int S = G::kStride, DS = G::kDStride;
  constexpr int LMI = G::kLMI, LNI = G::kLNI;
  extern __shared__ __align__(16) unsigned char smem[];
  T* os = reinterpret_cast<T*>(smem);
  T* xs = os + G::kOwn * S;
  T* ds = xs + G::kOth * S;
  float* slse = reinterpret_cast<float*>(
      ds + (kMode == kFwd ? 0 : G::kOwn * DS));
  float* ss = slse + G::kStats;
  int* sy = reinterpret_cast<int*>(ss + G::kStats);
  float* comb = reinterpret_cast<float*>(sy + G::kStats);  // [4][64][3]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  const int lj = lane >> 3, lr = lane & 7;
  const int H = a.H, hk = (H + 15) / 16 * 16;
  // the output's H slice (dh, dW): blockIdx.y; all of H when !kWide
  const HSlice out_sl(kMode == kFwd ? 0 : (int)blockIdx.y, H);
  const int out_c0 = kWide ? out_sl.c0 : 0, out_w = kWide ? out_sl.w : H;
  const int64_t nown = kMode == kDw ? a.V : a.N;
  const int64_t noth = kMode == kDw ? a.N : a.V;
  const int64_t own0 = (int64_t)blockIdx.x * G::kOwn;
  const T* own_src = kMode == kDw ? a.w : a.h;
  const T* oth_src = kMode == kDw ? a.h : a.w;

  if constexpr (!kWide) fill(os, own_src, own0, G::kOwn, nown, H, hk, S);
  if (kMode != kDw)
    token_stats<kMode>(a.y, a.lse, a.s, own0, G::kOwn, a.N, sy, slse, ss);

  // forward: running (max, sum-exp, gold) of this thread's rows
  float rm[LMI][2], rl[LMI][2], rg[LMI][2];
#pragma unroll
  for (int mi = 0; mi < LMI; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      rm[mi][hh] = kNegInf, rl[mi][hh] = 0.f, rg[mi][hh] = 0.f;
  // backward: this warp's gradient columns [col0, col0 + kSlice) of the
  // output slice, for the owner's kOwn rows
  float gacc[2][kNI][4];
  const int col0 = warp * kSlice;
  if constexpr (kMode != kFwd) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) gacc[mi][ni][r] = 0.f;
  }

  const int64_t tiles = tiles_of(noth, G::kOth);
  for (int64_t it = 0; it < tiles; ++it) {
    const int64_t oth0 = it * G::kOth;
    float acc[LMI][LNI][4];
    if constexpr (!kWide) {
      fill(xs, oth_src, oth0, G::kOth, noth, H, hk, S);
      if (kMode == kDw)
        token_stats<kMode>(a.y, a.lse, a.s, oth0, G::kOth, a.N, sy, slse,
                           ss);
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
        fill_slice(os, own_src, own0, G::kOwn, nown, H, hs, S);
        fill_slice(xs, oth_src, oth0, G::kOth, noth, H, hs, S);
        if (kMode == kDw && sl == 0)
          token_stats<kMode>(a.y, a.lse, a.s, oth0, G::kOth, a.N, sy, slse,
                             ss);
        cp_async_wait_all();
        __syncthreads();
        tile_logits<T, kMode, false>(acc, os, xs, hs.wk, wm, wn);
      }
      if (kMode != kFwd && out_sl.c0 + out_sl.w < H) {
        // the gradient product reads the other tile's columns of the
        // output slice, which a later slice overwrote
        __syncthreads();
        fill_slice(xs, oth_src, oth0, G::kOth, noth, H, out_sl, S);
        cp_async_wait_all();   // visible after the barrier below
      }
    }

    if constexpr (kMode == kFwd) {
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
              const int64_t v =
                  oth0 + wn * (G::kOth / 4) + ni * 8 + 2 * t + j;
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
    } else {
      // d = (p - onehot) * s, rounded to T, into ds [kOwn][kOth]
#pragma unroll
      for (int mi = 0; mi < LMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < LNI; ++ni)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = wm * (G::kOwn / 2) + mi * 16 + 8 * hh + g;
            const int col = wn * (G::kOth / 4) + ni * 8 + 2 * t;
            float dv[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              // token slot and vocab column of this logit
              const int slot = kMode == kDh ? row : col + j;
              const int64_t v = kMode == kDh ? oth0 + col + j : own0 + row;
              const float lg = acc[mi][ni][2 * hh + j];
              float d = 0.f;
              if (v < a.V) {
                const float p = expf(lg - slse[slot]);
                const float oh = v == (int64_t)sy[slot] ? 1.f : 0.f;
                d = __fmul_rn(__fsub_rn(p, oh), ss[slot]);
              }
              dv[j] = d;
            }
            store2(ds + row * DS + col, dv[0], dv[1]);
          }
      __syncthreads();
      // gradient rows += d @ (the other tile's columns of this warp)
      if (col0 < out_w) {
#pragma unroll
        for (int ks = 0; ks < G::kOth; ks += 16) {
          if constexpr (G::kBf) {
            uint32_t af[2][4], bfr[kNI][2];
            load_a<2, false>(af, [&](int mi) {
              return ds + (mi * 16 + 8 * (lj & 1) + lr) * DS + ks +
                     8 * (lj >> 1);
            });
            load_b<kNI, true>(bfr, [&](int np) {
              return xs + (ks + 8 * (lj & 1) + lr) * S + col0 + 16 * np +
                     8 * (lj >> 1);
            });
            mma_tile(gacc, af, bfr);
          } else {
            fma_step<2, kNI>(
                gacc,
                [&](int mi, int hh, int k) {
                  return ds + (mi * 16 + 8 * hh + g) * DS + ks + k;
                },
                [&](int n, int k) { return xs + (ks + k) * S + col0 + n; });
          }
        }
      }
    }
    __syncthreads();  // xs, ds and the statistics are rewritten next tile
  }

  if constexpr (kMode == kFwd) {
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
  } else if (col0 < out_w) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t row = own0 + mi * 16 + 8 * hh + g;
        if (row >= nown) continue;
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const int col = col0 + ni * 8 + 2 * t;
          if (col < out_w)
            store2(a.out + row * H + out_c0 + col, gacc[mi][ni][2 * hh],
                   gacc[mi][ni][2 * hh + 1]);
        }
      }
  }
}

template <typename T, int kMode, bool kWide>
cudaError_t start(const CeArgs<T>& a, cudaStream_t st) {
  using G = Tile<T, kMode>;
  auto kernel = ce_kernel<T, kMode, kWide>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = tiles_of(kMode == kDw ? a.V : a.N, G::kOwn);
  // dh and dW: one block per (owner tile, output H slice)
  const int out_slices = kMode == kFwd ? 1 : (a.H + kMaxH - 1) / kMaxH;
  kernel<<<dim3((unsigned)blocks, out_slices), kThreads, G::kSmem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int kMode>
cudaError_t launch(const CeArgs<T>& a, cudaStream_t st) {
  if (a.H <= 0 || a.H % 8 != 0 || a.N < 1 || a.V < 1)
    return cudaErrorInvalidValue;
  return a.H > kMaxH ? start<T, kMode, true>(a, st)
                     : start<T, kMode, false>(a, st);
}

template <int kMode>
int dispatch(const void* h, const void* w, const int* y, const float* lse,
             const float* s, float* out_lse, float* out_ce, void* out,
             long long N, long long V, int H, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    CeArgs<float> a{static_cast<const float*>(h),
                    static_cast<const float*>(w), y, lse, s, out_lse, out_ce,
                    static_cast<float*>(out), N, V, H};
    return (int)launch<float, kMode>(a, st);
  }
  if (dtype == 1) {
    CeArgs<bf16> a{static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                   y, lse, s, out_lse, out_ce, static_cast<bf16*>(out), N, V,
                   H};
    return (int)launch<bf16, kMode>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// lse, ce [N] fp32 of h [N, H] against W [V, H] and labels y [N] (int32)
int paddle_ce_fwd(const void* h, const void* w, const int* y, float* lse,
                  float* ce, long long N, long long V, int H, int dtype,
                  void* stream) {
  return dispatch<kFwd>(h, w, y, nullptr, nullptr, lse, ce, nullptr, N, V,
                        H, dtype, stream);
}

// dh [N, H] in h's type from the forward's lse and s = where(y >= 0, dce, 0)
int paddle_ce_bwd_dh(const void* h, const void* w, const int* y,
                     const float* lse, const float* s, void* dh, long long N,
                     long long V, int H, int dtype, void* stream) {
  return dispatch<kDh>(h, w, y, lse, s, nullptr, nullptr, dh, N, V, H, dtype,
                       stream);
}

// dW [V, H] in W's type, likewise
int paddle_ce_bwd_dw(const void* h, const void* w, const int* y,
                     const float* lse, const float* s, void* dw, long long N,
                     long long V, int H, int dtype, void* stream) {
  return dispatch<kDw>(h, w, y, lse, s, nullptr, nullptr, dw, N, V, H, dtype,
                       stream);
}

}  // extern "C"
