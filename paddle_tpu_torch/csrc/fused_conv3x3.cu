// The fused 3x3 convolution + batch-norm statistics pair of the ResNet
// bottleneck block, hand-written for Hopper (sm_90a): the BN-apply + ReLU
// of the block's first BN on the input, a 3x3 stride-1 SAME convolution,
// and the batch statistics of its output, then the backward of all three.
//
// Replaces the TPU kernels of paddle_tpu/kernels/fused_resnet.py:
//   paddle_conv3x3_bn_stats      _conv3x3_fwd_pallas :595
//                                (_conv3x3_fwd_kernel :480)
//   paddle_conv3x3_bn_stats_bwd  _conv3x3_bwd_pallas :628
//                                (_conv3x3_bwd_kernel :519)
//
// What they compute, for x [N,H,W,C] (NHWC), w9 [9C,O] in tap-major order
// (rows (dh*3+dw)*C ... +C hold tap (dh, dw)) and y [N,H,W,O]:
//   forward   a = T(relu(x*scale + shift)), zero outside the image (the
//             padding is zero in the activation domain, not relu(shift));
//             y = T(conv3x3(a, w9)) with fp32 sums; mean, var fp32 [O] of
//             the ROUNDED y over N*H*W.
//   backward  e = T(dy + perch + dvar2*(y - mean)), zero outside the image;
//             da = the transposed convolution of e (window tap (i, j) takes
//             weight tap (2-i, 2-j), transposed), fp32; pre = x*scale +
//             shift; gated = da where pre > 0; dx = T(gated*scale);
//             dscale = sum gated*x, dshift = sum gated over N*H*W;
//             dw[tap*C + c][o] = sum over pixels of a_window(tap)[c]*e[o],
//             fp32, with a recomputed from x.
// Neither a nor e reaches device memory: each is rebuilt from x (or dy, y)
// while a window is loaded into shared memory.
//
// Design for a card whose blocks run in parallel and in no order. The TPU
// kernel takes one image per grid step and keeps its sums in scratch across
// the steps. Here a block takes a tile of at most 128 output pixels: G
// slabs of R rows by Wt columns of one image each (the host picks R, Wt, G
// per shape: 2 rows of 56 at 56x56, two whole 7x7 images at 7x7). For each
// 32-channel slice of the input it copies the weights of all 9 taps for
// the slice into shared memory with cp.async, as they lie in w9, while it
// loads the slabs' windows, the slab plus a one-pixel halo (applying the
// prologue, zero where the window leaves the image; the loads of a batch
// are all in flight before the first is used), then runs the 9 shifted
// products out of the one window: an implicit GEMM with K = 9*C. The dx
// kernel is the same body over the e window with the taps flipped. dw
// (K = the pixels) has its own kernel: a block keeps all 9 taps of a
// 64 x 32 (c, o) tile, so each window it loads serves 9 products, and
// walks a chunk of pixel tiles; the chunks write fp32 partials that a
// fixed-order column sum adds. Batch statistics: each tile writes its
// count and its (mean, M2) per channel, two-pass over its rounded outputs,
// and a fixed-order Chan combine finishes them; dscale and dshift take
// fixed-order column sums over the tiles. No atomic anywhere: the bits
// repeat run to run.
//
// Products: bfloat16 runs on the tensor cores through warp-level
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), the TPU's MXU contract,
// its fragments loaded with ldmatrix (transposing where an operand lies
// depth-major: the forward's weights, dw's windows and e tile). float32
// computes the same fragments with fp32 FMAs on the CUDA cores (the fp32
// path holds the kernels' indexing against fp32 references). Elementwise
// steps that end in a rounding to the storage type use __fmul_rn/__fadd_rn,
// as in fused_resnet.cu, so they round where the plain PyTorch version
// rounds.
//
// What bounds them on the H100: at ResNet-50's 3x3 shapes (b128 at
// 224x224) the products, 29.6 GFLOP per forward and 59.2 per backward at
// every stage, bound the work at 0.030 and 0.060 ms against 989 TFLOP/s;
// at layer1 the bytes come close (x and y, 103 MB, 0.031 ms). This version
// is bound by neither: a slice's loads, its products and the statistics
// run in turn within a block (no double buffering), the windows are
// rebuilt for every 64 output channels, and mma.sync reaches about two
// thirds of the wgmma rate at best. wgmma with TMA is the next step.
//
// Shapes: any N, H, W >= 1; C and O multiples of 8 (rows stay 16-byte
// aligned). Element types float32 and bfloat16 (dtype 0 / 1), the same for
// x, w9, y, dy and dx; scale, shift and the statistics are fp32.
#include "fused_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 128;   // output pixels of a tile, at most
constexpr int kWin = 512;   // window positions of a tile, at most
constexpr int kBN = 64;     // output channels of a forward / dx tile
constexpr int kKC = 32;     // input channels of a window slice

// shared-memory row stride of a K-slice of `cols` elements: 16 bytes of
// padding keep the fragment loads of a warp on distinct banks
template <typename T>
__host__ __device__ constexpr int stride_of(int cols) {
  return cols + 16 / (int)sizeof(T);
}

// ------------------------------------------------------------ geometry

// A tile is G slabs; slab s of tile t is slab t*G + s of the whole batch,
// image n's slabs run over `bands` bands of R rows and `ctiles` column
// tiles of Wt columns. A slab's window is (R+2) x (Wt+2) positions.
struct Geo {
  int N, H, W, R, Wt, G, bands, ctiles;
  __device__ int slabs() const { return N * bands * ctiles; }
  __device__ int pix() const { return G * R * Wt; }
  __device__ int win_w() const { return Wt + 2; }
  __device__ int slab_win() const { return (R + 2) * (Wt + 2); }
  __device__ int positions() const { return G * slab_win(); }
  // (image, first row, first column) of global slab sg
  __device__ void slab(int sg, int& n, int& h0, int& w0) const {
    const int per = bands * ctiles;
    n = sg / per;
    const int b = (sg - n * per) / ctiles;
    h0 = b * R;
    w0 = (sg - n * per - b * ctiles) * Wt;
  }
};

// Output pixel p of tile `tile`: its window position for tap (0, 0), its
// row in the [N*H*W] pixel order, and whether it lies in the image.
struct Pixel {
  int base;
  int64_t at;
  bool ok;
};

__device__ __forceinline__ Pixel pixel_of(const Geo& g, int tile, int p) {
  Pixel px{0, 0, false};
  if (p >= g.pix()) return px;
  const int rw = g.R * g.Wt;
  const int s = p / rw, q = p - s * rw, r = q / g.Wt, wc = q - r * g.Wt;
  px.base = s * g.slab_win() + r * g.win_w() + wc;
  const int sg = tile * g.G + s;
  if (sg >= g.slabs()) return px;
  int n, h0, w0;
  g.slab(sg, n, h0, w0);
  const int hh = h0 + r, ww = w0 + wc;
  px.ok = hh < g.H && ww < g.W;
  px.at = ((int64_t)n * g.H + hh) * g.W + ww;
  return px;
}

// the pixel row that window position `pos` of tile `tile` reads, or -1
// where the window leaves the image (or the batch)
__device__ __forceinline__ int64_t window_source(const Geo& g, int tile,
                                                 int pos) {
  const int sw = g.slab_win();
  const int s = pos / sw, q = pos - s * sw;
  const int wr = q / g.win_w(), wc = q - wr * g.win_w();
  const int sg = tile * g.G + s;
  if (sg >= g.slabs()) return -1;
  int n, h0, w0;
  g.slab(sg, n, h0, w0);
  const int hh = h0 + wr - 1, ww = w0 + wc - 1;
  if (hh < 0 || hh >= g.H || ww < 0 || ww >= g.W) return -1;
  return ((int64_t)n * g.H + hh) * g.W + ww;
}

// elements of 8 a thread loads from each of kTensors tensors in a fill
// batch: four 16-byte loads in flight
template <typename T, int kTensors>
__host__ __device__ constexpr int batch_of() {
  return 8 / (kTensors * (int)sizeof(T));
}

// v[ni][j] (column ni*8 + 2(lane%4) + j of the warp's 32) summed over the
// tile's rows: the 8 row groups of a warp by shuffle, then the 4 row warps
// in turn through red[4][kBN]. Every thread gets the totals of its
// columns. Fixed order throughout.
__device__ __forceinline__ void column_sum(float* red, int wm, int wn,
                                           float (&v)[4][2]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = v[ni][j];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      v[ni][j] = s;
      if (lane < 4) red[wm * kBN + wn * 32 + ni * 8 + 2 * t + j] = s;
    }
  __syncthreads();
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = wn * 32 + ni * 8 + 2 * t + j;
      v[ni][j] = red[c] + red[kBN + c] + red[2 * kBN + c] + red[3 * kBN + c];
    }
  __syncthreads();
}

// ------------------------------------------------------------ fwd and dx

template <typename T>
struct ConvArgs {
  const T* src;        // the window's source: x (forward) or dy (dx)
  const T* y;          // dx: the forward's output
  const float* k0;     // per window channel: scale (forward) or perch
  const float* k1;     //                     shift           or dvar2
  const float* k2;     //                     -               or mean
  const T* w9;         // [9C, O]
  T* out;              // y [.., O] (forward) or dx [.., C]
  const T* x;          // dx: the forward's input, for the gate
  const float* scale;  // dx: the gate's scale, shift [C]
  const float* shift;
  float* p0;           // tile partials [tiles, cout]: mean or dscale
  float* p1;           //                              M2 or dshift
  float* pcnt;         // forward: each tile's pixel count [tiles]
  int cin, cout;       // window and output channels: (C, O) or (O, C)
};

// shared memory of a forward / dx tile: the windows [positions][kKC], the
// 9 taps' weights (forward [tap][kKC][kBN], dx [tap][kBN][kKC]), the
// column sums [4][kBN] and each window position's source [positions]
template <typename T>
__host__ __device__ constexpr int conv_weight_elems() {
  return 9 * kKC * stride_of<T>(kBN) > 9 * kBN * stride_of<T>(kKC)
             ? 9 * kKC * stride_of<T>(kBN)
             : 9 * kBN * stride_of<T>(kKC);
}

template <typename T>
size_t conv_smem(const Geo& g) {
  const size_t positions = (size_t)g.G * (g.R + 2) * (g.Wt + 2);
  return (positions * stride_of<T>(kKC) + conv_weight_elems<T>()) *
             sizeof(T) +
         4 * kBN * sizeof(float) + positions * sizeof(int);
}

// One tile of kPix pixels x kBN output channels: the forward (y, the
// tile's statistics) or, with kDx, da gated into dx (the tile's dscale and
// dshift partials). 8 warps: 4 over the pixels (32 each) x 2 over the
// channels (32 each). For each kKC-channel slice the weights are copied
// with cp.async while the windows load in batches, then the 9 taps run
// out of shared memory.
template <typename T, bool kDx>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const ConvArgs<T> a, const Geo geo) {
  constexpr int KS = stride_of<T>(kKC);   // window rows; dx weight rows
  constexpr int SB = stride_of<T>(kBN);   // forward weight rows
  constexpr int U = batch_of<T, kDx ? 2 : 1>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int positions = geo.positions();
  T* win = reinterpret_cast<T*>(smem);
  T* wts = win + (size_t)positions * KS;
  float* red = reinterpret_cast<float*>(wts + conv_weight_elems<T>());
  int* srct = reinterpret_cast<int*>(red + 4 * kBN);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
  const int lj = lane >> 3, lr = lane & 7;   // this lane's ldmatrix row
  const int tile = blockIdx.x, n0 = blockIdx.y * kBN;
  const int cin = a.cin, cout = a.cout;
  const int k8 = (tid % (kKC / 8)) * 8;      // this thread's fill channels

  for (int p = tid; p < positions; p += kThreads)
    srct[p] = window_source(geo, tile, p);
  Pixel px[2][2];
  int lb[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      px[mi][h] = pixel_of(geo, tile, wm * 32 + mi * 16 + h * 8 + g);
    lb[mi] = pixel_of(geo, tile, wm * 32 + mi * 16 + 8 * (lj & 1) + lr).base;
  }
  __syncthreads();

  float acc[2][4][4] = {};
  const int total = positions * (kKC / 8);
  for (int k0 = 0; k0 < cin; k0 += kKC) {
    // the 9 taps' weights for this slice, copied as they lie; window tap
    // (i, j) of dx takes weight tap (2-i, 2-j), read transposed
    if (kDx) {
      for (int i = tid; i < 9 * kBN * (kKC / 8); i += kThreads) {
        const int kk = (i % (kKC / 8)) * 8, n = (i / (kKC / 8)) % kBN;
        const int tap = i / (kBN * (kKC / 8));
        const bool ok = n0 + n < cout && k0 + kk < cin;
        cp_async8(wts + (tap * kBN + n) * KS + kk,
                  a.w9 + (ok ? ((size_t)(8 - tap) * cout + n0 + n) * cin +
                                   k0 + kk
                             : 0),
                  ok);
      }
    } else {
      for (int i = tid; i < 9 * kKC * (kBN / 8); i += kThreads) {
        const int nn = (i % (kBN / 8)) * 8, c = (i / (kBN / 8)) % kKC;
        const int tap = i / (kKC * (kBN / 8));
        const bool ok = k0 + c < cin && n0 + nn < cout;
        cp_async8(wts + (tap * kKC + c) * SB + nn,
                  a.w9 + (ok ? ((size_t)tap * cin + k0 + c) * cout + n0 + nn
                             : 0),
                  ok);
      }
    }
    // the windows of this slice, prologue applied, 0 outside the image
    const int ch = k0 + k8;
    const bool ch_ok = ch < cin;
    float c0[8], c1[8], c2[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      c0[e] = ch_ok ? a.k0[ch + e] : 0.f;
      c1[e] = ch_ok ? a.k1[ch + e] : 0.f;
      c2[e] = kDx && ch_ok ? a.k2[ch + e] : 0.f;
    }
    for (int i0 = tid; i0 < total; i0 += U * kThreads) {
      Vec8<T> xv[U], yv[U];
      int at[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * kThreads;
        at[u] = i < total && ch_ok ? srct[i / (kKC / 8)] : -1;
        if (at[u] >= 0) {
          xv[u].load(a.src + (size_t)at[u] * cin + ch);
          if (kDx) yv[u].load(a.y + (size_t)at[u] * cin + ch);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= total) continue;
        float v[8] = {};
        if (at[u] >= 0) {
          xv[u].get(v);
          if (kDx) {
            float yf[8];
            yv[u].get(yf);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e] = effective<T>(v[e], yf[e], c0[e], c1[e], c2[e]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = prologue<T>(v[e], c0[e], c1[e]);
          }
        }
        store8(win + (i / (kKC / 8)) * KS + k8, v);
      }
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * geo.win_w() + tap % 3;
#pragma unroll
      for (int ks = 0; ks < kKC; ks += 16) {
        if constexpr (sizeof(T) == 2) {
          uint32_t af[2][4], bfr[4][2];
          load_a<2, false>(af, [&](int mi) {
            return win + (lb[mi] + off) * KS + ks + 8 * (lj >> 1);
          });
          load_b<4, !kDx>(bfr, [&](int np) {
            return kDx ? wts + (tap * kBN + wn * 32 + 16 * np + 8 * (lj >> 1) +
                                lr) * KS + ks + 8 * (lj & 1)
                       : wts + (tap * kKC + ks + 8 * (lj & 1) + lr) * SB +
                             wn * 32 + 16 * np + 8 * (lj >> 1);
          });
          mma_tile(acc, af, bfr);
        } else {
          fma_step<2, 4>(
              acc,
              [&](int mi, int h, int k) {
                return win + (px[mi][h].base + off) * KS + ks + k;
              },
              [&](int n, int k) {
                return kDx ? wts + (tap * kBN + wn * 32 + n) * KS + ks + k
                           : wts + (tap * kKC + ks + k) * SB + wn * 32 + n;
              });
        }
      }
    }
    __syncthreads();
  }

  float s0[4][2] = {}, s1[4][2] = {};
  if (!kDx) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[mi][ni][r] =
              round_to(acc[mi][ni][r], static_cast<const T*>(nullptr));
          if (px[mi][r >> 1].ok) s0[ni][r & 1] += acc[mi][ni][r];
        }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!px[mi][h].ok) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t;
        if (col >= cout) continue;
        float* v = &acc[mi][ni][2 * h];
        const size_t o = (size_t)px[mi][h].at * cout + col;
        if (kDx) {
          float xv[2];
          load2(a.x + o, xv);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float sc = a.scale[col + j];
            const float pre = __fadd_rn(__fmul_rn(xv[j], sc), a.shift[col + j]);
            const float gated = pre > 0.f ? v[j] : 0.f;
            v[j] = __fmul_rn(gated, sc);
            s0[ni][j] = fmaf(gated, xv[j], s0[ni][j]);
            s1[ni][j] += gated;
          }
        }
        store2(a.out + o, v[0], v[1]);
      }
    }

  const size_t prow = (size_t)tile * cout;
  if (kDx) {
    column_sum(red, wm, wn, s0);
    column_sum(red, wm, wn, s1);
  } else {
    // the tile's count, mean and M2 (two-pass over the rounded outputs)
    const int cnt = __syncthreads_count(tid < kPix &&
                                        pixel_of(geo, tile, tid).ok);
    column_sum(red, wm, wn, s0);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) s0[ni][j] /= cnt;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (!px[mi][r >> 1].ok) continue;
          const float d = acc[mi][ni][r] - s0[ni][r & 1];
          s1[ni][r & 1] = fmaf(d, d, s1[ni][r & 1]);
        }
    column_sum(red, wm, wn, s1);
    if (tid == 0) a.pcnt[tile] = (float)cnt;
  }
  if (wm == 0 && lane < 4) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      if (col < cout) {
        store2(a.p0 + prow + col, s0[ni][0], s0[ni][1]);
        store2(a.p1 + prow + col, s1[ni][0], s1[ni][1]);
      }
    }
  }
}

// ------------------------------------------------------------ dw

constexpr int kDC = 64;   // the dw tile's input channels (2 warps of 32)
constexpr int kDO = 32;   // and output channels (4 warps of 8)

// shared memory of a dw block: the windows [positions][kDC], the e tile
// [kPix][kDO], the coefficients (scale, shift [kDC]; perch, dvar2, mean
// [kDO]) and the tables (pixel -> window base and -> pixel row, window
// position -> source row)
template <typename T>
size_t dw_smem(const Geo& g) {
  const size_t positions = (size_t)g.G * (g.R + 2) * (g.Wt + 2);
  return (positions * stride_of<T>(kDC) + kPix * stride_of<T>(kDO)) *
             sizeof(T) +
         (2 * kDC + 3 * kDO) * sizeof(float) +
         (2 * kPix + positions) * sizeof(int);
}

// dw partial [9 taps][64 of C][32 of O] summed over this block's chunk of
// pixel tiles: for each tile the a windows (x with the prologue, 0 outside
// the image) and the e tile (0 for pixels outside the image) are loaded,
// then dw[tap][c][o] += sum_p a_window(p, tap)[c] * e[p][o] for all 9
// taps out of the one window. Written to part[chunk][9C][O]. 8 warps: 2
// over c (32 each) x 4 over o (8 each), each warp all 9 taps.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_dw_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                  const float* __restrict__ perch,
                  const float* __restrict__ dvar2,
                  const float* __restrict__ mean, const T* __restrict__ x,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, float* __restrict__ part,
                  const Geo geo, int C, int O, int tiles,
                  int tiles_per_chunk) {
  constexpr int KS = stride_of<T>(kDC);
  constexpr int ES = stride_of<T>(kDO);
  constexpr int U = batch_of<T, 1>(), UE = batch_of<T, 2>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int positions = geo.positions();
  T* win = reinterpret_cast<T*>(smem);
  T* es = win + (size_t)positions * KS;
  float* coef = reinterpret_cast<float*>(es + kPix * ES);
  int* ptab = reinterpret_cast<int*>(coef + 2 * kDC + 3 * kDO);
  int* prow = ptab + kPix;
  int* srct = prow + kPix;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  const int lj = lane >> 3, lr = lane & 7;
  const int o0 = blockIdx.x * kDO, c0 = blockIdx.y * kDC;
  const int first = blockIdx.z * tiles_per_chunk;
  const int last = min(tiles, first + tiles_per_chunk);
  const int kp = (geo.pix() + 15) & ~15;   // pixels, padded to the step
  const int c8 = (tid % (kDC / 8)) * 8, o8 = (tid % (kDO / 8)) * 8;

  if (tid < kPix) ptab[tid] = pixel_of(geo, 0, tid).base;
  if (tid < kDC) {
    const bool ok = c0 + tid < C;
    coef[tid] = ok ? scale[c0 + tid] : 0.f;
    coef[kDC + tid] = ok ? shift[c0 + tid] : 0.f;
  }
  if (tid < kDO) {
    const bool ok = o0 + tid < O;
    coef[2 * kDC + tid] = ok ? perch[o0 + tid] : 0.f;
    coef[2 * kDC + kDO + tid] = ok ? dvar2[o0 + tid] : 0.f;
    coef[2 * kDC + 2 * kDO + tid] = ok ? mean[o0 + tid] : 0.f;
  }
  const float* sc = coef + c8;
  const float* sh = coef + kDC + c8;
  const float* pc = coef + 2 * kDC + o8;
  const float* dv = pc + kDO;
  const float* mn = pc + 2 * kDO;
  float acc[9][2][1][4] = {};
  for (int tile = first; tile < last; ++tile) {
    for (int p = tid; p < positions; p += kThreads)
      srct[p] = window_source(geo, tile, p);
    if (tid < kPix) {
      const Pixel px = pixel_of(geo, tile, tid);
      prow[tid] = px.ok ? (int)px.at : -1;
    }
    __syncthreads();
    // the a windows: x with the prologue, 0 outside the image
    const int wtotal = positions * (kDC / 8);
    for (int i0 = tid; i0 < wtotal; i0 += U * kThreads) {
      Vec8<T> xv[U];
      int at[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * kThreads;
        at[u] = i < wtotal && c0 + c8 < C ? srct[i / (kDC / 8)] : -1;
        if (at[u] >= 0) xv[u].load(x + (size_t)at[u] * C + c0 + c8);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= wtotal) continue;
        float v[8] = {};
        if (at[u] >= 0) {
          xv[u].get(v);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = prologue<T>(v[e], sc[e], sh[e]);
        }
        store8(win + (i / (kDC / 8)) * KS + c8, v);
      }
    }
    // the e tile, 0 for pixels outside the image and the padding
    const int etotal = kp * (kDO / 8);
    for (int i0 = tid; i0 < etotal; i0 += UE * kThreads) {
      Vec8<T> dv8[UE], yv[UE];
      int at[UE];
#pragma unroll
      for (int u = 0; u < UE; ++u) {
        const int i = i0 + u * kThreads;
        at[u] = i < etotal && o0 + o8 < O ? prow[i / (kDO / 8)] : -1;
        if (at[u] >= 0) {
          dv8[u].load(dy + (size_t)at[u] * O + o0 + o8);
          yv[u].load(y + (size_t)at[u] * O + o0 + o8);
        }
      }
#pragma unroll
      for (int u = 0; u < UE; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= etotal) continue;
        float v[8] = {};
        if (at[u] >= 0) {
          float yf[8];
          dv8[u].get(v);
          yv[u].get(yf);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = effective<T>(v[e], yf[e], pc[e], dv[e], mn[e]);
        }
        store8(es + (i / (kDO / 8)) * ES + o8, v);
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int p0 = 0; p0 < kp; p0 += 16) {
      if constexpr (sizeof(T) == 2) {
        uint32_t bfr[1][2];
        load_b<1, true>(bfr, [&](int) {
          return es + (p0 + 8 * (lj & 1) + lr) * ES + wn * 8 + 8 * (lj >> 1);
        });
        const T* wa = win + ptab[p0 + 8 * (lj >> 1) + lr] * KS + wm * 32 +
                      8 * (lj & 1);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int off = ((tap / 3) * geo.win_w() + tap % 3) * KS;
          uint32_t af[2][4];
          load_a<2, true>(af, [&](int mi) { return wa + off + mi * 16; });
          mma_tile(acc[tap], af, bfr);
        }
      } else {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int off = (tap / 3) * geo.win_w() + tap % 3;
          fma_step<2, 1>(
              acc[tap],
              [&](int mi, int h, int k) {
                return win + (ptab[p0 + k] + off) * KS + wm * 32 + mi * 16 +
                       h * 8 + g;
              },
              [&](int n, int k) { return es + (p0 + k) * ES + wn * 8 + n; });
        }
      }
    }
  }
  float* out = part + (size_t)blockIdx.z * 9 * C * O;
  const int o = o0 + wn * 8 + 2 * t;
  if (o >= O) return;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wm * 32 + mi * 16 + h * 8 + g;
        if (c < C)
          store2(out + ((size_t)tap * C + c) * O + o, acc[tap][mi][0][2 * h],
                 acc[tap][mi][0][2 * h + 1]);
      }
}

// ------------------------------------------------------------ launches

// each tile's pixel count, for stats_finish_kernel
struct TileCounts {
  const float* cnt;
  __device__ float operator()(int t) const { return cnt[t]; }
};

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int forward(const ConvArgs<T>& a, const Geo& g, int tiles, float* mean,
            float* var, cudaStream_t st) {
  const size_t smem = conv_smem<T>(g);
  cudaError_t err = allow_smem(conv3x3_kernel<T, false>, smem);
  if (err != cudaSuccess) return err;
  conv3x3_kernel<T, false>
      <<<dim3(tiles, tiles_of(a.cout, kBN)), kThreads, smem, st>>>(a, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return stats_finish(a.p0, a.p1, tiles, a.cout, TileCounts{a.pcnt}, mean,
                      var, st);
}

template <typename T>
int backward(const ConvArgs<T>& a, const Geo& g, int tiles, float* dw,
             float* dw_part, float* dscale, float* dshift, int chunks,
             int tiles_per_chunk, cudaStream_t st) {
  const int C = a.cout, O = a.cin;
  size_t smem = conv_smem<T>(g);
  cudaError_t err = allow_smem(conv3x3_kernel<T, true>, smem);
  if (err != cudaSuccess) return err;
  conv3x3_kernel<T, true>
      <<<dim3(tiles, tiles_of(C, kBN)), kThreads, smem, st>>>(a, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = dw_smem<T>(g);
  if ((err = allow_smem(conv3x3_dw_kernel<T>, smem)) != cudaSuccess)
    return err;
  // one chunk writes dw itself; more write partials for the column total
  const dim3 grid(tiles_of(O, kDO), tiles_of(C, kDC), chunks);
  conv3x3_dw_kernel<T><<<grid, kThreads, smem, st>>>(
      a.src, a.y, a.k0, a.k1, a.k2, a.x, a.scale, a.shift,
      chunks == 1 ? dw : dw_part, g, C, O, tiles, tiles_per_chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (chunks > 1 &&
      (err = column_total(dw_part, chunks, 9 * C * O, dw, st)) != cudaSuccess)
    return err;
  if ((err = column_total(a.p0, tiles, C, dscale, st)) != cudaSuccess)
    return err;
  return column_total(a.p1, tiles, C, dshift, st);
}

// the geometry the host chose, checked against the kernels' limits;
// returns the tile count, or 0 when it is not one the kernels take
int tiles_for(Geo& g) {
  if (g.N < 1 || g.H < 1 || g.W < 1 || g.R < 1 || g.Wt < 1 || g.G < 1 ||
      g.R > g.H || g.Wt > g.W || g.G * g.R * g.Wt > kPix ||
      g.G * (g.R + 2) * (g.Wt + 2) > kWin ||
      (int64_t)g.N * g.H * g.W > INT32_MAX)   // pixel rows fit an int
    return 0;
  g.bands = tiles_of(g.H, g.R);
  g.ctiles = tiles_of(g.W, g.Wt);
  return tiles_of(g.N * g.bands * g.ctiles, g.G);
}

bool channels_ok(int C, int O) {
  return C > 0 && O > 0 && C % 8 == 0 && O % 8 == 0;
}

}  // namespace

// Forward. x [N,H,W,C], w9 [9C,O], y [N,H,W,O] contiguous, of dtype 0
// (float32) or 1 (bfloat16); scale, shift fp32 [C]; mean, var fp32 [O].
// The tiling: slabs of R rows x Wt columns, G slabs a tile (R*Wt*G <= 128,
// G*(R+2)*(Wt+2) <= 512); tiles = ceil(N*ceil(H/R)*ceil(W/Wt) / G).
// Scratch: part_mean, part_m2 fp32 [tiles, O], part_count fp32 [tiles].
// Two launches (the convolution with its tile statistics, then the
// fixed-order combine). Returns the cudaError_t of the launches.
extern "C" int paddle_conv3x3_bn_stats(
    const void* x, const float* scale, const float* shift, const void* w9,
    void* y, float* part_mean, float* part_m2, float* part_count,
    float* mean, float* var, int dtype, int N, int H, int W, int C, int O,
    int R, int Wt, int G, void* stream) {
  Geo g{N, H, W, R, Wt, G, 0, 0};
  const int tiles = tiles_for(g);
  if (!tiles || !channels_ok(C, O)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const ConvArgs<float> a{
        static_cast<const float*>(x), nullptr, scale, shift, nullptr,
        static_cast<const float*>(w9), static_cast<float*>(y), nullptr,
        nullptr, nullptr, part_mean, part_m2, part_count, C, O};
    return forward(a, g, tiles, mean, var, st);
  }
  if (dtype == 1) {
    const ConvArgs<bf16> a{
        static_cast<const bf16*>(x), nullptr, scale, shift, nullptr,
        static_cast<const bf16*>(w9), static_cast<bf16*>(y), nullptr,
        nullptr, nullptr, part_mean, part_m2, part_count, C, O};
    return forward(a, g, tiles, mean, var, st);
  }
  return cudaErrorInvalidValue;
}

// Backward. dy, y [N,H,W,O]; x [N,H,W,C]; w9 [9C,O]; scale, shift fp32
// [C]; perch, dvar2, mean fp32 [O]; the tiling as for the forward.
// Outputs dx [N,H,W,C] (the input dtype), dw fp32 [9C,O], dscale, dshift
// fp32 [C]. Scratch: dw_part fp32 [chunks, 9C, O] when chunks > 1;
// ds_part, dt_part fp32 [tiles, C]. The dw kernel's chunk c takes tiles
// c*tiles_per_chunk ... (c+1)*tiles_per_chunk - 1, and chunks *
// tiles_per_chunk >= tiles. Returns the cudaError_t of the launches.
extern "C" int paddle_conv3x3_bn_stats_bwd(
    const void* dy, const void* y, const void* x, const float* scale,
    const float* shift, const void* w9, const float* perch,
    const float* dvar2, const float* mean, void* dx, float* dw,
    float* dw_part, float* dscale, float* dshift, float* ds_part,
    float* dt_part, int dtype, int N, int H, int W, int C, int O, int R,
    int Wt, int G, int chunks, int tiles_per_chunk, void* stream) {
  Geo g{N, H, W, R, Wt, G, 0, 0};
  const int tiles = tiles_for(g);
  if (!tiles || !channels_ok(C, O) || chunks < 1 || tiles_per_chunk < 1 ||
      (int64_t)chunks * tiles_per_chunk < tiles || chunks > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const ConvArgs<float> a{
        static_cast<const float*>(dy), static_cast<const float*>(y), perch,
        dvar2, mean, static_cast<const float*>(w9), static_cast<float*>(dx),
        static_cast<const float*>(x), scale, shift, ds_part, dt_part,
        nullptr, O, C};
    return backward(a, g, tiles, dw, dw_part, dscale, dshift, chunks,
                    tiles_per_chunk, st);
  }
  if (dtype == 1) {
    const ConvArgs<bf16> a{
        static_cast<const bf16*>(dy), static_cast<const bf16*>(y), perch,
        dvar2, mean, static_cast<const bf16*>(w9), static_cast<bf16*>(dx),
        static_cast<const bf16*>(x), scale, shift, ds_part, dt_part,
        nullptr, O, C};
    return backward(a, g, tiles, dw, dw_part, dscale, dshift, chunks,
                    tiles_per_chunk, st);
  }
  return cudaErrorInvalidValue;
}
