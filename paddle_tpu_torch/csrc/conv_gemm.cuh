// The tile body shared by the fused conv + BN-statistics kernels: the 1x1
// convolutions of fused_resnet.cu (a matrix product whose epilogue gives
// the batch statistics, with an optional BN-apply + ReLU prologue, and its
// two backwards) and the 3x3 pair of fused_conv3x3.cu on its implicit
// GEMM route (kTap: the forward, dx and dw with A gathered by tap from the
// materialized activation and effective gradient).
//
// One body serves every product. A block of 8 warps owns a 128 x 128
// output tile (each warp 64 x 32) and walks the contraction in 32-deep
// slices through a ring of three cp.async groups: slice s is multiplied
// while slices s+1 and s+2 are in flight. An operand copied as it lies (w,
// wt, x without the prologue, and every operand of the 3x3 route) lands
// straight in its ring; an operand with an elementwise step (the 1x1
// prologue's a, the effective e) lands raw in per-thread slots of shared
// memory, and after the products of slice s each thread takes the step on
// its own slots of slice s+1 and writes the slice the products read, so
// nothing waits in registers. The forward is y = a @ w, dx is e @ wt (wt
// [N,K]), both with A row-major and B depth-major; dw is a^T @ e
// contracting over the rows, both operands depth-major. The forward and
// dx write their tile through shared memory in 16-byte rows (dx's gate
// reads x from there too). The grid puts the column tiles of one row tile
// next to each other, so the blocks that share an A row tile run
// together and the second reads it from L2.
//
// Products: bfloat16 runs on the tensor cores through warp-level
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) on bf16 fragments loaded
// from shared memory with ldmatrix (transposed for every depth-major
// operand); float32 runs the same tile body with fp32 FMAs (fma_step).
// Elementwise steps that end in a rounding to the storage type use
// __fmul_rn/__fadd_rn, so they round where the plain PyTorch versions
// round. No atomics: every cross-block sum is a fixed-order column total.
#pragma once

#include <type_traits>

#include "fused_common.cuh"
#include "mma_common.cuh"

namespace {
namespace paddle_gemm {

constexpr int kThreads = 256;
constexpr int kBM = 128;   // tile rows: of M (forward, dx; the statistics'
                           // row tile) or of K (dw)
constexpr int kBN = 128;   // tile columns: of N (forward, dw) or of K (dx)
constexpr int kBK = 32;    // contraction slice: of K, of N, or of rows (dw)
constexpr int kWM = 2;     // warps over the tile's rows (64 each)
constexpr int kWN = 4;     // and its columns (32 each)
constexpr int kMI = kBM / kWM / 16;   // m16 tiles of a warp
constexpr int kNI = kBN / kWN / 8;    // n8 tiles of a warp
constexpr int kStages = 3;            // slices in flight: the one multiplied
                                      // and the next two

enum Kind { kFwd, kDx, kDw };

// shared-memory row padding: 16 bytes keep a warp's fragment loads on
// distinct banks
template <typename T>
__host__ __device__ constexpr int pad_of() {
  return 16 / (int)sizeof(T);
}

// ------------------------------------------------------------ staging

// Rows [r0, r1) and columns [c0, c1) of a row-major source with row
// stride ld: the part of a slice that lies inside the matrix.
struct Window {
  int64_t ld;
  int r0, r1, c0, c1;
};

// This thread's chunks of 8 elements of an R x C slice (C contiguous in
// the source and in shared memory, rows padded): column c, rows r + u*kRS.
template <typename T, int R, int C>
struct Chunks {
  static constexpr int kCS = C / 8, kRS = kThreads / kCS, kU = R / kRS;
  static constexpr int kS = C + pad_of<T>();   // shared-memory row stride
  static constexpr int kElems = R * kS;        // the slice in shared memory
  int r, c;
  __device__ __forceinline__ Chunks()
      : r(threadIdx.x / kCS), c(threadIdx.x % kCS * 8) {}
  __device__ __forceinline__ bool ok(const Window& w, int u) const {
    return w.c0 + c < w.c1 && w.r0 + r + u * kRS < w.r1;
  }
  __device__ __forceinline__ int64_t at(const Window& w, int u) const {
    return (int64_t)(w.r0 + r + u * kRS) * w.ld + w.c0 + c;
  }
};

// the slice into dst by cp.async, zeros outside the window
template <typename T, int R, int C>
__device__ __forceinline__ void copy_slice(T* dst, const T* src,
                                           const Window& w) {
  using G = Chunks<T, R, C>;
  const G g;
#pragma unroll
  for (int u = 0; u < G::kU; ++u) {
    const bool ok = g.ok(w, u);
    cp_async8(dst + (g.r + u * G::kRS) * G::kS + g.c,
              src + (ok ? g.at(w, u) : 0), ok);
  }
}

// An operand with an elementwise step, in two halves: land_raw() copies
// this thread's chunks as they lie into its own slots of a landing zone
// (cp.async: nothing held in registers while they fly); once they are in,
// transform() applies the step and writes the slice the products read. No
// barrier between the two: no other thread reads those slots. kE: the
// effective gradient e = T(s0 + k0 + k1*(s1 - k2)) from s0 = dy, s1 = y;
// else the prologue a = T(relu(s0*k0 + k1)). The coefficients k0..k2
// point at the slice's first column; zeros outside the window. The step
// is taken in fp32 and rounded to T once, by the store.
template <typename T, int R, int C, bool kE>
struct Staged {
  using G = Chunks<T, R, C>;
  static constexpr int kZone = (kE ? 2 : 1) * G::kU * kThreads * 8;

  // this thread's slot for chunk u of source i
  static __device__ __forceinline__ int slot(int i, int u) {
    return ((i * G::kU + u) * kThreads + (int)threadIdx.x) * 8;
  }

  static __device__ __forceinline__ void land_raw(T* zone, const T* s0,
                                                  const T* s1,
                                                  const Window& w) {
    const G g;
#pragma unroll
    for (int u = 0; u < G::kU; ++u) {
      const bool ok = g.ok(w, u);
      const int64_t at = ok ? g.at(w, u) : 0;
      cp_async8(zone + slot(0, u), s0 + at, ok);
      if constexpr (kE) cp_async8(zone + slot(1, u), s1 + at, ok);
    }
  }

  static __device__ __forceinline__ void transform(
      T* dst, const T* zone, const float* k0, const float* k1,
      const float* k2, const Window& w) {
    const G g;
    float a[8] = {}, b[8] = {}, m[8] = {};
    if (w.c0 + g.c < w.c1) {
      load8(k0 + g.c, a);
      load8(k1 + g.c, b);
      if constexpr (kE) load8(k2 + g.c, m);
    }
#pragma unroll
    for (int u = 0; u < G::kU; ++u) {
      float v[8] = {};
      if (g.ok(w, u)) {
        load8(zone + slot(0, u), v);
        if constexpr (kE) {
          float yv[8];
          load8(zone + slot(1, u), yv);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = effective_unrounded(v[e], yv[e], a[e], b[e], m[e]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = prologue_unrounded(v[e], a[e], b[e]);
        }
      }
      store8(dst + (g.r + u * G::kRS) * G::kS + g.c, v);
    }
  }
};

// v[ni][j] (column wn*32 + ni*8 + 2(lane%4) + j of the tile) summed over
// the tile's rows: the 8 row groups of a warp by shuffle, then the kWM
// row warps in turn through red[kWM][kBN]. Every thread gets the totals
// of its columns. Fixed order throughout.
__device__ __forceinline__ void column_sum(float* red, int wm, int wn,
                                           float (&v)[kNI][2]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = v[ni][j];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) red[wm * kBN + wn * 32 + ni * 8 + 2 * t + j] = s;
    }
  __syncthreads();
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = wn * 32 + ni * 8 + 2 * t + j;
      float s = red[c];
#pragma unroll
      for (int w = 1; w < kWM; ++w) s += red[w * kBN + c];
      v[ni][j] = s;
    }
  __syncthreads();
}

// ------------------------------------------------------------ the kernel

template <typename T>
struct Args {
  const T* x;            // [M,K]
  const float* scale;    // the prologue's [K] (prologue 1 only)
  const float* shift;
  const T* w;            // forward: w [K,N]; dx: wt [N,K]
  const T* dy;           // backward: dy, y [M,N]
  const T* y;
  const float* perch;    // backward: e's coefficients [N]
  const float* dvar2;
  const float* mean;
  void* out;             // y [M,N] or dx [M,K] (T); dw partials
                         // [chunks][K][N] (fp32)
  float* p0;             // row-tile partials [tiles][columns]: mean or
  float* p1;             // dscale, M2 or dshift
  int M, K, N;
  int chunk_rows;        // dw: rows a chunk (blockIdx.z) sums over
};

// A kernel's operands and shared memory. Each operand has a ring of
// kStages slots: its slices as copied (an operand taken as it lies) or its
// landing zones (a staged one), and a staged operand two more slices, the
// ones its step writes. Then the column sums' [kWM][kBN]. The output tile
// [kBM][kBN + pad] reuses the operands' memory after the last product.
template <typename T, int kKind, bool kPro, bool kTap = false>
struct Layout {
  static constexpr bool kTA = kKind == kDw;   // A depth-major
  static constexpr int AR = kTA ? kBK : kBM, AC = kTA ? kBM : kBK;
  using GA = Chunks<T, AR, AC>;
  using GB = Chunks<T, kBK, kBN>;
  using StA = Staged<T, AR, AC, kKind == kDx>;
  using StB = Staged<T, kBK, kBN, true>;      // dw's e
  // a tap-gathered operand (kTap) arrives with its step taken
  static constexpr bool kStageA = !kTap && (kKind == kDx || kPro);
  static constexpr bool kStageB = !kTap && kKind == kDw;
  static constexpr int kARing = kStageA ? StA::kZone : GA::kElems;
  static constexpr int kBRing = kStageB ? StB::kZone : GB::kElems;
  static constexpr int kA = kStages * kARing + (kStageA ? 2 * GA::kElems : 0);
  static constexpr int kB = kStages * kBRing + (kStageB ? 2 * GB::kElems : 0);
  static constexpr size_t kBytes =
      (kA + kB) * sizeof(T) + kWM * kBN * sizeof(float);
  static_assert(kBM * (kBN + pad_of<T>()) <= kA + kB,
                "the output tile must fit the operands' memory");
};

// ------------------------------------------------------------ 3x3 taps

// n / d for 0 <= n < 2^31 by a multiply and a shift, d >= 1 fixed for a
// launch (the round-up method: m = floor(2^32 (2^s - d) / d) + 1, s =
// ceil(log2 d)); made on the host
struct FastDiv {
  uint32_t m;
  int s;
  static FastDiv of(int d) {
    int s = 0;
    while ((1u << s) < (uint32_t)d) ++s;
    const uint64_t one = 1;
    return {(uint32_t)(((one << 32) * ((one << s) - d)) / d + 1), s};
  }
  __device__ __forceinline__ int operator()(int n) const {
    return (int)((__umulhi((uint32_t)n, m) + (uint32_t)n) >> s);
  }
};

// The 3x3 convolutions' arguments (kTap): the images' height and width,
// the channels of the tap-gathered source (dx: e's O; dw: a's C), and
// their dividers.
template <typename T>
struct TapArgs : Args<T> {
  int img_h, img_w, taps_ld;
  FastDiv div_h, div_w, div_ld;
};

template <typename T, bool kTap>
using ArgsOf = typename std::conditional<kTap, TapArgs<T>, Args<T>>::type;

// Column k of a 3x3 A operand reads tap t = k / taps_ld, channel k %
// taps_ld: pixel p shifted by (t/3 - 1, t%3 - 1) within its image, or
// zeros where that leaves the image (cp.async with src-size 0). ok: the
// element lies inside the operand. src [M pixels][taps_ld] pixel-major.
template <typename T>
__device__ __forceinline__ void tap_copy(T* dst, const T* src,
                                        const TapArgs<T>& a, int p, int k,
                                        bool ok) {
  const int t = a.div_ld(k), ch = k - t * a.taps_ld;
  const int q = a.div_w(p), ww = p - q * a.img_w;
  const int hh = q - a.div_h(q) * a.img_h;
  const int dh = t / 3 - 1, dw = t % 3 - 1;
  ok = ok && hh + dh >= 0 && hh + dh < a.img_h && ww + dw >= 0 &&
       ww + dw < a.img_w;
  cp_async8(dst, src + (ok ? ((int64_t)p + dh * a.img_w + dw) * a.taps_ld +
                                 ch
                           : 0),
            ok);
}

// The R x C slice of a 3x3 A operand in window w, gathered by tap from
// src: its rows are pixels and its columns k = t*taps_ld + channel. dx
// (row-major [pixels][9*O]): the tile's pixels by the slice's depth; dw
// (depth-major [pixels][9*C]): the chunk's pixels by the tile's dw rows.
template <typename T, int R, int C>
__device__ __forceinline__ void gather_taps(T* dst, const T* src,
                                           const TapArgs<T>& a,
                                           const Window& w) {
  using G = Chunks<T, R, C>;
  const G g;
#pragma unroll
  for (int u = 0; u < G::kU; ++u) {
    const int p = w.r0 + g.r + u * G::kRS, k = w.c0 + g.c;
    tap_copy(dst + (g.r + u * G::kRS) * G::kS + g.c, src, a, p, k,
             g.ok(w, u));
  }
}

// One 128 x 128 tile of the forward (y and the tile's statistics), of dx
// (with the prologue: gated, and the tile's dscale/dshift partials) or of
// a dw chunk's partial. Slice i is multiplied while slices i+1 and i+2 are
// in flight (cp.async groups); a staged operand's step for slice i+1 runs
// after the products of slice i. kTap: the 3x3 convolution's forward
// (kFwd), dx (kDx, kPro: the gate) or dw, A gathered by tap (gather_taps)
// from the materialized a (a.x) or e (a.dy), B copied as it lies: the
// weights w9 [9*C][O] or the flipped ones [9*O][C] (a.w), or e [M][O]
// (a.dy); nothing is staged.
template <typename T, int kKind, bool kPro, bool kTap = false>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
mm_stats_kernel(const ArgsOf<T, kTap> a) {
  using L = Layout<T, kKind, kPro, kTap>;
  using GA = typename L::GA;
  using GB = typename L::GB;
  constexpr bool kTA = L::kTA;
  constexpr int SA = GA::kS, SB = GB::kS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring_a = reinterpret_cast<T*>(smem);
  T* use_a = ring_a + kStages * L::kARing;   // a staged A's two slices
  T* ring_b = ring_a + L::kA;
  T* use_b = ring_b + kStages * L::kBRing;
  float* red = reinterpret_cast<float*>(ring_b + L::kB);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % kWM, wn = warp / kWM, g = lane >> 2, t = lane & 3;
  const int lj = lane >> 3, lr = lane & 7;   // this lane's ldmatrix row
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rows_total = kKind == kDw ? a.K : a.M;
  const int cols_total = kKind == kDx ? a.K : a.N;
  // the contraction: K (forward), N (dx) or this chunk's rows (dw)
  const int d0 = kKind == kDw ? blockIdx.z * a.chunk_rows : 0;
  const int d1 = kKind == kDw   ? min(a.M, d0 + a.chunk_rows)
                 : kKind == kFwd ? a.K
                                 : a.N;
  const int slices = (d1 - d0 + kBK - 1) / kBK;
  // a warp whose rows or columns all lie outside the output skips the
  // products (the narrow layer1 shapes)
  const bool live = m0 + wm * 64 < rows_total && n0 + wn * 32 < cols_total;

  // the windows of the slice at depth d: A [rows][depth] (dw: [depth][K]),
  // B [depth][columns]
  auto win_a = [&](int d) -> Window {
    if constexpr (kKind == kFwd) return {a.K, m0, a.M, d, a.K};
    else if constexpr (kKind == kDx) return {a.N, m0, a.M, d, a.N};
    else return {a.K, d, d1, m0, a.K};
  };
  auto win_b = [&](int d) -> Window {
    if constexpr (kKind == kFwd) return {a.N, d, a.K, n0, a.N};
    else if constexpr (kKind == kDx) return {a.K, d, a.N, n0, a.K};
    else return {a.N, d, d1, n0, a.N};
  };
  // slice i's copies into ring slot i % kStages
  auto issue = [&](int i) {
    const int d = d0 + i * kBK, s = i % kStages;
    T* A = ring_a + s * L::kARing;
    T* B = ring_b + s * L::kBRing;
    if constexpr (kKind == kDx)
      L::StA::land_raw(A, a.dy, a.y, win_a(d));
    else if constexpr (kPro)
      L::StA::land_raw(A, a.x, nullptr, win_a(d));
    else
      copy_slice<T, L::AR, L::AC>(A, a.x, win_a(d));
    if constexpr (kKind == kDw)
      L::StB::land_raw(B, a.dy, a.y, win_b(d));
    else
      copy_slice<T, kBK, kBN>(B, a.w, win_b(d));
  };
  // kTap: slice i's copies, A gathered by tap
  auto issue_tap = [&](int i) {
    if constexpr (kTap) {
      const int d = d0 + i * kBK, s = i % kStages;
      T* A = ring_a + s * L::kARing;
      T* B = ring_b + s * L::kBRing;
      gather_taps<T, L::AR, L::AC>(A, kKind == kDx ? a.dy : a.x, a,
                                   win_a(d));
      copy_slice<T, kBK, kBN>(B, kKind == kDw ? a.dy : a.w, win_b(d));
    }
  };
  // slice i's elementwise steps, from its landing zones into slice i % 2
  // of the staged operands
  auto land = [&](int i) {
    const int d = d0 + i * kBK, s = i % kStages;
    T* A = use_a + (i & 1) * GA::kElems;
    const T* zone_a = ring_a + s * L::kARing;
    if constexpr (kKind == kFwd && kPro)
      L::StA::transform(A, zone_a, a.scale + d, a.shift + d, nullptr,
                        win_a(d));
    else if constexpr (kKind == kDx)
      L::StA::transform(A, zone_a, a.perch + d, a.dvar2 + d, a.mean + d,
                        win_a(d));
    else if constexpr (kKind == kDw && kPro)
      L::StA::transform(A, zone_a, a.scale + m0, a.shift + m0, nullptr,
                        win_a(d));
    if constexpr (kKind == kDw)
      L::StB::transform(use_b + (i & 1) * GB::kElems,
                        ring_b + s * L::kBRing, a.perch + n0, a.dvar2 + n0,
                        a.mean + n0, win_b(d));
  };

  float acc[kMI][kNI][4] = {};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < slices) {
      if constexpr (kTap) issue_tap(i);
      else issue(i);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();   // slice 0 is in
  if constexpr (!kTap) land(0);
  __syncthreads();
  for (int i = 0; i < slices; ++i) {
    if (i + kStages - 1 < slices) {
      if constexpr (kTap) issue_tap(i + kStages - 1);
      else issue(i + kStages - 1);
    }
    cp_async_commit();   // empty groups at the end keep the count
    if (live) {
      const T* A = L::kStageA ? use_a + (i & 1) * GA::kElems
                              : ring_a + i % kStages * L::kARing;
      const T* B = L::kStageB ? use_b + (i & 1) * GB::kElems
                              : ring_b + i % kStages * L::kBRing;
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        if constexpr (sizeof(T) == 2) {
          uint32_t af[kMI][4], bfr[kNI][2];
          load_a<kMI, kTA>(af, [&](int mi) {
            return kTA ? A + (ks + 8 * (lj >> 1) + lr) * SA + wm * 64 +
                             mi * 16 + 8 * (lj & 1)
                       : A + (wm * 64 + mi * 16 + 8 * (lj & 1) + lr) * SA +
                             ks + 8 * (lj >> 1);
          });
          load_b<kNI, true>(bfr, [&](int np) {
            return B + (ks + 8 * (lj & 1) + lr) * SB + wn * 32 + 16 * np +
                   8 * (lj >> 1);
          });
          mma_tile(acc, af, bfr);
        } else {
          fma_step<kMI, kNI>(
              acc,
              [&](int mi, int h, int k) {
                const int r = wm * 64 + mi * 16 + 8 * h + g;
                return kTA ? A + (ks + k) * SA + r : A + r * SA + ks + k;
              },
              [&](int n, int k) { return B + (ks + k) * SB + wn * 32 + n; });
        }
      }
    }
    cp_async_wait<kStages - 2>();   // slice i + 1 is in
    if constexpr (!kTap)
      if (i + 1 < slices) land(i + 1);
    __syncthreads();
  }

  // ---- epilogues. acc[mi][ni][2h + j] is tile row wm*64 + mi*16 + 8h + g,
  // column wn*32 + ni*8 + 2t + j
  const int rows = min(kBM, rows_total - m0);
  if constexpr (kKind == kDw) {
    float* out = static_cast<float*>(a.out) + (size_t)blockIdx.z * a.K * a.N;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + mi * 16 + 8 * h + g;
        if (r >= rows) continue;
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const int col = n0 + wn * 32 + ni * 8 + 2 * t;
          if (col < a.N)
            store2(out + (size_t)(m0 + r) * a.N + col, acc[mi][ni][2 * h],
                   acc[mi][ni][2 * h + 1]);
        }
      }
    return;
  }
  // y or dx: the tile's final values go to shared memory in the fragment
  // layout, then out in 16-byte rows. With the prologue, dx's tile first
  // holds x's, copied in 16-byte rows, which the gate reads in place.
  T* tile = ring_a;
  constexpr int OS = kBN + pad_of<T>();
  if constexpr (kKind == kDx && kPro) {
    copy_slice<T, kBM, kBN>(tile, a.x, Window{a.K, m0, a.M, n0, a.K});
    cp_async_wait_all();
    __syncthreads();
  }
  float s0[kNI][2] = {}, s1[kNI][2] = {};
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni) {
    const int c = wn * 32 + ni * 8 + 2 * t, col = n0 + c;
    const bool col_ok = col < cols_total;
    float sc[2] = {}, sh[2] = {};
    if (kKind == kDx && kPro && col_ok) {
      load2(a.scale + col, sc);
      load2(a.shift + col, sh);
    }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + mi * 16 + 8 * h + g;
        float* v = &acc[mi][ni][2 * h];
        if (kKind == kFwd) {
          // y rounded before its statistics
          v[0] = round_to(v[0], static_cast<const T*>(nullptr));
          v[1] = round_to(v[1], static_cast<const T*>(nullptr));
          if (r < rows && col_ok) s0[ni][0] += v[0], s0[ni][1] += v[1];
        } else if (kPro && r < rows && col_ok) {
          float xv[2];
          load2(tile + r * OS + c, xv);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float pre = __fadd_rn(__fmul_rn(xv[j], sc[j]), sh[j]);
            const float gated = pre > 0.f ? v[j] : 0.f;
            v[j] = __fmul_rn(gated, sc[j]);
            s0[ni][j] = fmaf(gated, xv[j], s0[ni][j]);
            s1[ni][j] += gated;
          }
        }
        store2(tile + r * OS + c, v[0], v[1]);
      }
  }
  __syncthreads();
  {
    constexpr int kEU = 16 / (int)sizeof(T), kUR = kBN / kEU;
    T* out = static_cast<T*>(a.out);
    for (int i = tid; i < kBM * kUR; i += kThreads) {
      const int r = i / kUR, c = i % kUR * kEU;
      if (r < rows && n0 + c < cols_total)
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * cols_total + n0 +
                                  c) =
            *reinterpret_cast<const uint4*>(tile + r * OS + c);
    }
  }
  if (kKind == kDx && !kPro) return;
  column_sum(red, wm, wn, s0);
  if (kKind == kFwd) {
    // the tile's mean, then M2 two-pass about it
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) s0[ni][j] /= rows;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (wm * 64 + mi * 16 + 8 * h + g >= rows) continue;
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float d = acc[mi][ni][2 * h + j] - s0[ni][j];
            s1[ni][j] = fmaf(d, d, s1[ni][j]);
          }
      }
  }
  column_sum(red, wm, wn, s1);
  if (wm == 0 && lane < 4) {
    const size_t prow = (size_t)blockIdx.y * cols_total;
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      if (col < cols_total) {
        store2(a.p0 + prow + col, s0[ni][0], s0[ni][1]);
        store2(a.p1 + prow + col, s1[ni][0], s1[ni][1]);
      }
    }
  }
}

}  // namespace paddle_gemm
}  // namespace
