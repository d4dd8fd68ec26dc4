// Shared fp32 body of the flash-attention decode and chunk kernels, and
// of the forward's CUDA-core route (float32, and head_dim 256).
//
// One thread block owns BQ query rows of one head and streams the keys
// and values through shared memory in tiles of kBlockK rows, keeping a
// running row maximum m, normaliser l and fp32 output accumulator in
// registers (online softmax, base 2: queries are pre-scaled by
// scale * log2(e), so scores feed exp2f directly). The decode kernels
// (flash_decode.cu, flash_decode_paged.cu: decode, chunk, paged decode)
// run this ONE routine, so their numerics cannot drift apart (the JAX
// package keeps the same property with its shared _decode_accumulate
// body). The bf16 / fp16 forward at head_dim <= 128 does not: it runs on
// the tensor cores (flash_fwd.cu, flash_mma.cuh) and rounds P to the
// input type before P V, where this body keeps P in fp32.
//
// Thread layout: 128 threads = NRG row groups x NCG column groups. A
// thread owns TR consecutive query rows; for scores it owns the TC key
// columns cg, cg + NCG, ...; for the output it owns the TD head-dim
// columns cg, cg + NCG, .... The same thread owns the same rows in both
// phases, so the per-row softmax statistics never leave registers; the
// NCG threads of one row are consecutive lanes of one warp and reduce
// with shuffles. Shared arrays are padded by one float per row, which
// makes every access pattern below free of bank conflicts (or a
// broadcast).
//
// Masking: key column c is valid for a row iff c <= lim, where the
// caller derives lim from the causal offset and the key length. A row
// whose lim is below 0 never accumulates and writes zeros, as the TPU
// kernels do for fully masked rows. Columns past n_keys are never read:
// the tile loader zero-fills them, so masked products are exact zeros.
//
// Int8 caches: the key and value rows are int8 with one bf16 scale per
// column (position) in side arrays, and the dequantisation fuses into
// the tile, as in the JAX package's _decode_accumulate: the tile's 64
// key and 64 value scales are staged as fp32 in shared memory, each
// score column is multiplied by its key scale before the mask
// (s = (q . k_int8) * k_scale), the softmax normaliser sums the
// UNSCALED p, and p * v_scale goes into the p @ v product. A wide K/V
// row never exists anywhere.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace paddle_flash {

constexpr int kThreads = 128;
constexpr int kBlockK = 64;
// fp32 shared floats past Layout::kFloats that an int8 cache's tile
// scales take (its 64 key scales, then its 64 value scales)
constexpr int kScaleFloats = 2 * kBlockK;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

template <int BQ, int D>
struct Layout {
  static constexpr int NRG = BQ >= 16 ? 16 : BQ;  // row groups
  static constexpr int NCG = kThreads / NRG;      // column groups
  static constexpr int TR = BQ / NRG;             // rows per thread
  static constexpr int TC = kBlockK / NCG;        // score columns per thread
  static constexpr int TD = D / NCG;              // output columns per thread
  static constexpr int DP = D + 1;                // padded q/k/v row
  static constexpr int KP = kBlockK + 1;          // padded p row
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + BQ * DP;
  static constexpr int kV = kK + kBlockK * DP;
  static constexpr int kP = kV + kBlockK * DP;
  static constexpr int kFloats = kP + BQ * KP;
  static constexpr size_t kBytes = kFloats * sizeof(float);
  static_assert(NRG * NCG == kThreads, "thread layout");
  static_assert(NCG <= 32 && 32 % NCG == 0, "row lanes within one warp");
  static_assert(D % NCG == 0 && kBlockK % NCG == 0, "column split");
};

// Per-thread state of the online softmax for its TR rows.
template <int BQ, int D>
struct RowState {
  using L = Layout<BQ, D>;
  float acc[L::TR][L::TD];
  float m[L::TR];
  float l[L::TR];
  int lim[L::TR];
};

// The 16 / sizeof(T) values packed in one 16-byte load, as floats.
// Unpacked with bit operations: reading the registers through a T*
// would force them into local memory.
__device__ __forceinline__ void unpack16(const uint4& r, float (&out)[4]) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& r, float (&out)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      out[2 * i] = __uint_as_float(w[i] << 16);          // bf16 -> fp32
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      out[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i])));
      out[2 * i + 1] =
          __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
    }
  }
}

// 16 int8 values (exact in fp32), sign-extended from each byte.
__device__ __forceinline__ void unpack16(const uint4& r, float (&out)[16]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = (float)((int32_t)(w[i] << (24 - 8 * j)) >> 24);
}

template <typename T, int VN>
__device__ __forceinline__ void unpack(const uint4& r, float (&out)[VN]) {
  if constexpr (VN == 4 || VN == 16)
    unpack16(r, out);
  else
    unpack16<T>(r, out);
}

// Copy ROWS rows of D elements from device memory into padded fp32
// shared rows (stride D + 1), scaled by `scale`, for up to two tensors
// at once: row r of tensor t comes from src_t(r), or is zero-filled
// where src_t(r) is null. With `vec` (every row 16-byte aligned, as the
// caller checks), each thread issues up to kChunk 16-byte loads per
// tensor (fewer for head_dim 256, whose rows would not fit in registers)
// before it consumes any, so a tile costs one memory latency
// instead of one per element; otherwise it falls back to element loads.
constexpr int kChunk = 8;

template <typename T, int ROWS, int D, typename SrcA, typename SrcB>
__device__ __forceinline__ void stage_rows(float* dst_a, SrcA src_a,
                                           float* dst_b, SrcB src_b,
                                           float scale, bool vec) {
  constexpr int DP = D + 1;
  constexpr int VN = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int VPR = D / VN;                 // loads per row
  constexpr int NVEC = ROWS * VPR;
  constexpr int PER_T = (NVEC + kThreads - 1) / kThreads;
  constexpr int CH = D >= 256 ? 2 : kChunk;   // keep wide rows in registers
  static_assert(D % VN == 0, "rows are whole 16-byte vectors");
  const int tid = threadIdx.x;
  if (!vec) {
    for (int e = tid; e < ROWS * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const T* a = src_a(r);
      dst_a[r * DP + d] = a != nullptr ? to_float(a[d]) * scale : 0.f;
      if (dst_b != nullptr) {
        const T* b = src_b(r);
        dst_b[r * DP + d] = b != nullptr ? to_float(b[d]) * scale : 0.f;
      }
    }
    return;
  }
#pragma unroll
  for (int base = 0; base < PER_T; base += CH) {
    uint4 ra[CH], rb[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int e = (base + u) * kThreads + tid;
      ra[u] = rb[u] = make_uint4(0u, 0u, 0u, 0u);
      if (base + u < PER_T && e < NVEC) {
        const int r = e / VPR, dv = e % VPR;
        const T* a = src_a(r);
        if (a != nullptr) ra[u] = *reinterpret_cast<const uint4*>(a + dv * VN);
        if (dst_b != nullptr) {
          const T* b = src_b(r);
          if (b != nullptr)
            rb[u] = *reinterpret_cast<const uint4*>(b + dv * VN);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int e = (base + u) * kThreads + tid;
      if (base + u < PER_T && e < NVEC) {
        const int r = e / VPR, dv = e % VPR;
        float fa[VN], fb[VN];
        unpack<T, VN>(ra[u], fa);
        unpack<T, VN>(rb[u], fb);
#pragma unroll
        for (int i = 0; i < VN; ++i) {
          dst_a[r * DP + dv * VN + i] = fa[i] * scale;
          if (dst_b != nullptr) dst_b[r * DP + dv * VN + i] = fb[i] * scale;
        }
      }
    }
  }
}

// True when every row start p + r * stride (r >= 0) is 16-byte aligned.
template <typename T>
__device__ __forceinline__ bool rows_aligned(const T* p, int64_t stride) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) &&
         ((stride * (int64_t)sizeof(T)) % 16 == 0);
}

template <int NCG>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = NCG / 2; off >= 1; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int NCG>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = NCG / 2; off >= 1; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Key and value row c at base + c * stride (the head dimension is
// contiguous): the addressing of every dense caller of ``attend``.
template <typename T>
struct Strided {
  const T* base;
  int64_t stride;
  __device__ __forceinline__ const T* operator()(int c) const {
    return base + c * stride;
  }
};

// The column scales of a wide cache: none.
struct NoScales {
  static constexpr bool kOn = false;
  __device__ __forceinline__ float k(int) const { return 1.f; }
  __device__ __forceinline__ float v(int) const { return 1.f; }
};

// The column scales of an int8 cache: the bf16 key and value scales of
// column c at ka(c) and va(c).
template <typename KA, typename VA>
struct ColumnScales {
  static constexpr bool kOn = true;
  KA ka;
  VA va;
  __device__ __forceinline__ float k(int c) const {
    return __bfloat162float(*ka(c));
  }
  __device__ __forceinline__ float v(int c) const {
    return __bfloat162float(*va(c));
  }
};

template <typename KA, typename VA>
__device__ __forceinline__ ColumnScales<KA, VA> column_scales(KA ka, VA va) {
  return {ka, va};
}

// Attend the block's staged queries (smem[kQ...], already scaled) to key
// columns [0, n_keys), whose key and value rows (of element type KT)
// live at krow(c) and vrow(c) (the head dimension is contiguous; a dense
// caller passes Strided, the paged decode kernel a page-table lookup).
// ``vec``: every row address is 16-byte aligned, decided once by the
// caller. Columns past n_keys are never read: the tile loader zero-fills
// them. Tiles are kBlockK logical columns in column order whatever the
// addressing, so two callers that address the same logical rows get the
// same bits. An int8 cache passes ColumnScales ``sc`` and kScaleFloats
// more floats of shared memory past L::kFloats. Leaves the unnormalised
// output in st.acc and the statistics in st.m / st.l. Every thread of
// the block must call it with the same n_keys.
template <typename KT, int BQ, int D, typename KRow, typename VRow,
          typename Scales = NoScales>
__device__ void attend(float* smem, KRow krow, VRow vrow, bool vec,
                       int n_keys, RowState<BQ, D>& st,
                       Scales sc = Scales{}) {
  using L = Layout<BQ, D>;
  const int tid = threadIdx.x;
  const int cg = tid % L::NCG;
  const int r0 = (tid / L::NCG) * L::TR;
  float* qs = smem + L::kQ;
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* ps = smem + L::kP;
  float* kscale = smem + L::kFloats;   // int8 cache only
  float* vscale = kscale + kBlockK;

#pragma unroll
  for (int i = 0; i < L::TR; ++i) {
    st.m[i] = -INFINITY;
    st.l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < L::TD; ++j) st.acc[i][j] = 0.f;
  }

  static_assert(kBlockK <= kThreads, "one thread per column scale");
  for (int kt = 0; kt < n_keys; kt += kBlockK) {
    // int8 cache: thread c < kBlockK loads column kt + c's two scales
    // before the tile's rows, so their latency overlaps the row loads
    float kcol = 0.f, vcol = 0.f;
    if constexpr (Scales::kOn) {
      if (tid < kBlockK && kt + tid < n_keys) {
        kcol = sc.k(kt + tid);
        vcol = sc.v(kt + tid);
      }
    }
    // stage one K/V tile as fp32 (columns past n_keys zero-filled);
    // reads are coalesced along head_dim
    stage_rows<KT, kBlockK, D>(
        ks, [&](int c) -> const KT* {
          return kt + c < n_keys ? krow(kt + c) : nullptr;
        },
        vs, [&](int c) -> const KT* {
          return kt + c < n_keys ? vrow(kt + c) : nullptr;
        },
        1.f, vec);
    if constexpr (Scales::kOn) {
      if (tid < kBlockK) {
        kscale[tid] = kcol;
        vscale[tid] = vcol;
      }
    }
    __syncthreads();

    // scores s = q . k for this thread's TR x TC block
    float s[L::TR][L::TC];
#pragma unroll
    for (int i = 0; i < L::TR; ++i)
#pragma unroll
      for (int j = 0; j < L::TC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[L::TR], kv[L::TC];
#pragma unroll
      for (int i = 0; i < L::TR; ++i) qv[i] = qs[(r0 + i) * L::DP + d];
#pragma unroll
      for (int j = 0; j < L::TC; ++j) kv[j] = ks[(cg + j * L::NCG) * L::DP + d];
#pragma unroll
      for (int i = 0; i < L::TR; ++i)
#pragma unroll
        for (int j = 0; j < L::TC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    if constexpr (Scales::kOn) {   // fused K dequant: scale the columns
#pragma unroll
      for (int i = 0; i < L::TR; ++i)
#pragma unroll
        for (int j = 0; j < L::TC; ++j) s[i][j] *= kscale[cg + j * L::NCG];
    }

    // mask, then the online-softmax update of every owned row
#pragma unroll
    for (int i = 0; i < L::TR; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < L::TC; ++j) {
        const int col = kt + cg + j * L::NCG;
        if (col > st.lim[i]) s[i][j] = -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = row_max<L::NCG>(mt);
      const float mn = fmaxf(st.m[i], mt);
      const float alpha = st.m[i] == -INFINITY ? 0.f : exp2f(st.m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < L::TC; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : exp2f(s[i][j] - mn);
        s[i][j] = p;
        rs += p;
      }
      rs = row_sum<L::NCG>(rs);
      st.l[i] = st.l[i] * alpha + rs;
      st.m[i] = mn;
#pragma unroll
      for (int j = 0; j < L::TD; ++j) st.acc[i][j] *= alpha;
      // fused V dequant: the softmax weights carry the value scales
      // (l above summed the unscaled p)
#pragma unroll
      for (int j = 0; j < L::TC; ++j)
        ps[(r0 + i) * L::KP + cg + j * L::NCG] =
            Scales::kOn ? s[i][j] * vscale[cg + j * L::NCG] : s[i][j];
    }
    __syncthreads();

    // acc += p @ v over the tile's valid columns
    const int cmax = min(kBlockK, n_keys - kt);
    for (int c = 0; c < cmax; ++c) {
      float pv[L::TR];
#pragma unroll
      for (int i = 0; i < L::TR; ++i) pv[i] = ps[(r0 + i) * L::KP + c];
#pragma unroll
      for (int j = 0; j < L::TD; ++j) {
        const float vv = vs[c * L::DP + cg + j * L::NCG];
#pragma unroll
        for (int i = 0; i < L::TR; ++i) st.acc[i][j] = fmaf(pv[i], vv, st.acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// Normalised output of owned row i, column j of the thread (0 for rows
// that attended nothing).
template <int BQ, int D>
__device__ __forceinline__ float out_value(const RowState<BQ, D>& st, int i,
                                           int j) {
  return st.l[i] > 0.f ? st.acc[i][j] / st.l[i] : 0.f;
}

// Natural-log logsumexp of owned row i (-inf for rows that attended
// nothing).
template <int BQ, int D>
__device__ __forceinline__ float row_lse(const RowState<BQ, D>& st, int i) {
  return st.l[i] > 0.f ? (st.m[i] + log2f(st.l[i])) * kLn2 : -INFINITY;
}

}  // namespace paddle_flash
