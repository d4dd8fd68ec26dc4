// The decode-shaped caches and the fp32 attention kernel of the chunk
// entries' "fma" route (float32, and head_dim 256; flash_decode.cu),
// hand-written for Hopper (sm_90a). The decode and paged decode entries
// run flash_decode_split.cuh's split-key body on the same cache structs.
//
// Computes, for each batch row b, the attention of Sq new query rows
// q [B, Sq, Hq, D] against one layer's K/V with a per-row valid length
// kv_len[b] that already counts the Sq new positions: query row i
// attends logical columns c <= kv_len - Sq + i. Rows whose limit is
// below 0 write zeros; a lane parked with kv_len 0 reads nothing.
//
// One block per (row, kv head) serves all Hq / Hk query heads of its
// group from the same K/V tiles: its rows are (query head in group,
// position) pairs in head-major order, in a block of 8 rows or, past 8,
// of 64 (more than 64 take further blocks along blockIdx.y). A block
// streams keys only up to the limit of its last query position,
// min(kv_len, kv_len - Sq + last + 1), as the TPU chunk kernel skips
// key blocks past its tile's window.
//
// The K/V addressing (the split body reads both):
// - DenseCache: a [B, T, Hk, D] cache (a layer slice of the engine's
//   [layers, B, T, Hk, D] cache), row c of (b, hk) at
//   base + b * s_b + c * s_s + hk * s_h;
// - PagedCache: a [n_pages, page, Hk, D] pool (a layer slice of
//   [layers, n_pages, page, Hk, D]) with page_table [B, n_slots] int32;
//   logical column c of (b, hk) at
//   pool + table[b][c / page] * s_page + (c % page) * s_row + hk * s_h.
//   The pool is read in place: no transpose and no gather.
//
// Int8 mode (cache element type KT = int8_t, q and o still T): K/V are
// int8 with one bf16 scale per (position, kv head), read in place from
// the caches' scale arrays through the same addressing: a dense [B, T,
// Hk] layer slice by its strides, a paged [n_pages, page, Hk] layer slice
// through the table. attend() stages each tile's scales in shared memory
// and fuses the dequantisation.
#pragma once

#include "flash_common.cuh"

namespace paddle_flash {

constexpr int kMaxQLen = 8;     // MAX_DECODE_QLEN

struct DenseCache {
  const void* k;
  const void* v;
  int64_t k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int t_len;
  // int8 mode: bf16 scales [B, T, Hk] and their (batch, seq, head)
  // strides
  const void* ks;
  const void* vs;
  int64_t ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh;
};

struct PagedCache {
  const void* k;
  const void* v;
  const int* table;
  int64_t k_sp, k_sr, k_sh, v_sp, v_sr, v_sh, tbl_sb;
  int page, n_slots;
  // int8 mode: bf16 scale pools [n_pages, page, Hk] and their (page,
  // row, head) strides
  const void* ks;
  const void* vs;
  int64_t ks_sp, ks_sr, ks_sh, vs_sp, vs_sr, vs_sh;
};

template <typename Cache>
constexpr bool kPaged = std::is_same<Cache, PagedCache>::value;

template <typename KT>
constexpr bool kQuant = std::is_same<KT, int8_t>::value;

using bf16 = __nv_bfloat16;

template <typename T, typename KT, int BQ, int D, typename Cache>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, Cache cache,
                        const int* __restrict__ kv_len, T* __restrict__ o,
                        int Sq, int Hq, int Hk, int64_t q_sb, int64_t q_ss,
                        int64_t q_sh, int64_t o_sb, int64_t o_ss,
                        int64_t o_sh, float qscale) {
  using L = Layout<BQ, D>;
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hk;
  const int hk = blockIdx.x % Hk;
  const int group = Hq / Hk;
  const int n_rows = group * Sq;  // (query head in group, position) pairs
  const int j0 = blockIdx.y * BQ;
  const int cg = threadIdx.x % L::NCG;
  const int r0 = (threadIdx.x / L::NCG) * L::TR;
  const int klen = min(max(kv_len[b], 0), cache.t_len);
  // the block's last row; a block that spans two query heads reaches
  // the window's last position
  const int j1 = min(j0 + BQ, n_rows) - 1;
  const int last = j0 / Sq == j1 / Sq ? j1 % Sq : Sq - 1;
  const int n_keys = max(0, min(klen, klen - Sq + last + 1));

  // block row r is pair j = j0 + r: query head hk * group + j / Sq at
  // window position j % Sq
  const T* qb = q + b * q_sb;
  stage_rows<T, BQ, D>(
      smem + L::kQ, [&](int r) -> const T* {
        const int j = j0 + r;
        if (j >= n_rows) return nullptr;
        return qb + (j % Sq) * q_ss + (hk * group + j / Sq) * q_sh;
      },
      (float*)nullptr, [](int) -> const T* { return nullptr; }, qscale,
      rows_aligned(qb, q_ss) && rows_aligned(qb, q_sh));

  RowState<BQ, D> st;
#pragma unroll
  for (int i = 0; i < L::TR; ++i) {
    const int j = j0 + r0 + i;
    st.lim[i] = klen - Sq + (j % Sq);
  }

  __syncthreads();
  const KT* kb = static_cast<const KT*>(cache.k) + b * cache.k_sb +
                 hk * cache.k_sh;
  const KT* vb = static_cast<const KT*>(cache.v) + b * cache.v_sb +
                 hk * cache.v_sh;
  const bool vec =
      rows_aligned(kb, cache.k_ss) && rows_aligned(vb, cache.v_ss);
  if constexpr (kQuant<KT>) {
    const bf16* ksb = static_cast<const bf16*>(cache.ks) +
                      b * cache.ks_sb + hk * cache.ks_sh;
    const bf16* vsb = static_cast<const bf16*>(cache.vs) +
                      b * cache.vs_sb + hk * cache.vs_sh;
    attend<KT, BQ, D>(smem, Strided<KT>{kb, cache.k_ss},
                      Strided<KT>{vb, cache.v_ss}, vec, n_keys, st,
                      column_scales(Strided<bf16>{ksb, cache.ks_ss},
                                    Strided<bf16>{vsb, cache.vs_ss}));
  } else {
    attend<KT, BQ, D>(smem, Strided<KT>{kb, cache.k_ss},
                      Strided<KT>{vb, cache.v_ss}, vec, n_keys, st);
  }

#pragma unroll
  for (int i = 0; i < L::TR; ++i) {
    const int j = j0 + r0 + i;
    if (j >= n_rows) continue;
    const int h = hk * group + j / Sq;
    T* orow = o + b * o_sb + (j % Sq) * o_ss + h * o_sh;
#pragma unroll
    for (int jj = 0; jj < L::TD; ++jj)
      orow[cg + jj * L::NCG] = from_float<T>(out_value(st, i, jj));
  }
}

// qo: the (batch, seq, head) strides of q, then of o.
template <typename T, typename KT, int BQ, int D, typename Cache>
cudaError_t launch_rows(const void* q, const Cache& cache, const int* kv_len,
                        void* o, int B, int Sq, int Hq, int Hk,
                        const int64_t* qo, float scale, cudaStream_t stream) {
  using L = Layout<BQ, D>;
  auto kernel = flash_decode_kernel<T, KT, BQ, D, Cache>;
  const size_t bytes =
      L::kBytes + (kQuant<KT> ? kScaleFloats * sizeof(float) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int n_rows = (Hq / Hk) * Sq;
  dim3 grid(B * Hk, (n_rows + BQ - 1) / BQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, cache, kv_len, (T*)o, Sq, Hq, Hk, qo[0], qo[1], qo[2],
      qo[3], qo[4], qo[5], scale * kLog2e);
  return cudaGetLastError();
}

// One block holds every query row of a (batch row, kv head) group: 8
// rows for plain multi-head decode, 64 when grouped heads or a chunk
// window need more.
template <typename T, typename KT, int D, typename Cache>
cudaError_t launch(const void* q, const Cache& cache, const int* kv_len,
                   void* o, int B, int Sq, int Hq, int Hk, const int64_t* qo,
                   float scale, cudaStream_t stream) {
  if ((Hq / Hk) * Sq <= 8)
    return launch_rows<T, KT, 8, D>(q, cache, kv_len, o, B, Sq, Hq, Hk, qo,
                                    scale, stream);
  return launch_rows<T, KT, 64, D>(q, cache, kv_len, o, B, Sq, Hq, Hk, qo,
                                   scale, stream);
}

template <typename T, typename KT, typename Cache>
cudaError_t dispatch_d(int D, const void* q, const Cache& cache,
                       const int* kv_len, void* o, int B, int Sq, int Hq,
                       int Hk, const int64_t* qo, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, KT, 16>(q, cache, kv_len, o, B, Sq, Hq, Hk, qo,
                               scale, stream);
    case 32:
      return launch<T, KT, 32>(q, cache, kv_len, o, B, Sq, Hq, Hk, qo,
                               scale, stream);
    case 64:
      return launch<T, KT, 64>(q, cache, kv_len, o, B, Sq, Hq, Hk, qo,
                               scale, stream);
    case 128:
      return launch<T, KT, 128>(q, cache, kv_len, o, B, Sq, Hq, Hk, qo,
                                scale, stream);
    case 256:
      return launch<T, KT, 256>(q, cache, kv_len, o, B, Sq, Hq, Hk, qo,
                                scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// q and o of type T; the cache of type T, or int8 with scales.
template <typename T, typename Cache>
cudaError_t dispatch_cache(bool int8_cache, int D, const void* q,
                           const Cache& cache, const int* kv_len, void* o,
                           int B, int Sq, int Hq, int Hk, const int64_t* qo,
                           float scale, cudaStream_t s) {
  if (int8_cache)
    return dispatch_d<T, int8_t>(D, q, cache, kv_len, o, B, Sq, Hq, Hk, qo,
                                 scale, s);
  return dispatch_d<T, T>(D, q, cache, kv_len, o, B, Sq, Hq, Hk, qo, scale,
                          s);
}

// dtype: 0 float32, 1 bfloat16, 2 float16 (of q and o; of the cache too
// unless int8_cache).
template <typename Cache>
cudaError_t dispatch(int dtype, bool int8_cache, int D, const void* q,
                     const Cache& cache, const int* kv_len, void* o, int B,
                     int Sq, int Hq, int Hk, const int64_t* qo, float scale,
                     void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (B <= 0) return cudaSuccess;
  if (Sq <= 0 || Hk <= 0 || Hq % Hk != 0) return cudaErrorInvalidValue;
  if (int8_cache && (cache.ks == nullptr || cache.vs == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch_cache<float>(int8_cache, D, q, cache, kv_len, o, B,
                                   Sq, Hq, Hk, qo, scale, s);
    case 1:
      return dispatch_cache<__nv_bfloat16>(int8_cache, D, q, cache, kv_len,
                                           o, B, Sq, Hq, Hk, qo, scale, s);
    case 2:
      return dispatch_cache<__half>(int8_cache, D, q, cache, kv_len, o, B,
                                    Sq, Hq, Hk, qo, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace paddle_flash
