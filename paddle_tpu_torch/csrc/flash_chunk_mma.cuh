// The chunk-prefill attention kernel on the tensor cores, for bfloat16
// and float16 queries at head_dim 16..128 against a wide (T) or an int8
// dense cache; flash_decode.cu's paddle_flash_chunk[_int8] dispatch here
// before any launch, by the tensor-core forward's rule (flash_mma.cuh's
// mma_route), and float32 and head_dim 256 stay on the shared fp32 body
// of flash_decode.cuh.
//
// The contract is flash_decode.cuh's: query row i of batch row b attends
// cache columns c <= kv_len[b] - Sq + i (a row whose limit is below 0
// gives zeros); grouped query heads share their kv head's tiles (a
// block's rows are (query head in group, position) pairs, head-major);
// K/V are read in place through the cache's strides; an int8 cache comes
// with bf16 scales per (position, kv head), the key scale multiplying
// each score column after the product and the value scale each softmax
// weight before P V (the normaliser sums the unscaled weights), as
// _decode_math in kernels/flash_attention.py and the TPU kernel's
// _decode_accumulate do.
//
// Launch: the chunk is small (gpt2-small's 128-query chunk at batch 1 is
// 12 heads x 128 rows), so filling 132 SMs is the design's first job. A
// block owns kChunkRows = 16 rows, one m16 tile, so that chunk runs 96
// blocks; its 4 warps split the block's key range [0, n_keys) in
// contiguous runs of 32-key tiles (n_keys stops at the block's last
// row's limit, as the TPU chunk kernel skips key blocks past its tile's
// window). Each warp streams its own tiles through two cp.async stages
// in its own shared memory, so the walk needs no block barrier, and
// keeps an online softmax (max, sum, unnormalised output) for the 16
// rows. The warps then meet once, through shared memory, and combine in
// warp order: M = max m_w, L = sum l_w 2^(m_w - M), O = sum O_w 2^(m_w -
// M) / L. The split depends only on (Sq, kv_len, the tile constants), so
// the bits repeat run to run and a row's result does not depend on the
// batch. No second launch, no atomics.
//
// Products: S = Q K^T and O += P V on mma.sync.m16n8k16 with fp32
// accumulation (flash_mma.cuh's product shapes and tile layout: rows
// padded by 16 bytes, B fragments by ldmatrix, .trans for V). Q's
// fragments stay in registers for the whole walk. Int8 tiles land raw
// (cp.async) and are widened to T in shared memory before the product:
// int8 -> bf16 or fp16 is exact for -128..127. P enters P V rounded to
// T once, the JAX kernels' rounding: this kernel serves inference and is
// held to the serving rule (1e-2 + 1e-2 |plain| in bf16; PERF.md §2),
// which one rounding meets; the training forward's second term
// (flash_mma.cuh) would cost a third more tensor-core products here for
// nothing the rule asks.
//
// What bounds it on the H100: at 128 queries against 512 cached
// positions (12 heads, head_dim 64) the bytes are 0.6 MB and the
// products 0.2 GFLOP: both bounds are under a microsecond, so the launch
// and the latency of a warp's 2-4 dependent tile steps are what is
// left.
#pragma once

#include "flash_decode.cuh"
#include "flash_mma.cuh"

namespace paddle_flash {

constexpr int kChunkRows = 16;   // query rows of a block: one m16 tile
constexpr int kChunkWarps = kThreads / 32;   // warps splitting the keys
constexpr int kChunkKeys = 32;   // keys of a warp's tile

// Shared memory of a block, in bytes: Q [16][kRow<D>] in T, then each
// warp's area: two stages of K and V tiles [32][kRow<D>] in T (wide), or
// two stages of raw int8 tiles [32][D] and one widened K and V pair in T
// (int8). After the walk the warps' areas hold the combine: m and l
// [warps][16], then the outputs [warps][16][D], fp32.
template <typename T, typename KT, int D>
struct ChunkSmem {
  static constexpr int kQ = kChunkRows * kRow<D> * (int)sizeof(T);
  static constexpr int kTile = kChunkKeys * kRow<D> * (int)sizeof(T);
  static constexpr int kRaw = kChunkKeys * D;
  static constexpr int kWarp = kQuant<KT> ? 4 * kRaw + 2 * kTile : 4 * kTile;
  static constexpr int kComb = kChunkWarps * kChunkRows * (D + 2) * 4;
  static constexpr size_t kBytes =
      kQ + (kChunkWarps * kWarp > kComb ? kChunkWarps * kWarp : kComb);
};

// Rows [kt, kt + 32) of a K or V stream (row c at base + c * stride; zeros
// from row n on) into dst at a row stride of DS elements, by this warp's
// lanes: 16-byte cp.async copies when vec (every row 16-byte aligned),
// complete after cp_async_wait; element copies otherwise, complete when
// the call returns. Either way visible to the warp after __syncwarp().
template <typename E, int D, int DS>
__device__ __forceinline__ void warp_tile(E* dst, const E* base,
                                          int64_t stride, int kt, int n,
                                          bool vec) {
  constexpr int EPC = 16 / (int)sizeof(E);   // elements per 16 bytes
  constexpr int VPR = D / EPC;               // 16-byte chunks per row
  const int lane = threadIdx.x & 31;
  if (vec) {
#pragma unroll
    for (int i = 0; i < kChunkKeys * VPR / 32; ++i) {
      const int e = i * 32 + lane, r = e / VPR, c = (e % VPR) * EPC;
      const bool ok = kt + r < n;
      cp_async16(dst + r * DS + c, ok ? base + (kt + r) * stride + c : base,
                 ok);
    }
  } else {
    // the elements' bits: E is a 1- or 2-byte type
    using R = typename std::conditional<sizeof(E) == 1, uint8_t,
                                        uint16_t>::type;
    R* d = reinterpret_cast<R*>(dst);
    const R* s = reinterpret_cast<const R*>(base);
    for (int e = lane; e < kChunkKeys * D; e += 32) {
      const int r = e / D, c = e % D;
      d[r * DS + c] = kt + r < n ? s[(kt + r) * stride + c] : R(0);
    }
  }
}

// An int8 tile [32][D] widened to T [32][kRow<D>] by this warp's lanes.
template <typename T, int D>
__device__ __forceinline__ void widen_tile(T* dst, const int8_t* src) {
  constexpr int CPR = D / 16;   // 16-element chunks per row
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kChunkKeys * CPR / 32; ++i) {
    const int e = i * 32 + lane, r = e / CPR, c = (e % CPR) * 16;
    float f[16];
    unpack16(*reinterpret_cast<const uint4*>(src + r * D + c), f);
    uint4 w[2];
    uint32_t* u = reinterpret_cast<uint32_t*>(w);
#pragma unroll
    for (int k = 0; k < 8; ++k) u[k] = pack2<T>(f[2 * k], f[2 * k + 1]);
    uint4* out = reinterpret_cast<uint4*>(dst + r * kRow<D> + c);
    out[0] = w[0];
    out[1] = w[1];
  }
}

template <typename T, typename KT, int D>
__global__ void __launch_bounds__(kThreads)
    flash_chunk_mma_kernel(const T* __restrict__ q, DenseCache cache,
                           const int* __restrict__ kv_len, T* __restrict__ o,
                           int Sq, int Hq, int Hk, int64_t q_sb, int64_t q_ss,
                           int64_t q_sh, int64_t o_sb, int64_t o_ss,
                           int64_t o_sh, float qk2) {
  using Sm = ChunkSmem<T, KT, D>;
  constexpr bool kInt8 = kQuant<KT>;
  constexpr int S = kRow<D>, BK = kChunkKeys, BQ = kChunkRows;
  constexpr int KD = D / 16;   // k16 steps over the head dim
  constexpr int NK = BK / 8;   // n8 tiles of a score row
  constexpr int ND = D / 8;    // n8 tiles of an output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  unsigned char* areas = smem_raw + Sm::kQ;
  const int b = blockIdx.x / Hk, hk = blockIdx.x % Hk, group = Hq / Hk;
  const int n_rows = group * Sq;
  const int j0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lo_a = lane_off_a<D>(), lo_b = lane_off_b<D>();

  const int klen = min(max(kv_len[b], 0), cache.t_len);
  // the block's first and last window positions (a block spanning two
  // query heads reaches both ends of the window)
  const int j1 = min(j0 + BQ, n_rows) - 1;
  const bool one_head = j0 / Sq == j1 / Sq;
  const int last = one_head ? j1 % Sq : Sq - 1;
  const int first = one_head ? j0 % Sq : 0;
  const int n_keys = max(0, min(klen, klen - Sq + last + 1));
  const int lim_min = klen - Sq + first;   // a tile past it needs the mask
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = j0 + g + 8 * i;
    lim[i] = j < n_rows ? klen - Sq + j % Sq : -1;
  }

  const T* qb = q + b * q_sb;
  tile_to_smem<T, BQ, D>(
      qs, [&](int r) -> const T* {
        const int j = j0 + r;
        if (j >= n_rows) return nullptr;
        return qb + (j % Sq) * q_ss + (hk * group + j / Sq) * q_sh;
      },
      qb, rows_aligned(qb, q_ss) && rows_aligned(qb, q_sh));
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[KD][4];   // the block's 16 query rows, for the whole walk
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a_frag<D>(qf[kk], qs, kk, lo_a);

  // this warp's run of key tiles
  const int n_t = (n_keys + BK - 1) / BK;
  const int per = (n_t + kChunkWarps - 1) / kChunkWarps;
  const int tb = min(n_t, warp * per), te = min(n_t, tb + per);

  unsigned char* area = areas + warp * Sm::kWarp;
  const KT* kb = static_cast<const KT*>(cache.k) + b * cache.k_sb +
                 hk * cache.k_sh;
  const KT* vb = static_cast<const KT*>(cache.v) + b * cache.v_sb +
                 hk * cache.v_sh;
  const bool vec = rows_aligned(kb, cache.k_ss) && rows_aligned(vb, cache.v_ss);
  const bf16* ksb = nullptr;
  const bf16* vsb = nullptr;
  if constexpr (kInt8) {
    ksb = static_cast<const bf16*>(cache.ks) + b * cache.ks_sb +
          hk * cache.ks_sh;
    vsb = static_cast<const bf16*>(cache.vs) + b * cache.vs_sb +
          hk * cache.vs_sh;
  }
  // stage s's K and V as landed: T tiles (wide) or raw int8 tiles
  constexpr int kStage = kInt8 ? 2 * Sm::kRaw : 2 * Sm::kTile;
  constexpr int kHalf = kInt8 ? Sm::kRaw : Sm::kTile;
  constexpr int kLd = kInt8 ? D : S;   // landed row stride, elements
  auto load = [&](int it) {
    KT* k_dst = reinterpret_cast<KT*>(area + (it & 1) * kStage);
    KT* v_dst = reinterpret_cast<KT*>(area + (it & 1) * kStage + kHalf);
    warp_tile<KT, D, kLd>(k_dst, kb, cache.k_ss, it * BK, n_keys, vec);
    warp_tile<KT, D, kLd>(v_dst, vb, cache.v_ss, it * BK, n_keys, vec);
  };
  // int8: lane c holds column (tile * 32 + c)'s key and value scales
  float kc_next = 0.f, vc_next = 0.f;
  auto load_scales = [&](int it) {
    const int c = it * BK + lane;
    if constexpr (kInt8) {
      kc_next = c < n_keys ? __bfloat162float(ksb[c * cache.ks_ss]) : 0.f;
      vc_next = c < n_keys ? __bfloat162float(vsb[c * cache.vs_ss]) : 0.f;
    }
  };

  float acc[ND][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (tb < te) {
    load(tb);
    load_scales(tb);
  }
  cp_async_commit();
  for (int it = tb; it < te; ++it) {
    const float kc = kc_next, vc = vc_next;
    if (it + 1 < te) {   // into the stage tile it - 1 used
      load(it + 1);
      load_scales(it + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();   // tile it has landed
    __syncwarp();
    const T* ks;
    const T* vs;
    if constexpr (kInt8) {
      T* kw = reinterpret_cast<T*>(area + 2 * kStage);
      T* vw = kw + BK * S;
      const int8_t* raw =
          reinterpret_cast<const int8_t*>(area + (it & 1) * kStage);
      widen_tile<T, D>(kw, raw);
      widen_tile<T, D>(vw, raw + Sm::kRaw);
      __syncwarp();
      ks = kw, vs = vw;
    } else {
      ks = reinterpret_cast<const T*>(area + (it & 1) * kStage);
      vs = ks + BK * S;
    }

    float s[NK][4];
    zero(s);
    mma_nt<T, D, NK>(
        s, [&](int kk, uint32_t(&f)[4]) {
#pragma unroll
          for (int r = 0; r < 4; ++r) f[r] = qf[kk][r];
        },
        ks, lo_b);

    // base-2 logits (an int8 cache's key scale per column), the mask, and
    // the tile's row maxima
    const int kt = it * BK;
    const bool masked = kt + BK - 1 > lim_min;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int ni = 0; ni < NK; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = ni * 8 + 2 * t + (r & 1);
        float x = s[ni][r] * qk2;
        if constexpr (kInt8) x *= __shfl_sync(0xffffffffu, kc, col);
        if (masked && kt + col > lim[r >> 1]) x = -INFINITY;
        s[ni][r] = x;
        mx[r >> 1] = fmaxf(mx[r >> 1], x);
      }
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a row with nothing visible yet keeps m = -inf and l = 0
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      const float alpha = exp2f(m[i] - base[i]);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        acc[nd][2 * i] *= alpha;
        acc[nd][2 * i + 1] *= alpha;
      }
    }
    // p = exp2(s - m); l sums this lane's unscaled p (the quad's four
    // parts are added at the end); an int8 cache's value scale goes into
    // the weight P V multiplies
#pragma unroll
    for (int ni = 0; ni < NK; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = exp2f(s[ni][r] - base[r >> 1]);
        l[r >> 1] += p;
        if constexpr (kInt8)
          s[ni][r] = p * __shfl_sync(0xffffffffu, vc, ni * 8 + 2 * t + (r & 1));
        else
          s[ni][r] = p;
      }
    // O += P V, P rounded to T once: the C fragments of n8 tiles 2kq and
    // 2kq + 1 are the A fragment of k16 step kq
#pragma unroll
    for (int kq = 0; kq < NK / 2; ++kq) {
      const uint32_t a[4] = {pack2<T>(s[2 * kq][0], s[2 * kq][1]),
                             pack2<T>(s[2 * kq][2], s[2 * kq][3]),
                             pack2<T>(s[2 * kq + 1][0], s[2 * kq + 1][1]),
                             pack2<T>(s[2 * kq + 1][2], s[2 * kq + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t r[4];
        ldsm<true>(r, vs + kq * 16 * S + np * 16 + lo_a);
        mma_pair<T>(acc[2 * np], acc[2 * np + 1], a, r);
      }
    }
    __syncwarp();   // the stage is refilled by the next iteration's loads
  }
  cp_async_wait_all();

  // combine the warps' partial rows in warp order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __syncthreads();   // every warp is done with its area
  float* cm = reinterpret_cast<float*>(areas);   // [warps][16]
  float* cl = cm + kChunkWarps * BQ;             // [warps][16]
  float* co = cl + kChunkWarps * BQ;             // [warps][16][D]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * BQ + g + 8 * i;
    if (t == 0) cm[row] = m[i], cl[row] = l[i];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      co[row * D + nd * 8 + 2 * t] = acc[nd][2 * i];
      co[row * D + nd * 8 + 2 * t + 1] = acc[nd][2 * i + 1];
    }
  }
  __syncthreads();
  constexpr int CPT = D / 8;   // output columns a thread: 8 threads a row
  const int r = threadIdx.x >> 3, c0 = (threadIdx.x & 7) * CPT;
  const int j = j0 + r;
  if (j >= n_rows) return;
  float mmax = -INFINITY;
#pragma unroll
  for (int w = 0; w < kChunkWarps; ++w)
    if (cl[w * BQ + r] > 0.f) mmax = fmaxf(mmax, cm[w * BQ + r]);
  float lsum = 0.f, out[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) out[c] = 0.f;
#pragma unroll
  for (int w = 0; w < kChunkWarps; ++w) {
    const float lw = cl[w * BQ + r];
    if (lw > 0.f) {
      const float f = exp2f(cm[w * BQ + r] - mmax);
      lsum += lw * f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) out[c] += co[(w * BQ + r) * D + c0 + c] * f;
    }
  }
  T* orow = o + b * o_sb + (j % Sq) * o_ss + (hk * group + j / Sq) * o_sh;
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    orow[c0 + c] = from_float<T>(lsum > 0.f ? out[c] / lsum : 0.f);
}

template <typename T, typename KT, int D>
cudaError_t launch_chunk_mma(const void* q, const DenseCache& cache,
                             const int* kv_len, void* o, int B, int Sq,
                             int Hq, int Hk, const int64_t* qo, float scale,
                             cudaStream_t stream) {
  using Sm = ChunkSmem<T, KT, D>;
  auto kernel = flash_chunk_mma_kernel<T, KT, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sm::kBytes);
  if (err != cudaSuccess) return err;
  const int n_rows = (Hq / Hk) * Sq;
  dim3 grid(B * Hk, (n_rows + kChunkRows - 1) / kChunkRows);
  kernel<<<grid, kThreads, Sm::kBytes, stream>>>(
      (const T*)q, cache, kv_len, (T*)o, Sq, Hq, Hk, qo[0], qo[1], qo[2],
      qo[3], qo[4], qo[5], scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, typename KT>
cudaError_t chunk_mma_d(int D, const void* q, const DenseCache& cache,
                        const int* kv_len, void* o, int B, int Sq, int Hq,
                        int Hk, const int64_t* qo, float scale,
                        cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_chunk_mma<T, KT, 16>(q, cache, kv_len, o, B, Sq, Hq, Hk,
                                         qo, scale, s);
    case 32:
      return launch_chunk_mma<T, KT, 32>(q, cache, kv_len, o, B, Sq, Hq, Hk,
                                         qo, scale, s);
    case 64:
      return launch_chunk_mma<T, KT, 64>(q, cache, kv_len, o, B, Sq, Hq, Hk,
                                         qo, scale, s);
    case 128:
      return launch_chunk_mma<T, KT, 128>(q, cache, kv_len, o, B, Sq, Hq, Hk,
                                          qo, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype 1 (bfloat16) or 2 (float16) of q and o; the cache of that type,
// or int8 with scales. The caller has checked mma_route.
inline cudaError_t dispatch_chunk_mma(int dtype, bool int8_cache, int D,
                                      const void* q, const DenseCache& cache,
                                      const int* kv_len, void* o, int B,
                                      int Sq, int Hq, int Hk,
                                      const int64_t* qo, float scale,
                                      void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (B <= 0) return cudaSuccess;
  if (Sq <= 0 || Hk <= 0 || Hq % Hk != 0) return cudaErrorInvalidValue;
  if (int8_cache && (cache.ks == nullptr || cache.vs == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return int8_cache
               ? chunk_mma_d<bf16, int8_t>(D, q, cache, kv_len, o, B, Sq, Hq,
                                           Hk, qo, scale, s)
               : chunk_mma_d<bf16, bf16>(D, q, cache, kv_len, o, B, Sq, Hq,
                                         Hk, qo, scale, s);
  if (dtype == 2)
    return int8_cache
               ? chunk_mma_d<__half, int8_t>(D, q, cache, kv_len, o, B, Sq,
                                             Hq, Hk, qo, scale, s)
               : chunk_mma_d<__half, __half>(D, q, cache, kv_len, o, B, Sq,
                                             Hq, Hk, qo, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace paddle_flash
