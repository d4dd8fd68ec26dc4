// The decode kernels' body: flash-decode attention with a fixed key
// split, hand-written for Hopper (sm_90a). flash_decode.cu's
// paddle_flash_decode[_int8] run it with DenseCache addressing and
// flash_decode_paged.cu's paddle_flash_decode_paged[_int8] with
// PagedCache addressing (flash_decode.cuh's structs); the chunk entries
// keep flash_chunk_mma.cuh and flash_decode.cuh's fp32 body.
//
// The contract is flash_decode.cuh's: query row i of batch row b (Sq <=
// kMaxQLen rows) attends logical cache columns c <= kv_len[b] - Sq + i;
// a row whose limit is below 0 writes zeros; grouped query heads share
// their kv head's K/V (the rows of a (batch row, kv head) pair are (query
// head in group, position) pairs, head-major). Scores are fp32 on q
// pre-scaled by scale * log2(e), fed to exp2f; P is never rounded before
// P V. An int8 cache scales each score column by its key scale before
// the mask, sums the normaliser over the unscaled p and carries the
// value scale in p, as _decode_math and the TPU kernel's
// _decode_accumulate do.
//
// What bounds it on the H100: device-memory bytes, about 4 FLOP per K/V
// byte, and at a decode step's size (8 rows x 640 positions x 12 heads x
// head_dim 64 in bf16, 7 MB read, 2.1 us at 3.35 TB/s) the latency of the
// loads rather than their rate. What the design does about it:
// - Fixed key splits. Logical columns [s * kSplitKeys, (s + 1) *
//   kSplitKeys) of a (batch row, kv head) are split s, one block each,
//   so a 640-key row is 5 blocks that run side by side, not one block
//   walking 10 tiles of 64 (kSplitKeys 128 measured faster than 64 at a
//   serving step, experiments/decode_probe.py). The grid is sized from
//   the cache's capacity (T, or n_slots * page), never from kv_len,
//   which lives on the card; a block whose split starts past its rows'
//   keys exits at once.
// - Loads in flight. The block's 4 warps take a quarter of the split
//   each. A lane owns 8 head-dim elements (kLaneElems) of one key row at a
//   time: D / 8 lanes cover a key, 256 / D keys a warp step. Each lane
//   copies its own chunks of K and V, in their storage type, into its own
//   slots of a cp.async ring of kStages stages of up to kStageKeys keys,
//   so the next stage is in flight while this one is computed, and reads
//   back only what it copied: the walk needs no barrier. A warp's 16-byte
//   copies cover whole key rows, coalesced.
// - Only live rows. A block holds R = 1 query row (multi-head decode at
//   Sq 1) or up to 8 (grouped heads, verify windows; more take further
//   blocks along z), and rows past the live count compute nothing.
// - Conversion in registers. A lane converts its chunks to fp32 as it
//   reads them back, dots them with its 8 query elements and sums the
//   dot over the key's lanes with xor shuffles.
// Each lane group keeps its own online softmax (max m, normaliser l,
// fp32 output) over its keys; the groups of a warp meet by xor shuffles
// (a commutative two-term form, so both partners hold the same bits),
// the warps in warp order through shared memory. A row whose columns all
// lie in split 0 writes its output there. The other rows' splits are
// folded in split order, reading only the splits that hold a visible
// column of the row: M = max m_s, L = sum l_s 2^(m_s - M), O = sum O_s
// 2^(m_s - M), out = O / L (split_fold). When the capacity spans at most
// kClusterSplits splits (1024 columns: the serving and generate caches),
// the splits of a (batch row, kv head) are one thread-block cluster and
// block 0 folds the others' partials through distributed shared memory,
// in one launch. A longer capacity writes the partials to a scratch
// buffer the wrapper allocates, and flash_decode_combine_kernel folds
// them; it launches with programmatic stream serialization, so its warps
// start while the split kernel drains and wait for it in
// griddepcontrol.wait. Both routes run split_fold, so the bits do not
// depend on the route. No atomics: every sum has a fixed order.
//
// So a row's bits depend only on its logical K/V content, kv_len, Sq,
// head_dim and the dtypes: not on B or its slot, the cache's capacity,
// dense or paged layout or the page size, alignment (misaligned rows
// copy element by element into the same slots), or the grid. Every mul-
// add that feeds the result is an explicit fmaf or _rn intrinsic, so no
// instantiation contracts differently.
#pragma once

#include "flash_decode.cuh"
#include "mma_common.cuh"   // cp_async16, cp_async_commit, cp_async_wait,
                             // cluster_sync, cluster_load

namespace paddle_flash {

// Logical key columns of one split. Its bits are part of the kernels'
// numerics: changing it changes the outputs' last bits (not their
// tolerance). kernels/flash_attention.py's DECODE_SPLIT_KEYS mirrors it.
#ifndef PADDLE_DECODE_SPLIT
#define PADDLE_DECODE_SPLIT 128
#endif
constexpr int kSplitKeys = PADDLE_DECODE_SPLIT;
constexpr int kSplitWarps = kThreads / 32;
constexpr int kLaneElems = 8;    // head-dim elements a lane owns of a key
constexpr int kSplitRows = 8;    // query rows of a block beyond R = 1
constexpr int kStageKeys = 4;    // a lane's keys a ring stage
constexpr int kStages = 2;
// Most splits a launch folds inside one thread-block cluster (the
// portable cluster size); a longer capacity folds through the scratch
// buffer and the combine kernel. kernels/flash_attention.py's
// DECODE_CLUSTER_SPLITS mirrors it.
#ifndef PADDLE_DECODE_CLUSTER_SPLITS
#define PADDLE_DECODE_CLUSTER_SPLITS 8
#endif
constexpr int kClusterSplits = PADDLE_DECODE_CLUSTER_SPLITS;
static_assert(kSplitKeys % kSplitWarps == 0, "warps split the keys");

// The walk's geometry for a key element type KT at head dim D.
template <typename KT, int D>
struct SplitGeom {
  static constexpr int E = kLaneElems;
  static constexpr int LPK = D / E;                  // lanes a key
  static constexpr int KPW = 32 / LPK;               // keys a warp step
  static constexpr int Q = kSplitKeys / kSplitWarps;  // keys a warp
  static constexpr int KPG = Q / KPW;                // keys a lane group
  static constexpr int NB = KPG < kStageKeys ? KPG : kStageKeys;
  static constexpr int NT = KPG / NB;                // stages a warp walks
  static constexpr int NS = NT < kStages ? NT : kStages;   // ring depth
  static constexpr int CB = E * (int)sizeof(KT);     // bytes of a chunk
  static constexpr int PB = CB < 16 ? CB : 16;       // bytes of a copy
  static constexpr int P = CB / PB;                  // copies a chunk
  // ring: [stage][key][K or V][copy][thread] of PB bytes, so a warp's
  // lanes touch consecutive words
  static constexpr int kRing = NS * NB * 2 * P * kThreads * PB;
  static_assert(D % E == 0 && LPK >= 1 && LPK <= 32, "lane split");
  static_assert(Q % KPW == 0 && KPG % NB == 0, "key split");
};

// Shared memory of a block, in bytes: the ring, which the warps' combine
// reuses after the walk ([warps][R] m and l, then [warps][R][D] outputs,
// fp32); then the block's split partial for a cluster fold ([R] rows of
// m, l and the D outputs, fp32); then an int8 cache's scales of the
// split (fp32, key then value); then a paged cache's table entries for
// the split.
template <typename KT, int D, int R>
struct SplitSmem {
  using G = SplitGeom<KT, D>;
  static constexpr int kComb = kSplitWarps * R * (D + 2) * 4;
  static constexpr int kMain = G::kRing > kComb ? G::kRing : kComb;
  static constexpr int kFold = kMain;
  static constexpr int kScales = kFold + R * (D + 2) * 4;
  static constexpr int kTable = kScales + 2 * kSplitKeys * 4;
  static constexpr size_t kBytes = kTable + (kSplitKeys + 2) * 4;
};

// 8 bytes global -> shared, asynchronously; zeros when !ok (src then not
// read). cp.async.cg takes only 16, so this one also fills L1.
__device__ __forceinline__ void split_cp_async8(void* dst, const void* src,
                                                bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0));
}

// 8 int8 values (exact in fp32), sign-extended from each byte.
__device__ __forceinline__ void split_unpack_i8(const uint2& r,
                                                float (&f)[8]) {
  const uint32_t w[2] = {r.x, r.y};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = (float)((int32_t)(w[i] << (24 - 8 * j)) >> 24);
}

// 8 elements of type X at p (16-byte aligned when vec) as fp32.
template <typename X>
__device__ __forceinline__ void split_load8(const X* p, bool vec,
                                            float (&f)[8]) {
  if (!vec) {
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = to_float(p[e]);
  } else if constexpr (sizeof(X) == 2) {
    unpack16<X>(*reinterpret_cast<const uint4*>(p), f);
  } else {
    float a[4], c[4];
    unpack16(reinterpret_cast<const uint4*>(p)[0], a);
    unpack16(reinterpret_cast<const uint4*>(p)[1], c);
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = a[e], f[4 + e] = c[e];
  }
}

// The chunk a lane copied for one key, read back from its ring slots
// (copy part at base + part * kThreads * PB) as fp32.
template <typename KT, int PB>
__device__ __forceinline__ void split_read_chunk(const unsigned char* base,
                                                 float (&f)[8]) {
  if constexpr (sizeof(KT) == 1) {
    split_unpack_i8(*reinterpret_cast<const uint2*>(base), f);
  } else if constexpr (sizeof(KT) == 2) {
    unpack16<KT>(*reinterpret_cast<const uint4*>(base), f);
  } else {
    float a[4], c[4];
    unpack16(*reinterpret_cast<const uint4*>(base), a);
    unpack16(*reinterpret_cast<const uint4*>(base + kThreads * PB), c);
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = a[e], f[4 + e] = c[e];
  }
}

// A lane's chunk of one key row (src, or zeros when !ok; dummy is any
// readable address) into its ring slots: cp.async copies when vec (the
// row is aligned to the copy size), element copies otherwise, which land
// the same bytes before the call returns.
template <typename KT, int PB, int P>
__device__ __forceinline__ void split_copy_chunk(unsigned char* dst,
                                                 const KT* src,
                                                 const KT* dummy, bool ok,
                                                 bool vec) {
  if (vec) {
#pragma unroll
    for (int part = 0; part < P; ++part) {
      const KT* s = ok ? src + part * (PB / (int)sizeof(KT)) : dummy;
      if constexpr (PB == 16)
        cp_async16(dst + part * kThreads * PB, s, ok);
      else
        split_cp_async8(dst + part * kThreads * PB, s, ok);
    }
  } else {
    // the elements' bits: KT is a 1-, 2- or 4-byte type
    using Bits = typename std::conditional<
        sizeof(KT) == 1, uint8_t,
        typename std::conditional<sizeof(KT) == 2, uint16_t,
                                  uint32_t>::type>::type;
    constexpr int EPC = PB / (int)sizeof(KT);   // elements a copy
    const Bits* s = reinterpret_cast<const Bits*>(src);
#pragma unroll
    for (int part = 0; part < P; ++part) {
      Bits* d = reinterpret_cast<Bits*>(dst + part * kThreads * PB);
#pragma unroll
      for (int e = 0; e < EPC; ++e) d[e] = ok ? s[part * EPC + e] : Bits(0);
    }
  }
}

// True when p + r * stride (r >= 0) is A-byte aligned for every r.
template <int A, typename X>
__device__ __forceinline__ bool split_aligned(const X* p, int64_t stride) {
  return reinterpret_cast<uintptr_t>(p) % A == 0 &&
         (stride * (int64_t)sizeof(X)) % A == 0;
}

// The weight 2^(m - mx) of an online-softmax state with maximum m under
// a larger maximum mx; 0 for a state that has seen no column (m = -inf).
__device__ __forceinline__ float split_weight(float m, float mx) {
  return m == -INFINITY ? 0.f : exp2f(m - mx);
}

// Splits a row with limit lim (last visible column) reads: 0 when it
// sees nothing.
__device__ __forceinline__ int split_count(int lim) {
  return lim < 0 ? 0 : lim / kSplitKeys + 1;
}

// One output column of a row spanning ns >= 2 splits, from split s's
// m_of(s), l_of(s) and unnormalised o_of(s), folded in split order. Each
// m is finite: split s holds a visible column of the row. The cluster
// fold and the combine kernel both run this, so the route a capacity
// takes does not move a bit.
template <typename M, typename L, typename O>
__device__ __forceinline__ float split_fold(int ns, M m_of, L l_of,
                                            O o_of) {
  float mx = -INFINITY;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, m_of(s));
  float lsum = 0.f, out = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float a = exp2f(m_of(s) - mx);
    lsum = fmaf(l_of(s), a, lsum);
    out = fmaf(o_of(s), a, out);
  }
  return __fdiv_rn(out, lsum);
}

template <typename T, typename KT, int D, int R, typename Cache>
__global__ void __launch_bounds__(kThreads)
    flash_decode_split_kernel(const T* __restrict__ q, Cache cache,
                              const int* __restrict__ kv_len,
                              T* __restrict__ o, float* __restrict__ part,
                              int Sq, int Hq, int Hk, int n_split, int fold,
                              int64_t q_sb, int64_t q_ss, int64_t q_sh,
                              int64_t o_sb, int64_t o_ss, int64_t o_sh,
                              float qscale) {
  using G = SplitGeom<KT, D>;
  using Sm = SplitSmem<KT, D, R>;
  constexpr bool kInt8 = kQuant<KT>;
  constexpr int E = G::E, LPK = G::LPK, KPW = G::KPW, NB = G::NB;
  constexpr int NT = G::NT, NS = G::NS, PB = G::PB, P = G::P;
  extern __shared__ __align__(16) unsigned char split_smem[];
  // the combine kernel may start: it waits for this grid's end itself
  asm volatile("griddepcontrol.launch_dependents;");

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane / LPK, ch = lane % LPK;
  const int bh = blockIdx.x, b = bh / Hk, hk = bh % Hk;
  const int s = blockIdx.y;
  const int group = Hq / Hk, n_rows = group * Sq;
  const int j0 = blockIdx.z * R;
  const int live = min(R, n_rows - j0);
  const int cs = s * kSplitKeys;   // the split's first column
  int t_len;
  if constexpr (kPaged<Cache>)
    t_len = cache.n_slots * cache.page;
  else
    t_len = cache.t_len;
  const int kv = kv_len[b];
  int* tbl = reinterpret_cast<int*>(split_smem + Sm::kTable);
  int p0 = 0;
  if constexpr (kPaged<Cache>) {
    // the table entries of the split's pages, loaded beside kv_len
    // (only columns below kv_len ever use them)
    p0 = cs / cache.page;
    const int n_tp =
        min((cs + kSplitKeys - 1) / cache.page + 1, cache.n_slots) - p0;
    const int* trow = cache.table + b * cache.tbl_sb + p0;
    for (int i = tid; i < n_tp; i += kThreads) tbl[i] = trow[i];
  }
  const int klen = min(max(kv, 0), t_len);
  // the block's last live row reaches the window's last position when
  // the block spans two query heads
  const int j1 = j0 + live - 1;
  const int last = j0 / Sq == j1 / Sq ? j1 % Sq : Sq - 1;
  const int n_keys = max(0, min(klen, klen - Sq + last + 1));
  if (s > 0 && cs >= n_keys) {   // no visible column of any row
    if (fold) {   // the cluster's two barriers still count this block
      cluster_sync();
      cluster_sync();
    }
    return;
  }
  if constexpr (kPaged<Cache>) __syncthreads();

  int lim[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    lim[r] = r < live ? klen - Sq + (j0 + r) % Sq : -1;

  // K/V rows of logical column c (head dim contiguous)
  const KT* kb;
  const KT* vb;
  bool vec;
  if constexpr (kPaged<Cache>) {
    kb = static_cast<const KT*>(cache.k) + hk * cache.k_sh;
    vb = static_cast<const KT*>(cache.v) + hk * cache.v_sh;
    vec = split_aligned<PB>(kb, cache.k_sp) &&
          split_aligned<PB>(kb, cache.k_sr) &&
          split_aligned<PB>(vb, cache.v_sp) &&
          split_aligned<PB>(vb, cache.v_sr);
  } else {
    kb = static_cast<const KT*>(cache.k) + b * cache.k_sb + hk * cache.k_sh;
    vb = static_cast<const KT*>(cache.v) + b * cache.v_sb + hk * cache.v_sh;
    vec = split_aligned<PB>(kb, cache.k_ss) &&
          split_aligned<PB>(vb, cache.v_ss);
  }
  auto row_of = [&](int c, int64_t sp, int64_t sr, int64_t ss) -> int64_t {
    if constexpr (kPaged<Cache>)
      return tbl[c / cache.page - p0] * sp + (c % cache.page) * sr;
    else
      return c * ss;
  };
  int64_t k_sp = 0, k_sr = 0, v_sp = 0, v_sr = 0, k_ss = 0, v_ss = 0;
  if constexpr (kPaged<Cache>) {
    k_sp = cache.k_sp, k_sr = cache.k_sr, v_sp = cache.v_sp,
    v_sr = cache.v_sr;
  } else {
    k_ss = cache.k_ss, v_ss = cache.v_ss;
  }

  // this warp's keys: wk0 + j * KPW + g for j < KPG; stage t holds j in
  // [t * NB, (t + 1) * NB). Stages wholly past n_keys are skipped: a
  // fully masked stage leaves the state's bits as they are.
  const int wk0 = cs + warp * G::Q;
  const int nt =
      max(0, min(NT, (n_keys - wk0 + KPW * NB - 1) / (KPW * NB)));
  auto slot = [&](int st, int n, int kvi) -> unsigned char* {
    return split_smem +
           (((st * NB + n) * 2 + kvi) * P * kThreads + tid) * PB;
  };
  auto load_stage = [&](int t) {
    const int st = t % NS;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int c = wk0 + (t * NB + n) * KPW + g;
      const bool ok = c < n_keys;
      const KT* kr = ok ? kb + row_of(c, k_sp, k_sr, k_ss) + ch * E : kb;
      const KT* vr = ok ? vb + row_of(c, v_sp, v_sr, v_ss) + ch * E : vb;
      split_copy_chunk<KT, PB, P>(slot(st, n, 0), kr, kb, ok, vec);
      split_copy_chunk<KT, PB, P>(slot(st, n, 1), vr, vb, ok, vec);
    }
  };
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < nt) load_stage(t);
    cp_async_commit();
  }

  // this lane's 8 elements of each live query row, pre-scaled
  float qr[R][E];
  {
    const T* qb = q + b * q_sb;
    const bool qvec = rows_aligned(qb, q_ss) && rows_aligned(qb, q_sh);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < live) {
        const int j = j0 + r;
        split_load8<T>(qb + (j % Sq) * q_ss + (hk * group + j / Sq) * q_sh +
                           ch * E,
                       qvec, qr[r]);
#pragma unroll
        for (int e = 0; e < E; ++e) qr[r][e] = __fmul_rn(qr[r][e], qscale);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) qr[r][e] = 0.f;
      }
    }
  }

  // an int8 cache's scales of the split's columns, staged once
  float* ksc = reinterpret_cast<float*>(split_smem + Sm::kScales);
  float* vsc = ksc + kSplitKeys;
  if constexpr (kInt8) {
    const bf16* ksb;
    const bf16* vsb;
    int64_t ks_sp = 0, ks_sr = 0, vs_sp = 0, vs_sr = 0, ks_ss = 0, vs_ss = 0;
    if constexpr (kPaged<Cache>) {
      ksb = static_cast<const bf16*>(cache.ks) + hk * cache.ks_sh;
      vsb = static_cast<const bf16*>(cache.vs) + hk * cache.vs_sh;
      ks_sp = cache.ks_sp, ks_sr = cache.ks_sr, vs_sp = cache.vs_sp,
      vs_sr = cache.vs_sr;
    } else {
      ksb = static_cast<const bf16*>(cache.ks) + b * cache.ks_sb +
            hk * cache.ks_sh;
      vsb = static_cast<const bf16*>(cache.vs) + b * cache.vs_sb +
            hk * cache.vs_sh;
      ks_ss = cache.ks_ss, vs_ss = cache.vs_ss;
    }
    for (int i = tid; i < kSplitKeys; i += kThreads) {
      const int c = cs + i;
      const bool ok = c < n_keys;
      ksc[i] = ok ? __bfloat162float(ksb[row_of(c, ks_sp, ks_sr, ks_ss)])
                  : 0.f;
      vsc[i] = ok ? __bfloat162float(vsb[row_of(c, vs_sp, vs_sr, vs_ss)])
                  : 0.f;
    }
    __syncthreads();
  }

  float m[R], l[R], acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  for (int t = 0; t < nt; ++t) {
    if (t + NS - 1 < nt) load_stage(t + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();   // stage t has landed (this lane's copies)
    const int st = t % NS;

    // scores of the stage's keys: this lane's 8-element dot, summed over
    // the key's LPK lanes
    float sc[R][NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      float kf[E];
      split_read_chunk<KT, PB>(slot(st, n, 0), kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a = 0.f;
        if (r < live) {
#pragma unroll
          for (int e = 0; e < E; ++e) a = fmaf(qr[r][e], kf[e], a);
#pragma unroll
          for (int off = 1; off < LPK; off <<= 1)
            a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, off));
        }
        sc[r][n] = a;
      }
    }
    // an int8 cache's key scale per column, the mask, then the online
    // softmax of each live row over the stage
    float vs_n[NB];
    int col[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      col[n] = wk0 + (t * NB + n) * KPW + g;
      vs_n[n] = kInt8 ? vsc[col[n] - cs] : 1.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= live) continue;
      float mt = -INFINITY;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        float x = sc[r][n];
        if constexpr (kInt8) x = __fmul_rn(x, ksc[col[n] - cs]);
        if (col[n] > lim[r]) x = -INFINITY;
        sc[r][n] = x;
        mt = fmaxf(mt, x);
      }
      const float mn = fmaxf(m[r], mt);
      const float alpha = split_weight(m[r], mn);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float p = split_weight(sc[r][n], mn);
        rs = __fadd_rn(rs, p);
        // the value scale goes into the weight P V multiplies (l above
        // sums the unscaled p)
        sc[r][n] = kInt8 ? __fmul_rn(p, vs_n[n]) : p;
      }
      l[r] = fmaf(l[r], alpha, rs);
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = __fmul_rn(acc[r][e], alpha);
    }
    // O += P V
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      float vf[E];
      split_read_chunk<KT, PB>(slot(st, n, 1), vf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= live) continue;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[r][e] = fmaf(sc[r][n], vf[e], acc[r][e]);
      }
    }
  }
  cp_async_wait_all();

  // the warp's lane groups meet: xor partners absorb each other, each
  // state weighted as two rounded products and one rounded sum, so both
  // partners hold the same bits
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= live) continue;
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mx = fmaxf(m[r], mo);
      const float a = split_weight(m[r], mx), ao = split_weight(mo, mx);
      l[r] = __fadd_rn(__fmul_rn(l[r], a), __fmul_rn(lo, ao));
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float x = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = __fadd_rn(__fmul_rn(acc[r][e], a), __fmul_rn(x, ao));
      }
      m[r] = mx;
    }
  }

  // the warps meet in warp order, through the ring's shared memory
  __syncthreads();   // every warp is done with its ring slots
  float* fold_part = reinterpret_cast<float*>(split_smem + Sm::kFold);
  float* cm = reinterpret_cast<float*>(split_smem);   // [warps][R]
  float* cl = cm + kSplitWarps * R;             // [warps][R]
  float* co = cl + kSplitWarps * R;             // [warps][R][D]
  if (g == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= live) continue;
      if (ch == 0) cm[warp * R + r] = m[r], cl[warp * R + r] = l[r];
#pragma unroll
      for (int e = 0; e < E; ++e)
        co[(warp * R + r) * D + ch * E + e] = acc[r][e];
    }
  }
  __syncthreads();
  const int64_t n_part = (int64_t)gridDim.x * n_split * n_rows;
  for (int idx = tid; idx < live * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, j = j0 + r;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mx = fmaxf(mx, cm[w * R + r]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float a = split_weight(cm[w * R + r], mx);
      lsum = fmaf(cl[w * R + r], a, lsum);
      out = fmaf(co[(w * R + r) * D + d], a, out);
    }
    const int ns = split_count(klen - Sq + j % Sq);
    if (ns <= 1) {
      // every visible column of the row is in split 0: block 0 writes it
      if (s == 0) {
        T* orow =
            o + b * o_sb + (j % Sq) * o_ss + (hk * group + j / Sq) * o_sh;
        orow[d] = from_float<T>(lsum > 0.f ? __fdiv_rn(out, lsum) : 0.f);
      }
    } else if (s < ns && fold) {
      float* f = fold_part + r * (D + 2);
      f[2 + d] = out;
      if (d == 0) f[0] = mx, f[1] = lsum;
    } else if (s < ns) {
      const int64_t pi = ((int64_t)bh * n_split + s) * n_rows + j;
      part[pi * D + d] = out;
      if (d == 0) {
        part[n_part * D + 2 * pi] = mx;
        part[n_part * D + 2 * pi + 1] = lsum;
      }
    }
  }
  if (!fold) return;
  // the cluster holds every split of this (batch row, kv head) block of
  // rows, split s as block rank s (cluster dims (1, n_split, 1)): block
  // 0 folds the partials through distributed shared memory
  cluster_sync();   // every split's partial is in its block
  if (s == 0) {
    for (int idx = tid; idx < live * D; idx += kThreads) {
      const int r = idx / D, d = idx % D, j = j0 + r;
      const int ns = split_count(klen - Sq + j % Sq);
      if (ns <= 1) continue;
      const float* f = fold_part + r * (D + 2);
      o[b * o_sb + (j % Sq) * o_ss + (hk * group + j / Sq) * o_sh + d] =
          from_float<T>(split_fold(
              ns, [&](int t) { return cluster_load(f, t); },
              [&](int t) { return cluster_load(f + 1, t); },
              [&](int t) { return cluster_load(f + 2 + d, t); }));
    }
  }
  cluster_sync();   // no block leaves while block 0 reads its partial
}

// Fold the splits of every row that spans more than one, in split order,
// and write its output. One warp a (batch row, position, query head).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_decode_combine_kernel(const float* __restrict__ part,
                                const int* __restrict__ kv_len,
                                T* __restrict__ o, int B, int Sq, int Hq,
                                int Hk, int n_split, int t_len, int64_t o_sb,
                                int64_t o_ss, int64_t o_sh) {
  const int wid = blockIdx.x * kSplitWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  // the split kernel's partials are complete and visible past this
  // point; every warp waits, so this grid never ends before that one
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (wid >= B * Sq * Hq) return;
  const int b = wid / (Sq * Hq), h = (wid / Sq) % Hq, i = wid % Sq;
  const int klen = min(max(kv_len[b], 0), t_len);
  const int ns = split_count(klen - Sq + i);
  if (ns <= 1) return;   // the split kernel wrote it
  const int group = Hq / Hk, n_rows = group * Sq;
  const int j = (h % group) * Sq + i;
  const int64_t n_part = (int64_t)B * Hk * n_split * n_rows;
  const int64_t p0 = ((int64_t)(b * Hk + h / group) * n_split) * n_rows + j;
  const float* stats = part + n_part * D;
  T* orow = o + b * o_sb + i * o_ss + h * o_sh;
  for (int d = lane; d < D; d += 32) {
    auto pi = [&](int s) { return p0 + (int64_t)s * n_rows; };
    orow[d] = from_float<T>(split_fold(
        ns, [&](int s) { return stats[2 * pi(s)]; },
        [&](int s) { return stats[2 * pi(s) + 1]; },
        [&](int s) { return part[pi(s) * D + d]; }));
  }
}

// Floats of scratch a call needs: (m, l, O[D]) per (batch row, kv head,
// split, row of the group) when the capacity spans more splits than a
// cluster folds, else none (kernels/flash_attention.py's
// decode_scratch_floats).
inline int64_t split_scratch_floats(int B, int Sq, int Hq, int Hk, int t_len,
                                    int D) {
  const int64_t n_split = (t_len + kSplitKeys - 1) / kSplitKeys;
  if (n_split <= kClusterSplits) return 0;
  return (int64_t)B * Hk * n_split * (Hq / Hk) * Sq * (D + 2);
}

template <typename T, typename KT, int D, int R, typename Cache>
cudaError_t launch_split(const void* q, const Cache& cache, int t_len,
                         const int* kv_len, void* o, float* part, int B,
                         int Sq, int Hq, int Hk, const int64_t* qo,
                         float scale, cudaStream_t stream) {
  using Sm = SplitSmem<KT, D, R>;
  auto kernel = flash_decode_split_kernel<T, KT, D, R, Cache>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sm::kBytes);
  if (err != cudaSuccess) return err;
  const int n_split = (t_len + kSplitKeys - 1) / kSplitKeys;
  const int n_rows = (Hq / Hk) * Sq;
  dim3 grid(B * Hk, n_split, (n_rows + R - 1) / R);
  if (n_split > 1 && n_split <= kClusterSplits) {
    // one launch: a cluster of the n_split blocks of each (batch row, kv
    // head, block of rows) folds in distributed shared memory
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Sm::kBytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = n_split;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, (const T*)q, cache, kv_len, (T*)o,
                             part, Sq, Hq, Hk, n_split, 1, qo[0], qo[1],
                             qo[2], qo[3], qo[4], qo[5], scale * kLog2e);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  kernel<<<grid, kThreads, Sm::kBytes, stream>>>(
      (const T*)q, cache, kv_len, (T*)o, part, Sq, Hq, Hk, n_split, 0, qo[0],
      qo[1], qo[2], qo[3], qo[4], qo[5], scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split <= 1) return err;
  // programmatic stream serialization: the combine kernel's prologue
  // overlaps the split kernel's tail (1.2 us faster than a plain launch
  // at a serving step, experiments/decode_probe.py)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B * Sq * Hq + kSplitWarps - 1) / kSplitWarps);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_decode_combine_kernel<T, D>,
                           (const float*)part, kv_len, (T*)o, B, Sq, Hq, Hk,
                           n_split, t_len, qo[3], qo[4], qo[5]);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// R = 1 for one row a (batch row, kv head), else blocks of kSplitRows.
template <typename T, typename KT, int D, typename Cache>
cudaError_t split_rows(const void* q, const Cache& cache, int t_len,
                       const int* kv_len, void* o, float* part, int B,
                       int Sq, int Hq, int Hk, const int64_t* qo,
                       float scale, cudaStream_t stream) {
  if ((Hq / Hk) * Sq == 1)
    return launch_split<T, KT, D, 1>(q, cache, t_len, kv_len, o, part, B,
                                     Sq, Hq, Hk, qo, scale, stream);
  return launch_split<T, KT, D, kSplitRows>(q, cache, t_len, kv_len, o, part,
                                            B, Sq, Hq, Hk, qo, scale, stream);
}

template <typename T, typename KT, typename Cache>
cudaError_t split_d(int D, const void* q, const Cache& cache, int t_len,
                    const int* kv_len, void* o, float* part, int B, int Sq,
                    int Hq, int Hk, const int64_t* qo, float scale,
                    cudaStream_t s) {
  switch (D) {
    case 16:
      return split_rows<T, KT, 16>(q, cache, t_len, kv_len, o, part, B, Sq,
                                   Hq, Hk, qo, scale, s);
    case 32:
      return split_rows<T, KT, 32>(q, cache, t_len, kv_len, o, part, B, Sq,
                                   Hq, Hk, qo, scale, s);
    case 64:
      return split_rows<T, KT, 64>(q, cache, t_len, kv_len, o, part, B, Sq,
                                   Hq, Hk, qo, scale, s);
    case 128:
      return split_rows<T, KT, 128>(q, cache, t_len, kv_len, o, part, B, Sq,
                                    Hq, Hk, qo, scale, s);
    case 256:
      return split_rows<T, KT, 256>(q, cache, t_len, kv_len, o, part, B, Sq,
                                    Hq, Hk, qo, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 bfloat16, 2 float16 (of q and o; of the cache too
// unless int8_cache). part: scratch of part_floats floats, at least
// split_scratch_floats.
template <typename Cache>
cudaError_t dispatch_split(int dtype, bool int8_cache, int D, const void* q,
                           const Cache& cache, const int* kv_len, void* o,
                           void* part, int64_t part_floats, int B, int Sq,
                           int Hq, int Hk, const int64_t* qo, float scale,
                           void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (B <= 0) return cudaSuccess;
  if (Sq <= 0 || Sq > kMaxQLen || Hk <= 0 || Hq % Hk != 0)
    return cudaErrorInvalidValue;
  if (int8_cache && (cache.ks == nullptr || cache.vs == nullptr))
    return cudaErrorInvalidValue;
  int t_len;
  if constexpr (kPaged<Cache>)
    t_len = cache.n_slots * cache.page;
  else
    t_len = cache.t_len;
  if (t_len <= 0) return cudaErrorInvalidValue;
  const int64_t need = split_scratch_floats(B, Sq, Hq, Hk, t_len, D);
  if (need > 0 && (part == nullptr || part_floats < need))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      return int8_cache ? split_d<float, int8_t>(D, q, cache, t_len, kv_len,
                                                 o, p, B, Sq, Hq, Hk, qo,
                                                 scale, s)
                        : split_d<float, float>(D, q, cache, t_len, kv_len, o,
                                                p, B, Sq, Hq, Hk, qo, scale,
                                                s);
    case 1:
      return int8_cache ? split_d<bf16, int8_t>(D, q, cache, t_len, kv_len, o,
                                                p, B, Sq, Hq, Hk, qo, scale,
                                                s)
                        : split_d<bf16, bf16>(D, q, cache, t_len, kv_len, o,
                                              p, B, Sq, Hq, Hk, qo, scale, s);
    case 2:
      return int8_cache ? split_d<__half, int8_t>(D, q, cache, t_len, kv_len,
                                                  o, p, B, Sq, Hq, Hk, qo,
                                                  scale, s)
                        : split_d<__half, __half>(D, q, cache, t_len, kv_len,
                                                  o, p, B, Sq, Hq, Hk, qo,
                                                  scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace paddle_flash
