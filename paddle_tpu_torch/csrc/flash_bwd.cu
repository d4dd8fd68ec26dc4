// Flash-attention backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/kernels/flash_attention.py's
// custom VJP (_flash_bhsd_bwd :809): _flash_bwd (:714, split Pallas
// bodies _bwd_dq_kernel :304 and _bwd_dkv_kernel :352), _flash_bwd_fused
// (:673, _bwd_fused_kernel :441) and _flash_bwd_fused_tiled (:628,
// _bwd_fused_tiled_kernel :509). One design serves every length: the
// split variant's two passes.
//
// Given q [B, Sq, Hq, D], k/v [B, Sk, Hk, D], the output's cotangent dO
// [B, Sq, Hq, D], the forward's natural-log logsumexp lse [B, Hq, Sq]
// and delta = rowsum(dO * O) [B, Hq, Sq] (both fp32; the wrapper
// computes delta with one torch reduction, as the JAX package computes
// it outside its Pallas bodies, :722), it recomputes
//   P  = exp(q k^T * scale - lse)        (0 where masked or lse = -inf)
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - delta)
//   dQ = dS K * scale,   dK = dS^T Q * scale
// in two launches, with no atomics, so the result is deterministic:
//   (a) the dK/dV kernel (both routes): one block per (batch, kv head,
//       key tile) keeps its K/V tile in shared memory and the tile's
//       dK/dV sums in fp32 registers, and walks every query head of its
//       GQA group and every query tile that can see the key tile. Summing
//       the group's heads inside one block is what makes GQA right with
//       no repeat.
//   (b) the dQ kernel (both routes): one block per (batch, q head, query
//       tile) keeps its Q/dO tile and dQ sums, and walks the visible key
//       tiles.
// Causal masking aligns the diagonal bottom-right (offset Sk - Sq) as the
// forward does; any Sq and Sk are taken (the tile loaders zero-fill
// ragged tails). Tensors are read and written through their (batch,
// seq, head) strides.
//
// Two routes, chosen by (dtype, D) before any launch (mma_route in
// flash_mma.cuh, as the forward's):
//   bf16 / fp16 at D = 16..128: flash_bwd_dkdv_mma_kernel and
//     flash_bwd_dq_mma_kernel put every product on the tensor cores
//     (mma.sync.m16n8k16, fp32 accumulation; notes at each kernel). P and
//     dS enter the products that consume them as two terms of the input
//     type (hi + lo, flash_mma.cuh), where the JAX kernels round them
//     once (:344, :389, :396), which the card's training rule would not
//     take; everything else stays fp32.
//   fp32 at any D, and D = 256: flash_bwd_dkdv_kernel and
//     flash_bwd_dq_kernel, on the CUDA cores in fp32: fp32 is held to
//     1e-4 of the plain version, and a warp's accumulators would not fit
//     at D = 256.
//
// What bounds it on the H100: the five products of the algorithm, 2 *
// pairs * D FLOPs each (10 * pairs * D; 0.065 ms at 989 TFLOP/s at the
// training shape [16, 1024, 12, 64] causal), against ~12 bytes per
// (row, head_dim) element: far above the ridge point, bound by
// operations. The two-launch design computes seven: S and dP are
// computed in both kernels. FlashAttention-2 reaches five by adding dQ
// into fp32 with atomics from the dK/dV pass, which would give up the
// bitwise repeat this port holds (every output is written once, by one
// block, in a fixed order, so results repeat bit for bit and do not
// change with the batch or the grid). Seven products make its ceiling
// 1.4x the bound; the two-term P and dS of dV, dK and dQ make them 10
// tensor-core passes, 2x the bound, before mma.sync's own ceiling of
// about two thirds of wgmma's rate. Register pressure is the other limit: a dK/dV warp holds dK and
// dV (D fp32 a thread) beside S^T and dP^T, so the q-step
// shrinks to 32 rows at D = 128 (MmaBwdCfg).
#include "flash_mma.cuh"

namespace paddle_flash {

// (batch, seq, head) element strides of q, k, v, dO, dq, dk and dv
struct BwdStrides {
  int64_t s[21];
};

template <int D>
struct BwdCfg {
  // dK/dV kernel: key rows per block, query rows per step. The fp32
  // dK/dV sums live in registers, 2 * BKV * D / 128 per thread.
  static constexpr int BKV = D >= 256 ? 16 : (D >= 128 ? 32 : 64);
  static constexpr int BQV = D >= 256 ? 32 : 64;
  // dQ kernel: query rows per block, key rows per step
  static constexpr int BQQ = D >= 256 ? 16 : (D >= 128 ? 32 : 64);
  static constexpr int BKQ = D >= 256 ? 32 : 64;
  static constexpr int DP = D + 1;
  static constexpr size_t dkdv_bytes =
      (2 * BKV * DP + 2 * BQV * DP + 2 * BQV * (BKV + 1) + 2 * BQV) *
      sizeof(float);
  static constexpr size_t dq_bytes =
      (2 * BQQ * DP + 2 * BKQ * DP + BQQ * (BKQ + 1) + 2 * BQQ) *
      sizeof(float);
};

// Thread layout of a [BQ x BK] score tile: NRG row groups x NCG column
// groups; a thread owns TR consecutive rows and the TC columns cg,
// cg + NCG, ...
template <int BQ, int BK>
struct ScoreLayout {
  static constexpr int NCG = BK < 16 ? BK : 16;
  static constexpr int NRG = kThreads / NCG;
  static constexpr int TR = BQ / NRG;
  static constexpr int TC = BK / NCG;
  static_assert(TR * NRG == BQ && TC * NCG == BK, "score tile split");
};

// Thread layout of a [ROWS x D] fp32 accumulator: a thread owns TKR
// consecutive rows and the TDJ columns dg, dg + NDG, ...
template <int ROWS, int D>
struct AccLayout {
  static constexpr int NDG = D < 16 ? D : 16;
  static constexpr int NKG = kThreads / NDG;
  static constexpr int TKR = ROWS / NKG;
  static constexpr int TDJ = D / NDG;
  static_assert(TKR * NKG == ROWS && TDJ * NDG == D, "accumulator split");
};

// P and dS of one [BQ x BK] tile from the staged (unscaled) q, dO, k, v
// rows. l2 holds each row's logsumexp in base 2 (-inf for rows past Sq
// or fully masked), dl its delta. Writes P to ps (when given) and dS to
// dss, both [BQ][BK + 1]. q0/k0 are the tile's first row and column.
template <int BQ, int BK, int D>
__device__ __forceinline__ void score_tile(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* l2, const float* dl, int q0, int k0, int Sk, int offset,
    int causal, float qk2, float* ps, float* dss) {
  using S = ScoreLayout<BQ, BK>;
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  const int cg = threadIdx.x % S::NCG;
  const int r0 = (threadIdx.x / S::NCG) * S::TR;
  float s[S::TR][S::TC], dp[S::TR][S::TC];
#pragma unroll
  for (int i = 0; i < S::TR; ++i)
#pragma unroll
    for (int j = 0; j < S::TC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[S::TR], ov[S::TR], kv[S::TC], vv[S::TC];
#pragma unroll
    for (int i = 0; i < S::TR; ++i) {
      qv[i] = qs[(r0 + i) * DP + d];
      ov[i] = dos[(r0 + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < S::TC; ++j) {
      kv[j] = ks[(cg + j * S::NCG) * DP + d];
      vv[j] = vs[(cg + j * S::NCG) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < S::TR; ++i)
#pragma unroll
      for (int j = 0; j < S::TC; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < S::TR; ++i) {
    const int r = r0 + i;
    const int row = q0 + r;
    const float lse2 = l2[r];
    const float delta = dl[r];
#pragma unroll
    for (int j = 0; j < S::TC; ++j) {
      const int c = cg + j * S::NCG;
      const int col = k0 + c;
      const bool ok = col < Sk && lse2 != -INFINITY &&
                      (!causal || col <= row + offset);
      const float p = ok ? exp2f(s[i][j] * qk2 - lse2) : 0.f;
      if (ps != nullptr) ps[r * PP + c] = p;
      dss[r * PP + c] = p * (dp[i][j] - delta);
    }
  }
}

// Stage rows [q0, q0 + BQ) of q and dO of head h, with their base-2
// logsumexp and delta (rows past Sq: zeros and -inf).
template <typename T, int BQ, int D>
__device__ __forceinline__ void stage_queries(
    float* qs, float* dos, float* l2, float* dl, const T* qb, int64_t q_ss,
    const T* ob, int64_t o_ss, const float* lse_row, const float* delta_row,
    int q0, int Sq) {
  stage_rows<T, BQ, D>(
      qs, [&](int r) -> const T* {
        return q0 + r < Sq ? qb + (int64_t)(q0 + r) * q_ss : nullptr;
      },
      dos, [&](int r) -> const T* {
        return q0 + r < Sq ? ob + (int64_t)(q0 + r) * o_ss : nullptr;
      },
      1.f, rows_aligned(qb, q_ss) && rows_aligned(ob, o_ss));
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int row = q0 + r;
    l2[r] = row < Sq ? lse_row[row] * kLog2e : -INFINITY;
    dl[r] = row < Sq ? delta_row[row] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int Hq, int Hk, int Sq, int Sk,
                          BwdStrides st, int causal, float scale) {
  using C = BwdCfg<D>;
  constexpr int BK = C::BKV, BQ = C::BQV, DP = C::DP;
  using A = AccLayout<BK, D>;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * DP;
  float* qs = vs + BK * DP;
  float* dos = qs + BQ * DP;
  float* ps = dos + BQ * DP;
  float* dss = ps + BQ * (BK + 1);
  float* l2 = dss + BQ * (BK + 1);
  float* dl = l2 + BQ;
  const int64_t* s = st.s;
  const int b = blockIdx.x / Hk;
  const int hk = blockIdx.x % Hk;
  const int G = Hq / Hk;
  const int k0 = blockIdx.y * BK;
  const int offset = Sk - Sq;
  const float qk2 = scale * kLog2e;

  const T* kb = k + b * s[3] + hk * s[5];
  const T* vb = v + b * s[6] + hk * s[8];
  stage_rows<T, BK, D>(
      ks, [&](int c) -> const T* {
        return k0 + c < Sk ? kb + (int64_t)(k0 + c) * s[4] : nullptr;
      },
      vs, [&](int c) -> const T* {
        return k0 + c < Sk ? vb + (int64_t)(k0 + c) * s[7] : nullptr;
      },
      1.f, rows_aligned(kb, s[4]) && rows_aligned(vb, s[7]));

  const int dg = threadIdx.x % A::NDG;
  const int c0 = (threadIdx.x / A::NDG) * A::TKR;
  float acc_k[A::TKR][A::TDJ], acc_v[A::TKR][A::TDJ];
#pragma unroll
  for (int i = 0; i < A::TKR; ++i)
#pragma unroll
    for (int j = 0; j < A::TDJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // the first query row that sees column k0 (every later row does too)
  const int first = causal ? max(0, k0 - offset) : 0;
  for (int h = hk * G; h < (hk + 1) * G; ++h) {
    const T* qb = q + b * s[0] + h * s[2];
    const T* ob = dout + b * s[9] + h * s[11];
    const float* lse_row = lse + ((int64_t)b * Hq + h) * Sq;
    const float* delta_row = delta + ((int64_t)b * Hq + h) * Sq;
    for (int q0 = (first / BQ) * BQ; q0 < Sq; q0 += BQ) {
      __syncthreads();  // the previous step's readers are done
      stage_queries<T, BQ, D>(qs, dos, l2, dl, qb, s[1], ob, s[10], lse_row,
                              delta_row, q0, Sq);
      __syncthreads();
      score_tile<BQ, BK, D>(qs, dos, ks, vs, l2, dl, q0, k0, Sk, offset,
                            causal, qk2, ps, dss);
      __syncthreads();
      const int rmax = min(BQ, Sq - q0);
      for (int r = 0; r < rmax; ++r) {
        float pv[A::TKR], dsv[A::TKR], ov[A::TDJ], qv[A::TDJ];
#pragma unroll
        for (int i = 0; i < A::TKR; ++i) {
          pv[i] = ps[r * (BK + 1) + c0 + i];
          dsv[i] = dss[r * (BK + 1) + c0 + i];
        }
#pragma unroll
        for (int j = 0; j < A::TDJ; ++j) {
          ov[j] = dos[r * DP + dg + j * A::NDG];
          qv[j] = qs[r * DP + dg + j * A::NDG];
        }
#pragma unroll
        for (int i = 0; i < A::TKR; ++i)
#pragma unroll
          for (int j = 0; j < A::TDJ; ++j) {
            acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(dsv[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }

  T* dkb = dk + b * s[15] + hk * s[17];
  T* dvb = dv + b * s[18] + hk * s[20];
#pragma unroll
  for (int i = 0; i < A::TKR; ++i) {
    const int col = k0 + c0 + i;
    if (col >= Sk) continue;
#pragma unroll
    for (int j = 0; j < A::TDJ; ++j) {
      const int e = dg + j * A::NDG;
      dkb[(int64_t)col * s[16] + e] = from_float<T>(acc_k[i][j] * scale);
      dvb[(int64_t)col * s[19] + e] = from_float<T>(acc_v[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Hq, int Hk, int Sq, int Sk, BwdStrides st,
                        int causal, float scale) {
  using C = BwdCfg<D>;
  constexpr int BQ = C::BQQ, BK = C::BKQ, DP = C::DP;
  using A = AccLayout<BQ, D>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * DP;
  float* ks = dos + BQ * DP;
  float* vs = ks + BK * DP;
  float* dss = vs + BK * DP;
  float* l2 = dss + BQ * (BK + 1);
  float* dl = l2 + BQ;
  const int64_t* s = st.s;
  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hk);
  const int q0 = blockIdx.y * BQ;
  const int offset = Sk - Sq;
  const float qk2 = scale * kLog2e;

  stage_queries<T, BQ, D>(qs, dos, l2, dl, q + b * s[0] + h * s[2], s[1],
                          dout + b * s[9] + h * s[11], s[10],
                          lse + ((int64_t)b * Hq + h) * Sq,
                          delta + ((int64_t)b * Hq + h) * Sq, q0, Sq);

  const int dg = threadIdx.x % A::NDG;
  const int r0 = (threadIdx.x / A::NDG) * A::TKR;
  float acc[A::TKR][A::TDJ];
#pragma unroll
  for (int i = 0; i < A::TKR; ++i)
#pragma unroll
    for (int j = 0; j < A::TDJ; ++j) acc[i][j] = 0.f;

  const int last_row = min(q0 + BQ, Sq) - 1;
  const int n_keys = causal ? max(0, min(Sk, last_row + offset + 1)) : Sk;
  const T* kb = k + b * s[3] + hk * s[5];
  const T* vb = v + b * s[6] + hk * s[8];
  const bool vec = rows_aligned(kb, s[4]) && rows_aligned(vb, s[7]);
  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    __syncthreads();  // the previous step's readers of ks are done
    stage_rows<T, BK, D>(
        ks, [&](int c) -> const T* {
          return k0 + c < Sk ? kb + (int64_t)(k0 + c) * s[4] : nullptr;
        },
        vs, [&](int c) -> const T* {
          return k0 + c < Sk ? vb + (int64_t)(k0 + c) * s[7] : nullptr;
        },
        1.f, vec);
    __syncthreads();
    score_tile<BQ, BK, D>(qs, dos, ks, vs, l2, dl, q0, k0, Sk, offset,
                          causal, qk2, nullptr, dss);
    __syncthreads();
    const int cmax = min(BK, n_keys - k0);
    for (int c = 0; c < cmax; ++c) {
      float dsv[A::TKR], kv[A::TDJ];
#pragma unroll
      for (int i = 0; i < A::TKR; ++i) dsv[i] = dss[(r0 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < A::TDJ; ++j) kv[j] = ks[c * DP + dg + j * A::NDG];
#pragma unroll
      for (int i = 0; i < A::TKR; ++i)
#pragma unroll
        for (int j = 0; j < A::TDJ; ++j)
          acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  T* dqb = dq + b * s[12] + h * s[14];
#pragma unroll
  for (int i = 0; i < A::TKR; ++i) {
    const int row = q0 + r0 + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < A::TDJ; ++j)
      dqb[(int64_t)row * s[13] + dg + j * A::NDG] =
          from_float<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dq, void* dk, void* dv, int B, int Hq, int Hk,
                       int Sq, int Sk, const BwdStrides& st, int causal,
                       float scale, cudaStream_t stream) {
  using C = BwdCfg<D>;
  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  auto dqk = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::dkdv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::dq_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid_kv(B * Hk, (Sk + C::BKV - 1) / C::BKV);
  dkdv<<<grid_kv, kThreads, C::dkdv_bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, Hq, Hk, Sq, Sk, st, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_q(B * Hq, (Sq + C::BQQ - 1) / C::BQQ);
  dqk<<<grid_q, kThreads, C::dq_bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, Hq, Hk, Sq, Sk, st, causal, scale);
  return cudaGetLastError();
}

// ------------------------------------------------- tensor-core route

template <int D>
struct MmaBwdCfg {
  static constexpr int BK = 64;                 // key rows of a dK/dV block
  static constexpr int BQ = D <= 64 ? 64 : 32;  // its query rows a step
  static constexpr int BQQ = 64;                // query rows of a dQ block
  static constexpr int S = kRow<D>;
  // K, V; two stages of (Q, dO) and of (lse, delta)
  static constexpr size_t dkdv_bytes =
      (2 * BK + 4 * BQ) * S * 2 + 4 * BQ * sizeof(float);
  // Q, dO; two stages of (K, V)
  static constexpr size_t dq_bytes = (2 * BQQ + 4 * BK) * S * 2;
};

// (a) on the tensor cores: a block of 4 warps owns 64 key rows of one
// (batch, kv head), 16 rows a warp, with K and V in shared memory, and
// walks every query head of its GQA group and every visible q-tile, Q,
// dO, lse and delta coming in by cp.async into two stages. Per tile a
// warp computes S^T = K Q^T (its key rows as the A operand, so P^T lands
// in the accumulator layout of its own rows), P^T, dV += P^T dO,
// dP^T = V dO^T, dS^T = P^T (dP^T - delta) and dK += dS^T Q, with P^T
// and dS^T fed from registers in two terms; dK and dV stay in fp32
// registers for the whole walk and are written once.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkdv_mma_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int Hq,
                              int Hk, int Sq, int Sk, BwdStrides st,
                              int causal, float scale) {
  using C = MmaBwdCfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, S = C::S;
  constexpr int NQ = BQ / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BK * S;
  T* qd = vs + BK * S;   // [2][Q, dO][BQ][S]
  float* ld = reinterpret_cast<float*>(qd + 4 * BQ * S);   // [2][lse, dl][BQ]
  const int64_t* s = st.s;
  const int b = blockIdx.x / Hk;
  const int hk = blockIdx.x % Hk;
  const int G = Hq / Hk;
  const int k0 = blockIdx.y * BK;
  const int offset = Sk - Sq;
  const float qk2 = scale * kLog2e;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lo_a = lane_off_a<D>(), lo_b = lane_off_b<D>();

  const T* kb = k + b * s[3] + hk * s[5];
  const T* vb = v + b * s[6] + hk * s[8];
  const bool kv_vec = rows_aligned(kb, s[4]) && rows_aligned(vb, s[7]);
  tile_to_smem<T, BK, D>(
      ks, [&](int c) -> const T* {
        return k0 + c < Sk ? kb + (k0 + c) * s[4] : nullptr;
      },
      kb, kv_vec);
  tile_to_smem<T, BK, D>(
      vs, [&](int c) -> const T* {
        return k0 + c < Sk ? vb + (k0 + c) * s[7] : nullptr;
      },
      vb, kv_vec);

  // the first query row that sees column k0 (every later row does too)
  const int first = causal ? max(0, k0 - offset) : 0;
  const int qfirst = (first / BQ) * BQ;
  const int nq = qfirst < Sq ? (Sq - qfirst + BQ - 1) / BQ : 0;
  const int n_steps = G * nq;
  auto load_q = [&](int i) {
    const int h = hk * G + i / nq, q0 = qfirst + (i % nq) * BQ;
    T* qs = qd + (i & 1) * 2 * BQ * S;
    const T* qb = q + b * s[0] + h * s[2];
    const T* ob = dout + b * s[9] + h * s[11];
    tile_to_smem<T, BQ, D>(
        qs, [&](int r) -> const T* {
          return q0 + r < Sq ? qb + (q0 + r) * s[1] : nullptr;
        },
        qb, rows_aligned(qb, s[1]));
    tile_to_smem<T, BQ, D>(
        qs + BQ * S, [&](int r) -> const T* {
          return q0 + r < Sq ? ob + (q0 + r) * s[10] : nullptr;
        },
        ob, rows_aligned(ob, s[10]));
    float* l = ld + (i & 1) * 2 * BQ;
    const float* lrow = lse + ((int64_t)b * Hq + h) * Sq;
    const float* drow = delta + ((int64_t)b * Hq + h) * Sq;
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool ok = q0 + r < Sq;
      cp_async4(l + r, lrow + (ok ? q0 + r : 0), ok);
      cp_async4(l + BQ + r, drow + (ok ? q0 + r : 0), ok);
    }
  };
  if (n_steps > 0) load_q(0);
  cp_async_wait_all();
  __syncthreads();

  float dk_acc[ND][4], dv_acc[ND][4];
  zero(dk_acc);
  zero(dv_acc);
  const int key0 = k0 + 16 * warp + g;   // this lane's first key row
  for (int i = 0; i < n_steps; ++i) {
    if (i > 0) {
      cp_async_wait_all();   // step i has landed
      __syncthreads();       // and every warp is done with step i - 1
    }
    if (i + 1 < n_steps) load_q(i + 1);
    const int q0 = qfirst + (i % nq) * BQ;
    const T* qs = qd + (i & 1) * 2 * BQ * S;
    const T* dos = qs + BQ * S;
    const float* l = ld + (i & 1) * 2 * BQ;

    float sp[NQ][4];   // S^T, then P^T
    zero(sp);
    mma_nt<T, D, NQ>(
        sp, [&](int kk, uint32_t(&f)[4]) {
          load_a_frag<D>(f, ks + 16 * warp * S, kk, lo_a);
        },
        qs, lo_b);
    const bool masked = causal && k0 + BK - 1 > q0 + offset;
#pragma unroll
    for (int ni = 0; ni < NQ; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = ni * 8 + 2 * t + (r & 1);   // query in the tile
        const float lr = l[c];
        // rows past Sq and rows that saw nothing (lse = -inf) give 0
        const float l2 =
            q0 + c < Sq && lr != -INFINITY ? lr * kLog2e : INFINITY;
        float p = exp2f(fmaf(sp[ni][r], qk2, -l2));
        if (masked && key0 + 8 * (r >> 1) > q0 + c + offset) p = 0.f;
        sp[ni][r] = p;
      }
    mma_nn<T, D, NQ>(dv_acc, sp, dos, lo_a);   // dV += P^T dO

    float ds[NQ][4];   // dP^T, then dS^T
    zero(ds);
    mma_nt<T, D, NQ>(
        ds, [&](int kk, uint32_t(&f)[4]) {
          load_a_frag<D>(f, vs + 16 * warp * S, kk, lo_a);
        },
        dos, lo_b);
#pragma unroll
    for (int ni = 0; ni < NQ; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        ds[ni][r] =
            sp[ni][r] * (ds[ni][r] - l[BQ + ni * 8 + 2 * t + (r & 1)]);
    mma_nn<T, D, NQ>(dk_acc, ds, qs, lo_a);    // dK += dS^T Q
  }

  T* dkb = dk + b * s[15] + hk * s[17];
  T* dvb = dv + b * s[18] + hk * s[20];
  const bool pair = reinterpret_cast<uintptr_t>(dkb) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(dvb) % 4 == 0 &&
                    s[16] % 2 == 0 && s[19] % 2 == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int col = key0 + 8 * i;
    if (col >= Sk) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int e = nd * 8 + 2 * t;
      store2(dkb + col * s[16] + e, dk_acc[nd][2 * i] * scale,
             dk_acc[nd][2 * i + 1] * scale, pair);
      store2(dvb + col * s[19] + e, dv_acc[nd][2 * i],
             dv_acc[nd][2 * i + 1], pair);
    }
  }
}

// (b) on the tensor cores: a block of 4 warps owns 64 query rows of one
// (batch, head), 16 rows a warp, with Q and dO in shared memory and each
// row's lse and delta in registers, and walks the visible key tiles, K
// and V coming in by cp.async into two stages. Per tile a warp computes
// S = Q K^T, P, dP = dO V^T, dS = P (dP - delta) and dQ += dS K (dS in
// two terms, K's fragments through ldmatrix.trans); dQ stays in fp32
// registers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int Hq, int Hk, int Sq,
                            int Sk, BwdStrides st, int causal, float scale) {
  using C = MmaBwdCfg<D>;
  constexpr int BQ = C::BQQ, BK = C::BK, S = C::S;
  constexpr int NK = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + BQ * S;
  T* kvs = dos + BQ * S;   // [2][K, V][BK][S]
  const int64_t* s = st.s;
  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int offset = Sk - Sq;
  const float qk2 = scale * kLog2e;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lo_a = lane_off_a<D>(), lo_b = lane_off_b<D>();

  const T* qb = q + b * s[0] + h * s[2];
  const T* ob = dout + b * s[9] + h * s[11];
  tile_to_smem<T, BQ, D>(
      qs, [&](int r) -> const T* {
        return q0 + r < Sq ? qb + (q0 + r) * s[1] : nullptr;
      },
      qb, rows_aligned(qb, s[1]));
  tile_to_smem<T, BQ, D>(
      dos, [&](int r) -> const T* {
        return q0 + r < Sq ? ob + (q0 + r) * s[10] : nullptr;
      },
      ob, rows_aligned(ob, s[10]));

  const int last_row = min(q0 + BQ, Sq) - 1;
  const int n_keys = causal ? max(0, min(Sk, last_row + offset + 1)) : Sk;
  const int n_tiles = (n_keys + BK - 1) / BK;
  const int lim_min = causal ? min(q0 + offset, Sk - 1) : Sk - 1;
  const T* kb = k + b * s[3] + hk * s[5];
  const T* vb = v + b * s[6] + hk * s[8];
  const bool kv_vec = rows_aligned(kb, s[4]) && rows_aligned(vb, s[7]);
  auto load_kv = [&](int j) {
    T* kt_s = kvs + (j & 1) * 2 * BK * S;
    const int kt = j * BK;
    tile_to_smem<T, BK, D>(
        kt_s, [&](int c) -> const T* {
          return kt + c < n_keys ? kb + (kt + c) * s[4] : nullptr;
        },
        kb, kv_vec);
    tile_to_smem<T, BK, D>(
        kt_s + BK * S, [&](int c) -> const T* {
          return kt + c < n_keys ? vb + (kt + c) * s[7] : nullptr;
        },
        vb, kv_vec);
  };
  if (n_tiles > 0) load_kv(0);

  float l2[2], dl[2];
  int lim[2];
  const float* lrow = lse + ((int64_t)b * Hq + h) * Sq;
  const float* drow = delta + ((int64_t)b * Hq + h) * Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + g + 8 * i;
    const float lr = row < Sq ? lrow[row] : -INFINITY;
    l2[i] = lr != -INFINITY ? lr * kLog2e : INFINITY;   // -inf: P = 0
    dl[i] = row < Sq ? drow[row] : 0.f;
    lim[i] = causal ? min(row + offset, Sk - 1) : Sk - 1;
  }
  cp_async_wait_all();
  __syncthreads();

  float dq_acc[ND][4];
  zero(dq_acc);
  for (int j = 0; j < n_tiles; ++j) {
    if (j > 0) {
      cp_async_wait_all();   // tile j has landed
      __syncthreads();       // and every warp is done with tile j - 1
    }
    if (j + 1 < n_tiles) load_kv(j + 1);
    const T* kt_s = kvs + (j & 1) * 2 * BK * S;
    const T* vt_s = kt_s + BK * S;
    const int kt = j * BK;

    float sp[NK][4];   // S, then P
    zero(sp);
    mma_nt<T, D, NK>(
        sp, [&](int kk, uint32_t(&f)[4]) {
          load_a_frag<D>(f, qs + 16 * warp * S, kk, lo_a);
        },
        kt_s, lo_b);
    const bool masked = kt + BK - 1 > lim_min;
#pragma unroll
    for (int ni = 0; ni < NK; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = exp2f(fmaf(sp[ni][r], qk2, -l2[r >> 1]));
        if (masked && kt + ni * 8 + 2 * t + (r & 1) > lim[r >> 1]) p = 0.f;
        sp[ni][r] = p;
      }
    float ds[NK][4];   // dP, then dS
    zero(ds);
    mma_nt<T, D, NK>(
        ds, [&](int kk, uint32_t(&f)[4]) {
          load_a_frag<D>(f, dos + 16 * warp * S, kk, lo_a);
        },
        vt_s, lo_b);
#pragma unroll
    for (int ni = 0; ni < NK; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        ds[ni][r] = sp[ni][r] * (ds[ni][r] - dl[r >> 1]);
    mma_nn<T, D, NK>(dq_acc, ds, kt_s, lo_a);   // dQ += dS K
  }

  T* dqb = dq + b * s[12] + h * s[14];
  const bool pair = reinterpret_cast<uintptr_t>(dqb) % 4 == 0 &&
                    s[13] % 2 == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + g + 8 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      store2(dqb + row * s[13] + nd * 8 + 2 * t, dq_acc[nd][2 * i] * scale,
             dq_acc[nd][2 * i + 1] * scale, pair);
  }
}

template <typename T, int D>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, void* dk, void* dv,
                           int B, int Hq, int Hk, int Sq, int Sk,
                           const BwdStrides& st, int causal, float scale,
                           cudaStream_t stream) {
  using C = MmaBwdCfg<D>;
  auto dkdv = flash_bwd_dkdv_mma_kernel<T, D>;
  auto dqk = flash_bwd_dq_mma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::dkdv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::dq_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid_kv(B * Hk, (Sk + C::BK - 1) / C::BK);
  dkdv<<<grid_kv, kThreads, C::dkdv_bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, Hq, Hk, Sq, Sk, st, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_q(B * Hq, (Sq + C::BQQ - 1) / C::BQQ);
  dqk<<<grid_q, kThreads, C::dq_bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, Hq, Hk, Sq, Sk, st, causal, scale);
  return cudaGetLastError();
}

// bf16 and fp16 at D <= 128 take the tensor cores (mma_route); fp32 and
// D = 256 the fp32 kernels
template <typename T>
cudaError_t dispatch_bwd(int D, const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, void* dk, void* dv,
                         int B, int Hq, int Hk, int Sq, int Sk,
                         const BwdStrides& st, int causal, float scale,
                         cudaStream_t stream) {
#define PADDLE_BWD_CASE(DIM)                                                  \
  case DIM:                                                                   \
    if constexpr (mma_route(kDtype<T>, DIM))                                  \
      return launch_bwd_mma<T, DIM>(q, k, v, dout, lse, delta, dq, dk, dv, B, \
                                    Hq, Hk, Sq, Sk, st, causal, scale,        \
                                    stream);                                  \
    else                                                                      \
      return launch_bwd<T, DIM>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, \
                                Hk, Sq, Sk, st, causal, scale, stream);
  switch (D) {
    PADDLE_BWD_CASE(16)
    PADDLE_BWD_CASE(32)
    PADDLE_BWD_CASE(64)
    PADDLE_BWD_CASE(128)
    PADDLE_BWD_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PADDLE_BWD_CASE
}

}  // namespace paddle_flash

// dtype: 0 float32, 1 bfloat16, 2 float16. strides: 21 element strides,
// (batch, seq, head) of q, k, v, dout, dq, dk and dv in that order;
// head_dim must be contiguous. lse and delta are contiguous fp32
// [B, Hq, Sq]. Returns the first failing launch's cudaError_t.
extern "C" int paddle_flash_bwd(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq, void* dk,
                                void* dv, int dtype, int B, int Hq, int Hk,
                                int Sq, int Sk, int D, const int64_t* strides,
                                int causal, float scale, void* stream) {
  using namespace paddle_flash;
  cudaGetLastError();  // start from a clean error state
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hk <= 0 || Hq % Hk != 0)
    return cudaErrorInvalidValue;
  BwdStrides st;
  for (int i = 0; i < 21; ++i) st.s[i] = strides[i];
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch_bwd<float>(D, q, k, v, dout, lse, delta, dq, dk, dv, B,
                                 Hq, Hk, Sq, Sk, st, causal, scale, s);
    case 1:
      return dispatch_bwd<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dq, dk,
                                         dv, B, Hq, Hk, Sq, Sk, st, causal,
                                         scale, s);
    case 2:
      return dispatch_bwd<__half>(D, q, k, v, dout, lse, delta, dq, dk, dv, B,
                                  Hq, Hk, Sq, Sk, st, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
