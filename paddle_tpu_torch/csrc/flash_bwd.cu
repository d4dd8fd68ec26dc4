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
//   (a) flash_bwd_dkdv_kernel: one block per (batch, kv head, key tile)
//       keeps its K/V tile in shared memory and the tile's dK/dV sums in
//       fp32 registers, and walks every query head of its GQA group and
//       every query tile that can see the key tile. Summing the group's
//       heads inside one block is what makes GQA right with no repeat.
//   (b) flash_bwd_dq_kernel: one block per (batch, q head, query tile)
//       keeps its Q/dO tile and dQ sums, and walks the visible key tiles.
// Causal masking aligns the diagonal bottom-right (offset Sk - Sq) as the
// forward does; any Sq and Sk are taken (the tile loader zero-fills
// ragged tails). Tensors are read and written through their (batch,
// seq, head) strides.
//
// What bounds it on the H100: five products of 2 * pairs * D FLOPs per
// head against ~12 bytes per (row, head_dim) element, so at the training
// shapes (S = 1024, D = 64) it is far above the ridge point and bound by
// operations. This first version multiplies on the CUDA cores in fp32
// (no tensor cores), so it is bound by the fp32 FMA rate and by
// shared-memory reads, a long way above the tensor-core bound. What the
// design does about it: every tile is staged once per block with 16-byte
// loads (flash_common.cuh), each thread reuses register tiles for
// 2*TR*TC FMAs per d step in the score phase and 2*TKR*TDJ in the
// accumulation phase, and causal blocks skip every tile that cannot see
// their rows. Tensor cores (mma.sync, then wgmma) are the next step.
#include "flash_common.cuh"

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

template <typename T>
cudaError_t dispatch_bwd(int D, const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, void* dk, void* dv,
                         int B, int Hq, int Hk, int Sq, int Sk,
                         const BwdStrides& st, int causal, float scale,
                         cudaStream_t stream) {
#define PADDLE_BWD_CASE(DIM)                                                  \
  case DIM:                                                                   \
    return launch_bwd<T, DIM>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq,  \
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
