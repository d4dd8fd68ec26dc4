// Flash-attention forward for prefill, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py
// _flash_fwd (:205; Pallas bodies _fwd_kernel_whole_k :165 and
// _fwd_kernel :77), reached through flash_attention (:1475).
//
// Computes o = softmax(q k^T * scale) v for q [B, Sq, Hq, D] and k/v
// [B, Sk, Hk, D], read in place through their strides (the model hands
// in views of its fused qkv projection, so no copy is made). Grouped
// query attention maps query head h to kv head h / (Hq / Hk). Causal
// masking aligns the diagonal bottom-right (offset Sk - Sq) and the loop
// stops at the block's last diagonal tile. Any Sq and Sk are taken: the
// ragged key tail and the ragged query tail are masked here, where the
// TPU wrapper refuses causal lengths off its 128 grid. The natural-log
// logsumexp is written only when a buffer is given.
//
// What bounds it on the H100: at the prefill shapes of the serving path
// (batch 1, 12 heads, 512 tokens, head_dim 64) the work is ~0.2 GFLOP
// per layer and ~3 MB of traffic, so the card's bound is about a
// microsecond and the real limits are latency and issue rate: one wave
// of 96 blocks does not fill 132 SMs, and this first version multiplies
// on the CUDA cores in fp32 (no tensor cores). What the design does
// about it: every q/k/v element is read from device memory once per
// block into padded shared memory, with 16-byte loads that are all in
// flight before the first is used, the score tile lives in registers,
// each thread reuses 4 query and 8 key values for 32 FMAs, and causal
// blocks skip every tile past their diagonal. Tensor cores (mma.sync,
// then wgmma with TMA) are the next step.
#include "flash_common.cuh"

namespace paddle_flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Hq, int Hk, int Sq, int Sk,
                     int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                     int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                     int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                     int causal, float qscale) {
  constexpr int BQ = 64;
  using L = Layout<BQ, D>;
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hk);
  const int q0 = blockIdx.y * BQ;
  const int cg = threadIdx.x % L::NCG;
  const int r0 = (threadIdx.x / L::NCG) * L::TR;

  const T* qb = q + b * q_sb + h * q_sh;
  stage_rows<T, BQ, D>(
      smem + L::kQ, [&](int r) -> const T* {
        return q0 + r < Sq ? qb + (q0 + r) * q_ss : nullptr;
      },
      (float*)nullptr, [](int) -> const T* { return nullptr; }, qscale,
      rows_aligned(qb, q_ss));

  const int offset = Sk - Sq;
  RowState<BQ, D> st;
#pragma unroll
  for (int i = 0; i < L::TR; ++i) {
    const int row = q0 + r0 + i;
    st.lim[i] = causal ? min(row + offset, Sk - 1) : Sk - 1;
  }
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int n_keys = causal ? max(0, min(Sk, last_row + offset + 1)) : Sk;
  __syncthreads();

  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  attend<T, BQ, D>(smem, Strided<T>{kb, k_ss}, Strided<T>{vb, v_ss},
                   rows_aligned(kb, k_ss) && rows_aligned(vb, v_ss), n_keys,
                   st);

  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < L::TR; ++i) {
    const int row = q0 + r0 + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < L::TD; ++j)
      ob[row * o_ss + cg + j * L::NCG] = from_float<T>(out_value(st, i, j));
    if (lse != nullptr && cg == 0)
      lse[(int64_t)bh * Sq + row] = row_lse(st, i);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Hq, int Hk, int Sq, int Sk,
                   const int64_t* st, int causal, float scale,
                   cudaStream_t stream) {
  using L = Layout<64, D>;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hq, (Sq + 63) / 64);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Hq, Hk, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int Hq, int Hk, int Sq,
                       int Sk, const int64_t* st, int causal, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, Hq, Hk, Sq, Sk, st, causal,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, Hq, Hk, Sq, Sk, st, causal,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, Hq, Hk, Sq, Sk, st, causal,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, Hq, Hk, Sq, Sk, st, causal,
                           scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, B, Hq, Hk, Sq, Sk, st, causal,
                           scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace paddle_flash

// dtype: 0 float32, 1 bfloat16, 2 float16. strides: 12 element strides,
// (batch, seq, head) of q, k, v and o in that order; head_dim must be
// contiguous. lse may be null. Returns the launch's cudaError_t.
extern "C" int paddle_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, float* lse, int dtype, int B, int Hq,
                                int Hk, int Sq, int Sk, int D,
                                const int64_t* strides, int causal,
                                float scale, void* stream) {
  using namespace paddle_flash;
  cudaGetLastError();  // start from a clean error state
  if (B <= 0 || Sq <= 0) return cudaSuccess;
  if (Hk <= 0 || Hq % Hk != 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch_d<float>(D, q, k, v, o, lse, B, Hq, Hk, Sq, Sk, strides,
                               causal, scale, s);
    case 1:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, Hq, Hk, Sq, Sk,
                                       strides, causal, scale, s);
    case 2:
      return dispatch_d<__half>(D, q, k, v, o, lse, B, Hq, Hk, Sq, Sk,
                                strides, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
