// Flash-attention forward for prefill and training, hand-written for
// Hopper (sm_90a).
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
// TPU wrapper refuses causal lengths off its 128 grid. A row with no
// visible column gives zeros and LSE = -inf. The natural-log logsumexp
// is written only when a buffer is given.
//
// Two routes, chosen by (dtype, D) before any launch (mma_route in
// flash_mma.cuh; paddle_flash_route reports it):
//   bf16 / fp16 at D = 16..128: flash_fwd_mma_kernel, on the tensor
//     cores. A block of 4 warps owns 64 query rows of one (batch, head),
//     16 rows a warp, and walks key tiles of 64. Q's fragments are
//     loaded once and stay in registers; K and V tiles come in through
//     cp.async into two stages (the next tile loads while the current
//     one is multiplied), stored in the input type with rows padded by
//     16 bytes. S = Q K^T runs on mma.sync.m16n8k16 with fp32
//     accumulation, is scaled by scale * log2(e) in fp32, and the online
//     softmax keeps each row's max and sum in registers of the 4 lanes
//     of its quad. P is fed from registers, as two terms of the input
//     type (hi + lo, flash_mma.cuh: the JAX kernel's single rounding
//     would not meet the card's training rule), as the A fragments of
//     O += P V (V's fragments through ldmatrix.trans): it never touches
//     shared memory. Masks cost only
//     in a diagonal or ragged-tail tile; tiles past the diagonal are
//     skipped, and causal q-tiles start heaviest first. 45 KB of shared
//     memory at D = 64 leaves several blocks on an SM: the 64-row tile
//     is small for occupancy, which hides the ldmatrix -> mma latency
//     that one large block per SM could not (fused_ce.cu).
//   fp32 at any D, and D = 256: flash_fwd_kernel, the shared fp32 body
//     ``attend`` of flash_common.cuh on the CUDA cores (fp32 is held to
//     1e-4 of the plain version, which a bf16 product would not meet; a
//     warp's accumulators do not fit at D = 256).
//
// What bounds it on the H100: the causal forward at the training shape
// [16, 1024, 12, 64] moves 101 MB (q, k, v read and o written once,
// 0.030 ms at 3.35 TB/s) and does 2 products of 2 * pairs * D, 25.8
// GFLOP (0.026 ms at the 989 TFLOP/s of wgmma, of which mma.sync
// reaches about two thirds); the two-term P makes it 3 products here. At the serving prefill [1, 512, 12, 64]
// the bound is about a microsecond and 96 blocks of at most 8 key tiles
// each make it latency-bound. Every block's result depends on its own rows alone,
// so outputs do not change with the batch or the grid.
#include "flash_mma.cuh"

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

// The tensor-core forward (bf16 / fp16, D <= 128); see the note above.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 3 : 2)
    flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int Hq, int Hk, int Sq,
                         int Sk, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
                         float qk2) {
  constexpr int BQ = 64, BK = kBlockK, S = kRow<D>;
  constexpr int KD = D / 16;   // k16 steps over the head dim
  constexpr int NK = BK / 8;   // n8 tiles of a score row
  constexpr int ND = D / 8;    // n8 tiles of an output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);   // [BQ][S]
  T* kvs = qs + BQ * S;                     // 2 stages of K [BK][S], V
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lo_a = lane_off_a<D>(), lo_b = lane_off_b<D>();

  const int offset = Sk - Sq;
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int n_keys = causal ? max(0, min(Sk, last_row + offset + 1)) : Sk;
  const int n_tiles = (n_keys + BK - 1) / BK;
  // a tile needs the mask when a column past the block's smallest row
  // limit falls in it (the causal diagonal, or the ragged key tail)
  const int lim_min = causal ? min(q0 + offset, Sk - 1) : Sk - 1;
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + g + 8 * i;
    lim[i] = causal ? min(row + offset, Sk - 1) : Sk - 1;
  }

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const bool kv_vec = rows_aligned(kb, k_ss) && rows_aligned(vb, v_ss);
  auto load_kv = [&](int j) {
    T* ks = kvs + (j & 1) * 2 * BK * S;
    const int kt = j * BK;
    tile_to_smem<T, BK, D>(
        ks, [&](int c) -> const T* {
          return kt + c < n_keys ? kb + (kt + c) * k_ss : nullptr;
        },
        kb, kv_vec);
    tile_to_smem<T, BK, D>(
        ks + BK * S, [&](int c) -> const T* {
          return kt + c < n_keys ? vb + (kt + c) * v_ss : nullptr;
        },
        vb, kv_vec);
  };
  tile_to_smem<T, BQ, D>(
      qs, [&](int r) -> const T* {
        return q0 + r < Sq ? qb + (q0 + r) * q_ss : nullptr;
      },
      qb, rows_aligned(qb, q_ss));
  if (n_tiles > 0) load_kv(0);
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KD][4];   // this warp's 16 query rows, for the whole walk
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    load_a_frag<D>(qf[kk], qs + 16 * warp * S, kk, lo_a);

  float acc[ND][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    if (j > 0) {
      cp_async_wait_all();   // tile j has landed
      __syncthreads();       // and every warp is done with tile j - 1
    }
    if (j + 1 < n_tiles) load_kv(j + 1);   // into tile j - 1's stage
    const T* ks = kvs + (j & 1) * 2 * BK * S;
    const T* vs = ks + BK * S;

    float s[NK][4];
    zero(s);
    mma_nt<T, D, NK>(
        s, [&](int kk, uint32_t(&f)[4]) {
#pragma unroll
          for (int r = 0; r < 4; ++r) f[r] = qf[kk][r];
        },
        ks, lo_b);

    // scale into base-2 logits, mask, and the tile's row maxima
    const int kt = j * BK;
    const bool masked = kt + BK - 1 > lim_min;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int ni = 0; ni < NK; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = s[ni][r] * qk2;
        if (masked && kt + ni * 8 + 2 * t + (r & 1) > lim[r >> 1])
          x = -INFINITY;
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
    // p = exp2(s - m) in fp32; this lane's part of each row sum (the
    // quad's four parts are added once, at the end)
#pragma unroll
    for (int ni = 0; ni < NK; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = exp2f(s[ni][r] - base[r >> 1]);
        s[ni][r] = p;
        l[r >> 1] += p;
      }
    mma_nn<T, D, NK>(acc, s, vs, lo_a);   // O += P V
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  T* ob = o + b * o_sb + h * o_sh;
  const bool pair = reinterpret_cast<uintptr_t>(ob) % 4 == 0 && o_ss % 2 == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + g + 8 * i;
    if (row >= Sq) continue;
    const bool any = l[i] > 0.f;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      store2(ob + row * o_ss + nd * 8 + 2 * t,
             any ? acc[nd][2 * i] / l[i] : 0.f,
             any ? acc[nd][2 * i + 1] / l[i] : 0.f, pair);
    if (lse != nullptr && t == 0)
      lse[(int64_t)bh * Sq + row] =
          any ? (m[i] + log2f(l[i])) * kLn2 : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Hq, int Hk, int Sq, int Sk,
                       const int64_t* st, int causal, float scale,
                       cudaStream_t stream) {
  constexpr size_t bytes = (64 + 4 * kBlockK) * kRow<D> * sizeof(T);
  auto kernel = flash_fwd_mma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hq, (Sq + 63) / 64);
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Hq, Hk, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, scale * kLog2e);
  return cudaGetLastError();
}

// bf16 and fp16 at D <= 128 take the tensor cores (mma_route); fp32 and
// D = 256 the fp32 body
template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int Hq, int Hk, int Sq,
                       int Sk, const int64_t* st, int causal, float scale,
                       cudaStream_t stream) {
#define PADDLE_FWD_CASE(DIM)                                                 \
  case DIM:                                                                  \
    if constexpr (mma_route(kDtype<T>, DIM))                                 \
      return launch_mma<T, DIM>(q, k, v, o, lse, B, Hq, Hk, Sq, Sk, st,      \
                                causal, scale, stream);                      \
    else                                                                     \
      return launch<T, DIM>(q, k, v, o, lse, B, Hq, Hk, Sq, Sk, st, causal,  \
                            scale, stream);
  switch (D) {
    PADDLE_FWD_CASE(16)
    PADDLE_FWD_CASE(32)
    PADDLE_FWD_CASE(64)
    PADDLE_FWD_CASE(128)
    PADDLE_FWD_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PADDLE_FWD_CASE
}

}  // namespace paddle_flash

// 1 when (dtype, D) runs on the tensor-core kernels of flash_fwd.cu and
// flash_bwd.cu, 0 when on the fp32 CUDA-core kernels (dtype as below)
extern "C" int paddle_flash_route(int dtype, int D) {
  return paddle_flash::mma_route(dtype, D) ? 1 : 0;
}

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
