// Tensor-core pieces shared by the flash-attention forward (flash_fwd.cu)
// and backward (flash_bwd.cu) for bfloat16 and float16 inputs.
//
// Tiles of [rows][D] elements sit in shared memory in the input type, at
// a row stride of D + 8 elements: the 16 bytes of padding put the eight
// 16-byte rows that one ldmatrix phase reads into eight different bank
// groups, so fragment loads are free of bank conflicts at every D. A
// warp owns 16 rows of its block's tile and multiplies with
// mma.sync.m16n8k16 (bf16 or fp16 in, fp32 accumulate; mma_common.cuh).
// Two product shapes cover every product of both kernels:
//   mma_nt  acc[16 x 8*N8] += A[16 x D] @ B^T, B stored [n][D] (S = Q K^T
//           and its relatives: the depth is the contiguous head dim, so
//           B is ldmatrix's non-transposed "col" operand);
//   mma_nn  acc[16 x D] += P[16 x 16*KQ] @ B, B stored [k][D] (O += P V
//           and the gradient sums: B is loaded with ldmatrix.trans), with
//           P taken straight from the fp32 accumulator fragments of an
//           earlier product: the C fragment of two adjacent n8 tiles is
//           the A fragment of one k16 step, so P never touches shared
//           memory.
// Precision. Scores, softmax statistics and every sum stay in fp32. P
// (and dS) enter their product as two terms of the input type, hi = T(x)
// and lo = T(x - hi), two mma.sync each, so the product sees them to
// about 16 significant bits. The JAX kernels round P and dS to the input
// type once (paddle_tpu/kernels/flash_attention.py:120, :344, :389,
// :396); at the training shapes that single rounding puts a few elements
// of dq, dk and dv (and, by a thin margin, none of out) outside the rule
// the card holds these kernels to against their fp32 plain versions
// (2^-7 |plain| + 1e-3 max |plain|), which the two-term form meets with
// room (tests/test_torch_port_flash_rounding.py). It costs one more
// tensor-core product in each P / dS product: 3 products in the forward
// instead of 2, 10 in the backward instead of 7.
#pragma once

#include "flash_common.cuh"
#include "mma_common.cuh"

namespace paddle_flash {

// The route a (dtype, head_dim) takes: the tensor-core kernels for
// bfloat16 (1) and float16 (2) at head_dim 16..128; float32 (0), whose
// 1e-4 agreement with the plain version a bf16 product would not meet,
// and head_dim 256, whose accumulators do not fit a warp's registers,
// stay on the fp32 CUDA-core kernels (the shared ``attend`` body and
// flash_bwd.cu's score_tile).
__host__ __device__ constexpr bool mma_route(int dtype, int D) {
  return (dtype == 1 || dtype == 2) &&
         (D == 16 || D == 32 || D == 64 || D == 128);
}

// the entry points' dtype code of an element type
template <typename T>
constexpr int kDtype = std::is_same<T, float>::value                ? 0
                       : std::is_same<T, __nv_bfloat16>::value ? 1
                                                               : 2;

// shared-memory row stride of a [rows][D] tile, in elements
template <int D>
constexpr int kRow = D + 8;

// 4 bytes from global to shared memory, asynchronously; zeros when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// Rows [0, ROWS) of a [ROWS][D] tile into shared memory at stride
// kRow<D>: row r from src(r), zeros where src(r) is null (fallback is any
// valid address of the tensor, never read). vec (every row 16-byte
// aligned): cp.async 16-byte copies, complete after cp_async_wait_all();
// otherwise element loads, complete when the call returns. Either way the
// tile is visible to the block after the next __syncthreads().
template <typename T, int ROWS, int D, typename Src>
__device__ __forceinline__ void tile_to_smem(T* dst, Src src,
                                             const T* fallback, bool vec) {
  constexpr int S = kRow<D>, VPR = D / 8, N = ROWS * VPR;
  if (vec) {
#pragma unroll
    for (int i = 0; i < (N + kThreads - 1) / kThreads; ++i) {
      const int e = i * kThreads + threadIdx.x;
      if (N % kThreads != 0 && e >= N) break;
      const int r = e / VPR, c = (e % VPR) * 8;
      const T* p = src(r);
      cp_async16(dst + r * S + c, p != nullptr ? p + c : fallback,
                 p != nullptr);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const T* p = src(r);
      dst[r * S + c] = p != nullptr ? p[c] : from_float<T>(0.f);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// two adjacent output elements; one 4-byte store when pair (the row
// stride is even and the base 4-byte aligned)
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi, bool pair) {
  if (pair) {
    *reinterpret_cast<uint32_t*>(p) = pack2<T>(lo, hi);
  } else {
    p[0] = from_float<T>(lo);
    p[1] = from_float<T>(hi);
  }
}

template <typename T>
__device__ __forceinline__ void mma_t(float (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    mma_bf16(d, a, b);
  else
    mma_f16(d, a, b);
}

// c0 += a @ (n8 tile r[0..1]), c1 += a @ (n8 tile r[2..3])
template <typename T>
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&r)[4]) {
  const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
  mma_t<T>(c0, a, b0);
  mma_t<T>(c1, a, b1);
}

// This lane's ldmatrix.x4 offsets within a tile at stride kRow<D>. lane l
// gives row l%8 of matrix l/8. lo_a: matrix j at rows 8(j&1).., columns
// 8(j>>1)..: an A fragment (rows = m, columns = depth), or a transposed B
// fragment pair (rows = depth, columns = n8 tiles 0 and 1). lo_b: matrix j
// at rows 8(j>>1).., columns 8(j&1)..: a B fragment pair stored [n][depth].
template <int D>
__device__ __forceinline__ int lane_off_a() {
  const int lane = threadIdx.x & 31;
  return (8 * ((lane >> 3) & 1) + (lane & 7)) * kRow<D> + 8 * (lane >> 4);
}
template <int D>
__device__ __forceinline__ int lane_off_b() {
  const int lane = threadIdx.x & 31;
  return (8 * (lane >> 4) + (lane & 7)) * kRow<D> + 8 * ((lane >> 3) & 1);
}

// A fragment of depth step kk from 16 rows at a (stride kRow<D>)
template <int D>
__device__ __forceinline__ void load_a_frag(uint32_t (&f)[4], const void* a,
                                            int kk, int lo_a) {
  ldsm<false>(f, reinterpret_cast<const uint16_t*>(a) + kk * 16 + lo_a);
}

// acc[16 x 8*N8] += A @ B^T over depth D: afrag(kk, f) gives A's
// fragment of depth step kk; b points at B's first row ([n][D], stride
// kRow<D>).
template <typename T, int D, int N8, typename AF>
__device__ __forceinline__ void mma_nt(float (&acc)[N8][4], AF afrag,
                                       const T* b, int lo_b) {
  static_assert(N8 % 2 == 0, "n8 tiles come in pairs");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    afrag(kk, a);
#pragma unroll
    for (int np = 0; np < N8 / 2; ++np) {
      uint32_t r[4];
      ldsm<false>(r, b + np * 16 * kRow<D> + kk * 16 + lo_b);
      mma_pair<T>(acc[2 * np], acc[2 * np + 1], a, r);
    }
  }
}

// a and b as two values of T each, hi = T(x) and lo = T(x - hi), packed
// in pairs: hi + lo carries x to about 16 significant bits
template <typename T>
__device__ __forceinline__ void pack2_split(float a, float b, uint32_t& hi,
                                            uint32_t& lo) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  } else {
    const __half2 h = __floats2half2_rn(a, b);
    const float2 f = __half22float2(h);
    const __half2 l = __floats2half2_rn(a - f.x, b - f.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// The A fragments (hi and lo terms) of k16 step kq of P, from the fp32
// accumulator fragments c of P's n8 tiles 2kq and 2kq + 1.
template <typename T, int N8>
__device__ __forceinline__ void pack_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float (&c)[N8][4], int kq) {
  pack2_split<T>(c[2 * kq][0], c[2 * kq][1], hi[0], lo[0]);
  pack2_split<T>(c[2 * kq][2], c[2 * kq][3], hi[1], lo[1]);
  pack2_split<T>(c[2 * kq + 1][0], c[2 * kq + 1][1], hi[2], lo[2]);
  pack2_split<T>(c[2 * kq + 1][2], c[2 * kq + 1][3], hi[3], lo[3]);
}

// acc[16 x D] += P @ B, P [16 x 8*N8] in fp32 fragments, B [8*N8][D] at b
// (stride kRow<D>), loaded transposed. P enters as two terms of T (hi,
// then lo), so the product sees P to about 16 bits rather than T's 8
// (bf16) or 11 (fp16): see the note at the top.
template <typename T, int D, int N8>
__device__ __forceinline__ void mma_nn(float (&acc)[D / 8][4],
                                       const float (&p)[N8][4], const T* b,
                                       int lo_a) {
#pragma unroll
  for (int kq = 0; kq < N8 / 2; ++kq) {
    uint32_t hi[4], lo[4];
    pack_a<T, N8>(hi, lo, p, kq);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t r[4];
      ldsm<true>(r, b + kq * 16 * kRow<D> + np * 16 + lo_a);
      mma_pair<T>(acc[2 * np], acc[2 * np + 1], hi, r);
      mma_pair<T>(acc[2 * np], acc[2 * np + 1], lo, r);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
}

}  // namespace paddle_flash
