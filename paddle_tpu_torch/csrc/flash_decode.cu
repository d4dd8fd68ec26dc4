// Flash-decode and chunk-prefill attention against a dense cache,
// hand-written for Hopper (sm_90a): the decode entries run
// flash_decode_split.cuh's split-key body with DenseCache addressing; the
// chunk entries run, in bf16 / fp16 at head_dim 16..128, the tensor-core
// kernel of flash_chunk_mma.cuh, and otherwise flash_decode.cuh's fp32
// body.
//
// paddle_flash_decode replaces the TPU kernel
// paddle_tpu/kernels/flash_attention.py _decode_pallas (:942; Pallas
// body _decode_kernel :910 with the shared _decode_accumulate :846),
// reached through flash_attention_decode (:1037), in its wide
// (bf16/fp16/fp32 cache) mode: sq <= 8 query rows per batch row.
//
// paddle_flash_chunk replaces _chunk_pallas (:1163; Pallas body
// _chunk_kernel :1126), reached through flash_attention_chunk (:1219),
// in its wide mode: the same contract without the 8-row cap, for the
// serving engine's chunked prefill (a C-token window of a long prompt
// against the batch-1 side cache the earlier chunks wrote). The TPU
// kernel q-tiles the decode body at 128 rows. Here the entry chooses,
// from (dtype, head_dim) before any launch (flash_mma.cuh's mma_route;
// paddle_flash_chunk_route reports it): bf16 and fp16 at head_dim 16..128
// run flash_chunk_mma.cuh's tensor-core kernel (16-row blocks whose 4
// warps split the key range, combined in warp order); fp32 and head_dim
// 256 run flash_decode.cuh's kernel with 64-row blocks over blockIdx.y,
// each block stopping its key stream at its last row's limit.
//
// paddle_flash_decode_int8 and paddle_flash_chunk_int8 are the int8
// modes of the same two TPU kernels (the quant branch of
// _decode_accumulate, :858-865 and :867-896): an int8 cache with bf16
// scales [B, T, Hk] per (position, kv head), the QuantKVCache layer
// slices, read in place; the dequantisation fuses into the tile. They
// move half the wide mode's K/V bytes plus 2 bytes of scales per
// (position, head).
//
// The cache is read IN PLACE through its strides: the layer slice of
// the [layers, B, T, Hk, D] cache is handed over as it lies, where the
// JAX wrapper's swapaxes/reshape to [B*Hk, T, D] would be a full copy of
// the layer's cache in PyTorch on every layer of every step. Grouped
// query heads share their kv head's tiles, so caches are never repeated.
//
// What bounds them on the H100: device-memory bytes. At the serving
// decode shapes (8 rows, 640 cache positions, 12 heads, head_dim 64,
// bf16) a step reads at most 15.7 MB of K/V per layer (~4.7 us at 3.35
// TB/s) and does ~4 FLOP per byte, so the decode body is bound by the
// loads' latency and rate, not by arithmetic: it splits each row's keys
// into fixed 128-column splits run by blocks side by side, keeps its K/V
// copies in flight in a per-lane cp.async ring, computes only the live
// query rows and folds the splits in split order inside a thread-block
// cluster, or past 8 splits in a second small kernel (see
// flash_decode_split.cuh). A 128-row chunk against 512 cached positions
// does ~256 FLOP per byte, near the card's bf16 ridge, which the chunk's
// bf16 / fp16 route takes on the tensor cores.
#include "flash_chunk_mma.cuh"
#include "flash_decode_split.cuh"

namespace {

// ks/vs: null for a wide cache; for an int8 cache the scales, whose
// strides follow the 12 of q, k, v and o in st. part: the decode
// entries' scratch (part_floats floats); null for the chunk entries.
int dense(bool chunk, const void* q, const void* k, const void* v,
          const void* ks, const void* vs, const int* kv_len, void* o,
          void* part, int64_t part_floats, int dtype, int B, int Sq, int Hq,
          int Hk, int T_len, int D, const int64_t* st, float scale,
          void* stream, bool int8_cache) {
  using namespace paddle_flash;
  if ((!chunk && Sq > kMaxQLen) || T_len <= 0) return cudaErrorInvalidValue;
  DenseCache cache{k, v, st[3], st[4], st[5], st[6], st[7], st[8], T_len};
  if (int8_cache) {
    cache.ks = ks;
    cache.vs = vs;
    cache.ks_sb = st[12], cache.ks_ss = st[13], cache.ks_sh = st[14];
    cache.vs_sb = st[15], cache.vs_ss = st[16], cache.vs_sh = st[17];
  }
  const int64_t qo[6] = {st[0], st[1], st[2], st[9], st[10], st[11]};
  if (!chunk)
    return dispatch_split(dtype, int8_cache, D, q, cache, kv_len, o, part,
                          part_floats, B, Sq, Hq, Hk, qo, scale, stream);
  if (mma_route(dtype, D))
    return dispatch_chunk_mma(dtype, int8_cache, D, q, cache, kv_len, o, B,
                              Sq, Hq, Hk, qo, scale, stream);
  return dispatch(dtype, int8_cache, D, q, cache, kv_len, o, B, Sq, Hq, Hk,
                  qo, scale, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. strides: 12 element strides,
// (batch, seq, head) of q, k, v and o in that order; head_dim must be
// contiguous. kv_len: [B] int32 on the card. scratch: fp32 on the card,
// scratch_floats of them, at least the decode entries' need
// (kernels/flash_attention.py decode_scratch_floats; none when T_len is
// one split). Returns the launch's cudaError_t.
extern "C" int paddle_flash_decode(const void* q, const void* k,
                                   const void* v, const int* kv_len, void* o,
                                   void* scratch, int64_t scratch_floats,
                                   int dtype, int B, int Sq, int Hq, int Hk,
                                   int T_len, int D, const int64_t* strides,
                                   float scale, void* stream) {
  return dense(false, q, k, v, nullptr, nullptr, kv_len, o, scratch,
               scratch_floats, dtype, B, Sq, Hq, Hk, T_len, D, strides,
               scale, stream, false);
}

// The logical key columns of one split of the decode entries (their
// scratch rule's constant).
extern "C" int paddle_flash_decode_split_keys() {
  return paddle_flash::kSplitKeys;
}

// 1 when the chunk entries run (dtype, D) on flash_chunk_mma.cuh's
// tensor-core kernel, 0 when on the shared fp32 body (dtype as below)
extern "C" int paddle_flash_chunk_route(int dtype, int D) {
  return paddle_flash::mma_route(dtype, D) ? 1 : 0;
}

// paddle_flash_decode's arguments without the scratch; any Sq.
extern "C" int paddle_flash_chunk(const void* q, const void* k,
                                  const void* v, const int* kv_len, void* o,
                                  int dtype, int B, int Sq, int Hq, int Hk,
                                  int T_len, int D, const int64_t* strides,
                                  float scale, void* stream) {
  return dense(true, q, k, v, nullptr, nullptr, kv_len, o, nullptr, 0,
               dtype, B, Sq, Hq, Hk, T_len, D, strides, scale, stream,
               false);
}

// Int8 cache: k, v int8 [B, T, Hk, D]; k_scale, v_scale bf16 [B, T, Hk];
// dtype is q's and o's. strides: 18 element strides, the 12 above, then
// (batch, seq, head) of k_scale and of v_scale.
extern "C" int paddle_flash_decode_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const int* kv_len, void* o, void* scratch,
    int64_t scratch_floats, int dtype, int B, int Sq, int Hq, int Hk,
    int T_len, int D, const int64_t* strides, float scale, void* stream) {
  return dense(false, q, k, v, k_scale, v_scale, kv_len, o, scratch,
               scratch_floats, dtype, B, Sq, Hq, Hk, T_len, D, strides,
               scale, stream, true);
}

// paddle_flash_chunk's arguments with the two scales after k and v, and
// the 18 strides; any Sq.
extern "C" int paddle_flash_chunk_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const int* kv_len, void* o, int dtype, int B,
    int Sq, int Hq, int Hk, int T_len, int D, const int64_t* strides,
    float scale, void* stream) {
  return dense(true, q, k, v, k_scale, v_scale, kv_len, o, nullptr, 0,
               dtype, B, Sq, Hq, Hk, T_len, D, strides, scale, stream, true);
}
