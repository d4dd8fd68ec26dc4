// Flash-decode attention over a paged KV cache, hand-written for Hopper
// (sm_90a); the kernel is flash_decode_split.cuh's split-key body with
// PagedCache addressing, the body the dense decode entries run.
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py
// _paged_decode_pallas (:1323; Pallas body _paged_decode_kernel :1285
// with the shared _decode_accumulate :846), reached through
// flash_attention_decode_paged (:1392), in its wide mode.
//
// Computes the dense decode contract (sq <= 8 query rows per batch row,
// row i attends logical columns c <= kv_len - sq + i) with K/V in a
// shared pool of fixed-size pages: logical column c of batch row b is
// row c % page of pool page page_table[b][c / page]. The TPU kernel
// resolves the page id in its k/v BlockSpec index maps from a
// scalar-prefetched table and streams one page per grid step; here each
// block owns one fixed split of 128 logical columns, stages the table
// entries of the split's pages in shared memory (loaded beside kv_len, so
// they cost no extra round trip) and copies each key row through them,
// so a split may span pages and the page size is free. The grid is sized
// from the table's capacity (n_slots * page). The pool is read in place
// as a layer slice of [layers, n_pages, page, Hk, D]: no transpose (the
// JAX wrapper's, :1443) and no gather. Columns at or past kv_len are
// never read, so the null page 0 and a parked lane's stale pages cost
// nothing. The table is trusted, as on the TPU: the wrapper checks
// shapes and dtypes, never device values.
//
// What bounds it on the H100: device-memory bytes, exactly as the dense
// decode kernel (the same K/V bytes; the table adds 4 bytes a page), and
// at a decode step's size the loads' latency; the split body's answer
// is in flash_decode_split.cuh. Because it runs the dense entries' body
// over the same logical splits, its output equals paddle_flash_decode's
// bit for bit on the same logical content, at any page size and
// capacity, which is what lets the paged serving engine give the dense
// engine's tokens.
//
// paddle_flash_decode_paged_int8 is the int8-pool mode of the same TPU
// kernel (its scale pages through the same table, :1330-1333): int8
// pools with bf16 scale pools [n_pages, page, Hk] (QuantPagedKVCache
// layer slices), read in place through the table entries the block has
// staged; equal bit for bit to paddle_flash_decode_int8 on the same
// logical content.
#include "flash_decode_split.cuh"

namespace {

int paged(const void* q, const void* k_pool, const void* v_pool,
          const void* ks, const void* vs, const int* page_table,
          const int* kv_len, void* o, void* part, int64_t part_floats,
          int dtype, int B, int Sq, int Hq, int Hk, int page, int n_slots,
          int D, const int64_t* st, float scale, void* stream,
          bool int8_cache) {
  using namespace paddle_flash;
  if (Sq > kMaxQLen || page <= 0 || n_slots <= 0)
    return cudaErrorInvalidValue;
  PagedCache cache{k_pool, v_pool, page_table, st[3], st[4], st[5],
                   st[6], st[7], st[8], st[12], page, n_slots};
  if (int8_cache) {
    cache.ks = ks;
    cache.vs = vs;
    cache.ks_sp = st[13], cache.ks_sr = st[14], cache.ks_sh = st[15];
    cache.vs_sp = st[16], cache.vs_sr = st[17], cache.vs_sh = st[18];
  }
  const int64_t qo[6] = {st[0], st[1], st[2], st[9], st[10], st[11]};
  return dispatch_split(dtype, int8_cache, D, q, cache, kv_len, o, part,
                        part_floats, B, Sq, Hq, Hk, qo, scale, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. k_pool/v_pool: [n_pages,
// page, Hk, D] (head_dim contiguous). page_table: [B, n_slots] int32 on
// the card. kv_len: [B] int32 on the card. scratch: fp32 on the card,
// scratch_floats of them, at least the dense entry's need at T_len =
// n_slots * page. strides: 13 element strides: (batch, seq, head) of q;
// (page, row, head) of k_pool, then of v_pool; (batch, seq, head) of o;
// the table's row stride. Returns the launch's cudaError_t.
extern "C" int paddle_flash_decode_paged(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const int* kv_len, void* o, void* scratch,
    int64_t scratch_floats, int dtype, int B, int Sq, int Hq, int Hk,
    int page, int n_slots, int D, const int64_t* st, float scale,
    void* stream) {
  return paged(q, k_pool, v_pool, nullptr, nullptr, page_table, kv_len, o,
               scratch, scratch_floats, dtype, B, Sq, Hq, Hk, page, n_slots,
               D, st, scale, stream, false);
}

// The logical key columns of one split (as flash_decode.cu's).
extern "C" int paddle_flash_decode_split_keys() {
  return paddle_flash::kSplitKeys;
}

// Int8 pools: k_pool, v_pool int8 [n_pages, page, Hk, D]; k_scale,
// v_scale bf16 [n_pages, page, Hk]; dtype is q's and o's. strides: 19,
// the 13 above, then (page, row, head) of k_scale and of v_scale.
extern "C" int paddle_flash_decode_paged_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const int* page_table,
    const int* kv_len, void* o, void* scratch, int64_t scratch_floats,
    int dtype, int B, int Sq, int Hq, int Hk, int page, int n_slots, int D,
    const int64_t* st, float scale, void* stream) {
  return paged(q, k_pool, v_pool, k_scale, v_scale, page_table, kv_len, o,
               scratch, scratch_floats, dtype, B, Sq, Hq, Hk, page, n_slots,
               D, st, scale, stream, true);
}
