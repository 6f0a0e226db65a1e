// Paged decode attention: over the shared KV page pool, and over per-row
// contiguous rings with dead pages skipped.
//
// paged_decode replaces the TPU kernel
// src/repro/kernels/paged_decode.py::_table_decode (body _paged_kernel): one
// query token per row attends over its ring of logical pages, which a
// (B, T) page table maps into one shared pool (P, page, Hkv, hd). The
// ring-validity mask (with an optional window) is exactly _paged_kernel's;
// pages past live = ceil(min(pos+1, T*page)/page) are never read, and their
// table entries never dereferenced (scratch page 0 is never read for a live
// computation).
//
// paged_decode_ring replaces the same TPU kernel's contiguous branch
// (src/repro/kernels/paged_decode.py::paged_decode without a table): rings
// (B, C, Hkv, hd), cut into pages of `page` keys (the reference's
// _chunk(C): 512/256/128/64, or C), pages past ceil(min(pos+1, C)/page)
// never read. Its output is bitwise swa_decode's.
//
// What bounds it on an H100: bytes. Each (row, kv head) reads its live K and
// V once at 1 flop per byte (stablelm-1.6b: G = 1, hd = 64, bf16), far below
// the ~295 flops per byte of the tensor cores. The design (decode.cuh) is a
// split-KV flash decode: each row's ring is cut into fixed ranges of
// split_len(cap, hd) slots (kernels/paged_decode.py), one block per (range,
// kv head, row), so a long ring at B = 1 (long_500k: C = 8192) still fills
// the card; each warp streams its keys through a 2-stage cp.async ring in
// shared memory, in the pool's storage type, with q, the scores, the running
// max and sum and the accumulator in registers; a second kernel merges a
// row's ranges in range order. A range wholly past the live span writes the
// identity partial (m = NEG, l = 0, acc = 0) without reading anything. It is
// bitwise what walking it masked would give: the merge weighs a range by
// exp(m_r - M), exactly 0 for m_r = NEG, whatever the range's l and acc, and
// M comes from slot pos mod cap, which is always live. So the skip is
// invisible, and the table kernel over a pool that holds a ring's keys, the
// ring kernel at every page size and swa_decode (which walks every range)
// give the same bits.
//
// int8 pools (paged_decode_int8, the TPU kernel's k_scale/v_scale branch):
// the same kernel with the pool copied as int8 plus one f32 scale per (slot,
// kv head), dequantized at use exactly as repro::load_pool_rows does. It
// moves ~half the bytes of a bf16 pool (1 B per element plus 4 B per
// 64-element row), and the math after the conversion is the fp kernel's,
// so its output is bitwise the fp kernel's over the dequantized pool.
#include "decode.cuh"

namespace {

template <typename T, typename TP>
int table_decode(const void* q, const void* kp, const void* vp, const void* ks,
                 const void* vs, const void* pos, const void* table, void* part, void* out,
                 int B, int Hkv, int G, int hd, int page, int T_w, int window, int split,
                 float scale, cudaStream_t stream) {
  const repro::TableLayout layout{(const int*)table, T_w, page};
  return repro::decode_by_hd<T, TP>(hd, q, kp, vp, ks, vs, pos, layout, part, out, B, Hkv, G,
                                    window, split, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out and the fp pools). part: the
// caller's f32 scratch for the partials, B * Hkv * G * ceil(T_w * page /
// split) * (hd + 2) floats. Returns cudaGetLastError() after the launches
// (0 on success), or -1 for an unsupported head dim / dtype / split.
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* pos, const void* table, void* part, void* out,
                            int dtype, int B, int Hkv, int G, int hd, int page, int T_w,
                            int window, int split, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return table_decode<float, float>(q, k_pool, v_pool, nullptr, nullptr, pos, table, part,
                                      out, B, Hkv, G, hd, page, T_w, window, split, scale, s);
  if (dtype == 1)
    return table_decode<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr,
                                                      pos, table, part, out, B, Hkv, G, hd,
                                                      page, T_w, window, split, scale, s);
  return -1;
}

// The int8-pool variant (the TPU kernel's k_scale/v_scale branch): int8
// pools (P, page, Hkv, hd) with f32 scales (P, page, Hkv), dequantized in
// the kernel to q's dtype. Same scratch and return codes.
extern "C" int paged_decode_int8(const void* q, const void* k_pool, const void* v_pool,
                                 const void* k_scale, const void* v_scale, const void* pos,
                                 const void* table, void* part, void* out, int dtype, int B,
                                 int Hkv, int G, int hd, int page, int T_w, int window,
                                 int split, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return table_decode<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale, pos, table, part,
                                       out, B, Hkv, G, hd, page, T_w, window, split, scale, s);
  if (dtype == 1)
    return table_decode<__nv_bfloat16, int8_t>(q, k_pool, v_pool, k_scale, v_scale, pos,
                                               table, part, out, B, Hkv, G, hd, page, T_w,
                                               window, split, scale, s);
  return -1;
}

// The contiguous branch: rings k/v (B, C, Hkv, hd), pos (B,) int32, pages of
// `page` keys (C % page == 0), dead pages skipped; scratch B * Hkv * G *
// ceil(C / split) * (hd + 2) floats. Same return codes.
extern "C" int paged_decode_ring(const void* q, const void* k, const void* v, const void* pos,
                                 void* part, void* out, int dtype, int B, int C, int Hkv,
                                 int G, int hd, int page, int window, int split, float scale,
                                 void* stream) {
  return repro::ring_decode<true>(q, k, v, pos, part, out, dtype, B, C, Hkv, G, hd, page,
                                  window, split, scale, (cudaStream_t)stream);
}
