// Paged decode attention: over the shared KV page pool, and over per-row
// contiguous rings with dead pages skipped.
//
// paged_decode replaces the TPU kernel
// src/repro/kernels/paged_decode.py::_table_decode (body _paged_kernel): one
// query token per row attends over its ring of logical pages, which a
// (B, T) page table maps into one shared pool (P, page, Hkv, hd). The
// ring-validity mask (with an optional window) is exactly _paged_kernel's;
// pages past live = ceil(min(pos+1, T*page)/page) are never read.
//
// paged_decode_ring replaces the same TPU kernel's contiguous branch
// (src/repro/kernels/paged_decode.py::paged_decode without a table): rings
// (B, C, Hkv, hd), cut into pages of `page` keys (the reference's
// _chunk(C): 512/256/128/64, or C), pages past ceil(min(pos+1, C)/page)
// never read. Its output is bitwise swa_decode's (decode.cuh says why).
//
// What bounds it on an H100: bytes. Each (row, kv head) reads its live K and
// V once and does 4*G*hd flops per key: at stablelm-1.6b's shape (G = 1,
// hd = 64, bf16) that is 1 flop per byte, far below the ~295 flops/byte at
// which the tensor cores would become the limit. The design therefore only
// has to stream the live keys: one block per (row, kv head) (B*Hkv blocks:
// 256 at 8 slots, 128 at the ring path's 4), keys loaded with 16-byte
// vector loads into shared memory, several pool pages per tile (up to 64
// keys) so each barrier covers more bytes, the table read only for live
// pages (j clamped before the lookup: scratch page 0 is never read for a
// live computation), and no work at all for dead pages. A row of a long
// ring is walked by one block, one 64-key tile after the other: at B = 1
// (long_500k's shape) only Hkv = 32 blocks run, so split-KV is the next
// step for that shape.
//
// int8 pools (paged_decode_int8, the TPU kernel's k_scale/v_scale branch):
// the same kernel with the pool read as int8 plus one f32 scale per (slot,
// kv head), dequantized while the tile is loaded (repro::load_pool_rows).
// It moves ~half the bytes of a bf16 pool (1 B per element plus 4 B per
// 64-element row), and the math after the load is the fp kernel's, so its
// output is bitwise the fp kernel's over the dequantized pool.
#include "decode.cuh"

namespace {

template <typename T, typename TP>
int table_decode(const void* q, const void* kp, const void* vp, const void* ks,
                 const void* vs, const void* pos, const void* table, void* out, int B, int Hkv,
                 int G, int hd, int page, int T_w, int window, float scale,
                 cudaStream_t stream) {
  const int kpb = page >= 64 ? 1 : 64 / page;
  const repro::TableLayout layout{(const int*)table, T_w, page, kpb};
  return repro::decode_by_hd<T, TP>(hd, q, kp, vp, ks, vs, pos, layout, out, B, Hkv, G,
                                    window, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out and the fp pools). Returns
// cudaGetLastError() after the launch (0 on success), or -1 for an
// unsupported head dim / dtype.
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* pos, const void* table, void* out, int dtype, int B,
                            int Hkv, int G, int hd, int page, int T_w, int window, float scale,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return table_decode<float, float>(q, k_pool, v_pool, nullptr, nullptr, pos, table, out, B,
                                      Hkv, G, hd, page, T_w, window, scale, s);
  if (dtype == 1)
    return table_decode<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr,
                                                      pos, table, out, B, Hkv, G, hd, page,
                                                      T_w, window, scale, s);
  return -1;
}

// The int8-pool variant (the TPU kernel's k_scale/v_scale branch): int8
// pools (P, page, Hkv, hd) with f32 scales (P, page, Hkv), dequantized in
// the kernel to q's dtype. Same return codes.
extern "C" int paged_decode_int8(const void* q, const void* k_pool, const void* v_pool,
                                 const void* k_scale, const void* v_scale, const void* pos,
                                 const void* table, void* out, int dtype, int B, int Hkv,
                                 int G, int hd, int page, int T_w, int window, float scale,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return table_decode<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale, pos, table, out,
                                       B, Hkv, G, hd, page, T_w, window, scale, s);
  if (dtype == 1)
    return table_decode<__nv_bfloat16, int8_t>(q, k_pool, v_pool, k_scale, v_scale, pos,
                                               table, out, B, Hkv, G, hd, page, T_w, window,
                                               scale, s);
  return -1;
}

// The contiguous branch: rings k/v (B, C, Hkv, hd), pos (B,) int32, pages of
// `page` keys (C % page == 0), dead pages skipped. Same return codes.
extern "C" int paged_decode_ring(const void* q, const void* k, const void* v, const void* pos,
                                 void* out, int dtype, int B, int C, int Hkv, int G, int hd,
                                 int page, int window, float scale, void* stream) {
  return repro::ring_decode<true>(q, k, v, pos, out, dtype, B, C, Hkv, G, hd, page, window,
                                  scale, (cudaStream_t)stream);
}
