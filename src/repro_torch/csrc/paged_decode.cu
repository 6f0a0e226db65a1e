// Paged decode attention over the shared KV page pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode.py::_table_decode
// (body _paged_kernel): one query token per row attends over its ring of
// logical pages, which a (B, T) page table maps into one shared pool
// (P, page, Hkv, hd). The ring-validity mask (with an optional window) is
// exactly _paged_kernel's; pages past live = ceil(min(pos+1, T*page)/page)
// are never read.
//
// What bounds it on an H100: bytes. Each (row, kv head) reads its live K and
// V pages once and does 4*G*hd flops per key: at stablelm-1.6b's shape
// (G = 1, hd = 64, bf16) that is 1 flop per byte, far below the ~295
// flops/byte at which the tensor cores would become the limit. The design
// therefore only has to stream the live pages: one block per (row, kv head)
// (B*Hkv = 256 blocks at 8 slots and 32 kv heads fill the 132 SMs), pages
// loaded with 16-byte vector loads into shared memory, several pages per
// step (up to 64 keys) so each barrier covers more bytes, the table read
// only for live pages (j clamped before the lookup: scratch page 0 is never
// read for a live computation), and no work at all for dead pages.
//
// int8 pools (paged_decode_int8, the TPU kernel's k_scale/v_scale branch):
// the same kernel with the pool read as int8 plus one f32 scale per (slot,
// kv head), dequantized while the tile is loaded (repro::load_pool_rows).
// It moves ~half the bytes of a bf16 pool (1 B per element plus 4 B per
// 64-element row), and the math after the load is the fp kernel's, so its
// output is bitwise the fp kernel's over the dequantized pool.
#include "common.cuh"

namespace {

using repro::Tile;

template <typename T, int HD>
struct QRow {
  const T* base;
  __device__ const T* operator()(int r) const { return base + (size_t)r * HD; }
};

template <typename T, int HD>
struct ORow {
  T* base;
  __device__ T* operator()(int r) const { return base + (size_t)r * HD; }
};

struct RingLive {  // _paged_kernel's validity mask over logical ring slots
  int j0, pages, page, pos, cap, slot_w, lo;
  __device__ bool operator()(int, int c) const {
    if (j0 + c / page >= pages) return false;
    const int slot = j0 * page + c;
    const int back = ((slot_w - slot) % cap + cap) % cap;
    const int gpos = pos - back;
    return gpos >= lo && gpos <= pos;
  }
};

// TP is the pool's element type: T (fp pool) or int8_t (int8 pool, with
// k_scale/v_scale (P, page, Hkv) f32; unread for an fp pool).
template <typename T, typename TP, int HD>
__global__ void paged_decode_kernel(const T* __restrict__ q, const TP* __restrict__ k_pool,
                                    const TP* __restrict__ v_pool,
                                    const float* __restrict__ k_scale,
                                    const float* __restrict__ v_scale,
                                    const int* __restrict__ pos_arr,
                                    const int* __restrict__ table, T* __restrict__ out,
                                    int Hkv, int G, int page, int T_w, int kpb, int window,
                                    float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int rows = G;
  const int cols = kpb * page;
  const Tile t = repro::carve<HD>(smem, rows, cols);

  const size_t qo = ((size_t)b * Hkv + h) * G * HD;
  repro::load_rows<T, HD>(QRow<T, HD>{q + qo}, rows, t.q, HD);
  repro::init_state<HD>(t, rows);

  const int pos = pos_arr[b];
  const int cap = T_w * page;
  const int live = min(pos + 1, cap);
  const int pages = max(1, min((live + page - 1) / page, T_w));
  const int slot_w = pos % cap;
  const int lo = window > 0 ? max(pos - (window - 1), 0) : 0;
  const int* table_row = table + (size_t)b * T_w;
  __syncthreads();

  for (int j0 = 0; j0 < pages; j0 += kpb) {
    const repro::PageSlots slots{table_row, j0, pages, page};
    repro::load_pool_rows<T, TP, HD>(k_pool, k_scale, slots, Hkv, h, cols, t.k, HD + 1);
    repro::load_pool_rows<T, TP, HD>(v_pool, v_scale, slots, Hkv, h, cols, t.v, HD);
    __syncthreads();
    repro::scores<HD>(t, rows, cols, scale, RingLive{j0, pages, page, pos, cap, slot_w, lo});
    __syncthreads();
    repro::online_softmax_update<HD>(t, rows, cols);
  }
  repro::write_rows<T, HD>(t, rows, ORow<T, HD>{out + qo});
}

template <typename T, typename TP, int HD>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* pos, const void* table, void* out, int B, int Hkv, int G, int page,
           int T_w, int window, float scale, cudaStream_t stream) {
  const int kpb = page >= 64 ? 1 : 64 / page;
  const size_t smem = repro::tile_floats<HD>(G, kpb * page) * sizeof(float);
  cudaError_t err = repro::allow_smem(paged_decode_kernel<T, TP, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<T, TP, HD><<<dim3(B, Hkv), 128, smem, stream>>>(
      (const T*)q, (const TP*)kp, (const TP*)vp, (const float*)ks, (const float*)vs,
      (const int*)pos, (const int*)table, (T*)out, Hkv, G, page, T_w, kpb, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename TP>
int by_hd(int hd, const void* q, const void* kp, const void* vp, const void* ks,
          const void* vs, const void* pos, const void* table, void* out, int B, int Hkv, int G,
          int page, int T_w, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, TP, 32>(q, kp, vp, ks, vs, pos, table, out, B, Hkv, G, page, T_w,
                               window, scale, stream);
    case 64:
      return launch<T, TP, 64>(q, kp, vp, ks, vs, pos, table, out, B, Hkv, G, page, T_w,
                               window, scale, stream);
    case 128:
      return launch<T, TP, 128>(q, kp, vp, ks, vs, pos, table, out, B, Hkv, G, page, T_w,
                                window, scale, stream);
  }
  return -1;
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
    return by_hd<float, float>(hd, q, k_pool, v_pool, nullptr, nullptr, pos, table, out, B,
                               Hkv, G, page, T_w, window, scale, s);
  if (dtype == 1)
    return by_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, k_pool, v_pool, nullptr, nullptr, pos,
                                               table, out, B, Hkv, G, page, T_w, window,
                                               scale, s);
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
    return by_hd<float, int8_t>(hd, q, k_pool, v_pool, k_scale, v_scale, pos, table, out, B,
                                Hkv, G, page, T_w, window, scale, s);
  if (dtype == 1)
    return by_hd<__nv_bfloat16, int8_t>(hd, q, k_pool, v_pool, k_scale, v_scale, pos, table,
                                        out, B, Hkv, G, page, T_w, window, scale, s);
  return -1;
}
