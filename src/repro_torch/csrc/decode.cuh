// The port's decode-attention kernel: one query token per row (all G query
// heads of one kv head) over that row's ring of cached keys, with the
// ring-validity mask and an online softmax over key tiles. One kernel body,
// two KV layouts:
//
//   TableLayout  the shared page pool (P, page, Hkv, hd) read through a
//                (B, T) page table (paged_decode, paged_decode_int8);
//   RingLayout   per-row contiguous rings (B, C, Hkv, hd), no table
//                (paged_decode_ring: live pages only; swa_decode: every slot).
//
// A layout says how many logical ring slots a row walks (`span`), in tiles
// of how many keys (`cols`), and how a tile's columns map to K/V slots
// (`slots`, the addressing policies of common.cuh). The mask, the loads and
// the softmax are shared, so both ring kernels walk the ring in the SAME
// tiles of RING_TILE keys: a tile past the live span that one kernel reads
// and the other skips is wholly masked, and a wholly masked tile after a
// live key leaves (m, l, acc) bitwise unchanged (p = exp(NEG - m) == 0,
// alpha == 1). That is why paged_decode_ring equals swa_decode bitwise, at
// every page size that is a multiple of the tile.
#pragma once

#include "common.cuh"

namespace repro {

// Keys per tile of the ring layout: a page of 64-512 keys is walked in
// tiles of 64 (a 512-key tile of K at HD + 1 floats plus V would need ~264
// KB of shared memory at hd 64, above the 227 KB a block may have).
constexpr int RING_TILE = 64;

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

// The TPU kernels' validity mask over a row's logical ring slots s = s0 + c:
// slot s holds global position pos - ((pos mod cap) - s) mod cap, live iff
// s < limit and lo <= gpos <= pos. C++'s % of a negative number is negative,
// hence ((a % cap) + cap) % cap.
struct RingLive {
  int s0, limit, pos, cap, slot_w, lo;
  __device__ bool operator()(int, int c) const {
    const int s = s0 + c;
    if (s >= limit) return false;
    const int back = ((slot_w - s) % cap + cap) % cap;
    const int gpos = pos - back;
    return gpos >= lo && gpos <= pos;
  }
};

// Live pages of a row at position pos: ceil(min(pos + 1, cap) / page),
// clamped to [1, n_pages].
__device__ __forceinline__ int live_pages(int pos, int cap, int page, int n_pages) {
  const int live = min(pos + 1, cap);
  return max(1, min((live + page - 1) / page, n_pages));
}

struct TableLayout {
  const int* table;
  int T_w, page, kpb;  // table width, page size, pages per tile
  __host__ __device__ int cols() const { return kpb * page; }
  __device__ int cap() const { return T_w * page; }
  __device__ int span(int pos) const { return live_pages(pos, cap(), page, T_w) * page; }
  __device__ PageSlots slots(int b, int s0, int limit) const {
    return PageSlots{table + (size_t)b * T_w, s0 / page, limit / page, page};
  }
};

// SKIP: walk only the live pages (pages of `page` keys, a multiple of
// RING_TILE or the whole ring); else every slot of the ring.
template <bool SKIP>
struct RingLayout {
  int C, page;
  __host__ __device__ int cols() const { return RING_TILE; }
  __device__ int cap() const { return C; }
  __device__ int span(int pos) const {
    return SKIP ? min(live_pages(pos, C, page, C / page) * page, C) : C;
  }
  __device__ RingSlots slots(int b, int s0, int limit) const {
    return RingSlots{(long long)b * C, s0, limit};
  }
};

// One block per (row b, kv head h), 128 threads. TP is the K/V element
// type: T (fp) or int8_t (table layout only, with k_scale/v_scale (P, page,
// Hkv) f32; unread for fp).
template <typename T, typename TP, int HD, typename Layout>
__global__ void decode_kernel(const T* __restrict__ q, const TP* __restrict__ k,
                              const TP* __restrict__ v, const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ pos_arr, Layout layout,
                              T* __restrict__ out, int Hkv, int G, int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int rows = G;
  const int cols = layout.cols();
  const Tile t = carve<HD>(smem, rows, cols);

  const size_t qo = ((size_t)b * Hkv + h) * G * HD;
  load_rows<T, HD>(QRow<T, HD>{q + qo}, rows, t.q, HD);
  init_state<HD>(t, rows);

  const int pos = pos_arr[b];
  const int cap = layout.cap();
  const int limit = layout.span(pos);
  const int slot_w = pos % cap;
  const int lo = window > 0 ? max(pos - (window - 1), 0) : 0;
  __syncthreads();

  for (int s0 = 0; s0 < limit; s0 += cols) {
    const auto slots = layout.slots(b, s0, limit);
    load_pool_rows<T, TP, HD>(k, k_scale, slots, Hkv, h, cols, t.k, HD + 1);
    load_pool_rows<T, TP, HD>(v, v_scale, slots, Hkv, h, cols, t.v, HD);
    __syncthreads();
    scores<HD>(t, rows, cols, scale, RingLive{s0, limit, pos, cap, slot_w, lo});
    __syncthreads();
    online_softmax_update<HD>(t, rows, cols);
  }
  write_rows<T, HD>(t, rows, ORow<T, HD>{out + qo});
}

template <typename T, typename TP, int HD, typename Layout>
int launch_decode(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, const void* pos, Layout layout, void* out, int B, int Hkv,
                  int G, int window, float scale, cudaStream_t stream) {
  const size_t smem = tile_floats<HD>(G, layout.cols()) * sizeof(float);
  cudaError_t err = allow_smem(decode_kernel<T, TP, HD, Layout>, smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<T, TP, HD, Layout><<<dim3(B, Hkv), 128, smem, stream>>>(
      (const T*)q, (const TP*)k, (const TP*)v, (const float*)ks, (const float*)vs,
      (const int*)pos, layout, (T*)out, Hkv, G, window, scale);
  return (int)cudaGetLastError();
}

// Dispatch on head dim (32, 64, 128); -1 for any other.
template <typename T, typename TP, typename Layout>
int decode_by_hd(int hd, const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* pos, Layout layout, void* out, int B, int Hkv,
                 int G, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_decode<T, TP, 32>(q, k, v, ks, vs, pos, layout, out, B, Hkv, G, window,
                                      scale, stream);
    case 64:
      return launch_decode<T, TP, 64>(q, k, v, ks, vs, pos, layout, out, B, Hkv, G, window,
                                      scale, stream);
    case 128:
      return launch_decode<T, TP, 128>(q, k, v, ks, vs, pos, layout, out, B, Hkv, G, window,
                                       scale, stream);
  }
  return -1;
}

// The fp ring kernels (q, out and the rings share dtype: 0 = float32,
// 1 = bfloat16): RingLayout<SKIP> over (B, C, Hkv, hd).
template <bool SKIP>
int ring_decode(const void* q, const void* k, const void* v, const void* pos, void* out,
                int dtype, int B, int C, int Hkv, int G, int hd, int page, int window,
                float scale, cudaStream_t stream) {
  const RingLayout<SKIP> layout{C, page};
  if (dtype == 0)
    return decode_by_hd<float, float>(hd, q, k, v, nullptr, nullptr, pos, layout, out, B,
                                      Hkv, G, window, scale, stream);
  if (dtype == 1)
    return decode_by_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, k, v, nullptr, nullptr, pos,
                                                      layout, out, B, Hkv, G, window, scale,
                                                      stream);
  return -1;
}

}  // namespace repro
