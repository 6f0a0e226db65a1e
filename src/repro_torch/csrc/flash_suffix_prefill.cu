// Suffix prefill over a cached prefix in the shared KV page pool.
//
// Replaces the TPU kernel src/repro/kernels/flash_suffix_prefill.py::
// suffix_prefill (body _suffix_kernel): n rows of S suffix queries at
// absolute positions starts[r] + i attend over (1) the row's cached prefix,
// read straight from the pool through its page table, lanes live iff
// c < starts[r], and (2) the suffix's own keys, causally in local
// coordinates. fp32 online softmax across both phases.
//
// What bounds it on an H100: the same as flash prefill (operations for long
// suffixes over long prefixes, bytes for short ones); this first version
// computes in fp32 FMAs from shared memory, far from the tensor-core bound.
// What the design keeps from the TPU kernel is what saves work: no gather of
// the prefix pages into a contiguous copy in device memory, no score tensor
// in device memory, only pp = min(ceil(starts[r]/page), W) prefix pages read
// per row (a row with pp = 0 skips phase 1; dead pages are never read), and
// suffix tiles above the diagonal skipped. Tiling is flash prefill's: one
// block owns BQ positions times the G heads of one kv head.
//
// int8 pools (suffix_prefill_int8, the TPU kernel's pool_k_scale/
// pool_v_scale branch): only the prefix pages read through the table are
// int8, dequantized to q's dtype while the tile is loaded
// (repro::load_pool_rows); the suffix's own k/v stay in q's dtype. So the
// kernel has two element types, and after the loads its math is the fp
// kernel's: bitwise the fp kernel over the dequantized pool.
#include "common.cuh"

namespace {

using repro::Tile;

constexpr int BK = 64;

template <typename T, int HD>
struct QORow {
  T* base;
  int S, Hkv, G, b, h, q_lo;
  __device__ T* operator()(int r) const {
    const int s = q_lo + r / G;
    if (s >= S) return nullptr;
    return base + ((((size_t)b * S + s) * Hkv + h) * G + (r - (r / G) * G)) * HD;
  }
};

template <typename T, int HD>
struct SufRow {
  const T* base;
  int S, Hkv, b, h, k_lo;
  __device__ const T* operator()(int c) const {
    const int t = k_lo + c;
    if (t >= S) return nullptr;
    return base + (((size_t)b * S + t) * Hkv + h) * HD;
  }
};

struct PrefixLive {  // ring slot c holds global position c; live iff < start
  int j0, pp, page, start;
  __device__ bool operator()(int, int c) const {
    return j0 + c / page < pp && j0 * page + c < start;
  }
};

struct SuffixLive {  // causal in local suffix coordinates
  int G, q_lo, k_lo, S;
  __device__ bool operator()(int r, int c) const {
    const int kpos = k_lo + c;
    return kpos < S && kpos <= q_lo + r / G;
  }
};

// TP is the pool's element type: T (fp pool) or int8_t (int8 prefix pages
// with pool_ks/pool_vs (P, page, Hkv) f32; unread for an fp pool). The
// suffix's own k/v are always T.
template <typename T, typename TP, int HD>
__global__ void suffix_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_suf,
                                      const T* __restrict__ v_suf,
                                      const TP* __restrict__ pool_k,
                                      const TP* __restrict__ pool_v,
                                      const float* __restrict__ pool_ks,
                                      const float* __restrict__ pool_vs,
                                      const int* __restrict__ table,
                                      const int* __restrict__ starts, T* __restrict__ out,
                                      int S, int Hkv, int G, int page, int T_w, int W, int BQ,
                                      int kpb, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int q_lo = blockIdx.y * BQ;
  const int q_hi = min(q_lo + BQ, S) - 1;
  const int rows = BQ * G;
  const int cols_pfx = kpb * page;
  const Tile t = repro::carve<HD>(smem, rows, max(cols_pfx, BK));

  repro::load_rows<T, HD>(QORow<const T, HD>{q, S, Hkv, G, b, h, q_lo}, rows, t.q, HD);
  repro::init_state<HD>(t, rows);
  __syncthreads();

  // phase 1: the row's live cached prefix pages, read through its table
  const int start = starts[b];
  const int pp = max(0, min((start + page - 1) / page, W));
  const int* table_row = table + (size_t)b * T_w;
  for (int j0 = 0; j0 < pp; j0 += kpb) {
    const repro::PageSlots slots{table_row, j0, pp, page};
    repro::load_pool_rows<T, TP, HD>(pool_k, pool_ks, slots, Hkv, h, cols_pfx, t.k, HD + 1);
    repro::load_pool_rows<T, TP, HD>(pool_v, pool_vs, slots, Hkv, h, cols_pfx, t.v, HD);
    __syncthreads();
    repro::scores<HD>(t, rows, cols_pfx, scale, PrefixLive{j0, pp, page, start});
    __syncthreads();
    repro::online_softmax_update<HD>(t, rows, cols_pfx);
  }

  // phase 2: the suffix's own keys, causal, stopping at the diagonal
  const int n_k = (S + BK - 1) / BK;
  const int j_end = min(n_k, q_hi / BK + 1);
  for (int j = 0; j < j_end; ++j) {
    const int k_lo = j * BK;
    repro::load_rows<T, HD>(SufRow<T, HD>{k_suf, S, Hkv, b, h, k_lo}, BK, t.k, HD + 1);
    repro::load_rows<T, HD>(SufRow<T, HD>{v_suf, S, Hkv, b, h, k_lo}, BK, t.v, HD);
    __syncthreads();
    repro::scores<HD>(t, rows, BK, scale, SuffixLive{G, q_lo, k_lo, S});
    __syncthreads();
    repro::online_softmax_update<HD>(t, rows, BK);
  }
  repro::write_rows<T, HD>(t, rows, QORow<T, HD>{out, S, Hkv, G, b, h, q_lo});
}

template <typename T, typename TP, int HD>
int launch(const void* q, const void* ks, const void* vs, const void* pk, const void* pv,
           const void* pks, const void* pvs, const void* table, const void* starts, void* out,
           int n, int S, int Hkv, int G, int page, int T_w, int W, float scale,
           cudaStream_t stream) {
  const int BQ = G >= 64 ? 1 : 64 / G;
  const int kpb = page >= BK ? 1 : BK / page;
  const int cols = kpb * page > BK ? kpb * page : BK;
  const size_t smem = repro::tile_floats<HD>(BQ * G, cols) * sizeof(float);
  cudaError_t err = repro::allow_smem(suffix_prefill_kernel<T, TP, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n * Hkv, (S + BQ - 1) / BQ);
  suffix_prefill_kernel<T, TP, HD><<<grid, 256, smem, stream>>>(
      (const T*)q, (const T*)ks, (const T*)vs, (const TP*)pk, (const TP*)pv,
      (const float*)pks, (const float*)pvs, (const int*)table, (const int*)starts, (T*)out, S,
      Hkv, G, page, T_w, W, BQ, kpb, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename TP>
int by_hd(int hd, const void* q, const void* ks, const void* vs, const void* pk,
          const void* pv, const void* pks, const void* pvs, const void* table,
          const void* starts, void* out, int n, int S, int Hkv, int G, int page, int T_w, int W,
          float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, TP, 32>(q, ks, vs, pk, pv, pks, pvs, table, starts, out, n, S, Hkv, G,
                               page, T_w, W, scale, stream);
    case 64:
      return launch<T, TP, 64>(q, ks, vs, pk, pv, pks, pvs, table, starts, out, n, S, Hkv, G,
                               page, T_w, W, scale, stream);
    case 128:
      return launch<T, TP, 128>(q, ks, vs, pk, pv, pks, pvs, table, starts, out, n, S, Hkv, G,
                                page, T_w, W, scale, stream);
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. W is the number of leading table pages
// a row may stream (already capped at T_w). Returns cudaGetLastError() after
// the launch (0 on success), or -1 for an unsupported head dim / dtype.
extern "C" int suffix_prefill(const void* q, const void* k_suf, const void* v_suf,
                              const void* pool_k, const void* pool_v, const void* table,
                              const void* starts, void* out, int dtype, int n, int S, int Hkv,
                              int G, int hd, int page, int T_w, int W, float scale,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return by_hd<float, float>(hd, q, k_suf, v_suf, pool_k, pool_v, nullptr, nullptr, table,
                               starts, out, n, S, Hkv, G, page, T_w, W, scale, s);
  if (dtype == 1)
    return by_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, k_suf, v_suf, pool_k, pool_v, nullptr,
                                               nullptr, table, starts, out, n, S, Hkv, G,
                                               page, T_w, W, scale, s);
  return -1;
}

// The int8-pool variant (the TPU kernel's pool_k_scale/pool_v_scale
// branch): int8 prefix pages (P, page, Hkv, hd) with f32 scales (P, page,
// Hkv), dequantized in the kernel to q's dtype; the suffix's k/v in q's
// dtype. Same return codes.
extern "C" int suffix_prefill_int8(const void* q, const void* k_suf, const void* v_suf,
                                   const void* pool_k, const void* pool_v,
                                   const void* pool_k_scale, const void* pool_v_scale,
                                   const void* table, const void* starts, void* out, int dtype,
                                   int n, int S, int Hkv, int G, int hd, int page, int T_w,
                                   int W, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return by_hd<float, int8_t>(hd, q, k_suf, v_suf, pool_k, pool_v, pool_k_scale,
                                pool_v_scale, table, starts, out, n, S, Hkv, G, page, T_w, W,
                                scale, s);
  if (dtype == 1)
    return by_hd<__nv_bfloat16, int8_t>(hd, q, k_suf, v_suf, pool_k, pool_v, pool_k_scale,
                                        pool_v_scale, table, starts, out, n, S, Hkv, G, page,
                                        T_w, W, scale, s);
  return -1;
}
