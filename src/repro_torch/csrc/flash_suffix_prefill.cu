// Suffix prefill over a cached prefix in the shared KV page pool.
//
// Replaces the TPU kernel src/repro/kernels/flash_suffix_prefill.py::
// suffix_prefill (body _suffix_kernel): n rows of S suffix queries at
// absolute positions starts[r] + i attend over (1) the row's cached prefix,
// read straight from the pool through its page table, lanes live iff
// c < starts[r], and (2) the suffix's own keys, causally in local
// coordinates. fp32 online softmax across both phases.
//
// What the design keeps from the TPU kernel is what saves work: no gather
// of the prefix pages into a contiguous copy in device memory, no score
// tensor in device memory, only pp = min(ceil(starts[r]/page), W) prefix
// pages read per row (a row with pp = 0 skips phase 1; table entries past
// pp are never read), and suffix tiles above the diagonal skipped. What
// bounds it on an H100: bytes at the main path's hit round (n 8, S 64,
// start 256, hd 64: 10.5 MB, 0.0031 ms, against 1.2 GFLOP, 0.0012 ms at 989
// TFLOP/s), operations for long suffixes over long prefixes.
//
// Two bodies, chosen by the element type (not a fallback):
//
// bfloat16: the tensor-core body of prefill_tc.cuh with one consumer
// warpgroup (64 query rows: hit rounds are short, S 64 at the main path,
// where a 128-row tile would leave half its rows idle) and two blocks per SM
// where their shared memory fits (hd 32 and 64; one at hd 128 and 160), so one block's loads run
// under the other's MMAs. Phase 1's tiles are
// written by the producer warpgroup itself, one key row per thread, through
// the row's page table into the swizzled layout the TMA boxes have: a page
// need not divide the 128-key tile or fit in it (pages of 12, 16 and 256
// all run), which a TMA box per page could not place in a swizzled tile.
// Phase 2's tiles are TMA boxes of the contiguous suffix k/v, as in flash
// prefill, stopping at the diagonal.
//
// float32: the SIMT body of common.cuh (fp32 FMAs from shared memory), the
// type of the reference-parity runs.
//
// int8 pools (suffix_prefill_int8, the TPU kernel's pool_k_scale/
// pool_v_scale branch): only the prefix pages read through the table are
// int8, dequantized to q's dtype while the tile is written (bf16: the
// producer rounds float(q) * s to bf16 into the same swizzled layout;
// fp32: repro::load_pool_rows); the suffix's own k/v stay in q's dtype.
// After the loads the kernel is the fp kernel: bitwise the fp kernel over
// the dequantized pool.
#include "common.cuh"
#include "prefill_tc.cuh"

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
    case 160:
      return launch<T, TP, 160>(q, ks, vs, pk, pv, pks, pvs, table, starts, out, n, S, Hkv, G,
                                page, T_w, W, scale, stream);
  }
  return -1;
}

// ----------------------------------------------------- bf16: tensor cores
constexpr int TW = 1;   // consumer warpgroups: 64 query rows per block

// Producer thread `c`'s key row of a phase-1 tile: pool row `row` (slot *
// Hkv + kv head) as bf16 into tile row c, or zeros for a dead column. An
// int8 row becomes bf16(float(q) * scale), the rounding of load_pool_rows.
template <int HD>
__device__ __forceinline__ void write_pool_row(const __nv_bfloat16* pool, const float*,
                                               long long row, bool live, unsigned char* tile,
                                               int c) {
  using L = repro::tc::Layout<HD>;
  const int4* src = reinterpret_cast<const int4*>(pool + row * HD);
#pragma unroll
  for (int x0 = 0; x0 < L::CH; x0 += 4) {   // 64 bytes in flight: the producer's 40 registers
    int4 val[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) val[x] = live ? __ldg(src + x0 + x) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int x = 0; x < 4; ++x)
      *reinterpret_cast<int4*>(tile + L::off(repro::tc::BK, c, x0 + x)) = val[x];
  }
}

template <int HD>
__device__ __forceinline__ void write_pool_row(const int8_t* pool, const float* scale,
                                               long long row, bool live, unsigned char* tile,
                                               int c) {
  using L = repro::tc::Layout<HD>;
  const int4* src = reinterpret_cast<const int4*>(pool + row * HD);
  const float sc = live ? __ldg(scale + row) : 0.0f;
#pragma unroll
  for (int x = 0; x < HD / 16; ++x) {   // 16 int8 in, two 16-byte bf16 chunks out
    const int4 raw = live ? __ldg(src + x) : make_int4(0, 0, 0, 0);
    const int8_t* v8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = repro::tc::pack_bf16(__fmul_rn((float)v8[half * 8 + 2 * e], sc),
                                    __fmul_rn((float)v8[half * 8 + 2 * e + 1], sc));
      *reinterpret_cast<int4*>(tile + L::off(repro::tc::BK, c, 2 * x + half)) =
          make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
    }
  }
}

template <int HD, typename TP>
struct SuffixPlan {
  static constexpr int R = 64 * TW;
  static constexpr int BK = repro::tc::BK;
  const CUtensorMap *qmap, *kmap, *vmap;
  const TP *pool_k, *pool_v;
  const float *pool_ks, *pool_vs;
  const int* table_row;
  __nv_bfloat16* out;
  int b, h, S, Hkv, G, BQ, page, q_lo, q_hi, live_pfx, n_pfx, n;

  __device__ int count() const { return n; }
  __device__ bool manual(int i) const { return i < n_pfx; }
  __device__ int k_lo(int i) const { return (i < n_pfx ? i : i - n_pfx) * BK; }
  __device__ bool masked(int i, int k) const {
    return i < n_pfx ? k + BK > live_pfx : (k + BK - 1 > q_lo || k + BK > S);
  }
  __device__ bool live(int i, int k, int qp, int c) const {
    // prefix lane k + c holds position k + c (< every query's position);
    // suffix keys are causal in local coordinates
    return i < n_pfx ? k + c < live_pfx : (k + c < S && k + c <= qp);
  }
  __device__ int qpos(int r) const { return q_lo + r / G; }
  __device__ void load_q(uint32_t dst, uint32_t bar) const {
    repro::tc::load_q_tma<HD, R>(qmap, dst, bar, G, BQ, h, q_lo, b);
  }
  __device__ void load_tile(int i, uint32_t k_dst, uint32_t v_dst, unsigned char* k_tile,
                            unsigned char* v_tile, uint32_t bar, int ptid) const {
    if (i >= n_pfx) {
      if (ptid == 0) repro::tc::load_kv_tma<HD>(kmap, vmap, k_dst, v_dst, bar, h, k_lo(i), b);
      return;
    }
    // phase 1: thread ptid writes key row ptid of the tile (prefix position
    // pos) from pool page table_row[pos / page]; table entries past the live
    // prefix are never read
    const int pos = i * BK + ptid;
    const bool live = pos < live_pfx;
    long long row = 0;
    if (live) {
      const int j = pos / page;
      row = ((long long)table_row[j] * page + (pos - j * page)) * Hkv + h;
    }
    write_pool_row<HD>(pool_k, pool_ks, row, live, k_tile, ptid);
    write_pool_row<HD>(pool_v, pool_vs, row, live, v_tile, ptid);
    repro::tc::fence_proxy_async();
    repro::tc::named_sync(1, 128);
    if (ptid == 0) repro::tc::mbar_arrive(bar);
  }
  __device__ __nv_bfloat16* out_row(int r) const {
    const int s = q_lo + r / G;
    if (r >= BQ * G || s >= S) return nullptr;
    return out + ((((size_t)b * S + s) * Hkv + h) * G + (r - (r / G) * G)) * HD;
  }
};

template <int HD, typename TP>
__global__ void __launch_bounds__(128 * (TW + 1), repro::tc::Regs<TW>::BLOCKS)
    suffix_prefill_tc(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const TP* __restrict__ pool_k,
                      const TP* __restrict__ pool_v, const float* __restrict__ pool_ks,
                      const float* __restrict__ pool_vs, const int* __restrict__ table,
                      const int* __restrict__ starts, __nv_bfloat16* __restrict__ out, int S,
                      int Hkv, int G, int BQ, int page, int T_w, int W, float scale_log2) {
  constexpr int BK = repro::tc::BK;
  SuffixPlan<HD, TP> p;
  p.qmap = &qmap;
  p.kmap = &kmap;
  p.vmap = &vmap;
  p.pool_k = pool_k;
  p.pool_v = pool_v;
  p.pool_ks = pool_ks;
  p.pool_vs = pool_vs;
  p.out = out;
  p.b = blockIdx.x / Hkv;
  p.h = blockIdx.x - p.b * Hkv;
  p.table_row = table + (size_t)p.b * T_w;
  p.S = S;
  p.Hkv = Hkv;
  p.G = G;
  p.BQ = BQ;
  p.page = page;
  p.q_lo = blockIdx.y * BQ;
  p.q_hi = min(p.q_lo + BQ, S) - 1;
  const int start = starts[p.b];
  const int pp = max(0, min((start + page - 1) / page, W));
  p.live_pfx = max(0, min(start, pp * page));
  p.n_pfx = (p.live_pfx + BK - 1) / BK;
  p.n = p.n_pfx + min((S + BK - 1) / BK, p.q_hi / BK + 1);
  repro::tc::run_block<HD, TW>(p, scale_log2);
}

template <int HD, typename TP>
int launch_tc(const void* q, const void* ks, const void* vs, const void* pk, const void* pv,
              const void* pks, const void* pvs, const void* table, const void* starts,
              void* out, int n, int S, int Hkv, int G, int page, int T_w, int W, float scale,
              cudaStream_t stream) {
  using L = repro::tc::Layout<HD>;
  const int BQ = 64 * TW / G;
  CUtensorMap qm, km, vm;
  const uint64_t qd[5] = {HD, (uint64_t)G, (uint64_t)Hkv, (uint64_t)S, (uint64_t)n};
  const uint32_t qb[5] = {L::AW, (uint32_t)G, 1, (uint32_t)BQ, 1};
  const uint64_t kd[4] = {HD, (uint64_t)Hkv, (uint64_t)S, (uint64_t)n};
  const uint32_t kb[4] = {L::AW, 1, repro::tc::BK, 1};
  int err = repro::tc::make_map<HD>(&qm, q, 5, qd, qb);
  if (err == 0) err = repro::tc::make_map<HD>(&km, ks, 4, kd, kb);
  if (err == 0) err = repro::tc::make_map<HD>(&vm, vs, 4, kd, kb);
  if (err != 0) return err;
  const size_t smem = repro::tc::smem_bytes<HD, TW>();
  // once per instantiation: its attributes do not change while the process runs
  static const int ready = repro::tc::prepare<TW>(suffix_prefill_tc<HD, TP>, smem);
  if (ready != 0) return ready;
  const dim3 grid(n * Hkv, (S + BQ - 1) / BQ);
  suffix_prefill_tc<HD, TP><<<grid, 128 * (TW + 1), smem, stream>>>(
      qm, km, vm, (const TP*)pk, (const TP*)pv, (const float*)pks, (const float*)pvs,
      (const int*)table, (const int*)starts, (__nv_bfloat16*)out, S, Hkv, G, BQ, page, T_w, W,
      scale * repro::tc::LOG2E);
  return (int)cudaGetLastError();
}

template <typename TP>
int by_hd_tc(int hd, const void* q, const void* ks, const void* vs, const void* pk,
             const void* pv, const void* pks, const void* pvs, const void* table,
             const void* starts, void* out, int n, int S, int Hkv, int G, int page, int T_w,
             int W, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_tc<32, TP>(q, ks, vs, pk, pv, pks, pvs, table, starts, out, n, S, Hkv, G,
                               page, T_w, W, scale, stream);
    case 64:
      return launch_tc<64, TP>(q, ks, vs, pk, pv, pks, pvs, table, starts, out, n, S, Hkv, G,
                               page, T_w, W, scale, stream);
    case 128:
      return launch_tc<128, TP>(q, ks, vs, pk, pv, pks, pvs, table, starts, out, n, S, Hkv, G,
                                page, T_w, W, scale, stream);
    case 160:
      return launch_tc<160, TP>(q, ks, vs, pk, pv, pks, pvs, table, starts, out, n, S, Hkv, G,
                                page, T_w, W, scale, stream);
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32 (SIMT body), 1 = bfloat16 (tensor-core body). W is
// the number of leading table pages a row may stream (already capped at
// T_w). Returns cudaGetLastError() after the launch (0 on success), -1 for an
// unsupported head dim / dtype, -2 if cuTensorMapEncodeTiled refused a tensor map.
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
    return by_hd_tc<__nv_bfloat16>(hd, q, k_suf, v_suf, pool_k, pool_v, nullptr, nullptr,
                                   table, starts, out, n, S, Hkv, G, page, T_w, W, scale, s);
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
    return by_hd_tc<int8_t>(hd, q, k_suf, v_suf, pool_k, pool_v, pool_k_scale, pool_v_scale,
                            table, starts, out, n, S, Hkv, G, page, T_w, W, scale, s);
  return -1;
}
