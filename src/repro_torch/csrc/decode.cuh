// The port's decode-attention kernel: one query token per row (all G query
// heads of one kv head) over that row's ring of cached keys, with the
// ring-validity mask, as a split-KV flash decode. One kernel body, two KV
// layouts:
//
//   TableLayout  the shared page pool (P, page, Hkv, hd) read through a
//                (B, T) page table (paged_decode, paged_decode_int8);
//   RingLayout   per-row contiguous rings (B, C, Hkv, hd), no table
//                (paged_decode_ring: live pages only; swa_decode: every slot).
//
// What bounds it on an H100: bytes. Each (row, kv head) reads its live K and
// V once and does 4*G*hd flops per key: at stablelm-1.6b's shape (G = 1, hd
// 64, bf16) that is 1 flop per byte, far below the ~295 flops per byte at
// which the tensor cores would become the limit. So the design streams the
// live keys at close to the HBM rate and keeps every step after the load
// off the critical path:
//
// 1. Split-KV over fixed slot ranges. A row's logical ring slots are cut
//    into ranges of `split` slots (a multiple of RING_TILE), starting at 0.
//    `split` is a pure function of the capacity and the head dim
//    (kernels/paged_decode.py::split_len: never of B, the positions or the
//    card), so the table layout over a pool that holds the same keys walks
//    the same ranges, and a row's output does not depend on the rows that
//    share its batch. The grid is (kv head x row chunk, row, range); each
//    block reduces one range of one (row, kv head) to a partial (m, l, acc)
//    in fp32, and decode_combine merges a row's partials in range order.
// 2. Dead ranges. The table and paged_decode_ring layouts read only the
//    live span (whole pages up to ceil(min(pos + 1, cap) / page)); a range
//    wholly past it writes the identity partial (m = NEG, l = 0, acc = 0)
//    and returns. swa_decode walks every range.
// 3. Each warp streams its quarter of every 64-key tile (16 keys) through a
//    two-stage ring of shared memory, filled by 16-byte cp.async in the
//    storage type (bf16, fp32, or int8 plus the f32 scales), and keeps its
//    own online softmax: q, the scores, the running (m, l) and the output
//    accumulator live in registers, the tile's max and sum are warp
//    shuffles. No block barrier until the range ends; then the four warps'
//    states are merged in warp order.
//
// Why the three entry points are bitwise equal over the same keys. Every
// reduction has an order fixed by the code: a dot product is E FMAs per
// lane (DecodeLanes: 8, 20 at hd 160, 16 at hd 256) and then a butterfly over
// the key's lanes; a tile's max and sum are a
// local pass and a butterfly over the warp's key groups; the warps merge in
// order 0..3 and the ranges in order 0, 1, 2, ... (each xor-butterfly step
// adds two values that both partners add in either order, so every lane
// holds the same bits). Every product that meets a sum is an explicit
// __fmaf_rn / __fmul_rn, so no instantiation contracts differently. What a
// kernel skips is then invisible:
//   - a tile (or a warp's 16 keys of it) past the live span that one layout
//     reads and another does not hold is wholly masked; after a live key it
//     leaves (m, l, acc) bitwise unchanged (p = exp(NEG - m) == 0, alpha ==
//     1), and a state that has seen no live key keeps m = NEG;
//   - a merge (of warps or of ranges) weighs each state by exp(m_i - M),
//     which is exactly 0 for a state with m = NEG (M comes from a live key:
//     slot pos mod cap is always live), whatever its l and acc; so a dead
//     range walked masked (swa_decode) and the identity partial of a dead
//     range skipped (paged_decode_ring, the table) add exactly nothing.
// That is why paged_decode_ring equals swa_decode at every page size of
// 64-512 keys, the table kernel equals both over the same keys in pool
// pages, and an int8 pool (dequantized at use exactly as
// repro::load_pool_rows does) equals the fp pool dequantized beforehand.
#pragma once

#include "common.cuh"

namespace repro {

// Keys per tile; splits start at multiples of it.
constexpr int RING_TILE = 64;
constexpr int DECODE_WARPS = 4;
constexpr int WARP_KEYS = RING_TILE / DECODE_WARPS;  // keys per warp per tile
constexpr int DECODE_STAGES = 2;                       // cp.async ring depth where it fits
// Ranges per row at most: kernels/paged_decode.py's split rule (MAX_RANGES)
// never cuts a ring into more; the combine holds a row's partials in
// registers.
constexpr int MAX_RANGES = 16;
constexpr unsigned FULL_MASK = 0xffffffffu;

// The TPU kernels' validity mask over a row's logical ring slots s: slot s
// holds global position pos - ((pos mod cap) - s) mod cap, live iff
// s < limit and lo <= gpos <= pos. With slot_w = pos mod cap and s < limit
// <= cap, slot_w - s lies in (-cap, cap), so its mod is one conditional add.
struct RingLive {
  int limit, pos, cap, slot_w, lo;
  __device__ bool operator()(int s) const {
    if (s >= limit) return false;
    int back = slot_w - s;
    if (back < 0) back += cap;
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

// A layout gives the ring's capacity, the slots the kernel reads (`limit`:
// slots at or past it are neither read nor live), and the (slot) index of
// logical slot s of row b in the flattened (slots, Hkv, hd) K/V tensor.
struct TableLayout {
  const int* table;
  int T_w, page;
  __host__ __device__ int cap() const { return T_w * page; }
  // The live pages only: the table is never read past them, so scratch
  // page 0 is never read for a live computation.
  __device__ int limit(int pos) const { return live_pages(pos, cap(), page, T_w) * page; }
  __device__ long long slot(int b, int s) const {
    const int j = s / page;
    return (long long)table[(size_t)b * T_w + j] * page + (s - j * page);
  }
};

// SKIP: read only the live pages (pages of `page` keys: a multiple of
// RING_TILE, or the whole ring); else every slot of the ring.
template <bool SKIP>
struct RingLayout {
  int C, page;
  __host__ __device__ int cap() const { return C; }
  __device__ int limit(int pos) const {
    return SKIP ? min(live_pages(pos, C, page, C / page) * page, C) : C;
  }
  __device__ long long slot(int b, int s) const { return (long long)b * C + s; }
};

// ------------------------------------------------------------ async copies
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes (nothing read) if !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, or zeros if !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ the kernel
// One warp's share of one tile in one pipeline stage: K[WARP_KEYS][HD] and
// V[WARP_KEYS][HD] in the storage type TP, then (int8 only) the keys' K and
// V scales, f32 each.
template <typename TP, int HD>
struct WarpStage {
  static constexpr bool INT8 = std::is_same<TP, int8_t>::value;
  static constexpr int ROW = HD * (int)sizeof(TP);         // bytes per key row
  static constexpr int CHUNKS = ROW / 16;                   // 16-byte chunks per row
  static constexpr int BYTES = 2 * WARP_KEYS * ROW + (INT8 ? 2 * WARP_KEYS * 4 : 0);
  static_assert(ROW % 16 == 0, "rows are whole 16-byte chunks");
};

// Dynamic shared memory of one block: the warps' stage rings, then the
// warps' final states [warp][row][HD + 2] (acc, m, l) for the merge.
template <typename TP, int HD, int RG, int STAGES>
__host__ __device__ constexpr size_t split_smem_bytes() {
  return (size_t)DECODE_WARPS * STAGES * WarpStage<TP, HD>::BYTES +
         (size_t)DECODE_WARPS * RG * (HD + 2) * sizeof(float);
}

// Stages of the cp.async ring: DECODE_STAGES where the block's shared memory
// fits the 227 KB opt-in, else 1 (fp32 at hd 256: two stages of 64 keys of
// K and V are 256 KB). The pipeline depth changes when a tile's loads are
// issued, never the order of any sum, so the output is the same bits.
template <typename TP, int HD, int RG>
__host__ __device__ constexpr int decode_stages() {
  return split_smem_bytes<TP, HD, RG, DECODE_STAGES>() <= 232448 ? DECODE_STAGES : 1;
}

// How a warp spreads a key over its lanes: LPK lanes per key (a power of
// two: the dot product's butterfly), E = HD / LPK dims each, KPP = 32 / LPK
// keys per pass. 8 dims a lane (one 16-byte bf16 load) where HD / 8 is a
// power of two up to 16; at hd 160 (HD / 8 = 20) 8 lanes of 20 dims, read
// as five 4-element pieces (8 bytes of bf16, 16 of fp32, 4 of int8: each
// piece aligned, since a lane's first dim is a multiple of 20); at hd 256
// 16 lanes of 16 dims (two keys a pass, two 16-byte bf16 loads a lane).
template <int HD>
struct DecodeLanes {
  static constexpr int LPK = HD == 160 ? 8 : HD == 256 ? 16 : HD / 8;
  static constexpr int E = HD / LPK;
  static_assert((LPK & (LPK - 1)) == 0 && LPK >= 4 && LPK <= 16 && E * LPK == HD &&
                    E % 4 == 0,
                "a key is a power-of-two group of lanes, 4-element pieces each");
};

// 8 consecutive elements of a key row (storage type TP) as fp32: an fp row
// as it is, an int8 row dequantized exactly as repro::load_pool_rows does
// (float(q) * s rounded to the query type T, then widened).
template <typename T, typename TP>
__device__ __forceinline__ void load8(const TP* src, float sc, float* out) {
  if constexpr (std::is_same<TP, int8_t>::value) {
    const int2 raw = *reinterpret_cast<const int2*>(src);
    const int8_t* vals = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = to_f(from_f<T>(__fmul_rn((float)vals[e], sc)));
  } else if constexpr (std::is_same<TP, float>::value) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
    const int4 raw = *reinterpret_cast<const int4*>(src);
    const TP* vals = reinterpret_cast<const TP*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = to_f(vals[e]);
  }
}

// 4 consecutive elements, as load8 (8 bytes of bf16, 16 of fp32, 4 of int8).
template <typename T, typename TP>
__device__ __forceinline__ void load4(const TP* src, float sc, float* out) {
  if constexpr (std::is_same<TP, int8_t>::value) {
    const int raw = *reinterpret_cast<const int*>(src);
    const int8_t* vals = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = to_f(from_f<T>(__fmul_rn((float)vals[e], sc)));
  } else if constexpr (std::is_same<TP, float>::value) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else {
    const int2 raw = *reinterpret_cast<const int2*>(src);
    const TP* vals = reinterpret_cast<const TP*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = to_f(vals[e]);
  }
}

// A lane's E dims of a key row: 8-element pieces where E allows, else 4.
template <typename T, typename TP, int E>
__device__ __forceinline__ void load_dims(const TP* src, float sc, float (&out)[E]) {
  if constexpr (E % 8 == 0) {
#pragma unroll
    for (int c = 0; c < E; c += 8) load8<T, TP>(src + c, sc, out + c);
  } else {
#pragma unroll
    for (int c = 0; c < E; c += 4) load4<T, TP>(src + c, sc, out + c);
  }
}

// Issue one warp's cp.async copies of its WARP_KEYS keys, slots s0.., into
// a stage: K and V rows of kv head h (zeros, nothing read, at or past
// `limit`), and for int8 their scales.
template <typename TP, int HD, typename Layout>
__device__ __forceinline__ void issue_keys(unsigned char* stage, const TP* k, const TP* v,
                                           const float* k_scale, const float* v_scale,
                                           const Layout& layout, int b, int h, int Hkv,
                                           int s0, int limit, int lane) {
  using W = WarpStage<TP, HD>;
  constexpr int E16 = 16 / (int)sizeof(TP);  // elements per 16-byte chunk
  constexpr int PER_LANE = WARP_KEYS * W::CHUNKS / 32;
  static_assert(PER_LANE * 32 == WARP_KEYS * W::CHUNKS, "whole chunks per lane");
  TP* sk = reinterpret_cast<TP*>(stage);
  TP* sv = sk + WARP_KEYS * HD;
  // every address first (the table reads in flight together), then the copies
  size_t off[PER_LANE];
  bool valid[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int i = lane + 32 * j;
    const int kk = i / W::CHUNKS;
    const int s = s0 + kk;
    valid[j] = s < limit;
    off[j] = valid[j] ? ((size_t)layout.slot(b, s) * Hkv + h) * HD : 0;
  }
  // int8: lane c < WARP_KEYS also copies key c's two scales
  const bool scaled = W::INT8 && lane < WARP_KEYS && s0 + lane < limit;
  const size_t srow = scaled ? (size_t)layout.slot(b, s0 + lane) * Hkv + h : 0;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int i = lane + 32 * j;
    const int kk = i / W::CHUNKS;
    const int part = (i - kk * W::CHUNKS) * E16;
    cp_async16(sk + kk * HD + part, k + off[j] + part, valid[j]);
    cp_async16(sv + kk * HD + part, v + off[j] + part, valid[j]);
  }
  if constexpr (W::INT8) {
    float* sks = reinterpret_cast<float*>(sv + WARP_KEYS * HD);
    if (lane < WARP_KEYS) {
      cp_async4(sks + lane, k_scale + srow, scaled);
      cp_async4(sks + WARP_KEYS + lane, v_scale + srow, scaled);
    }
  }
}

// One block per (kv head h and a chunk of RG of its G query rows, row b,
// range), 128 threads; the range varies slowest, so the blocks of the first
// ranges, which hold the live keys of most rows, are dispatched first and
// the dead ranges' blocks (which only write their identity partial) fill in
// behind them. Lane mapping within a warp (DecodeLanes): a key's HD dims are
// spread over LPK lanes, E dims each; KPP = 32 / LPK keys per pass, NP
// passes over the warp's 16 keys. T is q's / out's type, TP the
// K/V storage type (T, or int8_t for the table layout with k_scale/v_scale
// (P, page, Hkv) f32; unread for fp).
//
// part (B, Hkv, G, ranges, HD + 2) f32: the partial (acc[HD], m, l) of each
// range, written by this kernel and read by decode_combine.
template <typename T, typename TP, int HD, int RG, typename Layout>
__global__ void __launch_bounds__(DECODE_WARPS * 32)
    split_decode_kernel(const T* __restrict__ q, const TP* __restrict__ k,
                        const TP* __restrict__ v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int* __restrict__ pos_arr,
                        Layout layout, float* __restrict__ part, int Hkv, int G, int window,
                        float scale, int split) {
  using W = WarpStage<TP, HD>;
  constexpr int ST = decode_stages<TP, HD, RG>();
  constexpr int E = DecodeLanes<HD>::E;
  constexpr int LPK = DecodeLanes<HD>::LPK;
  constexpr int KPP = 32 / LPK;
  constexpr int NP = WARP_KEYS / KPP;
  constexpr int PS = HD + 2;  // floats per partial
  static_assert(LPK * KPP == 32 && NP * KPP == WARP_KEYS, "lane mapping");
  extern __shared__ __align__(16) unsigned char smem[];

  const int chunks = (G + RG - 1) / RG;
  const int h = blockIdx.x / chunks;
  const int g0 = (blockIdx.x - h * chunks) * RG;
  const int b = blockIdx.y;
  const int range = blockIdx.z;
  const int ranges = gridDim.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPK;   // the lane's key within a pass
  const int dim = (lane % LPK) * E;  // the lane's first dim

  // q rows g0..g0+RG-1 of (b, h), this lane's E dims (a row past G repeats
  // row G - 1 and is never written); loaded while pos is read
  float qr[RG][E];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    const T* src = q + (((size_t)b * Hkv + h) * G + min(g0 + r, G - 1)) * HD + dim;
#pragma unroll
    for (int e = 0; e < E; ++e) qr[r][e] = to_f(src[e]);
  }
  const int pos = pos_arr[b];
  const int cap = layout.cap();
  const int limit = layout.limit(pos);
  const int s_begin = range * split;
  float* out_part = part + (((size_t)b * Hkv + h) * G + g0) * ranges * PS + (size_t)range * PS;

  if (s_begin >= limit) {  // a range wholly past the live span: identity partial
    for (int i = threadIdx.x; i < RG * PS; i += blockDim.x) {
      const int r = i / PS;
      const int j = i - r * PS;
      if (g0 + r < G) out_part[(size_t)r * ranges * PS + j] = j == HD ? NEG : 0.0f;
    }
    return;
  }
  const int n_tiles = (min(s_begin + split, limit) - s_begin + RING_TILE - 1) / RING_TILE;
  const RingLive live{limit, pos, cap, pos % cap, window > 0 ? max(pos - (window - 1), 0) : 0};

  float m[RG], l[RG], acc[RG][E];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    m[r] = NEG;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
  }

  unsigned char* ring = smem + (size_t)warp * ST * W::BYTES;
  const int s_warp = s_begin + warp * WARP_KEYS;  // the warp's first slot in tile 0
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < n_tiles)
      issue_keys<TP, HD>(ring + t * W::BYTES, k, v, k_scale, v_scale, layout, b, h, Hkv,
                         s_warp + t * RING_TILE, limit, lane);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int tn = t + ST - 1;
    if (tn < n_tiles)
      issue_keys<TP, HD>(ring + (tn % ST) * W::BYTES, k, v, k_scale, v_scale,
                         layout, b, h, Hkv, s_warp + tn * RING_TILE, limit, lane);
    cp_async_commit();
    cp_async_wait<ST - 1>();
    __syncwarp();

    const unsigned char* stage = ring + (t % ST) * W::BYTES;
    const TP* sk = reinterpret_cast<const TP*>(stage);
    const TP* sv = sk + WARP_KEYS * HD;
    const float* sks = reinterpret_cast<const float*>(sv + WARP_KEYS * HD);
    const int s0 = s_warp + t * RING_TILE;

    // scores s[r][p] of key p * KPP + grp, the same in the key's LPK lanes
    float s[RG][NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int kk = p * KPP + grp;
      float kf[E];
      load_dims<T, TP, E>(sk + kk * HD + dim, W::INT8 ? sks[kk] : 0.0f, kf);
      const bool lv = live(s0 + kk);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = __fmaf_rn(qr[r][e], kf[e], d);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) d = __fadd_rn(d, __shfl_xor_sync(FULL_MASK, d, o));
        s[r][p] = lv ? __fmul_rn(d, scale) : NEG;
      }
    }
    // online softmax over the warp's 16 keys:
    //   m' = max(m, max s);  p = exp(s - m');  alpha = exp(m - m')
    //   l' = l * alpha + sum p;  acc' = acc * alpha + p @ v
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int p = 1; p < NP; ++p) mx = fmaxf(mx, s[r][p]);
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        s[r][p] = expf(s[r][p] - m_new);
        sum = __fadd_rn(sum, s[r][p]);
      }
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) sum = __fadd_rn(sum, __shfl_xor_sync(FULL_MASK, sum, o));
      l[r] = __fmaf_rn(l[r], alpha, sum);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = __fmul_rn(acc[r][e], alpha);
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int kk = p * KPP + grp;
      float vf[E];
      load_dims<T, TP, E>(sv + kk * HD + dim, W::INT8 ? sks[WARP_KEYS + kk] : 0.0f, vf);
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = __fmaf_rn(s[r][p], vf[e], acc[r][e]);
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // the warp's acc: each lane holds its key group's share; sum the groups
  float* merge = reinterpret_cast<float*>(smem + (size_t)DECODE_WARPS * ST * W::BYTES);
#pragma unroll
  for (int r = 0; r < RG; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        acc[r][e] = __fadd_rn(acc[r][e], __shfl_xor_sync(FULL_MASK, acc[r][e], o));
    float* wst = merge + ((size_t)warp * RG + r) * PS;
    if (grp == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) wst[dim + e] = acc[r][e];
    }
    if (lane == 0) {
      wst[HD] = m[r];
      wst[HD + 1] = l[r];
    }
  }
  __syncthreads();
  // merge the warps' states in warp order into the range's partial
  for (int i = threadIdx.x; i < RG * HD; i += blockDim.x) {
    const int r = i / HD;
    const int d = i - r * HD;
    if (g0 + r >= G) continue;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < DECODE_WARPS; ++w) mx = fmaxf(mx, merge[((size_t)w * RG + r) * PS + HD]);
    float lsum = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < DECODE_WARPS; ++w) {
      const float* wst = merge + ((size_t)w * RG + r) * PS;
      const float wt = expf(wst[HD] - mx);
      lsum = __fmaf_rn(wt, wst[HD + 1], lsum);
      a = __fmaf_rn(wt, wst[d], a);
    }
    float* dst = out_part + (size_t)r * ranges * PS;
    dst[d] = a;
    if (d == 0) {
      dst[HD] = mx;
      dst[HD + 1] = lsum;
    }
  }
}

// out (B, Hkv, G, HD) = the partials of each (row, kv head, query row)
// merged in range order 0, 1, 2, ...: M = max m_r, w_r = exp(m_r - M),
// out = (sum w_r acc_r) / max(sum w_r l_r, 1e-30). One thread per output
// element, its row's partials read all at once (ranges <= MAX_RANGES); no
// atomics, so the order is the code's.
template <typename T, int HD>
__global__ void decode_combine(const float* __restrict__ part, T* __restrict__ out,
                               long long n, int ranges) {
  constexpr int PS = HD + 2;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long row = i / HD;
  const int d = (int)(i - row * HD);
  const float* p = part + row * ranges * PS;
  float m[MAX_RANGES], l[MAX_RANGES], acc[MAX_RANGES];
#pragma unroll
  for (int r = 0; r < MAX_RANGES; ++r) {
    const bool in = r < ranges;
    m[r] = in ? p[(size_t)r * PS + HD] : NEG;
    l[r] = in ? p[(size_t)r * PS + HD + 1] : 0.0f;
    acc[r] = in ? p[(size_t)r * PS + d] : 0.0f;
  }
  float mx = NEG;
#pragma unroll
  for (int r = 0; r < MAX_RANGES; ++r) mx = fmaxf(mx, m[r]);
  float lsum = 0.0f, a = 0.0f;
#pragma unroll
  for (int r = 0; r < MAX_RANGES; ++r) {
    if (r >= ranges) break;
    const float wt = expf(m[r] - mx);
    lsum = __fmaf_rn(wt, l[r], lsum);
    a = __fmaf_rn(wt, acc[r], a);
  }
  out[i] = from_f<T>(a / fmaxf(lsum, 1e-30f));
}

// Launch the split kernel and the combine on `stream`. `split` (keys per
// range, a positive multiple of RING_TILE, at most MAX_RANGES ranges per
// row) comes from the caller's rule; the partials buffer holds B * Hkv * G
// * ceil(cap / split) * (HD + 2) floats, allocated by the caller. Returns
// cudaGetLastError() after the launches, or -1 for a split the kernel
// cannot take.
template <typename T, typename TP, int HD, int RG, typename Layout>
int launch_split(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                 const void* pos, Layout layout, void* part, void* out, int B, int Hkv, int G,
                 int window, int split, float scale, cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<TP, HD, RG, decode_stages<TP, HD, RG>()>();
  // the opt-in above 48 KB, once per instantiation
  static const cudaError_t attr = allow_smem(split_decode_kernel<T, TP, HD, RG, Layout>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int ranges = (layout.cap() + split - 1) / split;
  if (ranges > MAX_RANGES) return -1;
  const int chunks = (G + RG - 1) / RG;
  split_decode_kernel<T, TP, HD, RG, Layout>
      <<<dim3(Hkv * chunks, B, ranges), DECODE_WARPS * 32, smem, stream>>>(
          (const T*)q, (const TP*)k, (const TP*)v, (const float*)ks, (const float*)vs,
          (const int*)pos, layout, (float*)part, Hkv, G, window, scale, split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * Hkv * G * HD;
  decode_combine<T, HD><<<(unsigned)((n + 127) / 128), 128, 0, stream>>>((const float*)part,
                                                                          (T*)out, n, ranges);
  return (int)cudaGetLastError();
}

// One query row per block at G 1, chunks of 4 rows otherwise.
template <typename T, typename TP, int HD, typename Layout>
int launch_rows(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                const void* pos, Layout layout, void* part, void* out, int B, int Hkv, int G,
                int window, int split, float scale, cudaStream_t stream) {
  if (G == 1)
    return launch_split<T, TP, HD, 1>(q, k, v, ks, vs, pos, layout, part, out, B, Hkv, G,
                                      window, split, scale, stream);
  return launch_split<T, TP, HD, 4>(q, k, v, ks, vs, pos, layout, part, out, B, Hkv, G,
                                    window, split, scale, stream);
}

template <typename Layout>
struct IsRing : std::false_type {};
template <bool SKIP>
struct IsRing<RingLayout<SKIP>> : std::true_type {};

// Dispatch on head dim (32, 64, 128, 160; 256 for the ring layouts only: the
// hybrid's local attention, which has no paged pool); -1 for another head
// dim, a G below 1 or a split that is not a positive multiple of RING_TILE.
template <typename T, typename TP, typename Layout>
int decode_by_hd(int hd, const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* pos, Layout layout, void* part, void* out, int B,
                 int Hkv, int G, int window, int split, float scale, cudaStream_t stream) {
  if (G < 1 || split <= 0 || split % RING_TILE) return -1;
  switch (hd) {
    case 32:
      return launch_rows<T, TP, 32>(q, k, v, ks, vs, pos, layout, part, out, B, Hkv, G,
                                    window, split, scale, stream);
    case 64:
      return launch_rows<T, TP, 64>(q, k, v, ks, vs, pos, layout, part, out, B, Hkv, G,
                                    window, split, scale, stream);
    case 128:
      return launch_rows<T, TP, 128>(q, k, v, ks, vs, pos, layout, part, out, B, Hkv, G,
                                     window, split, scale, stream);
    case 160:
      return launch_rows<T, TP, 160>(q, k, v, ks, vs, pos, layout, part, out, B, Hkv, G,
                                     window, split, scale, stream);
    case 256:
      if constexpr (IsRing<Layout>::value)
        return launch_rows<T, TP, 256>(q, k, v, ks, vs, pos, layout, part, out, B, Hkv, G,
                                       window, split, scale, stream);
      break;
  }
  return -1;
}

// The fp ring kernels (q, out and the rings share dtype: 0 = float32,
// 1 = bfloat16): RingLayout<SKIP> over (B, C, Hkv, hd).
template <bool SKIP>
int ring_decode(const void* q, const void* k, const void* v, const void* pos, void* part,
                void* out, int dtype, int B, int C, int Hkv, int G, int hd, int page,
                int window, int split, float scale, cudaStream_t stream) {
  const RingLayout<SKIP> layout{C, page};
  if (dtype == 0)
    return decode_by_hd<float, float>(hd, q, k, v, nullptr, nullptr, pos, layout, part, out,
                                      B, Hkv, G, window, split, scale, stream);
  if (dtype == 1)
    return decode_by_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, k, v, nullptr, nullptr, pos,
                                                      layout, part, out, B, Hkv, G, window,
                                                      split, scale, stream);
  return -1;
}

}  // namespace repro
