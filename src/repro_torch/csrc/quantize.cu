// Per-row symmetric int8: quantize -> dequantize of a flat fp32 tensor
// (int8_roundtrip), the encoder that keeps (q, scale) (int8_encode), and the
// int8 KV pool's write, which quantizes K and V and stores q and scale in
// their page slots (kv_write_int8).
//
// Replaces the TPU kernel src/repro/kernels/quantize.py::int8_roundtrip
// (body _roundtrip_kernel): each 256-element block gets the scale
// s = max(max|x| / 127, 1e-12) and every element becomes
// clip(round(x / s), -127, 127) * s. The last block may be ragged: its
// missing elements count as zeros (what the reference's zero padding gives)
// and are neither read nor written.
//
// The numerics follow the reference exactly, so the output is bitwise equal
// to the plain version: IEEE division (__fdiv_rn, never a reciprocal
// multiply), the 1e-12 floor applied before the division, round half to
// even (rintf, as jnp.round and torch.round), and a separate multiply.
//
// What bounds it on an H100: bytes (4 read + 4 written per element, a few
// flops each). One warp per block, its 256 elements in registers
// (channel_block.cuh): 16-byte loads and stores, and the block max is one
// __reduce_max_sync over the magnitudes' bits, with no shared memory and no
// barrier.
#include "channel_block.cuh"
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(repro::channel::WARPS * 32)
int8_roundtrip_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                      long long blocks, bool aligned) {
  namespace ch = repro::channel;
  const long long b = ch::warp_block();
  if (b >= blocks) return;  // the whole warp leaves together
  const long long base = b * ch::BLOCK;
  const bool vec = ch::vector_block(base, n, aligned);
  float v[ch::PER_LANE];
  ch::load(x, base, n, vec, v);
  unsigned mx = 0;
#pragma unroll
  for (int e = 0; e < ch::PER_LANE; ++e) mx = max(mx, ch::mag_bits(v[e]));
  const float amax = __uint_as_float(__reduce_max_sync(ch::FULL, mx));
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
#pragma unroll
  for (int e = 0; e < ch::PER_LANE; ++e)
    v[e] = __fmul_rn(fminf(fmaxf(rintf(__fdiv_rn(v[e], s)), -127.0f), 127.0f), s);
  ch::store(out, base, n, vec, v);
}

// Replaces the TPU kernel src/repro/kernels/quantize.py::int8_encode (body
// _encode_kernel) at the uplink leaf: rows of BLOCK = 256 elements, the
// int8 wire form's blocks (the int8 KV pool's rows go through
// kv_write_int8 below). Same numerics as above, so q and scale are bitwise
// the plain version's. The input is fp32 or bf16 (widened exactly);
// elements at flat index >= n count as zeros (a ragged last row) and their
// q is written as 0.
//
// What bounds it: bytes (4 or 2 read, 1 written per element, 4 per row).
// One warp per row, each lane holding 8 elements in registers, the row max
// by five butterfly shuffles (max is exact in any order).
template <typename T>
__global__ void __launch_bounds__(BLOCK)
int8_encode_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                   long long rows, long long n) {
  constexpr int PER = BLOCK / 32;
  const long long row = (long long)blockIdx.x * (BLOCK / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const long long base = row * BLOCK;
  float v[PER];
  float amax = 0.0f;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const long long i = base + p * 32 + lane;
    v[p] = i < n ? repro::to_f(x[i]) : 0.0f;
    amax = fmaxf(amax, fabsf(v[p]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
#pragma unroll
  for (int p = 0; p < PER; ++p)
    q[base + p * 32 + lane] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v[p], s)), -127.0f), 127.0f);
  if (lane == 0) scale[row] = s;
}

template <typename T>
int encode(const void* x, void* q, void* scale, long long rows, long long n,
           cudaStream_t stream) {
  if (rows > 0) {
    const unsigned blocks = (unsigned)((rows + BLOCK / 32 - 1) / (BLOCK / 32));
    int8_encode_kernel<T><<<blocks, BLOCK, 0, stream>>>((const T*)x, (int8_t*)q, (float*)scale,
                                                        rows, n);
  }
  return (int)cudaGetLastError();
}

// The int8 KV pool's write: one launch per layer quantizes K and V and stores
// q and scale in their page slots. Replaces the TPU kernel
// src/repro/kernels/quantize.py::int8_encode (body _encode_kernel) at the
// writes of the reference's int8 pool: the decode write
// (src/repro/models/attention.py:497-516, one token per row at its pos) and
// the masked requantization of the prefill write
// (src/repro/models/transformer.py:588-603, which leaves fresh (q, scale)
// exactly in the slots the round's tokens occupy; only those are written
// here, which leaves the same pool). Per (row r, token j, kv head h, plane K
// or V): s = max(max|x| / 127, 1e-12), q = clip(rint(x / s), +-127), with
// the numerics of the kernels above (__fdiv_rn, the floor before the
// division, rintf, then clip): q and s are bitwise the plain version's.
//
// Token j of row r is live iff j < lengths[r] and j >= lengths[r] - cap
// (cap = T * page: a row longer than its ring keeps its last cap tokens, so
// no two live tokens share a slot); lengths == nullptr means one token per
// row (the decode step, where starts is pos). A live token goes to ring slot
// (starts[r] + j) mod cap, i.e. page table[r][slot / page], offset
// slot % page. All of it is worked out here: the host reads nothing back.
//
// What bounds it on an H100: the launch. A decode step writes 8 x 32 head
// rows of K and of V (65,536 B read, 34,816 B written: ~0.00003 ms at the
// HBM rate), so the design is one launch per layer for both planes with no
// index tensors made on the host. One group of LANES lanes per head row
// (WriteLanes: 8 for a bf16 row of 64): each lane makes one 16-byte load
// (two for an fp32 row of 160) and one store of its int8 values; the row
// max is a xor butterfly over the magnitudes' uint32 bits inside the group
// (exact in any order, as in channel_block.cuh), and lane 0 of the group
// writes the scale. Where a row's pieces are not a power of two (20 at hd
// 160) the group is the next power of two, 32, and its lanes past the row
// load nothing, add 0 to the max and store nothing: the scale stays one per
// (token, kv head). No shared memory and no barrier; a group leaves as a
// whole (its row is out of range or its token dead), so each shuffle names
// only its own group's lanes.
struct KvWrite {
  const void* k;        // (n, S, Hkv, HD) elements, token rows contiguous
  const void* v;
  const int* table;     // (n, T)
  const int* starts;    // (n,)
  const int* lengths;   // (n,) or nullptr: one token per row
  int8_t* kq;           // (P, page, Hkv, HD)
  int8_t* vq;
  float* ks;            // (P, page, Hkv)
  float* vs;
  long long k_row, k_tok, v_row, v_tok;  // strides in elements
  long long items;      // n * S * 2 * Hkv head rows
  int s, hkv, t, page;
};

template <typename T, int HD>
struct WriteLanes {
  static constexpr int VEC = 16 / (int)sizeof(T);    // elements per 16-byte load
  static constexpr int NV = HD / VEC > 32 ? 2 : 1;   // loads per lane
  static constexpr int EPL = VEC * NV;               // elements per lane
  static constexpr int USED = HD / EPL;              // lanes holding the row
  static constexpr int LANES = USED <= 4 ? 4 : USED <= 8 ? 8 : USED <= 16 ? 16 : 32;
  static_assert(USED * EPL == HD && USED <= 32, "a head row in whole pieces, within a warp");
};

template <typename T, int HD>
__global__ void __launch_bounds__(BLOCK) kv_write_int8_kernel(const KvWrite a) {
  using WL = WriteLanes<T, HD>;
  constexpr int VEC = WL::VEC, NV = WL::NV, EPL = WL::EPL, LANES = WL::LANES;
  const long long item = ((long long)blockIdx.x * BLOCK + threadIdx.x) / LANES;
  if (item >= a.items) return;  // the whole group leaves together
  // item = ((r * S + j) * 2 + plane) * Hkv + h: a token's heads, K then V,
  // are neighbouring groups and read neighbouring bytes
  const int h = (int)(item % a.hkv);
  const long long tok2 = item / a.hkv;
  const int plane = (int)(tok2 & 1);
  const long long tok = tok2 >> 1;
  const int j = (int)(tok % a.s);
  const long long r = tok / a.s;
  const int len = a.lengths ? a.lengths[r] : 1;
  const int cap = a.t * a.page;
  if (j >= len || j < len - cap) return;  // dead token: nothing stored
  const long long slot = ((long long)a.starts[r] + j) % cap;
  const long long phys = a.table[r * a.t + slot / a.page];
  const long long row = (phys * a.page + slot % a.page) * a.hkv + h;  // in the planes
  const int sub = threadIdx.x & (LANES - 1);
  const bool holds = sub < WL::USED;  // else a lane past the row: no load, no store
  const T* src = static_cast<const T*>(plane ? a.v : a.k) +
                 r * (plane ? a.v_row : a.k_row) + j * (plane ? a.v_tok : a.k_tok) +
                 h * HD + sub * EPL;
  alignas(16) T raw[EPL];
#pragma unroll
  for (int u = 0; u < NV; ++u)
    *reinterpret_cast<uint4*>(raw + u * VEC) =
        holds ? *reinterpret_cast<const uint4*>(src + u * VEC) : make_uint4(0, 0, 0, 0);
  float x[EPL];
  unsigned mx = 0;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    x[e] = repro::to_f(raw[e]);
    mx = max(mx, __float_as_uint(fabsf(x[e])));
  }
  const int lane = threadIdx.x & 31;
  const unsigned group =
      LANES == 32 ? 0xffffffffu : ((1u << (LANES & 31)) - 1) << (lane & ~(LANES - 1));
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    mx = max(mx, __shfl_xor_sync(group, mx, off));
  const float s = fmaxf(__fdiv_rn(__uint_as_float(mx), 127.0f), 1e-12f);
  unsigned w[EPL / 4] = {};
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int q = (int)fminf(fmaxf(rintf(__fdiv_rn(x[e], s)), -127.0f), 127.0f);
    w[e / 4] |= (unsigned)(q & 0xff) << (8 * (e & 3));
  }
  if (!holds) return;
  int8_t* dst = (plane ? a.vq : a.kq) + row * HD + sub * EPL;
  if constexpr (EPL == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<unsigned*>(dst) = w[0];
  }
  if (sub == 0) (plane ? a.vs : a.ks)[row] = s;
}

template <typename T, int HD>
int launch_write(const KvWrite& a, cudaStream_t stream) {
  const long long threads = a.items * WriteLanes<T, HD>::LANES;
  kv_write_int8_kernel<T, HD>
      <<<(unsigned)((threads + BLOCK - 1) / BLOCK), BLOCK, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int write(const KvWrite& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_write<T, 32>(a, stream);
    case 64: return launch_write<T, 64>(a, stream);
    case 128: return launch_write<T, 128>(a, stream);
    case 160: return launch_write<T, 160>(a, stream);
    default: return -1;
  }
}

}  // namespace

// x, out: n contiguous float32 elements. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int int8_roundtrip(const void* x, void* out, long long n, void* stream) {
  namespace ch = repro::channel;
  if (n > 0) {
    const long long blocks = (n + ch::BLOCK - 1) / ch::BLOCK;
    const bool aligned = (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
    int8_roundtrip_kernel<<<(unsigned)((blocks + ch::WARPS - 1) / ch::WARPS), ch::WARPS * 32, 0,
                            (cudaStream_t)stream>>>((const float*)x, (float*)out, n, blocks,
                                                    aligned);
  }
  return (int)cudaGetLastError();
}

// x: rows x 256 contiguous elements of dtype 0 = float32 / 1 = bfloat16
// (the first n of them real); q: rows x 256 int8; scale: rows float32.
// Returns cudaGetLastError() after the launch (0 on success), or -1 for an
// unsupported dtype.
extern "C" int int8_encode(const void* x, void* q, void* scale, long long rows, long long n,
                           int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return encode<float>(x, q, scale, rows, n, s);
  if (dtype == 1) return encode<__nv_bfloat16>(x, q, scale, rows, n, s);
  return -1;
}

// k, v: (n, S, Hkv, hd) of dtype 0 = float32 / 1 = bfloat16, each token's
// Hkv * hd elements contiguous, rows and tokens k_row/k_tok (v_row/v_tok)
// elements apart, every token row at a 16-byte boundary; table (n, T),
// starts (n,), lengths (n,) or null: int32; kq, vq (P, page, Hkv, hd) int8,
// 8-byte aligned, and ks, vs (P, page, Hkv) float32. Writes the live
// tokens' q and scales in place. Returns cudaGetLastError() after the launch
// (0 on success; no launch when there is nothing to write), or -1 for an
// unsupported hd or dtype.
extern "C" int kv_write_int8(const void* k, const void* v, const void* table,
                             const void* starts, const void* lengths, void* kq, void* vq,
                             void* ks, void* vs, long long k_row, long long k_tok,
                             long long v_row, long long v_tok, int n, int s, int hkv, int hd,
                             int t, int page, int dtype, void* stream) {
  KvWrite a{k, v, (const int*)table, (const int*)starts, (const int*)lengths,
            (int8_t*)kq, (int8_t*)vq, (float*)ks, (float*)vs,
            k_row, k_tok, v_row, v_tok, (long long)n * s * 2 * hkv, s, hkv, t, page};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype != 0 && dtype != 1) return -1;
  if (hd != 32 && hd != 64 && hd != 128 && hd != 160) return -1;
  if (a.items <= 0) return (int)cudaGetLastError();
  return dtype == 0 ? write<float>(a, hd, st) : write<__nv_bfloat16>(a, hd, st);
}
