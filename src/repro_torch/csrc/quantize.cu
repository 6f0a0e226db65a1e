// Per-row symmetric int8: quantize -> dequantize of a flat fp32 tensor
// (int8_roundtrip), and the encoder that keeps (q, scale) (int8_encode).
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
// _encode_kernel), over rows of any R in {32, 64, 128, 256}: R = 256 is the
// uplink leaf's block, R = hd the int8 KV pool's row (one scale per token
// slot per kv head, the reference's kv_quant). Same numerics as above, so q
// and scale are bitwise the plain version's. The input is fp32 or bf16
// (widened exactly); elements at flat index >= n count as zeros (a ragged
// last row) and their q is written as 0.
//
// What bounds it: bytes (4 or 2 read, 1 written per element, 4 per row).
// One warp per row, each lane holding R/32 elements in registers, the row
// max by five butterfly shuffles (max is exact in any order): rows of 64
// (the pool write) would leave most of a 256-thread block idle otherwise.
template <typename T, int PER>
__global__ void __launch_bounds__(BLOCK)
int8_encode_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                   long long rows, long long n) {
  constexpr int R = 32 * PER;
  const long long row = (long long)blockIdx.x * (BLOCK / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const long long base = row * R;
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
int encode(const void* x, void* q, void* scale, long long rows, int R, long long n,
           cudaStream_t stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((rows + BLOCK / 32 - 1) / (BLOCK / 32));
  const T* xs = (const T*)x;
  int8_t* qs = (int8_t*)q;
  float* ss = (float*)scale;
  switch (R) {
    case 32: int8_encode_kernel<T, 1><<<blocks, BLOCK, 0, stream>>>(xs, qs, ss, rows, n); break;
    case 64: int8_encode_kernel<T, 2><<<blocks, BLOCK, 0, stream>>>(xs, qs, ss, rows, n); break;
    case 128: int8_encode_kernel<T, 4><<<blocks, BLOCK, 0, stream>>>(xs, qs, ss, rows, n); break;
    case 256: int8_encode_kernel<T, 8><<<blocks, BLOCK, 0, stream>>>(xs, qs, ss, rows, n); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
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

// x: rows x R contiguous elements of dtype 0 = float32 / 1 = bfloat16 (the
// first n of them real); q: rows x R int8; scale: rows float32. Returns
// cudaGetLastError() after the launch (0 on success), or -1 for an
// unsupported R or dtype.
extern "C" int int8_encode(const void* x, void* q, void* scale, long long rows, int R,
                           long long n, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return encode<float>(x, q, scale, rows, R, n, s);
  if (dtype == 1) return encode<__nv_bfloat16>(x, q, scale, rows, R, n, s);
  return -1;
}
