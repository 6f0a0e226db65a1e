// Per-block symmetric int8 quantize -> dequantize of a flat fp32 tensor.
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
// flops each). One 256-thread block per 256-element block, one element per
// thread: the loads and stores of a warp are 128 contiguous bytes, and the
// block max is one shared-memory tree reduction.
#include "reduce.cuh"

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
int8_roundtrip_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  __shared__ float buf[BLOCK];
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < n;
  const float v = live ? x[i] : 0.0f;
  const float amax = repro::block_reduce(buf, fabsf(v), repro::MaxOp());
  const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
  if (live) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f);
    out[i] = __fmul_rn(q, scale);
  }
}

}  // namespace

// x, out: n contiguous float32 elements. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int int8_roundtrip(const void* x, void* out, long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + BLOCK - 1) / BLOCK;
    int8_roundtrip_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, n);
  }
  return (int)cudaGetLastError();
}
