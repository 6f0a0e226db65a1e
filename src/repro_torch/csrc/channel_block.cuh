// One warp per 256-element block of a flat fp32 tensor, held in registers:
// the layout and the warp reductions shared by the uplink channel's block
// kernels (topk_compress.cu, and quantize.cu's int8_roundtrip).
//
// Lane l holds elements 4l..4l+3 and 128+4l..128+4l+3 of its warp's block.
// It reads them with two 16-byte loads, so each warp-wide load covers 512
// contiguous bytes, and writes them back with two 16-byte stores. A CTA of
// WARPS warps covers WARPS consecutive blocks; the grid is sized to the data.
//
// The last block may be ragged: its elements at flat index >= n read as
// zeros (the reference's zero padding) and are not written. That block takes
// scalar loads and stores in the same layout, and so does every block of a
// call whose x or out starts off a 16-byte boundary (a view with an offset:
// no caller on the training path makes one).
//
// For finite floats, magnitudes order exactly as the uint32 bits of
// fabsf(x), and fabsf makes -0 into +0, so equal bits are equal magnitudes.
// A block's max magnitude is then one __reduce_max_sync over those bits, and
// a count one __reduce_add_sync: both exact in any order, with no shared
// memory and no __syncthreads.
#pragma once

#include <cuda_runtime.h>

namespace repro {
namespace channel {

constexpr int BLOCK = 256;    // elements per block
constexpr int PER_LANE = 8;   // elements per lane: BLOCK / 32
constexpr int WARPS = 8;      // blocks (one per warp) per CTA
constexpr unsigned FULL = 0xffffffffu;
static_assert(PER_LANE * 32 == BLOCK, "a warp holds one block");

// The block this warp owns.
__device__ __forceinline__ long long warp_block() {
  return (long long)blockIdx.x * WARPS + threadIdx.x / 32;
}

// Offset in its block of this lane's element e (0 <= e < PER_LANE).
__device__ __forceinline__ int lane_offset(int e) {
  return (e & 4) * 32 + 4 * (int)(threadIdx.x & 31) + (e & 3);
}

// This lane's elements of the block at flat index base: two 16-byte loads if
// vec, else scalar loads with zeros at flat index >= n.
__device__ __forceinline__ void load(const float* __restrict__ x, long long base, long long n,
                                     bool vec, float (&v)[PER_LANE]) {
  if (vec) {
    const float4* p = reinterpret_cast<const float4*>(x + base) + (threadIdx.x & 31);
    const float4 a = p[0], b = p[32];  // p[32]: 128 floats on, the second half
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const long long i = base + lane_offset(e);
      v[e] = i < n ? x[i] : 0.0f;
    }
  }
}

// The inverse of load: elements at flat index >= n are not written.
__device__ __forceinline__ void store(float* __restrict__ out, long long base, long long n,
                                      bool vec, const float (&v)[PER_LANE]) {
  if (vec) {
    float4* p = reinterpret_cast<float4*>(out + base) + (threadIdx.x & 31);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[32] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const long long i = base + lane_offset(e);
      if (i < n) out[i] = v[e];
    }
  }
}

// |x| as bits that order as the magnitudes (x finite).
__device__ __forceinline__ unsigned mag_bits(float x) { return __float_as_uint(fabsf(x)); }

// Whether the block at base takes the 16-byte loads: whole, and x and out
// aligned (checked once per call by the launcher).
__device__ __forceinline__ bool vector_block(long long base, long long n, bool aligned) {
  return aligned && base + BLOCK <= n;
}

}  // namespace channel
}  // namespace repro
