// The DP transmit transform of the federated uplink: the squared L2 norm of
// a tensor, and the fused clip-and-noise x * scale + sigma * noise.
//
// Replaces the TPU kernels src/repro/kernels/dp_clip.py::sq_norm (body
// _sq_norm_kernel) and ::clip_noise (body _clip_noise_kernel). Both take
// the tensor as n flat contiguous elements; no padding is needed.
//
// What bounds both on an H100: bytes. sq_norm reads each element once;
// clip_noise reads x (and the fp32 noise) and writes the output once. Both
// move their data in 16-byte vectors per thread (4 fp32 or 8 bf16) and
// start several vectors' loads in every thread before the first is used.
// Plain loads and stores: in trial builds on an H100 the streaming hints
// (ld/st.global.cs) made the norm no faster and clip_noise slower.
//
// sq_norm, one launch. The TPU kernel carried one accumulator across its
// sequential grid; Hopper blocks run in parallel and in no order. Each block
// sums a fixed chunk of CHUNK elements into one partial: thread t reads
// vector j of the chunk at element (j * BLOCK + t) * VEC, squares and adds
// element k of each vector into accumulator k % ACC (j outer, k inner),
// adds its accumulators as (a0 + a1) + (a2 + a3), and the block adds the
// threads' sums in an xor butterfly within each warp and then one over the
// warps' sums. The block that takes the last ticket of the grid's counter
// (after a __threadfence that publishes its partial) sums the partials the
// same way: thread t adds partial r * BLOCK + t into accumulator r % ACC,
// then the same butterflies. Every addition's order follows from n alone,
// never from which block finishes last, so two calls give the same bits and
// so the same clip scale. A chunk that is not whole or not 16-byte aligned
// is read element by element in the same order, with zeros past n. Each
// product and sum is rounded on its own (no FMA), so that
// tests/test_torch_dp_clip.py emulates the order bitwise in PyTorch.
//
// The counter: the last block sets it back to 0 before it exits, so the
// next call finds it clean without a launch of its own. The wrapper keeps
// one counter per CUDA stream (calls on one stream run one after another;
// calls on two streams never share one) and allocates the partials per call
// from PyTorch's stream-ordered allocator.
//
// clip_noise: y = x * scale + sigma * noise, each product and the sum
// rounded on its own (__fmul_rn / __fadd_rn: nvcc may not contract them into
// an FMA), so the result is bitwise the plain PyTorch expression; the output
// has the input's dtype. scale is read from device memory (a 0-d tensor the
// norm produced), so clipping needs no host synchronisation. With no noise
// pointer (sigma = 0, the clip) no noise is read. Each block takes one
// tile of CLIP_BLOCK x UNROLL vectors, so the blocks resident at a time
// stream one contiguous stretch (a grid sized to the resident blocks,
// striding over the whole tensor, was slower in trial builds). The ragged
// tail takes a scalar loop in the same kernel. If x, out or noise starts off
// a 16-byte boundary (a view with an offset: no caller on the training path
// makes one), every element takes that loop.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int BLOCK = 256;       // sq_norm
constexpr int WARPS = BLOCK / 32;
constexpr int CHUNK = 65536;     // sq_norm: elements per block and partial
constexpr int ACC = 4;           // sq_norm: accumulators per thread
constexpr int PARTS = 16;        // sq_norm: partials in flight per thread of the last block
constexpr int CLIP_BLOCK = 128;  // clip_noise
constexpr int UNROLL = 2;        // clip_noise: 16-byte vectors of x in flight per thread

// A 16-byte vector of T, unpacked to and packed from floats.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  using V = float4;
  __device__ __forceinline__ static void unpack(const float4& v, float (&f)[4]) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ __forceinline__ static float4 pack(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using V = uint4;
  __device__ __forceinline__ static void unpack(const uint4& v, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[8]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

// Sum over the lanes of a warp's first WIDTH lanes (a power of two): an xor
// butterfly, every lane ends with the same bits (a + b == b + a).
template <int WIDTH>
__device__ __forceinline__ float butterfly(float s) {
#pragma unroll
  for (int off = WIDTH / 2; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// The block's sum of every thread's s: a butterfly in each warp, then one
// over the warps' sums in warp 0. The result is valid in warp 0.
__device__ __forceinline__ float block_sum(float s, float* warp_sums) {
  s = butterfly<32>(s);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x < 32) {
    t = threadIdx.x < WARPS ? warp_sums[threadIdx.x] : 0.0f;
    t = butterfly<WARPS>(t);
  }
  return t;
}

__device__ __forceinline__ float combine(const float (&a)[ACC]) {
  return __fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3]));
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
sq_norm_kernel(const T* __restrict__ x, float* __restrict__ partials,
               unsigned* __restrict__ counter, float* __restrict__ out, long long n) {
  using V = Vec<T>;
  constexpr int LOADS = CHUNK / (BLOCK * V::N);  // vectors per thread: 64 fp32, 32 bf16
  constexpr int BATCH = 8;                       // of them in flight at once
  static_assert(LOADS % BATCH == 0, "a chunk is whole batches");
  __shared__ float warp_sums[WARPS];
  __shared__ bool last;

  const long long base = (long long)blockIdx.x * CHUNK;
  const bool fast = base + CHUNK <= n && ((uintptr_t)x & 15) == 0;
  float acc[ACC] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j0 = 0; j0 < LOADS; j0 += BATCH) {
    // past n only zeros would be added (exact no-ops): the block skips them
    if (!fast && base + (long long)j0 * BLOCK * V::N >= n) break;
    float v[BATCH][V::N];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const long long e = base + (long long)((j0 + b) * BLOCK + threadIdx.x) * V::N;
      if (fast) {
        V::unpack(*reinterpret_cast<const typename V::V*>(x + e), v[b]);
      } else {
#pragma unroll
        for (int k = 0; k < V::N; ++k) v[b][k] = e + k < n ? repro::to_f(x[e + k]) : 0.0f;
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
#pragma unroll
      for (int k = 0; k < V::N; ++k)
        acc[k % ACC] = __fadd_rn(acc[k % ACC], __fmul_rn(v[b][k], v[b][k]));
  }
  const float partial = block_sum(combine(acc), warp_sums);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = partial;
    __threadfence();  // the partial is visible before the ticket is
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // The last block: every other block fenced its partial before its ticket.
  const int m = gridDim.x;
  float a[ACC] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int r0 = 0; r0 * BLOCK < m; r0 += PARTS) {
    float p[PARTS];
#pragma unroll
    for (int b = 0; b < PARTS; ++b) {
      const int i = (r0 + b) * BLOCK + threadIdx.x;
      p[b] = i < m ? __ldcg(partials + i) : 0.0f;  // from L2, past this SM's L1
    }
#pragma unroll
    for (int b = 0; b < PARTS; ++b) a[b % ACC] = __fadd_rn(a[b % ACC], p[b]);
  }
  const float total = block_sum(combine(a), warp_sums);
  if (threadIdx.x == 0) {
    out[0] = total;
    *counter = 0u;  // clean for the next call on this stream
  }
}

template <typename T, bool NOISE>
__global__ void __launch_bounds__(CLIP_BLOCK)
clip_noise_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ noise, float sigma, T* __restrict__ out,
                  long long n, long long nvec) {
  using V = Vec<T>;
  constexpr int NV = V::N / 4;  // float4s of noise per vector of x
  const float s = __ldg(scale);

  // the 16-byte body: vectors [0, nvec)
  const typename V::V* xv = reinterpret_cast<const typename V::V*>(x);
  const float4* nz = reinterpret_cast<const float4*>(noise);
  typename V::V* ov = reinterpret_cast<typename V::V*>(out);
  const long long tile = (long long)CLIP_BLOCK * UNROLL;
  for (long long v0 = (long long)blockIdx.x * tile + threadIdx.x; v0 < nvec;
       v0 += (long long)gridDim.x * tile) {
    typename V::V xr[UNROLL];
    float4 nr[UNROLL][NV];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + (long long)u * CLIP_BLOCK;
      if (v < nvec) {
        xr[u] = xv[v];
        if (NOISE) {
#pragma unroll
          for (int h = 0; h < NV; ++h) nr[u][h] = nz[v * NV + h];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + (long long)u * CLIP_BLOCK;
      if (v < nvec) {
        float f[V::N];
        V::unpack(xr[u], f);
#pragma unroll
        for (int k = 0; k < V::N; ++k) f[k] = __fmul_rn(f[k], s);
        if (NOISE) {
#pragma unroll
          for (int h = 0; h < NV; ++h) {
            f[4 * h] = __fadd_rn(f[4 * h], __fmul_rn(sigma, nr[u][h].x));
            f[4 * h + 1] = __fadd_rn(f[4 * h + 1], __fmul_rn(sigma, nr[u][h].y));
            f[4 * h + 2] = __fadd_rn(f[4 * h + 2], __fmul_rn(sigma, nr[u][h].z));
            f[4 * h + 3] = __fadd_rn(f[4 * h + 3], __fmul_rn(sigma, nr[u][h].w));
          }
        }
        ov[v] = V::pack(f);
      }
    }
  }

  // the scalar tail [nvec * N, n)
  for (long long e = nvec * V::N + (long long)blockIdx.x * CLIP_BLOCK + threadIdx.x; e < n;
       e += (long long)gridDim.x * CLIP_BLOCK) {
    float y = __fmul_rn(repro::to_f(x[e]), s);
    if (NOISE) y = __fadd_rn(y, __fmul_rn(sigma, noise[e]));
    out[e] = repro::from_f<T>(y);
  }
}

template <typename T>
int sq_norm_launch(const void* x, void* partials, void* counter, void* out, long long n,
                   cudaStream_t st) {
  const long long m = n > 0 ? (n + CHUNK - 1) / CHUNK : 1;
  sq_norm_kernel<T><<<(unsigned)m, BLOCK, 0, st>>>((const T*)x, (float*)partials,
                                                   (unsigned*)counter, (float*)out, n);
  return (int)cudaGetLastError();
}

template <typename T, bool NOISE>
int clip_noise_launch(const void* x, const void* scale, const void* noise, float sigma,
                      void* out, long long n, cudaStream_t st) {
  constexpr int N = Vec<T>::N;
  const bool aligned = (((uintptr_t)x | (uintptr_t)out | (uintptr_t)noise) & 15) == 0;
  const long long nvec = aligned ? n / N : 0;
  const long long tile = (long long)CLIP_BLOCK * UNROLL;
  long long blocks = (nvec + tile - 1) / tile;
  const long long scalar_blocks = (n - nvec * N + CLIP_BLOCK - 1) / CLIP_BLOCK;
  if (scalar_blocks > blocks) blocks = scalar_blocks;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;  // the loops stride over the rest
  clip_noise_kernel<T, NOISE><<<(unsigned)blocks, CLIP_BLOCK, 0, st>>>(
      (const T*)x, (const float*)scale, (const float*)noise, sigma, (T*)out, n, nvec);
  return (int)cudaGetLastError();
}

template <typename T>
int clip_noise_dispatch(const void* x, const void* scale, const void* noise, float sigma,
                        void* out, long long n, cudaStream_t st) {
  if (n == 0) return (int)cudaGetLastError();
  if (noise) return clip_noise_launch<T, true>(x, scale, noise, sigma, out, n, st);
  return clip_noise_launch<T, false>(x, scale, nullptr, 0.0f, out, n, st);
}

}  // namespace

// x: n elements (dtype 0 = float32, 1 = bfloat16); partials: max(1,
// ceil(n / 65536)) floats of scratch; counter: one unsigned int that is 0
// and that no call running at the same time uses (one per stream); out:
// one float. One launch. Returns cudaGetLastError() after it (0 on
// success), -1 for an unsupported dtype or n.
extern "C" int sq_norm(const void* x, void* partials, void* counter, void* out, long long n,
                       int dtype, void* stream) {
  if ((n + CHUNK - 1) / CHUNK > 0x7fffffffLL) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return sq_norm_launch<float>(x, partials, counter, out, n, st);
  if (dtype == 1) return sq_norm_launch<__nv_bfloat16>(x, partials, counter, out, n, st);
  return -1;
}

// x, out: n elements of one dtype (0 = float32, 1 = bfloat16); scale: one
// float in device memory; noise: n floats, or null (then sigma is unused).
extern "C" int clip_noise(const void* x, const void* scale, const void* noise, void* out,
                          long long n, float sigma, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return clip_noise_dispatch<float>(x, scale, noise, sigma, out, n, st);
  if (dtype == 1) return clip_noise_dispatch<__nv_bfloat16>(x, scale, noise, sigma, out, n, st);
  return -1;
}
