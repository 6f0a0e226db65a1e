// The DP transmit transform of the federated uplink: the squared L2 norm of
// a tensor, and the fused clip-and-noise x * scale + sigma * noise.
//
// Replaces the TPU kernels src/repro/kernels/dp_clip.py::sq_norm (body
// _sq_norm_kernel) and ::clip_noise (body _clip_noise_kernel). Both take
// the tensor as n flat contiguous elements; no padding is needed.
//
// sq_norm: the TPU kernel carried one accumulator across its sequential
// grid. Hopper blocks run in parallel and in no order, so the sum is taken
// in two deterministic passes instead of with atomics: each block of the
// first pass sums a chunk of 2048 elements (8 per thread, in order, then a
// shared-memory tree) into one partial; one block of the second pass sums
// the partials (strided per thread, then a tree). The order is fixed by n
// alone, so two runs give the same norm and so the same clip scale. Reads
// bf16 or fp32, accumulates in fp32.
//
// clip_noise: y = x * scale + sigma * noise, each product and the sum
// rounded on its own (__fmul_rn / __fadd_rn: nvcc may not contract them into
// an FMA), so the result is bitwise the plain PyTorch expression; the output
// has the input's dtype. scale is read from device memory (a 0-d tensor the
// norm produced), so clipping needs no host synchronisation. With no noise
// pointer (sigma = 0, the clip) no noise is read.
//
// What bounds both on an H100: bytes. sq_norm reads each element once;
// clip_noise reads x (and the fp32 noise) and writes the output once.
#include "common.cuh"
#include "reduce.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int PER_THREAD = 8;
constexpr int CHUNK = BLOCK * PER_THREAD;
constexpr int FINAL = 1024;

template <typename T>
__global__ void __launch_bounds__(BLOCK)
sq_norm_partial_kernel(const T* __restrict__ x, float* __restrict__ partials, long long n) {
  __shared__ float buf[BLOCK];
  const long long base = (long long)blockIdx.x * CHUNK + threadIdx.x;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const long long i = base + (long long)j * BLOCK;
    if (i < n) {
      const float v = repro::to_f(x[i]);
      acc += v * v;
    }
  }
  const float total = repro::block_reduce(buf, acc, repro::SumOp<float>());
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(FINAL)
sq_norm_final_kernel(const float* __restrict__ partials, float* __restrict__ out, int m) {
  __shared__ float buf[FINAL];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < m; i += FINAL) acc += partials[i];
  const float total = repro::block_reduce(buf, acc, repro::SumOp<float>());
  if (threadIdx.x == 0) out[0] = total;
}

template <typename T, bool NOISE>
__global__ void __launch_bounds__(BLOCK)
clip_noise_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ noise, float sigma, T* __restrict__ out,
                  long long n) {
  const float s = *scale;
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long i = (long long)blockIdx.x * BLOCK + threadIdx.x; i < n; i += stride) {
    float y = __fmul_rn(repro::to_f(x[i]), s);
    if (NOISE) y = __fadd_rn(y, __fmul_rn(sigma, noise[i]));
    out[i] = repro::from_f<T>(y);
  }
}

template <typename T>
int sq_norm_launch(const void* x, void* partials, void* out, long long n, cudaStream_t st) {
  const long long m = (n + CHUNK - 1) / CHUNK;
  if (m > 0)
    sq_norm_partial_kernel<T><<<(unsigned)m, BLOCK, 0, st>>>((const T*)x, (float*)partials, n);
  sq_norm_final_kernel<<<1, FINAL, 0, st>>>((const float*)partials, (float*)out, (int)m);
  return (int)cudaGetLastError();
}

template <typename T>
int clip_noise_launch(const void* x, const void* scale, const void* noise, float sigma,
                      void* out, long long n, cudaStream_t st) {
  if (n == 0) return (int)cudaGetLastError();
  long long blocks = (n + BLOCK - 1) / BLOCK;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride: 16 blocks per SM
  if (noise)
    clip_noise_kernel<T, true><<<(unsigned)blocks, BLOCK, 0, st>>>(
        (const T*)x, (const float*)scale, (const float*)noise, sigma, (T*)out, n);
  else
    clip_noise_kernel<T, false><<<(unsigned)blocks, BLOCK, 0, st>>>(
        (const T*)x, (const float*)scale, nullptr, 0.0f, (T*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x: n elements (dtype 0 = float32, 1 = bfloat16); partials: ceil(n / 2048)
// floats of scratch; out: one float. Returns cudaGetLastError() after the
// launches (0 on success), -1 for an unsupported dtype or n.
extern "C" int sq_norm(const void* x, void* partials, void* out, long long n, int dtype,
                       void* stream) {
  if ((n + CHUNK - 1) / CHUNK > 0x7fffffffLL) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return sq_norm_launch<float>(x, partials, out, n, st);
  if (dtype == 1) return sq_norm_launch<__nv_bfloat16>(x, partials, out, n, st);
  return -1;
}

// x, out: n elements of one dtype (0 = float32, 1 = bfloat16); scale: one
// float in device memory; noise: n floats, or null (then sigma is unused).
extern "C" int clip_noise(const void* x, const void* scale, const void* noise, void* out,
                          long long n, float sigma, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return clip_noise_launch<float>(x, scale, noise, sigma, out, n, st);
  if (dtype == 1) return clip_noise_launch<__nv_bfloat16>(x, scale, noise, sigma, out, n, st);
  return -1;
}
