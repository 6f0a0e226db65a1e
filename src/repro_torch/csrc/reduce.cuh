// Block-wide tree reductions over a shared-memory array, shared by the
// channel kernels (top-k, int8, DP norm). Every thread of the block writes
// its value to buf[threadIdx.x], calls the reduction, and gets the result of
// the whole block. Only __syncthreads and shared memory are used (no warp
// shuffles); the order of the reduction is fixed, so a result never depends
// on scheduling. blockDim.x must be a power of two equal to the size of buf.
#pragma once

#include <cuda_runtime.h>

namespace repro {

struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

template <typename V>
struct SumOp {
  __device__ __forceinline__ V operator()(V a, V b) const { return a + b; }
};

// Returns op over buf[0 .. blockDim.x); ends with a barrier, so the caller
// may overwrite buf right after.
template <typename V, typename Op>
__device__ __forceinline__ V block_reduce(V* buf, V value, Op op) {
  const int t = threadIdx.x;
  buf[t] = value;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) buf[t] = op(buf[t], buf[t + s]);
    __syncthreads();
  }
  const V out = buf[0];
  __syncthreads();
  return out;
}

}  // namespace repro
