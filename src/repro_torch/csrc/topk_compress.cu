// Block-local magnitude top-k sparsification of a flat fp32 tensor.
//
// Replaces the TPU kernel src/repro/kernels/topk_compress.py::topk_sparsify
// (body _topk_kernel): in each 256-element block, t is the k-th largest
// magnitude counted with multiplicity, and every element with |x| >= t is
// kept (ties at t are all kept); the others become 0. The last block may be
// ragged: its missing elements count as zeros of magnitude 0, as the
// reference's zero padding makes them, and are neither read nor written.
//
// The threshold is found as the TPU kernel finds it: rounds of block max
// over the magnitudes not yet counted, each round adding the number of
// elements equal to that max, until k are counted. So t is exact and the
// output is bitwise equal to the plain version (torch.topk's k-th value).
// A round is two shared-memory tree reductions; the loop ends as soon as k
// elements are counted, so at k = 3 on continuous data it runs 3 rounds,
// and never more than k.
//
// What bounds it on an H100: bytes (4 read + 4 written per element) for
// small k; the reductions cost 2 * 8 barrier steps per round, so a large k
// makes it latency bound inside the block. One 256-thread block per
// 256-element block, one element per thread.
#include "reduce.cuh"

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
topk_sparsify_kernel(const float* __restrict__ x, float* __restrict__ out, long long n, int k) {
  __shared__ float fbuf[BLOCK];
  __shared__ int ibuf[BLOCK];
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < n;
  const float v = live ? x[i] : 0.0f;
  const float mag = fabsf(v);
  bool active = true;  // not yet counted
  float thr = 0.0f;
  int cnt = 0;         // elements counted so far: the same in every thread
  for (int r = 0; r < k && cnt < k; ++r) {
    const float cur = repro::block_reduce(fbuf, active ? mag : -1.0f, repro::MaxOp());
    cnt += repro::block_reduce(ibuf, mag == cur ? 1 : 0, repro::SumOp<int>());
    thr = cur;
    active = active && mag < cur;
  }
  if (live) out[i] = mag >= thr ? v : 0.0f;
}

}  // namespace

// x, out: n contiguous float32 elements; 1 <= k <= 256. Returns
// cudaGetLastError() after the launch (0 on success), -1 for a bad k.
extern "C" int topk_sparsify(const void* x, void* out, long long n, int k, void* stream) {
  if (k < 1 || k > BLOCK) return -1;
  if (n > 0) {
    const long long blocks = (n + BLOCK - 1) / BLOCK;
    topk_sparsify_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, n, k);
  }
  return (int)cudaGetLastError();
}
