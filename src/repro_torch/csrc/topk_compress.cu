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
// Every round counts at least one element, so there are at most k rounds,
// and fewer where the magnitudes at the top tie (a block of the sync's
// bf16-grid updates, or one that is all zeros).
//
// What bounds it on an H100: bytes (4 read + 4 written per element) at the
// path's k = 3. One warp per block, its 256 elements in registers
// (channel_block.cuh): 16-byte loads and stores, and a round is one
// __reduce_max_sync over the magnitudes' bits and one __reduce_add_sync of
// the tie count, with no shared memory and no barrier.
#include "channel_block.cuh"

#include <cstdint>

namespace {

using namespace repro::channel;

__global__ void __launch_bounds__(WARPS * 32)
topk_sparsify_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                     long long blocks, int k, bool aligned) {
  const long long b = warp_block();
  if (b >= blocks) return;  // the whole warp leaves together
  const long long base = b * BLOCK;
  const bool vec = vector_block(base, n, aligned);
  float v[PER_LANE];
  unsigned m[PER_LANE];
  load(x, base, n, vec, v);
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) m[e] = mag_bits(v[e]);
  unsigned lim = 0xffffffffu;  // the magnitudes below lim are not yet counted
  unsigned t = 0;
  int cnt = 0;                 // elements counted so far: the same in every lane
  while (cnt < k) {
    unsigned mx = 0;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) mx = m[e] < lim && m[e] > mx ? m[e] : mx;
    t = __reduce_max_sync(FULL, mx);
    int c = 0;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) c += m[e] == t;
    cnt += (int)__reduce_add_sync(FULL, (unsigned)c);
    lim = t;
  }
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) v[e] = m[e] >= t ? v[e] : 0.0f;
  store(out, base, n, vec, v);
}

}  // namespace

// x, out: n contiguous float32 elements; 1 <= k <= 256. Returns
// cudaGetLastError() after the launch (0 on success), -1 for a bad k.
extern "C" int topk_sparsify(const void* x, void* out, long long n, int k, void* stream) {
  if (k < 1 || k > BLOCK) return -1;
  if (n > 0) {
    const long long blocks = (n + BLOCK - 1) / BLOCK;
    const bool aligned = (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
    topk_sparsify_kernel<<<(unsigned)((blocks + WARPS - 1) / WARPS), WARPS * 32, 0,
                           (cudaStream_t)stream>>>((const float*)x, (float*)out, n, blocks, k,
                                                   aligned);
  }
  return (int)cudaGetLastError();
}
