// Causal GQA flash attention for cold prefill.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py::flash_prefill
// (body _flash_kernel): q (B, S, Hkv, G, hd) against k/v (B, T, Hkv, hd),
// causal with an optional sliding window, fp32 online softmax.
//
// What bounds it on an H100: operations at long prompts, bytes at short
// ones. Causal attention does ~2*S*T*hd*H flops over (S + 2T)*Hkv*hd input
// elements, so a 512-token bucket is well above the tensor cores' ~295
// flops/byte line; this first version computes in fp32 FMAs from shared
// memory, not on the tensor cores, and is therefore far from that bound
// (wgmma and TMA are the work of a later change). What the design does keep
// from the TPU kernel is what saves work: one block owns BQ query positions
// times all G query heads of one kv head (rows = BQ*G <= 64, so a K/V tile
// is read once for the G heads), K/V stream through shared memory in tiles
// of BK = 64 keys, tiles above the diagonal are never loaded (the loop stops
// at k_lo <= q_hi) and, with a window, the loop starts at the window's edge.
// The probability tensor never touches device memory.
#include "common.cuh"

namespace {

using repro::Tile;

constexpr int BK = 64;

template <typename T, int HD>
struct QORow {  // query/output row r = (position q_lo + r / G, head r % G)
  T* base;
  int S, Hkv, G, b, h, q_lo;
  __device__ T* operator()(int r) const {
    const int s = q_lo + r / G;
    if (s >= S) return nullptr;
    return base + ((((size_t)b * S + s) * Hkv + h) * G + (r - (r / G) * G)) * HD;
  }
};

template <typename T, int HD>
struct KVRow {
  const T* base;
  int T_len, Hkv, b, h, k_lo;
  __device__ const T* operator()(int c) const {
    const int t = k_lo + c;
    if (t >= T_len) return nullptr;
    return base + (((size_t)b * T_len + t) * Hkv + h) * HD;
  }
};

struct CausalLive {
  int G, q_lo, k_lo, T_len, window;
  __device__ bool operator()(int r, int c) const {
    const int qpos = q_lo + r / G;
    const int kpos = k_lo + c;
    if (kpos >= T_len || kpos > qpos) return false;
    return window == 0 || qpos - kpos < window;
  }
};

template <typename T, int HD>
__global__ void flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                     const T* __restrict__ v, T* __restrict__ out, int S,
                                     int T_len, int Hkv, int G, int BQ, int window,
                                     float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int q_lo = blockIdx.y * BQ;
  const int q_hi = min(q_lo + BQ, S) - 1;
  const int rows = BQ * G;
  const Tile t = repro::carve<HD>(smem, rows, BK);

  repro::load_rows<T, HD>(QORow<const T, HD>{q, S, Hkv, G, b, h, q_lo}, rows, t.q, HD);
  repro::init_state<HD>(t, rows);
  __syncthreads();

  const int n_k = (T_len + BK - 1) / BK;
  const int j_end = min(n_k, q_hi / BK + 1);  // stop at the diagonal
  const int j_start = window > 0 ? max(0, q_lo - (window - 1)) / BK : 0;
  for (int j = j_start; j < j_end; ++j) {
    const int k_lo = j * BK;
    repro::load_rows<T, HD>(KVRow<T, HD>{k, T_len, Hkv, b, h, k_lo}, BK, t.k, HD + 1);
    repro::load_rows<T, HD>(KVRow<T, HD>{v, T_len, Hkv, b, h, k_lo}, BK, t.v, HD);
    __syncthreads();
    repro::scores<HD>(t, rows, BK, scale, CausalLive{G, q_lo, k_lo, T_len, window});
    __syncthreads();
    repro::online_softmax_update<HD>(t, rows, BK);
  }
  repro::write_rows<T, HD>(t, rows, QORow<T, HD>{out, S, Hkv, G, b, h, q_lo});
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int T_len,
           int Hkv, int G, int window, float scale, cudaStream_t stream) {
  const int BQ = G >= 64 ? 1 : 64 / G;
  const size_t smem = repro::tile_floats<HD>(BQ * G, BK) * sizeof(float);
  cudaError_t err = repro::allow_smem(flash_prefill_kernel<T, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hkv, (S + BQ - 1) / BQ);
  flash_prefill_kernel<T, HD><<<grid, 256, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, T_len, Hkv, G, BQ, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int by_hd(int hd, const void* q, const void* k, const void* v, void* out, int B, int S,
          int T_len, int Hkv, int G, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, T_len, Hkv, G, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, T_len, Hkv, G, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, T_len, Hkv, G, window, scale, stream);
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success), or -1 for an unsupported head dim / dtype.
extern "C" int flash_prefill(const void* q, const void* k, const void* v, void* out, int dtype,
                             int B, int S, int T_len, int Hkv, int G, int hd, int window,
                             float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return by_hd<float>(hd, q, k, v, out, B, S, T_len, Hkv, G, window, scale, s);
  if (dtype == 1)
    return by_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, T_len, Hkv, G, window, scale, s);
  return -1;
}
