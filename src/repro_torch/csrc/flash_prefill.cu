// GQA flash attention: cold prefill (causal) and whisper's encoder and
// cross-attention (non-causal).
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py::flash_prefill
// (body _flash_kernel): q (B, S, Hkv, G, hd) against k/v (B, T, Hkv, hd),
// fp32 online softmax, in both of its modes: causal with an optional
// sliding window, or non-causal (causal = 0, window 0) over all T keys for
// any S (S = T = 1500 at whisper's encoder, S = 64 or 1 queries against
// its 1500 frames in cross-attention). Non-causal, a block walks every key
// tile; only the tile that crosses T pays for the element mask (kp < T),
// so the zero rows past T (the TMA box's fill, the SIMT loads' zeros) never
// reach the running max or sum.
//
// Two bodies, chosen by the element type (not a fallback: each type has one):
//
// bfloat16, the serving paths' type: the tensor-core body of prefill_tc.cuh
// (wgmma for Q.K^T and P.V, TMA tiles through a 2-stage mbarrier ring
// filled by a producer warpgroup). A block owns one (row, kv head) and 128
// query rows (BQ = 128 / G positions times the G heads) in two consumer
// warpgroups: the cold rounds' buckets (512 and 8192 tokens at the main
// paths) fill both, each K/V tile is read once for 128 rows, and the two
// warpgroups take turns on the tensor cores, one's softmax under the
// other's MMAs. Q has a 5-D tensor map (hd, G, Hkv, S, B), K and V 4-D maps
// (hd, Hkv, T, B) with 128-key boxes (64-key boxes at hd 256).
// What bounds it on an H100: bytes at a short bucket (8 x 512, hd 64, G 1:
// 67.1 MB, 0.020 ms at 3.35 TB/s against 8.6 GFLOP, 0.0087 ms at 989
// TFLOP/s), operations at a long one (the ring path's cold round, B 4, S = T
// = 8192, window 4096: 8.25e11 FLOP over the live pairs, 0.834 ms). The
// design keeps the work to the live pairs: the tile loop stops at the
// diagonal, starts at the window's edge, never loads a tile above the
// diagonal or wholly outside the window, and only tiles that cross the
// diagonal, the window's edge or the end of T pay for an element mask.
//
// float32, the reference-parity type (the golden traces reproduce the JAX
// engine's fp32 tokens exactly; wgmma on fp32 would be TF32): the SIMT body
// of common.cuh, fp32 FMAs from shared memory. One block owns BQ query
// positions times all G query heads of one kv head (rows = BQ*G <= 64), K/V
// stream through shared memory in tiles of 64 keys with the same skips (rows
// = BQ*G <= 32 at hd 256, the shared memory's limit).
// The probability tensor never touches device memory in either body.
#include "common.cuh"
#include "prefill_tc.cuh"

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
  int G, q_lo, k_lo, T_len, causal, window;
  __device__ bool operator()(int r, int c) const {
    const int kpos = k_lo + c;
    if (kpos >= T_len) return false;
    if (!causal) return true;
    const int qpos = q_lo + r / G;
    if (kpos > qpos) return false;
    return window == 0 || qpos - kpos < window;
  }
};

template <typename T, int HD>
__global__ void flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                     const T* __restrict__ v, T* __restrict__ out, int S,
                                     int T_len, int Hkv, int G, int BQ, int causal,
                                     int window, float scale) {
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
  // causal: stop at the diagonal, start at the window's edge
  const int j_end = causal ? min(n_k, q_hi / BK + 1) : n_k;
  const int j_start = causal && window > 0 ? max(0, q_lo - (window - 1)) / BK : 0;
  for (int j = j_start; j < j_end; ++j) {
    const int k_lo = j * BK;
    repro::load_rows<T, HD>(KVRow<T, HD>{k, T_len, Hkv, b, h, k_lo}, BK, t.k, HD + 1);
    repro::load_rows<T, HD>(KVRow<T, HD>{v, T_len, Hkv, b, h, k_lo}, BK, t.v, HD);
    __syncthreads();
    repro::scores<HD>(t, rows, BK, scale, CausalLive{G, q_lo, k_lo, T_len, causal, window});
    __syncthreads();
    repro::online_softmax_update<HD>(t, rows, BK);
  }
  repro::write_rows<T, HD>(t, rows, QORow<T, HD>{out, S, Hkv, G, b, h, q_lo});
}

// Query rows a SIMT block holds: 64, or 32 at hd 256 (64 rows of 256 fp32
// and their tiles would be 270 KB of shared memory).
template <int HD>
constexpr int simt_rows() {
  return HD == 256 ? 32 : 64;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int T_len,
           int Hkv, int G, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int ROWS = simt_rows<HD>();
  const int BQ = G >= ROWS ? 1 : ROWS / G;
  const size_t smem = repro::tile_floats<HD>(BQ * G, BK) * sizeof(float);
  if (smem > 232448) return -1;   // G too large for a block at this head dim
  cudaError_t err = repro::allow_smem(flash_prefill_kernel<T, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hkv, (S + BQ - 1) / BQ);
  flash_prefill_kernel<T, HD><<<grid, 256, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, T_len, Hkv, G, BQ, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int by_hd(int hd, const void* q, const void* k, const void* v, void* out, int B, int S,
          int T_len, int Hkv, int G, int causal, int window, float scale,
          cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, T_len, Hkv, G, causal, window, scale,
                             stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, T_len, Hkv, G, causal, window, scale,
                             stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, T_len, Hkv, G, causal, window, scale,
                             stream);
    case 160:
      return launch<T, 160>(q, k, v, out, B, S, T_len, Hkv, G, causal, window, scale,
                             stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, S, T_len, Hkv, G, causal, window, scale,
                             stream);
  }
  return -1;
}

// ----------------------------------------------------- bf16: tensor cores
constexpr int TW = 2;   // consumer warpgroups: 128 query rows per block

template <int HD>
struct FlashPlan {
  static constexpr int R = 64 * TW;
  const CUtensorMap *qmap, *kmap, *vmap;
  __nv_bfloat16* out;
  int b, h, S, T, Hkv, G, BQ, causal, window, q_lo, q_hi, j0, n;

  __device__ int count() const { return n; }
  __device__ bool manual(int) const { return false; }
  static constexpr int KB = repro::tc::key_tile<HD>();
  __device__ int k_lo(int i) const { return (j0 + i) * KB; }
  // non-causal: only the tile that crosses T is masked, and only kp < T
  __device__ bool masked(int, int k) const {
    return k + KB > T || (causal && (k + KB - 1 > q_lo || (window > 0 && q_hi - k >= window)));
  }
  __device__ bool live(int, int k, int qp, int c) const {
    const int kp = k + c;
    return kp < T && (!causal || (kp <= qp && (window == 0 || qp - kp < window)));
  }
  __device__ int qpos(int r) const { return q_lo + r / G; }
  __device__ void load_q(uint32_t dst, uint32_t bar) const {
    repro::tc::load_q_tma<HD, R>(qmap, dst, bar, G, BQ, h, q_lo, b);
  }
  __device__ void load_tile(int i, uint32_t k_dst, uint32_t v_dst, unsigned char*,
                            unsigned char*, uint32_t bar, int) const {
    repro::tc::load_kv_tma<HD>(kmap, vmap, k_dst, v_dst, bar, h, k_lo(i), b);
  }
  __device__ __nv_bfloat16* out_row(int r) const {
    const int s = q_lo + r / G;
    if (r >= BQ * G || s >= S) return nullptr;
    return out + ((((size_t)b * S + s) * Hkv + h) * G + (r - (r / G) * G)) * HD;
  }
};

template <int HD>
__global__ void __launch_bounds__(128 * (TW + 1), repro::tc::Regs<TW>::BLOCKS)
    flash_prefill_tc(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                     int S, int T_len, int Hkv, int G, int BQ, int causal, int window,
                     float scale_log2) {
  FlashPlan<HD> p;
  p.qmap = &qmap;
  p.kmap = &kmap;
  p.vmap = &vmap;
  p.out = out;
  p.b = blockIdx.x / Hkv;
  p.h = blockIdx.x - p.b * Hkv;
  p.S = S;
  p.T = T_len;
  p.Hkv = Hkv;
  p.G = G;
  p.BQ = BQ;
  p.causal = causal;
  p.window = window;
  p.q_lo = blockIdx.y * BQ;
  p.q_hi = min(p.q_lo + BQ, S) - 1;
  constexpr int KB = repro::tc::key_tile<HD>();
  const int n_k = (T_len + KB - 1) / KB;
  const int j_end = causal ? min(n_k, p.q_hi / KB + 1) : n_k;      // stop at the diagonal
  p.j0 = causal && window > 0 ? max(0, p.q_lo - (window - 1)) / KB : 0;   // the window's edge
  p.n = max(0, j_end - p.j0);
  repro::tc::run_block<HD, TW>(p, scale_log2);
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B, int S, int T_len,
              int Hkv, int G, int causal, int window, float scale, cudaStream_t stream) {
  using L = repro::tc::Layout<HD>;
  const int BQ = 64 * TW / G;
  CUtensorMap qm, km, vm;
  const uint64_t qd[5] = {HD, (uint64_t)G, (uint64_t)Hkv, (uint64_t)S, (uint64_t)B};
  const uint32_t qb[5] = {L::AW, (uint32_t)G, 1, (uint32_t)BQ, 1};
  const uint64_t kd[4] = {HD, (uint64_t)Hkv, (uint64_t)T_len, (uint64_t)B};
  const uint32_t kb[4] = {L::AW, 1, (uint32_t)repro::tc::key_tile<HD>(), 1};
  int err = repro::tc::make_map<HD>(&qm, q, 5, qd, qb);
  if (err == 0) err = repro::tc::make_map<HD>(&km, k, 4, kd, kb);
  if (err == 0) err = repro::tc::make_map<HD>(&vm, v, 4, kd, kb);
  if (err != 0) return err;
  const size_t smem = repro::tc::smem_bytes<HD, TW>();
  // once per instantiation: its attributes do not change while the process runs
  static const int ready = repro::tc::prepare<TW>(flash_prefill_tc<HD>, smem);
  if (ready != 0) return ready;
  const dim3 grid(B * Hkv, (S + BQ - 1) / BQ);
  flash_prefill_tc<HD><<<grid, 128 * (TW + 1), smem, stream>>>(
      qm, km, vm, (__nv_bfloat16*)out, S, T_len, Hkv, G, BQ, causal, window,
      scale * repro::tc::LOG2E);
  return (int)cudaGetLastError();
}

int by_hd_tc(int hd, const void* q, const void* k, const void* v, void* out, int B, int S,
             int T_len, int Hkv, int G, int causal, int window, float scale,
             cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_tc<32>(q, k, v, out, B, S, T_len, Hkv, G, causal, window, scale,
                             stream);
    case 64:
      return launch_tc<64>(q, k, v, out, B, S, T_len, Hkv, G, causal, window, scale,
                             stream);
    case 128:
      return launch_tc<128>(q, k, v, out, B, S, T_len, Hkv, G, causal, window, scale,
                             stream);
    case 160:
      return launch_tc<160>(q, k, v, out, B, S, T_len, Hkv, G, causal, window, scale,
                             stream);
    case 256:
      return launch_tc<256>(q, k, v, out, B, S, T_len, Hkv, G, causal, window, scale,
                             stream);
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32 (SIMT body), 1 = bfloat16 (tensor-core body); causal:
// 1 = causal with the optional window, 0 = every key (window 0). Returns
// cudaGetLastError() after the launch (0 on success), -1 for an unsupported
// head dim / dtype, -2 if cuTensorMapEncodeTiled refused a tensor map, -3 if the
// tensor-core kernel was built with too few registers for its warp roles.
extern "C" int flash_prefill(const void* q, const void* k, const void* v, void* out, int dtype,
                             int B, int S, int T_len, int Hkv, int G, int hd, int causal,
                             int window, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!causal && window) return -1;
  if (dtype == 0)
    return by_hd<float>(hd, q, k, v, out, B, S, T_len, Hkv, G, causal, window, scale, s);
  if (dtype == 1)
    return by_hd_tc(hd, q, k, v, out, B, S, T_len, Hkv, G, causal, window, scale, s);
  return -1;
}
