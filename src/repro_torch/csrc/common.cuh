// Shared device code of the port's attention kernels: element conversion
// (every kernel) and, for the fp32 SIMT prefill bodies (flash prefill,
// suffix prefill), tile loads from device memory into shared memory, the
// masked score tile, and the ONE online-softmax tile update they run. The
// decode kernels (decode.cuh) keep their softmax in registers and dequantize
// an int8 pool at use exactly as load_pool_rows does here.
//
// Every kernel keeps the same state per query row as the TPU kernels did in
// VMEM scratch: the running max m, the running denominator l and the output
// accumulator acc, all fp32, with masked scores set to NEG = -2**30 (a large
// finite negative, so a fully masked tile never produces NaN; a tile that
// was wholly masked is annihilated by alpha = exp(NEG - m) == 0 at the
// first tile that holds a live key).
//
// Shared-memory layout of one block (floats):
//   q   [rows][HD]        query rows, converted to fp32 once
//   k   [cols][HD + 1]    key tile; the +1 pad keeps the score loop (threads
//                         on consecutive keys) free of bank conflicts
//   v   [cols][HD]        value tile (the PV loop reads it along HD)
//   s   [rows][cols + 1]  scores, then probabilities (pad: the per-row loops)
//   acc [rows][HD]        output accumulator
//   m, l, alpha [rows]
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace repro {

constexpr float NEG = -1073741824.0f;  // -2**30, as in the TPU kernels

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Tile {
  float* q;
  float* k;
  float* v;
  float* s;
  float* acc;
  float* m;
  float* l;
  float* alpha;
  int ld_s;  // row stride of s (max cols + 1)
};

template <int HD>
__host__ __device__ __forceinline__ size_t tile_floats(int rows, int cols) {
  return (size_t)rows * HD + (size_t)cols * (HD + 1) + (size_t)cols * HD +
         (size_t)rows * (cols + 1) + (size_t)rows * HD + 3 * (size_t)rows;
}

template <int HD>
__device__ __forceinline__ Tile carve(float* smem, int rows, int cols) {
  Tile t;
  t.q = smem;
  t.k = t.q + (size_t)rows * HD;
  t.v = t.k + (size_t)cols * (HD + 1);
  t.s = t.v + (size_t)cols * HD;
  t.acc = t.s + (size_t)rows * (cols + 1);
  t.m = t.acc + (size_t)rows * HD;
  t.l = t.m + rows;
  t.alpha = t.l + rows;
  t.ld_s = cols + 1;
  return t;
}

// Load `nrows` rows of HD elements into dst (row stride ld floats) with
// 16-byte vector loads. row_ptr(r) gives the row's address in device memory,
// or nullptr for a row that is not live (filled with zeros, never read from
// device memory).
template <typename T, int HD, typename RowPtr>
__device__ __forceinline__ void load_rows(const RowPtr& row_ptr, int nrows, float* dst,
                                          int ld) {
  constexpr int E = 16 / sizeof(T);
  constexpr int V = HD / E;
  for (int u = threadIdx.x; u < nrows * V; u += blockDim.x) {
    const int r = u / V;
    const int part = u - r * V;
    float* d = dst + (size_t)r * ld + part * E;
    const T* src = row_ptr(r);
    if (src == nullptr) {
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = 0.0f;
      continue;
    }
    const int4 raw = *reinterpret_cast<const int4*>(src + part * E);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) d[e] = to_f(vals[e]);
  }
}

// The addressing policy of the pool loader: it maps tile column c to a
// slot index of the flattened (slots, Hkv, hd) K/V tensor, or -1 for a
// column that is not read (filled with zeros).
//
// PageSlots: logical token slot c of the current chunk of a row's pages
// [j0, j0 + ...), read through the row's page table: the pool slot (phys *
// page + offset), or -1 for a page at or past `pages` (the row's live pages;
// never read, and its table entry never dereferenced).
struct PageSlots {
  const int* table_row;
  int j0, pages, page;
  __device__ long long operator()(int c) const {
    const int j = j0 + c / page;
    if (j >= pages) return -1;
    return (long long)table_row[j] * page + (c - (c / page) * page);
  }
};

template <typename TP, int HD, typename Slots>
struct PoolRow {  // kv head h's row of pool slot slots(c), or nullptr
  const TP* pool;
  Slots slots;
  int Hkv, h;
  __device__ const TP* operator()(int c) const {
    const long long s = slots(c);
    return s < 0 ? nullptr : pool + ((size_t)s * Hkv + h) * HD;
  }
};

// Load kv head h's rows of `nrows` slots (pool pages or ring rows, by the
// addressing policy) into dst (row stride ld floats).
// An fp pool (TP == T) is read as it is. An int8 pool (TP == int8_t) has one
// f32 scale per (slot, kv head) in `scale`, and each element becomes
// (float)q * s rounded to the query type T, then widened: the value set of
// the fp pool dequantized to T (the reference's kv_dequant(q, s, T)), so the
// int8 kernels compute bitwise what the fp kernels compute over that pool.
// A 16-byte vector holds 16 int8 elements; hd in {32, 64, 128, 160} keeps every
// row (h * hd bytes into its slot) 16-byte aligned.
template <typename T, typename TP, int HD, typename Slots>
__device__ __forceinline__ void load_pool_rows(const TP* pool, const float* scale,
                                               const Slots& slots, int Hkv, int h,
                                               int nrows, float* dst, int ld) {
  if constexpr (std::is_same<TP, int8_t>::value) {
    constexpr int E = 16;
    constexpr int V = HD / E;
    for (int u = threadIdx.x; u < nrows * V; u += blockDim.x) {
      const int r = u / V;
      const int part = u - r * V;
      float* d = dst + (size_t)r * ld + part * E;
      const long long s = slots(r);
      if (s < 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) d[e] = 0.0f;
        continue;
      }
      const size_t row = (size_t)s * Hkv + h;
      const float sc = scale[row];
      const int4 raw = *reinterpret_cast<const int4*>(pool + row * HD + part * E);
      const int8_t* vals = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = to_f(from_f<T>(__fmul_rn((float)vals[e], sc)));
    }
  } else {
    static_assert(std::is_same<TP, T>::value, "an fp pool has the query's type");
    load_rows<TP, HD>(PoolRow<TP, HD, Slots>{pool, slots, Hkv, h}, nrows, dst, ld);
  }
}

template <int HD>
__device__ __forceinline__ void init_state(const Tile& t, int rows) {
  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) t.acc[i] = 0.0f;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    t.m[r] = NEG;
    t.l[r] = 0.0f;
  }
}

// s[r][c] = (q[r] . k[c]) * scale where live(r, c), else NEG.
template <int HD, typename Live>
__device__ __forceinline__ void scores(const Tile& t, int rows, int cols, float scale,
                                       const Live& live) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols;
    const int c = i - r * cols;
    const float* qr = t.q + (size_t)r * HD;
    const float* kc = t.k + (size_t)c * (HD + 1);
    float dot = 0.0f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) dot = __fmaf_rn(qr[d], kc[d], dot);
    t.s[(size_t)r * t.ld_s + c] = live(r, c) ? dot * scale : NEG;
  }
}

// The online-softmax tile update shared by every attention kernel:
//   m' = max(m, max_c s);  p = exp(s - m');  alpha = exp(m - m')
//   l' = l * alpha + sum_c p;  acc' = acc * alpha + p @ v
// Every product that may meet a sum is an explicit __fmaf_rn / __fmul_rn
// (here and in the score tile), so no instantiation leaves the choice of
// what to contract into an FMA to the compiler: a kernel whose tile width is
// a compile-time constant and one whose width is a runtime value round
// alike.
// Expects the score tile and the value tile in shared memory and a barrier
// after both were written; ends with a barrier, so the caller may overwrite
// the k/v/s tiles next.
template <int HD>
__device__ __forceinline__ void online_softmax_update(const Tile& t, int rows, int cols) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float* sr = t.s + (size_t)r * t.ld_s;
    float mx = t.m[r];
    for (int c = 0; c < cols; ++c) mx = fmaxf(mx, sr[c]);
    t.alpha[r] = expf(t.m[r] - mx);
    t.m[r] = mx;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols;
    const int c = i - r * cols;
    float* p = t.s + (size_t)r * t.ld_s + c;
    *p = expf(*p - t.m[r]);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float* sr = t.s + (size_t)r * t.ld_s;
    float sum = 0.0f;
    for (int c = 0; c < cols; ++c) sum += sr[c];
    t.l[r] = __fmaf_rn(t.l[r], t.alpha[r], sum);
  }
  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
    const int r = i / HD;
    const int d = i - r * HD;
    const float* sr = t.s + (size_t)r * t.ld_s;
    float a = __fmul_rn(t.acc[i], t.alpha[r]);
    for (int c = 0; c < cols; ++c) a = __fmaf_rn(sr[c], t.v[(size_t)c * HD + d], a);
    t.acc[i] = a;
  }
  __syncthreads();
}

// out row r = acc[r] / max(l[r], 1e-30), for rows with out_ptr(r) != nullptr.
template <typename T, int HD, typename OutPtr>
__device__ __forceinline__ void write_rows(const Tile& t, int rows, const OutPtr& out_ptr) {
  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
    const int r = i / HD;
    const int d = i - r * HD;
    T* dst = out_ptr(r);
    if (dst == nullptr) continue;
    dst[d] = from_f<T>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro
