// Tensor-core body of the bf16 prefill kernels (flash prefill, suffix
// prefill over fp or int8 pool pages): Hopper's wgmma on the tensor cores,
// tiles brought in by the Tensor Memory Accelerator (TMA) through a ring of
// shared-memory stages sequenced by mbarriers.
//
// What it does for prefill is what decode.cuh does for decode: one device
// body (run_block) that both kernels instantiate with a Plan (flash_prefill.cu,
// flash_suffix_prefill.cu) saying which K/V tiles a block walks, which of
// them need an element mask, and how each tile is loaded.
//
// Block: one (row, kv head) pair and a query tile of R = 64*W rows, packed
// as the SIMT kernels pack them: tile row r = (position q_lo + r / G, head
// r % G), so one K/V tile serves all G query heads. W consumer warpgroups
// (threads 0 .. 128W-1) own 64 rows each; the last warpgroup is the
// producer. Its thread 0 issues the TMA loads (the Q tile once, then K and V
// tiles of BK keys into a STAGES-deep ring: "full" barriers complete when a
// stage's bytes have landed, "empty" ones when every consumer thread is done
// with it); a tile a TMA box cannot express (pool pages through a page
// table) is written by all 128 producer threads instead (Plan::manual). The
// producer hands registers to the consumers with setmaxnreg (Regs<W>); two
// consumer warpgroups take turns to issue Q.K^T (Turn<W>), so one's softmax
// runs under the other's MMAs.
//
// Consumers, per tile: S = Q.K^T by wgmma m64n128k16 (bf16 in, fp32 out, Q
// and K both K-major in shared memory), the online softmax in registers (the
// row max and sum reduced over the 4 threads of the accumulator layout that
// share a row; exp2 with scale*log2(e) folded into the scores; masked scores
// NEG = -2**30 as in common.cuh, and only tiles the Plan flags pay for the
// mask), P split in registers into three bf16 terms (hi + mid + lo) used
// as the register A operands of wgmma m64n{HD}k16 against V (an MN-major B
// operand: the transpose bit).
// Epilogue: O / max(l, 1e-30) in fp32, rounded to bf16, staged through the
// warpgroup's own Q rows in shared memory and stored with 16-byte stores for
// rows with a position inside the sequence.
//
// Shared-memory layout: every tile (Q: R rows, K and V: BK rows) is rows of
// HD bf16 in the swizzle TMA and wgmma agree on: 128-byte atom rows for hd
// 64 and 128 (two atoms side by side, each its own region, for 128), 64-byte
// rows (the 64-byte swizzle) for the head dims 64 does not divide: one
// region for hd 32, five for hd 160; regions 1024-byte aligned.
// Layout<HD>::off is that swizzle, used by the producer's own writes and the
// epilogue. At hd 160 P.V is one wgmma m64n160k16 per k-step and term (V an
// MN-major operand five 64-byte atoms wide, its leading byte offset the
// region stride, as the two 128-byte atoms of hd 128), and the block's
// shared memory is 201 KB with two consumer warpgroups, 181 KB with one.
//
// G that does not divide 64 (G 3: BQ = 64 * W / 3 positions, 63 or 126 rows)
// leaves the tile's last rows outside the Q box: TMA writes G * BQ rows, the
// rest hold whatever shared memory held. A row of a wgmma product and of the
// softmax depends on its own Q row only, and out_row() stores no row past
// G * BQ, so those rows are computed and dropped.
//
// Numerics against the plain version (fp32 softmax, fp32 P.V): scores from
// bf16 products summed in fp32 by the tensor cores; fp32 accumulation;
// online rescaling per 128-key tile. P goes into P.V as three bf16 terms,
// hi + mid + lo (~24 bits of p, as fp32), not as one bf16 rounding (8
// bits) as most tensor-core flash attentions do: one rounding moves the
// early rows' outputs (few keys, values of 1-4) by ~2**-9 of themselves,
// enough to flip their bf16 rounding by one ulp, and one such ulp at a value
// above 2 is 0.0156, twice the gate of 0.05 x RMS (RMS ~0.16) that the
// kernel is held to at the serving path's shape; two terms keep p to ~2**-18
// of itself, three to ~2**-27, below fp32's own rounding. The terms cost P.V
// three wgmmas where one would do: twice the MMA work of a tile. On an H100
// (chip_smoke.py phase 3, builds of one, two and three terms on the same
// inputs) the 8 x 512 path shape read err/RMS 0.096 / 0.048 / 0.024 against
// the gate of 0.05, at 0.066 / 0.071 / 0.082 ms: two terms would sit at the
// gate's edge for 13 % of the time, so three stay. The sum l of the
// unrounded p stays fp32.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace repro {
namespace tc {

constexpr int BK = 128;     // keys per K/V tile (= producer threads: one row each)
constexpr int STAGES = 2;   // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;

// Blocks per SM and the registers setmaxnreg hands each role: the producer
// gives up what the consumers' accumulators need. W = 2: one block of 384
// threads at 168 registers; W = 1: two blocks of 256 threads at 128 each.
template <int W>
struct Regs {
  static_assert(W == 1 || W == 2, "one or two consumer warpgroups");
  static constexpr int BLOCKS = W == 1 ? 2 : 1;
  static constexpr int PRODUCER = 40;
  static constexpr int CONSUMER = W == 1 ? 216 : 232;
  static constexpr int AT_LAUNCH = (PRODUCER + W * CONSUMER) / (W + 1);   // 128 / 168
};

template <int HD>
struct Layout {
  static_assert(HD == 32 || HD == 64 || HD == 128 || HD == 160,
                "head dims 32, 64, 128, 160");
  static constexpr int AW = HD % 64 == 0 ? 64 : 32;   // elements per swizzle-atom row
  static constexpr int AB = AW * 2;              // its bytes: 128 or 64
  static constexpr int CPA = AB / 16;            // 16-byte chunks per atom row
  static constexpr int CH = HD / 8;              // 16-byte chunks per row
  static constexpr int REGIONS = HD / AW;
  static constexpr uint64_t MODE = AB == 128 ? 1 : 2;   // wgmma: 128B / 64B swizzle
  static constexpr CUtensorMapSwizzle TMA_SWIZZLE =
      AB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  // byte offset of 16-byte chunk c of row r in a tile of `rows` rows
  __device__ static uint32_t off(int rows, int r, int c) {
    const uint32_t o = (uint32_t)(c / CPA) * rows * AB + (uint32_t)r * AB + (c % CPA) * 16;
    return o ^ (((o >> 7) & (CPA - 1)) << 4);
  }
};

// ------------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// phase that never completes is a fault in the kernel: trap (the launch
// fails with an error) rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma reads through it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Two consumer warpgroups take turns to issue their Q.K^T (named barriers 4
// and 5): while one runs its softmax, the other's MMAs hold the tensor
// cores. Warpgroup 0 goes first; each passes the turn once its Q.K^T is
// issued, except warpgroup 1 after its last tile (so that every arrive meets
// a wait). One warpgroup takes no turns.
template <int W>
struct Turn {
  int wg;
  bool last;
  __device__ void wait() const {
    if constexpr (W == 2) named_sync(4 + wg, 256);
  }
  __device__ void pass() const {
    if constexpr (W == 2) {
      if (wg == 0 || !last) named_arrive(4 + (wg ^ 1), 256);
    }
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2**x on the SFU; results below 2**-126 flush to zero (a probability that
// small moves no fp32 sum it joins).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

#define TC_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TC_D16(i) TC_D8(i), TC_D8(i + 8)
#define TC_D32(i) TC_D16(i), TC_D16(i + 16)
#define TC_D64(i) TC_D32(i), TC_D32(i + 32)

// S (64 x 128) = A (64 x 16, smem) . B (128 x 16, smem)^T, both K-major; scale_d 0
// overwrites d, 1 accumulates.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TC_D64(0)
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 32) += A (64 x 16, registers) . B (16 x 32, smem, MN-major: imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : TC_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 64) += A (64 x 16, registers) . B (16 x 64, smem, MN-major: imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TC_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128) += A (64 x 16, registers) . B (16 x 128, smem, MN-major: imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TC_D64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 160) += A (64 x 16, registers) . B (16 x 160, smem, MN-major: imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : TC_D64(0), TC_D16(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 32) {
    wgmma_rs_n32(o, a, db);
  } else if constexpr (HD == 64) {
    wgmma_rs_n64(o, a, db);
  } else if constexpr (HD == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n160(o, a, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One K/V tile of one consumer warpgroup: its 64 query rows (q_addr: their
// first row in region 0 of the Q tile of R rows) against the BK keys at
// k_addr / v_addr. Each thread holds rows r0 and r0 + 8 of the warpgroup's
// 64 (the accumulator layout): half h of s[j*4 + e] is e >> 1, its column
// j*8 + col0 + (e & 1). `live(h, c)` decides a key where `masked` is set.
template <int HD, int R, typename Live, typename Turn>
__device__ __forceinline__ void attend_tile(float (&o)[HD / 2], float (&m)[2], float (&l)[2],
                                            uint32_t q_addr, uint32_t k_addr, uint32_t v_addr,
                                            float scale_log2, bool masked, const Live& live,
                                            int col0, const Turn& turn) {
  using L = Layout<HD>;
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
  fence_regs(s);
  turn.wait();
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {   // 16 elements = 32 bytes of hd per step
    const uint32_t region = kk * 32 / L::AB, within = kk * 32 % L::AB;
    wgmma_ss_n128(s, desc(q_addr + region * R * L::AB + within, 16, 8 * L::AB, L::MODE),
                  desc(k_addr + region * BK * L::AB + within, 16, 8 * L::AB, L::MODE),
                  kk > 0);
  }
  wgmma_commit();
  turn.pass();
  wgmma_wait0();
  fence_regs(s);

  if (masked) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j * 4 + e] = live(e >> 1, j * 8 + col0 + (e & 1)) ? s[j * 4 + e] * scale_log2 : NEG;
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] *= scale_log2;
  }

  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j * 4 + 2 * h], s[j * 4 + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[h] = exp2_ftz(m[h] - mx);
    m[h] = mx;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_ftz(s[j * 4 + e] - m[e >> 1]);
      s[j * 4 + e] = p;
      sum[e >> 1] += p;
    }
  // l stays a per-thread partial sum (alpha is uniform over the row's 4
  // threads); the epilogue reduces it.
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

  // P as three bf16 terms, hi = bf16(p), mid = bf16(p - hi), lo = bf16(p -
  // hi - mid) (each difference exact in fp32), each the A fragments of
  // k-steps of 16 keys (the accumulator layout of n8 blocks 2kk and 2kk+1
  // is the A layout of k-step kk): P.V = hi.V + mid.V + lo.V keeps p to
  // ~24 bits, as fp32 does.
  uint32_t pa[3][BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float r0 = s[kk * 8 + 2 * x], r1 = s[kk * 8 + 2 * x + 1];
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        const uint32_t t = pack_bf16(r0, r1);   // bf16(r0) low, bf16(r1) high
        pa[term][kk][x] = t;
        r0 -= __uint_as_float(t << 16);
        r1 -= __uint_as_float(t & 0xffff0000u);
      }
    }
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {   // V: MN-major, 16 keys = 16 atom rows per step
    const uint64_t dv = desc(v_addr + kk * 16 * L::AB, BK * L::AB, 8 * L::AB, L::MODE);
#pragma unroll
    for (int term = 0; term < 3; ++term) wgmma_rs<HD>(o, pa[term][kk], dv);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(o);
}

template <int HD, int W>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)64 * W * HD * 2 + (size_t)STAGES * 2 * BK * HD * 2 +
         8 * (1 + 2 * STAGES);
}
static_assert(smem_bytes<160, 2>() <= 232448, "hd 160 fits the 227 KB opt-in");

// The block body. Plan (device methods, see flash_prefill.cu):
//   count()                      K/V tiles the block walks
//   k_lo(i)                      first key of tile i
//   manual(i)                    tile i written by the producer threads (else TMA)
//   masked(i, k_lo)              tile i needs the element mask
//   live(i, k_lo, qpos, c)       key c of tile i is live for a row at qpos
//   qpos(r)                      position of tile row r
//   load_q(dst, bar)             TMA of the Q tile (producer thread 0)
//   load_tile(i, k_dst, v_dst, k_ptr, v_ptr, bar, ptid)   fill a stage
//   out_row(r)                   output row r, or nullptr (not stored)
template <int HD, int W, typename Plan>
__device__ __forceinline__ void run_block(const Plan& plan, float scale_log2) {
  using L = Layout<HD>;
  constexpr int R = 64 * W;
  constexpr uint32_t Q_BYTES = R * HD * 2, KV_BYTES = BK * HD * 2;
  static_assert(BK == 128, "one producer thread per key row");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzled TMA boxes: 1024-byte aligned
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + Q_BYTES + STAGES * 2 * KV_BYTES;
  auto kv = [&](int st) { return base + Q_BYTES + st * 2 * KV_BYTES; };
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + STAGES + st); };
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bars, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), W * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n = plan.count();

  if (tid >= W * 128) {   // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs<W>::PRODUCER) : "memory");
    const int ptid = tid - W * 128;
    if (ptid == 0) plan.load_q(base, bars);
    for (int i = 0; i < n; ++i) {
      if (ptid != 0 && !plan.manual(i)) break;   // TMA tiles: thread 0 alone
      const int st = i % STAGES;
      mbar_wait(empty(st), ((i / STAGES) & 1) ^ 1);
      plan.load_tile(i, kv(st), kv(st) + KV_BYTES, gbase + (kv(st) - base),
                     gbase + (kv(st) + KV_BYTES - base), full(st), ptid);
    }
  } else {                // ---- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs<W>::CONSUMER) : "memory");
    const int wg = tid >> 7, t = tid & 127, lane = t & 31;
    const int r0 = wg * 64 + (t >> 5) * 16 + (lane >> 2);
    const int qp[2] = {plan.qpos(r0), plan.qpos(r0 + 8)};
    const int col0 = (lane & 3) * 2;
    float o[HD / 2], m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    const uint32_t q_wg = base + wg * 64 * L::AB;
    if (W == 2 && wg == 1 && n > 0) named_arrive(4, 256);   // warpgroup 0's first turn
    mbar_wait(bars, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      mbar_wait(full(st), (i / STAGES) & 1);
      const int k_lo = plan.k_lo(i);
      attend_tile<HD, R>(
          o, m, l, q_wg, kv(st), kv(st) + KV_BYTES, scale_log2, plan.masked(i, k_lo),
          [&](int h, int c) { return plan.live(i, k_lo, qp[h], c); }, col0,
          Turn<W>{wg, i == n - 1});
      mbar_arrive(empty(st));
    }
    // epilogue: the row sums over the 4 threads of a row, O / max(l, 1e-30)
    // in bf16 into the warpgroup's own Q rows (its wgmma reads are done),
    // then 16-byte stores of the rows that are stored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = fmaxf(l[h], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(gbase + L::off(R, r0 + 8 * h, j) + col0 * 2) =
            pack_bf16(o[j * 4 + 2 * h] / l[h], o[j * 4 + 2 * h + 1] / l[h]);
    named_sync(2 + wg, 128);
    for (int u = t; u < 64 * L::CH; u += 128) {
      const int r = wg * 64 + u / L::CH, c = u % L::CH;
      __nv_bfloat16* dst = plan.out_row(r);
      if (dst != nullptr)
        *reinterpret_cast<int4*>(dst + c * 8) =
            *reinterpret_cast<const int4*>(gbase + L::off(R, r, c));
    }
  }
}

// TMA loads of the K and V tile of keys [k, k + BK) of kv head h, row b, from
// (B, T, Hkv, HD) maps into a stage (both hd regions).
template <int HD>
__device__ __forceinline__ void load_kv_tma(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                            uint32_t k_dst, uint32_t v_dst, uint32_t bar,
                                            int h, int k, int b) {
  using L = Layout<HD>;
  mbar_expect_tx(bar, 2 * L::REGIONS * L::AB * BK);
#pragma unroll
  for (int g = 0; g < L::REGIONS; ++g) {
    tma_load_4d(k_dst + g * BK * L::AB, kmap, bar, g * L::AW, h, k, b);
    tma_load_4d(v_dst + g * BK * L::AB, vmap, bar, g * L::AW, h, k, b);
  }
}

// TMA load of the Q tile (BQ positions from q_lo, all G heads of kv head h,
// row b) from a (B, S, Hkv, G, HD) map into a tile of R rows.
template <int HD, int R>
__device__ __forceinline__ void load_q_tma(const CUtensorMap* qmap, uint32_t dst, uint32_t bar,
                                           int G, int BQ, int h, int q_lo, int b) {
  using L = Layout<HD>;
  mbar_expect_tx(bar, L::REGIONS * L::AB * G * BQ);
#pragma unroll
  for (int g = 0; g < L::REGIONS; ++g)
    tma_load_5d(dst + g * R * L::AB, qmap, bar, g * L::AW, 0, h, q_lo, b);
}

// ------------------------------------------------------------------ host
constexpr int ERR_TENSOR_MAP = -2;   // cuTensorMapEncodeTiled refused a tensor map
constexpr int ERR_REGISTERS = -3;    // too few registers for the setmaxnreg split

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the library
// links no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A tensor map over a contiguous bf16 tensor: `rank` dims innermost first,
// box `box`, the swizzle of Layout<HD>, zeros outside the tensor.
template <int HD>
inline int make_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                    const uint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_TENSOR_MAP;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = stride;
    stride *= dims[i];
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), gdim,
                        gstride, bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        Layout<HD>::TMA_SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// Opt in to the kernel's shared memory and check that it was built with the
// registers the setmaxnreg split hands out (a consumer's .inc would
// otherwise wait for registers that never come). The launchers call it once
// per kernel instantiation and keep the result.
template <int W, typename Kernel>
inline int prepare(Kernel kernel, size_t smem) {
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  return attr.numRegs < Regs<W>::AT_LAUNCH ? ERR_REGISTERS : 0;
}

}  // namespace tc
}  // namespace repro
