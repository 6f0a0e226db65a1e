// Flash-decode attention over per-row contiguous ring caches, every slot.
//
// Replaces the TPU kernel src/repro/kernels/swa_decode.py::swa_decode (body
// _swa_kernel): one query token per row (the G query heads of one kv head
// together) attends over its ring (B, C, Hkv, hd) with the ring-validity
// mask and an optional sliding window. Like the TPU kernel it streams EVERY
// key of the ring, whatever the row's depth: paged_decode_ring is the
// variant that skips the pages a row has not reached, and the two give
// bitwise the same output (decode.cuh). It serves the lockstep single-batch
// path (serve_batch) and the ring engine with paged decode switched off.
//
// What bounds it on an H100: bytes, all of both rings (B*C*Hkv*hd elements
// of K and of V) per call, at 1 flop per byte for stablelm-1.6b's G = 1,
// hd = 64. The design is paged_decode_ring's (one block per row and kv
// head, 64-key tiles through shared memory, 16-byte loads); at B = 1 and a
// long ring (long_500k: C = 8192) only Hkv blocks run, which is the shape a
// split-KV kernel is for.
#include "decode.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q, out and the rings). pos (B,) int32.
// Returns cudaGetLastError() after the launch (0 on success), or -1 for an
// unsupported head dim / dtype.
extern "C" int swa_decode(const void* q, const void* k, const void* v, const void* pos,
                          void* out, int dtype, int B, int C, int Hkv, int G, int hd,
                          int window, float scale, void* stream) {
  return repro::ring_decode<false>(q, k, v, pos, out, dtype, B, C, Hkv, G, hd, C, window,
                                   scale, (cudaStream_t)stream);
}
