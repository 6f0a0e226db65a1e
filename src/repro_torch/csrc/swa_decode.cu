// Flash-decode attention over per-row contiguous ring caches, every slot.
//
// Replaces the TPU kernel src/repro/kernels/swa_decode.py::swa_decode (body
// _swa_kernel): one query token per row (the G query heads of one kv head
// together) attends over its ring (B, C, Hkv, hd) with the ring-validity
// mask and an optional sliding window. Like the TPU kernel it streams EVERY
// key of the ring, whatever the row's depth: paged_decode_ring is the
// variant that skips the pages a row has not reached, and the two give
// bitwise the same output. It serves the lockstep single-batch path
// (serve_batch) and the ring engine with paged decode switched off.
//
// What bounds it on an H100: bytes, all of both rings (B*C*Hkv*hd elements
// of K and of V) per call, at 1 flop per byte for stablelm-1.6b's G = 1,
// hd = 64. The design is paged_decode_ring's split-KV body (decode.cuh):
// fixed ranges of split_len(C, hd) slots, one block per (range, kv head,
// row), keys streamed per warp through a 2-stage cp.async ring, the softmax
// in registers, the ranges merged in order by a second kernel. It walks
// every range, also those past a row's live span: their keys are all
// masked, so the range's max stays NEG and the merge weighs it by
// exp(NEG - M) == 0, bitwise what paged_decode_ring's identity partial for
// the skipped range adds.
#include "decode.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q, out and the rings). pos (B,) int32.
// part: the caller's f32 scratch, B * Hkv * G * ceil(C / split) * (hd + 2)
// floats. Returns cudaGetLastError() after the launches (0 on success), or
// -1 for an unsupported head dim / dtype / split.
extern "C" int swa_decode(const void* q, const void* k, const void* v, const void* pos,
                          void* part, void* out, int dtype, int B, int C, int Hkv, int G,
                          int hd, int window, int split, float scale, void* stream) {
  return repro::ring_decode<false>(q, k, v, pos, part, out, dtype, B, C, Hkv, G, hd, C, window,
                                   split, scale, (cudaStream_t)stream);
}
