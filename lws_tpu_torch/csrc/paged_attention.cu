// Paged decode attention (one query token per slot) over the whole KV block
// pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lws_tpu/ops/paged_attention.py:
// paged_decode_attention (body _kernel), both branches:
//   q [B,1,H,128] bf16; k/v pools [L, NB, 16, Hkv, 128] (passed whole), bf16,
//   or int8 with f32 scales [L, NB, 16, Hkv] (quant=True); table [B, MB] int32
//   (slot -> pool blocks); pos [B] int32 (each slot's current write
//   position); layer -> out [B,1,H,128] bf16.
// Keys at logical positions <= pos[b] are attended; everything is read in
// place from the pool at ((layer*NB + blk)*16 + t)*Hkv + h)*128, so no
// per-layer slice or gathered view is ever built.
//
// What bounds it: bytes. A decode step reads every live K/V row once and does
// ~2 flops per byte (~4 for int8), far below the ~295 flop/byte at which the
// H100's tensor cores, not its memory, would be the limit. An int8 row with
// its scale is 132 bytes per kv head against 256 in bf16, so the int8 bound
// is about half the bf16 one. The TPU kernel walks one slot's blocks in order
// on one core; on the H100 a few dozen (slot, kv head) pairs would leave most
// of the 132 SMs idle, and one CTA walking a long sequence is bound by
// latency, not bandwidth. So the sequence is split:
//   * pass 1 (decode_split<Bf16Rows or Int8Rows, PagedAddr> of
//     decode_common.cuh): one CTA per (slot, kv head, split of
//     `blocks_per_split` table entries). Its G = H/Hkv query heads are one
//     warp each and share every K/V block, staged in shared memory by cp.async
//     (16-byte copies, kStages blocks in flight). Only live blocks
//     (j <= pos/16, capped at MB so a row is never read past max_blocks) and,
//     inside the last one, only tokens <= pos are used. Each warp keeps an
//     online softmax in f32 (running max m, sum l, a 4-wide accumulator per
//     lane) and writes its unnormalised (acc, m, l) for the split;
//   * pass 2 (decode_combine): one CTA per (slot, query head) merges the
//     splits with weights exp(m_s - max m) and writes acc / l as bf16.
// Splits past a slot's live range write l = 0 and are skipped by pass 2.
// Block 0 is the null block: inactive slots' table rows are all 0 and their
// pos is frozen, so they read block 0 harmlessly; an entry outside [0, NB)
// also reads block 0.

#include "decode_common.cuh"

extern "C" {

// q/out [B,1,H,128], pools [L,NB,16,Hkv,128] contiguous bf16; table [B,MB]
// and pos [B] contiguous int32; part_acc f32 [B*Hkv*splits*G*128] and part_ml
// f32 [B*Hkv*splits*G*2] scratch; all on the current device; 1 <= H/Hkv <= 32;
// splits * blocks_per_split >= MB. Launches both passes on `stream`; returns
// the first cudaError_t.
int lws_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                               const void* table, const void* pos, int layer, void* out,
                               void* part_acc, void* part_ml, int B, int H, int Hkv, int NB,
                               int MB, int splits, int blocks_per_split, float scale,
                               void* stream) {
  const lws_decode::PagedAddr addr{static_cast<const int*>(table), MB, NB, layer};
  return lws_decode::launch_decode<lws_decode::Bf16Rows>(
      q, k_pool, nullptr, v_pool, nullptr, addr, pos, 0, out, part_acc, part_ml, B, H, Hkv,
      splits, blocks_per_split, scale, stream);
}

// The int8 pool: k/v [L,NB,16,Hkv,128] contiguous int8 with k_scale/v_scale
// [L,NB,16,Hkv] contiguous f32; everything else as above.
int lws_paged_decode_attention_int8(const void* q, const void* k_pool, const void* k_scale,
                                    const void* v_pool, const void* v_scale,
                                    const void* table, const void* pos, int layer, void* out,
                                    void* part_acc, void* part_ml, int B, int H, int Hkv,
                                    int NB, int MB, int splits, int blocks_per_split,
                                    float scale, void* stream) {
  const lws_decode::PagedAddr addr{static_cast<const int*>(table), MB, NB, layer};
  return lws_decode::launch_decode<lws_decode::Int8Rows>(
      q, k_pool, k_scale, v_pool, v_scale, addr, pos, 0, out, part_acc, part_ml, B, H, Hkv,
      splits, blocks_per_split, scale, stream);
}

const char* lws_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
