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
// on one core; on the H100 the live (slot, block) pairs are dealt out as
// equal work items over a fixed grid, so no CTA walks a long sequence alone.
// The kernel is decode_attention<Bf16Rows or Int8Rows, PagedAddr> of
// decode_common.cuh: each CTA plans the items from pos on the device (no
// host read of pos, one launch, capturable in a CUDA graph), fetches an
// item's blocks by TMA, up to 8 (int8: 16) at a time, runs Q.K^T and P.V on
// the tensor cores with the G = H/Hkv query heads as the MMA's rows, and the
// last item of a (slot, kv head) merges the others in chunk order. Only live blocks (j <= pos/16,
// capped at MB so a row is never read past max_blocks) are read and, inside
// the last one, only rows <= pos. Block 0 is the null block: inactive slots'
// table rows are all 0 and their pos is frozen, so they read block 0
// harmlessly; an entry outside [0, NB) also reads block 0.

#include "decode_common.cuh"

extern "C" {

// q/out [B,1,H,128], pools [L,NB,16,Hkv,128] contiguous bf16; table [B,MB]
// and pos [B] contiguous int32; part_acc f32 [items*G*128] and part_ml f32
// [items*G*2] scratch for `items` = plan bound (ops/paged_attention.py:
// scratch_items); tickets int32 [B*Hkv], zero, and left zero; all on the
// current device; 1 <= H/Hkv <= 32. Launches `grid` CTAs on `stream` that
// plan at most `prefer` items where a chunk size allows; returns the
// cudaError_t.
int lws_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                               const void* table, const void* pos, int layer, void* out,
                               void* part_acc, void* part_ml, void* tickets, int B, int H,
                               int Hkv, int NB, int MB, int grid, int prefer, float scale,
                               void* stream) {
  const lws_decode::PagedAddr addr{static_cast<const int*>(table), MB, NB, layer};
  return lws_decode::launch_decode<lws_decode::Bf16Rows>(
      q, k_pool, nullptr, v_pool, nullptr, addr, pos, 0, out, part_acc, part_ml, tickets, B, H,
      Hkv, grid, prefer, scale, stream);
}

// The int8 pool: k/v [L,NB,16,Hkv,128] contiguous int8 with k_scale/v_scale
// [L,NB,16,Hkv] contiguous f32; everything else as above.
int lws_paged_decode_attention_int8(const void* q, const void* k_pool, const void* k_scale,
                                    const void* v_pool, const void* v_scale,
                                    const void* table, const void* pos, int layer, void* out,
                                    void* part_acc, void* part_ml, void* tickets, int B, int H,
                                    int Hkv, int NB, int MB, int grid, int prefer, float scale,
                                    void* stream) {
  const lws_decode::PagedAddr addr{static_cast<const int*>(table), MB, NB, layer};
  return lws_decode::launch_decode<lws_decode::Int8Rows>(
      q, k_pool, k_scale, v_pool, v_scale, addr, pos, 0, out, part_acc, part_ml, tickets, B, H,
      Hkv, grid, prefer, scale, stream);
}

// The chunk sizes the bf16 (quant = 0) or int8 kernel's plan picks from,
// into out[0..cap); returns their count.
int lws_decode_chunk_sizes(int quant, int* out, int cap) {
  return quant ? lws_decode::chunk_sizes<lws_decode::Int8Rows>(out, cap)
               : lws_decode::chunk_sizes<lws_decode::Bf16Rows>(out, cap);
}

const char* lws_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
