// Decode attention (one query token per row) over a dense int8 KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lws_tpu/ops/int8_attention.py:
// int8_decode_attention (body _kernel):
//   q [B,1,H,128] bf16; k/v [B,T,Hkv,128] int8 in the cache's own layout (one
//   layer of the [L,B,T,Hkv,128] cache, read in place); k_scale/v_scale
//   [B,T,Hkv] f32 (per token and kv head); pos scalar or [B] int32 -> out
//   [B,1,H,128] bf16. Keys at positions > pos are masked.
//
// What bounds it: bytes. It reads the int8 rows up to pos and their scales,
// 132 bytes per token and kv head, and does ~4 flops per byte. The TPU
// kernel gives one program a whole (row, kv head) pair; on the H100,
// B x Hkv = 64 CTAs (the flagship's 8 rows) would leave half the SMs idle
// and each would walk up to 2048 tokens behind one CTA's latency. So it is
// the paged kernel's design with dense addressing (decode_common.cuh,
// DenseAddr): the T axis is cut into 16-token blocks, each (row, kv head) is
// split over CTAs sized to give the card ~4 CTAs per SM, the G query heads
// share every staged block, and a second pass merges the splits. With a
// scalar pos every row has the same live length, so the splits cover only
// the live blocks; with [B] pos (device data) they cover all of T.

#include "decode_common.cuh"

extern "C" {

// q/out [B,1,H,128] bf16, k/v [B,T,Hkv,128] int8, k_scale/v_scale [B,T,Hkv]
// f32, all contiguous on the current device; pos [B] int32, or null with
// every row at pos_all; part_acc f32 [B*Hkv*splits*G*128] and part_ml f32
// [B*Hkv*splits*G*2] scratch; 1 <= H/Hkv <= 32; splits * blocks_per_split
// covers every row's live 16-token blocks. Returns the first cudaError_t.
int lws_int8_decode_attention(const void* q, const void* k, const void* k_scale,
                              const void* v, const void* v_scale, const void* pos,
                              int pos_all, void* out, void* part_acc, void* part_ml, int B,
                              int T, int H, int Hkv, int splits, int blocks_per_split,
                              float scale, void* stream) {
  const lws_decode::DenseAddr addr{T};
  return lws_decode::launch_decode<lws_decode::Int8Rows>(q, k, k_scale, v, v_scale, addr, pos,
                                                         pos_all, out, part_acc, part_ml, B, H,
                                                         Hkv, splits, blocks_per_split, scale,
                                                         stream);
}

const char* lws_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
