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
// the paged kernel with dense addressing (decode_common.cuh,
// decode_attention<Int8Rows, DenseAddr>): the T axis is cut into 16-token
// blocks, the live blocks of every row are planned on the device into equal
// work items over a fixed grid, the G query heads share every staged block
// on the tensor cores, and the last item of a (row, kv head) merges the
// others in the same launch. A scalar pos is every row's position.

#include "decode_common.cuh"

extern "C" {

// q/out [B,1,H,128] bf16, k/v [B,T,Hkv,128] int8, k_scale/v_scale [B,T,Hkv]
// f32, all contiguous on the current device; pos [B] int32, or null with
// every row at pos_all; part_acc/part_ml/tickets as for the paged kernel
// (blocks = ceil(T/16)); 1 <= H/Hkv <= 32. Returns the cudaError_t.
int lws_int8_decode_attention(const void* q, const void* k, const void* k_scale,
                              const void* v, const void* v_scale, const void* pos,
                              int pos_all, void* out, void* part_acc, void* part_ml,
                              void* tickets, int B, int T, int H, int Hkv, int grid, int prefer,
                              float scale, void* stream) {
  const lws_decode::DenseAddr addr{T};
  return lws_decode::launch_decode<lws_decode::Int8Rows>(
      q, k, k_scale, v, v_scale, addr, pos, pos_all, out, part_acc, part_ml, tickets, B, H, Hkv,
      grid, prefer, scale, stream);
}

// The chunk sizes the kernel's plan picks from, into out[0..cap); returns
// their count (`quant` is accepted for the paged library's signature).
int lws_decode_chunk_sizes(int /*quant*/, int* out, int cap) {
  return lws_decode::chunk_sizes<lws_decode::Int8Rows>(out, cap);
}

const char* lws_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
