// Building blocks shared by the port's CUDA sources: cp.async copies (with
// zero fill), mbarrier waits for TMA copies, ldmatrix, the
// mma.sync.m16n8k16 bf16 product with f32 accumulation, and the exact int8 ->
// bf16 conversion. ops/_ext.py hashes every csrc/*.cuh into each library's
// build digest, so an edit here rebuilds every source that may include it.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * g + t):
//   A [16 x 16] row-major, 4 regs of bf16x2: a0 (row g, k 2t..2t+1),
//     a1 (row g+8, k 2t..), a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..);
//   B [16 x 8], 2 regs: b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g);
//   C [16 x 8] f32, 4 regs: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// A product sums over k, so any permutation of k applied to A and B alike
// leaves it unchanged; int8_matmul.cu uses that to give lane t contiguous k.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lws_sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the bytes past `src_bytes` (0 or 16) are zero.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem_dst)),
               "l"(gmem_src), "r"(src_bytes));
}

// 4 bytes global -> shared, through L1 (for strided scalars).
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem_dst)),
               "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Order the shared-memory accesses before it (of the threads this thread has
// synchronised with) before this thread's later TMA copies into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Four 8x8 16-bit matrices (or 8 x 16 bytes of int8); lane i gives the row
// address of matrix i / 8, and lane 4g + t gets bytes 4t..4t+3 of row g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> bf16x2 (lo in the low half), round to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four int8 (one word, byte 0 first) -> two bf16x2 words, exactly: each
// byte, biased to unsigned, becomes the low mantissa byte of 2^23 (an f32
// whose value is 2^23 + u), 2^23 + 128 is subtracted (exact), and the upper
// half of the f32 is the bf16 (exact: |v| <= 128 needs 8 significant bits).
__device__ __forceinline__ void int8x4_to_bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr uint32_t kBase = 0x4B000000u;  // 2^23
  float f0 = __uint_as_float(__byte_perm(u, kBase, 0x7650)) - 8388736.f;
  float f1 = __uint_as_float(__byte_perm(u, kBase, 0x7651)) - 8388736.f;
  float f2 = __uint_as_float(__byte_perm(u, kBase, 0x7652)) - 8388736.f;
  float f3 = __uint_as_float(__byte_perm(u, kBase, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

}  // namespace lws_sm90
