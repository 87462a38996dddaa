// Causal (or full) grouped-query flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lws_tpu/ops/attention.py:flash_attention
// (body _flash_kernel): q [B,S,H,D], k/v [B,Skv,Hkv,D] in bf16 -> o [B,S,H,D]
// in bf16, online softmax in f32, the [S, Skv] score matrix never written to
// device memory. Query head h reads kv head h / (H / Hkv).
//
// What bounds it: at prefill lengths (S >= 128) the work is operations
// (4*S*Skv*D per head, halved by causality) against a few MB of input, so
// the tensor cores are the limit, and what keeps them waiting is everything
// around the products: shared-memory round trips of the scores and of the
// output accumulator, synchronous loads, and the softmax's scalar code. The
// design is FlashAttention-2's, with mma.sync:
//   * one CTA of 8 warps per (q tile of 128 rows, head, batch); each warp owns
//     16 query rows. Q . K^T and P . V are mma.sync.m16n8k16 bf16 products
//     with f32 accumulation, their operands read by ldmatrix (.trans for V)
//     from row-padded shared tiles (a 272-byte pitch keeps ldmatrix free of
//     bank conflicts);
//   * S, P and O stay in registers: the score accumulator of one 64-key tile
//     becomes, packed to bf16, the A operand of P . V (the accumulator and
//     A-operand layouts agree), the row max and row sum reduce over the 4
//     lanes of a quad by two shuffles, and O is rescaled in registers. The
//     softmax runs in base 2 with D**-0.5 * log2(e) folded into one FMA
//     per score;
//   * K/V tiles pass through a 2-stage cp.async ring: tile j+1 is in flight
//     while tile j is computed, with one barrier per tile;
//   * only a tile that holds the diagonal (causal) or the ragged end of Skv
//     computes the mask; a warp whose rows all precede a tile's first key, or
//     lie past S, skips the tile's products;
//   * causal CTAs stop at the tile holding their last query row, as the
//     Pallas kernel's `upper` bound does, and the grid issues the longest
//     q tiles (the last ones) first, so the short ones fill the tail;
//   * keys >= Skv (zero-filled, never read from device memory) and, when
//     causal, keys after the query are masked, so ragged S/Skv need no
//     padding in device memory; query rows >= S are never stored.
// 104 KB of shared memory per CTA: two CTAs (16 warps) per SM. The G query
// heads of one kv head are neighbouring CTAs, so their K/V tiles come from
// L2; wgmma, TMA and warp specialisation (FlashAttention-3) are left for a
// later version.

#include "sm90_common.cuh"

namespace {

using namespace lws_sm90;
typedef __nv_bfloat16 bf16;

constexpr int kD = 128;        // head dim (the flagship's; checked by the wrapper)
constexpr int kBQ = 128;       // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPitch = kD + 8;  // bf16 pitch of the shared tiles (272 bytes)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kTileQ = kBQ * kPitch;  // elements
constexpr int kTileKV = kBK * kPitch;
constexpr size_t kSmemBytes = sizeof(bf16) * (kTileQ + 4 * kTileKV);  // Q, 2 x (K, V)

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + ROWS) of a [rows_valid, kD] matrix whose rows are
// `row_stride` elements apart into a kPitch-pitched tile, by 16-byte
// cp.async copies; rows past rows_valid are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, size_t row_stride,
                                          int rows_valid) {
  constexpr int kVecs = kD / 8;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    const bool ok = row0 + r < rows_valid;
    cp_async16(dst + r * kPitch + c, ok ? src + (size_t)(row0 + r) * row_stride + c : src,
               ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int B, int S, int Skv,
                 int H, int Hkv, int causal, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kTileQ;        // 2 stages
  bf16* sV = sK + 2 * kTileKV;   // 2 stages

  const int n_qtiles = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (B * H);
  const int qt = n_qtiles - 1 - blockIdx.x / (B * H);  // the longest q tiles first
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int t = lane & 3;   // lane within the quad

  const bf16* qb = q + ((size_t)b * S * H + h) * kD;       // row s at qb + s*H*kD
  const bf16* kb = k + ((size_t)b * Skv * Hkv + hk) * kD;  // row s at kb + s*Hkv*kD
  const bf16* vb = v + ((size_t)b * Skv * Hkv + hk) * kD;
  const size_t kv_stride = (size_t)Hkv * kD;

  const int q_last = min(q0 + kBQ, S) - 1;  // last real query row of this tile
  int n_tiles = (Skv + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, q_last / kBK + 1);  // stop at the diagonal

  load_rows<kBQ>(sQ, qb, q0, (size_t)H * kD, S);
  load_rows<kBK>(sK, kb, 0, kv_stride, Skv);
  load_rows<kBK>(sV, vb, 0, kv_stride, Skv);
  cp_async_commit();

  const int w_row0 = q0 + warp * 16;  // this warp's first query row
  const bool live = w_row0 < S;
  const int qr0 = w_row0 + g;         // the rows of accumulator regs 0-1 and 2-3
  const int qr1 = qr0 + 8;
  const bf16* sQw = sQ + warp * 16 * kPitch;

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this lane's share of the row sum

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j is in; every warp is done with tile j-1's stage
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      load_rows<kBK>(sK + st * kTileKV, kb, (j + 1) * kBK, kv_stride, Skv);
      load_rows<kBK>(sV + st * kTileKV, vb, (j + 1) * kBK, kv_stride, Skv);
    }
    cp_async_commit();
    const int k0 = j * kBK;
    if (!live || (causal && k0 > w_row0 + 15)) continue;  // no key of this tile is attended
    const bf16* cK = sK + (j & 1) * kTileKV;
    const bf16* cV = sV + (j & 1) * kTileKV;

    // Scores: [16, 64] = Q_w [16, 128] . K^T, eight 8-key accumulator tiles.
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, sQw + (lane & 15) * kPitch + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bk[4];  // keys 16np..+15 x d 16kk..+15: b0, b1 of two key tiles
        ldmatrix_x4(bk, cK + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kPitch + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // Masked online softmax in base 2. The raw scores are masked and their
    // row max taken; the scale D**-0.5 * log2(e) enters once, in the max and
    // in one FMA per score before exp2.
    if (k0 + kBK > Skv || (causal && k0 + kBK - 1 > w_row0)) {
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + n * 8 + 2 * t + (e & 1);
          if (kp >= Skv || (causal && kp > (e < 2 ? qr0 : qr1))) s[n][e] = kNegInf;
        }
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
    const float alpha0 = fast_exp2(m0 - mn0), alpha1 = fast_exp2(m1 - mn1);  // first tile: 0
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = fast_exp2(fmaf(s[n][0], scale_log2, -mn0));
      s[n][1] = fast_exp2(fmaf(s[n][1], scale_log2, -mn0));
      s[n][2] = fast_exp2(fmaf(s[n][2], scale_log2, -mn1));
      s[n][3] = fast_exp2(fmaf(s[n][3], scale_log2, -mn1));
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O_w [16, 128] += P [16, 64] . V [64, 128]; P's A fragments are the
    // score accumulators of two neighbouring key tiles, packed to bf16.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t bv[4];  // keys 16kk..+15 x d 16dp..+15: b0, b1 of two d tiles
        ldmatrix_x4_trans(bv, cV + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * kPitch +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }
  if (!live) return;

  // Epilogue: O / l as bf16 into this warp's own Q rows (no other warp reads
  // them), then 16-byte stores of the rows < S.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* sOw = sQ + warp * 16 * kPitch;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    *reinterpret_cast<uint32_t*>(sOw + g * kPitch + n * 8 + 2 * t) =
        pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(sOw + (g + 8) * kPitch + n * 8 + 2 * t) =
        pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  __syncwarp();
  constexpr int kVecs = kD / 8;
#pragma unroll
  for (int i = lane; i < 16 * kVecs; i += 32) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    if (w_row0 + r >= S) continue;
    *reinterpret_cast<uint4*>(o + ((size_t)(b * S + w_row0 + r) * H + h) * kD + c) =
        *reinterpret_cast<const uint4*>(sOw + r * kPitch + c);
  }
}

}  // namespace

extern "C" {

// q [B,S,H,128], k/v [B,Skv,Hkv,128], o [B,S,H,128]: contiguous bf16 on the
// current device, 16-byte aligned. Returns the cudaError_t of the launch.
int lws_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                            int S, int Skv, int H, int Hkv, int causal, float scale,
                            void* stream) {
  static bool ready = false;  // the attribute holds for the process: set it once
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int grid = (S + kBQ - 1) / kBQ * H * B;
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), B, S, Skv, H, Hkv, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

const char* lws_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
