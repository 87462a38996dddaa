// Paged decode attention (one query token per slot) over the whole KV block
// pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lws_tpu/ops/paged_attention.py:
// paged_decode_attention (body _kernel), bf16-pool branch:
//   q [B,1,H,128] bf16; k/v pools [L, NB, 16, Hkv, 128] bf16 (passed whole);
//   table [B, MB] int32 (slot -> pool blocks); pos [B] int32 (each slot's
//   current write position); layer -> out [B,1,H,128] bf16.
// Keys at logical positions <= pos[b] are attended; everything is read in
// place from the pool at ((layer*NB + blk)*16 + t)*Hkv + h)*128, so no
// per-layer slice or gathered view is ever built.
//
// What bounds it: bytes. A decode step reads every live K/V row once and does
// ~2 flops per byte, far below the ~295 flop/byte at which the H100's tensor
// cores, not its memory, would be the limit. The TPU kernel walks one slot's
// blocks in order on one core; on the H100 a few dozen (slot, kv head) pairs
// would leave most of the 132 SMs idle, and one CTA walking a long sequence
// is bound by latency, not bandwidth. So the sequence is split:
//   * pass 1 (paged_decode_split): one CTA per (slot, kv head, split of
//     `blocks_per_split` table entries). Its G = H/Hkv query heads are one
//     warp each and share every K/V block, staged in shared memory by cp.async
//     (16-byte copies, kStages blocks in flight). Only live blocks
//     (j <= pos/16, capped at MB so a row is never read past max_blocks) and,
//     inside the last one, only tokens <= pos are used. Each warp keeps an
//     online softmax in f32 (running max m, sum l, a 4-wide accumulator per
//     lane) and writes its unnormalised (acc, m, l) for the split;
//   * pass 2 (paged_decode_combine): one CTA per (slot, query head) merges the
//     splits with weights exp(m_s - max m) and writes acc / l as bf16.
// Splits past a slot's live range write l = 0 and are skipped by pass 2.
// Block 0 is the null block: inactive slots' table rows are all 0 and their
// pos is frozen, so they read block 0 harmlessly; an entry outside [0, NB)
// also reads block 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHD = 128;     // head dim (the flagship's; checked by the wrapper)
constexpr int kBS = 16;      // tokens per pool block (the engine's; checked by the wrapper)
constexpr int kStages = 4;   // K/V blocks in flight per CTA
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Pass 1. Grid (B, Hkv, splits), 32*G threads. part_acc [B,Hkv,splits,G,128]
// and part_ml [B,Hkv,splits,G,2] (m, l) in f32.
__global__ void paged_decode_split(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                                   const bf16* __restrict__ v_pool,
                                   const int* __restrict__ table, const int* __restrict__ pos,
                                   int layer, float* __restrict__ part_acc,
                                   float* __restrict__ part_ml, int H, int Hkv, int NB, int MB,
                                   int blocks_per_split, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTile = kBS * kHD;  // elements of one block's rows for one kv head
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  bf16* sK = reinterpret_cast<bf16*>(smem);  // [kStages][kBS][kHD]
  bf16* sV = sK + kStages * kTile;           // [kStages][kBS][kHD]

  const int p = pos[b];
  const int n_live = min(p / kBS + 1, MB);
  const int j0 = split * blocks_per_split;
  const int j1 = min(j0 + blocks_per_split, n_live);
  const size_t part = (((size_t)b * Hkv + h) * splits + split) * G + warp;
  if (j0 >= j1) {  // nothing live in this split
    if (lane == 0) {
      part_ml[part * 2] = kNegInf;
      part_ml[part * 2 + 1] = 0.f;
    }
    return;
  }

  // This warp's query head; lane l holds q[4l .. 4l+3] * scale in f32.
  const int hq = h * G + warp;
  float qv[4];
  {
    const __nv_bfloat162* qr =
        reinterpret_cast<const __nv_bfloat162*>(q + ((size_t)b * H + hq) * kHD + lane * 4);
    const float2 q01 = __bfloat1622float2(qr[0]);
    const float2 q23 = __bfloat1622float2(qr[1]);
    qv[0] = q01.x * scale;
    qv[1] = q01.y * scale;
    qv[2] = q23.x * scale;
    qv[3] = q23.y * scale;
  }

  const int* trow = table + (size_t)b * MB;
  const size_t tok_stride = (size_t)Hkv * kHD;
  const size_t blk_stride = (size_t)kBS * tok_stride;
  const bf16* k_layer = k_pool + (size_t)layer * NB * blk_stride + (size_t)h * kHD;
  const bf16* v_layer = v_pool + (size_t)layer * NB * blk_stride + (size_t)h * kHD;

  // Stage table entry j (if in this split's live range) into ring slot
  // (j - j0) % kStages. Always commits a group, empty past the range, so the
  // wait count stays uniform.
  auto issue = [&](int j) {
    if (j < j1) {
      int blk = trow[j];
      blk = (blk >= 0 && blk < NB) ? blk : 0;
      const bf16* kb = k_layer + (size_t)blk * blk_stride;
      const bf16* vb = v_layer + (size_t)blk * blk_stride;
      bf16* dk = sK + ((j - j0) % kStages) * kTile;
      bf16* dv = sV + ((j - j0) % kStages) * kTile;
      for (int i = tid; i < kBS * (kHD / 8); i += nthreads) {
        const int t = i / (kHD / 8);
        const int c = (i % (kHD / 8)) * 8;
        cp_async16(dk + t * kHD + c, kb + t * tok_stride + c);
        cp_async16(dv + t * kHD + c, vb + t * tok_stride + c);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(j0 + s);

  float m = kNegInf, l = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = j0; j < j1; ++j) {
    issue(j + kStages - 1);  // refills the ring slot block j-1 used (freed by the last barrier)
    cp_async_wait<kStages - 1>();
    __syncthreads();  // block j has landed for every thread's copies
    const bf16* ks = sK + ((j - j0) % kStages) * kTile;
    const bf16* vs = sV + ((j - j0) % kStages) * kTile;
    const int n_tok = min(kBS, p - j * kBS + 1);  // tokens <= pos in this block

    // kBS independent dot products; the butterflies interleave, so the warp
    // pays shuffle throughput, not kBS x 5 shuffle latencies. Every lane ends
    // with every score.
    float s[kBS];
#pragma unroll
    for (int t = 0; t < kBS; ++t) {
      const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(ks + t * kHD + lane * 4);
      const float2 k01 = __bfloat1622float2(kr[0]);
      const float2 k23 = __bfloat1622float2(kr[1]);
      s[t] = qv[0] * k01.x + qv[1] * k01.y + qv[2] * k23.x + qv[3] * k23.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < kBS; ++t) s[t] += __shfl_xor_sync(0xffffffffu, s[t], off);
    }
    float blk_max = kNegInf;
#pragma unroll
    for (int t = 0; t < kBS; ++t) {
      s[t] = t < n_tok ? s[t] : kNegInf;
      blk_max = fmaxf(blk_max, s[t]);
    }
    const float m_new = fmaxf(m, blk_max);
    const float alpha = __expf(m - m_new);  // first block: exp(-1e30 - m) = 0
    l *= alpha;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= alpha;
#pragma unroll
    for (int t = 0; t < kBS; ++t) {
      const float pt = t < n_tok ? __expf(s[t] - m_new) : 0.f;
      l += pt;
      const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(vs + t * kHD + lane * 4);
      const float2 v01 = __bfloat1622float2(vr[0]);
      const float2 v23 = __bfloat1622float2(vr[1]);
      acc[0] += pt * v01.x;
      acc[1] += pt * v01.y;
      acc[2] += pt * v23.x;
      acc[3] += pt * v23.y;
    }
    m = m_new;
    __syncthreads();  // this ring slot is free for reuse
  }
  cp_async_wait<0>();

  reinterpret_cast<float4*>(part_acc + part * kHD)[lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  if (lane == 0) {
    part_ml[part * 2] = m;
    part_ml[part * 2 + 1] = l;
  }
}

// Pass 2. Grid (B, H), kHD threads: merge the splits of one query head.
__global__ void paged_decode_combine(const float* __restrict__ part_acc,
                                     const float* __restrict__ part_ml, bf16* __restrict__ out,
                                     int H, int Hkv, int splits) {
  const int b = blockIdx.x;
  const int hq = blockIdx.y;
  const int G = H / Hkv;
  const int h = hq / G;
  const int g = hq % G;
  const int d = threadIdx.x;
  const size_t base = ((size_t)b * Hkv + h) * splits;  // split s is part (base + s) * G + g
  float m_max = kNegInf;
  for (int s = 0; s < splits; ++s) {
    const size_t part = (base + s) * G + g;
    if (part_ml[part * 2 + 1] > 0.f) m_max = fmaxf(m_max, part_ml[part * 2]);
  }
  float num = 0.f, den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t part = (base + s) * G + g;
    const float l = part_ml[part * 2 + 1];
    if (l > 0.f) {
      const float w = __expf(part_ml[part * 2] - m_max);
      num += w * part_acc[part * kHD + d];
      den += w * l;
    }
  }
  out[((size_t)b * H + hq) * kHD + d] = __float2bfloat16(num / den);
}

constexpr size_t kSplitSmem = 2 * kStages * (size_t)kBS * kHD * sizeof(bf16);  // 32 KB

}  // namespace

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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  paged_decode_split<<<dim3(B, Hkv, splits), 32 * (H / Hkv), kSplitSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(pos), layer, pa, pm, H, Hkv, NB, MB, blocks_per_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine<<<dim3(B, H), kHD, 0, st>>>(pa, pm, static_cast<bf16*>(out), H, Hkv,
                                                    splits);
  return (int)cudaGetLastError();
}

const char* lws_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
