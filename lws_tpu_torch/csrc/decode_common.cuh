// Shared pieces of the decode-attention kernels (one query token per slot):
// the split pass and the split-combining pass. Included by
// paged_attention.cu (block-pool addressing, bf16 and int8 pools) and
// int8_attention.cu (dense-cache addressing); each stays its own library
// with its own C entry points. ops/_ext.py hashes this header into both
// libraries' build digests.
//
// The split pass (decode_split) is one template over the K/V element type
// (`Elem`: Bf16Rows, or Int8Rows with per-(token, kv head) f32 scales) and
// the addressing (`Addr`):
//   * one CTA per (slot, kv head, split of `blocks_per_split` 16-token
//     blocks); the G = H/Hkv query heads are one warp each and share every
//     block, staged in shared memory by cp.async (kStages blocks in flight):
//     the K and V rows of the block (16 x 128 elements each, 16-byte copies)
//     and, for int8, their 16 + 16 scales (4-byte copies: the scales of one
//     head are strided by Hkv, never one 16-byte chunk);
//   * lane l holds q[4l .. 4l+3] in f32 and reads 4 elements of each row;
//     the block's 16 dot products reduce by interleaved butterflies, so the
//     warp pays shuffle throughput, not 16 x 5 shuffle latencies. An int8 K
//     scale multiplies the reduced sum and the V scale the probability, so
//     the dequantized value k * scale is never formed, but the result equals
//     attention over it in exact arithmetic;
//   * online softmax in f32 (running max m, sum l, a 4-wide accumulator per
//     lane); (acc, m, l) per split go to the combine pass.
// `Addr` says where a block's 16 token rows start: through the block table
// (PagedAddr) or at b*T + 16*j of a dense cache (DenseAddr, whose last block
// may be partial: the missing rows are zero-filled, never read).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace lws_decode {

using lws_sm90::cp_async16;
using lws_sm90::cp_async4;
using lws_sm90::cp_async_commit;
using lws_sm90::cp_async_wait;

typedef __nv_bfloat16 bf16;

constexpr int kHD = 128;     // head dim (the flagship's; checked by the wrappers)
constexpr int kBS = 16;      // tokens per block (the engine's pool block size)
constexpr int kStages = 4;   // blocks in flight per CTA
constexpr float kNegInf = -1e30f;

// bf16 K/V rows, used as stored.
struct Bf16Rows {
  typedef bf16 T;
  static constexpr bool kScaled = false;
  __device__ static __forceinline__ void load4(const T* p, float (&o)[4]) {
    const __nv_bfloat162* r = reinterpret_cast<const __nv_bfloat162*>(p);
    const float2 a = __bfloat1622float2(r[0]);
    const float2 b = __bfloat1622float2(r[1]);
    o[0] = a.x;
    o[1] = a.y;
    o[2] = b.x;
    o[3] = b.y;
  }
};

// int8 K/V rows with one f32 scale per (token, kv head).
struct Int8Rows {
  typedef int8_t T;
  static constexpr bool kScaled = true;
  __device__ static __forceinline__ void load4(const T* p, float (&o)[4]) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    o[0] = (float)c.x;
    o[1] = (float)c.y;
    o[2] = (float)c.z;
    o[3] = (float)c.w;
  }
};

// Block j of slot b lives at pool block table[b, j] of `layer` (an entry
// outside [0, NB) reads the null block 0).
struct PagedAddr {
  const int* table;
  int MB;
  int NB;
  int layer;
  __device__ __forceinline__ int n_blocks() const { return MB; }
  __device__ __forceinline__ int last_pos() const { return 0x7fffffff; }
  __device__ __forceinline__ size_t first_token(int b, int j) const {
    int blk = table[(size_t)b * MB + j];
    blk = (blk >= 0 && blk < NB) ? blk : 0;
    return ((size_t)layer * NB + blk) * kBS;
  }
  __device__ __forceinline__ int rows(int /*j*/) const { return kBS; }
};

// Block j of slot b is tokens [16j, 16j + 16) of row b of a dense [B, T]
// cache; positions past T - 1 attend every key.
struct DenseAddr {
  int T;
  __device__ __forceinline__ int n_blocks() const { return (T + kBS - 1) / kBS; }
  __device__ __forceinline__ int last_pos() const { return T - 1; }
  __device__ __forceinline__ size_t first_token(int b, int j) const {
    return (size_t)b * T + (size_t)j * kBS;
  }
  __device__ __forceinline__ int rows(int j) const { return min(kBS, T - j * kBS); }
};

// Split pass. Grid (B, Hkv, splits), 32*G threads. Values are
// [tokens, Hkv, 128] Elem::T and (int8 only) scales [tokens, Hkv] f32 with
// tokens indexed as Addr says; pos is [B] int32, or null with every slot at
// pos_all. part_acc [B,Hkv,splits,G,128] and part_ml [B,Hkv,splits,G,2] in
// f32.
template <class Elem, class Addr>
__global__ void decode_split(const bf16* __restrict__ q, const typename Elem::T* __restrict__ k,
                             const float* __restrict__ k_scale,
                             const typename Elem::T* __restrict__ v,
                             const float* __restrict__ v_scale, Addr addr,
                             const int* __restrict__ pos, int pos_all,
                             float* __restrict__ part_acc, float* __restrict__ part_ml, int H,
                             int Hkv, int blocks_per_split, float scale) {
  typedef typename Elem::T T;
  constexpr int kTile = kBS * kHD;             // elements of one block's rows for one kv head
  constexpr int kChunk = 16 / sizeof(T);       // elements per 16-byte copy
  constexpr int kScales = Elem::kScaled ? kBS : 1;
  __shared__ __align__(16) T sK[kStages][kTile];
  __shared__ __align__(16) T sV[kStages][kTile];
  __shared__ float sKs[kStages][kScales];
  __shared__ float sVs[kStages][kScales];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int p = min(pos != nullptr ? pos[b] : pos_all, addr.last_pos());
  const int n_live = min(p / kBS + 1, addr.n_blocks());
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
  Bf16Rows::load4(q + ((size_t)b * H + hq) * kHD + lane * 4, qv);
#pragma unroll
  for (int i = 0; i < 4; ++i) qv[i] *= scale;
  const size_t tok_stride = (size_t)Hkv * kHD;  // elements between token rows

  // Stage block j (if in this split's live range) into ring slot
  // (j - j0) % kStages; always commits a group so the wait count is uniform.
  auto issue = [&](int j) {
    if (j < j1) {
      const size_t t0 = addr.first_token(b, j);
      const int n_rows = addr.rows(j);
      const int s = (j - j0) % kStages;
      for (int i = tid; i < kBS * (kHD / kChunk); i += nthreads) {
        const int t = i / (kHD / kChunk);
        const int c = (i % (kHD / kChunk)) * kChunk;
        if (t < n_rows) {
          const size_t off = (t0 + t) * tok_stride + (size_t)h * kHD + c;
          cp_async16(&sK[s][t * kHD + c], k + off);
          cp_async16(&sV[s][t * kHD + c], v + off);
        } else {
          *reinterpret_cast<int4*>(&sK[s][t * kHD + c]) = make_int4(0, 0, 0, 0);
          *reinterpret_cast<int4*>(&sV[s][t * kHD + c]) = make_int4(0, 0, 0, 0);
        }
      }
      if constexpr (Elem::kScaled) {
        if (tid < 2 * kBS) {
          const int t = tid % kBS;
          float* dst = tid < kBS ? &sKs[s][t] : &sVs[s][t];
          const float* src = tid < kBS ? k_scale : v_scale;
          if (t < n_rows) {
            cp_async4(dst, src + (t0 + t) * Hkv + h);
          } else {
            *dst = 0.f;
          }
        }
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
    const int s = (j - j0) % kStages;
    const int n_tok = min(kBS, p - j * kBS + 1);  // tokens <= pos in this block

    float sc[kBS];
#pragma unroll
    for (int t = 0; t < kBS; ++t) {
      float kf[4];
      Elem::load4(&sK[s][t * kHD + lane * 4], kf);
      sc[t] = qv[0] * kf[0] + qv[1] * kf[1] + qv[2] * kf[2] + qv[3] * kf[3];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < kBS; ++t) sc[t] += __shfl_xor_sync(0xffffffffu, sc[t], off);
    }
    float blk_max = kNegInf;
#pragma unroll
    for (int t = 0; t < kBS; ++t) {
      if constexpr (Elem::kScaled) sc[t] *= sKs[s][t];
      sc[t] = t < n_tok ? sc[t] : kNegInf;
      blk_max = fmaxf(blk_max, sc[t]);
    }
    const float m_new = fmaxf(m, blk_max);
    const float alpha = __expf(m - m_new);  // first block: exp(-1e30 - m) = 0
    l *= alpha;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= alpha;
#pragma unroll
    for (int t = 0; t < kBS; ++t) {
      if (t < n_tok) {
        const float pt = __expf(sc[t] - m_new);
        l += pt;
        float w = pt;
        if constexpr (Elem::kScaled) w *= sVs[s][t];
        float vf[4];
        Elem::load4(&sV[s][t * kHD + lane * 4], vf);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += w * vf[i];
      }
    }
    m = m_new;
    __syncthreads();  // this ring slot is free for reuse
  }
  cp_async_wait<0>();

  reinterpret_cast<float4*>(part_acc + part * kHD)[lane] =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  if (lane == 0) {
    part_ml[part * 2] = m;
    part_ml[part * 2 + 1] = l;
  }
}

// Combine pass. Grid (B, H), kHD threads: merge the splits of one query head
// with weights exp(m_s - max m); splits with l = 0 held nothing live.
__global__ void decode_combine(const float* __restrict__ part_acc,
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

// Launch both passes on `stream` (k_scale/v_scale are ignored for
// Bf16Rows); returns the first cudaError_t.
template <class Elem, class Addr>
int launch_decode(const void* q, const void* k, const void* k_scale, const void* v,
                  const void* v_scale, Addr addr, const void* pos, int pos_all, void* out,
                  void* part_acc, void* part_ml, int B, int H, int Hkv, int splits,
                  int blocks_per_split, float scale, void* stream) {
  typedef typename Elem::T T;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  decode_split<Elem, Addr><<<dim3(B, Hkv, splits), 32 * (H / Hkv), 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k), static_cast<const float*>(k_scale),
      static_cast<const T*>(v), static_cast<const float*>(v_scale), addr,
      static_cast<const int*>(pos), pos_all, pa, pm, H, Hkv, blocks_per_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<<<dim3(B, H), kHD, 0, st>>>(pa, pm, static_cast<bf16*>(out), H, Hkv, splits);
  return (int)cudaGetLastError();
}

}  // namespace lws_decode
