// Causal (or full) grouped-query flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lws_tpu/ops/attention.py:flash_attention
// (body _flash_kernel): q [B,S,H,D], k/v [B,Skv,Hkv,D] in bf16 -> o [B,S,H,D]
// in bf16, online softmax in f32, the [S, Skv] score matrix never written to
// device memory. Query head h reads kv head h / (H / Hkv).
//
// What bounds it: at prefill lengths (S >= 128) the work is operations
// (4*S*Skv*D per head, halved by causality) against a few MB of input, so
// the tensor cores are the limit. This first version feeds them with WMMA
// bf16 16x16x16 fragments (f32 accumulation) from shared-memory tiles:
//   * one CTA of 4 warps per (q tile of 64 rows, head, batch); each warp owns
//     16 query rows;
//   * per 64-key tile: S = Q.K^T (WMMA) -> shared f32 scores -> masked online
//     softmax in f32 (2 lanes per row) -> P in bf16 -> O += P.V (WMMA), with O
//     kept as an f32 tile in shared memory so the per-row rescale by
//     exp(m_old - m_new) is plain scalar code;
//   * causal CTAs stop at the tile holding their last query row (the
//     diagonal), as the Pallas kernel's `upper` bound does;
//   * keys >= Skv and (causal) keys after the query are masked to -1e30, so
//     ragged S/Skv need no padding in device memory; query rows >= S are
//     computed on zero rows and never stored.
// The softmax scale D**-0.5 multiplies the f32 product q.k, which equals
// the Pallas kernel's (q * scale).k in exact arithmetic and keeps q exact as
// a bf16 MMA operand. wgmma, TMA and warp specialisation are left for a later
// version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kD = 128;        // head dim (the flagship's; checked by the wrapper)
constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLdQ = kD + 8;   // bf16 pitch of the Q/K/V tiles (pads off bank conflicts)
constexpr int kLdS = kBK + 4;  // f32 pitch of the score tile
constexpr int kLdP = kBK + 8;  // bf16 pitch of the probability tile
constexpr int kLdO = kD + 4;   // f32 pitch of the output accumulator
constexpr float kNegInf = -1e30f;

constexpr size_t kOffQ = 0;
constexpr size_t kOffK = kOffQ + sizeof(bf16) * kBQ * kLdQ;
constexpr size_t kOffV = kOffK + sizeof(bf16) * kBK * kLdQ;
constexpr size_t kOffS = kOffV + sizeof(bf16) * kBK * kLdQ;
constexpr size_t kOffP = kOffS + sizeof(float) * kBQ * kLdS;
constexpr size_t kOffO = kOffP + sizeof(bf16) * kBQ * kLdP;
constexpr size_t kOffM = kOffO + sizeof(float) * kBQ * kLdO;
constexpr size_t kOffL = kOffM + sizeof(float) * kBQ;
constexpr size_t kSmemBytes = kOffL + sizeof(float) * kBQ;

// Rows [row0, row0 + nrows) of a [rows_valid, kD] matrix whose rows are
// `row_stride` elements apart, into a kLdQ-pitched tile; rows past
// rows_valid read as zeros. 16-byte vector loads.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int nrows,
                                          size_t row_stride, int rows_valid) {
  constexpr int kVecs = kD / 8;
  for (int i = threadIdx.x; i < nrows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows_valid) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLdQ + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int S, int Skv,
                 int H, int Hkv, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + kOffQ);
  bf16* sK = reinterpret_cast<bf16*>(smem + kOffK);
  bf16* sV = reinterpret_cast<bf16*>(smem + kOffV);
  float* sS = reinterpret_cast<float*>(smem + kOffS);
  bf16* sP = reinterpret_cast<bf16*>(smem + kOffP);
  float* sO = reinterpret_cast<float*>(smem + kOffO);
  float* sM = reinterpret_cast<float*>(smem + kOffM);
  float* sL = reinterpret_cast<float*>(smem + kOffL);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const bf16* qb = q + ((size_t)b * S * H + h) * kD;       // row s at qb + s*H*kD
  const bf16* kb = k + ((size_t)b * Skv * Hkv + hk) * kD;  // row s at kb + s*Hkv*kD
  const bf16* vb = v + ((size_t)b * Skv * Hkv + hk) * kD;

  load_tile(sQ, qb, q0, kBQ, (size_t)H * kD, S);
  for (int i = tid; i < kBQ * kLdO; i += kThreads) sO[i] = 0.f;
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;  // last real query row of this tile
  int n_tiles = (Skv + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, q_last / kBK + 1);  // stop at the diagonal

  float* sSw = sS + warp * 16 * kLdS;
  bf16* sPw = sP + warp * 16 * kLdP;
  float* sOw = sO + warp * 16 * kLdO;
  const bf16* sQw = sQ + warp * 16 * kLdQ;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile (and Q/O init)
    load_tile(sK, kb, k0, kBK, (size_t)Hkv * kD, Skv);
    load_tile(sV, vb, k0, kBK, (size_t)Hkv * kD, Skv);
    __syncthreads();

    // Scores for this warp's 16 rows: [16, kBK] = Q_w [16, kD] . K^T [kD, kBK].
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBK / 16];
#pragma unroll
      for (int n = 0; n < kBK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < kD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQw + kk, kLdQ);
#pragma unroll
        for (int n = 0; n < kBK / 16; ++n) {
          // K stored [key][d] row-major is K^T [d][key] column-major.
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, sK + n * 16 * kLdQ + kk, kLdQ);
          wmma::mma_sync(acc[n], a, bk, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < kBK / 16; ++n) {
        wmma::store_matrix_sync(sSw + n * 16, acc[n], kLdS, wmma::mem_row_major);
      }
    }
    __syncwarp();

    // Masked online softmax, two lanes per row (each takes half the keys).
    {
      const int r = lane >> 1;
      const int half = lane & 1;
      const int row = warp * 16 + r;
      const int qpos = q0 + row;
      float* srow = sSw + r * kLdS;
      float mx = kNegInf;
      for (int c = half * (kBK / 2); c < (half + 1) * (kBK / 2); ++c) {
        const int kpos = k0 + c;
        const bool ok = kpos < Skv && (!causal || kpos <= qpos);
        const float s = ok ? srow[c] * scale : kNegInf;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = __expf(m_old - m_new);  // first tile: exp(-1e30 - m) = 0
      float sum = 0.f;
      bf16* prow = sPw + r * kLdP;
      for (int c = half * (kBK / 2); c < (half + 1) * (kBK / 2); ++c) {
        const bf16 p = __float2bfloat16(__expf(srow[c] - m_new));
        prow[c] = p;
        sum += __bfloat162float(p);  // the denominator sums what P.V multiplies
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      float* orow = sOw + r * kLdO;
      for (int c = half * (kD / 2); c < (half + 1) * (kD / 2); ++c) orow[c] *= alpha;
      if (half == 0) {
        sM[row] = m_new;
        sL[row] = sL[row] * alpha + sum;
      }
    }
    __syncwarp();

    // O_w [16, kD] += P_w [16, kBK] . V [kBK, kD].
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kD / 16];
#pragma unroll
      for (int n = 0; n < kD / 16; ++n) {
        wmma::load_matrix_sync(acc[n], sOw + n * 16, kLdO, wmma::mem_row_major);
      }
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sPw + kk, kLdP);
#pragma unroll
        for (int n = 0; n < kD / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(bv, sV + kk * kLdQ + n * 16, kLdQ);
          wmma::mma_sync(acc[n], a, bv, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < kD / 16; ++n) {
        wmma::store_matrix_sync(sOw + n * 16, acc[n], kLdO, wmma::mem_row_major);
      }
    }
    __syncwarp();
  }

  // Epilogue: this warp's rows, O / l, as bf16, 8 values per store.
  constexpr int kVecs = kD / 8;
  for (int i = lane; i < 16 * kVecs; i += 32) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    const int row = warp * 16 + r;
    if (q0 + row >= S) continue;
    const float inv = 1.f / sL[row];
    const float* orow = sOw + r * kLdO + c;
    __align__(16) bf16 out8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) out8[e] = __float2bfloat16(orow[e] * inv);
    *reinterpret_cast<uint4*>(o + ((size_t)(b * S + q0 + row) * H + h) * kD + c) =
        *reinterpret_cast<const uint4*>(out8);
  }
}

}  // namespace

extern "C" {

// q [B,S,H,128], k/v [B,Skv,Hkv,128], o [B,S,H,128]: contiguous bf16 on the
// current device. Returns the cudaError_t of the launch.
int lws_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                            int S, int Skv, int H, int Hkv, int causal, float scale,
                            void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, Skv, H, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

const char* lws_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
