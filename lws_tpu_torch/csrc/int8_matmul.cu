// W8A16 matrix product for Hopper (sm_90a): out = (x @ q^T) * scale.
//
// Replaces the Pallas TPU kernel lws_tpu/ops/int8_matmul.py:int8_matmul
// (body _kernel): x [M, D] bf16 times int8 weights with a per-output-channel
// f32 scale applied to the f32 accumulator, cast to bf16. The port keeps
// nn.Linear's layout, so q is [F, D] (one contiguous row of D int8 per output
// channel) and scale is [F]; M <= 256 on the serving path (decode products,
// the lm_head, and prefill products at buckets <= 256).
//
// What bounds it: at M <= 16 (decode, lm_head) the bytes of the weights: a
// product does 2*M operations per weight byte, far below the ~295 per byte
// at which the bf16 tensor cores would be the limit, so the kernel has to
// keep HBM streaming. At M = 128-256 it is near the ridge, and the tensor
// cores' issue rate and the shared-memory traffic of the operands bound it.
// Three bodies, chosen by the wrapper from M, one launch per product each:
//   * M <= 16 (`int8_matmul_small`): the operands are swapped, out^T [F, M] =
//     q [F, D] . x^T, so 16 output channels are the mma.sync.m16n8k16 M and
//     the (8 or 16) tokens its N, and no MMA row is padding. A CTA of 4 warps
//     owns 64 channels (16 per warp). The [64 x 128-byte] int8 tiles come by
//     TMA (one tensor-map copy per stage, issued by one thread, completing on
//     an mbarrier; 128-byte swizzled, zero past the edges) through a 4-stage
//     ring, about 24 KB in flight per CTA and 3-4 CTAs per SM, so no thread
//     spends registers or instructions on the weight stream; the small x tile
//     comes by cp.async beside it. Each warp reads its int8 fragment with
//     ldmatrix and converts it to bf16 in registers right before the MMA
//     (byte_perm into an f32 magic number: exact);
//   * 64 < M <= 256 (`int8_matmul_wg`, prefill buckets 128 and 256): the
//     same swap, with Hopper's warpgroup MMA. A CTA of two warpgroups owns
//     128 channels x 128 tokens; both tiles come by TMA through a 4-stage
//     ring, and each warpgroup converts its [64 x 16] int8 slice to bf16
//     registers, the A operand of wgmma.m64n128k16, whose B operand (the x
//     tile) the tensor cores read from shared memory. This cuts the operand
//     traffic through shared memory and the issue slots that mma.sync spent;
//   * 16 < M <= 64, and any M whose rows TMA cannot read (`int8_matmul_tc`):
//     a CTA of 4 warps owns 64 rows x 128 channels, each warp 64 rows x 32
//     channels, so each int8 value is converted once per row tile, with a
//     4-stage cp.async ring of 64-deep x and int8 tiles and mma.sync bf16
//     products;
//   * the two mma.sync bodies give each lane contiguous k (a product sums
//     over k, so the same permutation of k in both operands leaves it
//     unchanged): a lane's fragments are whole 8- or 16-byte shared loads,
//     not 2-byte gathers. wgmma fixes B's k order, so the wgmma body picks
//     its A bytes out of a 16-byte load with one byte_perm. The tiles are
//     padded or swizzled so these loads are free of bank conflicts;
//   * split-K inside the kernel: when there are too few output tiles to fill
//     the card, the grid splits D (at most 8 ways); each split writes its f32
//     partial, and the last CTA of an output tile to arrive (an atomic ticket
//     in a small counter buffer that the wrapper zeroes once and this kernel
//     resets) sums the partials in split order, applies the scale and casts.
//     The result is deterministic and needs no second kernel;
//   * ragged M, D and F are masked in the kernel (zero-filled tiles, guarded
//     stores); TMA and cp.async run where D and the pointers allow 16-byte
//     copies, else byte loads.
// The scale multiplies the f32 sum, as the Pallas kernel does; the JAX dequant
// path (models/quant.py:117) instead multiplies in bf16 after casting the
// scale to bf16. Warp specialisation and a persistent schedule are left for
// a later version.

#include <cuda.h>

#include "sm90_common.cuh"

namespace {

using namespace lws_sm90;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;   // the small body's CTA (the tensor-core body: 128 per 64 rows)
constexpr int kStages = 4;
constexpr int kSplitBatch = 8;  // partials in flight per thread in the split reduction

// M <= 16: 64 channels x 128 k per stage. The int8 rows are 128-byte
// swizzled (the 8 rows of an ldmatrix land on distinct banks) and the x rows
// padded to 288 bytes (the 4 rows of a half-warp's 8-byte loads do).
constexpr int kSmallBN = 64;
constexpr int kSmallBK = 128;
constexpr int kSmallXPitch = kSmallBK + 16;  // bf16
// 16 < M <= 64 (or rows TMA cannot read): 64 rows x 128 channels x 64 k per
// stage; x rows padded to 144 bytes, int8 rows (64 bytes) as they are.
constexpr int kTcBM = 64;
constexpr int kTcBN = 128;
constexpr int kTcBK = 64;
constexpr int kTcXPitch = kTcBK + 8;  // bf16

// 64 < M <= 256: 128 tokens x 128 channels x 64 k per stage, both by TMA.
constexpr int kWgBT = 128;
constexpr int kWgBN = 128;
constexpr int kWgBK = 64;
constexpr int kWgXStage = kWgBT * kWgBK * 2;  // bytes
constexpr int kWgWStage = kWgBN * kWgBK;      // bytes
constexpr size_t kWgSmem = 1024 + (size_t)kStages * (kWgXStage + kWgWStage + 8);

template <int MP>
constexpr size_t small_smem() {
  return 1024 + (size_t)kStages * (kSmallBN * kSmallBK + MP * kSmallXPitch * sizeof(bf16) + 8);
}
constexpr size_t kTcSmem = (size_t)kStages * (kTcBM * kTcXPitch * sizeof(bf16) + kTcBN * kTcBK);

// Rows [r0, r0 + ROWS) x k [kk, kk + BK) of the int8 weights into a tile with
// PITCH-byte rows (with SWZ, chunk c of row r at chunk c ^ (r & 7), the TMA's
// 128-byte swizzle). Zero past F and past k1 (the split's end).
template <int ROWS, int BK, int PITCH, bool SWZ = false>
__device__ __forceinline__ void load_w(int8_t* dst, const int8_t* __restrict__ q, int r0, int F,
                                       int D, int kk, int k1, bool vec) {
  constexpr int kChunks = BK / 16;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int n = r0 + r;
    const int k = kk + c * 16;
    int8_t* d = dst + r * PITCH + (SWZ ? c ^ (r & 7) : c) * 16;
    if (vec) {  // D % 16 == 0: a chunk is wholly inside or outside [0, k1)
      const bool ok = n < F && k < k1;
      cp_async16(d, ok ? q + (size_t)n * D + k : q, ok ? 16 : 0);
    } else {
      union { uint4 v; int8_t b[16]; } u;
#pragma unroll
      for (int e = 0; e < 16; ++e) u.b[e] = (n < F && k + e < k1) ? q[(size_t)n * D + k + e] : 0;
      *reinterpret_cast<uint4*>(d) = u.v;
    }
  }
}

// Rows [m0, m0 + ROWS) x k [kk, kk + BK) of x into a PITCH-pitched tile;
// zero past M and past k1.
template <int ROWS, int BK, int PITCH>
__device__ __forceinline__ void load_x(bf16* dst, const bf16* __restrict__ x, int m0, int M, int D,
                                       int kk, int k1, bool vec) {
  constexpr int kChunks = BK / 8;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = m0 + r;
    const int k = kk + c * 8;
    bf16* d = dst + r * PITCH + c * 8;
    if (vec) {  // D % 8 == 0
      const bool ok = row < M && k < k1;
      cp_async16(d, ok ? x + (size_t)row * D + k : x, ok ? 16 : 0);
    } else {
      union { uint4 v; uint16_t h[8]; } u;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        u.h[e] = (row < M && k + e < k1) ? __bfloat16_as_ushort(x[(size_t)row * D + k + e])
                                         : (uint16_t)0;
      *reinterpret_cast<uint4*>(d) = u.v;
    }
  }
}

// After every thread of a split CTA has written its f32 partial of the tile
// (rows [m0, m0 + ROWS), channels [n0, n0 + COLS)): take a ticket; the last
// split to arrive sums all partials in split order, scales, casts, and
// resets the counter for the next launch.
template <int ROWS, int COLS>
__device__ __forceinline__ void finish_split(const float* __restrict__ partial,
                                             const float* __restrict__ scale,
                                             bf16* __restrict__ out, int* counter, int M, int F,
                                             int m0, int n0, int splits) {
  __shared__ int last;
  __threadfence();  // this CTA's partials are visible device-wide before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Every split's loads of a group are issued before any is summed, and a
  // group is 4 channels (one 16-byte load) when F allows it.
  const size_t stride = (size_t)M * F;  // between two splits' partials
  constexpr int kGroups = ROWS * COLS / 4;
  if ((F & 3) == 0) {
    for (int gi = threadIdx.x; gi < kGroups; gi += blockDim.x) {
      const int r = m0 + gi / (COLS / 4);
      const int n = n0 + (gi % (COLS / 4)) * 4;
      if (r >= M || n >= F) continue;
      const float* p = partial + (size_t)r * F + n;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s0 = 0; s0 < splits; s0 += kSplitBatch) {
        float4 v[kSplitBatch];
#pragma unroll
        for (int s = 0; s < kSplitBatch; ++s)
          if (s0 + s < splits)
            v[s] = __ldcg(reinterpret_cast<const float4*>(p + (s0 + s) * stride));
#pragma unroll
        for (int s = 0; s < kSplitBatch; ++s) {
          if (s0 + s < splits) {
            a.x += v[s].x;
            a.y += v[s].y;
            a.z += v[s].z;
            a.w += v[s].w;
          }
        }
      }
      bf16* o = out + (size_t)r * F + n;
      *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16(a.x * scale[n], a.y * scale[n + 1]),
                                                pack_bf16(a.z * scale[n + 2], a.w * scale[n + 3]));
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * COLS; idx += blockDim.x) {
      const int r = m0 + idx / COLS;
      const int n = n0 + idx % COLS;
      if (r >= M || n >= F) continue;
      float a = 0.f;
      for (int s = 0; s < splits; ++s)
        a += __ldcg(partial + (size_t)s * stride + (size_t)r * F + n);
      out[(size_t)r * F + n] = __float2bfloat16(a * scale[n]);
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

// TMA copy of the box at (column c0, row c1) of the tensor `map` describes
// into shared memory (aligned as its swizzle needs); elements past the
// tensor's edges arrive as zeros. Completion counts against `bar`'s
// transactions.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// M <= 16 (MP = 8 or 16 token columns). Grid (F / 64, splits); split s
// covers D columns [s * k_chunk, min(D, (s + 1) * k_chunk)).
template <int MP>
__global__ void __launch_bounds__(kThreads, 4)
int8_matmul_small(const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ x,
           const int8_t* __restrict__ q, const float* __restrict__ scale, bf16* __restrict__ out,
           float* __restrict__ partial, int* __restrict__ counters, int M, int D, int F,
           int k_chunk, int vec_x, int vec_w) {
  constexpr int kNT = MP / 8;  // MMA n tiles (8 tokens each)
  constexpr int kWStage = kSmallBN * kSmallBK;  // bytes
  constexpr int kXStage = MP * kSmallXPitch;    // bf16 elements
  extern __shared__ __align__(128) unsigned char smem[];
  // The int8 slots first, 1024-byte aligned (the TMA's 128-byte swizzle
  // repeats every 8 rows of 128 bytes), then the x slots, then one mbarrier
  // per ring slot.
  int8_t* sW = reinterpret_cast<int8_t*>(smem + ((1024 - (smem_addr(smem) & 1023)) & 1023));
  bf16* sX = reinterpret_cast<bf16*>(sW + kStages * kWStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(sX + kStages * kXStage);

  const int n0 = blockIdx.x * kSmallBN;
  const int split = blockIdx.y;
  const int k0 = split * k_chunk;
  const int k1 = min(D, k0 + k_chunk);
  const int n_k = (k1 - k0 + kSmallBK - 1) / kSmallBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    fence_mbar_init();
  }
  __syncthreads();

  auto load_stage = [&](int slot, int kk) {
    int8_t* w = sW + slot * kWStage;
    if (vec_w) {
      if (threadIdx.x == 0) {
        fence_proxy_async();  // every warp's reads of this slot (before the barrier) come first
        mbar_arrive_expect_tx(&full[slot], kWStage);
        tma_load_2d(w, &wmap, kk, n0, &full[slot]);
      }
    } else {  // rows not 16-byte aligned: byte loads, and the slot's barrier just arrives
      load_w<kSmallBN, kSmallBK, kSmallBK, true>(w, q, n0, F, D, kk, k1, false);
      if (threadIdx.x == 0) mbar_arrive(&full[slot]);
    }
    load_x<MP, kSmallBK, kSmallXPitch>(sX + slot * kXStage, x, 0, M, D, kk, k1, vec_x);
  };

  float acc[2][kNT][4];  // two sets, alternating by k16 step, so MMAs do not wait on each other
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[p][j][0] = acc[p][j][1] = acc[p][j][2] = acc[p][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load_stage(s, k0 + s * kSmallBK);
    cp_async_commit();
  }
  // ldmatrix rows of this lane: channel rows of the warp's 16, 8 apart by matrix.
  const int lrow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  for (int i = 0; i < n_k; ++i) {
    const int slot = i % kStages;
    cp_async_wait<kStages - 2>();            // this thread's x copies of stage i
    mbar_wait(&full[slot], (i / kStages) & 1);  // the int8 tile of stage i
    __syncthreads();  // every thread's copies are in; every warp is done with stage i - 1's slot
    const int nxt = i + kStages - 1;
    if (nxt < n_k) load_stage(nxt % kStages, k0 + nxt * kSmallBK);
    cp_async_commit();
    const int8_t* w = sW + slot * kWStage;
    const bf16* xs = sX + slot * kXStage;
#pragma unroll
    for (int p = 0; p < kSmallBK / 32; ++p) {  // pairs of k16 steps
      uint32_t r[4];  // rows g and g + 8, bytes 4t..4t+3 of 16-byte chunks 2p and 2p + 1
      ldmatrix_x4(r, w + lrow * kSmallBK + (((2 * p + (lane >> 4)) ^ (lrow & 7)) * 16));
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // k16 step s = 2p + h: lane t holds k 16s + 4t .. +3
        const int s = 2 * p + h;
        uint32_t a[4];
        int8x4_to_bf16x4(r[2 * h], a[0], a[2]);
        int8x4_to_bf16x4(r[2 * h + 1], a[1], a[3]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const uint2 b = *reinterpret_cast<const uint2*>(xs + (j * 8 + g) * kSmallXPitch +
                                                          16 * s + 4 * t);
          mma_bf16(acc[h][j], a, b.x, b.y);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] += acc[1][j][e];

  // acc[j]: (channel n0 + wr, tokens 8j + 2t, +1) and (channel n0 + wr + 8, same tokens).
  const int wr = warp * 16 + g;
  const bool direct = gridDim.y == 1;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + wr + (e >> 1) * 8;
      const int r = j * 8 + 2 * t + (e & 1);
      if (r >= M || n >= F) continue;
      if (direct) {
        out[(size_t)r * F + n] = __float2bfloat16(acc[0][j][e] * scale[n]);
      } else {
        partial[((size_t)split * M + r) * F + n] = acc[0][j][e];
      }
    }
  }
  if (!direct)
    finish_split<MP, kSmallBN>(partial, scale, out, counters + blockIdx.x, M, F, 0, n0,
                               gridDim.y);
}

// 16 < M <= 256 where int8_matmul_wg does not run: a CTA of 4 warps per 64
// rows x 128 channels, each warp 64 rows x 32 channels. Grid (M / 64, F / 128,
// splits), rows fastest, so the CTAs that share a weight tile run together
// and read it from L2.
__global__ void __launch_bounds__(128, 3)
int8_matmul_tc(const bf16* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, bf16* __restrict__ out,
               float* __restrict__ partial, int* __restrict__ counters, int M, int D, int F,
               int k_chunk, int vec_x, int vec_w) {
  constexpr int kXStage = kTcBM * kTcXPitch;  // bf16 elements
  constexpr int kWStage = kTcBN * kTcBK;   // bytes
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);
  int8_t* sW = reinterpret_cast<int8_t*>(smem + kStages * kXStage * sizeof(bf16));

  const int m0 = blockIdx.x * kTcBM;
  const int n0 = blockIdx.y * kTcBN;
  const int split = blockIdx.z;
  const int k0 = split * k_chunk;
  const int k1 = min(D, k0 + k_chunk);
  const int n_k = (k1 - k0 + kTcBK - 1) / kTcBK;
  const int warp = threadIdx.x >> 5;  // this warp's 32 channels
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  auto load_stage = [&](int slot, int kk) {
    load_x<kTcBM, kTcBK, kTcXPitch>(sX + slot * kXStage, x, m0, M, D, kk, k1, vec_x);
    load_w<kTcBN, kTcBK, kTcBK>(sW + slot * kWStage, q, n0, F, D, kk, k1, vec_w);
  };

  float acc[4][4][4];  // [m tile of 16 rows][n tile of 8 channels][fragment]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load_stage(s, k0 + s * kTcBK);
    cp_async_commit();
  }
  for (int i = 0; i < n_k; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = i + kStages - 1;
    if (nxt < n_k) load_stage(nxt % kStages, k0 + nxt * kTcBK);
    cp_async_commit();
    const bf16* xs = sX + (i % kStages) * kXStage;
    const int8_t* w = sW + (i % kStages) * kWStage;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // lane t takes k [16t + 8h, +8) of the stage
      uint32_t b[4][2][2];  // [n tile][k16 step][b0, b1]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint2 wv = *reinterpret_cast<const uint2*>(
            w + (warp * 32 + j * 8 + g) * kTcBK + 16 * t + 8 * h);
        int8x4_to_bf16x4(wv.x, b[j][0][0], b[j][0][1]);
        int8x4_to_bf16x4(wv.y, b[j][1][0], b[j][1][1]);
      }
      uint32_t a[4][2][4];  // [m tile][k16 step][a0..a3]
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* xr = xs + (mt * 16 + g) * kTcXPitch + 16 * t + 8 * h;
        const uint4 ra = *reinterpret_cast<const uint4*>(xr);
        const uint4 rb = *reinterpret_cast<const uint4*>(xr + 8 * kTcXPitch);
        a[mt][0][0] = ra.x, a[mt][0][1] = rb.x, a[mt][0][2] = ra.y, a[mt][0][3] = rb.y;
        a[mt][1][0] = ra.z, a[mt][1][1] = rb.z, a[mt][1][2] = ra.w, a[mt][1][3] = rb.w;
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)  // 16 independent MMAs per k16 step
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a[mt][ks], b[j][ks][0], b[j][ks][1]);
    }
  }

  // acc[mt][j]: rows m0 + 16mt + g (+8), channels n0 + 32warp + 8j + 2t, +1.
  const bool direct = gridDim.z == 1;
  const bool pairs = (F & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + warp * 32 + j * 8 + 2 * t;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + mt * 16 + g + hr * 8;
        if (r >= M) continue;
        const float v0 = acc[mt][j][2 * hr], v1 = acc[mt][j][2 * hr + 1];
        if (direct) {
          bf16* o = out + (size_t)r * F + n;
          if (pairs && n + 1 < F) {
            *reinterpret_cast<uint32_t*>(o) = pack_bf16(v0 * scale[n], v1 * scale[n + 1]);
          } else {
            if (n < F) o[0] = __float2bfloat16(v0 * scale[n]);
            if (n + 1 < F) o[1] = __float2bfloat16(v1 * scale[n + 1]);
          }
        } else {
          float* p = partial + ((size_t)split * M + r) * F + n;
          if (n < F) p[0] = v0;
          if (n + 1 < F) p[1] = v1;
        }
      }
    }
  }
  if (!direct)
    finish_split<kTcBM, kTcBN>(partial, scale, out,
                               counters + blockIdx.y * gridDim.x + blockIdx.x, M, F, m0, n0,
                               gridDim.z);
}

// d[64] += A . B for one warpgroup: wgmma.m64n128k16, f32 accumulation. A
// is 4 bf16x2 registers per thread (each warp's 16 rows of the 64 x 16 tile,
// in the mma.m16n8k16 A layout); B (16 x 128) is read from shared memory
// through `desc`, K-major.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major tile whose rows are 128
// bytes, 128-byte swizzled (groups of 8 rows 1024 bytes apart).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// 64 < M <= 256 (`int8_matmul_wg`), both operands by TMA. A CTA is two
// warpgroups, 128 channels x 128 tokens: out^T tile = q tile . x^T, with
// wgmma.m64n128k16 (each warpgroup 64 channels, A from registers: the int8
// tile converted to bf16 right before the product; B the x tile, read by the
// tensor cores from shared memory). Grid (M / 128, F / 128, splits), tokens
// fastest. Stage: x [128 tokens x 64 k] bf16, 128-byte swizzled, and q
// [128 channels x 64 k] int8, 64-byte swizzled (16-byte chunk c of row r at
// c ^ ((r >> 1) & 3)), both by one thread, completing on the slot's mbarrier.
__global__ void __launch_bounds__(256, 2)
int8_matmul_wg(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ scale, bf16* __restrict__ out,
               float* __restrict__ partial, int* __restrict__ counters, int M, int D, int F,
               int k_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sX = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  int8_t* sW = reinterpret_cast<int8_t*>(sX + kStages * kWgXStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(sW + kStages * kWgWStage);

  const int t0 = blockIdx.x * kWgBT;
  const int n0 = blockIdx.y * kWgBN;
  const int split = blockIdx.z;
  const int k0 = split * k_chunk;
  const int n_k = (min(D, k0 + k_chunk) - k0 + kWgBK - 1) / kWgBK;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // This thread's two channel rows of the tile (8 apart, same 64-byte swizzle).
  const int r0 = (threadIdx.x >> 5) * 16 + g;
  const int swz = (r0 >> 1) & 3;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    fence_mbar_init();
  }
  __syncthreads();
  auto issue = [&](int stage) {  // thread 0
    const int slot = stage % kStages;
    fence_proxy_async();  // every warp's reads of this slot (before the barrier) come first
    mbar_arrive_expect_tx(&full[slot], kWgXStage + kWgWStage);
    tma_load_2d(sX + slot * kWgXStage, &xmap, k0 + stage * kWgBK, t0, &full[slot]);
    tma_load_2d(sW + slot * kWgWStage, &wmap, k0 + stage * kWgBK, n0, &full[slot]);
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages && s < n_k; ++s) issue(s);

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  // Bytes 2t, 2t+1 and 2t+8, 2t+9 of a 16-byte chunk: the A layout's k.
  const uint32_t b0 = 2 * (t & 1);
  const uint32_t sel = b0 | (b0 + 1) << 4 | (b0 + 4) << 8 | (b0 + 5) << 12;
  for (int i = 0; i < n_k; ++i) {
    const int slot = i % kStages;
    mbar_wait(&full[slot], (i / kStages) & 1);
    const int8_t* w = sW + slot * kWgWStage;
    uint32_t a[kWgBK / 16][4];
#pragma unroll
    for (int ks = 0; ks < kWgBK / 16; ++ks) {
      const uint4 v0 = *reinterpret_cast<const uint4*>(w + r0 * kWgBK + ((ks ^ swz) * 16));
      const uint4 v1 = *reinterpret_cast<const uint4*>(w + (r0 + 8) * kWgBK + ((ks ^ swz) * 16));
      int8x4_to_bf16x4(__byte_perm(t < 2 ? v0.x : v0.y, t < 2 ? v0.z : v0.w, sel), a[ks][0],
                       a[ks][2]);
      int8x4_to_bf16x4(__byte_perm(t < 2 ? v1.x : v1.y, t < 2 ? v1.z : v1.w, sel), a[ks][1],
                       a[ks][3]);
    }
    const unsigned char* xs = sX + slot * kWgXStage;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kWgBK / 16; ++ks) wgmma_m64n128k16(acc, a[ks], sw128_desc(xs + ks * 32));
    wgmma_commit();
    wgmma_wait_all();
    __syncthreads();  // every warpgroup is done with this slot
    if (threadIdx.x == 0 && i + kStages < n_k) issue(i + kStages);
  }

  // acc[4j + e]: channel n0 + r0 (+8 for e >= 2), token t0 + 8j + 2t + (e & 1).
  const bool direct = gridDim.z == 1;
#pragma unroll
  for (int j = 0; j < kWgBT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + r0 + (e >> 1) * 8;
      const int r = t0 + j * 8 + 2 * t + (e & 1);
      if (r >= M || n >= F) continue;
      if (direct) {
        out[(size_t)r * F + n] = __float2bfloat16(acc[4 * j + e] * scale[n]);
      } else {
        partial[((size_t)split * M + r) * F + n] = acc[4 * j + e];
      }
    }
  }
  if (!direct)
    finish_split<kWgBT, kWgBN>(partial, scale, out, counters + blockIdx.y * gridDim.x + blockIdx.x,
                               M, F, t0, n0, gridDim.z);
}

// Allow the kernel `smem` bytes of dynamic shared memory (once: the
// attribute holds for the process, and a host call per launch would cost
// host time on the eager decode path), then launch it.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, bool& ready, dim3 grid, int threads, size_t smem,
                   cudaStream_t st, Args... args) {
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}
bool g_small8_ready = false, g_small16_ready = false, g_tc_ready = false, g_wg_ready = false;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A row-major [rows, cols] matrix of `elem`-byte values as a TMA tensor of
// [box_rows x box_cols] boxes with the given swizzle, zero past the edges.
// The encoder lives in libcuda; it is looked up once through the CUDA
// runtime, so the library links only the runtime.
cudaError_t tensor_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
                       int cols, int rows, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};  // bytes between rows
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [M,D] bf16, q [F,D] int8, scale [F] f32, out [M,F] bf16, all contiguous
// on the current device. bm picks the body: 8 or 16 (M <= bm: the swapped
// small body), 64 (the mma.sync body) or 128 (the wgmma body, which needs
// vec_x and vec_w). With splits > 1: partial is f32 [splits*M*F] scratch and
// counters one zeroed int per output tile (F tiles for bm 8/16, M tiles x F
// tiles otherwise), which the kernel leaves zeroed, and which no launch
// that may run at the same time (another stream's) shares; both may be null
// otherwise. splits * k_chunk >= D, with k_chunk a multiple of 128 (bm 8/16)
// or 64. vec_x / vec_w: x rows (D % 8 == 0) and q rows (D % 16 == 0) and
// both pointers are 16-byte aligned. Returns the first cudaError_t.
int lws_int8_matmul(const void* x, const void* q, const void* scale, void* out, void* partial,
                    void* counters, int M, int D, int F, int bm, int splits, int k_chunk,
                    int vec_x, int vec_w, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  bf16* op = static_cast<bf16*>(out);
  float* pp = static_cast<float*>(partial);
  int* cp = static_cast<int*>(counters);
  cudaError_t err;
  if (bm == 8 || bm == 16) {
    CUtensorMap map{};  // unused (zero) when the rows take byte loads
    if (vec_w && (err = tensor_map(&map, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, F, kSmallBK,
                                   kSmallBN, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
      return (int)err;
    const dim3 grid((F + kSmallBN - 1) / kSmallBN, splits);
    return (int)(bm == 8 ? launch(int8_matmul_small<8>, g_small8_ready, grid, kThreads,
                                  small_smem<8>(), st, map, xp, qp, sp, op, pp, cp, M, D, F,
                                  k_chunk, vec_x, vec_w)
                         : launch(int8_matmul_small<16>, g_small16_ready, grid, kThreads,
                                  small_smem<16>(), st, map, xp, qp, sp, op, pp, cp, M, D, F,
                                  k_chunk, vec_x, vec_w));
  }
  if (bm == kTcBM) {
    const dim3 grid((M + kTcBM - 1) / kTcBM, (F + kTcBN - 1) / kTcBN, splits);
    return (int)launch(int8_matmul_tc, g_tc_ready, grid, 128, kTcSmem, st, xp, qp, sp, op, pp,
                       cp, M, D, F, k_chunk, vec_x, vec_w);
  }
  if (bm == kWgBT && vec_x && vec_w) {
    CUtensorMap xmap, wmap;
    if ((err = tensor_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, M, kWgBK, kWgBT,
                          CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
        (err = tensor_map(&wmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, F, kWgBK, kWgBN,
                          CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess)
      return (int)err;
    const dim3 grid((M + kWgBT - 1) / kWgBT, (F + kWgBN - 1) / kWgBN, splits);
    return (int)launch(int8_matmul_wg, g_wg_ready, grid, 256, kWgSmem, st, xmap, wmap, sp, op, pp,
                       cp, M, D, F, k_chunk);
  }
  return (int)cudaErrorInvalidValue;
}

const char* lws_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
