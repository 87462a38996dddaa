// W8A16 matrix product for Hopper (sm_90a): out = (x @ q^T) * scale.
//
// Replaces the Pallas TPU kernel lws_tpu/ops/int8_matmul.py:int8_matmul
// (body _kernel): x [M, D] bf16 times int8 weights with a per-output-channel
// f32 scale applied to the f32 accumulator, cast to bf16. The port keeps
// nn.Linear's layout, so q is [F, D] (one contiguous row of D int8 per output
// channel) and scale is [F]; M <= 256 on the serving path (decode products,
// the lm_head, and prefill products at buckets <= 256).
//
// What bounds it: the bytes of the weights. At M = 8 a product reads D*F
// int8 bytes and does 2*M*D*F operations, 16 per weight byte, far below the
// ~295 per byte at which the bf16 tensor cores would be the limit: one decode
// step's products (about 7.5 GB of int8) take at least 2.2 ms at 3.35 TB/s.
// Even at M = 256 (512 operations per byte) the work is close to the ridge.
// This first version is right and simple:
//   * one CTA of 4 warps per (tile of BM rows, tile of 64 output channels,
//     split of D). The int8 tile [64, 128] is read with 16-byte loads into
//     registers one stage ahead, converted to bf16 in registers (every int8
//     value is exact in bf16) and stored to shared memory; the x tile
//     [BM, 128] likewise (x is small and stays in L2);
//   * WMMA bf16 16x16x16 fragments with f32 accumulation; each warp owns 16
//     output channels and all BM rows (BM = 16 for M <= 16, else 64);
//   * the grid is ordered rows-fastest, so the CTAs that share a weight tile
//     run together and read it from L2, and split over D when there are too
//     few channel tiles to fill the card ((4096, 1024) has 16): each split
//     writes f32 partials and a second pass sums them, applies the scale and
//     casts. With one split the first pass does that itself;
//   * ragged M, D and F are masked in the kernel (zero-filled tiles, guarded
//     stores); the 16-byte loads run where D allows them, else byte loads.
// The scale multiplies the f32 sum, as the Pallas kernel does; the JAX dequant
// path (models/quant.py:117) instead multiplies in bf16 after casting the
// scale to bf16. wgmma, TMA and a persistent schedule are left for a later
// version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kBN = 64;           // output channels per CTA (4 warps x 16)
constexpr int kBK = 128;          // contraction depth per stage
constexpr int kLd = kBK + 8;      // bf16 pitch of the shared tiles (pads off bank conflicts)
constexpr int kLdC = kBN + 4;     // f32 pitch of the epilogue tile
constexpr int kThreads = 128;
constexpr int kWChunks = kBN * kBK / 16 / kThreads;  // 16-byte int8 chunks per thread

template <int BM>
struct __align__(128) Tiles {  // bf16 as raw bits (a trivially constructible __shared__)
  uint16_t x[BM][kLd];
  uint16_t w[kBN][kLd];
};

union Chunk {  // 16 bytes: 16 int8 or 8 bf16 (as raw bits)
  uint4 v;
  int8_t b[16];
  uint16_t h[8];
};

// Grid (M tiles, F tiles, splits). Split s covers D columns
// [s * k_chunk, min(D, (s + 1) * k_chunk)), k_chunk a multiple of kBK.
// vec_x / vec_w: 16-byte loads are aligned (D % 8 == 0 and x 16-byte aligned;
// D % 16 == 0 and q 16-byte aligned).
template <int BM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, bf16* __restrict__ out,
                   float* __restrict__ partial, int M, int D, int F, int k_chunk, int vec_x,
                   int vec_w) {
  constexpr int kXChunks = BM * kBK / 8 / kThreads;  // 16-byte bf16 chunks per thread
  __shared__ Tiles<BM> s;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int split = blockIdx.z;
  const int k0 = split * k_chunk;
  const int k1 = min(D, k0 + k_chunk);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  Chunk wr[kWChunks];
  Chunk xr[kXChunks];
  // Load stage kk of the weight and x tiles into registers (zero past the
  // ragged edges).
  auto load = [&](int kk) {
    const bool full = kk + kBK <= k1;
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / (kBK / 16);
      const int col = (c % (kBK / 16)) * 16;
      const int n = n0 + row;
      const int k = kk + col;
      if (n < F && full && vec_w) {
        wr[i].v = __ldg(reinterpret_cast<const uint4*>(q + (size_t)n * D + k));
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          wr[i].b[e] = (n < F && k + e < k1) ? q[(size_t)n * D + k + e] : (int8_t)0;
      }
    }
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / (kBK / 8);
      const int col = (c % (kBK / 8)) * 8;
      const int r = m0 + row;
      const int k = kk + col;
      if (r < M && full && vec_x) {
        xr[i].v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * D + k));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          xr[i].h[e] = (r < M && k + e < k1) ? __bfloat16_as_ushort(x[(size_t)r * D + k + e])
                                             : (uint16_t)0;
      }
    }
  };
  // Registers -> shared tiles, int8 converted to bf16 on the way.
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / (kBK / 16);
      const int col = (c % (kBK / 16)) * 16;
      Chunk lo, hi;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        lo.h[e] = __bfloat16_as_ushort(__float2bfloat16((float)wr[i].b[e]));
        hi.h[e] = __bfloat16_as_ushort(__float2bfloat16((float)wr[i].b[8 + e]));
      }
      uint4* dst = reinterpret_cast<uint4*>(&s.w[row][col]);
      dst[0] = lo.v;
      dst[1] = hi.v;
    }
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / (kBK / 8);
      const int col = (c % (kBK / 8)) * 8;
      *reinterpret_cast<uint4*>(&s.x[row][col]) = xr[i].v;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BM / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) wmma::fill_fragment(acc[i], 0.f);

  load(k0);
  for (int kk = k0; kk < k1; kk += kBK) {
    store();
    __syncthreads();
    if (kk + kBK < k1) load(kk + kBK);  // next stage's loads fly during the MMAs
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
      wmma::load_matrix_sync(bf, reinterpret_cast<const bf16*>(&s.w[warp * 16][ks * 16]),
                             kLd);
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, reinterpret_cast<const bf16*>(&s.x[i * 16][ks * 16]),
                               kLd);
        wmma::mma_sync(acc[i], af, bf, acc[i]);
      }
    }
    __syncthreads();  // tiles free for the next stage
  }

  // Epilogue through shared memory (the tiles are free): [BM][kBN] f32.
  float* c_tile = reinterpret_cast<float*>(&s);
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
    wmma::store_matrix_sync(c_tile + (i * 16) * kLdC + warp * 16, acc[i], kLdC,
                            wmma::mem_row_major);
  __syncthreads();
  const bool direct = gridDim.z == 1;
  for (int idx = tid; idx < BM * kBN; idx += kThreads) {
    const int r = m0 + idx / kBN;
    const int n = n0 + idx % kBN;
    if (r < M && n < F) {
      const float a = c_tile[(idx / kBN) * kLdC + idx % kBN];
      if (direct) {
        out[(size_t)r * F + n] = __float2bfloat16(a * scale[n]);
      } else {
        partial[((size_t)split * M + r) * F + n] = a;
      }
    }
  }
}

// Sum the splits' partials, apply the scale, cast.
__global__ void int8_matmul_combine(const float* __restrict__ partial,
                                    const float* __restrict__ scale, bf16* __restrict__ out,
                                    int M, int F, int splits) {
  const size_t total = (size_t)M * F;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s) a += partial[(size_t)s * total + i];
    out[i] = __float2bfloat16(a * scale[i % F]);
  }
}

static_assert(sizeof(Tiles<16>) >= 16 * kLdC * sizeof(float), "epilogue tile fits");
static_assert(sizeof(Tiles<64>) >= 64 * kLdC * sizeof(float), "epilogue tile fits");

}  // namespace

extern "C" {

// x [M,D] bf16, q [F,D] int8, scale [F] f32, out [M,F] bf16, all contiguous
// on the current device; partial f32 [splits*M*F] scratch when splits > 1
// (may be null otherwise); bm is 16 or 64; splits * k_chunk >= D with k_chunk
// a multiple of 128. Returns the first cudaError_t.
int lws_int8_matmul(const void* x, const void* q, const void* scale, void* out, void* partial,
                    int M, int D, int F, int bm, int splits, int k_chunk, int vec_x, int vec_w,
                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + bm - 1) / bm, (F + kBN - 1) / kBN, splits);
  const bf16* xp = static_cast<const bf16*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  bf16* op = static_cast<bf16*>(out);
  float* pp = static_cast<float*>(partial);
  if (bm == 16) {
    int8_matmul_kernel<16><<<grid, kThreads, 0, st>>>(xp, qp, sp, op, pp, M, D, F, k_chunk,
                                                      vec_x, vec_w);
  } else if (bm == 64) {
    int8_matmul_kernel<64><<<grid, kThreads, 0, st>>>(xp, qp, sp, op, pp, M, D, F, k_chunk,
                                                      vec_x, vec_w);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t total = (size_t)M * F;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  int8_matmul_combine<<<blocks, 256, 0, st>>>(pp, sp, op, M, F, splits);
  return (int)cudaGetLastError();
}

const char* lws_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
