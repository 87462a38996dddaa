// The decode-attention kernel (one query token per slot) shared by
// paged_attention.cu (block-pool addressing, bf16 and int8 pools) and
// int8_attention.cu (dense-cache addressing); each stays its own library
// with its own C entry points. ops/_ext.py hashes this header into both
// libraries' build digests.
//
// decode_attention<Elem, Addr> is one template over the K/V element type
// (`Elem`: Bf16Rows, or Int8Rows with per-(token, kv head) f32 scales) and
// the addressing (`Addr`). One launch does the whole job:
//   * Plan, on the device. Every CTA reads pos[0..B), computes each slot's
//     live 16-token blocks and picks the chunk C from Smem::size (1..kChunk
//     blocks, then doublings up to 512): the smallest for which the (slot,
//     kv head, chunk of C blocks) work items fit in `prefer` CTAs (2 per
//     SM), else in the grid, else the largest. The grid is fixed by the host from (B, Hkv, blocks,
//     SMs), so the launch needs no host read of pos; CTAs walk the items
//     (item = h * chunks + first chunk of slot b + c) with a grid stride.
//     An item longer than the kChunk blocks staged at once runs in passes,
//     its (m, l, O) carried in registers from one to the next, so a long
//     slot costs few items, few partials and few merges.
//     ops/paged_attention.py:plan_items is the same plan in Python.
//   * Fetch. One thread issues every block of a pass at once: per block
//     one TMA copy per 16-row x 128-byte box of K and of V (the rows of one
//     kv head are strided Hkv * 128 elements apart; the map steps over
//     them) and, for int8, one bulk copy of the block's K and of its V
//     scales for all kv heads (a contiguous 64 * Hkv bytes; else 4-byte
//     copies of this head's, Addr::whole_scales), all completing
//     on that block's mbarrier, so each warp starts on its block as soon as
//     that block has landed. Rows past pos are read but never used: their
//     scores are masked, their scales selected away, and bf16 V rows past
//     pos are zeroed in shared memory before P.V (0 * NaN would be NaN).
//   * Compute on the tensor cores. The G = H/Hkv query heads are the M rows
//     of mma.m16n8k16 (padded to 16; two m-tiles when G > 16), so each K/V
//     element is read from shared memory once per warp and not once per
//     head: S [16 heads x 16 keys] = Q . K^T (8 k-steps x 2 key tiles), an
//     online softmax in base 2 over S's accumulators, O [16 x 128] += P . V
//     with P's A fragments packed from S's accumulators. The 4 warps take
//     each pass's blocks round robin and, after the item's last pass, merge
//     their (m, l, O) in shared memory.
//   * int8: a K word of 4 bytes gives 4 keys' d values; K is the B operand,
//     and ldmatrix hands lane 4g+t bytes 4t..4t+3 of row g, so Q's A
//     fragments are loaded with the same k (d) permutation (a product sums
//     over k, so permuting A and B alike changes nothing). V is the B
//     operand of P.V with the keys as k: a fragment needs two keys' bytes at
//     one d, so each lane reads one word of 4 d values from each of its 4
//     keys and pairs them with __byte_perm before the exact int8 -> bf16
//     conversion; the 4 d values of a word go to 4 n-tiles, so O's columns
//     are a permutation of d, undone at the write. The K scale multiplies
//     the scores, the V scale the probabilities before they are packed;
//     the sum l takes the unscaled probabilities.
//   * Merge, in the same launch. A slot whose kv head has one chunk writes
//     its output directly. Otherwise each item writes (O, m, l) to a
//     scratch row; the last CTA of a (slot, kv head) to arrive, known by an
//     atomic ticket, sums the chunks in chunk order (bitwise repeatable),
//     writes the output and resets the ticket to 0 for the next launch on
//     the stream.
// `Addr` says where a block's 16 token rows start: through the block table
// (PagedAddr) or at b*T + 16*j of a dense cache (DenseAddr, whose last block
// may be partial: its rows past T are past pos, so they are never used).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90_common.cuh"

namespace lws_decode {

using lws_sm90::cp_async4;
using lws_sm90::cp_async_commit;
using lws_sm90::cp_async_wait;
using lws_sm90::int8x4_to_bf16x4;
using lws_sm90::ldmatrix_x4;
using lws_sm90::ldmatrix_x4_trans;
using lws_sm90::mma_bf16;
using lws_sm90::pack_bf16;

typedef __nv_bfloat16 bf16;

constexpr int kHD = 128;       // head dim (the flagship's; checked by the wrappers)
constexpr int kBS = 16;        // tokens per block (the engine's pool block size)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// Most bf16 blocks staged at once (int8: twice as many, the same bytes); a
// longer work item runs in passes of up to that many blocks.
constexpr int kMaxChunk = 8;
constexpr int kLargestChunk = 512;  // blocks: the largest work item the plan makes
__host__ __device__ constexpr int ilog2(int x) { return x > 1 ? 1 + ilog2(x / 2) : 0; }
constexpr int kMaxSlots = 4096;  // the plan's per-slot arrays live in shared memory
constexpr int kMaxDevices = 64;
constexpr int kAccPitch = kHD + 4;  // f32 row pitch of the merge area
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {  // ex2.approx(-1e30) is 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A block's K (or V) rows of one kv head arrive as 16 rows x 128 bytes
// boxes, one TMA copy each, with the 128-byte swizzle: 16-byte chunk c of
// row r lands at chunk c ^ (r & 7), so the 8 rows an ldmatrix reads fall in
// 8 different bank groups.
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// bf16 K/V rows: two boxes of 64 elements per 128-element row.
struct Bf16Rows {
  typedef bf16 T;
  static constexpr bool kScaled = false;
  static constexpr int kBoxes = 2;
};

// int8 K/V rows (one box) with one f32 scale per (token, kv head).
struct Int8Rows {
  typedef int8_t T;
  static constexpr bool kScaled = true;
  static constexpr int kBoxes = 1;
};

constexpr int kBoxBytes = kBS * 128;  // one box: 16 rows x 128 bytes
constexpr int kScaleHeads = 8;  // up to this many kv heads, a block's scales come whole

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
  // Token rows the tensor maps span (every row a launch may read).
  size_t token_rows(int /*B*/) const { return ((size_t)layer + 1) * NB * kBS; }
  // A block's scales, [16, Hkv] f32, are one 16-byte aligned run.
  bool whole_scales(int Hkv) const { return Hkv <= kScaleHeads; }
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
  size_t token_rows(int B) const { return (size_t)B * T; }
  // Every block's scales (the partial last one's too) start and end on 16
  // bytes when T * Hkv is a multiple of 4.
  bool whole_scales(int Hkv) const { return Hkv <= kScaleHeads && ((long long)T * Hkv) % 4 == 0; }
};

// Shared memory, from a 1024-byte aligned start (the swizzle's period): a
// region that first holds a pass's staged blocks (K tile, V tile: kBoxes
// boxes each) and then the 4 warps' (O, m, l) for the merge; for int8 the
// blocks' K and V scales ([16, up to kScaleHeads] f32 each); one mbarrier
// per staged block; the pass's blocks' first tokens; the plan's [B]
// positions, [B] live blocks, [B+1] chunk offsets and a few words.
template <class Elem>
struct Smem {
  typedef typename Elem::T T;
  static constexpr int kChunk = kMaxChunk * (2 / (int)sizeof(T));  // blocks staged at once
  // The chunk sizes the plan picks from: 1..kChunk, then doublings up to
  // kLargestChunk (ops/paged_attention.py:chunk_sizes, checked at load).
  static constexpr int kSizes = kChunk + ilog2(kLargestChunk / kChunk);  // at most 32
  __host__ __device__ static constexpr int size(int i) {
    return i < kChunk ? i + 1 : kChunk << (i - kChunk + 1);
  }
  static constexpr int kTile = Elem::kBoxes * kBoxBytes;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kMerge = kWarps * (kBS * kAccPitch + 2 * kBS) * 4;
  static constexpr int kRegion = kChunk * kStage > kMerge ? kChunk * kStage : kMerge;
  static constexpr int kBlockScales = Elem::kScaled ? 2 * kBS * kScaleHeads : 0;  // floats
  static constexpr int kScales = kChunk * kBlockScales * 4;                       // bytes
  static constexpr int kPlanWords = 2 * kChunk + 2 * kChunk + kWarps * 32 + 2 + 2 * 32;
  static size_t bytes(int B) {
    return 1024 + kRegion + kScales + (size_t)(3 * B + 1 + kPlanWords) * 4;
  }
};

// TMA copy of the box at (column c0, row c1) of the tensor `map` describes
// into shared memory; rows past the tensor's edge arrive as zeros.
// Completion counts against `bar`'s transactions.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c0, int c1,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(lws_sm90::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(lws_sm90::smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) global -> shared
// in one bulk copy, completing against `bar`'s transactions.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(lws_sm90::smem_addr(dst)), "l"(src), "r"(bytes), "r"(lws_sm90::smem_addr(bar))
      : "memory");
}

// Grid (grid CTAs, fixed by the host), kThreads threads,
// Smem<Elem>::bytes(B) of dynamic shared memory. Values are
// [tokens, Hkv, 128] Elem::T, read through kmap/vmap (2-D maps of [token
// rows, Hkv * 128] with 16 x 128-byte boxes), and (int8 only) scales
// [tokens, Hkv] f32, tokens indexed as Addr says; whole_scales: a block's
// scales are one aligned run (Addr::whole_scales). q/out [B, H, 128] bf16;
// pos [B] int32, or null with every slot at pos_all. part_acc [items, G,
// 128] and part_ml [items, G, 2] f32 hold the chunks of slots with more
// than one; tickets [B * Hkv] int32 are 0 on entry and left 0. The plan
// keeps to `prefer` items (<= grid) where a chunk size allows, else to the
// grid, else takes the largest size. scale_log2 = head_dim**-0.5 * log2(e).
template <class Elem, class Addr>
__global__ void __launch_bounds__(kThreads, 3)  // registers for up to 3 CTAs per SM
decode_attention(const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ q,
                 const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                 int whole_scales, Addr addr, const int* __restrict__ pos, int pos_all,
                 bf16* __restrict__ out, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int* __restrict__ tickets, int B, int H, int Hkv,
                 int prefer, float scale_log2) {
  typedef typename Elem::T T;
  typedef Smem<Elem> L;
  constexpr int kChunk = L::kChunk;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (lws_sm90::smem_addr(smem_raw) & 1023)) & 1023);  // the swizzle's period
  float* sScale = reinterpret_cast<float*>(smem + L::kRegion);        // [kChunk][2][16][sstride]
  uint64_t* sBar = reinterpret_cast<uint64_t*>(smem + L::kRegion + L::kScales);  // [kChunk]
  size_t* sTok = reinterpret_cast<size_t*>(sBar + kChunk);   // [kChunk] blocks' first tokens
  int* sP = reinterpret_cast<int*>(sTok + kChunk);          // [B] positions, clamped
  int* sN = sP + B;                                         // [B] live blocks
  int* sOff = sN + B;                                       // [B+1] first chunk of each slot
  int* sRed = sOff + B + 1;                                 // [kWarps][32]
  int* sMisc = sRed + kWarps * 32;                          // chunk, ticket verdict
  float* sRowM = reinterpret_cast<float*>(sMisc + 2);       // [32] merged m per head
  float* sRowL = sRowM + 32;                                // [32] merged l per head
  const int G = H / Hkv;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nb = addr.n_blocks();
  if (tid == 0) {
    for (int i = 0; i < kChunk; ++i) lws_sm90::mbar_init(&sBar[i], 1);
    lws_sm90::fence_mbar_init();
  }

  // ---- Plan: live blocks per slot, the chunk, each slot's first chunk.
  int cnt[L::kSizes];
#pragma unroll
  for (int i = 0; i < L::kSizes; ++i) cnt[i] = 0;
  for (int b = tid; b < B; b += kThreads) {
    int p = pos != nullptr ? pos[b] : pos_all;
    p = min(max(p, 0), addr.last_pos());
    const int n = min(p / kBS + 1, nb);
    sP[b] = p;
    sN[b] = n;
#pragma unroll
    for (int i = 0; i < L::kSizes; ++i) cnt[i] += (n + L::size(i) - 1) / L::size(i);
  }
#pragma unroll
  for (int i = 0; i < L::kSizes; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) cnt[i] += __shfl_xor_sync(0xffffffffu, cnt[i], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < L::kSizes; ++i) sRed[warp * 32 + i] = cnt[i];
  }
  __syncthreads();
  if (warp == 0) {  // the smallest size whose items fit `prefer`, else the grid, else the largest
    long long items = 0;  // lane i: the items at size i
    for (int w = 0; w < kWarps; ++w) items += lane < L::kSizes ? sRed[w * 32 + lane] : 0;
    items *= Hkv;
    const unsigned fit_prefer = __ballot_sync(0xffffffffu, lane < L::kSizes && items <= prefer);
    const unsigned fit_grid = __ballot_sync(0xffffffffu, lane < L::kSizes && items <= gridDim.x);
    if (lane == 0) {
      const int i = fit_prefer ? __ffs(fit_prefer) - 1
                    : fit_grid ? __ffs(fit_grid) - 1 : L::kSizes - 1;
      sMisc[0] = L::size(i);
    }
  }
  __syncthreads();
  const int C = sMisc[0];
  if (warp == 0) {  // exclusive scan of the chunks per slot
    int carry = 0;
    for (int base = 0; base < B; base += 32) {
      const int b = base + lane;
      const int nc = b < B ? (sN[b] + C - 1) / C : 0;
      int incl = nc;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (b < B) sOff[b] = carry + incl - nc;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) sOff[B] = carry;
  }
  __syncthreads();
  const int per_head = sOff[B];
  const int total = per_head * Hkv;

  const int MT = (G + 15) / 16;  // m-tiles of 16 query heads
  const int mt = warp % MT;      // this warp's m-tile
  const int wb = warp / MT;      // and its first block of the item
  const int WB = kWarps / MT;    // warps per m-tile
  // Scales: [16, Hkv] per block as stored (whole), or this head's [16].
  const int sstride = whole_scales ? Hkv : 1;
  uint32_t phases = 0;  // bit jj: the parity sBar[jj] completes next

  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    // Item i is chunk c of slot b of kv head h: i = h * per_head + sOff[b] + c.
    const int h = item / per_head;
    const int r = item - h * per_head;
    int lo = 0, hi = B - 1;  // the slot: the last b with sOff[b] <= r
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (sOff[mid] <= r) lo = mid; else hi = mid - 1;
    }
    const int b = lo;
    const int c = r - sOff[b];
    const int nc = sOff[b + 1] - sOff[b];
    const int j0 = c * C;
    const int n_item = min(j0 + C, sN[b]) - j0;  // blocks, fetched in passes of kChunk
    const int p = sP[b];

    // Q fragments of this warp's m-tile (rows past G are zero), loaded while
    // the first pass's copies are in flight.
    uint32_t qa[kHD / 16][4];
    float o[kHD / 8][4];
#pragma unroll
    for (int n = 0; n < kHD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g, g+8; l: this lane's share

    for (int p0 = 0; p0 < n_item; p0 += kChunk) {
      const int nblk = min(kChunk, n_item - p0);
      const int jb = j0 + p0;  // the pass's first block
      if (p0 > 0) __syncthreads();  // every warp is done with the last pass's blocks
      // ---- Fetch the pass's blocks at once: per block one TMA box per K
      // and V box and, for int8 where whole_scales, one bulk copy per K and
      // V scale run, all completing on the block's mbarrier; else the
      // scales come as 4-byte copies (rows past pos zero).
      if (tid < nblk) sTok[tid] = addr.first_token(b, jb + tid);
      __syncthreads();
      if (tid == 0) {
        lws_sm90::fence_proxy_async();  // earlier reads and writes of the region come first
        for (int jj = 0; jj < nblk; ++jj) {
          unsigned char* st = smem + jj * L::kStage;
          const int tok = (int)sTok[jj];
          const int srows = min(kBS, addr.rows(jb + jj));
          const bool bulk = Elem::kScaled && whole_scales;
          lws_sm90::mbar_arrive_expect_tx(
              &sBar[jj], L::kStage + (bulk ? 2 * srows * Hkv * 4 : 0));
#pragma unroll
          for (int x = 0; x < Elem::kBoxes; ++x) {
            const int col = (h * kHD * (int)sizeof(T) + x * 128) / (int)sizeof(T);
            tma_box(st + x * kBoxBytes, &kmap, col, tok, &sBar[jj]);
            tma_box(st + L::kTile + x * kBoxBytes, &vmap, col, tok, &sBar[jj]);
          }
          if (bulk) {
            float* sc = sScale + jj * L::kBlockScales;
            bulk_copy(sc, k_scale + (size_t)tok * Hkv, srows * Hkv * 4, &sBar[jj]);
            bulk_copy(sc + kBS * Hkv, v_scale + (size_t)tok * Hkv, srows * Hkv * 4, &sBar[jj]);
          }
        }
      }
      if constexpr (Elem::kScaled) {
        if (!whole_scales) {
          for (int i = tid; i < nblk * 2 * kBS; i += kThreads) {
            const int jj = i / (2 * kBS);
            const int which = (i / kBS) & 1;
            const int row = i % kBS;
            const int j = jb + jj;
            float* dst = sScale + jj * L::kBlockScales + which * kBS + row;
            if (row < addr.rows(j) && j * kBS + row <= p) {
              cp_async4(dst, (which ? v_scale : k_scale) + (sTok[jj] + row) * Hkv + h);
            } else {
              *dst = 0.f;
            }
          }
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();  // every thread's scale copies have landed
        }
      }

      if (p0 == 0) {
        const int r0 = mt * 16 + g, r1 = r0 + 8;
        const bf16* q0 = q + ((size_t)b * H + h * G + r0) * kHD;
        const bf16* q1 = q + ((size_t)b * H + h * G + r1) * kHD;
#pragma unroll
        for (int kk = 0; kk < kHD / 16; ++kk) {
          if constexpr (Elem::kScaled) {  // d 16kk+4t..+1 and +2..+3: the int8 K permutation
            const uint2 w0 = r0 < G ? *reinterpret_cast<const uint2*>(q0 + kk * 16 + 4 * t) : make_uint2(0, 0);
            const uint2 w1 = r1 < G ? *reinterpret_cast<const uint2*>(q1 + kk * 16 + 4 * t) : make_uint2(0, 0);
            qa[kk][0] = w0.x;
            qa[kk][1] = w1.x;
            qa[kk][2] = w0.y;
            qa[kk][3] = w1.y;
          } else {
            const int e = kk * 16 + 2 * t;
            qa[kk][0] = r0 < G ? *reinterpret_cast<const uint32_t*>(q0 + e) : 0u;
            qa[kk][1] = r1 < G ? *reinterpret_cast<const uint32_t*>(q1 + e) : 0u;
            qa[kk][2] = r0 < G ? *reinterpret_cast<const uint32_t*>(q0 + e + 8) : 0u;
            qa[kk][3] = r1 < G ? *reinterpret_cast<const uint32_t*>(q1 + e + 8) : 0u;
          }
        }
      }

      const int rounds = (nblk + WB - 1) / WB;  // the warps take the blocks round robin
      for (int rd = 0; rd < rounds; ++rd) {
        const int jj = rd * WB + wb;
        if (jj >= nblk) continue;
        const int j = jb + jj;
        lws_sm90::mbar_wait(&sBar[jj], (phases >> jj) & 1);  // the block's copies have landed
        unsigned char* st = smem + jj * L::kStage;
        const unsigned char* cK = st;
        unsigned char* cV = st + L::kTile;
        // This head's K scales at cs[key * sstride], V scales at cs[(16 + key) * sstride].
        const float* cs = sScale + jj * L::kBlockScales + (whole_scales ? h : 0);
        if constexpr (!Elem::kScaled) {
          // bf16 V rows past pos may be unwritten (NaN): zero them, as P is
          // 0 there and 0 * NaN is NaN. Whole rows, so the swizzle is moot.
          const int last = p - j * kBS;
          if (last < kBS - 1) {
            for (int i = lane; i < (kBS - 1 - last) * Elem::kBoxes * 8; i += 32) {
              const int row = last + 1 + i / (Elem::kBoxes * 8);
              const int x = (i / 8) % Elem::kBoxes;
              *reinterpret_cast<uint4*>(cV + x * kBoxBytes + row * 128 + (i % 8) * 16) =
                  make_uint4(0, 0, 0, 0);
            }
            __syncwarp();
          }
        }

        // S [16 heads, 16 keys] = Q . K^T: two 8-key accumulator tiles.
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if constexpr (Elem::kScaled) {
#pragma unroll
          for (int k2 = 0; k2 < kHD / 32; ++k2) {
            uint32_t w[4];  // keys 0-7 / 8-15 of chunk 2k2, then of chunk 2k2+1
            ldmatrix_x4(w, cK + swz((lane & 7) + ((lane >> 3) & 1) * 8, 2 * k2 + (lane >> 4)));
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              uint32_t b0, b1;
              int8x4_to_bf16x4(w[x], b0, b1);
              mma_bf16(s[x & 1], qa[2 * k2 + (x >> 1)], b0, b1);
            }
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < kHD / 16; ++kk) {
            uint32_t bk[4];  // keys 0-15 x d 16kk..+15: b0, b1 of the two key tiles
            ldmatrix_x4(bk, cK + (kk >> 2) * kBoxBytes +
                                swz((lane & 7) + ((lane >> 4) << 3), (kk & 3) * 2 + ((lane >> 3) & 1)));
            mma_bf16(s[0], qa[kk], bk[0], bk[1]);
            mma_bf16(s[1], qa[kk], bk[2], bk[3]);
          }
        }

        // Scale (and K scale), mask keys past pos, online softmax in base 2.
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = nt * 8 + 2 * t + (e & 1);
            float f = scale_log2;
            if constexpr (Elem::kScaled) f *= cs[key * sstride];
            s[nt][e] = j * kBS + key <= p ? s[nt][e] * f : kNegInf;
          }
          mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
          mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float alpha0 = fast_exp2(m0 - mn0), alpha1 = fast_exp2(m1 - mn1);  // first block: 0
        m0 = mn0;
        m1 = mn1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          s[nt][0] = fast_exp2(s[nt][0] - mn0);
          s[nt][1] = fast_exp2(s[nt][1] - mn0);
          s[nt][2] = fast_exp2(s[nt][2] - mn1);
          s[nt][3] = fast_exp2(s[nt][3] - mn1);
          sum0 += s[nt][0] + s[nt][1];
          sum1 += s[nt][2] + s[nt][3];
          if constexpr (Elem::kScaled) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {  // a select: a scale past pos may be NaN
              const int key = nt * 8 + 2 * t + (e & 1);
              s[nt][e] = j * kBS + key <= p ? s[nt][e] * cs[(kBS + key) * sstride] : 0.f;
            }
          }
        }
        l0 = l0 * alpha0 + sum0;
        l1 = l1 * alpha1 + sum1;
#pragma unroll
        for (int n = 0; n < kHD / 8; ++n) {
          o[n][0] *= alpha0;
          o[n][1] *= alpha0;
          o[n][2] *= alpha1;
          o[n][3] *= alpha1;
        }

        // O [16, 128] += P [16, 16] . V [16, 128]; P's A fragments are S's
        // accumulators, packed to bf16.
        const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                               pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
        if constexpr (Elem::kScaled) {
          // n-tile 4m+i, column n holds d = 32m + 4n + i: lane (g, t) reads the
          // word of d 32m+4g..+3 of keys 2t, 2t+1, 2t+8, 2t+9 and pairs the
          // two keys of each k slot byte by byte.
#pragma unroll
          for (int m = 0; m < kHD / 32; ++m) {
            const int ch = 2 * m + (g >> 2), in = (4 * g) & 15;  // byte 32m + 4g of a row
            auto word = [&](int row) {
              return *reinterpret_cast<const uint32_t*>(cV + swz(row, ch) + in);
            };
            const uint32_t wa = word(2 * t), wb2 = word(2 * t + 1);
            const uint32_t wc = word(2 * t + 8), wd = word(2 * t + 9);
            uint32_t lo01, hi01, lo23, hi23, clo01, chi01, clo23, chi23;
            int8x4_to_bf16x4(__byte_perm(wa, wb2, 0x5140), lo01, hi01);
            int8x4_to_bf16x4(__byte_perm(wa, wb2, 0x7362), lo23, hi23);
            int8x4_to_bf16x4(__byte_perm(wc, wd, 0x5140), clo01, chi01);
            int8x4_to_bf16x4(__byte_perm(wc, wd, 0x7362), clo23, chi23);
            mma_bf16(o[4 * m + 0], a, lo01, clo01);
            mma_bf16(o[4 * m + 1], a, hi01, chi01);
            mma_bf16(o[4 * m + 2], a, lo23, clo23);
            mma_bf16(o[4 * m + 3], a, hi23, chi23);
          }
        } else {
#pragma unroll
          for (int dp = 0; dp < kHD / 16; ++dp) {
            uint32_t bv[4];  // keys 0-15 x d 16dp..+15: b0, b1 of two d tiles
            ldmatrix_x4_trans(bv, cV + (dp >> 2) * kBoxBytes +
                                      swz((lane & 7) + (((lane >> 3) & 1) << 3),
                                          (dp & 3) * 2 + (lane >> 4)));
            mma_bf16(o[2 * dp], a, bv[0], bv[1]);
            mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
          }
        }
      }
      phases ^= (1u << nblk) - 1u;  // blocks 0..nblk-1 completed a phase each
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }

    // ---- Merge the warps of each m-tile in shared memory (over the staged
    // blocks, which every warp is done with after the barrier).
    __syncthreads();
    float* sAcc = reinterpret_cast<float*>(smem);  // [warp][16][kAccPitch]
    float* sML = sAcc + kWarps * kBS * kAccPitch;  // [warp][m 16, l 16]
    {
      float* wAcc = sAcc + warp * kBS * kAccPitch;
#pragma unroll
      for (int n = 0; n < kHD / 8; ++n) {
        int d0, d1;
        if constexpr (Elem::kScaled) {
          d0 = (n >> 2) * 32 + 8 * t + (n & 3);
          d1 = d0 + 4;
        } else {
          d0 = n * 8 + 2 * t;
          d1 = d0 + 1;
        }
        wAcc[g * kAccPitch + d0] = o[n][0];
        wAcc[g * kAccPitch + d1] = o[n][1];
        wAcc[(g + 8) * kAccPitch + d0] = o[n][2];
        wAcc[(g + 8) * kAccPitch + d1] = o[n][3];
      }
      if (t == 0) {
        float* wML = sML + warp * 2 * kBS;
        wML[g] = m0;
        wML[g + 8] = m1;
        wML[kBS + g] = l0;
        wML[kBS + g + 8] = l1;
      }
    }
    __syncthreads();
    if (tid < G) {  // per head: the warps' common max and the merged sum
      const int rt = tid / 16, rr = tid % 16;
      float M = kNegInf;
      for (int w = rt; w < kWarps; w += MT) M = fmaxf(M, sML[w * 2 * kBS + rr]);
      float den = 0.f;
      for (int w = rt; w < kWarps; w += MT) {
        den += fast_exp2(sML[w * 2 * kBS + rr] - M) * sML[w * 2 * kBS + kBS + rr];
      }
      sRowM[tid] = M;
      sRowL[tid] = den;
    }
    __syncthreads();
    const bool direct = nc == 1;
    for (int e = tid; e < G * kHD; e += kThreads) {
      const int hr = e / kHD, d = e % kHD;
      const int rt = hr / 16, rr = hr % 16;
      const float M = sRowM[hr];
      float num = 0.f;
      for (int w = rt; w < kWarps; w += MT) {
        num += fast_exp2(sML[w * 2 * kBS + rr] - M) * sAcc[(w * kBS + rr) * kAccPitch + d];
      }
      if (direct) {
        out[((size_t)b * H + h * G + hr) * kHD + d] = __float2bfloat16(num / sRowL[hr]);
      } else {
        part_acc[((size_t)item * G + hr) * kHD + d] = num;
        if (d == 0) {
          part_ml[((size_t)item * G + hr) * 2] = M;
          part_ml[((size_t)item * G + hr) * 2 + 1] = sRowL[hr];
        }
      }
    }

    // ---- The last chunk of (b, h) to finish sums all of them, in order.
    if (!direct) {
      __threadfence();  // this item's partial is visible before its ticket
      __syncthreads();
      if (tid == 0) sMisc[1] = atomicAdd(&tickets[b * Hkv + h], 1) == nc - 1;
      __syncthreads();
      if (sMisc[1]) {
        __threadfence();
        const size_t first = (size_t)item - c;
        for (int hr = warp; hr < G; hr += kWarps) {  // per head: max and sum over the chunks
          float M = kNegInf;
          for (int cc = lane; cc < nc; cc += 32) {
            M = fmaxf(M, __ldcg(&part_ml[((first + cc) * G + hr) * 2]));
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
          float den = 0.f;
          for (int cc = lane; cc < nc; cc += 32) {
            const float* ml = &part_ml[((first + cc) * G + hr) * 2];
            den += fast_exp2(__ldcg(ml) - M) * __ldcg(ml + 1);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
          if (lane == 0) {
            sRowM[hr] = M;
            sRowL[hr] = den;
          }
        }
        __syncthreads();
        for (int e = tid; e < G * (kHD / 4); e += kThreads) {  // 4 d values a thread
          const int hr = e / (kHD / 4), d4 = e % (kHD / 4);
          const float M = sRowM[hr];
          float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
          for (int cc = 0; cc < nc; ++cc) {
            const size_t row = (first + cc) * G + hr;
            const float w = fast_exp2(__ldcg(&part_ml[row * 2]) - M);
            const float4 a = __ldcg(reinterpret_cast<const float4*>(part_acc + row * kHD) + d4);
            num.x += w * a.x;
            num.y += w * a.y;
            num.z += w * a.z;
            num.w += w * a.w;
          }
          const float inv = 1.f / sRowL[hr];
          __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
              out + ((size_t)b * H + h * G + hr) * kHD + 4 * d4);
          dst[0] = __floats2bfloat162_rn(num.x * inv, num.y * inv);
          dst[1] = __floats2bfloat162_rn(num.z * inv, num.w * inv);
        }
        if (tid == 0) tickets[b * Hkv + h] = 0;
      }
    }
    __syncthreads();  // the next item's copies overwrite the merge area
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// K or V values [rows, Hkv * 128] as a TMA tensor of 16-row x 128-byte
// boxes with the 128-byte swizzle, zero past the last row. The encoder
// lives in libcuda; it is looked up once through the CUDA runtime, so the
// library links only the runtime.
template <class Elem>
cudaError_t kv_map(CUtensorMap* map, const void* base, size_t rows, int Hkv) {
  static const EncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(fn);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  typedef typename Elem::T T;
  const CUtensorMapDataType type =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dims[2] = {(cuuint64_t)Hkv * kHD, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Hkv * kHD * sizeof(T)};  // bytes between rows
  const cuuint32_t box[2] = {(cuuint32_t)(128 / sizeof(T)), (cuuint32_t)kBS};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch on `stream` with `grid` CTAs, planning at most `prefer` items where
// a chunk size allows (k_scale/v_scale are ignored for Bf16Rows); B <=
// kMaxSlots. Returns the cudaError_t of the launch.
template <class Elem, class Addr>
int launch_decode(const void* q, const void* k, const void* k_scale, const void* v,
                  const void* v_scale, Addr addr, const void* pos, int pos_all, void* out,
                  void* part_acc, void* part_ml, void* tickets, int B, int H, int Hkv, int grid,
                  int prefer, float scale, void* stream) {
  // The shared-memory allowance is a per-device attribute of the function:
  // set once per device, to what kMaxSlots slots need.
  static std::atomic<bool> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (B > kMaxSlots) return (int)cudaErrorInvalidValue;
  if (!allowed[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(decode_attention<Elem, Addr>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Smem<Elem>::bytes(kMaxSlots));
    if (err != cudaSuccess) return (int)err;
    allowed[dev].store(true, std::memory_order_release);
  }
  CUtensorMap kmap, vmap;
  const size_t rows = addr.token_rows(B);
  if ((err = kv_map<Elem>(&kmap, k, rows, Hkv)) != cudaSuccess ||
      (err = kv_map<Elem>(&vmap, v, rows, Hkv)) != cudaSuccess)
    return (int)err;
  const size_t smem = Smem<Elem>::bytes(B);
  decode_attention<Elem, Addr><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, static_cast<const bf16*>(q), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), Elem::kScaled && addr.whole_scales(Hkv) ? 1 : 0, addr,
      static_cast<const int*>(pos), pos_all, static_cast<bf16*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), static_cast<int*>(tickets), B,
      H, Hkv, prefer, scale * kLog2e);
  return (int)cudaGetLastError();
}

// Writes the chunk sizes of the Elem kernel's plan to out[0..cap) and
// returns how many there are (the wrappers check them against their own).
template <class Elem>
int chunk_sizes(int* out, int cap) {
  for (int i = 0; i < Smem<Elem>::kSizes && i < cap; ++i) out[i] = Smem<Elem>::size(i);
  return Smem<Elem>::kSizes;
}

}  // namespace lws_decode
