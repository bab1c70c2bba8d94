// One-token GQA decode attention over the quantized slot caches, for Hopper
// (sm_90a), CUDA C++ with a plain C interface bound from Python with ctypes
// (ops/_build.py, ops/attention.py).
//
//   #18 attn_split_kernel<G, kSplitKv8> replaces
//                                       lightcompress_tpu/ops/pallas_attention.py
//                                       decode_attention_bd (_attn_kernel_bd)
//   #19 attn_bd_flash_kernel<G, false>  replaces decode_attention_bd_flash
//                                       (_attn_kernel_bd_flash)
//   #20 attn_split_kernel<G, kSplitKv4> replaces decode_attention_bd4
//                                       (_attn_kernel_bd4)
//   #21 attn_bd_flash_kernel<G, true>   replaces decode_attention_bd4_flash
//                                       (_attn_kernel_bd4_flash)
//   #17 attn_split_kernel<G, kSplitI8>  replaces decode_attention_i8
//                                       (_attn_kernel_i8_append, masked)
//   #22 attn_kv8_kernel<G, ST>          replaces decode_attention_kv8
//                                       (_attn_kernel)
//
// Inputs shared by all but #22: the int8 query q8 (B, H, G, D) and its
// f32 scales qs (B, H, G) (ops/attention.quantize_q), bf16 per-token cache
// scales (B, H, S), int32 lengths (B,).  D = 128; G is a template argument.
// Block-diagonal caches (#18-#21): K feature-major (B, H*R, S) and V
// time-major (B, S, H*R), R code bytes per head and token: kv8 (#18, #19)
// R = D int8 codes, row h*D + d = feature d of head h; kv4 (#20, #21) R =
// D/2, one byte = two int4 codes, low nibble feature d, high nibble
// feature d + D/2.  int8 hhd cache (#17): K and V (B, H, S, D).  The TPU
// kernels of #18/#19 multiply a block-diagonal q (H*G, H*D) against the
// whole slab, a matrix-unit device; these compute what it computes, each
// head's G query rows against that head's rows of the slab.
//
// Arithmetic, in the JAX kernels' order: integer dots (int8 q against int8
// codes or sign-extended nibbles, exact in int32 on the int8 tensor cores);
// scores (f32(s) * (qs * D^-0.5)) * ks;
// columns >= length are masked; the max is floored at -1e30 (#18-#21); e =
// exp(s - m); pv = e * vs; ps = max(max(pv), 1e-20) / 127; p8 = rint(pv /
// ps) (round half to even, IEEE division: the build uses no fast-math); PV
// as an int32 dot times ps.  Where JAX multiplies and then adds,
// __fmul_rn/__fadd_rn keep the two roundings.  Masked columns contribute
// exactly 0 in the TPU kernels, so these skip them.
//
// Bound of #17-#21 on an H100 SXM: bytes (their sections below).  A kernel
// reads each valid column's codes and scales once (kv8: 128 + 128 + 2 + 2
// bytes per kv head and token; kv4: 64 + 64 + 2 + 2) against 2*G*D int
// operations per code byte pair, far below the int8 tensor-core rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "w4_mma.cuh"  // the TMA and mbarrier helpers (#22)

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 128;                       // head_dim
constexpr int kD2 = kD / 2;                   // kv4 bytes per head and token
constexpr float kScale = 0.08838834764831845f;  // 128 ** -0.5

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The four bytes of x hold two nibbles each; these return the low (or high)
// nibbles sign-extended to four int8 lanes (s8 operands of mma.sync).
__device__ __forceinline__ int nib_lo(uint32_t x) {
  const uint32_t n = x & 0x0F0F0F0Fu;
  return (int)(n | ((n & 0x08080808u) * 0x1Eu));
}
__device__ __forceinline__ int nib_hi(uint32_t x) {
  const uint32_t n = (x >> 4) & 0x0F0F0F0Fu;
  return (int)(n | ((n & 0x08080808u) * 0x1Eu));
}

// ---------------------------------------------------------------------------
// #19 (kNib false) and #21 (kNib true): S in blocks of sb columns; each
// block carries (o, m, d) as the TPU kernels' grid steps do:
//   m' = max(m, max(max(s_blk), -1e30)); a = exp(m - m');
//   d' = d*a + sum(e); o' = o*a + f32(p8 . v) * ps_blk,
// the probabilities requantized once a block with that block's scale, so a
// unit of work is a whole block.  Blocks at or past the slot's length leave
// (o, m, d) unchanged in the TPU kernel (a = 1, e = 0): they are skipped.
//
// Bound on an H100 SXM: bytes (K and V of the valid columns, as #17-#18),
// against 4 * G * D int8 operations a column.  The design:
//   * S split over ranks in whole blocks: P CTAs per (slot, kv head), grid
//     (P, H, B); rank r runs the recurrence over blocks [r * bpr, (r + 1) *
//     bpr), bpr = ceil((S / sb) / P), from m = -1e30.  The wrapper picks P
//     from S, sb, the B * H pairs and the card's occupancy, never from the
//     lengths (ops/attention.bd_flash_parts).  A rank past the slot's valid
//     blocks exits at once.  The active ranks (the first ceil(ceil(L / sb) /
//     bpr)) write their (o, m, d) to a scratch and count themselves on a
//     per-pair integer counter; the last to arrive merges them in rank
//     order, m = max(m_r), o = sum_r o_r * exp(m_r - m), d likewise, writes
//     the outputs and sets the counter back to 0.  One active rank writes
//     its outputs itself.
//   * Each of the four warps streams its own chunks (64 columns of K: R
//     feature rows of 64 bytes, with the columns' K and V scales; 64 time
//     steps of V: rows of R bytes; chunk c of a block to warp c % 4)
//     through a ring of `nslot` slots, K before V in every block, so its
//     first V chunks are in flight while the block's softmax runs.  Lane 0
//     issues a chunk as one TMA box (the chunks that hold valid columns;
//     the scales by two bulk copies) on the slot's mbarrier, and refills a
//     slot only after the products that read it (then __syncwarp).  Copies
//     by cp.async, 16 bytes a lane, held the issuing warp about 0.55 us a
//     chunk, a TMA box about 0.3 (kernel_ab.py ... flash_stamps).
//   * Both dots on the int8 tensor cores (mma.sync m16n8k32 s8.s8.s32,
//     exact, as __dp4a): scores with A = 16 time steps x 32 features of K,
//     B = q8 (its G rows the n8 columns); PV with A = 16 features x 32 time
//     steps of V, B = p8.  K is feature-major and V time-major, so both A
//     operands take a 4 x 4 byte transpose in registers (eight byte
//     permutes for four words); kv4's nibbles are sign-extended after it,
//     q's low half against the low nibbles (features d), its high half
//     against the high ones (d + 64).  The features (QK) and time steps
//     (PV) a lane reads are permuted so that the chunks' 16-byte pieces,
//     swizzled by row, fall on distinct banks; q and p8 follow the same
//     order.  The scores are those of #17-#18 bit for bit, and m with them.
//   * The softmax chain in the TPU's order and roundings (__fmul_rn, the
//     IEEE division, rintf, the -1e30 floor) with three exchanges a block
//     through shared memory (the block max; the sum of e and max of pv; the
//     PV sums, int32 shared-memory atomics, exact in any order, on distinct
//     banks), each after warp shuffles.  A warp makes its own p8 B
//     fragments before its V chunk's wait: rint(pv * (1 / ps)) by adding
//     1.5 * 2^23, the IEEE division near a tie (as #13's act codes).
//   * Shared memory: the ring, the block's f32 scores (then pv) and V
//     scales, the int32 PV sums, the exchanges: 4 * G bytes a column and
//     the V scales' 2 where they fit, so every sb the whole-block kernel
//     took still fits (past that the softmax reads the V scales from
//     global memory).
// ---------------------------------------------------------------------------
constexpr int kFlashThreads = 128;
constexpr int kFlashWarps = kFlashThreads / 32;
constexpr int kChunk = 64;  // columns (K) or time steps (V) of a ring chunk
constexpr int kFlashMaxParts = 16;  // ranks a (slot, kv head)
// a query's row of the int32 PV sums: feature phi of lane group g at phi * 8
// + g, rows 132 words apart, so that a warp's atomics hit distinct banks
constexpr int kAccRow = 132;

#ifdef LC_FLASH_STAMPS
// timing only (kernel_ab.py ... flash_stamps): (point, %globaltimer) pairs
// of thread 0 of one CTA (rank 0 of kv head 0 of slot 1), stores only (the
// count in a register), read by lc_flash_stamps
__device__ unsigned long long flash_stamps[2048];
__device__ int flash_nstamps;
#define FLASH_STAMP(id)                                                     \
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&             \
      blockIdx.z == 1 && nstamp_ < 1024) {                                  \
    unsigned long long t_;                                                  \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                 \
    flash_stamps[2 * nstamp_] = (id);                                       \
    flash_stamps[2 * nstamp_ + 1] = t_;                                     \
    flash_nstamps = ++nstamp_;                                              \
  }
#else
#define FLASH_STAMP(id)
#endif

// the f32 score rows of a block: a stride that spreads the score stores of
// the mma fragments over the banks
__host__ __device__ constexpr int flash_sc_stride(int sb) {
  return ((sb + 31) & ~31) + 1;
}

// bytes of a ring slot's codes (R x 64; 1024-byte aligned for the TMA's
// swizzle) and of its scales (a K chunk's 64 K then 64 V scales, bf16)
__host__ __device__ constexpr int flash_slot_bytes(bool nib) {
  return (nib ? kD2 : kD) * kChunk;
}
constexpr int kSlotScales = 4 * kChunk;

// dynamic shared memory of a #19/#21 CTA (ops/attention.bd_flash_smem_bytes):
// 1024 bytes of alignment slack, the ring (codes, scales, the slots'
// mbarriers), the int32 PV sums, the exchanges (3 x 4 warps x 8 floats) and
// the flag, the block's V scales (bf16; where they fit beside a one-slot
// ring, else the softmax reads them from global memory), the scores
constexpr size_t kSmemMax = 232448;
inline size_t flash_smem(int G, int sb, bool nib, int nslot, bool vsb) {
  const size_t ring = (size_t)kFlashWarps * nslot *
                      (flash_slot_bytes(nib) + kSlotScales + 8);
  return 1024 + ring + (size_t)G * kAccRow * 4 + 3 * kFlashWarps * 8 * 4 + 16 +
         (vsb ? (size_t)sb * 2 : 0) + (size_t)G * flash_sc_stride(sb) * 4;
}
inline bool flash_vsb(int G, int sb, bool nib) {
  return flash_smem(G, sb, nib, 1, true) <= kSmemMax;
}

// byte offset of 16-byte piece c of row r of a chunk of 64-byte rows (the
// 64-byte swizzle) or of 128-byte rows (the 128-byte swizzle)
__device__ __forceinline__ int sw64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}
// r & 7 of the rows (64-byte rows) that lane group tig reads with low bit
// b: with sw64, the four groups' loads of one instruction hit distinct banks
__device__ __forceinline__ int lane7_64(int tig, int b) {
  return (tig & 1) | (b << 1) | ((tig >> 1) << 2);
}
// the same for 128-byte rows (sw128)
__device__ __forceinline__ int lane7_128(int tig, int b) { return 2 * tig + b; }

// 4 x 4 byte transpose: byte i of o[j] is byte j of w_i
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           uint32_t* o) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void mma_i8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A K chunk's scores on the tile (#18, #19: kv8 feature rows; #21: kv4):
// acc[i] += m16 tile i (lane (g, tig): time steps 8 g + 2 i, + 1 as rows g,
// g + 8) times q8's B fragments qb; lane (g, tig) reads time steps 8 g ..
// 8 g + 7 of the rows 8 a + lane7_64(tig, b) and transposes them
template <bool kNib>
__device__ __forceinline__ void bd_chunk_scores(const unsigned char* sl,
                                                int g, int tig,
                                                const uint32_t (&qb)[4][2],
                                                int (&acc)[4][4]) {
#pragma unroll
  for (int ka = 0; ka < (kNib ? 2 : 4); ++ka) {
    uint2 wv[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int r = 8 * (4 * ka + (jj >> 1)) + lane7_64(tig, jj & 1);
      wv[jj] = *reinterpret_cast<const uint2*>(sl + sw64(r, g >> 1) +
                                               8 * (g & 1));
    }
    uint32_t x[2][8];  // [a0 rows, a2 rows][time step 8 g + u]
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      transpose4(wv[4 * s].x, wv[4 * s + 1].x, wv[4 * s + 2].x,
                 wv[4 * s + 3].x, x[s]);
      transpose4(wv[4 * s].y, wv[4 * s + 1].y, wv[4 * s + 2].y,
                 wv[4 * s + 3].y, x[s] + 4);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kNib) {
        mma_i8(acc[i], nib_lo(x[0][2 * i]), nib_lo(x[0][2 * i + 1]),
               nib_lo(x[1][2 * i]), nib_lo(x[1][2 * i + 1]), qb[ka][0],
               qb[ka][1]);
        mma_i8(acc[i], nib_hi(x[0][2 * i]), nib_hi(x[0][2 * i + 1]),
               nib_hi(x[1][2 * i]), nib_hi(x[1][2 * i + 1]),
               qb[ka + 2][0], qb[ka + 2][1]);
      } else {
        mma_i8(acc[i], x[0][2 * i], x[0][2 * i + 1], x[1][2 * i],
               x[1][2 * i + 1], qb[ka][0], qb[ka][1]);
      }
    }
  }
}

// The PV B fragments of the chunk at column tb: p8 of query g (score row
// srow, stride ss; zero where live_g is false or t >= n) at the lane's
// time steps 32 kk + 8 a + lane7(tig, jj & 1), a = jj >> 1.  p8 = rint(pv
// / ps): t = pv * (1 / ps) rounded to even by adding 1.5 * 2^23, or the
// IEEE division where t lies within 2^-14 of a tie (lcw4::kTieGuard, as
// #13's act codes: t is within 2^-15 of pv / ps); without branches (every
// lane reads a score in its row's bounds); a lane with a tie divides all
// sixteen
template <bool kNib>
__device__ __forceinline__ void p8_frags(const float* srow, int ss, int tb,
                                         int n, bool live_g, int tig,
                                         float psinv, float psg,
                                         uint32_t (&bws)[2][2]) {
  float pv[16];
  int p8[16];
  bool tie = false;
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int jj = u & 7;
    const int t = tb + 32 * (u >> 3) + 8 * (jj >> 1) +
                  (kNib ? lane7_64(tig, jj & 1) : lane7_128(tig, jj & 1));
    pv[u] = (live_g && t < n) ? srow[min(t, ss - 1)] : 0.f;
    const float tq = __fmul_rn(pv[u], psinv);
    const float yq = __fadd_rn(tq, 12582912.f);
    p8[u] = __float_as_int(yq) - 0x4B400000;
    tie |= fabsf(__fsub_rn(tq, __fsub_rn(yq, 12582912.f))) > lcw4::kTieGuard;
  }
  if (tie)
#pragma unroll
    for (int u = 0; u < 16; ++u) p8[u] = (int)rintf(__fdiv_rn(pv[u], psg));
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int s = 0; s < 2; ++s)
      bws[kk][s] = __byte_perm(
          __byte_perm(p8[8 * kk + 4 * s], p8[8 * kk + 4 * s + 1], 0x40),
          __byte_perm(p8[8 * kk + 4 * s + 2], p8[8 * kk + 4 * s + 3], 0x40),
          0x5410);
}

// A V chunk's PV on the tile: pacc[i] += m16 tile i (lane (g, tig): rows
// g, g + 8 as features phi = 2 i, 2 i + 1 of its 16; kv8: 16 g + phi;
// kv4: 8 g + phi, and 64 + 8 g + phi - 8 from phi 8 on) times p8's B
// fragments bws[kk]; lane (g, tig) reads, at k step kk, the time steps
// 32 kk + 8 a + lane7(tig, jj & 1), a = jj >> 1 (jj < 4: the a0/a1 k
// range, else a2/a3), 16 features each (kv8: bytes 16 g .. 16 g + 15; kv4:
// bytes 8 g .. 8 g + 7, low then high nibbles)
template <bool kNib>
__device__ __forceinline__ void bd_chunk_pv(const unsigned char* sl, int g,
                                            int tig,
                                            const uint32_t (&bws)[2][2],
                                            int (&pacc)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t y[2][16];  // [a0/a1 time steps, a2/a3][feature phi]
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if constexpr (kNib) {
        uint2 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int jj = 4 * s + i;
          const int t = 32 * kk + 8 * (jj >> 1) + lane7_64(tig, jj & 1);
          v[i] = *reinterpret_cast<const uint2*>(sl + sw64(t, g >> 1) +
                                                 8 * (g & 1));
        }
        uint32_t x[8];
        transpose4(v[0].x, v[1].x, v[2].x, v[3].x, x);
        transpose4(v[0].y, v[1].y, v[2].y, v[3].y, x + 4);
#pragma unroll
        for (int f = 0; f < 8; ++f) {
          y[s][f] = (uint32_t)nib_lo(x[f]);
          y[s][8 + f] = (uint32_t)nib_hi(x[f]);
        }
      } else {
        uint4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int jj = 4 * s + i;
          const int t = 32 * kk + 8 * (jj >> 1) + lane7_128(tig, jj & 1);
          v[i] = *reinterpret_cast<const uint4*>(sl + sw128(t, g));
        }
        transpose4(v[0].x, v[1].x, v[2].x, v[3].x, y[s]);
        transpose4(v[0].y, v[1].y, v[2].y, v[3].y, y[s] + 4);
        transpose4(v[0].z, v[1].z, v[2].z, v[3].z, y[s] + 8);
        transpose4(v[0].w, v[1].w, v[2].w, v[3].w, y[s] + 12);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      mma_i8(pacc[i], y[0][2 * i], y[0][2 * i + 1], y[1][2 * i],
             y[1][2 * i + 1], bws[kk][0], bws[kk][1]);
  }
}

// A warp's chunks of its rank, in order: block j (absolute), K (v = 0) then
// V (v = 1), chunks c = warp, warp + 4, ... of the block's ceil(n / 64).
struct FlashCursor {
  int j, v, c;
};

// moves cur to its next chunk at or after itself; false past the last
__device__ __forceinline__ bool flash_settle(FlashCursor& cur, int warp,
                                             int jend, int L, int sb) {
  while (cur.j < jend) {
    const int n = min(sb, L - cur.j * sb);
    if (cur.c < (n + kChunk - 1) / kChunk) return true;
    cur.c = warp;
    if (cur.v) ++cur.j;
    cur.v ^= 1;
  }
  return false;
}

// 1D bulk copy of `bytes` (a multiple of 16) from global src into shared
// dst, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(lcw4::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(lcw4::smem_u32(bar))
      : "memory");
}

// One lane copies chunk cur into a ring slot (codes dst, scales sdst),
// completing on bar: a K chunk is one TMA box of R feature rows x 64
// columns (64-byte swizzle; columns past S as zeros) and the K and V
// scales of its valid columns rounded up to 16 (bulk copies); a V chunk
// one box of 64 time steps x R bytes (kv8: 128-byte swizzle, kv4: 64-byte).
template <bool kNib>
__device__ __forceinline__ void flash_issue(unsigned char* dst,
                                            unsigned char* sdst,
                                            uint64_t* bar,
                                            const FlashCursor& cur,
                                            const CUtensorMap* kmap,
                                            const CUtensorMap* vmap,
                                            const __nv_bfloat16* ksh,
                                            const __nv_bfloat16* vsh, int bh,
                                            int b, int h, int S, int L,
                                            int sb) {
  constexpr int R = kNib ? kD2 : kD;
  const int col = cur.j * sb + cur.c * kChunk;
  if (!cur.v) {
    const int nv = min(kChunk, min(sb, L - cur.j * sb) - cur.c * kChunk);
    const int sbytes = 32 * ((nv + 15) >> 4);
    lcw4::mbar_expect_tx(bar, R * kChunk + 2 * sbytes);
    lcw4::tma_load_2d(dst, kmap, col, bh * R, bar);
    bulk_load(sdst, ksh + col, sbytes, bar);
    bulk_load(sdst + 2 * kChunk, vsh + col, sbytes, bar);
  } else {
    lcw4::mbar_expect_tx(bar, kChunk * R);
    lcw4::tma_load_2d(dst, vmap, h * R, b * S + col, bar);
  }
}

template <int G, bool kNib>
__global__ void __launch_bounds__(kFlashThreads)
attn_bd_flash_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const int8_t* __restrict__ q8,
                     const float* __restrict__ qs,
                     const __nv_bfloat16* __restrict__ ks,
                     const __nv_bfloat16* __restrict__ vs,
                     const int* __restrict__ lengths,
                     float* __restrict__ ctx, float* __restrict__ m_out,
                     float* __restrict__ d_out, float* __restrict__ part,
                     int* __restrict__ counters, int S, int sb, int nslot,
                     int vsb_on) {
  constexpr int CB = flash_slot_bytes(kNib);  // code bytes of a ring slot
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (lcw4::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sring = ring + kFlashWarps * nslot * CB;  // the scales
  uint64_t* full =
      reinterpret_cast<uint64_t*>(sring + kFlashWarps * nslot * kSlotScales);
  int* accs = reinterpret_cast<int*>(full + kFlashWarps * nslot);
  float* red = reinterpret_cast<float*>(accs + G * kAccRow);  // [3][warps][8]
  int* flag = reinterpret_cast<int*>(red + 3 * kFlashWarps * 8);
  __nv_bfloat16* vsb = reinterpret_cast<__nv_bfloat16*>(flag + 4);  // [sb]
  float* sc = reinterpret_cast<float*>(vsb + (vsb_on ? sb : 0));  // [G][ss]
  const int ss = flash_sc_stride(sb);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int rank = blockIdx.x, P = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, bh = b * H + h;
#ifdef LC_FLASH_STAMPS
  int nstamp_ = 0;
#endif
  FLASH_STAMP(0);
  const int L = min(max(lengths[b], 0), S);
  const int nblk = S / sb, bpr = (nblk + P - 1) / P;
  const int nvb = (L + sb - 1) / sb;       // the slot's valid blocks
  const int nv = (nvb + bpr - 1) / bpr;    // its active ranks
  const int j0 = rank * bpr, jend = min(j0 + bpr, nvb);
  if (j0 >= jend) {  // no valid block; an empty slot's rank 0 writes
                     // (0, -1e30, 0)
    if (rank == 0) {
      for (int i = tid; i < G * kD; i += kFlashThreads)
        ctx[(size_t)bh * G * kD + i] = 0.f;
      if (tid < G) {
        m_out[bh * G + tid] = -1e30f;
        d_out[bh * G + tid] = 0.f;
      }
    }
    return;
  }
  const __nv_bfloat16* ksh = ks + (size_t)bh * S;
  const __nv_bfloat16* vsh = vs + (size_t)bh * S;
  unsigned char* wring = ring + warp * nslot * CB;
  unsigned char* wsring = sring + warp * nslot * kSlotScales;
  uint64_t* wfull = full + warp * nslot;

  // q8 of the pair's G queries into the scores' room (read below, after
  // the barrier), its load in flight while the ring's copies are issued
  int8_t* qsh = reinterpret_cast<int8_t*>(sc);
  if (tid < G * kD / 16)
    reinterpret_cast<uint4*>(qsh)[tid] =
        __ldg(reinterpret_cast<const uint4*>(q8 + (size_t)bh * G * kD) + tid);
  // the ring: the warp's first nslot chunks, lane 0 issuing; a slot's
  // mbarrier completes once its copies land
  FlashCursor fill{j0, 0, warp};
  bool more = flash_settle(fill, warp, jend, L, sb);
  if (lane == 0) {
    for (int s = 0; s < nslot; ++s) lcw4::mbar_init(wfull + s, 1);
    lcw4::mbar_init_fence();
  }
  for (int s = 0; s < nslot && more; ++s) {
    if (lane == 0)
      flash_issue<kNib>(wring + s * CB, wsring + s * kSlotScales, wfull + s,
                        fill, &kmap, &vmap, ksh, vsh, bh, b, h, S, L, sb);
    fill.c += kFlashWarps;
    more = flash_settle(fill, warp, jend, L, sb);
  }
  __syncwarp();
  int k = 0;  // the warp's chunks consumed
  // waits for the warp's chunk k
  auto wait = [&]() {
    lcw4::mbar_wait(wfull + k % nslot, (k / nslot) & 1);
  };
  // consumed chunk k: lane 0 refills its slot with the warp's chunk
  // k + nslot once every lane's reads of it are in registers used
  auto refill = [&]() {
    __syncwarp();
    if (more) {
      if (lane == 0)
        flash_issue<kNib>(wring + (k % nslot) * CB,
                          wsring + (k % nslot) * kSlotScales,
                          wfull + k % nslot, fill, &kmap, &vmap, ksh, vsh,
                          bh, b, h, S, L, sb);
      fill.c += kFlashWarps;
      more = flash_settle(fill, warp, jend, L, sb);
    }
    ++k;
  };

  float o[G], m[G], d[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    o[q] = 0.f, m[q] = -1e30f, d[q] = 0.f;
    accs[q * kAccRow + tid] = 0;
  }
  __syncthreads();
  // q8 as the scores' B fragments: k step ks, lane (g, tig) holds query g
  // at the features of rows 8 a + lane7_64(tig, j & 1), a = 4 ks' + (j >> 1)
  // (byte j of b0, j < 4; of b1, j - 4), the rows the A fragments gather;
  // kv4: ks' = ks & 1, features + 64 for ks >= 2 (the high nibbles)
  uint32_t qb[4][2];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t wd = 0u;
      if (g < G) {
        const int8_t* qg = qsh + g * kD;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * s + i, ka = kNib ? (ks & 1) : ks;
          const int r = 8 * (4 * ka + (j >> 1)) + lane7_64(tig, j & 1);
          const int f = r + ((kNib && ks >= 2) ? kD2 : 0);
          wd |= (uint32_t)(uint8_t)qg[f] << (8 * i);
        }
      }
      qb[ks][s] = wd;
    }
  float qsc[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    qsc[e] = 2 * tig + e < G ? __fmul_rn(qs[bh * G + 2 * tig + e], kScale)
                             : 0.f;
  __syncthreads();  // q8 read before the first scores overwrite it
  FLASH_STAMP(1);

  for (int j = j0; j < jend; ++j) {
    const int c0 = j * sb, n = min(sb, L - c0);
    const int nc = (n + kChunk - 1) / kChunk;

    // scores: chunk c (64 columns) of K; lane (g, tig) reads time steps
    // 8 g .. 8 g + 7 of its rows and holds m16 tile i's rows g, g + 8 as
    // time steps 8 g + 2 i, 8 g + 2 i + 1
    float mx[2] = {-INFINITY, -INFINITY};
    for (int c = warp; c < nc; c += kFlashWarps) {
      const int tb = c * kChunk;
      wait();
      FLASH_STAMP(2);
      const unsigned char* sl = wring + (k % nslot) * CB;
      const unsigned char* ssl = wsring + (k % nslot) * kSlotScales;
      // the K scales of time steps 8 g .. 8 g + 7; lanes tig 0 copy their
      // V scales into the block's vsb (the slot is refilled before the
      // softmax reads them)
      float kv[8];
      if (tb + 8 * g < n) {
        const uint4 raw = *reinterpret_cast<const uint4*>(ssl + 16 * g);
        const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int u = 0; u < 8; ++u) kv[u] = bf(kb[u]);
        if (vsb_on && tig == 0)
          *reinterpret_cast<uint4*>(vsb + tb + 8 * g) =
              *reinterpret_cast<const uint4*>(ssl + 2 * kChunk + 16 * g);
      }
      int acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0;
      bd_chunk_scores<kNib>(sl, g, tig, qb, acc);
      FLASH_STAMP(3);
      refill();
      FLASH_STAMP(4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = 2 * i + (e >> 1), t = tb + 8 * g + u;
          const int qq = 2 * tig + (e & 1);
          if (qq < G && t < n) {
            const float v = __fmul_rn(
                __fmul_rn(lcw4::exact_f32(acc[i][e]), qsc[e & 1]), kv[u]);
            sc[qq * ss + t] = v;
            mx[e & 1] = fmaxf(mx[e & 1], v);
          }
        }
      FLASH_STAMP(5);
    }
    // exchange 1: the block's max
    FLASH_STAMP(6);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], off));
    if (g == 0) {
      red[warp * 8 + 2 * tig] = mx[0];
      red[warp * 8 + 2 * tig + 1] = mx[1];
    }
    __syncthreads();
    FLASH_STAMP(7);
    float alpha[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      float bm = red[q];
#pragma unroll
      for (int w = 1; w < kFlashWarps; ++w) bm = fmaxf(bm, red[w * 8 + q]);
      const float mn = fmaxf(m[q], fmaxf(bm, -1e30f));
      alpha[q] = expf(m[q] - mn);
      m[q] = mn;
    }

    // e = exp(s - m'), pv = e * vs in place of the scores; sum(e), max(pv)
    float es[G], pm[G];
#pragma unroll
    for (int q = 0; q < G; ++q) es[q] = 0.f, pm[q] = 0.f;
    for (int t = tid; t < n; t += kFlashThreads) {
      const float vsv = bf(vsb_on ? vsb[t] : vsh[c0 + t]);
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const float e = expf(sc[q * ss + t] - m[q]);
        es[q] += e;
        const float pv = __fmul_rn(e, vsv);
        sc[q * ss + t] = pv;
        pm[q] = fmaxf(pm[q], pv);
      }
    }
    // exchange 2: sum(e) in warp order, max(pv); ps = max(max(pv), 1e-20) / 127
    FLASH_STAMP(8);
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        es[q] += __shfl_xor_sync(0xffffffffu, es[q], off);
        pm[q] = fmaxf(pm[q], __shfl_xor_sync(0xffffffffu, pm[q], off));
      }
    if (lane == 0)
#pragma unroll
      for (int q = 0; q < G; ++q) {
        red[kFlashWarps * 8 + warp * 8 + q] = es[q];
        red[2 * kFlashWarps * 8 + warp * 8 + q] = pm[q];
      }
    __syncthreads();
    FLASH_STAMP(9);
    float esum[G], ps[G], psg = 1.f;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      float a = red[kFlashWarps * 8 + q], p = red[2 * kFlashWarps * 8 + q];
#pragma unroll
      for (int w = 1; w < kFlashWarps; ++w) {
        a += red[kFlashWarps * 8 + w * 8 + q];
        p = fmaxf(p, red[2 * kFlashWarps * 8 + w * 8 + q]);
      }
      esum[q] = a;
      ps[q] = fmaxf(p, 1e-20f) / 127.0f;
      if (g == q) psg = ps[q];
    }

    // PV: chunk c (64 time steps) of V (bd_chunk_pv), its p8 B fragments
    // made before the chunk's wait (p8_frags)
    int pacc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) pacc[i][e] = 0;
    const bool pv_any = warp < nc;
    const float psinv = __frcp_rn(psg);
    for (int c = warp; c < nc; c += kFlashWarps) {
      const int tb = c * kChunk;
      uint32_t bws[2][2];
      p8_frags<kNib>(sc + min(g, G - 1) * ss, ss, tb, n, g < G, tig, psinv,
                     psg, bws);
      FLASH_STAMP(10);
      wait();
      FLASH_STAMP(11);
      const unsigned char* sl = wring + (k % nslot) * CB;
      bd_chunk_pv<kNib>(sl, g, tig, bws, pacc);
      FLASH_STAMP(12);
      refill();
      FLASH_STAMP(13);
    }
    FLASH_STAMP(14);
    if (pv_any)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = 2 * tig + (e & 1);
          if (qq < G)
            atomicAdd(accs + qq * kAccRow + (2 * i + (e >> 1)) * 8 + g,
                      pacc[i][e]);
        }
    // exchange 3: the block's int32 PV sums; (o, d) of feature tid, at
    // (phi, g) of its lane group (kv8: 16 g + phi; kv4: 8 g + phi, and 64 +
    // 8 g + phi - 8 from phi 8 on)
    __syncthreads();
    FLASH_STAMP(15);
    const int acc_at =
        kNib ? ((tid & 7) + (tid >= kD2 ? 8 : 0)) * 8 + ((tid & (kD2 - 1)) >> 3)
             : (tid & 15) * 8 + (tid >> 4);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int a = accs[q * kAccRow + acc_at];
      accs[q * kAccRow + acc_at] = 0;
      o[q] = __fadd_rn(__fmul_rn(o[q], alpha[q]),
                       __fmul_rn(__int2float_rn(a), ps[q]));
      d[q] = __fadd_rn(__fmul_rn(d[q], alpha[q]), esum[q]);
    }
  }

  FLASH_STAMP(16);
  if (nv == 1) {  // the slot's only active rank
#pragma unroll
    for (int q = 0; q < G; ++q) {
      ctx[((size_t)bh * G + q) * kD + tid] = o[q];
      if (tid == q) {
        m_out[bh * G + q] = m[q];
        d_out[bh * G + q] = d[q];
      }
    }
    return;
  }
  // the rank's (o, m, d) into the scratch [pairs][P][G][D + 2]; the last
  // active rank to arrive merges them in rank order
  float* mine = part + ((size_t)bh * P + rank) * G * (kD + 2);
#pragma unroll
  for (int q = 0; q < G; ++q) {
    mine[q * (kD + 2) + tid] = o[q];
    if (tid == q) {
      mine[q * (kD + 2) + kD] = m[q];
      mine[q * (kD + 2) + kD + 1] = d[q];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counters + bh, 1) == nv - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // the ranks' m and d into shared memory (the scores' room), then their
  // weights exp(m_r - m), m = max(m_r), one thread a (query, rank); the
  // contexts' loads of all ranks in flight at once
  const float* all = part + (size_t)bh * P * G * (kD + 2);
  float* pm = sc;                            // [G][16] m_r, then weights
  float* pd = sc + G * kFlashMaxParts;       // [G][16] d_r
  float* mrow = pd + G * kFlashMaxParts;     // [G] m
  for (int i = tid; i < G * nv; i += kFlashThreads) {
    const int q = i / nv, r = i - q * nv;
    const float* pr = all + ((size_t)r * G + q) * (kD + 2);
    pm[q * kFlashMaxParts + r] = __ldcg(pr + kD);
    pd[q * kFlashMaxParts + r] = __ldcg(pr + kD + 1);
  }
  __syncthreads();
  float wgt = 0.f;
  if (tid < G * nv) {
    const int q = tid / nv, r = tid - q * nv;
    float mm = pm[q * kFlashMaxParts];
    for (int i = 1; i < nv; ++i) mm = fmaxf(mm, pm[q * kFlashMaxParts + i]);
    wgt = expf(pm[q * kFlashMaxParts + r] - mm);
    if (r == 0) mrow[q] = mm;
  }
  __syncthreads();
  if (tid < G * nv) {
    const int q = tid / nv, r = tid - q * nv;
    pm[q * kFlashMaxParts + r] = wgt;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < G; ++q) {
    float ov[kFlashMaxParts];
#pragma unroll
    for (int r = 0; r < kFlashMaxParts; ++r)
      ov[r] = r < nv ? __ldcg(all + ((size_t)r * G + q) * (kD + 2) + tid)
                     : 0.f;
    float oa = __fmul_rn(ov[0], pm[q * kFlashMaxParts]);
#pragma unroll
    for (int r = 1; r < kFlashMaxParts; ++r)
      if (r < nv)
        oa = __fadd_rn(oa, __fmul_rn(ov[r], pm[q * kFlashMaxParts + r]));
    ctx[((size_t)bh * G + q) * kD + tid] = oa;
  }
  if (tid < G) {
    float da = __fmul_rn(pd[tid * kFlashMaxParts], pm[tid * kFlashMaxParts]);
    for (int r = 1; r < nv; ++r)
      da = __fadd_rn(da, __fmul_rn(pd[tid * kFlashMaxParts + r],
                                   pm[tid * kFlashMaxParts + r]));
    m_out[bh * G + tid] = mrow[tid];
    d_out[bh * G + tid] = da;
  }
  if (tid == 0) counters[bh] = 0;  // ready for the next call
  FLASH_STAMP(17);
}

// ---------------------------------------------------------------------------
// #22: bf16 q (B, H, G, D) over the int8 cache (B, H, S, D) with per-token
// scales (B, H, S) (ST = bf16 or f32), no length mask (every column is
// read: the caller appended the fresh token), the normalized context out:
//   s = (f32 dot(bf16 q, bf16 k)) * ks * D^-0.5;  p = e / sum(e),
//   e = exp(s - max(s));  pv = bf16(p * vs);  out = f32 dot(pv, bf16 v).
// Every product (a bf16 q or pv times an int8 code) is exact in f32; only
// the order of the f32 sums differs from the plain version.
//
// Bound on an H100 SXM: bytes (K and V, 2 * 128 code bytes and 2 scales a
// column and kv head), against 4 * G * D operations a column on the bf16
// tensor cores.  What the design does about it:
//   * A thread-block cluster of P CTAs (P = 1, 2, 4 or 8, chosen by the
//     wrapper, ops/attention.kv8_parts) per (slot, kv head), grid
//     (P * H, B): rank r takes the columns [r * per, (r + 1) * per), per =
//     ceil(S / P) rounded up to 16, so that 8 slots fill the card as well as
//     32.  A rank with no columns adds exactly 0.
//   * The K slab and then the V slab of the rank's columns (contiguous runs
//     of 128-byte rows) stream through a ring of kKvSlots chunks of 128 rows
//     (16 KB each, 64 KB in flight a CTA), copied by the tensor memory
//     accelerator in boxes of 16 rows with the 128-byte swizzle (the tail
//     chunk takes only the boxes it needs) and counted by mbarriers.  Thread
//     0 refills a slot once all eight warps have released it (after their
//     products, which consumed the loaded registers); V's chunks
//     follow K's in the same ring, so V's first 64 KB arrive while the
//     softmax runs.
//   * Both dots run on the bf16 tensor cores (mma.sync m16n8k16, f32
//     accumulation), the int8 codes turned into bf16 exactly in registers
//     (two masks and a bf16x2 subtract for two codes: 128 + (c & 127) less
//     128 + (c & 128)), never through an int-to-float conversion (16 a clock
//     an SM; at the bench's shape those alone would take most of the bound).
//     Scores: A = 16 time steps x 16 features of K, B = q (its G rows the n8
//     columns, zero past G); a thread reads 32 contiguous code bytes of each
//     of its two rows, which fixes its features of every k step (the q
//     fragments follow the same order).  PV: A = V^T (16 features x 16 time
//     steps), B = pv^T; a thread reads a 16-byte run of features from four
//     rows and pairs the two time steps of a feature with a byte permute.
//     Both reads hit 32 distinct banks in the swizzled chunks.  A warp takes
//     one m16 block of every chunk: 16 rows of K, or 16 time steps of V.
//     CUDA cores with a byte-permute conversion to f32 were not built: their
//     G f32 multiply-adds a code (G = 4: about 5 ops a code on the f32 pipe,
//     twice the tensor-core route's issue) would bound the kernel at G >= 4.
//   * The TPU's numerics round pv = bf16(p * vs) after normalizing, so the
//     PV dot needs the whole row's max and sum.  Each thread keeps a running
//     max and sum of exp(s - max) of its scores (the sum rescaled when the
//     max grows, an online softmax; its f32 roundings differ from the plain
//     version's sum of e within the gate), merged over the lanes by a fixed
//     tree, over the warps in order, and over the ranks in order: the
//     cluster meets once through distributed shared memory for the max and
//     the sum, and once more for the PV partials (rank r adds features [r *
//     D / P, (r + 1) * D / P) of every rank's partial in rank order).  Each
//     CTA adds its warps' partials in warp order, so a second call gives the
//     same bits.
//   * Shared memory: the ring, the rank's f32 scores (G * per), its PV
//     partial.  A warp makes its own pv B fragments in the PV loop (an exp
//     and a division a lane a time step, the V scales read a chunk ahead),
//     so no pass over the row stands between the sum and V's first chunk.
//     S is bounded by a rank's share at P = 8: S <= 81280 at G = 4 (the
//     wrapper raises above it).
// ---------------------------------------------------------------------------
constexpr int kKvRows = 128;              // time steps of a ring chunk
constexpr int kKvBox = 16;                // rows of one TMA box
constexpr int kKvSlots = 4;               // ring depth
constexpr int kKvChunk = kKvRows * kD;    // bytes of a chunk (16 KB)
constexpr int kKvScratch = 1024;          // reductions and mbarriers

// the f32 score rows of a rank's `per` columns: a stride that puts the
// mma fragments' stores on distinct banks
__host__ __device__ constexpr int kv8_sc_stride(int per) { return per + 4; }

// dynamic shared memory of a CTA (ops/attention.kv8_smem_bytes): 1024 bytes
// of alignment slack, the ring, the scores, the PV partial, the scratch
inline size_t kv8_smem(int G, int per) {
  return 1024 + (size_t)kKvSlots * kKvChunk +
         (size_t)G * kv8_sc_stride(per) * 4 + (size_t)G * kD * 4 +
         kKvScratch;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster; orders shared-memory writes
// before it with reads after it, across the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the float at p in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t a;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(lcw4::smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          lcw4::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The int8 codes in bytes 0 and 2 of z as a bf16 pair (byte 0 in the low
// half), exactly: (128 + (c & 127)) + (-(128 + (c & 128))) in one bf16x2
// multiply-add by 1; both terms and the difference are bf16 integers.
__device__ __forceinline__ uint32_t codes02_bf16(uint32_t z) {
  const uint32_t a = (z & 0x007F007Fu) | 0x43004300u;
  const uint32_t nb = (z & 0x00800080u) | 0xC300C300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3F803F80u), "r"(nb));
  return d;
}

// byte offset of 16-byte chunk c of row r of a ring chunk (the TMA's
// 128-byte swizzle on a 1024-byte aligned slot)
__device__ __forceinline__ int kv_swz(int r, int c) {
  return r * kD + ((c ^ (r & 7)) << 4);
}

// (m, s) of a softmax over some columns merged with (m2, s2) of others: the
// larger max and the sums rescaled to it (an empty side, max -inf, adds 0)
__device__ __forceinline__ void softmax_merge(float& m, float& s, float m2,
                                              float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;
  s = __fadd_rn(s * expf(m - mm), s2 * expf(m2 - mm));
  m = mm;
}

template <int G, typename ST>
__global__ void __launch_bounds__(kThreads)
attn_kv8_kernel(const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __nv_bfloat16* __restrict__ q,
                const ST* __restrict__ ks, const ST* __restrict__ vs,
                float* __restrict__ out, int S, int parts, int per) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (lcw4::smem_u32(smem_raw) & 1023)) & 1023);
  const int ss = kv8_sc_stride(per);
  float* sc = reinterpret_cast<float*>(ring + kKvSlots * kKvChunk);  // [G][ss]
  float* part = sc + G * ss;        // [G][kD] the CTA's PV partial
  float* redm = part + G * kD;      // [kWarps][8] the warps' maxima
  float* reds = redm + kWarps * 8;  // [kWarps][8] and sums
  float* xm = reds + kWarps * 8;    // [8] the CTA's maxima, read by the cluster
  float* xs = xm + 8;               // [8] and sums
  float* mrow = xs + 8;             // [8] the row's max
  float* srow = mrow + 8;           // [8] the row's sum
  uint64_t* full = reinterpret_cast<uint64_t*>(srow + 8);
  uint64_t* empty = full + kKvSlots;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  const int rank = (int)cluster_rank();
  const int H = gridDim.x / parts, bh = blockIdx.y * H + blockIdx.x / parts;
  const int t0 = rank * per, n = max(0, min(per, S - t0));
  const int nk = (n + kKvRows - 1) / kKvRows;  // chunks of K, then of V
  const int total = 2 * nk;
  const int row0 = bh * S + t0;  // the rank's first row of the slabs

  // chunk c (K for c < nk, then V) into slot c % kKvSlots: the boxes of its
  // rows, thread 0 alone
  auto issue = [&](int c) {
    const int slot = c % kKvSlots, cl = c < nk ? c : c - nk;
    const int boxes = (min(kKvRows, n - cl * kKvRows) + kKvBox - 1) / kKvBox;
    lcw4::mbar_expect_tx(full + slot, boxes * kKvBox * kD);
    for (int j = 0; j < boxes; ++j)
      lcw4::tma_load_2d(ring + slot * kKvChunk + j * kKvBox * kD,
                        c < nk ? (const void*)&kmap : (const void*)&vmap, 0,
                        row0 + cl * kKvRows + j * kKvBox, full + slot);
  };
  // the warp is done with chunk c (its products have consumed the loaded
  // registers); thread 0 refills the slot once all eight warps are.
  // Released right after the loads, before the products, the refill's TMA
  // writes overtook reads still in flight (wrong scores at G = 8, B 32).
  auto release = [&](int c) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + c % kKvSlots);
    if (tid == 0 && c + kKvSlots < total) {
      lcw4::mbar_wait(empty + c % kKvSlots, (c / kKvSlots) & 1);
      issue(c + kKvSlots);
    }
    __syncwarp();  // warp 0 whole again for its mma.sync
  };

  if (tid == 0) {
    for (int i = 0; i < kKvSlots; ++i) {
      lcw4::mbar_init(full + i, 1);
      lcw4::mbar_init(empty + i, kWarps);
    }
    lcw4::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < min(kKvSlots, total); ++c) issue(c);

  // q as the scores' B fragments: k step kb of thread (g, tq) holds
  // features 32 tq + 4 kb + {0, 2} (b0) and {1, 3} (b1) of query row g, the
  // order in which codes02_bf16 lays out its K words; zero past G
  uint32_t qb[8][2];
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    qb[kb][0] = qb[kb][1] = 0u;
    if (g < G) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          q + ((size_t)bh * G + g) * kD + 32 * tq + 4 * kb);
      qb[kb][0] = __byte_perm(v.x, v.y, 0x5410);
      qb[kb][1] = __byte_perm(v.x, v.y, 0x7632);
    }
  }

  // scores: warp w takes rows 16 w .. 16 w + 15 of every K chunk; thread
  // (g, tq) reads 32 code bytes (chunks 2 tq and 2 tq + 1) of rows g and
  // g + 8 and holds the scores of those rows for queries 2 tq, 2 tq + 1,
  // with its running max and sum of exp(s - max) of each (an online
  // softmax: the sum rescaled when the max grows).  The K scales are read
  // a chunk ahead.
  const ST* ksr = ks + row0;
  auto ks_at = [&](int tl) { return tl < n ? to_f32(ksr[tl]) : 0.f; };
  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
  float kn[2] = {ks_at(16 * warp + g), ks_at(16 * warp + g + 8)};
  for (int c = 0; c < nk; ++c) {
    const int tl0 = c * kKvRows + 16 * warp;
    const bool live = tl0 < n;
    const float kv[2] = {kn[0], kn[1]};
    kn[0] = ks_at(tl0 + kKvRows + g);
    kn[1] = ks_at(tl0 + kKvRows + g + 8);
    lcw4::mbar_wait(full + c % kKvSlots, (c / kKvSlots) & 1);
    if (!live) {
      release(c);
      continue;
    }
    const unsigned char* sl = ring + (c % kKvSlots) * kKvChunk;
    int4 w[2][2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        w[rr][hh] = *reinterpret_cast<const int4*>(
            sl + kv_swz(16 * warp + g + 8 * rr, 2 * tq + hh));
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      const uint32_t wa = reinterpret_cast<const uint32_t*>(&w[0][kb >> 2])[kb & 3];
      const uint32_t wb = reinterpret_cast<const uint32_t*>(&w[1][kb >> 2])[kb & 3];
      mma_bf16(acc, codes02_bf16(wa), codes02_bf16(wb), codes02_bf16(wa >> 8),
               codes02_bf16(wb >> 8), qb[kb][0], qb[kb][1]);
    }
    release(c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tl = tl0 + g + 8 * (e >> 1), qi = 2 * tq + (e & 1);
      if (qi < G && tl < n) {
        const float s = __fmul_rn(__fmul_rn(acc[e], kv[e >> 1]), kScale);
        sc[qi * ss + tl] = s;
        float& m = mx[e & 1];
        float& a = sm[e & 1];
        if (s > m) {
          a = __fadd_rn(a * expf(m - s), 1.f);
          m = s;
        } else {
          a = __fadd_rn(a, expf(s - m));
        }
      }
    }
  }
  // the row's max and sum: the lanes of a query (a fixed tree), the warps
  // in order, then the cluster's ranks in order
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      softmax_merge(mx[j], sm[j], __shfl_xor_sync(0xffffffffu, mx[j], o),
                    __shfl_xor_sync(0xffffffffu, sm[j], o));
  if (g == 0)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (2 * tq + j < G) {
        redm[warp * 8 + 2 * tq + j] = mx[j];
        reds[warp * 8 + 2 * tq + j] = sm[j];
      }
  __syncthreads();
  if (tid < G) {
    float m = redm[tid], a = reds[tid];
    for (int w = 1; w < kWarps; ++w)
      softmax_merge(m, a, redm[w * 8 + tid], reds[w * 8 + tid]);
    xm[tid] = m;
    xs[tid] = a;
  }
  cluster_sync();  // 1: every rank's max and sum
  if (tid < G) {
    float m = ld_cluster(xm + tid, 0), a = ld_cluster(xs + tid, 0);
    for (int r = 1; r < parts; ++r)
      softmax_merge(m, a, ld_cluster(xm + tid, r), ld_cluster(xs + tid, r));
    mrow[tid] = m;
    srow[tid] = a;
  }
  __syncthreads();

  // PV: warp w takes time steps 16 w .. 16 w + 15 of every V chunk; m16
  // tile 2 i + hh, row g + 8 j of thread (g, tq) is feature 16 g + 4 i +
  // 2 hh + j, read as byte 2 hh + j of word i of the 16-byte chunk g of
  // rows 2 tq, 2 tq + 1 (slots 2 tq, 2 tq + 1) and 2 tq + 8, 2 tq + 9.
  // Its B fragment, pv = bf16((exp(s - max) / sum) * vs) of query g at
  // those four time steps (0 past n), it computes itself, the V scales read
  // a chunk ahead, so V's chunks are consumed as soon as the sum is known.
  const ST* vsr = vs + row0;
  const float m_g = g < G ? mrow[g] : 0.f, sum_g = g < G ? srow[g] : 1.f;
  auto vs_at = [&](int tl) {
    return (g < G && tl < n) ? to_f32(vsr[tl]) : 0.f;
  };
  float vn[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    vn[j] = vs_at(16 * warp + 2 * tq + (j & 1) + 8 * (j >> 1));
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int c = nk; c < total; ++c) {
    const int tl0 = (c - nk) * kKvRows + 16 * warp;
    const bool live = tl0 < n;
    float pv[4];  // time steps 2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tl = tl0 + 2 * tq + (j & 1) + 8 * (j >> 1);
      pv[j] = (g < G && tl < n)
                  ? __fmul_rn(__fdiv_rn(expf(sc[g * ss + tl] - m_g), sum_g),
                              vn[j])
                  : 0.f;
      vn[j] = vs_at(tl + kKvRows);
    }
    const __nv_bfloat162 p01 = __floats2bfloat162_rn(pv[0], pv[1]);
    const __nv_bfloat162 p89 = __floats2bfloat162_rn(pv[2], pv[3]);
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&p01);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&p89);
    lcw4::mbar_wait(full + c % kKvSlots, (c / kKvSlots) & 1);
    if (!live) {
      release(c);
      continue;
    }
    const unsigned char* sl = ring + (c % kKvSlots) * kKvChunk;
    int4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = *reinterpret_cast<const int4*>(
          sl + kv_swz(16 * warp + 2 * tq + (j & 1) + 8 * (j >> 1), g));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t sel = hh ? 0x7632u : 0x5410u;
        const uint32_t z0 = __byte_perm(
            reinterpret_cast<const uint32_t*>(&v[0])[i],
            reinterpret_cast<const uint32_t*>(&v[1])[i], sel);
        const uint32_t z1 = __byte_perm(
            reinterpret_cast<const uint32_t*>(&v[2])[i],
            reinterpret_cast<const uint32_t*>(&v[3])[i], sel);
        mma_bf16(acc[2 * i + hh], codes02_bf16(z0), codes02_bf16(z0 >> 8),
                 codes02_bf16(z1), codes02_bf16(z1 >> 8), b0, b1);
      }
    release(c);
  }

  // the warps' partials through the ring (every chunk has landed and been
  // read), added in warp order into the CTA's partial
  __syncthreads();
  float* red2 = reinterpret_cast<float*>(ring);  // [kWarps][G][kD]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 2 * tq + (e & 1);
        if (qi < G)
          red2[(warp * G + qi) * kD + 16 * g + 4 * i + 2 * hh + (e >> 1)] =
              acc[2 * i + hh][e];
      }
  __syncthreads();
  for (int i = tid; i < G * kD; i += kThreads) {
    float a = red2[i];
    for (int w = 1; w < kWarps; ++w) a += red2[w * G * kD + i];
    part[i] = a;
  }
  cluster_sync();  // 2: every rank's partial
  const int nf = kD / parts;
  for (int i = tid; i < G * nf; i += kThreads) {
    const int qi = i / nf, f = rank * nf + i % nf;
    float a = ld_cluster(part + qi * kD + f, 0);
    for (int r = 1; r < parts; ++r) a += ld_cluster(part + qi * kD + f, r);
    out[((size_t)bh * G + qi) * kD + f] = a;
  }
  cluster_sync();  // 3: no CTA leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// #17 (kSplitI8), #18 (kSplitKv8) and #20 (kSplitKv4): one pass over the
// buffer, S split over a thread-block cluster.
//   #18: the kv8 bd slabs; (ctx unnormalized, m, d).
//   #20: the kv4 bd4 slabs (R = D/2 bytes a head and token, two nibbles a
//        byte); (ctx unnormalized, m, d), as #18.
//   #17: the int8 hhd cache (B, H, S, D) plus the fresh token as one more
//        softmax column, not requantized:
//          m = max(max(s), s_new); denom = sum(e) + e_new;
//          out = (f32(p8 . v) * ps + (e_new * vns) * v_new) / denom.
//
// Bound on an H100 SXM: bytes (K and V of the valid columns, 2 * R code
// bytes and 2 scales a column and kv head), against 4 * G * D int8
// operations a column.  The TPU kernels' probability scale ps is a max over
// the whole row, so the scores, the softmax and the PV dot depend on each
// other in turn; a whole-row block per (slot, kv head) left half of the
// card idle at 8 slots of 8 kv heads and streamed each head alone.  The
// design:
//   * S split over a cluster of P CTAs (P = 1, 2, 4 or 8, chosen on the host
//     from S, B * H, G and the card's cluster occupancy, never from the
//     lengths: ops/attention.split_parts) per (slot, kv head), grid (P * H,
//     B): rank r takes the columns [r * per, (r + 1) * per), per = ceil(S /
//     P) rounded up to 16, and holds their f32 scores (then pv) and V scales
//     in shared memory, so the shared-memory cap bounds a rank's columns,
//     not the row.
//   * Each of the four warps streams its own chunks of 64 columns (K, then
//     V; chunk c of the rank to warp c % 4) through a ring of `nslot` slots
//     on mbarriers, lane 0 issuing one TMA box a chunk (#18: K feature-major,
//     R rows x 64 columns, 64-byte swizzle, with the chunk's K and V scales
//     by two bulk copies; V time-major, 64 rows x 128 bytes, 128-byte
//     swizzle; #20: K R rows x 64 columns and V 64 rows x R bytes, both
//     in the 64-byte swizzle, #21's boxes; #17: the (B * H * S, D) rows of
//     K and of V, 64 rows x 128 bytes, 128-byte swizzle, K's chunks with
//     the scales), and refilling a
//     slot only after the products that read it and a __syncwarp (PR 15's
//     rule).  On rank 0 a warp's first K chunk goes out before the slot's
//     length is read (over the rank's columns of the buffer), so for a
//     short slot the length's load and the copy overlap.  A warp's V chunks follow its K chunks in its
//     ring, so its first V copies are in flight while the cluster meets
//     and the softmax runs.
//   * Both dots on the int8 tensor cores (mma.sync m16n8k32 s8.s8.s32,
//     exact): scores with A = 16 time steps x 32 features of K, B = q8 (its
//     G rows the n8 columns); PV with A = 16 features x 32 time steps of V,
//     B = p8.  #18's K is feature-major, so its A fragments take #19's 4 x 4
//     byte transposes; #20's take #21's (its nibbles sign-extended after
//     the transpose, q's low half against the low nibbles, features d, its
//     high half against the high ones, d + 64); #17's K rows are time-major
//     and load as A fragments
//     as they are (lane (g, tig) reads 32 bytes of time steps g and g + 8,
//     features 32 tig .. 32 tig + 31; q8 follows the same feature order).
//     V is time-major in every cache: #19's kv8 PV fragments (#17, #18),
//     #21's kv4 ones (#20).
//   * Three meets of the cluster through distributed shared memory, each
//     read in rank order: (a) the row max m (#18, #20 floored at -1e30, #17
//     with the fresh token's score); (b) the max of pv, giving ps by IEEE
//     division, and the f32 sums of e, giving d; (c) the int32 PV partials
//     (rank r adds features [r * D / P, (r + 1) * D / P) of every rank's
//     partial: exact), times ps.  So m, ps, p8 and the unnormalized context
//     are the same bits at every P (the TPU kernels' ps is a max over the
//     whole row, so #20 meets as #18 and not as #21's per-block scale);
//     only d, and #17's output through d,
//     follow the f32 order of the sums (lanes by a fixed tree, warps and
//     ranks in order: a second call gives the same bits).
//   * The cluster barrier rule: every rank, one with no valid column too,
//     runs every barrier.cluster of the kernel (four), and none leaves
//     before the last, after which no rank reads another's shared memory.
//     A rank that skipped one would hang the cluster or read freed memory.
//     A rank's chunk count follows its valid columns, and a warp waits only
//     on chunks it issued (a first chunk past them before the last meet).
// ---------------------------------------------------------------------------
constexpr int kSplitScratch = 1024;  // bytes of the exchanges
// the split's operands: #18's kv8 bd slabs, #17's int8 hhd cache, #20's
// kv4 bd4 slabs (lc_attn_split_clusters' `mode`)
constexpr int kSplitKv8 = 0, kSplitI8 = 1, kSplitKv4 = 2;

// the f32 score rows of a rank's `per` columns: a stride that keeps the
// mma fragments' score stores of both layouts within two lanes a bank
__host__ __device__ constexpr int split_sc_stride(int per) {
  return ((per + 31) & ~31) + 9;
}

// dynamic shared memory of a #17/#18/#20 CTA (ops/attention.split_smem_bytes):
// 1024 bytes of alignment slack, the ring (codes: R x 64 bytes a slot, R =
// D/2 for #20's nibbles (nib), else D; scales, the slots' mbarriers), the
// int32 PV sums, q8, the exchanges, the rank's V scales (bf16) and scores
inline size_t split_smem(int G, int per, int nslot, bool nib) {
  return 1024 +
         (size_t)kFlashWarps * nslot *
             (flash_slot_bytes(nib) + kSlotScales + 8) +
         (size_t)G * kAccRow * 4 + (size_t)G * kD + kSplitScratch +
         (size_t)per * 2 + (size_t)G * split_sc_stride(per) * 4;
}

// the int at p in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ int ld_cluster_s32(const int* p, uint32_t rank) {
  uint32_t a;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(lcw4::smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(a)
               : "memory");
  return v;
}

// the two halves of cluster_sync: this thread's arrival (its shared-memory
// reads and writes before it ordered with the cluster's after the wait)
// and the wait for every thread of the cluster
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the operands of #17/#18/#20 besides the TMA maps (#18, #20: kn .. vns
// null, out the unnormalized ctx; #17: m and d null)
struct SplitPtrs {
  const int8_t* q8;
  const float* qs;
  const __nv_bfloat16* ks;
  const __nv_bfloat16* vs;
  const int* lengths;
  const int8_t* kn;
  const __nv_bfloat16* kns;
  const int8_t* vn;
  const __nv_bfloat16* vns;
  float* out;
  float* m;
  float* d;
};

template <int G, int kMode>
__global__ void __launch_bounds__(kFlashThreads)
attn_split_kernel(const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const SplitPtrs p, int S, int parts, int per, int nslot) {
  constexpr bool kI8 = kMode == kSplitI8, kNib = kMode == kSplitKv4;
  constexpr int R = kNib ? kD2 : kD;  // code bytes a head and token
  constexpr int CB = R * kChunk;      // code bytes of a ring slot
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (lcw4::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sring = ring + kFlashWarps * nslot * CB;  // the scales
  uint64_t* full =
      reinterpret_cast<uint64_t*>(sring + kFlashWarps * nslot * kSlotScales);
  int* accs = reinterpret_cast<int*>(full + kFlashWarps * nslot);
  int8_t* qsh = reinterpret_cast<int8_t*>(accs + G * kAccRow);  // [G][kD]
  float* red = reinterpret_cast<float*>(qsh + G * kD);  // [3][warps][8]
  float* xm = red + 3 * kFlashWarps * 8;  // [8] the CTA's max (meet a)
  float* xs = xm + 8;                     // [8] its sum of e (meet b)
  float* xp = xs + 8;                     // [8] its max of pv (meet b)
  float* rm = xp + 8;                     // [8] the row's m
  float* rd = rm + 8;                     // [8] d
  float* rps = rd + 8;                    // [8] ps
  float* rsn = rps + 8;                   // [8] #17: s_new, then e_new
  __nv_bfloat16* vsb =
      reinterpret_cast<__nv_bfloat16*>(red + kSplitScratch / 4);  // [per]
  float* sc = reinterpret_cast<float*>(vsb + per);                 // [G][ss]
  const int ss = split_sc_stride(per);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int rank = (int)cluster_rank();
  const int H = gridDim.x / parts, h = blockIdx.x / parts, b = blockIdx.y;
  const int bh = b * H + h;
  const int t0 = rank * per;                  // the rank's first column
  const int span = max(0, min(per, S - t0));  // its columns of the buffer
  const __nv_bfloat16* ksr = p.ks + (size_t)bh * S + t0;
  const __nv_bfloat16* vsr = p.vs + (size_t)bh * S + t0;
  unsigned char* wring = ring + warp * nslot * CB;
  unsigned char* wsring = sring + warp * nslot * kSlotScales;
  uint64_t* wfull = full + warp * nslot;

  // lane 0: the K chunk at the rank's column cl (its TMA box and the K and
  // V scales of `cols` columns, a multiple of 16 within the buffer) or the
  // V chunk there (v) into the warp's slot
  auto issue_at = [&](int slot, int cl, bool v, int cols) {
    const int col = t0 + cl;
    unsigned char* dst = wring + slot * CB;
    uint64_t* bar = wfull + slot;
    if (!v) {
      unsigned char* sdst = wsring + slot * kSlotScales;
      lcw4::mbar_expect_tx(bar, CB + 4 * cols);
      if constexpr (kI8)
        lcw4::tma_load_2d(dst, &kmap, 0, bh * S + col, bar);
      else
        lcw4::tma_load_2d(dst, &kmap, col, bh * R, bar);
      bulk_load(sdst, ksr + cl, 2 * cols, bar);
      bulk_load(sdst + 2 * kChunk, vsr + cl, 2 * cols, bar);
    } else {
      lcw4::mbar_expect_tx(bar, CB);
      if constexpr (kI8)
        lcw4::tma_load_2d(dst, &vmap, 0, bh * S + col, bar);
      else
        lcw4::tma_load_2d(dst, &vmap, h * R, b * S + col, bar);
    }
  };
  // rank 0 (which holds a slot's first columns: any valid column at all)
  // issues the warp's first K chunk before the slot's length is read (over
  // its columns of the buffer; the length cuts what is used); the other
  // ranks wait for the length, so no rank streams a chunk past it
  const int cols0 = rank == 0 ? min(kChunk, span - warp * kChunk) : 0;
  if (lane == 0) {
    if (warp == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&kmap) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&vmap) : "memory");
    }
    for (int s = 0; s < nslot; ++s) lcw4::mbar_init(wfull + s, 1);
    lcw4::mbar_init_fence();
    if (cols0 > 0) issue_at(0, warp * kChunk, false, cols0);
  }
  // the per-thread operands, in flight with it: the queries' scales; #17
  // the fresh token's word of the lane, its scales, and the thread's
  // feature of v_new in meet (c) (rank r's features r * nf + tid % nf)
  float qsc[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    qsc[e] = 2 * tig + e < G ? __fmul_rn(p.qs[bh * G + 2 * tig + e], kScale)
                             : 0.f;
  int knw = 0;
  float qsw[2] = {0.f, 0.f}, knsf = 0.f, vnsf = 0.f, vnf = 0.f;
  if constexpr (kI8) {
    knw = __ldg(reinterpret_cast<const int*>(p.kn + (size_t)bh * kD) + lane);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (warp + kFlashWarps * j < G)
        qsw[j] = __fmul_rn(p.qs[bh * G + warp + kFlashWarps * j], kScale);
    knsf = bf(p.kns[bh]);
    vnsf = bf(p.vns[bh]);
    const int nf = kD / parts;
    vnf = (float)p.vn[(size_t)bh * kD + rank * nf + tid % nf];
  }
  const int L = min(max(p.lengths[b], 0), S);
  const int n = max(0, min(span, L - t0));   // the rank's valid columns
  const int nc = (n + kChunk - 1) / kChunk;  // its chunks of K (and of V)
  // the warp's chunks: K chunks warp, warp + 4, .. (fill indices 0 ..
  // nkw - 1), then the V chunks of the same columns; fill 0, when there
  // is one, is the chunk already issued
  const int nkw = warp < nc ? (nc - 1 - warp) / kFlashWarps + 1 : 0;
  const int nfill = 2 * nkw;
  auto issue = [&](int f) {
    const bool v = f >= nkw;
    const int cl = (warp + kFlashWarps * (v ? f - nkw : f)) * kChunk;
    issue_at(f % nslot, cl, v, v ? 0 : (min(kChunk, n - cl) + 15) & ~15);
  };
  if (lane == 0)
    for (int f = cols0 > 0 ? 1 : 0; f < min(nslot, nfill); ++f) issue(f);
  __syncwarp();
  int k = 0;  // the warp's chunks consumed
  auto wait = [&]() {
    lcw4::mbar_wait(wfull + k % nslot, (k / nslot) & 1);
  };
  // consumed chunk k: lane 0 refills its slot with the warp's fill
  // k + nslot once every lane's reads of it are in registers used
  auto refill = [&]() {
    __syncwarp();
    if (lane == 0 && k + nslot < nfill) issue(k + nslot);
    ++k;
  };

  // q8 of the pair's G queries; the PV sums zeroed
  if (tid < G * kD / 16)
    reinterpret_cast<uint4*>(qsh)[tid] = __ldg(
        reinterpret_cast<const uint4*>(p.q8 + (size_t)bh * G * kD) + tid);
  for (int i = tid; i < G * kAccRow; i += kFlashThreads) accs[i] = 0;
  __syncthreads();
  if constexpr (kI8) {
    // the fresh token's score, a warp a query
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = warp + kFlashWarps * j;
      if (q >= G) break;
      int s = __dp4a(knw, reinterpret_cast<const int*>(qsh + q * kD)[lane], 0);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) rsn[q] = __fmul_rn(__fmul_rn((float)s, qsw[j]), knsf);
    }
  }
  // q8 as the scores' B fragments of k step ks: #18 and #20 as #19 and #21
  // (query g at the features of rows 8 a + lane7_64(tig, j & 1), a = 4 ks'
  // + (j >> 1), byte j of b0, j < 4, of b1, j - 4; #18: ks' = ks; #20:
  // ks' = ks & 1, features + 64 for ks >= 2, the high nibbles); #17
  // features 32 tig + 8 ks + 0..3 (b0) and + 4..7 (b1), the order of its K
  // words
  uint32_t qb[4][2];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    qb[ks][0] = qb[ks][1] = 0u;
    if (g < G) {
      const int8_t* qg = qsh + g * kD;
      if constexpr (kI8) {
        const uint2 w =
            *reinterpret_cast<const uint2*>(qg + 32 * tig + 8 * ks);
        qb[ks][0] = w.x;
        qb[ks][1] = w.y;
      } else {
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 4 * s + i, ka = kNib ? (ks & 1) : ks;
            const int r = 8 * (4 * ka + (j >> 1)) + lane7_64(tig, j & 1);
            const int f = r + ((kNib && ks >= 2) ? kD2 : 0);
            qb[ks][s] |= (uint32_t)(uint8_t)qg[f] << (8 * i);
          }
      }
    }
  }

  // scores: the warp's K chunks.  #18, #20: lane (g, tig) reads time steps 8 g
  // .. 8 g + 7 and holds m16 tile i's rows g, g + 8 as time steps 8 g +
  // 2 i, 8 g + 2 i + 1; #17: m16 tile i is time steps 16 i .. 16 i + 15,
  // rows g, g + 8 as read.  Lanes tig 0 copy the chunk's V scales into vsb.
  float mx[2] = {-INFINITY, -INFINITY};
  for (int j = 0; j < nkw; ++j) {
    const int tb = (warp + kFlashWarps * j) * kChunk;
    wait();
    const unsigned char* sl = wring + (k % nslot) * CB;
    const unsigned char* ssl = wsring + (k % nslot) * kSlotScales;
    float kv[8];  // the K scales of the lane's 8 time steps
    if (tb + 8 * g < n && tig == 0)
      *reinterpret_cast<uint4*>(vsb + tb + 8 * g) =
          *reinterpret_cast<const uint4*>(ssl + 2 * kChunk + 16 * g);
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0;
    if constexpr (kI8) {
      // kv[2 i + rr]: time step 16 i + g + 8 rr
      const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(ssl);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = 16 * (u >> 1) + g + 8 * (u & 1);
        kv[u] = tb + t < n ? bf(kb[t]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint4 w[2][2];  // [row g, g + 8][features 32 tig + 16 hh ..]
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            w[rr][hh] = *reinterpret_cast<const uint4*>(
                sl + sw128(16 * i + g + 8 * rr, 2 * tig + hh));
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint32_t* w0 =
              reinterpret_cast<const uint32_t*>(&w[0][ks >> 1]);
          const uint32_t* w1 =
              reinterpret_cast<const uint32_t*>(&w[1][ks >> 1]);
          const int o = 2 * (ks & 1);
          mma_i8(acc[i], w0[o], w1[o], w0[o + 1], w1[o + 1], qb[ks][0],
                 qb[ks][1]);
        }
      }
    } else {
      // kv[u]: time step 8 g + u
      if (tb + 8 * g < n) {
        const uint4 raw = *reinterpret_cast<const uint4*>(ssl + 16 * g);
        const __nv_bfloat16* kr = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int u = 0; u < 8; ++u) kv[u] = bf(kr[u]);
      }
      bd_chunk_scores<kNib>(sl, g, tig, qb, acc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = 2 * i + (e >> 1);
        const int t = tb + (kI8 ? 16 * i + g + 8 * (e >> 1) : 8 * g + u);
        const int qq = 2 * tig + (e & 1);
        if (qq < G && t < n) {
          const float v = __fmul_rn(
              __fmul_rn(lcw4::exact_f32(acc[i][e]), qsc[e & 1]), kv[u]);
          sc[qq * ss + t] = v;
          mx[e & 1] = fmaxf(mx[e & 1], v);
        }
      }
    refill();  // after the last use of the slot's scales
  }

  // meet (a): the row max, ranks in order
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], off));
  if (g == 0) {
    red[warp * 8 + 2 * tig] = mx[0];
    red[warp * 8 + 2 * tig + 1] = mx[1];
  }
  __syncthreads();
  if (tid < G) {
    float a = red[tid];
#pragma unroll
    for (int w = 1; w < kFlashWarps; ++w) a = fmaxf(a, red[w * 8 + tid]);
    xm[tid] = a;
  }
  cluster_sync();  // 1
  if (tid < G) {
    float a = ld_cluster(xm + tid, 0);
    for (int r = 1; r < parts; ++r) a = fmaxf(a, ld_cluster(xm + tid, r));
    if constexpr (kI8) {
      a = fmaxf(a, rsn[tid]);
      rsn[tid] = expf(rsn[tid] - a);  // e_new
    } else {
      a = fmaxf(a, -1e30f);
    }
    rm[tid] = a;
  }
  __syncthreads();

  // e = exp(s - m), pv = e * vs in place of the scores; sum(e), max(pv)
  float es[G], pm[G];
#pragma unroll
  for (int q = 0; q < G; ++q) es[q] = 0.f, pm[q] = 0.f;
  for (int t = tid; t < n; t += kFlashThreads) {
    const float vsv = bf(vsb[t]);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const float e = expf(sc[q * ss + t] - rm[q]);
      es[q] += e;
      const float pv = __fmul_rn(e, vsv);
      sc[q * ss + t] = pv;
      pm[q] = fmaxf(pm[q], pv);
    }
  }
  // meet (b): sum(e) and max(pv); ps = max(max(pv), 1e-20) / 127
#pragma unroll
  for (int q = 0; q < G; ++q)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      es[q] += __shfl_xor_sync(0xffffffffu, es[q], off);
      pm[q] = fmaxf(pm[q], __shfl_xor_sync(0xffffffffu, pm[q], off));
    }
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < G; ++q) {
      red[kFlashWarps * 8 + warp * 8 + q] = es[q];
      red[2 * kFlashWarps * 8 + warp * 8 + q] = pm[q];
    }
  __syncthreads();
  if (tid < G) {
    float a = red[kFlashWarps * 8 + tid];
    float pmax = red[2 * kFlashWarps * 8 + tid];
#pragma unroll
    for (int w = 1; w < kFlashWarps; ++w) {
      a += red[kFlashWarps * 8 + w * 8 + tid];
      pmax = fmaxf(pmax, red[2 * kFlashWarps * 8 + w * 8 + tid]);
    }
    xs[tid] = a;
    xp[tid] = pmax;
  }
  cluster_sync();  // 2
  if (tid < G) {
    float a = ld_cluster(xs + tid, 0), pmax = ld_cluster(xp + tid, 0);
    for (int r = 1; r < parts; ++r) {
      a += ld_cluster(xs + tid, r);
      pmax = fmaxf(pmax, ld_cluster(xp + tid, r));
    }
    rd[tid] = a;
    rps[tid] = fmaxf(pmax, 1e-20f) / 127.0f;
  }
  __syncthreads();

  // PV: the warp's V chunks on #19's kv8 or #21's kv4 fragments
  // (bd_chunk_pv), the p8 B fragments made before the chunk's wait
  // (p8_frags)
  int pacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) pacc[i][e] = 0;
  const float psg = g < G ? rps[g] : 1.f;
  const float psinv = __frcp_rn(psg);
  for (int j = 0; j < nkw; ++j) {
    uint32_t bws[2][2];
    p8_frags<kNib>(sc + min(g, G - 1) * ss, ss,
                    (warp + kFlashWarps * j) * kChunk, n, g < G, tig, psinv,
                    psg, bws);
    wait();
    bd_chunk_pv<kNib>(wring + (k % nslot) * CB, g, tig, bws, pacc);
    refill();
  }
  if (nkw > 0)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qq = 2 * tig + (e & 1);
        if (qq < G)
          atomicAdd(accs + qq * kAccRow + (2 * i + (e >> 1)) * 8 + g,
                    pacc[i][e]);
      }
  cluster_sync();  // 3: every rank's PV sums
  // meet (c): rank r's features [r * nf, (r + 1) * nf) of every rank's
  // sums, ranks in order (feature f at (phi, g) of its lane group, phi * 8
  // + g: kv8 f = 16 g + phi; kv4 f = 8 g + phi, and 64 + 8 g + phi - 8
  // from phi 8 on); a thread
  // takes i = tid, tid + 128, .. < G * nf (at most G), all of feature
  // rank * nf + tid % nf; the remote reads done, it announces the last
  // meet before its stores
  const int nf = kD / parts, f = rank * nf + tid % nf;
  const int at0 = kNib ? ((f & 7) + (f >= kD2 ? 8 : 0)) * 8 + ((f & 63) >> 3)
                       : (f & 15) * 8 + (f >> 4);
  int a[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int q = (tid + kFlashThreads * j) / nf;
    if (q < G) {
      a[j] = ld_cluster_s32(accs + q * kAccRow + at0, 0);
      for (int r = 1; r < parts; ++r)
        a[j] += ld_cluster_s32(accs + q * kAccRow + at0, r);
    }
  }
  cluster_arrive();  // 4: no rank leaves while another reads its sums
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int q = (tid + kFlashThreads * j) / nf;
    if (q >= G) break;
    const float c = __fmul_rn(__int2float_rn(a[j]), rps[q]);
    if constexpr (kI8) {
      const float pvn = __fmul_rn(rsn[q], vnsf);
      const float num = __fadd_rn(c, __fmul_rn(pvn, vnf));
      p.out[((size_t)bh * G + q) * kD + f] = num / __fadd_rn(rd[q], rsn[q]);
    } else {
      p.out[((size_t)bh * G + q) * kD + f] = c;
    }
  }
  if constexpr (!kI8)
    if (rank == 0 && tid < G) {
      p.m[bh * G + tid] = rm[tid];
      p.d[bh * G + tid] = rd[tid];
    }
  // a first chunk past the valid columns lands before the CTA leaves
  if (nkw == 0 && cols0 > 0) lcw4::mbar_wait(wfull, 0);
  cluster_wait();  // 4
}

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int G, bool kNib>
int launch_bd_flash(const void* q8, const void* qs, const void* kt,
                    const void* ks, const void* vt, const void* vs,
                    const void* lengths, void* ctx, void* m, void* d,
                    void* part, void* counters, int B, int H, int S, int sb,
                    int parts, int nslot, cudaStream_t st) {
  constexpr int R = kNib ? kD2 : kD;
  // K as (B * H * R, S) byte rows, boxes of R rows x 64 columns (64-byte
  // swizzle); V as (B * S, H * R), boxes of 64 rows x R bytes (kv8:
  // 128-byte swizzle, kv4: 64-byte)
  CUtensorMap kmap, vmap;
  int rc = lcw4::tensor_map_2d(&kmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, kt, S,
                               (uint64_t)B * H * R, S, kChunk, R,
                               CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc == 0)
    rc = lcw4::tensor_map_2d(
        &vmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, vt, (uint64_t)H * R,
        (uint64_t)B * S, (uint64_t)H * R, R, kChunk,
        kNib ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const bool vsb = flash_vsb(G, sb, kNib);
  const size_t smem = flash_smem(G, sb, kNib, nslot, vsb);
  cudaError_t e = prepare(attn_bd_flash_kernel<G, kNib>, smem);
  if (e != cudaSuccess) return (int)e;
  attn_bd_flash_kernel<G, kNib><<<dim3(parts, H, B), kFlashThreads, smem,
                                  st>>>(
      kmap, vmap, (const int8_t*)q8, (const float*)qs,
      (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs,
      (const int*)lengths, (float*)ctx, (float*)m, (float*)d, (float*)part,
      (int*)counters, S, sb, nslot, (int)vsb);
  return (int)cudaGetLastError();
}

// the #19/#21 CTAs an SM holds at once, or minus a CUDA error
template <int G, bool kNib>
int flash_ctas(int sb, int nslot) {
  const size_t smem = flash_smem(G, sb, kNib, nslot, flash_vsb(G, sb, kNib));
  cudaError_t e = prepare(attn_bd_flash_kernel<G, kNib>, smem);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, attn_bd_flash_kernel<G, kNib>, kFlashThreads, smem);
  return e != cudaSuccess ? -(int)e : n;
}

template <int G, typename ST>
int launch_kv8(const void* q, const void* kq, const void* ks, const void* vq,
               const void* vs, void* out, int B, int H, int S, int parts,
               cudaStream_t st) {
  const int per = ((S + parts - 1) / parts + 15) & ~15;
  // K and V as (B * H * S, D) byte rows, boxes of kKvBox rows
  CUtensorMap kmap, vmap;
  const uint64_t rows = (uint64_t)B * H * S;
  int rc = lcw4::tensor_map_2d(&kmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, kq, kD,
                               rows, kD, kD, kKvBox);
  if (rc == 0)
    rc = lcw4::tensor_map_2d(&vmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, vq, kD,
                             rows, kD, kD, kKvBox);
  if (rc != 0) return rc;
  const size_t smem = kv8_smem(G, per);
  cudaError_t e = prepare(attn_kv8_kernel<G, ST>, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(parts * H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, attn_kv8_kernel<G, ST>, kmap, vmap,
                         (const __nv_bfloat16*)q, (const ST*)ks,
                         (const ST*)vs, (float*)out, S, parts, per);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the most clusters of `parts` #22 CTAs the card holds at once over a
// rank's `per` columns, or minus a CUDA error
template <int G, typename ST>
int kv8_clusters(int per, int parts) {
  const size_t smem = kv8_smem(G, per);
  cudaError_t e = prepare(attn_kv8_kernel<G, ST>, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(parts, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, attn_kv8_kernel<G, ST>, &cfg);
  return e != cudaSuccess ? -(int)e : n;
}

template <typename ST>
int kv8_clusters_g(int G, int per, int parts) {
  switch (G) {
    case 1: return kv8_clusters<1, ST>(per, parts);
    case 2: return kv8_clusters<2, ST>(per, parts);
    case 4: return kv8_clusters<4, ST>(per, parts);
    case 8: return kv8_clusters<8, ST>(per, parts);
    default: return -(int)cudaErrorInvalidValue;
  }
}

template <typename ST>
int kv8_dispatch(const void* q, const void* kq, const void* ks,
                 const void* vq, const void* vs, void* out, int B, int H,
                 int G, int S, int parts, cudaStream_t st) {
  switch (G) {
    case 1: return launch_kv8<1, ST>(q, kq, ks, vq, vs, out, B, H, S, parts, st);
    case 2: return launch_kv8<2, ST>(q, kq, ks, vq, vs, out, B, H, S, parts, st);
    case 4: return launch_kv8<4, ST>(q, kq, ks, vq, vs, out, B, H, S, parts, st);
    case 8: return launch_kv8<8, ST>(q, kq, ks, vq, vs, out, B, H, S, parts, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// #17, #18 or #20 (kMode) on a cluster of `parts` CTAs per (slot, kv head),
// `nslot` ring slots a warp; k, v: #18's or #20's slabs (K as (B * H * R,
// S) byte rows, boxes of R rows x 64 columns, 64-byte swizzle; V as (B * S,
// H * R), boxes of 64 rows x R bytes, kv8: 128-byte swizzle, kv4: 64-byte)
// or #17's caches (both (B * H * S, D) byte rows, boxes of 64 rows,
// 128-byte swizzle)
template <int G, int kMode>
int launch_split(const SplitPtrs& p, const void* k, const void* v, int B,
                 int H, int S, int parts, int nslot, cudaStream_t st) {
  constexpr bool kNib = kMode == kSplitKv4;
  constexpr int R = kNib ? kD2 : kD;
  const int per = ((S + parts - 1) / parts + 15) & ~15;
  CUtensorMap kmap, vmap;
  int rc;
  if (kMode == kSplitI8) {
    const uint64_t rows = (uint64_t)B * H * S;
    rc = lcw4::tensor_map_2d(&kmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, k, kD, rows,
                             kD, kD, kChunk);
    if (rc == 0)
      rc = lcw4::tensor_map_2d(&vmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, v, kD,
                               rows, kD, kD, kChunk);
  } else {
    rc = lcw4::tensor_map_2d(&kmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, k, S,
                             (uint64_t)B * H * R, S, kChunk, R,
                             CU_TENSOR_MAP_SWIZZLE_64B);
    if (rc == 0)
      rc = lcw4::tensor_map_2d(
          &vmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, v, (uint64_t)H * R,
          (uint64_t)B * S, (uint64_t)H * R, R, kChunk,
          kNib ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (rc != 0) return rc;
  const size_t smem = split_smem(G, per, nslot, kNib);
  cudaError_t e = prepare(attn_split_kernel<G, kMode>, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(parts * H, B);
  cfg.blockDim = dim3(kFlashThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, attn_split_kernel<G, kMode>, kmap, vmap, p,
                         S, parts, per, nslot);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the most clusters of `parts` #17/#18/#20 CTAs the card holds at once over
// a rank's `per` columns, or minus a CUDA error
template <int G, int kMode>
int split_clusters(int per, int nslot, int parts) {
  const size_t smem = split_smem(G, per, nslot, kMode == kSplitKv4);
  cudaError_t e = prepare(attn_split_kernel<G, kMode>, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(parts, 1);
  cfg.blockDim = dim3(kFlashThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, attn_split_kernel<G, kMode>, &cfg);
  return e != cudaSuccess ? -(int)e : n;
}

template <int kMode>
int split_dispatch(const SplitPtrs& p, const void* k, const void* v, int B,
                   int H, int G, int S, int parts, int nslot,
                   cudaStream_t st) {
  switch (G) {
    case 1: return launch_split<1, kMode>(p, k, v, B, H, S, parts, nslot, st);
    case 2: return launch_split<2, kMode>(p, k, v, B, H, S, parts, nslot, st);
    case 4: return launch_split<4, kMode>(p, k, v, B, H, S, parts, nslot, st);
    case 8: return launch_split<8, kMode>(p, k, v, B, H, S, parts, nslot, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int kMode>
int split_clusters_g(int G, int per, int nslot, int parts) {
  switch (G) {
    case 1: return split_clusters<1, kMode>(per, nslot, parts);
    case 2: return split_clusters<2, kMode>(per, nslot, parts);
    case 4: return split_clusters<4, kMode>(per, nslot, parts);
    case 8: return split_clusters<8, kMode>(per, nslot, parts);
    default: return -(int)cudaErrorInvalidValue;
  }
}

inline bool split_args_ok(int S, int parts, int nslot) {
  return S >= 16 && S % 16 == 0 && parts >= 1 && parts <= 8 &&
         (parts & (parts - 1)) == 0 && nslot >= 1 && nslot <= 2;
}

template <bool kNib>
int flash_dispatch(const void* q8, const void* qs, const void* kt,
                   const void* ks, const void* vt, const void* vs,
                   const void* lengths, void* ctx, void* m, void* d,
                   void* part, void* counters, int B, int H, int G, int S,
                   int sb, int parts, int nslot, cudaStream_t st) {
  switch (G) {
    case 1: return launch_bd_flash<1, kNib>(q8, qs, kt, ks, vt, vs, lengths, ctx, m, d, part, counters, B, H, S, sb, parts, nslot, st);
    case 2: return launch_bd_flash<2, kNib>(q8, qs, kt, ks, vt, vs, lengths, ctx, m, d, part, counters, B, H, S, sb, parts, nslot, st);
    case 4: return launch_bd_flash<4, kNib>(q8, qs, kt, ks, vt, vs, lengths, ctx, m, d, part, counters, B, H, S, sb, parts, nslot, st);
    case 8: return launch_bd_flash<8, kNib>(q8, qs, kt, ks, vt, vs, lengths, ctx, m, d, part, counters, B, H, S, sb, parts, nslot, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kNib>
int flash_ctas_g(int G, int sb, int nslot) {
  switch (G) {
    case 1: return flash_ctas<1, kNib>(sb, nslot);
    case 2: return flash_ctas<2, kNib>(sb, nslot);
    case 4: return flash_ctas<4, kNib>(sb, nslot);
    case 8: return flash_ctas<8, kNib>(sb, nslot);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// #18 (mode kSplitKv8) over the kv8 slabs (K (B, H*D, S), V (B, S, H*D))
// or #20 (mode kSplitKv4) over the kv4 slabs (K (B, H*D/2, S), V (B, S,
// H*D/2)): S split over a cluster of `parts` CTAs (1, 2, 4 or 8) per
// (slot, kv head), `nslot` ring slots a warp (1 or 2); S % 16 == 0, ks
// and vs 16-byte aligned, a rank's share within the shared memory
// (ops/attention.split_smem_bytes).
int lc_attn_bd(const void* q8, const void* qs, const void* kt,
               const void* ks, const void* vt, const void* vs,
               const void* lengths, void* ctx, void* m, void* d, int B,
               int H, int G, int S, int parts, int nslot, int mode,
               void* stream) {
  if (!split_args_ok(S, parts, nslot)) return (int)cudaErrorInvalidValue;
  SplitPtrs p = {(const int8_t*)q8, (const float*)qs,
                 (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs,
                 (const int*)lengths, nullptr, nullptr, nullptr, nullptr,
                 (float*)ctx, (float*)m, (float*)d};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSplitKv8:
      return split_dispatch<kSplitKv8>(p, kt, vt, B, H, G, S, parts, nslot,
                                       st);
    case kSplitKv4:
      return split_dispatch<kSplitKv4>(p, kt, vt, B, H, G, S, parts, nslot,
                                       st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// #21 (nib = 1, the kv4 slabs) and #19 (nib = 0, kv8) in blocks of sb
// columns (sb % 16 == 0, S % sb == 0), S split over `parts` CTAs per (slot,
// kv head), `nslot` ring slots a warp (1-3); part: f32 [B*H][parts][G][D+2]
// and counters: int32 [B*H], zero (the kernel leaves them zero), both
// unused at parts = 1.
int lc_attn_bd_flash(const void* q8, const void* qs, const void* kt,
                     const void* ks, const void* vt, const void* vs,
                     const void* lengths, void* ctx, void* m, void* d,
                     void* part, void* counters, int B, int H, int G, int S,
                     int sb, int parts, int nslot, int nib, void* stream) {
  if (sb <= 0 || sb % 16 || S % sb || parts < 1 || parts > kFlashMaxParts ||
      nslot < 1 || nslot > 3 ||
      (parts > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return nib ? flash_dispatch<true>(q8, qs, kt, ks, vt, vs, lengths, ctx, m,
                                    d, part, counters, B, H, G, S, sb, parts,
                                    nslot, st)
             : flash_dispatch<false>(q8, qs, kt, ks, vt, vs, lengths, ctx, m,
                                     d, part, counters, B, H, G, S, sb, parts,
                                     nslot, st);
}

#ifdef LC_FLASH_STAMPS
// the (point, ns) pairs of the launches since the last call (n <= 1024 into
// out), then none; returns n or minus a CUDA error
int lc_flash_stamps(void* out) {
  int n = 0;
  cudaError_t e = cudaMemcpyFromSymbol(&n, flash_nstamps, sizeof(int));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, flash_stamps,
                             2 * n * sizeof(unsigned long long));
  const int zero = 0;
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(flash_nstamps, &zero, sizeof(int));
  return e == cudaSuccess ? n : -(int)e;
}
#endif

// #19/#21's CTAs an SM holds at once (ops/attention.bd_flash_parts), or
// minus a CUDA error
int lc_attn_bd_flash_ctas(int G, int sb, int nslot, int nib) {
  if (sb <= 0 || sb % 16 || nslot < 1 || nslot > 3)
    return -(int)cudaErrorInvalidValue;
  return nib ? flash_ctas_g<true>(G, sb, nslot)
             : flash_ctas_g<false>(G, sb, nslot);
}

// #17 over the int8 cache (B, H, S, D) with the fresh token kn, vn (B, H,
// D) and its scales kns, vns (B, H); out (B, H, G, D) normalized; parts and
// nslot as #18's.
int lc_attn_i8(const void* q8, const void* qs, const void* kq, const void* ks,
               const void* vq, const void* vs, const void* kn,
               const void* kns, const void* vn, const void* vns,
               const void* lengths, void* out, int B, int H, int G, int S,
               int parts, int nslot, void* stream) {
  if (!split_args_ok(S, parts, nslot)) return (int)cudaErrorInvalidValue;
  SplitPtrs p = {(const int8_t*)q8, (const float*)qs,
                 (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs,
                 (const int*)lengths, (const int8_t*)kn,
                 (const __nv_bfloat16*)kns, (const int8_t*)vn,
                 (const __nv_bfloat16*)vns, (float*)out, nullptr, nullptr};
  return split_dispatch<kSplitI8>(p, kq, vq, B, H, G, S, parts, nslot,
                                  reinterpret_cast<cudaStream_t>(stream));
}

// #18's (mode 0), #17's (1) or #20's (2) co-resident clusters of `parts`
// CTAs over `per` columns a rank with `nslot` ring slots a warp
// (ops/attention.split_parts), or minus a CUDA error
int lc_attn_split_clusters(int G, int per, int nslot, int mode, int parts) {
  if (!split_args_ok(per, parts, nslot)) return -(int)cudaErrorInvalidValue;
  switch (mode) {
    case kSplitKv8: return split_clusters_g<kSplitKv8>(G, per, nslot, parts);
    case kSplitI8: return split_clusters_g<kSplitI8>(G, per, nslot, parts);
    case kSplitKv4: return split_clusters_g<kSplitKv4>(G, per, nslot, parts);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// #22: q (B, H, G, D) bf16; kq, vq (B, H, S, D) int8; ks, vs (B, H, S) bf16
// (scales_f32 = 0) or f32 (1); out (B, H, G, D) f32; a cluster of `parts`
// CTAs (1, 2, 4 or 8) per (slot, kv head).  Any S >= 1 whose share of a
// rank fits the shared memory (ops/attention.kv8_smem_bytes).
// #22's co-resident clusters of `parts` CTAs over `per` columns a rank
// (ops/attention.kv8_parts), or minus a CUDA error.
int lc_attn_kv8_clusters(int G, int per, int scales_f32, int parts) {
  if (parts < 1 || parts > 8 || (parts & (parts - 1)) || per < 16 || per % 16)
    return -(int)cudaErrorInvalidValue;
  return scales_f32 ? kv8_clusters_g<float>(G, per, parts)
                    : kv8_clusters_g<__nv_bfloat16>(G, per, parts);
}

int lc_attn_kv8(const void* q, const void* kq, const void* ks, const void* vq,
                const void* vs, void* out, int B, int H, int G, int S,
                int scales_f32, int parts, void* stream) {
  if (S < 1 || parts < 1 || parts > 8 || (parts & (parts - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (scales_f32)
    return kv8_dispatch<float>(q, kq, ks, vq, vs, out, B, H, G, S, parts,
                               st);
  return kv8_dispatch<__nv_bfloat16>(q, kq, ks, vq, vs, out, B, H, G, S,
                                     parts, st);
}

}  // extern "C"
