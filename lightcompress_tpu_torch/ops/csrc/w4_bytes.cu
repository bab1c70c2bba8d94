// Grouped-W4 matmul kernels on the s4 byte layouts for Hopper
// (sm_90a), CUDA C++ with a plain C interface bound from Python with ctypes
// (ops/_build.py, ops/w4_matmul.py).
//
// Weight layout of #12 and #13: untiled byte pairs (#11 takes natural-order
// bytes, described at its kernel).
//   wb  (N, K/2) int8: byte p*128 + t holds, already signed (c' = u - 8 in
//                      [-8, 7]), the code of weight (2p)*128 + t in its low
//                      nibble and of weight (2p+1)*128 + t in its high one
//   s   (N, G)   bf16: per-group scale, G = K/128
//   zs  (N, G)   bf16: premultiplied zero correction (z - 8) * s
// so w = c' * s - zs and every kernel computes
//   y[m, n] = sum_g s[n,g] * (x_g . c'_g) - zs[n,g] * sum(x_g)
// with the integer group dot finished before the scale is applied
// (symmetric weights have zs = 0 exactly).
//
// Requirements checked by the Python wrappers: K % 512 == 0 (#11: K % 128
// == 0), N % 32 == 0, contiguous tensors on the current device.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 1979 TOP/s int8): at M <= 256 the
// bytes, N*K/2 + 4*N*G + M*K*b_x + M*N*b_out over 3.35 TB/s, so the packed
// weight read is the bound.  #12's decode block (small M) computes with
// __dp4a on the CUDA cores, a lane per channel; #12 above the decode regime
// runs the int8 tensor-core tile of w4_mma.cuh, #13 and #11 the int8
// mma.sync decode tiles below it.

#include "w4_mma.cuh"

namespace {

using namespace lcw4;

// The four low (high) nibbles of w, sign-extended to four int8 lanes:
// (n ^ 8) - 8 maps the nibble n in [0, 16) to n, or n - 16 from 8 on, and
// __vsub4 subtracts per byte without borrows between them.
__device__ __forceinline__ int sext_lo(uint32_t w) {
  return (int)__vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ int sext_hi(uint32_t w) {
  return (int)__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// ---------------------------------------------------------------------------
// #12 W4A8 on byte pairs, the decode block (the wrapper sends M <
// BYTES_TILE_MIN_M here, ops/w4_matmul.py).  Replaces
// lightcompress_tpu/ops/pallas_matmul.py w4a8_matmul_bytes
// (_w4a8_kernel_pairs, _pairs_group_loop).
//
// Bound: the packed weight read (memory).  One lane per output channel, 4
// warps splitting the group pairs, MT = 8 rows of int8
// x in shared memory (natural K order, as the TPU kernel keeps it), per lane
// 16 bytes of its weight row per step through the read-only cache.  Each
// 4-byte word gives two __dp4a operands, the low nibbles against x of group
// 2p and the high ones against group 2p+1, signed by signed; f32 out times
// the act scale.
// ---------------------------------------------------------------------------
template <int MT>
__global__ void __launch_bounds__(kDecodeThreads)
w4a8_bytes_kernel(const int8_t* __restrict__ x,
                  const float* __restrict__ xscale,
                  const int8_t* __restrict__ wb,
                  const __nv_bfloat16* __restrict__ s,
                  const __nv_bfloat16* __restrict__ zs,
                  float* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = K / kGroup, kh = K / 2;
  int8_t* xsh = reinterpret_cast<int8_t*>(smem);
  float* xsum = reinterpret_cast<float*>(smem + (size_t)MT * K);
  float* red = xsum + MT * G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * MT;
  const int n = blockIdx.x * 32 + lane;

  stage_rows<MT>(x, M, K, m0, xsh);
  __syncthreads();
  group_sums<MT>(xsh, K, xsum);
  __syncthreads();

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  const int8_t* wrow = wb + (size_t)n * kh;
  for (int p = warp; p < G / 2; p += kDecodeWarps) {
    int de[MT], dodd[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) de[m] = dodd[m] = 0;
    const int4* wq = reinterpret_cast<const int4*>(wrow + p * kGroup);
    const int ke = 2 * p * kGroup, ko = ke + kGroup;
#pragma unroll 2
    for (int c = 0; c < kGroup / 16; ++c) {
      const int4 w = __ldg(wq + c);
      const uint32_t ws[4] = {(uint32_t)w.x, (uint32_t)w.y, (uint32_t)w.z,
                              (uint32_t)w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int lo = sext_lo(ws[q]), hi = sext_hi(ws[q]);
        const int t = 16 * c + 4 * q;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int8_t* xr = xsh + (size_t)m * K;
          de[m] = __dp4a(lo, *reinterpret_cast<const int*>(xr + ke + t), de[m]);
          dodd[m] =
              __dp4a(hi, *reinterpret_cast<const int*>(xr + ko + t), dodd[m]);
        }
      }
    }
    const int g = 2 * p;
    const float s0 = __bfloat162float(s[(size_t)n * G + g]);
    const float z0 = __bfloat162float(zs[(size_t)n * G + g]);
    const float s1 = __bfloat162float(s[(size_t)n * G + g + 1]);
    const float z1 = __bfloat162float(zs[(size_t)n * G + g + 1]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      acc[m] += s0 * (float)de[m] - z0 * xsum[m * G + g];
      acc[m] += s1 * (float)dodd[m] - z1 * xsum[m * G + g + 1];
    }
  }
  store_rows<MT>(acc, red, xscale, out, M, N, m0, n);
}

// ---------------------------------------------------------------------------
// #12, the tile: w4a8_matmul_bytes above the decode regime (the wrapper
// sends M >= BYTES_TILE_MIN_M here, ops/w4_matmul.py), on the int8
// tensor-core tile of w4_mma.cuh.  Replaces the same TPU kernel as the
// decode block above (w4a8_matmul_bytes, _w4a8_kernel_pairs and
// _pairs_group_loop), whose grid (N/32, M/8) streamed the whole packed
// weight once for every 8 rows and computed with __dp4a.
//
// A block takes 64 rows x 128 channels and walks the group pairs p: a
// stage holds the x of groups 2p and 2p + 1 (two [64][128] tiles) and
// bytes p*128 .. +128 of its 128 weight rows, which hold both groups'
// codes: three 128-byte-swizzled TMA boxes that thread 0 issues and an
// mbarrier counts.  Three stages in flight (96 KB); 16 warps of 32 x 16
// outputs (mma.sync), one block an SM.  The B
// fragments come straight from the packed tile: a 32-bit word is four
// consecutive k of one channel, its low nibbles (sext_lo) group 2p's codes
// and its high ones (sext_hi) group 2p + 1's, so the tile is read twice
// and never unpacked in shared memory.  Per group: the exact dot d, then
// acc += d * s[g] and acc -= xsum[g] * zs[g] (f32, fused multiply-adds;
// one accumulator, the TPU's four are not kept), then y = acc * xscale.
// Rows past M and channels past N (N % 32 == 0) come in as zeros (TMA
// fills a box's elements out of range with zeros) and are masked on store.
// Bound: the packed weight read at small M, the int8 operations and the
// f32 epilogue at M 256 (a Llama-3-8B block's seven linears: 56 G int8
// multiply-adds).
// ---------------------------------------------------------------------------
constexpr int kBytesThreads = kMmaThreads;
constexpr int kBytesStages = 3;
constexpr size_t kBytesStage = 2 * kTileX + kTileW;
// (after 1024 bytes of alignment slack) the stages, the stage's row sums
// [2][64], scales and zero corrections [2][128], the stages' mbarriers
constexpr size_t kBytesSmem = 1024 + kBytesStages * kBytesStage +
                              (2 * kTileM + 4 * kTileN) * 4 + 8 * kBytesStages;

struct LowNibbles {
  __device__ __forceinline__ int operator()(int w) const {
    return sext_lo((uint32_t)w);
  }
};
struct HighNibbles {
  __device__ __forceinline__ int operator()(int w) const {
    return sext_hi((uint32_t)w);
  }
};

__global__ void __launch_bounds__(kBytesThreads, 1)
w4a8_bytes_tile_kernel(const __grid_constant__ CUtensorMap xmap,
                       const float* __restrict__ xscale,
                       const __grid_constant__ CUtensorMap wmap,
                       const __nv_bfloat16* __restrict__ s,
                       const __nv_bfloat16* __restrict__ zs,
                       float* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte aligned bases
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* stages = reinterpret_cast<int8_t*>(smem);
  float* xs_sh = reinterpret_cast<float*>(smem + kBytesStages * kBytesStage);
  float* s_sh = xs_sh + 2 * kTileM;
  float* zs_sh = s_sh + 2 * kTileN;
  uint64_t* bar = reinterpret_cast<uint64_t*>(zs_sh + 2 * kTileN);
  const int G = K / kGroup, P = G / 2;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  const int mv = min(kTileM, M - m0), nv = min(kTileN, N - n0);

  auto load = [&](int p) {  // by thread 0: x of groups 2p, 2p + 1; bytes p
    const int slot = p % kBytesStages;
    int8_t* dst = stages + slot * kBytesStage;
    mbar_expect_tx(bar + slot, kBytesStage);
    tma_load_2d(dst, &xmap, 2 * p * kGroup, m0, bar + slot);
    tma_load_2d(dst + kTileX, &xmap, (2 * p + 1) * kGroup, m0, bar + slot);
    tma_load_2d(dst + 2 * kTileX, &wmap, p * kGroup, n0, bar + slot);
  };

  constexpr int NT = kMmaNT;
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  auto add_group = [&](const Dot& d, int h) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = h * kTileN + frag_col(j, q);
          acc[i][j][q] = fmaf(exact_f32(d[i][j][q]), s_sh[c], acc[i][j][q]);
          acc[i][j][q] = fmaf(-xs_sh[h * kTileM + frag_row(i, q)], zs_sh[c],
                              acc[i][j][q]);
        }
  };

  // stage p's scales and zero corrections, read one stage ahead (thread
  // t < 256: channel t % 128 of group 2p + t / 128)
  float s_next = 0.f, z_next = 0.f;
  auto fetch = [&](int p) {
    const int n = tid % kTileN;
    if (tid < 2 * kTileN && n < nv) {
      const size_t o = (size_t)(n0 + n) * G + 2 * p + tid / kTileN;
      s_next = __bfloat162float(s[o]);
      z_next = __bfloat162float(zs[o]);
    }
  };
  fetch(0);
  if (tid == 0) {
    for (int i = 0; i < kBytesStages; ++i) mbar_init(bar + i, 1);
    mbar_init_fence();
    for (int q = 0; q < kBytesStages - 1 && q < P; ++q) load(q);
  }
  __syncthreads();  // the barriers are initialised
  for (int p = 0; p < P; ++p) {
    mbar_wait(bar + p % kBytesStages, (p / kBytesStages) & 1);
    __syncthreads();  // every warp is done with p - 1
    if (tid == 0 && p + kBytesStages - 1 < P) load(p + kBytesStages - 1);
    const int8_t* st = stages + (p % kBytesStages) * kBytesStage;
    {
      constexpr int kParts = kBytesThreads / kTileN;  // threads a row sum
      const int sum = stage_row_sum<kBytesThreads>(st, st + kTileX);
      if (tid % kParts == 0)
        xs_sh[(tid / (kBytesThreads / 2)) * kTileM + (tid / kParts) % kTileM] =
            sum;
      if (tid < 2 * kTileN) {
        s_sh[tid] = s_next;
        zs_sh[tid] = z_next;
      }
      if (p + 1 < P) fetch(p + 1);
    }
    __syncthreads();
    Dot d;
    group_dot(d, st, st + 2 * kTileX, LowNibbles());
    add_group(d, 0);
    group_dot(d, st + kTileX, st + 2 * kTileX, HighNibbles());
    add_group(d, 1);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row(i, 2 * h);
      if (r >= mv) continue;
      const float xs = xscale[m0 + r];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = frag_col(j, 0);
        if (c >= nv) continue;  // nv % 32 == 0: c and c + 1 are in or out
        *reinterpret_cast<float2*>(out + (size_t)(m0 + r) * N + n0 + c) =
            make_float2(acc[i][j][2 * h] * xs, acc[i][j][2 * h + 1] * xs);
      }
    }
}

// ---------------------------------------------------------------------------
// #13 fused W4A8 decode linear on the int8 tensor cores.  Replaces
// lightcompress_tpu/ops/pallas_matmul.py w4a8_linear_bytes_fused
// (_w4a8_kernel_pairs_fused, _pairs_group_loop).
//
// y = ((a0 + a1) + (a2 + a3) - corr) * xscale in x's type (XT = bf16 or
// f32), with a_r the sum over the groups g = r, r + 4, ... in ascending
// order of f32(x_g . c'_g) * s_g (the product and the sum each rounded) and
// corr = the sum of xsum_g * zs_g in ascending g: the TPU kernel's four
// accumulators of _pairs_group_loop, and its zero correction summed in
// order (the plain version w4a8_matmul_pairs_tpu_order, bit for bit on
// the kernel's own act codes and scales).  The prologue runs in the
// kernel, as JAX fuses it: per row, ss = sum(x * x) and am = max|x| over
// the whole row, r = rsqrt(ss / K + eps) with rms (__frsqrt_rn), sc =
// max(am * r, 1e-8) / 127, codes rint(x * r / sc) (IEEE division; no
// contraction): w4_common.cuh fused_row_scales and quantize8, shared with
// #14.
//
// Bound: the packed weight read (memory), N*K/2 bytes.  The design:
//   * A block takes 32 channels (4 n8 tiles) and MT = 16 or 32 rows (one
//     or two m16 tiles of mma.sync m16n8k32 s8 x s8 -> s32); N 4096 gives
//     128 blocks, no K split (a split could not keep the sequential
//     accumulators).  Its 8 warps are 4 n8 tiles x 2 groups of a pair:
//     warp (ct, h) multiplies group 2p + h of word pair p, so it holds the
//     accumulators a_h (p even) and a_{h+2} (p odd) of its outputs, and the
//     h = 0 warps the correction; the h = 1 warps hand theirs over through
//     shared memory at the end.
//   * One barrier a word pair (two pairs a step measured slower on the
//     H100).  Weights: bytes p*128 .. +128 of the block's 32 channels (4
//     KB, both groups of pair p) stream through a ring of kFusedSlots
//     cp.async slots in the 128-byte swizzle; the first kFusedSlots - 1
//     are issued before the prologue reads any x.  The B fragments come
//     straight from those words in registers (ldmatrix, then S4PairsB: a
//     32-bit word is four consecutive k of one channel, its low nibbles
//     group 2p's codes and its high ones group 2p + 1's).  The block's
//     rows of s and zs (all G groups) land in shared memory with pair 0's
//     words: no global load waits inside a pair.
//   * The prologue: every block reduces its rows' ss and am itself (one
//     to eight warps a row, 16-byte loads, eight in flight a lane, in one
//     fixed order: every block of a row tile gets the same bits), then
//     quantizes pair p + 1's 256 columns of its rows into two swizzled
//     [MT][128] x tiles right after pair p's barrier, beside pair p's
//     products, from values loaded into registers two pairs ahead.
//     rint(v * (1/sc)) (rounded by adding 1.5 * 2^23) equals rint(v / sc)
//     unless v * (1/sc) lies within 2^-14 of a rounding tie, where the
//     kernel divides.  The group sums come from the codes (warp
//     reductions); rows past M are never quantized (they feed only
//     outputs that are not stored).
// ---------------------------------------------------------------------------
constexpr int kFusedWarps = 8;
constexpr int kFusedThreads = kFusedWarps * 32;
constexpr int kFusedChan = 32;                       // channels a block
constexpr int kFusedSlots = 8;                       // word pairs in flight
constexpr int kFusedStage = kFusedChan * kTileRow;   // 4 KB of words a pair
// The weight unpack of the decode tile: the B operand of group 2p + h from
// a 32-bit word of s4 byte pairs (low nibbles for h = 0, high for h = 1).
template <int H>
struct S4PairsB {
  __device__ __forceinline__ int operator()(int w) const {
    return H ? sext_hi((uint32_t)w) : sext_lo((uint32_t)w);
  }
};

// 8 bytes from global to shared memory without registers
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// The integer dots of one group (the warp's n8 tile ct, its m16 tiles)
// from a word-pair tile ws ([32][128], swizzled) and an x tile xt
// ([MT][128], swizzled), the words' B operand mapped by bx.
template <int MI, class BX>
__device__ __forceinline__ void pair_dots(int (&d)[MI][4], const int8_t* ws,
                                          const int8_t* xt, int ct, bool two,
                                          BX bx) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = 0;
#pragma unroll
  for (int k2 = 0; k2 < 2; ++k2) {
    // ldmatrix x4: lane L names channel 8 ct + (L & 7) of 16-byte chunk
    // 4 k2 + (L >> 3): b0, b1 of k steps 2 k2 and 2 k2 + 1
    int r4[4];
    ldsm_x4(r4, ws + swz(8 * ct + (lane & 7), 4 * k2 + (lane >> 3)));
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int b[2] = {bx(r4[2 * v]), bx(r4[2 * v + 1])};
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if (i == 1 && !two) break;
        int a[4], dk[4] = {0, 0, 0, 0};  // a k step's own chain
        decode_a_frag(a, xt, i, 2 * k2 + v);
        mma_s8(dk, a, b);
#pragma unroll
        for (int e = 0; e < 4; ++e) d[i][e] += dk[e];
      }
    }
  }
}

// Pair p's dots d (group 2p + h) into acc with the thread's channels c0,
// c0 + 1 scales, and for h = 0 groups 2p and 2p + 1's corrections into
// corr in order (xs2: their row sums, [2][MT]).  xsum * zs is exact (at
// most 14 + 8 significant bits): the fused multiply-add rounds once, as
// the product and the sum do.
template <int MI, int MT>
__device__ __forceinline__ void scale_pair(
    float (&acc)[MI][4], float (&corr)[MI][4], const int (&d)[MI][4],
    const __nv_bfloat16* s_sh, const __nv_bfloat16* zs_sh, const int* xs2,
    int c0, int G, int p, int h) {
  const int g = (threadIdx.x & 31) >> 2;
  const float sv[2] = {__bfloat162float(s_sh[c0 * G + 2 * p + h]),
                       __bfloat162float(s_sh[(c0 + 1) * G + 2 * p + h])};
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[i][e] = mac_rn(acc[i][e], exact_f32(d[i][e]), sv[e & 1]);
  if (h == 0)
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      const int* xq = xs2 + hq * MT + g;
      const float zv[2] = {
          __bfloat162float(zs_sh[c0 * G + 2 * p + hq]),
          __bfloat162float(zs_sh[(c0 + 1) * G + 2 * p + hq])};
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          corr[i][e] = fmaf((float)xq[16 * i + 8 * (e >> 1)], zv[e & 1],
                            corr[i][e]);
    }
}

// two blocks an SM but for f32 x in 32-row tiles, whose prefetched values
// would not fit in 128 registers a thread
template <typename XT, int MT>
__global__ void __launch_bounds__(kFusedThreads,
                                  MT == 16 || sizeof(XT) == 2 ? 2 : 1)
w4a8_bytes_fused_kernel(const XT* __restrict__ x,
                        const int8_t* __restrict__ wb,
                        const __nv_bfloat16* __restrict__ s,
                        const __nv_bfloat16* __restrict__ zs,
                        XT* __restrict__ out, int8_t* __restrict__ act_out,
                        float* __restrict__ scale_out, int M, int N, int K,
                        int rms, float eps) {
  constexpr int MI = MT / 16;                             // m16 tiles
  constexpr int kChunks = MT * 32 / kFusedThreads;  // 8-value chunks a pair
  constexpr int kWords = 2 * (int)sizeof(XT);       // x words of a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  int8_t* wbuf = reinterpret_cast<int8_t*>(smem);   // [slots][32][128]
  int8_t* xbuf = wbuf + kFusedSlots * kFusedStage;  // [2][2][MT][128]
  const int G = K / kGroup;
  // the block's scales and zero corrections, [32][G] bf16 each
  __nv_bfloat16* s_sh =
      reinterpret_cast<__nv_bfloat16*>(xbuf + 4 * MT * kTileRow);
  __nv_bfloat16* zs_sh = s_sh + kFusedChan * G;
  int* xsum_sh = reinterpret_cast<int*>(zs_sh + kFusedChan * G);  // [2][2][MT]
  float* row_sh = reinterpret_cast<float*>(xsum_sh + 4 * MT);
  float* st_sh = row_sh + 3 * MT;  // [MT][8 warps]: ss, am

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ct = warp & 3, h = warp >> 2;
  const int n0 = blockIdx.x * kFusedChan, m0 = blockIdx.y * MT;
  const int mv = min(MT, M - m0);
  const bool two = MI == 2 && mv > 16;  // the second m16 tile holds rows
  const int kh = K / 2, P = G / 2;  // word pairs
  const bool exporter = act_out != nullptr && blockIdx.x == 0;

  // word pair p of the block's channels into slot p % kFusedSlots (row c,
  // chunk q at swz(c, q)); each call one cp.async group, empty past P
  auto stage_w = [&](int p) {
    if (p < P) {
      int8_t* dst = wbuf + (p % kFusedSlots) * kFusedStage;
      for (int i = tid; i < kFusedChan * 8; i += kFusedThreads)
        cp_async16(dst + swz(i >> 3, i & 7),
                   wb + (size_t)(n0 + (i >> 3)) * kh + p * kTileRow +
                       16 * (i & 7),
                   true);
    }
    cp_async_commit();
  };
  // chunk j of a pair: row r = q / 32, group h' = (q / 16) % 2 of the
  // pair, values 8 (q % 16) .. + 7 of the group, q = tid + 256 j; loaded
  // two pairs ahead into one of two register buffers
  using Raw = uint32_t[kChunks][kWords];
  Raw raw_e, raw_o;  // even, odd pairs
  auto load_x = [&](int p, Raw& raw) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int q = tid + kFusedThreads * j, r = q >> 5;
      if (r >= mv) continue;
      const uint4* src = reinterpret_cast<const uint4*>(
          x + (size_t)(m0 + r) * K + 2 * kGroup * p + 8 * (q & 31));
#pragma unroll
      for (int v = 0; v < kWords / 4; ++v) {
        const uint4 w4 = __ldg(src + v);
        raw[j][4 * v] = w4.x;
        raw[j][4 * v + 1] = w4.y;
        raw[j][4 * v + 2] = w4.z;
        raw[j][4 * v + 3] = w4.w;
      }
    }
  };

  // the block's s and zs rows, 8 bytes a copy, land with pair 0's words
  for (int i = tid; i < kFusedChan * G / 2; i += kFusedThreads) {
    const int w = i % (kFusedChan * G / 4), c = w / (G / 4);
    const int k = 4 * (w % (G / 4));
    const bool z = i >= kFusedChan * G / 4;
    cp_async8((z ? zs_sh : s_sh) + c * G + k,
              (z ? zs : s) + (size_t)(n0 + c) * G + k);
  }
  for (int p = 0; p < kFusedSlots - 1; ++p) stage_w(p);
  load_x(0, raw_e);
  load_x(1, raw_o);  // P >= 2: K % 512 == 0

  // the rows' statistics and scales (w4_common.cuh)
  fused_row_scales<XT, MT, kFusedWarps>(x, K, m0, mv, rms, eps, st_sh,
                                        row_sh, exporter ? scale_out : nullptr);

  // pair p's codes into x tiles [slot][h'] and their group sums.  A
  // chunk's row is the same over the warp: rows past mv are skipped (their
  // codes and sums feed only outputs that are never stored).  The rows'
  // r, sc and 1/sc are held in registers
  float q_rr[kChunks], q_sc[kChunks], q_inv[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int r = min(warp + kFusedWarps * j, MT - 1);
    q_rr[j] = row_sh[r];
    q_sc[j] = row_sh[MT + r];
    q_inv[j] = row_sh[2 * MT + r];
  }
  auto quantize = [&](int p, const Raw& raw) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int q = tid + kFusedThreads * j, r = q >> 5, hq = (q >> 4) & 1;
      const int c8 = q & 15, tile = (p & 1) * 2 + hq;
      if (r >= mv) continue;  // uniform over the warp
      uint32_t lo, hi;
      const int sum = quantize8<XT>(raw[j], rms, q_rr[j], q_sc[j], q_inv[j],
                                    lo, hi);
      // the group's sum: lanes 0-15 hold group 2p's chunks, 16-31 2p + 1's
      const int s0 = __reduce_add_sync(0xffffffffu, hq ? 0 : sum);
      const int s1 = __reduce_add_sync(0xffffffffu, hq ? sum : 0);
      *reinterpret_cast<uint2*>(xbuf + tile * MT * kTileRow +
                                swz(r, c8 >> 1) + 8 * (c8 & 1)) =
          make_uint2(lo, hi);
      if ((lane & 15) == 0) xsum_sh[tile * MT + r] = hq ? s1 : s0;
      if (exporter)
        *reinterpret_cast<uint2*>(act_out + (size_t)(m0 + r) * K +
                                  2 * kGroup * p + 8 * (q & 31)) =
            make_uint2(lo, hi);
    }
  };

  // a thread's outputs, m16 tile i, element e: row 16 i + g + 8 (e >> 1),
  // channel c0 + (e & 1); acc_e: groups 2p + h of even pairs p, acc_o of
  // odd ones
  const int c0 = 8 * ct + 2 * t;
  float acc_e[MI][4], acc_o[MI][4], corr[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_e[i][e] = acc_o[i][e] = corr[i][e] = 0.f;

  // pair p; raw holds pair p + 1's values
  auto step = [&](int p, Raw& raw) {
    // words of pair p landed (every group but the newest kFusedSlots - 2);
    // pair p's codes stored; every warp is past pair p - 1
    cp_async_wait<kFusedSlots - 2>();
    __syncthreads();
    stage_w(p + kFusedSlots - 1);  // into the slot of pair p - 1
    if (p + 1 < P) {
      quantize(p + 1, raw);  // into the tiles pair p - 1 left
      if (p + 3 < P) load_x(p + 3, raw);
    }
    const int8_t* ws = wbuf + (p % kFusedSlots) * kFusedStage;
    const int8_t* xt = xbuf + ((p & 1) * 2 + h) * MT * kTileRow;
    int d[MI][4];
    if (h)
      pair_dots<MI>(d, ws, xt, ct, two, S4PairsB<1>());
    else
      pair_dots<MI>(d, ws, xt, ct, two, S4PairsB<0>());
    const int* xs2 = xsum_sh + (p & 1) * 2 * MT;
    if (p & 1)
      scale_pair<MI, MT>(acc_o, corr, d, s_sh, zs_sh, xs2, c0, G, p, h);
    else
      scale_pair<MI, MT>(acc_e, corr, d, s_sh, zs_sh, xs2, c0, G, p, h);
  };
  quantize(0, raw_e);
  if (2 < P) load_x(2, raw_e);
  for (int p = 0; p < P; p += 2) {  // P is even: K % 512 == 0
    step(p, raw_o);
    step(p + 1, raw_e);
  }

  // the h = 1 warps hand a1, a3 to the h = 0 warps of their channels (the
  // word ring is free: every copy landed and was read)
  __syncthreads();
  float* red = reinterpret_cast<float*>(wbuf) + (ct * 32 + lane) * 8 * MI;
  if (h == 1) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[i * 4 + e] = acc_e[i][e];
        red[4 * MI + i * 4 + e] = acc_o[i][e];
      }
  }
  __syncthreads();
  if (h == 0) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * i + g + 8 * hr;
        if (r >= mv) continue;
        const float xs = row_sh[MT + r];
        float y[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * hr + c;
          y[c] = __fmul_rn(
              __fsub_rn(__fadd_rn(__fadd_rn(acc_e[i][e], red[i * 4 + e]),
                                  __fadd_rn(acc_o[i][e],
                                            red[4 * MI + i * 4 + e])),
                        corr[i][e]),
              xs);
        }
        store2(out + (size_t)(m0 + r) * N + n0 + c0, y[0], y[1]);
      }
  }
}

size_t fused_smem(int mt, int K) {
  return 128 + (size_t)kFusedSlots * kFusedStage + 4 * (size_t)mt * kTileRow +
         2 * (size_t)kFusedChan * (K / kGroup) * 2 + 4 * (size_t)mt * 4 +
         3 * (size_t)mt * 4 + 2 * (size_t)mt * kFusedWarps * 4;
}

template <typename XT, int MT>
int launch_fused_mt(const XT* x, const void* wb, const void* s,
                    const void* zs, void* out, void* act_out, void* scale_out,
                    int M, int N, int K, int rms, float eps, void* stream) {
  const size_t smem = fused_smem(MT, K);
  cudaError_t e = prepare(w4a8_bytes_fused_kernel<XT, MT>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / kFusedChan, (M + MT - 1) / MT);
  w4a8_bytes_fused_kernel<XT, MT>
      <<<grid, kFusedThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
          x, (const int8_t*)wb, (const __nv_bfloat16*)s,
          (const __nv_bfloat16*)zs, (XT*)out, (int8_t*)act_out,
          (float*)scale_out, M, N, K, rms, eps);
  return (int)cudaGetLastError();
}

// one m16 tile up to 16 rows, two (32-row tiles) above
template <typename XT>
int launch_bytes_fused(const XT* x, const void* wb, const void* s,
                       const void* zs, void* out, void* act_out,
                       void* scale_out, int M, int N, int K, int rms,
                       float eps, void* stream) {
  if (M < 1 || K % (4 * kGroup) || N % kFusedChan)
    return (int)cudaErrorInvalidValue;
  if (M <= 16)
    return launch_fused_mt<XT, 16>(x, wb, s, zs, out, act_out, scale_out, M,
                                   N, K, rms, eps, stream);
  return launch_fused_mt<XT, 32>(x, wb, s, zs, out, act_out, scale_out, M, N,
                                 K, rms, eps, stream);
}

// ---------------------------------------------------------------------------
// #11 W4A8 on natural-order s4 bytes, on the int8 tensor cores.  Replaces
// lightcompress_tpu/ops/pallas_matmul.py w4a8_matmul_s4 (_w4a8_kernel_s4)
// behind its byte-view entry point w4a8_matmul_s4_bytes.
//
// Weight layout (pack_s4_bytes, untiled): wb (N, K/2) int8, byte b holds the
// signed code c' = u - 8 of weight 2b in its low nibble and of weight 2b+1
// in its high one; s and zs' = (z - 8) * s are (N, G) in ST (f32 or bf16).
// In the TPU kernel's order:
//   a_r = sum over the groups g with g % 4 == r, in turn, of
//         f32(x_g . c'_g) * s_g   (exact int32 group dots)
//   y = ((a0 + a1) + (a2 + a3) - corr) * x_scale, corr = the sum of
//       xsum_g * zs'_g in ascending g
// each product and sum rounded once (__fmul_rn, __fadd_rn: with f32 zs'
// the product xsum * zs' is not exact), bit for bit the plain version
// w4a8_matmul_s4_plain.  Bound: the packed weight read (memory).  The
// design: #13's int8 decode tile without its prologue (x arrives as codes
// with their scales), in stages of four groups:
//   * A block takes 32 channels (4 n8 tiles) and MT = 16 or 32 rows (one or
//     two m16 tiles of mma.sync m16n8k32 s8 x s8 -> s32; more rows are a
//     grid dimension, innermost, so that a channel tile's row tiles share
//     its words in L2).  Stage p holds groups 4p .. 4p + 3 (bytes 256p ..
//     +256 of a row); its 8 warps are 4 n8 tiles x 2: warp (ct, h) takes
//     groups 4p + h and 4p + 2 + h, so it holds the whole accumulators
//     a_h and a_{h+2} of its outputs; the h = 1 warps hand theirs over
//     through shared memory at the end.  Groups past G (K % 512 != 0) are
//     zeros, not multiplied.
//   * A stage's 8 KB of words (two [32][128] tiles) and its rows' 512
//     columns of x (four [MT][128] tiles) stream through a ring of
//     s4_slots(MT) cp.async slots in the 128-byte swizzle, one barrier a
//     stage; the block's rows of s and zs' (32 x G each, contiguous) land
//     with stage 0.  Every thread sums 16-byte chunks of the stage's x
//     (the row sums, shared through shared memory), and the h = 0 warps
//     add the stage's corrections in order one stage later.  (Stages of
//     two groups, the row sums taken by the h = 0 warps alone, measured
//     slower: PERF.md.)
//   * The B operand straight from the words (one ldmatrix x4 a group): a
//     32-bit word is k 8q .. 8q + 7 of one channel, its low nibbles
//     (sext_lo) the even k and its high ones (sext_hi) the odd k, so one
//     word gives both B registers of a k32 step.  The A registers take the
//     same order: 8 bytes of x at k 32 kk + 8t, evens then odds (two byte
//     permutes).  The group dot is an exact integer, so any k order gives
//     the TPU's bits.
// ---------------------------------------------------------------------------
constexpr int kS4Threads = 256;  // 8 warps
constexpr int kS4Chan = 32;      // channels a block
constexpr int kS4WTile = kS4Chan * kTileRow;  // a [32][128] word tile
constexpr int kS4Words = 2 * kS4WTile;        // 8 KB of words a stage
// ring slots: two blocks an SM with K 14336's f32 scales
__host__ __device__ constexpr int s4_slots(int mt) { return mt == 16 ? 5 : 3; }

// The exact dots of one group (warp (ct, h)): its 64 bytes of words at
// chunks 4h .. 4h + 3 of word tile ws ([32][128], swizzled), x tile xt
// ([MT][128], swizzled), the warp's n8 tile ct and its m16 tiles (the
// second where two).
template <int MI>
__device__ __forceinline__ void s4_group_dots(int (&d)[MI][4],
                                              const int8_t* ws,
                                              const int8_t* xt, int ct,
                                              int h, bool two) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = 0;
  // ldmatrix x4: lane L names channel 8 ct + (L & 7) of chunk 4h + (L >>
  // 3): r4[kk] is word t of k step kk's 16 bytes of channel 8 ct + g
  int r4[4];
  ldsm_x4(r4, ws + swz(8 * ct + (lane & 7), 4 * h + (lane >> 3)));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int b[2] = {sext_lo((uint32_t)r4[kk]), sext_hi((uint32_t)r4[kk])};
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (i == 1 && !two) break;
      // rows 16 i + g (a0, a2) and + 8 (a1, a3): k 32 kk + 8t .. + 7
      const int off = 8 * (t & 1);
      const uint2 lo = *reinterpret_cast<const uint2*>(
          xt + swz(16 * i + g, 2 * kk + (t >> 1)) + off);
      const uint2 hi = *reinterpret_cast<const uint2*>(
          xt + swz(16 * i + g + 8, 2 * kk + (t >> 1)) + off);
      const int a[4] = {(int)__byte_perm(lo.x, lo.y, 0x6420),
                        (int)__byte_perm(hi.x, hi.y, 0x6420),
                        (int)__byte_perm(lo.x, lo.y, 0x7531),
                        (int)__byte_perm(hi.x, hi.y, 0x7531)};
      int dk[4] = {0, 0, 0, 0};  // a k step's own chain
      mma_s8(dk, a, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][e] += dk[e];
    }
  }
}

template <int MT, typename ST>
__global__ void __launch_bounds__(kS4Threads, 2)
w4a8_s4_tile_kernel(const int8_t* __restrict__ xq,
                    const float* __restrict__ xscale,
                    const int8_t* __restrict__ wb, const ST* __restrict__ s,
                    const ST* __restrict__ zs, float* __restrict__ out, int M,
                    int N, int K) {
  constexpr int MI = MT / 16;
  constexpr int S = s4_slots(MT);
  constexpr int kXT = MT * kTileRow;         // an x tile [MT][128]
  constexpr int kSlot = kS4Words + 4 * kXT;  // words, x of 4p .. 4p + 3
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  const int G = K / kGroup, kh = K / 2, P = (G + 3) / 4;  // stages
  ST* s_sh = reinterpret_cast<ST*>(smem + (size_t)S * kSlot);  // [32][G]
  ST* zs_sh = s_sh + kS4Chan * G;
  int* xsum_sh = reinterpret_cast<int*>(zs_sh + kS4Chan * G);  // [2][4][MT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ct = warp & 3, h = warp >> 2;
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * kS4Chan;
  const int mv = min(MT, M - m0);
  const bool two = MI == 2 && mv > 16;  // the second m16 tile holds rows

  // the block's rows of s and zs' (32 G values each, contiguous), in
  // 16-byte copies that land with stage 0
  {
    const int nb = kS4Chan * G * (int)sizeof(ST) / 16;
    for (int i = tid; i < 2 * nb; i += kS4Threads) {
      const bool z = i >= nb;
      const int k = z ? i - nb : i;
      cp_async16(reinterpret_cast<unsigned char*>(z ? zs_sh : s_sh) + 16 * k,
                 reinterpret_cast<const unsigned char*>(
                     (z ? zs : s) + (size_t)n0 * G) + 16 * k,
                 true);
    }
  }
  // stage p into slot p % S: bytes 256p .. +256 of the block's 32 rows
  // (chunk q of row c in word tile q >> 3 at swz(c, q & 7)) and columns
  // 512p .. +512 of its rows (chunk q of row r in x tile q >> 3 at swz(r,
  // q & 7)); past the row's bytes, G's groups or M's rows, zeros.  Each
  // call one cp.async group, empty past P
  auto stage = [&](int p) {
    if (p < P) {
      int8_t* dst = ring + (p % S) * kSlot;
      for (int i = tid; i < kS4Chan * 16; i += kS4Threads) {
        const int c = i >> 4, q = i & 15, b = 2 * kTileRow * p + 16 * q;
        const bool ok = b < kh;
        cp_async16(dst + (q >> 3) * kS4WTile + swz(c, q & 7),
                   ok ? wb + (size_t)(n0 + c) * kh + b : wb, ok);
      }
      for (int i = tid; i < MT * 32; i += kS4Threads) {
        const int r = i >> 5, q = i & 31;
        const bool ok = r < mv && 4 * p + (q >> 3) < G;
        cp_async16(dst + kS4Words + (q >> 3) * kXT + swz(r, q & 7),
                   ok ? xq + (size_t)(m0 + r) * K + 4 * kGroup * p + 16 * q
                      : xq,
                   ok);
      }
    }
    cp_async_commit();
  };

  // a thread's outputs, m16 tile i, element e: row 16 i + g + 8 (e >> 1),
  // channel c0 + (e & 1); acc[j]: the groups 4p + 2j + h, a_{h + 2j}
  const int c0 = 8 * ct + 2 * t;
  float acc[2][MI][4], corr[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][i][e] = acc[1][i][e] = corr[i][e] = 0.f;

  // the corrections of stage q's groups in order, from their row sums
  // (xsum_sh ring entry q & 1)
  auto corrections = [&](int q) {
    const int* xs4 = xsum_sh + (q & 1) * 4 * MT;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gq = 4 * q + j;
      if (gq >= G) break;
      const float zv[2] = {to_f32(zs_sh[c0 * G + gq]),
                           to_f32(zs_sh[(c0 + 1) * G + gq])};
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          corr[i][e] = mac_rn(corr[i][e],
                              (float)xs4[j * MT + 16 * i + g + 8 * (e >> 1)],
                              zv[e & 1]);
    }
  };

  for (int p = 0; p < S - 1; ++p) stage(p);
  for (int p = 0; p < P; ++p) {
    cp_async_wait<S - 2>();  // stage p landed (all but the newest S - 2)
    __syncthreads();         // for every thread; every warp is past p - 1
    stage(p + S - 1);        // into the slot of stage p - 1
    const int8_t* st = ring + (p % S) * kSlot;
    const int8_t* x0 = st + kS4Words;
    // the stage's row sums: chunk i & 7 of row i >> 3 (x tile row / MT,
    // row % MT), the 8 chunks of a row in 8 neighbouring lanes
#pragma unroll
    for (int i0 = 0; i0 < 4 * MT * 8; i0 += kS4Threads) {
      const int i = i0 + tid, row = i >> 3;
      const int4 v = *reinterpret_cast<const int4*>(
          x0 + (row / MT) * kXT + swz(row % MT, i & 7));
      int a = __dp4a(v.x, 0x01010101, 0);
      a = __dp4a(v.y, 0x01010101, a);
      a = __dp4a(v.z, 0x01010101, a);
      a = __dp4a(v.w, 0x01010101, a);
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if ((i & 7) == 0) xsum_sh[(p & 1) * 4 * MT + row] = a;
    }
    if (h == 0 && p > 0) corrections(p - 1);  // written before the barrier
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gq = 4 * p + 2 * j + h;
      if (gq >= G) break;  // uniform over the warp
      int d[MI][4];
      s4_group_dots<MI>(d, st + j * kS4WTile, x0 + (2 * j + h) * kXT, ct, h,
                        two);
      const float sv[2] = {to_f32(s_sh[c0 * G + gq]),
                           to_f32(s_sh[(c0 + 1) * G + gq])};
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][i][e] = mac_rn(acc[j][i][e], exact_f32(d[i][e]), sv[e & 1]);
    }
  }

  // the last stage's row sums for the h = 0 warps; the h = 1 warps hand
  // a1, a3 to them (the ring is free: every copy landed and was read)
  __syncthreads();
  if (h == 0) corrections(P - 1);
  float* red = reinterpret_cast<float*>(ring) + (ct * 32 + lane) * 8 * MI;
  if (h == 1) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[i * 4 + e] = acc[0][i][e];
        red[4 * MI + i * 4 + e] = acc[1][i][e];
      }
  }
  __syncthreads();
  if (h == 0) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * i + g + 8 * hr;
        if (r >= mv) continue;
        const float xs = xscale[m0 + r];
        float y[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * hr + c;
          y[c] = __fmul_rn(
              __fsub_rn(__fadd_rn(__fadd_rn(acc[0][i][e], red[i * 4 + e]),
                                  __fadd_rn(acc[1][i][e],
                                            red[4 * MI + i * 4 + e])),
                        corr[i][e]),
              xs);
        }
        store2(out + (size_t)(m0 + r) * N + n0 + c0, y[0], y[1]);
      }
  }
}

template <int MT, typename ST>
int launch_s4_mt(const void* xq, const void* xscale, const void* wb,
                 const void* s, const void* zs, void* out, int M, int N,
                 int K, void* stream) {
  const size_t smem = 128 +
                      (size_t)s4_slots(MT) * (kS4Words + 4 * MT * kTileRow) +
                      (size_t)2 * kS4Chan * (K / kGroup) * sizeof(ST) +
                      (size_t)2 * 4 * MT * 4;
  auto kern = w4a8_s4_tile_kernel<MT, ST>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + MT - 1) / MT, N / kS4Chan);
  kern<<<grid, kS4Threads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)xq, (const float*)xscale, (const int8_t*)wb,
      (const ST*)s, (const ST*)zs, (float*)out, M, N, K);
  return (int)cudaGetLastError();
}

// one m16 tile up to 16 rows, two (32-row tiles) above
template <typename ST>
int launch_s4(const void* xq, const void* xscale, const void* wb,
              const void* s, const void* zs, void* out, int M, int N, int K,
              void* stream) {
  if (M < 1 || K % kGroup || N % kS4Chan) return (int)cudaErrorInvalidValue;
  if (M <= 16)
    return launch_s4_mt<16, ST>(xq, xscale, wb, s, zs, out, M, N, K, stream);
  return launch_s4_mt<32, ST>(xq, xscale, wb, s, zs, out, M, N, K, stream);
}

int launch_bytes(const void* xq, const void* xscale, const void* wb,
                 const void* s, const void* zs, void* out, int M, int N,
                 int K, void* stream) {
  const size_t smem = decode_smem_i8(8, K);
  cudaError_t e = prepare(w4a8_bytes_kernel<8>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / 32, (M + 7) / 8);
  w4a8_bytes_kernel<8><<<grid, kDecodeThreads, smem,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)xq, (const float*)xscale, (const int8_t*)wb,
      (const __nv_bfloat16*)s, (const __nv_bfloat16*)zs, (float*)out, M, N,
      K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// #12, the tile: xq (M, K) int8, xscale (M,) f32 -> out (M, N) f32;
// K % 512 == 0, N % 32 == 0.
int lc_w4a8_bytes_tile(const void* xq, const void* xscale, const void* wb,
                       const void* s, const void* zs, void* out, int M,
                       int N, int K, void* stream) {
  CUtensorMap xmap, wmap;
  int rc = tensor_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, K, M, K,
                         kTileRow, kTileM);
  if (rc == 0)
    rc = tensor_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, wb, K / 2, N,
                       K / 2, kTileRow, kTileN);
  if (rc != 0) return rc;
  cudaError_t e = prepare(w4a8_bytes_tile_kernel, kBytesSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kTileM - 1) / kTileM, (N + kTileN - 1) / kTileN);
  w4a8_bytes_tile_kernel<<<grid, kBytesThreads, kBytesSmem,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      xmap, (const float*)xscale, wmap, (const __nv_bfloat16*)s,
      (const __nv_bfloat16*)zs, (float*)out, M, N, K);
  return (int)cudaGetLastError();
}

// #12, the decode block: xq (M, K) int8, xscale (M,) f32 -> out (M, N) f32.
int lc_w4a8_bytes(const void* xq, const void* xscale, const void* wb,
                  const void* s, const void* zs, void* out, int M, int N,
                  int K, void* stream) {
  return launch_bytes(xq, xscale, wb, s, zs, out, M, N, K, stream);
}

// #13: x (M, K) bf16 (x_f32 = 0) or f32 (1); out (M, N) in x's type;
// act_out (M, K) int8 and scale_out (M,) f32 may be null.  K % 512 == 0,
// N % 32 == 0.
int lc_w4a8_bytes_fused(const void* x, int x_f32, const void* wb,
                        const void* s, const void* zs, void* out,
                        void* act_out, void* scale_out, int M, int N, int K,
                        int rms, float eps, void* stream) {
  if (x_f32)
    return launch_bytes_fused((const float*)x, wb, s, zs, out, act_out,
                              scale_out, M, N, K, rms, eps, stream);
  return launch_bytes_fused((const __nv_bfloat16*)x, wb, s, zs, out, act_out,
                            scale_out, M, N, K, rms, eps, stream);
}

// #11: xq (M, K) int8, xscale (M,) f32, wb (N, K/2) natural s4 bytes,
// s, zs (N, G) f32 (s_bf16 = 0) or bf16 (1) -> out (M, N) f32; K % 128
// == 0, N % 32 == 0, M >= 1.
int lc_w4a8_s4(const void* xq, const void* xscale, const void* wb,
               const void* s, const void* zs, int s_bf16, void* out, int M,
               int N, int K, void* stream) {
  if (s_bf16)
    return launch_s4<__nv_bfloat16>(xq, xscale, wb, s, zs, out, M, N, K,
                                    stream);
  return launch_s4<float>(xq, xscale, wb, s, zs, out, M, N, K, stream);
}

}  // extern "C"
