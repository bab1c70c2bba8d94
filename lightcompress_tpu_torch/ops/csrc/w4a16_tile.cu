// #1 and #4: the W4A16 decode matmuls on the bf16 tensor cores of Hopper
// (sm_90a), one kernel template, CUDA C++ with a plain C interface bound
// from Python with ctypes (ops/_build.py, ops/w4_matmul.py).  Replaces
// lightcompress_tpu/ops/pallas_matmul.py w4a16_matmul_planes
// (_w4a16_kernel_fullk) and w4a16_matmul_planes_masked
// (_w4a16_kernel_fullk_masked).
//
// Weights: untiled planes, (N, K/8) int32 words, nibble j of word kw the code
// of weight j*K/8 + kw, and (N, G) scales and zero corrections, G = K/128; a
// group g = j*gpp + gi (plane j, word block gi, gpp = K/1024).
//   #1: codes u, bf16 s and zs = z*s; y in x's type (bf16 or f32).
//   #4: the masked planes (plane 7 stored XOR 0x8, read as (u - 8) * 2^28),
//       scales pre-divided by 16^j and zs = (z - 8*[j = 7])*s, f32 or bf16;
//       plane j's masked value is its code times 16^j, so the group partial
//       is the code dot times 16^j (a power of two: exact); y in f32.
// Both in the TPU kernels' order: for gi, then plane j, the f32 partial of
// the bf16 dot (times 16^j for #4) times s added into accumulator j % 4;
// corr = the sum of xsum * zs over (gi, j); y = (a0 + a1) + (a2 + a3) -
// corr, every op rounded on its own.  The dot of 128 bf16 products is summed
// inside the tensor core (not IEEE-sequential), so the gates are one bf16
// ulp (bf16 y) or 1e-4 of max|y| (f32 y) against the plain versions.
//
// Bound on an H100 SXM: the packed weight read, bytes = N*K/2 + 2*N*G*b_s +
// M*K*2 + M*N*b_y over 3.35 TB/s (a Llama-3-8B block at M 8: 0.035 ms).
// The design:
//   * Swapped operands: mma.sync m16n8k16 bf16 with 16 channels as A (m16)
//     and 8 tokens as B (n8), so a decode of 8 tokens fills the mma and
//     32 tokens are four n8 tiles.  The k of a product is free to permute
//     as long as A and B agree: lane (g, t) reads 16 bytes of channel g's
//     words (four consecutive words, k = 4t .. 4t + 3 of every plane) and
//     makes of them the A registers of all eight planes for the mma's
//     logical k {2t, 2t + 1} (words 0, 1) and {2t + 8, 2t + 9} (words 2,
//     3); B is then one 8-byte read of x at physical k 4t .. 4t + 3.
//   * Unpack in registers: a byte permute puts byte b of two words in the
//     two halves of a word, a mask and an OR of 0x4300 make bf16 128 + c,
//     and a bf16x2 subtract of 128 leaves c, exactly (plane 7 masked: an
//     XOR of 8 and 136 subtracted: c - 8).
//   * A block: 4 warps, 64 channels (a warp an m16 tile), up to 32 tokens
//     (NT n8 tiles: every weight byte read once at M <= 32; more tokens
//     are a grid dimension of 32-token chunks, neighbours in launch order
//     so that they share the word blocks in L2), and one of KS splits of
//     the gi range; the KS CTAs of a channel tile are one cluster.  At 8
//     tokens up to 8 splits: K 4096 is four splits of one gi each, so N
//     1024 gives 64 blocks of 32 KB, q and o 256, gate and up 896; from 16
//     tokens, where meeting costs more (20 NT values a thread), up to 2.
//   * Copies: a split's word block of gi (64 channels x 512 bytes) and its
//     bf16 x slab of gi (8 planes x 128 k x the block's tokens), by
//     cp.async in 16-byte chunks, swizzled so that the fragment reads hit
//     distinct banks, with the gi's scales and zero corrections read into
//     registers meanwhile; the group sums of x are taken from the slab
//     (f32, four chains in k order).  One slot a block (48 KB at 8
//     tokens) lets four blocks share an SM, the copies of one under the
//     products of another; at 32 tokens a split of more than two gi takes
//     two slots, the next gi's copies under this gi's products.  (These
//     choices, and blocks of 2 or 8 warps, were measured: PERF.md.)
//   * The splits meet in the cluster: each CTA leaves its four
//     accumulators and corr in its shared memory, and the first adds the
//     others' accumulator by accumulator in rank order (the same bits every
//     run), then stores y in OutT.

#include <cooperative_groups.h>

#include "w4_bf16_tile.cuh"

namespace {

namespace cg = cooperative_groups;

using namespace lcw4;

constexpr int kTWarps = 4;                    // m16 channel tiles a block
constexpr int kTThreads = kTWarps * 32;
constexpr int kTChan = kTWarps * 16;          // 64 channels a block
constexpr int kTWords = kTChan * kWordRow;    // a block's word block, 32 KB

// 2^(4j): plane j's factor of the masked layout
__device__ __forceinline__ float pow16(int j) {
  return __int_as_float((127 + 4 * j) << 23);
}

// The tile.  Grid (token chunks of 8 NT, KS splits, ceil(N / 64) channel
// tiles), clusters of (1, KS, 1).
template <int NT, bool kMasked, typename ST, typename OutT>
__global__ void __launch_bounds__(kTThreads)
w4a16_tile_kernel(const __nv_bfloat16* __restrict__ x,
                  const int32_t* __restrict__ wp, const ST* __restrict__ s,
                  const ST* __restrict__ zs, OutT* __restrict__ out, int M,
                  int N, int K, int slots) {
  constexpr int TB = 8 * NT;             // tokens a block
  constexpr int kXRow = kGroup * 2;      // bytes of a token's plane row
  constexpr int kSlot = kTWords + 8 * TB * kXRow;  // words, then the x slab
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  float* xsum_sh = reinterpret_cast<float*>(smem + (size_t)slots * kSlot);
  const int kp = K / 8, G = K / kGroup, gpp = kp / kGroup;
  const int KS = gridDim.y, sp = blockIdx.y;
  const int gi_lo = sp * gpp / KS, gi_hi = (sp + 1) * gpp / KS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * TB, nv = min(TB, M - m0);
  const int n0 = blockIdx.z * kTChan;
  const int nw = n0 + 16 * warp;  // the warp's 16 channels
  const bool live = nw < N;

  // a thread's outputs, n8 tile nt, element e: channel nw + g + 8 (e >> 1),
  // token 8 nt + 2t + (e & 1)
  float acc[4][NT][4], corr[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      corr[nt][e] = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][nt][e] = 0.f;
    }
  const size_t srow0 = (size_t)(live ? nw + g : 0) * G;
  const size_t srow1 = srow0 + (size_t)8 * G;

  // the word block (row c: 512 bytes, chunk q at q ^ 4 (c & 1)) and the x
  // slab (plane j, token r: 256 bytes, chunk c at c ^ (r & 7)) of gi into
  // slot (gi - gi_lo) % slots, one cp.async group (empty past the split)
  auto stage = [&](int gi) {
    if (gi < gi_hi) {
      unsigned char* dst = smem + (size_t)((gi - gi_lo) % slots) * kSlot;
      for (int i = tid; i < kTChan * 32; i += kTThreads) {
        const int c = i >> 5, q = i & 31;
        const bool ok = n0 + c < N;
        cp_async16(dst + c * kWordRow + ((q ^ ((c & 1) << 2)) << 4),
                   ok ? wp + (size_t)(n0 + c) * kp + gi * kGroup + 4 * q
                      : (const int32_t*)wp,
                   ok);
      }
      for (int i = tid; i < 8 * TB * 16; i += kTThreads) {
        const int j = i / (TB * 16), r = (i >> 4) % TB, c = i & 15;
        const bool ok = r < nv;
        cp_async16(dst + kTWords + (j * TB + r) * kXRow + ((c ^ (r & 7)) << 4),
                   ok ? x + (size_t)(m0 + r) * K + j * kp + gi * kGroup + 8 * c
                      : x,
                   ok);
      }
    }
    cp_async_commit();
  };

  if (slots > 1) stage(gi_lo);
  for (int gi = gi_lo; gi < gi_hi; ++gi) {
    __syncthreads();  // every warp is done with the slot staged next
    stage(gi + slots - 1);
    // the gi's scales and zero corrections of the lane's two channels,
    // read while the copies land
    float sv[8][2], zv[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t o = (size_t)j * gpp + gi;
      sv[j][0] = live ? to_f32(s[srow0 + o]) : 0.f;
      sv[j][1] = live ? to_f32(s[srow1 + o]) : 0.f;
      zv[j][0] = live ? to_f32(zs[srow0 + o]) : 0.f;
      zv[j][1] = live ? to_f32(zs[srow1 + o]) : 0.f;
    }
    if (slots > 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // the copies of gi landed for every thread
    unsigned char* wbuf = smem + (size_t)((gi - gi_lo) % slots) * kSlot;
    const unsigned char* xs = wbuf + kTWords;
    // the group sums of the slab: thread (plane j, token r), four f32
    // chains (k mod 8 in {2q, 2q + 1}) in k order, then (a0 + a1) +
    // (a2 + a3)
    for (int i = tid; i < 8 * TB; i += kTThreads) {
      const int j = i / TB, r = i % TB;
      const unsigned char* row = xs + (j * TB + r) * kXRow;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int c = 0; c < 16; ++c) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            row + ((c ^ (r & 7)) << 4));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = __fadd_rn(a[q], __uint_as_float(w[q] << 16));
          a[q] = __fadd_rn(a[q], __uint_as_float(w[q] & 0xFFFF0000u));
        }
      }
      xsum_sh[j * TB + r] =
          __fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3]));
    }
    __syncthreads();  // the group sums, for every thread
    if (!live) continue;
    // the zero correction of gi, plane by plane
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* xq = xsum_sh + j * TB + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          corr[nt][e] = __fadd_rn(
              corr[nt][e], __fmul_rn(xq[8 * nt + (e & 1)], zv[j][e >> 1]));
    }

    const unsigned char* wrow = wbuf + (16 * warp + g) * kWordRow;
    const unsigned char* wrow8 = wrow + 8 * kWordRow;
    const int sw = (g & 1) << 2;  // rows g and g + 8: one parity
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // planes 4h .. 4h + 3: bytes 2h, 2h + 1
      float d[4][NT][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[p][nt][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < 8; ++kk) {
        const int q = 4 * kk + t;  // the chunk of words 16 kk + 4t .. + 3
        const uint4 wa =
            *reinterpret_cast<const uint4*>(wrow + ((q ^ sw) << 4));
        const uint4 wb =
            *reinterpret_cast<const uint4*>(wrow8 + ((q ^ sw) << 4));
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const int b = 2 * h + bb;
          // a0: row g, logical k 2t, 2t + 1 (words 0, 1); a1: row g + 8;
          // a2: row g, k 2t + 8, 2t + 9 (words 2, 3); a3: row g + 8
          const uint32_t pr[4] = {byte_pair(wa.x, wa.y, b),
                                  byte_pair(wb.x, wb.y, b),
                                  byte_pair(wa.z, wa.w, b),
                                  byte_pair(wb.z, wb.w, b)};
#pragma unroll
          for (int nib = 0; nib < 2; ++nib) {
            const int p = 2 * bb + nib, j = 4 * h + p;
            uint32_t a[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              a[r] = (kMasked && j == 7) ? code_pair<true>(pr[r], nib)
                                         : code_pair<false>(pr[r], nib);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              // token 8 nt + g, plane j, physical k 16 kk + 4t .. + 3
              const int r = 8 * nt + g;
              const uint2 bv = *reinterpret_cast<const uint2*>(
                  xs + (j * TB + r) * kXRow +
                  (((2 * kk + (t >> 1)) ^ (r & 7)) << 4) + 8 * (t & 1));
              mma_bf16(d[p][nt], a, bv.x, bv.y);
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int j = 4 * h + p;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float part =
                kMasked ? __fmul_rn(d[p][nt][e], pow16(j)) : d[p][nt][e];
            acc[j & 3][nt][e] =
                __fadd_rn(acc[j & 3][nt][e], __fmul_rn(part, sv[j][e >> 1]));
          }
      }
    }
  }
  __syncthreads();  // every warp is done with the copies

  // the splits meet in the cluster, accumulator by accumulator, in rank
  // order; the first CTA stores
  constexpr int kVals = 5 * NT * 4;
  if (KS > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    float* ex = reinterpret_cast<float*>(smem);  // the word block, free now
#pragma unroll
    for (int v = 0; v < kVals; ++v)
      ex[v * kTThreads + tid] =
          v < 4 * NT * 4 ? acc[v / (NT * 4)][(v / 4) % NT][v & 3]
                         : corr[(v / 4) % NT][v & 3];
    cluster.sync();
    if (sp == 0) {
      for (int rk = 1; rk < KS; ++rk) {
        const float* other = cluster.map_shared_rank(ex, rk);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int r = 0; r < 4; ++r)
              acc[r][nt][e] = __fadd_rn(
                  acc[r][nt][e],
                  other[((r * NT + nt) * 4 + e) * kTThreads + tid]);
            corr[nt][e] = __fadd_rn(
                corr[nt][e],
                other[((4 * NT + nt) * 4 + e) * kTThreads + tid]);
          }
      }
    }
    cluster.sync();  // the others' shared memory lives until it was read
    if (sp != 0) return;
  }
  if (!live) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * nt + 2 * t + (e & 1);
      if (r >= nv) continue;
      const float y = __fsub_rn(
          __fadd_rn(__fadd_rn(acc[0][nt][e], acc[1][nt][e]),
                    __fadd_rn(acc[2][nt][e], acc[3][nt][e])),
          corr[nt][e]);
      store(out + (size_t)(m0 + r) * N + nw + g + 8 * (e >> 1), y);
    }
}

// Splits of the gi range: the largest divisor of gpp up to max_splits, or
// that many uneven splits where the divisor is less than half of it.
int tile_splits(int gpp, int max_splits) {
  const int cap = gpp < max_splits ? gpp : max_splits;
  int ks = 1;
  for (int d = cap; d >= 1; --d)
    if (gpp % d == 0) {
      ks = d;
      break;
    }
  return 2 * ks <= cap ? cap : ks;
}

template <int NT, bool kMasked, typename ST, typename OutT>
int launch_tile(const void* x, const void* wp, const void* s, const void* zs,
                void* out, int M, int N, int K, int max_splits,
                void* stream) {
  constexpr int TB = 8 * NT;
  const int gpp = K / (8 * kGroup), ks = tile_splits(gpp, max_splits);
  // two slots where a 32-token split runs more than two gi (the K 14336
  // down: -14%); at two gi they cost a block an SM (q|k|v: +17%)
  const int slots = NT == 4 && (gpp + ks - 1) / ks > 2 ? 2 : 1;
  const size_t smem = 128 + (size_t)slots * (kTWords + 8 * TB * kGroup * 2) +
                      (size_t)8 * TB * 4;
  auto kern = w4a16_tile_kernel<NT, kMasked, ST, OutT>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + TB - 1) / TB, ks, (N + kTChan - 1) / kTChan);
  cfg.blockDim = dim3(kTThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, (const __nv_bfloat16*)x,
                         (const int32_t*)wp, (const ST*)s, (const ST*)zs,
                         (OutT*)out, M, N, K, slots);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the 8-, 16- or 32-token instance by M (more tokens are chunks of 32),
// with the most splits of the gi range a cluster takes at that instance:
// 8 (the portable cluster size) at 8 tokens, 2 from 16 on, where the
// splits' meeting costs more than the blocks it adds (PERF.md)
constexpr int kSplits8 = 8, kSplits16 = 2, kSplits32 = 2;
template <bool kMasked, typename ST, typename OutT>
int launch_by_m(const void* x, const void* wp, const void* s, const void* zs,
                void* out, int M, int N, int K, void* stream) {
  if (M <= 8)
    return launch_tile<1, kMasked, ST, OutT>(x, wp, s, zs, out, M, N, K,
                                             kSplits8, stream);
  if (M <= 16)
    return launch_tile<2, kMasked, ST, OutT>(x, wp, s, zs, out, M, N, K,
                                             kSplits16, stream);
  return launch_tile<4, kMasked, ST, OutT>(x, wp, s, zs, out, M, N, K,
                                           kSplits32, stream);
}

}  // namespace

extern "C" {

// #1: x (M, K) bf16, wp (N, K/8) planes, s and zs (N, G) bf16 -> out (M, N)
// bf16 (out_f32 = 0) or f32.  #4 (masked = 1): wp the masked planes, s and
// zs f32 (s_bf16 = 0) or bf16, out f32.  K % 1024 == 0, N % 16 == 0, M >= 1.
int lc_w4a16_tile(const void* x, const void* wp, const void* s,
                  const void* zs, int s_bf16, int masked, void* out,
                  int out_f32, int M, int N, int K, void* stream) {
  if (K % (8 * kGroup) || N % 16 || M < 1) return (int)cudaErrorInvalidValue;
  if (!masked) {
    if (!s_bf16) return (int)cudaErrorInvalidValue;
    if (out_f32)
      return launch_by_m<false, __nv_bfloat16, float>(x, wp, s, zs, out, M,
                                                      N, K, stream);
    return launch_by_m<false, __nv_bfloat16, __nv_bfloat16>(
        x, wp, s, zs, out, M, N, K, stream);
  }
  if (!out_f32) return (int)cudaErrorInvalidValue;
  if (s_bf16)
    return launch_by_m<true, __nv_bfloat16, float>(x, wp, s, zs, out, M, N,
                                                   K, stream);
  return launch_by_m<true, float, float>(x, wp, s, zs, out, M, N, K, stream);
}

}  // extern "C"
