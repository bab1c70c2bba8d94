// The W4A8 planes tile on the int8 tensor cores (wgmma), one kernel body
// shared by #3 (w4_matmul.cu: dense rows, any M, bf16 or f32 out), #9
// (w4_moe.cu: expert-sorted rows, one expert a 64-row tile, f32 out) and,
// from STACKED_TILE_MIN_B rows on, #6 (w4_moe.cu: every expert on B rows,
// f32 out).  Replaces, as their body, the TPU kernels lightcompress_tpu/ops/
// pallas_matmul.py _w4a8_kernel_mtiled (w4a8_matmul_planes_mtiled),
// _w4a8_kernel_grouped (w4a8_grouped_matmul) and _w4a8_kernel_stacked
// (w4a8_stacked_matmul), which the JAX package itself calls one math: the
// grouped kernel is "the _w4a8_kernel_mtiled math with an expert-indexed
// weight tile", the stacked one the same sums for every expert.
//
// Three row mappings, chosen at compile time (kRows):
//   kRowsDense: out[r] = x[r] . W[e]^T, e = block_eid[r / m_tile] (#9) or 0
//     (#3, block_eid null); block x takes rows 64 x .. 64 x + 63;
//   kRowsStacked, kRowsPair (#6, M = B): block x takes row tile t = x % T
//     (T = ceil(B / 64)) of expert e = x / T; its x rows start at 64 t
//     (stacked: every expert reads the same (B, K) x, whose tensor map
//     spans B rows) or e * B + 64 t (pair: (E, B, K) x, a map of E * B
//     rows), its outputs are rows e * B + 64 t + r of the (E, B, N) output,
//     stores and xscale reads masked to 64 t + r < B.  In pair mode a
//     tile's rows past B belong to the next expert: they are computed and
//     never stored (row sums are per row).
// Weight: E experts of untiled planes stacked as (E * N, K/8) int32
// words (nibble j of word kw of row n holds code u of weight j*K/8 + kw),
// s and zs (E, N, G) bf16; x (M, K) int8 in natural K order with an f32
// scale per row.  A block takes 64 rows x 128 channels on the tiles of
// w4_mma.cuh: with #9 m_tile % 64 == 0, so its rows lie in one expert's
// segment, whose id the block reads itself (an id out of range fills the
// tile with NaN).  The x tensor map covers M rows: TMA fills the rows past
// M with zeros, and the stores and xscale reads are masked to m < M.  Any
// K % 1024 == 0: up to ROWSUM_SMEM_K_MAX (ops/w4_matmul.py, 49152) the row
// sums stay in shared memory beside the stages; above it (kBigK) they go to
// a global int16 scratch (xsum_g, [gridDim.x][G][64], from the wrapper), and
// the zero corrections are staged kZsGi word blocks at a time.
//
// Stages.  Word block gi (words gi*128 .. +128 of each channel, all eight
// planes of groups j*gpp + gi) is copied once into shared memory (64 KB:
// four 128-byte-swizzled TMA boxes of [128 channels][32 words]); stage
// (gi, b), b = 0..3, multiplies planes j = 2b and 2b + 1.  Stages b = 0
// and 2 first unpack four planes, bytes b and b + 1 of every word (a byte
// gather of four words, then the low and the high nibbles: unpack4), into
// four int8 tiles; after the second unpack the word block is free and the
// next one is copied under two stages of products.  The x tiles of a
// stage's two groups ([64 rows][128 bytes] TMA boxes) are copied two
// stages ahead.  Thread 0 issues the copies and they complete on
// mbarriers.  Codes 0..15 are valid s8 operands.  Two warpgroups take 64
// channels each: per plane four m64n64k32 wgmma read the x tile and the
// plane tile straight from shared memory, and the second plane's products
// run under the first plane's f32 epilogue.
//
// Float order, bit for bit that of w4a8_rows_tpu_order (ops/w4_matmul.py):
// for gi, for plane j, acc[j % 4] += f32(dot) * s[g], then y = ((a0 + a1) +
// (a2 + a3) - corr) * xscale with corr = the sum of xsum[g] * zs[g] in the
// same (gi, j) order, every op rounded on its own; a bf16 output is y
// rounded to nearest even.  Each accumulator sees its own sequence; corr is
// summed after the stages from the row sums each stage leaves in shared
// or global memory (int16: |xsum| <= 128 * 127), so a thread holds four
// accumulators per output and the two planes' group dots (32 outputs: 192
// registers; about 220 in all, one block an SM) during the stages.  Bound:
// the int8 operations of the rows and the f32 epilogue of every (output,
// group); with 64 x 128 tiles (the accumulators fill the register file)
// also the L2 traffic of x and the word blocks.
#pragma once

#include "w4_mma.cuh"

namespace lcw4 {

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

constexpr int kPlanesThreads = 256;   // two warpgroups of 64 x 64 outputs
constexpr size_t kWordBlock = (size_t)kTileN * kWordRow;
constexpr int kXStages = 3;           // x tiles in flight
// (after 1024 bytes of alignment slack) four unpacked planes, the x tiles
// (kXStages stages x 2 groups), the word block, the stage's scales, the
// mbarriers (kXStages x tiles, the word block); then, unless they go to
// global memory, the row sums, 128 bytes a group
constexpr size_t kPlanesFixedSmem = 1024 + 4 * kTileW + 2 * kXStages * kTileX +
                                    kWordBlock + 2 * kTileN * 4 + 64;
// word blocks of zero corrections ([8 planes][128 channels] bf16 each) that
// fit in the plane and x tiles once the stages are done
constexpr int kZsGi = (4 * kTileW + 2 * kXStages * kTileX) / (8 * kTileN * 2);

// 16-byte chunk c of channel n's word block: TMA box c / 8, swizzled
__device__ __forceinline__ int word_swz(int n, int c) {
  return (c >> 3) * kTileW + swz(n, c & 7);
}

enum { kRowsDense = 0, kRowsStacked = 1, kRowsPair = 2 };

template <typename OutT, bool kBigK, int kRows = kRowsDense>
__global__ void __launch_bounds__(kPlanesThreads, 1)
w4a8_planes_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const float* __restrict__ xscale,
                         const __grid_constant__ CUtensorMap wmap,
                         const __nv_bfloat16* __restrict__ s,
                         const __nv_bfloat16* __restrict__ zs,
                         const int32_t* __restrict__ block_eid,
                         int16_t* __restrict__ xsum_g,
                         OutT* __restrict__ out, int M, int N, int K, int E,
                         int m_tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the wgmma tiles need 1024-byte aligned bases
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* bsh = reinterpret_cast<int8_t*>(smem);    // [4][128][128]
  int8_t* xbuf = bsh + 4 * kTileW;                   // [kXStages][2][64][128]
  int8_t* wbuf = xbuf + 2 * kXStages * kTileX;       // [4][128][128]
  float* s_sh = reinterpret_cast<float*>(wbuf + kWordBlock);  // [2][128]
  uint64_t* xbar = reinterpret_cast<uint64_t*>(s_sh + 2 * kTileN);
  uint64_t* wbar = xbar + kXStages;
  const int kp = K / 8, G = K / kGroup, gpp = kp / kGroup;
  // the row sums, [G][64]: in shared memory, or (kBigK) the block's rows
  // of xsum_g
  int16_t* xsum_sh = kBigK ? xsum_g + (size_t)blockIdx.x * G * kTileM
                           : reinterpret_cast<int16_t*>(xbar + 8);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  // a thread's outputs d[4j + e]: row rw + 8 (e >> 1), channel
  // cw + 8j + (e & 1)
  const int rw = 16 * (warp & 3) + (lane >> 2), cw = 64 * wg + 2 * (lane & 3);
  const int n0 = blockIdx.y * kTileN;
  // m0: the x map's first row of the tile (dense: also the output's);
  // stacked: o0 the output's first row, t0 = 64 t the tile's first row of B
  int m0, e;
  [[maybe_unused]] int o0, t0;
  if constexpr (kRows == kRowsDense) {
    m0 = blockIdx.x * kTileM;
    e = block_eid != nullptr ? block_eid[m0 / m_tile] : 0;
    if (e < 0 || e >= E) {
      for (int i = tid; i < kTileM * kTileN; i += kPlanesThreads)
        if (m0 + i / kTileN < M)
          store(out + (size_t)(m0 + i / kTileN) * N + n0 + i % kTileN,
                quiet_nan());
      return;  // uniform over the block
    }
  } else {
    const int T = (M + kTileM - 1) / kTileM;
    e = blockIdx.x / T;
    t0 = (blockIdx.x % T) * kTileM;
    o0 = e * M + t0;
    m0 = (kRows == kRowsPair ? e * M : 0) + t0;
  }
  const __nv_bfloat16* s_e = s + ((size_t)e * N + n0) * G;
  const __nv_bfloat16* zs_e = zs + ((size_t)e * N + n0) * G;
  // copies, issued by thread 0: word block gi (four boxes of 32 words),
  // the x tiles of stage st (planes 2b, 2b + 1 of gi)
  auto load_words = [&](int gi) {
    mbar_expect_tx(wbar, kWordBlock);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tma_load_2d(wbuf + q * kTileW, &wmap, gi * kGroup + 32 * q, e * N + n0,
                  wbar);
  };
  auto load_x = [&](int st) {
    const int gi = st >> 2, b = st & 3, slot = st % kXStages;
    mbar_expect_tx(xbar + slot, 2 * kTileX);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tma_load_2d(xbuf + (2 * slot + h) * kTileX, &xmap,
                  (2 * b + h) * kp + gi * kGroup, m0, xbar + slot);
  };

  float acc0[32], acc1[32], acc2[32], acc3[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = acc2[i] = acc3[i] = 0.f;
  // the sums of stage st's x rows, kept for the zero correction
  auto row_sums = [&](const int8_t* xt, int st) {
    constexpr int kParts = kPlanesThreads / kTileN;  // threads a row sum
    const int gi = st >> 2, b = st & 3, h = tid / (kPlanesThreads / 2);
    const int sum = stage_row_sum<kPlanesThreads>(xt, xt + kTileX);
    if (tid % kParts == 0)
      xsum_sh[((2 * b + h) * gpp + gi) * kTileM + (tid / kParts) % kTileM] =
          (int16_t)sum;
  };

  // planes 2b and 2b + 1 of stage st into accumulators (2b) % 4 and
  // (2b + 1) % 4: both planes' products are issued, the row sums taken
  // under them, then each plane's epilogue runs once its products landed
  auto pair = [&](const int8_t* xt, const int8_t* bt, int st,
                  float (&a0)[32], float (&a1)[32]) {
    int d0[32], d1[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d0[i] = d1[i] = 0;
    wgmma_fence();
    group_wgmma(d0, xt, bt, wg);
    wgmma_commit();
    group_wgmma(d1, xt + kTileX, bt + kTileW, wg);
    wgmma_commit();
    row_sums(xt, st);
    wgmma_wait<1>();
    wgmma_hold(d0);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      a0[i] = mac_rn(a0[i], exact_f32(d0[i]),
                     s_sh[cw + 8 * (i >> 2) + (i & 1)]);
    wgmma_wait<0>();
    wgmma_hold(d1);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      a1[i] = mac_rn(a1[i], exact_f32(d1[i]),
                     s_sh[kTileN + cw + 8 * (i >> 2) + (i & 1)]);
  };

  // the stage's scales, read one stage ahead (thread t: channel t % 128 of
  // plane 2b + t / 128); no global load waits inside a stage
  auto fetch_s = [&](int st) {
    const int gi = st >> 2, b = st & 3;
    return __bfloat162float(
        s_e[(size_t)(tid % kTileN) * G + (2 * b + tid / kTileN) * gpp + gi]);
  };
  static_assert(kPlanesThreads == 2 * kTileN, "a scale a thread");

  const int S = 4 * gpp;
  if (tid == 0) {
    for (int i = 0; i < kXStages + 1; ++i) mbar_init(xbar + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    load_words(0);
    load_x(0);
    if (1 < S) load_x(1);
  }
  float s_next = fetch_s(0);
  for (int st = 0; st < S; ++st) {
    const int gi = st >> 2, b = st & 3;
    mbar_wait(xbar + st % kXStages, (st / kXStages) & 1);
    if (b == 0) mbar_wait(wbar, gi & 1);
    __syncthreads();  // every warp is done with stage st - 1
    if (tid == 0 && st + 2 < S) load_x(st + 2);
    s_sh[tid] = s_next;
    if (st + 1 < S) s_next = fetch_s(st + 1);
    if (!(b & 1)) {
      // unpack planes 2b .. 2b + 3: thread unit (channel n, 16 words c16)
#pragma unroll
      for (int r = 0; r < kTileN * 8 / kPlanesThreads; ++r) {
        const int u = tid + r * kPlanesThreads, n = u & (kTileN - 1);
        const int c16 = u >> 7;
        int pl[4][4];  // [plane 2b + i][word quad]
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int p4[4];
          unpack4(*reinterpret_cast<const int4*>(wbuf +
                                                 word_swz(n, 4 * c16 + q)),
                  b, p4);
#pragma unroll
          for (int i = 0; i < 4; ++i) pl[i][q] = p4[i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<int4*>(bsh + i * kTileW + swz(n, c16)) =
              make_int4(pl[i][0], pl[i][1], pl[i][2], pl[i][3]);
      }
    }
    fence_proxy_async();  // the planes written above, for wgmma
    __syncthreads();
    if (tid == 0 && b == 2 && gi + 1 < gpp) load_words(gi + 1);  // unpacked
    const int8_t* xt = xbuf + (st % kXStages) * 2 * kTileX;
    const int8_t* bt = bsh + (b & 1) * 2 * kTileW;
    if (b & 1)
      pair(xt, bt, st, acc2, acc3);
    else
      pair(xt, bt, st, acc0, acc1);
  }

  if constexpr (kBigK) {
    // y = (a0 + a1) + (a2 + a3) into acc0; corr into acc1, in (gi, j)
    // order, the zero corrections staged in the plane and x tiles (112 KB,
    // free now) kZsGi word blocks gi at a time: row jp * gin + gi - gi0
    // holds group jp * gpp + gi of the 128 channels, one value a thread,
    // the threads along a channel's run of gin groups
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc0[i] = __fadd_rn(__fadd_rn(acc0[i], acc1[i]),
                          __fadd_rn(acc2[i], acc3[i]));
      acc1[i] = 0.f;
    }
    __nv_bfloat16* zs_sh = reinterpret_cast<__nv_bfloat16*>(bsh);
    for (int gi0 = 0; gi0 < gpp; gi0 += kZsGi) {
      const int gin = min(kZsGi, gpp - gi0), per = 8 * gin;
      __syncthreads();  // the tiles (then the previous chunk) are free
      for (int i = tid; i < kTileN * per; i += kPlanesThreads) {
        const int n = i / per, r = i % per;
        zs_sh[r * kTileN + n] =
            zs_e[(size_t)n * G + (r / gin) * gpp + gi0 + r % gin];
      }
      __syncthreads();
      for (int gi = gi0; gi < gi0 + gin; ++gi)
        for (int jp = 0; jp < 8; ++jp) {
          const int g = jp * gpp + gi, zr = jp * gin + gi - gi0;
          float zv[16], xv[2];
#pragma unroll
          for (int c = 0; c < 16; ++c)
            zv[c] = __bfloat162float(
                zs_sh[zr * kTileN + cw + 8 * (c >> 1) + (c & 1)]);
          xv[0] = (float)xsum_sh[g * kTileM + rw];
          xv[1] = (float)xsum_sh[g * kTileM + rw + 8];
#pragma unroll
          for (int i = 0; i < 32; ++i)
            acc1[i] =
                fmaf(xv[(i >> 1) & 1], zv[2 * (i >> 2) + (i & 1)], acc1[i]);
        }
    }
  } else {
    // the block's zero corrections, [G][128] bf16, into the plane and x
    // tiles (112 KB, free now: every warp is past its last products); a
    // channel's G values are G / 8 16-byte chunks, read eight a thread at
    // once and stored transposed
    __syncthreads();
    __nv_bfloat16* zs_sh = reinterpret_cast<__nv_bfloat16*>(bsh);
    const int n_chunks = kTileN * G / 8;
    for (int i0 = 0; i0 < n_chunks; i0 += 8 * kPlanesThreads) {
      int4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kPlanesThreads + tid;
        if (i < n_chunks)
          v[u] = *reinterpret_cast<const int4*>(
              zs_e + (size_t)(i % kTileN) * G + 8 * (i / kTileN));
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kPlanesThreads + tid;
        if (i >= n_chunks) continue;
        const __nv_bfloat16* z =
            reinterpret_cast<const __nv_bfloat16*>(&v[u]);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          zs_sh[(8 * (i / kTileN) + k) * kTileN + i % kTileN] = z[k];
      }
    }
    __syncthreads();

    // y = (a0 + a1) + (a2 + a3) into acc0; corr into acc1, in (gi, j) order
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc0[i] = __fadd_rn(__fadd_rn(acc0[i], acc1[i]),
                          __fadd_rn(acc2[i], acc3[i]));
      acc1[i] = 0.f;
    }
    for (int gi = 0; gi < gpp; ++gi)
      for (int jp = 0; jp < 8; ++jp) {
        const int g = jp * gpp + gi;
        float zv[16], xv[2];
#pragma unroll
        for (int c = 0; c < 16; ++c)
          zv[c] = __bfloat162float(
              zs_sh[g * kTileN + cw + 8 * (c >> 1) + (c & 1)]);
        xv[0] = (float)xsum_sh[g * kTileM + rw];
        xv[1] = (float)xsum_sh[g * kTileM + rw + 8];
#pragma unroll
        // xsum * zs is exact (at most 14 + 8 significant bits): the fused
        // multiply-add rounds once, as the product and the sum do
        for (int i = 0; i < 32; ++i)
          acc1[i] =
              fmaf(xv[(i >> 1) & 1], zv[2 * (i >> 2) + (i & 1)], acc1[i]);
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int m, o;  // the row of x (and xscale), of out
    if constexpr (kRows == kRowsDense) {
      m = o = m0 + rw + 8 * h;
      if (m >= M) continue;
    } else {
      if (t0 + rw + 8 * h >= M) continue;
      m = m0 + rw + 8 * h;
      o = o0 + rw + 8 * h;
    }
    const float xs = xscale[m];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * h;
      store2(out + (size_t)o * N + n0 + cw + 8 * j,
             __fmul_rn(__fsub_rn(acc0[i], acc1[i]), xs),
             __fmul_rn(__fsub_rn(acc0[i + 1], acc1[i + 1]), xs));
    }
  }
}

// Launches the planes tile over x int8 and the stacked weight of E experts.
// kRowsDense: x (M, K), block_eid null for one expert and dense rows, with
// block_eid m_tile % 64 == 0.  kRowsStacked / kRowsPair (#6): M = B, x
// (B, K) or (E, B, K), out (E, B, N); block_eid and m_tile unused.
// K % 1024 == 0, N % 128 == 0.  xsum_g: null (the row sums in shared
// memory, K <= 49152) or an int16 scratch of 64 * K / 128 values for each
// block of the grid's first dimension.  Returns 0 or an error code (shared
// memory that does not fit is refused, never worked around).
template <typename OutT, int kRows = kRowsDense>
int launch_planes_wgmma(const void* x, const void* xscale, const void* wp,
                        const void* s, const void* zs, const void* block_eid,
                        void* xsum_g, OutT* out, int M, int N, int K, int E,
                        int m_tile, void* stream) {
  CUtensorMap xmap, wmap;
  const int x_rows = kRows == kRowsPair ? E * M : M;
  int rc = tensor_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, K, x_rows,
                         K, kTileRow, kTileM);
  if (rc == 0)  // wp as (E * N, K / 8) int32 words
    rc = tensor_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_INT32, wp, K / 8,
                       (uint64_t)E * N, (uint64_t)K / 2, 32, kTileN);
  if (rc != 0) return rc;
  const int tiles = (M + kTileM - 1) / kTileM;
  // rows innermost (stacked: an expert's row tiles, then the next expert)
  const dim3 grid(kRows == kRowsDense ? tiles : E * tiles, N / kTileN);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (xsum_g != nullptr) {
    e = prepare(w4a8_planes_wgmma_kernel<OutT, true, kRows>,
                kPlanesFixedSmem);
    if (e != cudaSuccess) return (int)e;
    w4a8_planes_wgmma_kernel<OutT, true, kRows>
        <<<grid, kPlanesThreads, kPlanesFixedSmem, st>>>(
            xmap, (const float*)xscale, wmap, (const __nv_bfloat16*)s,
            (const __nv_bfloat16*)zs, (const int32_t*)block_eid,
            (int16_t*)xsum_g, out, M, N, K, E, m_tile);
  } else {
    const size_t smem = kPlanesFixedSmem + (size_t)(K / kGroup) * kTileM * 2;
    e = prepare(w4a8_planes_wgmma_kernel<OutT, false, kRows>, smem);
    if (e != cudaSuccess) return (int)e;
    w4a8_planes_wgmma_kernel<OutT, false, kRows>
        <<<grid, kPlanesThreads, smem, st>>>(
            xmap, (const float*)xscale, wmap, (const __nv_bfloat16*)s,
            (const __nv_bfloat16*)zs, (const int32_t*)block_eid, nullptr,
            out, M, N, K, E, m_tile);
  }
  return (int)cudaGetLastError();
}

}  // namespace lcw4
