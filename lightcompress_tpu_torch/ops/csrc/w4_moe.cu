// Stacked-expert W4A8 matmul kernels of the MoE serving path for Hopper
// (sm_90a), CUDA C++ with a plain C interface bound from Python with ctypes
// (ops/_build.py, ops/moe_matmul.py).
//
// Weight layout: E experts of untiled planes, stacked.
//   wp  (E, N, K/8) int32: nibble j of word kw of row n holds code u of
//                          weight k = j*K/8 + kw (pack_int4_planes)
//   s   (E, N, G)   bf16 : per-group scale, G = K/128
//   zs  (E, N, G)   bf16 : premultiplied zero correction z*s
// Activations are int8 in natural K order with an f32 scale per row.
//
// Every output is computed in the float order of the TPU kernels
// (_w4a8_kernel_stacked / _gathered / _grouped in
// lightcompress_tpu/ops/pallas_matmul.py): with gpp = K/1024, for gi in
// 0..gpp-1 and then plane j in 0..7 (group g = j*gpp + gi), the exact
// integer group dot d times s[g] is added to accumulator j % 4; the zero
// correction corr = sum of xsum[g]*zs[g] runs over the same (gi, j) order;
// y = ((a0 + a1) + (a2 + a3) - corr) * xscale.  Every product and sum is
// rounded on its own (__fmul_rn/__fadd_rn: no contracted multiply-adds), so
// the plain PyTorch versions, which run the same sequence of f32 ops, agree
// bit for bit.
//
// Requirements checked by the Python wrappers: K % 1024 == 0,
// N % 128 == 0, contiguous 16-byte aligned tensors on the current device.
//
// #7 (the small-M stacked kernel) takes #6's inputs and keeps the TPU
// small-M kernel's order instead: per group-block gi one f32 dot of x (int8,
// exact as bf16) with the bf16-rounded weights u*s, added to one
// accumulator; the zero correction and xscale after the loop.  Its dots sum
// in a thread's own order, so it matches its plain version to f32
// rounding, not bit for bit.
//
// Bounds on an H100 SXM (3.35 TB/s HBM, 1979 TOP/s int8 dense peak):
//   #6, #7 stacked (B <= 256): the packed weight of all E experts read
//      once, bytes = E*(N*K/2 + 4*N*G) + x + out;
//   #8 gathered: the packed weights of the distinct experts selected;
//   #9 grouped: at a prefill's Mp rows the 2*rows*N*K int8 operations.
// #6 below STACKED_TILE_MIN_B rows (ops/moe_matmul.py), #7 and #8 use no
// tensor cores (__dp4a on the CUDA cores); #9, and #6 from
// STACKED_TILE_MIN_B rows on, run on the int8 tensor cores (wgmma) over
// TMA-fed stages, in the planes tile they share with #3
// (w4_planes_wgmma.cuh).

#include "w4_planes_wgmma.cuh"

namespace {

using namespace lcw4;

constexpr int kMoeThreads = 128;  // one output channel per thread
constexpr int kStackedRows = 8;   // rows of x per #6 block

// ((a0 + a1) + (a2 + a3) - corr) * xs, each op rounded.
__device__ __forceinline__ float finish(float a0, float a1, float a2,
                                        float a3, float corr, float xs) {
  return __fmul_rn(__fsub_rn(__fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3)),
                             corr),
                   xs);
}

// ---------------------------------------------------------------------------
// The decode block of #6 and #8: rows [0, nv) of x (row r at xrow0 + r*K,
// its act scale at xs0[r]) against one expert's weight; output row r at
// out0 + r*N.  Thread t owns channel n = blockIdx.x*128 + t and walks the
// whole of K in the TPU order, so each output's sums run in one thread.
// Per gi the block stages the MT rows' eight 128-byte groups of that gi (one
// per plane; MT KB of shared memory) and their sums, then every thread reads
// its own 512 bytes of codes (16 B a load) and finishes the eight group dots
// with __dp4a.  Design against the bound (the weight read): 128 channels a
// block, so a 14336-channel expert spreads over 112 blocks, and each lane's
// 16-byte loads walk its row; x is re-read from L2 by every block.
// ---------------------------------------------------------------------------
template <int MT>
__device__ __forceinline__ void expert_rows(
    const int8_t* __restrict__ xrow0, const float* __restrict__ xs0,
    const int32_t* __restrict__ wp_e, const __nv_bfloat16* __restrict__ s_e,
    const __nv_bfloat16* __restrict__ zs_e, float* __restrict__ out0, int nv,
    int N, int K) {
  __shared__ __align__(16) int8_t xc[MT * 8 * kGroup];
  __shared__ float xsc[MT * 8];
  const int tid = threadIdx.x;
  const int kp = K / 8, G = K / kGroup, gpp = kp / kGroup;
  const int n = blockIdx.x * kMoeThreads + tid;

  float acc[4][MT], corr[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    corr[m] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[p][m] = 0.f;
  }
  const int32_t* wrow = wp_e + (size_t)n * kp;
  for (int gi = 0; gi < gpp; ++gi) {
    __syncthreads();  // every thread is done with the previous chunk
    // xc[m][j][0..128) = x row m, plane j, group gi (natural K offset
    // j*kp + gi*128); 16 bytes a thread a step; absent rows are zeros
    for (int i = tid; i < MT * 64; i += kMoeThreads) {
      const int m = i >> 6, j = (i >> 3) & 7, q = i & 7;
      int4 v = make_int4(0, 0, 0, 0);
      if (m < nv)
        v = *reinterpret_cast<const int4*>(xrow0 + (size_t)m * K + j * kp +
                                           gi * kGroup + q * 16);
      reinterpret_cast<int4*>(xc)[i] = v;
    }
    __syncthreads();
    if (tid < MT * 8) {
      const int* p = reinterpret_cast<const int*>(xc + tid * kGroup);
      int a = 0;
      for (int q = 0; q < kGroup / 4; ++q) a = __dp4a(p[q], 0x01010101, a);
      xsc[tid] = (float)a;
    }
    __syncthreads();

    int dot[8][MT];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m) dot[j][m] = 0;
    const int4* wg = reinterpret_cast<const int4*>(wrow + gi * kGroup);
#pragma unroll 2
    for (int c = 0; c < kGroup / 4; ++c) {
      const int4 w = __ldg(wg + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int packed = pack_nibbles((uint32_t)w.x, (uint32_t)w.y,
                                        (uint32_t)w.z, (uint32_t)w.w, 4 * j);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int xv =
              *reinterpret_cast<const int*>(xc + (m * 8 + j) * kGroup + 4 * c);
          dot[j][m] = __dp4a(packed, xv, dot[j][m]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int g = j * gpp + gi;
      const float sf = __bfloat162float(s_e[(size_t)n * G + g]);
      const float zf = __bfloat162float(zs_e[(size_t)n * G + g]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[j & 3][m] = mac_rn(acc[j & 3][m], (float)dot[j][m], sf);
        corr[m] = mac_rn(corr[m], xsc[m * 8 + j], zf);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
    if (m < nv)
      out0[(size_t)m * N + n] =
          finish(acc[0][m], acc[1][m], acc[2][m], acc[3][m], corr[m], xs0[m]);
}

// ---------------------------------------------------------------------------
// #6  Stacked-expert W4A8 matmul.  Replaces lightcompress_tpu/ops/
// pallas_matmul.py w4a8_stacked_matmul (_w4a8_kernel_stacked).
//
// out[e, b, :] = x_e[b] . W[e]^T for every expert e, B <= 256 rows.  With
// pair = 0 every expert reads the same x (B, K) (gate/up); with pair = 1
// expert e reads its own rows x[e] (E, B, K) (the down projection).  Two
// bodies, chosen by B alone (stacked_body in ops/moe_matmul.py):
//   * the decode block below (the wrapper sends B < STACKED_TILE_MIN_B
//     here): grid (N/128, ceil(B/8), E), the TPU grid's expert and N-tile
//     axes plus 8-row chunks of B, a lane per channel on __dp4a.  Bound:
//     every expert's packed weight, read once;
//   * the planes tile (lc_w4a8_stacked_tile): a block takes 64 rows of one
//     expert (the kRowsStacked / kRowsPair mappings of
//     w4_planes_wgmma.cuh), 128 channels, on wgmma; one launch, x never
//     copied per expert.  Bound: the int8 operations of E * B rows (a
//     tile pads B to a multiple of 64) beside the weight read.
// Both equal w4a8_stacked_matmul_plain bit for bit.
// ---------------------------------------------------------------------------
template <int MT>
__global__ void __launch_bounds__(kMoeThreads)
w4a8_stacked_kernel(const int8_t* __restrict__ x,
                    const float* __restrict__ xscale,
                    const int32_t* __restrict__ wp,
                    const __nv_bfloat16* __restrict__ s,
                    const __nv_bfloat16* __restrict__ zs,
                    float* __restrict__ out, int pair, int B, int N, int K) {
  const int e = blockIdx.z, m0 = blockIdx.y * MT;
  const size_t G = K / kGroup, kp = K / 8;
  const size_t xrow = pair ? (size_t)e * B + m0 : (size_t)m0;
  expert_rows<MT>(x + xrow * K, xscale + xrow, wp + (size_t)e * N * kp,
                  s + (size_t)e * N * G, zs + (size_t)e * N * G,
                  out + ((size_t)e * B + m0) * N, min(MT, B - m0), N, K);
}

// ---------------------------------------------------------------------------
// #7  Small-M stacked-expert W4A8 matmul.  Replaces lightcompress_tpu/ops/
// pallas_matmul.py w4a8_stacked_matmul_smallm (_w4a8_kernel_stacked_bf16).
//
// #6's grid, rows and pair mode (8-row chunks of B, 128 channels, one
// expert a block; thread t owns channel n).  Per gi the block stages the
// MT rows' eight 128-value groups of that gi (plane j, natural K offset
// j*K/8 + gi*128) as f32 in shared memory (MT*4 KB), then every thread
// walks its 128 words of codes: nibble j of word c is weight u of group
// j*gpp + gi, turned into bf16(u * s_j) (the product of two bf16 values is
// exact in f32; __float2bfloat16_rn rounds it as the TPU's bf16 multiply
// does) and multiplied by each row's x in f32 (exact products).  The dot of
// the gi is added to the row's accumulator; the zero correction sums
// xsum*zs in (gi, j) order; y = (acc - corr) * xscale.  Design against
// the bound (every expert's packed weight read once, as #6): the same
// weight walk as #6, with the scale fold and the bf16 rounding in place of
// __dp4a; the x reads are shared-memory broadcasts.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int MT>
__global__ void __launch_bounds__(kMoeThreads)
w4a8_stacked_smallm_kernel(const int8_t* __restrict__ x,
                           const float* __restrict__ xscale,
                           const int32_t* __restrict__ wp,
                           const __nv_bfloat16* __restrict__ s,
                           const __nv_bfloat16* __restrict__ zs,
                           float* __restrict__ out, int pair, int B, int N,
                           int K) {
  __shared__ __align__(16) float xf[MT * 8 * kGroup];
  __shared__ float xsc[MT * 8];
  const int e = blockIdx.z, m0 = blockIdx.y * MT, tid = threadIdx.x;
  const int kp = K / 8, G = K / kGroup, gpp = kp / kGroup;
  const int n = blockIdx.x * kMoeThreads + tid;
  const int nv = min(MT, B - m0);
  const size_t xrow = pair ? (size_t)e * B + m0 : (size_t)m0;
  const int8_t* x0 = x + xrow * K;
  const size_t row = (size_t)e * N + n;
  const int32_t* wrow = wp + row * kp;
  const __nv_bfloat16* s_n = s + row * G;
  const __nv_bfloat16* zs_n = zs + row * G;

  float acc[MT], corr[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = corr[m] = 0.f;
  for (int gi = 0; gi < gpp; ++gi) {
    __syncthreads();  // every thread is done with the previous chunk
    // xf[m][j][c] = x row m at natural K offset j*kp + gi*128 + c; four
    // values a step; absent rows are zeros
    for (int i = tid; i < MT * 8 * kGroup / 4; i += kMoeThreads) {
      const int m = i / (8 * kGroup / 4), j = (i / (kGroup / 4)) & 7,
                q = i % (kGroup / 4);
      int v = 0;
      if (m < nv)
        v = *reinterpret_cast<const int*>(x0 + (size_t)m * K + j * kp +
                                          gi * kGroup + 4 * q);
      reinterpret_cast<float4*>(xf)[i] =
          make_float4((float)(int8_t)v, (float)(int8_t)(v >> 8),
                      (float)(int8_t)(v >> 16), (float)(int8_t)(v >> 24));
    }
    __syncthreads();
    if (tid < MT * 8) {
      float a = 0.f;  // integer sums below 2^24: exact in any order
      for (int c = 0; c < kGroup; ++c) a += xf[tid * kGroup + c];
      xsc[tid] = a;
    }
    __syncthreads();

    float sj[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) sj[j] = __bfloat162float(s_n[j * gpp + gi]);
    float part[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) part[m] = 0.f;
    const int4* wg = reinterpret_cast<const int4*>(wrow + gi * kGroup);
#pragma unroll 2
    for (int c = 0; c < kGroup / 4; ++c) {
      const int4 w4 = __ldg(wg + c);
      const uint32_t ws[4] = {(uint32_t)w4.x, (uint32_t)w4.y, (uint32_t)w4.z,
                              (uint32_t)w4.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[q] = bf16_round(__fmul_rn((float)((ws[q] >> (4 * j)) & 0xFu),
                                       sj[j]));
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float4 xv =
              reinterpret_cast<const float4*>(xf + (m * 8 + j) * kGroup)[c];
          // x * w is exact in f32: each add rounds once
          part[m] = __fadd_rn(part[m], __fmul_rn(xv.x, wv[0]));
          part[m] = __fadd_rn(part[m], __fmul_rn(xv.y, wv[1]));
          part[m] = __fadd_rn(part[m], __fmul_rn(xv.z, wv[2]));
          part[m] = __fadd_rn(part[m], __fmul_rn(xv.w, wv[3]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float zf = __bfloat162float(zs_n[j * gpp + gi]);
#pragma unroll
      for (int m = 0; m < MT; ++m) corr[m] = mac_rn(corr[m], xsc[m * 8 + j], zf);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = __fadd_rn(acc[m], part[m]);
  }
  const float* xs0 = xscale + xrow;
  float* out0 = out + ((size_t)e * B + m0) * N + n;
#pragma unroll
  for (int m = 0; m < MT; ++m)
    if (m < nv)
      out0[(size_t)m * N] = __fmul_rn(__fsub_rn(acc[m], corr[m]), xs0[m]);
}

// ---------------------------------------------------------------------------
// #8  Expert-gathered W4A8 matmul.  Replaces lightcompress_tpu/ops/
// pallas_matmul.py w4a8_gathered_matmul (_w4a8_kernel_gathered).
//
// out[s] = x[t_idx[s]] . W[e_idx[s]]^T.  The TPU prefetches the index
// vectors as scalars for its BlockSpec maps and replicates the token row to
// 8 sublanes; here a block (one selection, 128 channels) loads its own
// e_idx[s] and t_idx[s] and stages that one row.  Only the selected experts'
// weights are read; selections that share an expert re-read its weight (no
// dedup, as on the TPU), which the 50 MB L2 serves when they run close
// together.  Bound: the bytes of the distinct experts selected.  An index
// out of range fills the row with NaN.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kMoeThreads)
w4a8_gathered_kernel(const int8_t* __restrict__ x,
                     const float* __restrict__ xscale,
                     const int32_t* __restrict__ wp,
                     const __nv_bfloat16* __restrict__ s,
                     const __nv_bfloat16* __restrict__ zs,
                     const int32_t* __restrict__ e_idx,
                     const int32_t* __restrict__ t_idx,
                     float* __restrict__ out, int n_rows, int E, int N,
                     int K) {
  const int sel = blockIdx.y;
  const int e = e_idx[sel], t = t_idx[sel];
  if (e < 0 || e >= E || t < 0 || t >= n_rows) {
    out[(size_t)sel * N + blockIdx.x * kMoeThreads + threadIdx.x] =
        quiet_nan();
    return;  // uniform over the block
  }
  const size_t G = K / kGroup, kp = K / 8;
  expert_rows<1>(x + (size_t)t * K, xscale + t, wp + (size_t)e * N * kp,
                 s + (size_t)e * N * G, zs + (size_t)e * N * G,
                 out + (size_t)sel * N, 1, N, K);
}

}  // namespace

extern "C" {

// #6: x (B, K) int8 (pair = 0) or (E, B, K) (pair = 1), xscale (B,) or
// (E, B) f32; out (E, B, N) f32.
int lc_w4a8_stacked(const void* x, const void* xscale, const void* wp,
                    const void* s, const void* zs, void* out, int pair, int B,
                    int N, int K, int E, void* stream) {
  const dim3 grid(N / kMoeThreads, (B + kStackedRows - 1) / kStackedRows, E);
  w4a8_stacked_kernel<kStackedRows>
      <<<grid, kMoeThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          (const int8_t*)x, (const float*)xscale, (const int32_t*)wp,
          (const __nv_bfloat16*)s, (const __nv_bfloat16*)zs, (float*)out,
          pair, B, N, K);
  return (int)cudaGetLastError();
}

// #6 on the planes tile: #6's arguments, and xsum_g null or the int16
// row-sum scratch of launch_planes_wgmma (K > 49152: 64 * K / 128 values
// for each of E * ceil(B / 64) row tiles).
int lc_w4a8_stacked_tile(const void* x, const void* xscale, const void* wp,
                         const void* s, const void* zs, void* xsum_g,
                         void* out, int pair, int B, int N, int K, int E,
                         void* stream) {
  if (pair)
    return launch_planes_wgmma<float, kRowsPair>(
        x, xscale, wp, s, zs, nullptr, xsum_g, (float*)out, B, N, K, E, 0,
        stream);
  return launch_planes_wgmma<float, kRowsStacked>(
      x, xscale, wp, s, zs, nullptr, xsum_g, (float*)out, B, N, K, E, 0,
      stream);
}

// #7: #6's arguments.
int lc_w4a8_stacked_smallm(const void* x, const void* xscale, const void* wp,
                           const void* s, const void* zs, void* out, int pair,
                           int B, int N, int K, int E, void* stream) {
  const dim3 grid(N / kMoeThreads, (B + kStackedRows - 1) / kStackedRows, E);
  w4a8_stacked_smallm_kernel<kStackedRows>
      <<<grid, kMoeThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          (const int8_t*)x, (const float*)xscale, (const int32_t*)wp,
          (const __nv_bfloat16*)s, (const __nv_bfloat16*)zs, (float*)out,
          pair, B, N, K);
  return (int)cudaGetLastError();
}

// #8: x (n_rows, K) int8, xscale (n_rows,) f32, e_idx/t_idx (n_sel,) int32;
// out (n_sel, N) f32.
int lc_w4a8_gathered(const void* x, const void* xscale, const void* wp,
                     const void* s, const void* zs, const void* e_idx,
                     const void* t_idx, void* out, int n_rows, int n_sel,
                     int N, int K, int E, void* stream) {
  const dim3 grid(N / kMoeThreads, n_sel);
  w4a8_gathered_kernel<<<grid, kMoeThreads, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)x, (const float*)xscale, (const int32_t*)wp,
      (const __nv_bfloat16*)s, (const __nv_bfloat16*)zs,
      (const int32_t*)e_idx, (const int32_t*)t_idx, (float*)out, n_rows, E,
      N, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// #9  Capacity-grouped W4A8 matmul.  Replaces lightcompress_tpu/ops/
// pallas_matmul.py w4a8_grouped_matmul (_w4a8_kernel_grouped,
// _xsum_slab_order).
//
// out[r] = x[r] . W[block_eid[r / m_tile]]^T over expert-sorted rows padded
// to m_tile segments (moe_group_selections), on the planes tile of
// w4_planes_wgmma.cuh (wgmma on TMA-fed tiles, shared with #3): a block's
// 64 rows lie in one expert's segment, whose id it reads itself (an id out
// of range fills the tile with NaN).  Padding rows are the zero dummy row
// with scale 1: they are computed like any other (they give 0) and the
// caller drops them on the unsort.  The TPU kernel permutes its row sums to
// the scale slab's order with a one-hot matmul (a Mosaic workaround); here
// x stays in natural order.  Bound: the int8 operations of the Mp rows and
// the f32 epilogue of every (output, group).
// ---------------------------------------------------------------------------
// x (Mp, K) int8, xscale (Mp,) f32, block_eid (Mp / m_tile,) int32;
// out (Mp, N) f32; m_tile % 64 == 0, Mp % m_tile == 0, K % 1024 == 0,
// N % 128 == 0; xsum_g null or the int16 row-sum scratch of
// launch_planes_wgmma (K > 49152).
int lc_w4a8_grouped(const void* x, const void* xscale, const void* wp,
                    const void* s, const void* zs, const void* block_eid,
                    void* xsum_g, void* out, int Mp, int N, int K, int E,
                    int m_tile, void* stream) {
  return launch_planes_wgmma(x, xscale, wp, s, zs, block_eid, xsum_g,
                             (float*)out, Mp, N, K, E, m_tile, stream);
}

}  // extern "C"
