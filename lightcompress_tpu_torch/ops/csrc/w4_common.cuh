// Pieces shared by the grouped-W4 kernels of w4_matmul.cu, w4_bytes.cu,
// w4_moe.cu, w4_ksplit.cu and layer_fused.cu: the block shape, the nibble
// gather, bf16/f32 loads and stores, and the fused prologue (RMSNorm and
// per-token int8 act quant done inside the kernel).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace lcw4 {

constexpr int kGroup = 128;
constexpr int kDecodeWarps = 4;
constexpr int kDecodeThreads = kDecodeWarps * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to(bf16)
}

// Bytes j of the result are nibble `sh/4` of words a, b, c, d: four
// consecutive codes of one group, ready for __dp4a.
__device__ __forceinline__ int pack_nibbles(uint32_t a, uint32_t b,
                                            uint32_t c, uint32_t d, int sh) {
  return (int)(((a >> sh) & 0xFu) | (((b >> sh) & 0xFu) << 8) |
               (((c >> sh) & 0xFu) << 16) | (((d >> sh) & 0xFu) << 24));
}

// ---- the fused prologue of #13 and #14 ----
// The TPU kernels run it once, at grid step 0, into VMEM scratch; CUDA
// blocks cannot share it, so every block runs it for its own rows, from x,
// which the L2 serves.  Per row, in the JAX kernels' float order: xf =
// f32(x), times r = rsqrt(sum(xf * xf) / K + eps) with rms (__frsqrt_rn,
// correctly rounded; xf * r is not rounded to bf16); sc = max(max|xf|,
// 1e-8) / 127; codes clip(rint(xf / sc), -127, 127) with IEEE division and
// no contracted multiply-adds.  max|xf| is taken as max|x| * r: rounding is
// monotonic, so that equals the max of the rounded products.
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// Value k of x from the registers of one 16-byte (bf16) or two (f32) loads.
template <typename XT>
__device__ __forceinline__ float x_value(const uint32_t* w, int k) {
  if constexpr (sizeof(XT) == 2)
    return k & 1 ? bf_hi(w[k >> 1]) : bf_lo(w[k >> 1]);
  else
    return __uint_as_float(w[k]);
}

// |t - rint(t)| above this, t = v * (1/sc) may round otherwise than v / sc
// (|t - v/sc| < 2^-15 for |v/sc| <= 127.01)
constexpr float kTieGuard = 0.5f - 1.f / 16384.f;

// The statistics and scales of rows m0 .. m0 + mv of x (B, K) for a block
// of kWarps = 8 warps: wpr warps a row (8 for one row, 4 for two, 2 for
// three or four, else 1), the lanes along 16-byte vectors with eight loads
// in flight; a vector's squares summed as a tree, then into one of eight
// sums by its round, combined as a tree, the lanes by a butterfly, the
// row's warps in order: short sequential sums (the scale stays within a
// few ulps of the plain version's), one order for every block.  Leaves
// row r's r, sc and 1/sc at row_sh[r], row_sh[MT + r], row_sh[2 MT + r]
// (st_sh: [MT][kWarps][2] floats of scratch) and, with scale_out, sc at
// scale_out[m0 + r]; ends with a barrier.
template <typename XT, int MT, int kWarps>
__device__ void fused_row_scales(const XT* __restrict__ x, int K, int m0,
                                 int mv, int rms, float eps, float* st_sh,
                                 float* row_sh, float* scale_out) {
  static_assert(kWarps == 8, "warps a row for 8 warps");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kPer = 16 / (int)sizeof(XT);  // values a vector
  const int n_vec = K / kPer;
  const int wpr = mv == 1 ? 8 : mv == 2 ? 4 : mv <= 4 ? 2 : 1;
  {
    const int wr = warp % wpr, stride = 32 * wpr;
    for (int r = warp / wpr; r < mv; r += kWarps / wpr) {
      const uint4* row =
          reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K);
      float part[8], am = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) part[u] = 0.f;
      for (int i0 = 32 * wr + lane; i0 < n_vec; i0 += 8 * stride) {
        uint4 q[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (i0 + u * stride < n_vec) q[u] = __ldg(row + i0 + u * stride);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (i0 + u * stride >= n_vec) continue;
          const uint32_t w[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
          float sq[kPer];
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const float v = x_value<XT>(w, k);
            sq[k] = __fmul_rn(v, v);
            am = fmaxf(am, fabsf(v));
          }
#pragma unroll
          for (int o = 1; o < kPer; o <<= 1)
#pragma unroll
            for (int k = 0; k < kPer; k += 2 * o)
              sq[k] = __fadd_rn(sq[k], sq[k + o]);
          part[u] = __fadd_rn(part[u], sq[0]);
        }
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
#pragma unroll
        for (int u = 0; u < 8; u += 2 * o)
          part[u] = __fadd_rn(part[u], part[u + o]);
      float ss = part[0];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
        am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
      }
      if (lane == 0) {
        st_sh[2 * (r * kWarps + wr)] = ss;
        st_sh[2 * (r * kWarps + wr) + 1] = am;
      }
    }
  }
  __syncthreads();  // every warp's partial statistics
  if ((int)threadIdx.x < mv) {
    const int r = threadIdx.x;
    float ss = st_sh[2 * r * kWarps], am = st_sh[2 * r * kWarps + 1];
    for (int k = 1; k < wpr; ++k) {
      ss = __fadd_rn(ss, st_sh[2 * (r * kWarps + k)]);
      am = fmaxf(am, st_sh[2 * (r * kWarps + k) + 1]);
    }
    float rr = 1.f;
    if (rms) {
      rr = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)K), eps));
      am = __fmul_rn(am, rr);
    }
    const float sc = __fdiv_rn(fmaxf(am, 1e-8f), 127.f);
    row_sh[r] = rr;
    row_sh[MT + r] = sc;
    row_sh[2 * MT + r] = __frcp_rn(sc);
    if (scale_out != nullptr) scale_out[m0 + r] = sc;
  }
  __syncthreads();  // the rows' r, sc, 1/sc
}

// The codes of eight values of x (x_value k of w, times rr with rms) at a
// row's scale sc (inv = 1/sc), as int8 lanes: lo (values 0-3) and hi (4-7);
// returns their sum.  rint(t) of t = v * inv and its integer come from the
// bits of t + 1.5 * 2^23 (|t| < 2^22: its ulp is 1, so the add rounds t to
// nearest even); if one of the eight lies within 2^-14 of a tie, all eight
// take rint(v / sc) by IEEE division.
template <typename XT>
__device__ __forceinline__ int quantize8(const uint32_t* w, int rms,
                                         float rr, float sc, float inv,
                                         uint32_t& lo, uint32_t& hi) {
  float v[8];
  int c[8];
  bool tie = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = x_value<XT>(w, k);
    if (rms) v[k] = __fmul_rn(v[k], rr);
    const float tq = __fmul_rn(v[k], inv);
    const float y = __fadd_rn(tq, 12582912.f);
    c[k] = __float_as_int(y) - 0x4B400000;
    tie |= fabsf(__fsub_rn(tq, __fsub_rn(y, 12582912.f))) > kTieGuard;
  }
  if (tie)
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = (int)rintf(__fdiv_rn(v[k], sc));
  lo = __byte_perm(__byte_perm(c[0], c[1], 0x40),
                   __byte_perm(c[2], c[3], 0x40), 0x5410);
  hi = __byte_perm(__byte_perm(c[4], c[5], 0x40),
                   __byte_perm(c[6], c[7], 0x40), 0x5410);
  return ((c[0] + c[1]) + (c[2] + c[3])) + ((c[4] + c[5]) + (c[6] + c[7]));
}

// Copies MT rows of pre-quantized int8 x into shared memory (zeros past M).
template <int MT>
__device__ __forceinline__ void stage_rows(const int8_t* __restrict__ xq,
                                           int M, int K, int m0, int8_t* xsh) {
  const int n16 = MT * K / 16;
  for (int i = threadIdx.x; i < n16; i += blockDim.x) {
    const int m = (i * 16) / K, k = (i * 16) % K;
    int4 v = make_int4(0, 0, 0, 0);
    if (m0 + m < M)
      v = *reinterpret_cast<const int4*>(xq + (size_t)(m0 + m) * K + k);
    reinterpret_cast<int4*>(xsh)[i] = v;
  }
}

// Per-group sums of the staged int8 rows in natural K order: xsum[m*G + g].
template <int MT>
__device__ __forceinline__ void group_sums(const int8_t* xsh, int K,
                                           float* xsum) {
  const int G = K / kGroup;
  for (int i = threadIdx.x; i < MT * G; i += blockDim.x) {
    const int* p = reinterpret_cast<const int*>(
        xsh + (size_t)(i / G) * K + (i % G) * kGroup);
    int a = 0;
    for (int q = 0; q < kGroup / 4; ++q) a = __dp4a(p[q], 0x01010101, a);
    xsum[i] = (float)a;
  }
}

// Shared memory of #12's decode block: MT int8 rows, their group sums and
// the per-warp partial outputs.
inline size_t decode_smem_i8(int mt, int K) {
  const int G = K / kGroup;
  return (size_t)mt * K + (size_t)mt * G * 4 +
         (size_t)kDecodeWarps * mt * 32 * 4;
}

// The epilogue of #12's decode block: warp 0 adds the warps' partial sums of
// its lane's channel n and stores row m0+m times the row's act scale, f32.
template <int MT>
__device__ __forceinline__ void store_rows(const float (&acc)[MT], float* red,
                                           const float* __restrict__ xscale,
                                           float* out, int M, int N, int m0,
                                           int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < MT; ++m) red[(warp * MT + m) * 32 + lane] = acc[m];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = 0.f;
      for (int w = 0; w < kDecodeWarps; ++w) v += red[(w * MT + m) * 32 + lane];
      if (m0 + m < M) out[(size_t)(m0 + m) * N + n] = v * xscale[m0 + m];
    }
  }
}

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace lcw4
