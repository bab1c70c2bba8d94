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

// Block-wide sum and max of one value per thread, in one fixed order (warp
// butterflies, then warps 0..3 in turn), so every block that reduces the
// same inputs gets the same bits.  ``scratch`` holds 2 * kDecodeWarps
// floats; all threads return the results.
__device__ __forceinline__ void block_sum_max(float& sum, float& mx,
                                              float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch may still be read from the previous row
  if (lane == 0) {
    scratch[warp] = sum;
    scratch[kDecodeWarps + warp] = mx;
  }
  __syncthreads();
  sum = scratch[0];
  mx = scratch[kDecodeWarps];
#pragma unroll
  for (int w = 1; w < kDecodeWarps; ++w) {
    sum = __fadd_rn(sum, scratch[w]);
    mx = fmaxf(mx, scratch[kDecodeWarps + w]);
  }
}

// The fused prologue of kernels #13 and #14 (the TPU kernels run it once at
// grid step 0 into VMEM scratch; CUDA blocks cannot share it, so every block
// recomputes it for its own MT rows from x, which the L2 serves).  For each
// row m of x[m0 .. m0+MT) (B, K), in the JAX kernels' float order:
//   xf = f32(x); if rms: xf *= rsqrt(sum(xf*xf) / K + eps)  (not rounded to
//   bf16); sc = max(max|xf|, 1e-8) / 127; q = clip(rint(xf / sc), -127, 127)
// Exactly rounded throughout: IEEE division (__fdiv_rn), the correctly
// rounded reciprocal square root __frsqrt_rn (rsqrtf is approximate), no
// contracted multiply-adds, rintf (half to even).  max|xf| is taken as
// max|x| * r: rounding is monotonic, so that equals the max of the rounded
// products.  Codes go to xsh (MT, K), scales to xs_sh[MT]; rows past M get
// zero codes.  ``scratch``: 2 * kDecodeWarps floats.
template <int MT, typename T>
__device__ void quantize_rows(const T* __restrict__ x, int M, int K, int m0,
                              int rms, float eps, int8_t* xsh, float* xs_sh,
                              float* scratch) {
  for (int m = 0; m < MT; ++m) {
    int8_t* qrow = xsh + (size_t)m * K;
    if (m0 + m >= M) {
      for (int i = threadIdx.x; i < K; i += blockDim.x) qrow[i] = 0;
      if (threadIdx.x == 0) xs_sh[m] = 1.f;
      continue;
    }
    const T* row = x + (size_t)(m0 + m) * K;
    float ss = 0.f, am = 0.f;
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      const float v = to_f32(row[i]);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
      am = fmaxf(am, fabsf(v));
    }
    block_sum_max(ss, am, scratch);
    float r = 1.f;
    if (rms) {
      r = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)K), eps));
      am = __fmul_rn(am, r);
    }
    const float sc = __fdiv_rn(fmaxf(am, 1e-8f), 127.f);
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      float v = to_f32(row[i]);
      if (rms) v = __fmul_rn(v, r);
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v, sc)), -127.f), 127.f);
      qrow[i] = (int8_t)(int)q;
    }
    if (threadIdx.x == 0) xs_sh[m] = sc;
  }
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

// Shared memory of a decode block: MT int8 rows, their group sums, the
// per-warp partial outputs, the row scales and the reduction scratch.
inline size_t decode_smem_i8(int mt, int K) {
  const int G = K / kGroup;
  return (size_t)mt * K + (size_t)mt * G * 4 +
         (size_t)kDecodeWarps * mt * 32 * 4 + (size_t)mt * 4 +
         2 * kDecodeWarps * 4;
}

// The epilogue of a decode block: warp 0 adds the warps' partial sums of its
// lane's channel n and stores row m0+m scaled by the row's act scale, as f32
// (xscale from global memory: #2, #12) or in T (xs_sh: #13, #14).
template <int MT, typename OutT>
__device__ __forceinline__ void store_rows(const float (&acc)[MT], float* red,
                                           const float* __restrict__ xscale,
                                           const float* xs_sh, OutT* out,
                                           int M, int N, int m0, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < MT; ++m) red[(warp * MT + m) * 32 + lane] = acc[m];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = 0.f;
      for (int w = 0; w < kDecodeWarps; ++w) v += red[(w * MT + m) * 32 + lane];
      if (m0 + m < M) {
        const float xs = xscale != nullptr ? xscale[m0 + m] : xs_sh[m];
        store(out + (size_t)(m0 + m) * N + n, v * xs);
      }
    }
  }
}

// With ``act_out`` set, the blocks of the first channel tile also write their
// rows' act codes and scales (the card tests count code flips against the
// plain version with them).
template <int MT>
__device__ __forceinline__ void export_act(const int8_t* xsh,
                                           const float* xs_sh,
                                           int8_t* act_out, float* scale_out,
                                           int M, int K, int m0) {
  if (act_out == nullptr || blockIdx.x != 0) return;
  for (int i = threadIdx.x; i < MT * K; i += blockDim.x)
    if (m0 + i / K < M) act_out[(size_t)m0 * K + i] = xsh[i];
  if (threadIdx.x < MT && m0 + (int)threadIdx.x < M)
    scale_out[m0 + threadIdx.x] = xs_sh[threadIdx.x];
}

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace lcw4
