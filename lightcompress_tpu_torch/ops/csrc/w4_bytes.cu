// Grouped-W4 matmul kernels on the s4 group-pair byte layout for Hopper
// (sm_90a), CUDA C++ with a plain C interface bound from Python with ctypes
// (ops/_build.py, ops/w4_matmul.py).
//
// Weight layout: untiled byte pairs.
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
// Requirements checked by the Python wrappers: K % 512 == 0, N % 32 == 0,
// contiguous tensors on the current device.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 1979 TOP/s int8): at M <= 256 the
// bytes, N*K/2 + 4*N*G + M*K*b_x + M*N*b_out over 3.35 TB/s, so the packed
// weight read is the bound.  These first kernels use no tensor cores (no
// mma/wgmma, no TMA); later work makes them fast.

#include "w4_common.cuh"

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
// #12 W4A8 on byte pairs.  Replaces lightcompress_tpu/ops/pallas_matmul.py
// w4a8_matmul_bytes (_w4a8_kernel_pairs, _pairs_group_loop).
// #13 fused W4A8 decode linear (XT = bf16 or f32 x).  Replaces
// w4a8_linear_bytes_fused (_w4a8_kernel_pairs_fused).
//
// Bound: the packed weight read (memory).  The decode block of #2: one lane
// per output channel, 4 warps splitting the group pairs, MT = 8 rows of int8
// x in shared memory (natural K order, as the TPU kernel keeps it), per lane
// 16 bytes of its weight row per step through the read-only cache.  Each
// 4-byte word gives two __dp4a operands, the low nibbles against x of group
// 2p and the high ones against group 2p+1, signed by signed.  #12 stages
// pre-quantized rows and writes f32 times the act scale; #13 runs the
// prologue of w4_common.cuh first (every block repeats it for its rows) and
// writes XT.
// ---------------------------------------------------------------------------
template <int MT, typename XT>
__global__ void __launch_bounds__(kDecodeThreads)
w4a8_bytes_kernel(const XT* __restrict__ x, const float* __restrict__ xscale,
                  const int8_t* __restrict__ wb,
                  const __nv_bfloat16* __restrict__ s,
                  const __nv_bfloat16* __restrict__ zs, void* __restrict__ out,
                  int8_t* __restrict__ act_out, float* __restrict__ scale_out,
                  int M, int N, int K, int rms, float eps) {
  constexpr bool kFused = !std::is_same<XT, int8_t>::value;
  using OutT = typename std::conditional<kFused, XT, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = K / kGroup, kh = K / 2;
  int8_t* xsh = reinterpret_cast<int8_t*>(smem);
  float* xsum = reinterpret_cast<float*>(smem + (size_t)MT * K);
  float* red = xsum + MT * G;
  float* xs_sh = red + kDecodeWarps * MT * 32;
  float* scratch = xs_sh + MT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * MT;
  const int n = blockIdx.x * 32 + lane;

  if constexpr (kFused)
    quantize_rows<MT>(x, M, K, m0, rms, eps, xsh, xs_sh, scratch);
  else
    stage_rows<MT>(x, M, K, m0, xsh);
  __syncthreads();
  group_sums<MT>(xsh, K, xsum);
  if constexpr (kFused) export_act<MT>(xsh, xs_sh, act_out, scale_out, M, K, m0);
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
  store_rows<MT>(acc, red, kFused ? nullptr : xscale, xs_sh,
                 static_cast<OutT*>(out), M, N, m0, n);
}

template <typename XT>
int launch_bytes(const XT* x, const void* xscale, const void* wb,
                 const void* s, const void* zs, void* out, void* act_out,
                 void* scale_out, int M, int N, int K, int rms, float eps,
                 void* stream) {
  const size_t smem = decode_smem_i8(8, K);
  cudaError_t e = prepare(w4a8_bytes_kernel<8, XT>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / 32, (M + 7) / 8);
  w4a8_bytes_kernel<8, XT><<<grid, kDecodeThreads, smem,
                             reinterpret_cast<cudaStream_t>(stream)>>>(
      x, (const float*)xscale, (const int8_t*)wb, (const __nv_bfloat16*)s,
      (const __nv_bfloat16*)zs, out, (int8_t*)act_out, (float*)scale_out, M,
      N, K, rms, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// #12: xq (M, K) int8, xscale (M,) f32 -> out (M, N) f32.
int lc_w4a8_bytes(const void* xq, const void* xscale, const void* wb,
                  const void* s, const void* zs, void* out, int M, int N,
                  int K, void* stream) {
  return launch_bytes((const int8_t*)xq, xscale, wb, s, zs, out, nullptr,
                      nullptr, M, N, K, 0, 0.f, stream);
}

// #13: x (M, K) bf16 (x_f32 = 0) or f32 (1); out (M, N) in x's type;
// act_out (M, K) int8 and scale_out (M,) f32 may be null.
int lc_w4a8_bytes_fused(const void* x, int x_f32, const void* wb,
                        const void* s, const void* zs, void* out,
                        void* act_out, void* scale_out, int M, int N, int K,
                        int rms, float eps, void* stream) {
  if (x_f32)
    return launch_bytes((const float*)x, nullptr, wb, s, zs, out, act_out,
                        scale_out, M, N, K, rms, eps, stream);
  return launch_bytes((const __nv_bfloat16*)x, nullptr, wb, s, zs, out,
                      act_out, scale_out, M, N, K, rms, eps, stream);
}

}  // extern "C"
