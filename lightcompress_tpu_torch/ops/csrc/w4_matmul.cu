// Grouped-W4A8 matmul kernels on the planes layout for Hopper (sm_90a), CUDA
// C++ with a plain C interface bound from Python with ctypes (ops/_build.py,
// ops/w4_matmul.py): #2, #14 and #3.  (#1 and #4, the W4A16 planes kernels,
// are the bf16 tensor-core tile of w4a16_tile.cu.)
//
// Weight layout (shared by the three kernels): untiled planes.
//   wp  (N, K/8) int32: nibble j of word kw holds code u[n, j*K/8 + kw]
//   s   (N, G)   bf16 : per-group scale, G = K/128
//   zs  (N, G)   bf16 : premultiplied zero correction z*s
// The group of weight k is g = k / 128; in plane terms g = j*gpp + gi with
// gpp = K/1024 and gi = kw / 128.  Every kernel computes
//   y[m, n] = sum_g s[n,g] * (x_g . u_g) - zs[n,g] * sum(x_g)
// with the group dot finished before the scale is applied.
//
// Requirements checked by the Python wrappers: K % 1024 == 0, N % 64 == 0
// (#3: N % 128 == 0), contiguous tensors on the current
// device.  The decode block, the fused prologue (#14) and the epilogue live
// in w4_common.cuh, shared with the byte-pair kernels of w4_bytes.cu; #3's
// body is the planes tile of w4_planes_wgmma.cuh, shared with #9.
//
// Bounds on an H100 SXM (3.35 TB/s HBM, 1979 TOP/s int8 and 989 TFLOP/s
// bf16 dense tensor-core peaks):
//   decode (M <= 256): bytes / 3.35 TB/s, bytes = N*K/2 + 4*N*G + M*K*b_x
//                      + M*N*4, so the packed weight read is the bound;
//   prefill (M > 256): max(bytes / 3.35 TB/s, 2*M*N*K / 1979 TOP/s).
// The decode kernels use no tensor cores (a lane per channel, __dp4a); #3
// runs on the int8 tensor cores (wgmma, TMA-fed tiles).

#include "w4_planes_wgmma.cuh"

namespace {

using namespace lcw4;

__device__ __forceinline__ float bf16_to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------------------
// #2  W4A8 decode.  Replaces lightcompress_tpu/ops/pallas_matmul.py
// w4a8_matmul_planes (_w4a8_kernel_fullk_combined, _w4a8_kernel_fullk).
// #14 W4A8 fused decode linear (XT = bf16 or f32 x).  Replaces
// w4a8_linear_planes_fused (_w4a8_kernel_fullk_fused).
//
// Bound: the packed weight read (memory).  Design: one lane owns one output
// channel, and the block's 4 warps split the gi range of the same 32
// channels, adding their sums through shared memory at the end; each
// lane's group dot is integer-exact (__dp4a over four
// codes packed into bytes; a group sum is at most 127*15*128 = 243,840),
// then the f32 scale and zero correction, then the per-token act scale.
// #2 stages pre-quantized rows (XT = int8_t) and writes f32; #14 runs the
// prologue of w4_common.cuh (RMSNorm, act quant) on its rows first, which
// every block repeats (no block may wait on another), and writes XT.
// ---------------------------------------------------------------------------
template <int MT, typename XT>
__global__ void __launch_bounds__(kDecodeThreads)
w4a8_decode_kernel(const XT* __restrict__ x,
                   const float* __restrict__ xscale,
                   const int32_t* __restrict__ wp,
                   const __nv_bfloat16* __restrict__ s,
                   const __nv_bfloat16* __restrict__ zs,
                   void* __restrict__ out, int8_t* __restrict__ act_out,
                   float* __restrict__ scale_out, int M, int N, int K,
                   int rms, float eps) {
  constexpr bool kFused = !std::is_same<XT, int8_t>::value;
  using OutT = typename std::conditional<kFused, XT, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = K / 8, G = K / kGroup, gpp = kp / kGroup;
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
  const int32_t* wrow = wp + (size_t)n * kp;
  for (int gi = warp; gi < gpp; gi += kDecodeWarps) {
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
        const int koff = j * kp + gi * kGroup + 4 * c;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int xv = *reinterpret_cast<const int*>(xsh + (size_t)m * K + koff);
          dot[j][m] = __dp4a(packed, xv, dot[j][m]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int g = j * gpp + gi;
      const float sf = bf16_to_f32(s[(size_t)n * G + g]);
      const float zf = bf16_to_f32(zs[(size_t)n * G + g]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
        acc[m] += sf * (float)dot[j][m] - zf * xsum[m * G + g];
    }
  }
  store_rows<MT>(acc, red, kFused ? nullptr : xscale, xs_sh,
                 static_cast<OutT*>(out), M, N, m0, n);
}

// #2 (XT = int8_t, pre-quantized x and its scales) and #14 (XT = bf16 or
// f32 x, the prologue in the kernel): 8 rows of x per block.
template <typename XT>
int launch_w4a8_decode(const XT* x, const void* xscale, const void* wp,
                       const void* s, const void* zs, void* out,
                       void* act_out, void* scale_out, int M, int N, int K,
                       int rms, float eps, void* stream) {
  const size_t smem = decode_smem_i8(8, K);
  cudaError_t e = prepare(w4a8_decode_kernel<8, XT>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / 32, (M + 7) / 8);
  w4a8_decode_kernel<8, XT><<<grid, kDecodeThreads, smem,
                              reinterpret_cast<cudaStream_t>(stream)>>>(
      x, (const float*)xscale, (const int32_t*)wp, (const __nv_bfloat16*)s,
      (const __nv_bfloat16*)zs, out, (int8_t*)act_out, (float*)scale_out, M,
      N, K, rms, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lc_w4a8_decode(const void* xq, const void* xscale, const void* wp,
                   const void* s, const void* zs, void* out, int M, int N,
                   int K, void* stream) {
  return launch_w4a8_decode((const int8_t*)xq, xscale, wp, s, zs, out,
                            nullptr, nullptr, M, N, K, 0, 0.f, stream);
}

// #14: x (M, K) bf16 (x_f32 = 0) or f32 (1); out (M, N) in x's type;
// act_out (M, K) int8 and scale_out (M,) f32 may be null.
int lc_w4a8_planes_fused(const void* x, int x_f32, const void* wp,
                         const void* s, const void* zs, void* out,
                         void* act_out, void* scale_out, int M, int N, int K,
                         int rms, float eps, void* stream) {
  if (x_f32)
    return launch_w4a8_decode((const float*)x, nullptr, wp, s, zs, out,
                              act_out, scale_out, M, N, K, rms, eps, stream);
  return launch_w4a8_decode((const __nv_bfloat16*)x, nullptr, wp, s, zs, out,
                            act_out, scale_out, M, N, K, rms, eps, stream);
}

// ---------------------------------------------------------------------------
// #3  W4A8 prefill, any M.  Replaces lightcompress_tpu/ops/pallas_matmul.py
// w4a8_matmul_planes_mtiled (_w4a8_kernel_mtiled, _xsum_slab_order).
//
// The planes tile of w4_planes_wgmma.cuh with one expert and dense rows
// (no block_eid): 64 rows x 128 channels a block, wgmma m64n64k32 on planes
// unpacked four at a time from TMA-fed word blocks, the exact f32 group
// epilogue in registers, y * xscale stored in bf16 or f32 by the kernel.
// The TPU kernel unpacks a weight tile once and keeps it across a
// sequential M loop; here the grid runs the row tiles innermost, so the
// blocks in flight share a weight tile that the L2 serves.  The x tensor
// map covers the M rows: the ragged tail's rows are zeros, their stores
// masked.  Float order: w4a8_rows_tpu_order (ops/w4_matmul.py), bit for
// bit.  Bound: at M = 1024 and the Llama-3-8B shapes the 2*M*N*K int8
// operations, and the f32 epilogue of every (output, group).
// ---------------------------------------------------------------------------
// xq (M, K) int8, xscale (M,) f32; out (M, N) bf16 (out_f32 = 0) or f32;
// xsum_g null or the int16 row-sum scratch of launch_planes_wgmma.
int lc_w4a8_prefill(const void* xq, const void* xscale, const void* wp,
                    const void* s, const void* zs, void* xsum_g, void* out,
                    int out_f32, int M, int N, int K, void* stream) {
  if (out_f32)
    return launch_planes_wgmma(xq, xscale, wp, s, zs, nullptr, xsum_g,
                               (float*)out, M, N, K, 1, kTileM, stream);
  return launch_planes_wgmma(xq, xscale, wp, s, zs, nullptr, xsum_g,
                             (__nv_bfloat16*)out, M, N, K, 1, kTileM, stream);
}

}  // extern "C"
