// #5 W4A8 split-K decode matmul for Hopper (sm_90a), CUDA C++ with a plain
// C interface bound from Python with ctypes (ops/_build.py,
// ops/w4_matmul.py).  Replaces lightcompress_tpu/ops/pallas_matmul.py
// w4a8_matmul_planes_ksplit (_w4a8_kernel_ksplit).
//
// Weight layout: the untiled planes of w4_matmul.cu, (N, K/8) int32 codes
// and (N, G) bf16 s and zs in natural group order.  The TPU kernel's
// `planes_ks` tiles are these words cut by word column: half h holds the
// word columns [h*kp/2, (h+1)*kp/2) of every plane, i.e. the weights
// j*K/8 + h*K/16 + p (p < K/16) and the natural groups
// j*gpp + h*gpp/2 + gi (gi < gpp/2); only the TPU scale slab is permuted
// per half, and convert.py undoes that.  Two halves (splits = 2):
//   out[m, n] = (part_0[m, n] + part_1[m, n]) * x_scale[m],
//   part_h = sum over the half's groups g of s*(x_g . u_g) - zs*sum(x_g).
//
// Design: #2's decode block (one lane one output channel, four warps over
// the half's gi range, 8 rows of x staged in shared memory) on a grid of
// (N/32 channel tiles, M/8 row chunks, 2 halves).  A block stages only its
// half of each row (K/2 bytes), so the down projection's 8 rows take 57 KB
// of shared memory instead of 114.  The halves meet in the output: each
// block atomically adds its unscaled partial into an f32 output that the
// wrapper zeroed, and the wrapper multiplies by x_scale after the launch,
// as the TPU kernel's caller does.  With two halves this is deterministic:
// 0 + a + b rounds once, to a + b, whichever half lands first.
//
// Bound on an H100 SXM: the packed weight read, bytes = N*K/2 + 4*N*G +
// M*K + 4*M*N + 4*M over 3.35 TB/s.  No tensor cores, no TMA.

#include "w4_common.cuh"

namespace {

using namespace lcw4;

constexpr int kRows = 8;  // rows of x per block

__global__ void __launch_bounds__(kDecodeThreads)
w4a8_ksplit_kernel(const int8_t* __restrict__ xq,
                   const int32_t* __restrict__ wp,
                   const __nv_bfloat16* __restrict__ s,
                   const __nv_bfloat16* __restrict__ zs,
                   float* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = K / 8, G = K / kGroup, gpp = kp / kGroup;
  const int K2 = K / 2, kp2 = kp / 2, gpp2 = gpp / 2, G2 = G / 2;
  const int h = blockIdx.z;
  int8_t* xsh = reinterpret_cast<int8_t*>(smem);           // [kRows][K2]
  float* xsum = reinterpret_cast<float*>(smem + (size_t)kRows * K2);
  float* red = xsum + kRows * G2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * kRows;
  const int n = blockIdx.x * 32 + lane;

  // this half of each row: staged byte j*kp2 + p is x[j*kp + h*kp2 + p]
  const int n16 = kRows * K2 / 16;
  for (int i = threadIdx.x; i < n16; i += blockDim.x) {
    const int m = (i * 16) / K2, k2 = (i * 16) % K2;
    const int j = k2 / kp2, p = k2 % kp2;
    int4 v = make_int4(0, 0, 0, 0);
    if (m0 + m < M)
      v = *reinterpret_cast<const int4*>(xq + (size_t)(m0 + m) * K +
                                         j * kp + h * kp2 + p);
    reinterpret_cast<int4*>(xsh)[i] = v;
  }
  __syncthreads();
  // staged group j*gpp2 + gi is natural group j*gpp + h*gpp2 + gi
  group_sums<kRows>(xsh, K2, xsum);
  __syncthreads();

  float acc[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) acc[m] = 0.f;
  const int32_t* wrow = wp + (size_t)n * kp;
  for (int gi = warp; gi < gpp2; gi += kDecodeWarps) {
    int dot[8][kRows];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int m = 0; m < kRows; ++m) dot[j][m] = 0;
    const int4* wg =
        reinterpret_cast<const int4*>(wrow + (h * gpp2 + gi) * kGroup);
#pragma unroll 2
    for (int c = 0; c < kGroup / 4; ++c) {
      const int4 w = __ldg(wg + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int packed = pack_nibbles((uint32_t)w.x, (uint32_t)w.y,
                                        (uint32_t)w.z, (uint32_t)w.w, 4 * j);
        const int koff = j * kp2 + gi * kGroup + 4 * c;
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          const int xv =
              *reinterpret_cast<const int*>(xsh + (size_t)m * K2 + koff);
          dot[j][m] = __dp4a(packed, xv, dot[j][m]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int g = j * gpp + h * gpp2 + gi;
      const float sf = __bfloat162float(s[(size_t)n * G + g]);
      const float zf = __bfloat162float(zs[(size_t)n * G + g]);
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        acc[m] += sf * (float)dot[j][m] - zf * xsum[m * G2 + j * gpp2 + gi];
    }
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m) red[(warp * kRows + m) * 32 + lane] = acc[m];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      float v = 0.f;
      for (int w = 0; w < kDecodeWarps; ++w)
        v += red[(w * kRows + m) * 32 + lane];
      if (m0 + m < M) atomicAdd(out + (size_t)(m0 + m) * N + n, v);
    }
  }
}

size_t ksplit_smem(int K) {
  const int G2 = K / kGroup / 2;
  return (size_t)kRows * (K / 2) + (size_t)kRows * G2 * 4 +
         (size_t)kDecodeWarps * kRows * 32 * 4;
}

}  // namespace

extern "C" {

// xq (M, K) int8; wp (N, K/8) int32; s, zs (N, G) bf16; out (M, N) f32,
// zeroed by the caller, gets part_0 + part_1 (not yet times x_scale).
// K % 2048 == 0 (an even number of 128-word groups per plane), N % 32 == 0.
int lc_w4a8_ksplit(const void* xq, const void* wp, const void* s,
                   const void* zs, void* out, int M, int N, int K,
                   void* stream) {
  if (K % (16 * kGroup) || N % 32 || M < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = ksplit_smem(K);
  cudaError_t e = prepare(w4a8_ksplit_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / 32, (M + kRows - 1) / kRows, 2);
  w4a8_ksplit_kernel<<<grid, kDecodeThreads, smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)xq, (const int32_t*)wp, (const __nv_bfloat16*)s,
      (const __nv_bfloat16*)zs, (float*)out, M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
