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
// Requirements checked by the Python wrappers: K % 512 == 0, N % 32 == 0,
// contiguous tensors on the current device.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 1979 TOP/s int8): at M <= 256 the
// bytes, N*K/2 + 4*N*G + M*K*b_x + M*N*b_out over 3.35 TB/s, so the packed
// weight read is the bound.  The decode blocks (#11, #12 at small M, #13)
// compute with __dp4a on the CUDA cores, a lane per channel; #12 above
// the decode regime runs the int8 tensor-core tile of w4_mma.cuh.

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
// #11 W4A8 on natural-order s4 bytes.  Replaces
// lightcompress_tpu/ops/pallas_matmul.py w4a8_matmul_s4 (_w4a8_kernel_s4)
// behind its byte-view entry point w4a8_matmul_s4_bytes.
//
// Weight layout (pack_s4_bytes, untiled): wb (N, K/2) int8, byte b holds the
// signed code c' = u - 8 of weight 2b in its low nibble and of weight 2b+1
// in its high one; s and zs' = (z - 8) * s are (N, G) in ST (f32 or bf16).
// In the TPU kernel's order:
//   a_r = sum over the groups g with g % 4 == r, in turn, of
//         f32(x_g . c'_g) * s_g   (exact int32 group dots)
//   y = ((a0 + a1) + (a2 + a3) - sum_g xsum_g * zs'_g) * x_scale
// each product and sum rounded once.  Bound: the packed weight read
// (memory).  Design: #12's decode block (a lane per channel, MT = 8 rows of
// int8 x in shared memory), with warp w taking the groups g = w, w + 4, ...
// in order, so that its accumulator is the TPU kernel's a_w; a 4-byte word
// holds codes 8q .. 8q+7, sign-extended to four even and four odd ones and
// put back in K order with two byte permutes for two __dp4a.
// ---------------------------------------------------------------------------
template <int MT, typename ST>
__global__ void __launch_bounds__(kDecodeThreads)
w4a8_s4_kernel(const int8_t* __restrict__ xq,
               const float* __restrict__ xscale,
               const int8_t* __restrict__ wb, const ST* __restrict__ s,
               const ST* __restrict__ zs, float* __restrict__ out, int M,
               int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = K / kGroup, kh = K / 2;
  int8_t* xsh = reinterpret_cast<int8_t*>(smem);
  float* xsum = reinterpret_cast<float*>(smem + (size_t)MT * K);
  float* red = xsum + MT * G;  // [warp][2][MT][32]: a_warp, corr
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * MT;
  const int n = blockIdx.x * 32 + lane;

  stage_rows<MT>(xq, M, K, m0, xsh);
  __syncthreads();
  group_sums<MT>(xsh, K, xsum);
  __syncthreads();

  float acc[MT], corr[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = corr[m] = 0.f;
  const int8_t* wrow = wb + (size_t)n * kh;
  for (int g = warp; g < G; g += kDecodeWarps) {
    int dot[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) dot[m] = 0;
    const int4* wq = reinterpret_cast<const int4*>(wrow + g * (kGroup / 2));
#pragma unroll
    for (int c = 0; c < kGroup / 32; ++c) {
      const int4 w = __ldg(wq + c);
      const uint32_t ws[4] = {(uint32_t)w.x, (uint32_t)w.y, (uint32_t)w.z,
                              (uint32_t)w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t lo = (uint32_t)sext_lo(ws[q]);
        const uint32_t hi = (uint32_t)sext_hi(ws[q]);
        const int a = (int)__byte_perm(lo, hi, 0x5140);  // codes 0 1 2 3
        const int b = (int)__byte_perm(lo, hi, 0x7362);  // codes 4 5 6 7
        const int k = g * kGroup + 32 * c + 8 * q;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int8_t* xr = xsh + (size_t)m * K + k;
          dot[m] = __dp4a(a, *reinterpret_cast<const int*>(xr), dot[m]);
          dot[m] = __dp4a(b, *reinterpret_cast<const int*>(xr + 4), dot[m]);
        }
      }
    }
    const float sf = to_f32(s[(size_t)n * G + g]);
    const float zf = to_f32(zs[(size_t)n * G + g]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      acc[m] = __fadd_rn(acc[m], __fmul_rn((float)dot[m], sf));
      corr[m] = __fadd_rn(corr[m], __fmul_rn(xsum[m * G + g], zf));
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    red[((warp * 2) * MT + m) * 32 + lane] = acc[m];
    red[((warp * 2 + 1) * MT + m) * 32 + lane] = corr[m];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float a[kDecodeWarps], c = 0.f;
#pragma unroll
      for (int w = 0; w < kDecodeWarps; ++w) {
        a[w] = red[((w * 2) * MT + m) * 32 + lane];
        c = __fadd_rn(c, red[((w * 2 + 1) * MT + m) * 32 + lane]);
      }
      const float y = __fsub_rn(
          __fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3])), c);
      if (m0 + m < M)
        out[(size_t)(m0 + m) * N + n] = __fmul_rn(y, xscale[m0 + m]);
    }
  }
}

template <typename ST>
int launch_s4(const void* xq, const void* xscale, const void* wb,
              const void* s, const void* zs, void* out, int M, int N, int K,
              void* stream) {
  const size_t smem = (size_t)8 * K + (size_t)8 * (K / kGroup) * 4 +
                      (size_t)kDecodeWarps * 2 * 8 * 32 * 4;
  cudaError_t e = prepare(w4a8_s4_kernel<8, ST>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / 32, (M + 7) / 8);
  w4a8_s4_kernel<8, ST><<<grid, kDecodeThreads, smem,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)xq, (const float*)xscale, (const int8_t*)wb,
      (const ST*)s, (const ST*)zs, (float*)out, M, N, K);
  return (int)cudaGetLastError();
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

// #11: xq (M, K) int8, xscale (M,) f32, wb (N, K/2) natural s4 bytes,
// s, zs (N, G) f32 (s_bf16 = 0) or bf16 (1) -> out (M, N) f32.
int lc_w4a8_s4(const void* xq, const void* xscale, const void* wb,
               const void* s, const void* zs, int s_bf16, void* out, int M,
               int N, int K, void* stream) {
  if (s_bf16)
    return launch_s4<__nv_bfloat16>(xq, xscale, wb, s, zs, out, M, N, K,
                                    stream);
  return launch_s4<float>(xq, xscale, wb, s, zs, out, M, N, K, stream);
}

}  // extern "C"
