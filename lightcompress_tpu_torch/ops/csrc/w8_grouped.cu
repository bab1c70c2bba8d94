// #10  Capacity-grouped W8A8 matmul for Hopper (sm_90a), CUDA C++ with a
// plain C interface bound from Python with ctypes (ops/_build.py,
// ops/moe_matmul.py).  Replaces lightcompress_tpu/ops/pallas_matmul.py
// w8a8_grouped_matmul (_w8a8_kernel_grouped): the grouped MoE route's
// int8 per-channel expert projection (a down projection whose input width
// does not fit the W4 planes layout, e.g. Qwen3-30B-A3B's 768).
//
//   xq        (Mp, K)   int8 rows sorted by expert into m_tile segments
//   xscale    (Mp,)     f32 per-row act scale
//   codes     (E, N, K) int8 symmetric per-channel expert weights
//   scales    (E, N)    f32 per-channel scales
//   block_eid (Mp / m_tile,) int32 expert of each segment
//   out       (Mp, N)   f32: (f32(x . w_e) * scale_e[n]) * xscale[m]
//
// The dot is exact (int32 accumulation on the tensor cores); the epilogue
// is the JAX kernel's two f32 products in its order, each rounded on its own
// (__fmul_rn), so the output equals the plain PyTorch version bit for bit.
//
// Design.  One block per (128-channel tile, 64-row tile): blockIdx.x walks
// the channel tiles fastest, so the tiles of one M block, which share its
// 64 rows of x, run together, and consecutive M blocks of one expert find
// its weight in the 50 MB L2.  m_tile % 64 == 0, so a block's rows belong
// to one expert, whose id the block reads itself (no scalar prefetch); an
// id out of range fills the tile with NaN.  Eight warps of 32x32 outputs
// run mma.sync m16n8k32 s8 x s8 -> s32 over 64-byte K steps staged through
// shared memory (rows padded to 80 bytes: the fragment reads hit 32
// distinct banks); the next step's global loads are issued before the
// current step's products.  The ragged channel edge (N % 128) and the K
// tail (K % 64, with K % 16 == 0) are zero-filled on load and masked on
// store.  Padding rows are zeros: their outputs are 0, computed like any
// other.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 1979 TOP/s int8 dense peak): at a
// prefill's shapes the bytes (each live expert's N*K codes, x, and the
// Mp*N f32 outputs) outweigh the 2*Mp*N*K operations.  This first kernel
// uses mma.sync without TMA or wgmma.

#include "w4_mma.cuh"

namespace {

using lcw4::mma_s8;

constexpr int kBM = 64;               // rows of a block tile
constexpr int kBN = 128;              // channels of a block tile
constexpr int kBK = 64;               // bytes of K per shared-memory step
constexpr int kThreads = 256;         // 8 warps: 2 (rows) x 4 (channels)
constexpr int kStride = kBK + 16;     // bytes per padded shared row

__device__ __forceinline__ int lds32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

__global__ void __launch_bounds__(kThreads)
w8a8_grouped_kernel(const int8_t* __restrict__ xq,
                    const float* __restrict__ xscale,
                    const int8_t* __restrict__ codes,
                    const float* __restrict__ scales,
                    const int32_t* __restrict__ block_eid,
                    float* __restrict__ out, int N, int K, int E,
                    int m_tile) {
  __shared__ __align__(16) int8_t xt[kBM * kStride];
  __shared__ __align__(16) int8_t wt[kBN * kStride];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;       // mma fragment coordinates
  const int wm = warp >> 2, wn = warp & 3;     // the warp's 32x32 outputs
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int e = block_eid[m0 / m_tile];
  if (e < 0 || e >= E) {
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int n = n0 + i % kBN;
      if (n < N)
        out[(size_t)(m0 + i / kBN) * N + n] = __int_as_float(0x7fc00000);
    }
    return;  // uniform over the block
  }
  const int8_t* w_e = codes + (size_t)e * N * K;

  // staging: thread tid moves 16 bytes of row lr of x and of rows lr and
  // lr + 64 of the weight tile, at byte lc of the K step
  const int lr = tid >> 2, lc = (tid & 3) * 16;
  const int8_t* xsrc = xq + (size_t)(m0 + lr) * K + lc;
  int4 xv, wv[2];
  auto load = [&](int k0) {
    const bool kin = k0 + lc < K;  // K % 16 == 0: a chunk is in or out
    const int4 zero = make_int4(0, 0, 0, 0);
    xv = kin ? *reinterpret_cast<const int4*>(xsrc + k0) : zero;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + lr + 64 * h;
      wv[h] = (kin && n < N)
                  ? __ldg(reinterpret_cast<const int4*>(
                        w_e + (size_t)n * K + k0 + lc))
                  : zero;
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous step's tiles
    *reinterpret_cast<int4*>(xt + lr * kStride + lc) = xv;
    *reinterpret_cast<int4*>(wt + lr * kStride + lc) = wv[0];
    *reinterpret_cast<int4*>(wt + (lr + 64) * kStride + lc) = wv[1];
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      // A (16x32, row-major): rows g and g + 8, bytes 4t and 16 + 4t;
      // B (32x8, the weight's rows are its columns): channel g, bytes 4t
      // and 16 + 4t
      int a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = xt + (wm * 32 + i * 16 + g) * kStride + kk + 4 * t;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * kStride);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * kStride + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = wt + (wn * 32 + j * 8 + g) * kStride + kk + 4 * t;
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }

  // C (16x8): elements 0, 1 at row g, channels 2t and 2t + 1; 2, 3 at row
  // g + 8
  const float* s_e = scales + (size_t)e * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
      const float xs = xscale[m];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + wn * 32 + j * 8 + 2 * t + q;
          if (n < N)
            out[(size_t)m * N + n] = __fmul_rn(
                __fmul_rn(__int2float_rn(acc[i][j][2 * h + q]), s_e[n]), xs);
        }
    }
}

}  // namespace

extern "C" {

// #10: xq (Mp, K) int8, xscale (Mp,) f32, codes (E, N, K) int8, scales
// (E, N) f32, block_eid (Mp / m_tile,) int32; out (Mp, N) f32;
// K % 16 == 0, m_tile % 64 == 0, Mp % m_tile == 0.
int lc_w8a8_grouped(const void* xq, const void* xscale, const void* codes,
                    const void* scales, const void* block_eid, void* out,
                    int Mp, int N, int K, int E, int m_tile, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, Mp / kBM);
  w8a8_grouped_kernel<<<grid, kThreads, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)xq, (const float*)xscale, (const int8_t*)codes,
      (const float*)scales, (const int32_t*)block_eid, (float*)out, N, K, E,
      m_tile);
  return (int)cudaGetLastError();
}

}  // extern "C"
