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
//   part_h = ((a0 + a1) + (a2 + a3)) - corr over the half's groups,
// in the TPU kernel's order: for gi, then plane j, the exact integer group
// dot times s into accumulator j % 4, and corr = the sum of xsum * zs in
// the same order, every op rounded on its own.
//
// Bound on an H100 SXM: the packed weight read, bytes = N*K/2 + 4*N*G +
// M*K + 4*M*N + 4*M over 3.35 TB/s (29.4 MB at the down projection: 8.8 us
// at B 32).  The design, the decode tile of w4_mma.cuh:
//   * A warp owns an n8 tile of channels and walks its whole half, so each
//     output's float sequence runs in one thread, the TPU's.  A block of 8
//     warps takes 64 channels, one half and up to 32 rows: two m16 tiles of
//     mma.sync m16n8k32 s8 x s8 -> s32, so at B <= 32 every weight byte is
//     read exactly once (more rows: a grid dimension of 32-row chunks).
//     N 4096 gives 64 x 2 = 128 blocks, one an SM.
//   * The B fragments are unpacked in registers from the planes words:
//     lane (g, t) reads 16 bytes at word 4t and at 16 + 4t of a k step of
//     channel g and unpacks them into the eight planes' fragments
//     (planes_b_frags).  The words reach shared memory by cp.async in
//     coalesced 16-byte chunks, a block's 32 KB word block of gi two gi
//     ahead (three slots): 64 KB of weight in flight an SM, no registers
//     held for it.
//   * x: the half's eight 128-column groups of gi, for the block's rows,
//     staged by cp.async one gi ahead in the 128-byte swizzle (zeros past
//     M), read as A fragments with ldmatrix; the rows' group sums are taken
//     from the staged tile.  A thread's s and zs of a gi (two channels,
//     eight planes) are loaded into registers right after the previous
//     gi's epilogue, under the next gi's products.
//   * The halves meet in a cluster of the two CTAs of a channel tile: the
//     second hands its parts to the first through distributed shared
//     memory, which stores ((0 + part_0) + part_1) * x_scale.  The same
//     sum in the same order every run, and no zero fill or scale pass
//     around the kernel.

#include <cooperative_groups.h>

#include "w4_mma.cuh"

namespace {

namespace cg = cooperative_groups;

using namespace lcw4;

constexpr int kKsWarps = 8;                     // n8 tiles a block
constexpr int kKsThreads = kKsWarps * 32;
constexpr int kKsChan = kKsWarps * 8;           // channels a block
constexpr int kKsRows = 32;                     // rows a block: 2 m16 tiles
constexpr int kKsPlane = kKsRows * kTileRow;    // one plane's x tile
constexpr int kKsStage = 8 * kKsPlane;          // the eight planes of a gi
constexpr int kKsWords = kKsChan * kWordRow;    // a word block, 32 KB
constexpr int kKsWStages = 3;                   // word blocks in flight

// ((a0 + a1) + (a2 + a3)) - corr, each op rounded.
__device__ __forceinline__ float part_of(float a0, float a1, float a2,
                                         float a3, float corr) {
  return __fsub_rn(__fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3)), corr);
}

// a cluster: the two halves of one channel tile and row chunk
__global__ void __cluster_dims__(1, 2, 1) __launch_bounds__(kKsThreads, 1)
w4a8_ksplit_kernel(const int8_t* __restrict__ xq,
                   const float* __restrict__ xscale,
                   const int32_t* __restrict__ wp,
                   const __nv_bfloat16* __restrict__ s,
                   const __nv_bfloat16* __restrict__ zs,
                   float* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled tiles need 128-byte aligned bases
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int kp = K / 8, G = K / kGroup, gpp = kp / kGroup;
  const int kp2 = kp / 2, gpp2 = gpp / 2;
  int8_t* wbuf = reinterpret_cast<int8_t*>(smem);      // [3][64][512]
  int8_t* xbuf = wbuf + kKsWStages * kKsWords;          // [2][8][32][128]
  float* xsum_sh = reinterpret_cast<float*>(xbuf + 2 * kKsStage);
                                                        // [gpp2*8][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kKsChan, h = blockIdx.y;
  const int m0 = blockIdx.z * kKsRows, nv = min(kKsRows, M - m0);
  const bool two = nv > 16;  // the second m16 tile holds rows

  // copies, each its own cp.async group (an empty one past the half)
  // word block gi of the block's channels in this half into slot gi % 3:
  // row c (512 bytes), 16-byte chunk q at q ^ 4 (c & 1), so that the
  // lanes' reads below hit distinct banks
  auto stage_w = [&](int gi) {
    if (gi < gpp2) {
      int8_t* dst = wbuf + (gi % kKsWStages) * kKsWords;
      for (int i = tid; i < kKsChan * 32; i += kKsThreads) {
        const int c = i >> 5, q = i & 31;
        cp_async16(dst + c * kWordRow + ((q ^ ((c & 1) << 2)) << 4),
                   wp + (size_t)(n0 + c) * kp + h * kp2 + gi * kGroup + 4 * q,
                   true);
      }
    }
    cp_async_commit();
  };
  // the x of gi: plane j's columns j*kp + h*kp2 + gi*128 + [0, 128) of the
  // block's rows into slot gi & 1, plane tile j, row r at swz(r, c)
  auto stage_x = [&](int gi) {
    if (gi < gpp2) {
      int8_t* dst = xbuf + (gi & 1) * kKsStage;
      for (int i = tid; i < 8 * kKsRows * 8; i += kKsThreads) {
        const int j = i >> 8, r = (i >> 3) & (kKsRows - 1), c = i & 7;
        const bool ok = r < nv;
        const int8_t* src = ok ? xq + (size_t)(m0 + r) * K + j * kp +
                                     h * kp2 + gi * kGroup + 16 * c
                               : xq;
        cp_async16(dst + j * kKsPlane + swz(r, c), src, ok);
      }
    }
    cp_async_commit();
  };
  // the scales of group block gi for the thread's channels 2t, 2t + 1,
  // eight planes: loaded right after the previous gi's epilogue used them
  const int c0 = 8 * warp + 2 * t;
  __nv_bfloat16 sv[8][2], zv[8][2];
  auto load_s = [&](int gi) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const size_t o = (size_t)(n0 + c0 + e) * G + j * gpp + h * gpp2 + gi;
        sv[j][e] = s[o];
        zv[j][e] = zs[o];
      }
  };

  // order of the groups: X0, W0, W1, then per gi X(gi + 1), W(gi + 2); at
  // gi every group but the newest, W(gi + 1), has landed
  stage_x(0);
  stage_w(0);
  stage_w(1);
  load_s(0);

  // a thread's outputs, m16 tile i, element e: row 16i + g + 8 (e >> 1),
  // channel 8 warp + 2t + (e & 1)
  float acc[4][2][4], corr[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      corr[i][e] = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][i][e] = 0.f;
    }

  for (int gi = 0; gi < gpp2; ++gi) {
    cp_async_wait<1>();
    __syncthreads();  // x and words of gi landed; every warp is past gi - 1
    stage_x(gi + 1);  // into the slot of gi - 1
    stage_w(gi + 2);  // into the slot of gi - 1
    const int8_t* xs = xbuf + (gi & 1) * kKsStage;
    {
      // the group sums of the stage: thread (plane j, row r)
      const int j = tid >> 5, r = tid & 31;
      int a = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int4 v =
            *reinterpret_cast<const int4*>(xs + j * kKsPlane + swz(r, c));
        a = __dp4a(v.x, 0x01010101, a);
        a = __dp4a(v.y, 0x01010101, a);
        a = __dp4a(v.z, 0x01010101, a);
        a = __dp4a(v.w, 0x01010101, a);
      }
      xsum_sh[(gi * 8 + j) * kKsRows + r] = (float)a;
    }
    static_assert(kKsThreads == 8 * kKsRows, "a group sum a thread");

    // the lane's row of the word block: channel 8 warp + g
    const int8_t* wrow =
        wbuf + (gi % kKsWStages) * kKsWords + (8 * warp + g) * kWordRow;
    const int sw = (g & 1) << 2;
    int d[8][2][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][i][e] = 0;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int q = decode_b_word(kk, lane) / 4;  // chunk of b0; b1 at q + 4
      int b[8][2];
      planes_b_frags(
          *reinterpret_cast<const int4*>(wrow + ((q ^ sw) << 4)),
          *reinterpret_cast<const int4*>(wrow + (((q + 4) ^ sw) << 4)), b);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int a[4];
        decode_a_frag(a, xs + j * kKsPlane, 0, kk);
        mma_s8(d[j][0], a, b[j]);
        if (two) {
          decode_a_frag(a, xs + j * kKsPlane, 1, kk);
          mma_s8(d[j][1], a, b[j]);
        }
      }
    }
    __syncthreads();  // the stage's group sums, for every thread

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float sq[2] = {__bfloat162float(sv[j][0]),
                           __bfloat162float(sv[j][1])};
      const float zq[2] = {__bfloat162float(zv[j][0]),
                           __bfloat162float(zv[j][1])};
      const float* xsum_q = xsum_sh + (gi * 8 + j) * kKsRows + g;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 1 && !two) break;  // no rows there
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j & 3][i][e] =
              mac_rn(acc[j & 3][i][e], exact_f32(d[j][i][e]), sq[e & 1]);
          // xsum * zs is exact (at most 14 + 8 significant bits): the fused
          // multiply-add rounds once, as the product and the sum do
          corr[i][e] =
              fmaf(xsum_q[16 * i + 8 * (e >> 1)], zq[e & 1], corr[i][e]);
        }
      }
    }
    if (gi + 1 < gpp2) load_s(gi + 1);
  }

  // the halves meet in the cluster: CTA h = 1 hands its parts to CTA
  // h = 0 through distributed shared memory (the x slots, free now), which
  // stores ((0 + part_0) + part_1) * x_scale
  float part[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[i][e] = part_of(acc[0][i][e], acc[1][i][e], acc[2][i][e],
                           acc[3][i][e], corr[i][e]);
  cg::cluster_group cluster = cg::this_cluster();
  float* ex = reinterpret_cast<float*>(xbuf) + tid * 8;
  __syncthreads();  // every warp is done with the x slots
  if (h == 1)
#pragma unroll
    for (int k = 0; k < 8; ++k) ex[k] = part[k >> 2][k & 3];
  cluster.sync();
  if (h == 0) {
    const float* other = cluster.map_shared_rank(ex, 1);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * i + g + 8 * (e >> 1);
        if (r < nv)
          out[(size_t)(m0 + r) * N + n0 + c0 + (e & 1)] = __fmul_rn(
              __fadd_rn(__fadd_rn(0.f, part[i][e]), other[i * 4 + e]),
              xscale[m0 + r]);
      }
  }
  cluster.sync();  // CTA 1's shared memory lives until CTA 0 has read it
}

size_t ksplit_smem(int K) {
  const int gpp2 = K / kGroup / 16;
  return 128 + (size_t)kKsWStages * kKsWords + 2 * (size_t)kKsStage +
         (size_t)gpp2 * 8 * kKsRows * 4;
}

}  // namespace

extern "C" {

// xq (M, K) int8, xscale (M,) f32; wp (N, K/8) int32; s, zs (N, G) bf16;
// out (M, N) f32 = (part_0 + part_1) * xscale.  K % 2048 == 0 (an even
// number of 128-word groups per plane), N % 64 == 0.
int lc_w4a8_ksplit(const void* xq, const void* xscale, const void* wp,
                   const void* s, const void* zs, void* out, int M, int N,
                   int K, void* stream) {
  if (K % (16 * kGroup) || N % kKsChan || M < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ksplit_smem(K);
  cudaError_t e = prepare(w4a8_ksplit_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / kKsChan, 2, (M + kKsRows - 1) / kKsRows);
  w4a8_ksplit_kernel<<<grid, kKsThreads, smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)xq, (const float*)xscale, (const int32_t*)wp,
      (const __nv_bfloat16*)s, (const __nv_bfloat16*)zs, (float*)out, M, N,
      K);
  return (int)cudaGetLastError();
}

}  // extern "C"
