// The fused layer tail for Hopper (sm_90a), CUDA C++ with a plain C
// interface bound from Python with ctypes (ops/_build.py,
// ops/layer_fused.py).  One kernel body, two kernels:
//
//   #15 layer_fused_kernel<false>  replaces
//       lightcompress_tpu/ops/pallas_matmul.py w4a8_attn_tail_fused
//       (_attn_tail_kernel)
//   #16 layer_fused_kernel<true>   replaces w4a8_layer_fused
//       (_layer_fused_kernel)
//
// What it computes, for ctx and x (B, H) bf16 and the o, gate|up and down
// weights (and, for #16, the next block's merged q|k|v), each in the
// untiled planes layout of w4_matmul.cu ((N, K/8) int32 codes, (N, G) bf16
// s and zs), with q8(t) the per-token int8 act quant of the prologue
// (w4_common.cuh quantize_rows; rms(t) its RMSNorm, gamma folded into the
// weights) and W(q) the grouped W4A8 dot without the act scale:
//   1. h   = f32(x) + o(q8(ctx)) * xs1                      (f32)
//   2. gu  = gateup(q8(rms(h))) * xs2                       (f32, B x 2I)
//   3. mid = (g * logistic(g)) * u, g|u the halves of gu    (f32)
//   4. y   = h + down(q8(mid)) * xs3; returned as bf16
//   5. #16: qkv = qkv(q8(rms(y))) * xs4 from the f32 y; returned as bf16.
// The TPU kernels run these as phases of one sequential grid with VMEM
// scratch between them.  Here each phase needs all of the previous one (the
// RMSNorm and the act amax read a whole row of h; down reads all of gate|up),
// so the kernel is one cooperative launch (cudaLaunchCooperativeKernel) of
// at most as many blocks as are co-resident, with grid-wide barriers
// (cooperative_groups::this_grid().sync()) between the phases; the card
// refuses a cooperative launch it cannot hold, and the wrapper raises.
//
// Prologues: each runs once a phase.  Block b quantizes rows b, b + grid,
// ... (B <= grid: one row a block) into a global workspace (int8 codes and
// the f32 act scale), then a grid barrier.  Matmul phases: #2's decode block
// (one lane one output channel, four warps over the gi range, __dp4a group
// dots, the f32 scale and zero correction) on tiles of 32 channels x 8 rows;
// each block walks the tiles b, b + grid, ...  A block stages its 8 rows of
// int8 codes (and their group sums) in shared memory once a phase when the
// grid is a multiple of the row chunks, as it is on the H100 (132 blocks, 4
// chunks at B 32), else at each change of chunk.  Workspaces (from the
// wrapper): h, gate|up and (for #16) y in f32, the four prologues' codes
// and scales.
//
// Bound on an H100 SXM: the packed weights, read once: #15 at Llama-3-8B
// (H 4096, I 14336) 102.8 MB, 0.031 ms at 3.35 TB/s; #16 adds the 12.9 MB of
// q|k|v.  The activations and workspaces are a few MB at B 32.  Shared
// memory is sized for the widest K (down's I: 122 KB at I 14336), which
// leaves one block of four warps an SM; no tensor cores, no TMA.

#include <cooperative_groups.h>

#include <initializer_list>

#include "w4_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace lcw4;

constexpr int kRows = 8;  // rows of a matmul tile

struct Linear {
  const int32_t* w;
  const __nv_bfloat16* s;
  const __nv_bfloat16* zs;
  int N, K;
};

struct Params {
  const __nv_bfloat16* ctx;
  const __nv_bfloat16* x;
  Linear o, gu, down, qkv;
  __nv_bfloat16* y;
  __nv_bfloat16* qkv_out;
  float* h;       // (B, H)
  float* gub;     // (B, 2I); the SiLU product overwrites its first half
  float* yf;      // (B, H), #16
  int8_t* xq[4];  // the prologues' codes: (B, H), (B, H), (B, I), (B, H)
  float* xs[4];   // and act scales (B)
  int B, H, I, kmax;
  float eps;
};

enum class Epi { kO, kGateUp, kDown, kQkv };

// Shared memory: kRows staged rows of the widest K, their group sums, the
// warps' partial outputs, the prologue's reduction scratch.
struct Smem {
  int8_t* xsh;
  float* xsum;
  float* red;
  float* scratch;
  __device__ Smem(unsigned char* base, int kmax) {
    xsh = reinterpret_cast<int8_t*>(base);
    xsum = reinterpret_cast<float*>(base + (size_t)kRows * kmax);
    red = xsum + kRows * (kmax / kGroup);
    scratch = red + kDecodeWarps * kRows * 32;
  }
  static size_t bytes(int kmax) {
    return (size_t)kRows * kmax + (size_t)kRows * (kmax / kGroup) * 4 +
           (size_t)kDecodeWarps * kRows * 32 * 4 + 2 * kDecodeWarps * 4;
  }
};

// Prologue: rows of t (row stride ld) -> codes xq (B, K) and scales xs.
template <typename T>
__device__ void prologue(const T* t, size_t ld, int B, int K, int rms,
                         float eps, int8_t* xq, float* xs, float* scratch) {
  for (int r = blockIdx.x; r < B; r += gridDim.x)
    quantize_rows<1>(t + (size_t)r * ld, 1, K, 0, rms, eps,
                     xq + (size_t)r * K, xs + r, scratch);
}

// One matmul phase over the codes xq (B, K) with act scales xs.
template <Epi E>
__device__ void matmul_phase(const Params& p, const Linear& L,
                             const int8_t* xq, const float* xs, Smem& sm) {
  const int K = L.K, N = L.N, B = p.B;
  const int kp = K / 8, G = K / kGroup, gpp = kp / kGroup;
  const int chunks = (B + kRows - 1) / kRows, tiles = (N / 32) * chunks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int staged = -1;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int mc = t % chunks, m0 = mc * kRows;
    const int n = (t / chunks) * 32 + lane;
    if (mc != staged) {
      __syncthreads();  // the previous tile is done with xsh
      stage_rows<kRows>(xq, B, K, m0, sm.xsh);
      __syncthreads();
      group_sums<kRows>(sm.xsh, K, sm.xsum);
      __syncthreads();
      staged = mc;
    }
    float acc[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) acc[m] = 0.f;
    const int32_t* wrow = L.w + (size_t)n * kp;
    for (int gi = warp; gi < gpp; gi += kDecodeWarps) {
      int dot[8][kRows];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int m = 0; m < kRows; ++m) dot[j][m] = 0;
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
          for (int m = 0; m < kRows; ++m) {
            const int xv =
                *reinterpret_cast<const int*>(sm.xsh + (size_t)m * K + koff);
            dot[j][m] = __dp4a(packed, xv, dot[j][m]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int g = j * gpp + gi;
        const float sf = __bfloat162float(L.s[(size_t)n * G + g]);
        const float zf = __bfloat162float(L.zs[(size_t)n * G + g]);
#pragma unroll
        for (int m = 0; m < kRows; ++m)
          acc[m] += sf * (float)dot[j][m] - zf * sm.xsum[m * G + g];
      }
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m)
      sm.red[(warp * kRows + m) * 32 + lane] = acc[m];
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int row = m0 + m;
        if (row >= B) continue;
        float v = 0.f;
        for (int w = 0; w < kDecodeWarps; ++w)
          v += sm.red[(w * kRows + m) * 32 + lane];
        const float a = __fmul_rn(v, xs[row]);
        const size_t i = (size_t)row * N + n;
        if constexpr (E == Epi::kO) {
          p.h[i] = __fadd_rn(__bfloat162float(p.x[i]), a);
        } else if constexpr (E == Epi::kGateUp) {
          p.gub[i] = a;
        } else if constexpr (E == Epi::kDown) {
          const float yv = __fadd_rn(p.h[i], a);
          if (p.yf != nullptr) p.yf[i] = yv;
          p.y[i] = __float2bfloat16(yv);
        } else {
          p.qkv_out[i] = __float2bfloat16(a);
        }
      }
    }
    __syncthreads();  // red is free for the next tile
  }
}

template <bool kNext>
__global__ void __launch_bounds__(kDecodeThreads)
layer_fused_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem sm(smem, p.kmax);
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, H = p.H, I = p.I;

  prologue(p.ctx, H, B, H, 0, p.eps, p.xq[0], p.xs[0], sm.scratch);
  grid.sync();
  matmul_phase<Epi::kO>(p, p.o, p.xq[0], p.xs[0], sm);
  grid.sync();
  prologue(p.h, H, B, H, 1, p.eps, p.xq[1], p.xs[1], sm.scratch);
  grid.sync();
  matmul_phase<Epi::kGateUp>(p, p.gu, p.xq[1], p.xs[1], sm);
  grid.sync();
  // mid = (g * logistic(g)) * u in f32, into the row's first half
  for (int r = blockIdx.x; r < B; r += gridDim.x) {
    float* row = p.gub + (size_t)r * 2 * I;
    for (int i = threadIdx.x; i < I; i += blockDim.x) {
      const float g = row[i];
      const float lg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
      row[i] = __fmul_rn(__fmul_rn(g, lg), row[I + i]);
    }
    __syncthreads();
  }
  prologue(p.gub, 2 * (size_t)I, B, I, 0, p.eps, p.xq[2], p.xs[2],
           sm.scratch);
  grid.sync();
  matmul_phase<Epi::kDown>(p, p.down, p.xq[2], p.xs[2], sm);
  if constexpr (kNext) {
    grid.sync();
    prologue(p.yf, H, B, H, 1, p.eps, p.xq[3], p.xs[3], sm.scratch);
    grid.sync();
    matmul_phase<Epi::kQkv>(p, p.qkv, p.xq[3], p.xs[3], sm);
  }
}

// The largest number of tiles of any phase, and the grid: co-resident
// blocks (or fewer, at most max_blocks when that is > 0), no more than
// there is work for.  Returns 0 where the card cannot run it cooperatively.
template <bool kNext>
int grid_size(int B, int H, int I, int Nq, int max_blocks, size_t smem,
              cudaError_t* err) {
  *err = prepare(layer_fused_kernel<kNext>, smem);
  if (*err != cudaSuccess) return 0;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, layer_fused_kernel<kNext>, kDecodeThreads, smem);
  if (*err != cudaSuccess) return 0;
  if (!coop || per_sm < 1) {
    *err = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  const int chunks = (B + kRows - 1) / kRows;
  int work = B;
  for (int n : {H, 2 * I, H, kNext ? Nq : 0})
    work = work > (n / 32) * chunks ? work : (n / 32) * chunks;
  int grid = per_sm * sms;
  if (max_blocks > 0 && max_blocks < grid) grid = max_blocks;
  return grid < work ? grid : work;
}

size_t smem_bytes(int H, int I) { return Smem::bytes(H > I ? H : I); }

}  // namespace

extern "C" {

// The grid a launch of these shapes takes (0: refused; see lc_layer_fused).
int lc_layer_fused_grid(int B, int H, int I, int Nq, int next,
                        int max_blocks) {
  cudaError_t e;
  const size_t smem = smem_bytes(H, I);
  return next ? grid_size<true>(B, H, I, Nq, max_blocks, smem, &e)
              : grid_size<false>(B, H, I, Nq, max_blocks, smem, &e);
}

// #15 (next = 0) and #16 (next = 1).  ctx, x (B, H) bf16; wo (H, H/8),
// wg (2I, H/8), wd (H, I/8), wq (Nq, H/8) int32 with their (N, G) bf16
// scales and zero corrections (wq, sq, zsq and qkv unused when next = 0);
// y (B, H) and qkv (B, Nq) bf16 out.  ws_f32 holds B*(2H + 2I) + 4B floats
// (h, gate|up, y, the four act scales), ws_i8 B*(3H + I) bytes (the four
// prologues' codes), in that order.  H % 1024 == 0, I % 1024 == 0,
// Nq % 32 == 0.  max_blocks > 0 caps the grid below the co-resident count.
int lc_layer_fused(const void* ctx, const void* x, const void* wo,
                   const void* so, const void* zso, const void* wg,
                   const void* sg, const void* zsg, const void* wd,
                   const void* sd, const void* zsd, const void* wq,
                   const void* sq, const void* zsq, void* y, void* qkv,
                   void* ws_f32, void* ws_i8, int B, int H, int I, int Nq,
                   int next, float eps, int max_blocks, void* stream) {
  if (B < 1 || H % (8 * kGroup) || I % (8 * kGroup) ||
      (next && (Nq < 32 || Nq % 32)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.ctx = (const __nv_bfloat16*)ctx;
  p.x = (const __nv_bfloat16*)x;
  auto lin = [](const void* w, const void* s, const void* zs, int N, int K) {
    return Linear{(const int32_t*)w, (const __nv_bfloat16*)s,
                  (const __nv_bfloat16*)zs, N, K};
  };
  p.o = lin(wo, so, zso, H, H);
  p.gu = lin(wg, sg, zsg, 2 * I, H);
  p.down = lin(wd, sd, zsd, H, I);
  p.qkv = lin(wq, sq, zsq, Nq, H);
  p.y = (__nv_bfloat16*)y;
  p.qkv_out = (__nv_bfloat16*)qkv;
  float* f = (float*)ws_f32;
  const size_t bh = (size_t)B * H, bi = (size_t)B * I;
  p.h = f;
  p.gub = f + bh;
  p.yf = next ? f + bh + 2 * bi : nullptr;
  int8_t* q = (int8_t*)ws_i8;
  const size_t xq_off[4] = {0, bh, 2 * bh, 2 * bh + bi};
  for (int k = 0; k < 4; ++k) {
    p.xq[k] = q + xq_off[k];
    p.xs[k] = f + 2 * bh + 2 * bi + (size_t)k * B;
  }
  p.B = B;
  p.H = H;
  p.I = I;
  p.kmax = H > I ? H : I;
  p.eps = eps;

  const size_t smem = smem_bytes(H, I);
  cudaError_t e;
  const int grid = next ? grid_size<true>(B, H, I, Nq, max_blocks, smem, &e)
                        : grid_size<false>(B, H, I, Nq, max_blocks, smem, &e);
  if (grid < 1) return (int)e;
  void* args[] = {(void*)&p};
  e = cudaLaunchCooperativeKernel(
      next ? (const void*)layer_fused_kernel<true>
           : (const void*)layer_fused_kernel<false>,
      dim3(grid), dim3(kDecodeThreads), args, smem,
      reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
