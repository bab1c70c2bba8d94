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
// s and zs), with q8(t) the per-token int8 act quant of the prologues
// (rms(t) its RMSNorm, gamma folded into the weights) and W(q) the grouped
// W4A8 dot without the act scale:
//   1. h   = f32(x) + o(q8(ctx)) * xs0                      (f32)
//   2. gu  = gateup(q8(rms(h))) * xs1                       (f32)
//   3. mid = (g * logistic(g)) * u, g|u the halves of gu    (f32)
//   4. y   = h + down(q8(mid)) * xs2; returned as bf16
//   5. #16: qkv = qkv(q8(rms(y))) * xs3 from the f32 y; returned as bf16.
// Each phase needs all of the previous one (the RMSNorm and the act amax
// read a whole row; down reads all of mid), so the kernel is one
// cooperative launch (cudaLaunchCooperativeKernel) of at most as many
// blocks as are co-resident, persistent, with grid-wide barriers
// (cooperative_groups::this_grid().sync()) between its segments: for each
// matmul phase a prologue (the act quant of its input) and the products.
// The card refuses a cooperative launch it cannot hold; the wrapper raises.
//
// Bound on an H100 SXM: the packed weights, read once: #15 at Llama-3-8B
// (H 4096, I 14336) 102.8 MB, 0.031 ms at 3.35 TB/s; #16 adds the 12.9 MB of
// q|k|v.  The activations and workspaces are a few MB at B 32 and stay in
// the 50 MB L2.  The design:
//   * Products on #5's int8 decode tile (w4_mma.cuh): a work item is 64
//     channels by up to 32 rows by a range of group blocks gi, so at B <= 32
//     every weight byte is read once; more rows are more items.  Its 8 warps
//     are 2 row halves (an m16 tile of mma.sync m16n8k32 s8 x s8 -> s32)
//     by 4 channel quarters (two n8 tiles), so each reads half the x slab
//     a step.  The B fragments are unpacked in registers from the planes
//     words (planes_b_frags), the A fragments read by ldmatrix from the
//     x codes of the gi (8 planes x 128 k x 32 rows, 32 KB) staged one gi
//     ahead in the 128-byte swizzle.  A block takes 196 KB of shared
//     memory: one 8-warp block an SM.
//   * A weight stream that does not stop: each block knows its whole
//     sequence of (phase, item, gi) steps, and its 32 KB word blocks reach
//     a three-slot ring by coalesced 16-byte cp.async two steps ahead of
//     the products, across items, prologues and grid barriers (the weights
//     do not depend on the activations), as the TPU pipeline prefetches the
//     next phase's first block.  Only the x slab waits for the barrier.
//   * Every phase fills the grid: the gi range of a phase is split when
//     that evens the blocks' work (the host's plan: the busiest block's
//     steps, an item's epilogue counted as one step and a meet of split
//     parts as three).  Each split writes its f32 part to a workspace; the
//     last split of an item to arrive (an integer counter, no float
//     atomics) sums the parts in split order, so the result has the same
//     bits on every run, and runs the phase's epilogue.
//   * The epilogue order of the TPU's _phase_dot over an item's gi range:
//     for each gi, then plane j, the exact integer group dot times s into
//     accumulator j % 4; then (a0 + a1) + (a2 + a3); then the eight
//     per-plane zero corrections sum_gi xsum * zs, subtracted in plane
//     order; every op rounded on its own.  The splits meet as
//     ((0 + part_0) + part_1) + ..., then times the act scale.
//   * The prologues run on every block: the epilogue that writes h, mid or
//     y also writes each row's partial sum of squares over its channels
//     and raises the row's amax (an atomic maximum, order-free); after the
//     barrier a warp per 1024 codes of a row reduces the partials in one
//     fixed order (the same bits in every warp) and quantizes its codes.  The gate|up items take 32 gate and the same 32
//     up channels, so their epilogue forms mid = silu(g) * u itself.
//   * Optional stamps (%globaltimer) of block 0 and the last block to
//     arrive at each segment's end and past each barrier, for the phase
//     times (nullptr: none; the bench never asks).

#include <cooperative_groups.h>

#include <algorithm>

#include "w4_mma.cuh"

namespace {

namespace cg = cooperative_groups;

using namespace lcw4;

constexpr int kWarps = 8;                    // n8 tiles of a work item
constexpr int kThreads = kWarps * 32;
constexpr int kChan = kWarps * 8;            // channels of a work item
constexpr int kRows = 32;                    // rows: two m16 tiles
constexpr int kPlaneX = kRows * kTileRow;    // one plane's x tile
constexpr int kStageX = 8 * kPlaneX;         // the eight planes of a gi
constexpr int kWords = kChan * kWordRow;     // a word block, 32 KB
constexpr int kWSlots = 3;                   // word blocks in the ring
constexpr int kMaxGi = 8;                    // group blocks of an item
constexpr int kPhases = 4;                   // o, gate|up, down, q|k|v
constexpr int kSegs = 2 * kPhases;           // a prologue and products each
constexpr int kUnit = 1024;                  // codes of a prologue unit
constexpr int kStamps = 1 + 3 * kSegs + kSegs;

enum Kind { kO = 0, kGateUp = 1, kDown = 2, kQkv = 3 };

struct Phase {
  const int32_t* w;
  const __nv_bfloat16* s;
  const __nv_bfloat16* zs;
  int N, K;          // weight rows, depth
  int tiles;         // 64-channel tiles (gate|up: 32 gate + 32 up channels)
  int splits;        // pieces of the gi range
  int items;         // tiles * row chunks * splits
};

struct Params {
  const __nv_bfloat16* ctx;
  const __nv_bfloat16* x;
  Phase ph[kPhases];
  __nv_bfloat16* y;
  __nv_bfloat16* qkv_out;
  float* h;       // (B, H)
  float* mid;     // (B, I)
  float* yf;      // (B, H), #16
  float* stats;   // [tmax][B]: the rows' partial sums of squares
  float* parts;   // [splits][B][tiles * 64]: the splits' parts
  int8_t* xq[kPhases];  // each phase's act codes (B, K) and scales (B)
  float* xs[kPhases];
  int* counters;  // [kPhases][cmax]: the parts of an item that arrived
  int* amax;      // [kPhases][B]: each prologue's row amax, as float bits
  unsigned long long* stamps;  // kStamps, or nullptr
  int nph, B, H, I, chunks, tmax, cmax;
  float eps;
};

// Shared memory: the word ring, the x slabs, an item's group sums and zero
// scales (for its corrections), the epilogue's exchange.
struct Smem {
  int8_t* wbuf;            // [3][64][512]
  int8_t* xbuf;            // [2][8][32][128]
  float* xsum;             // [kMaxGi][8][32]
  __nv_bfloat16* ssh;      // [2][8][64]: s of a step
  __nv_bfloat16* zsh;      // [2][kMaxGi][8][64]: zs of an item
  float* ep;               // [32][32]: u of a gate|up item
  float* red;              // [2][4][32]: the warps' row sums and maxima
  int* flag;
  __device__ explicit Smem(unsigned char* base) {
    wbuf = reinterpret_cast<int8_t*>(base);
    xbuf = wbuf + kWSlots * kWords;
    xsum = reinterpret_cast<float*>(xbuf + 2 * kStageX);
    ssh = reinterpret_cast<__nv_bfloat16*>(xsum + kMaxGi * 8 * kRows);
    zsh = ssh + 2 * 8 * kChan;
    ep = reinterpret_cast<float*>(zsh + 2 * kMaxGi * 8 * kChan);
    red = ep + kRows * 32;
    flag = reinterpret_cast<int*>(red + 2 * 4 * kRows);
  }
};
constexpr size_t kSmem = 128 + (size_t)kWSlots * kWords + 2 * kStageX +
                         (size_t)kMaxGi * 8 * kRows * 4 + 2 * 8 * kChan * 2 +
                         2 * (size_t)kMaxGi * 8 * kChan * 2 + kRows * 32 * 4 +
                         2 * 4 * kRows * 4 + 16;

// A block's place in its sequence of steps: phase, item, gi and the end of
// the item's gi range (ph == nph: past the last step), with the item
// decoded (its tile, row chunk and split; tc the tile and chunk's index).
// Block b takes the items b, b + grid, ... of each phase.
struct Cursor {
  int ph, it, g, g1;
  int tile, tc, split, m0, nv;
  __device__ void range(const Params& p) {
    const Phase& P = p.ph[ph];
    const int gpp = P.K / (8 * kGroup);
    split = it % P.splits;
    tc = it / P.splits;
    tile = tc / p.chunks;
    m0 = (tc - tile * p.chunks) * kRows;
    nv = min(kRows, p.B - m0);
    g = split * gpp / P.splits;
    g1 = (split + 1) * gpp / P.splits;
  }
  __device__ void seek(const Params& p, int from) {
    for (ph = from; ph < p.nph; ++ph) {
      it = blockIdx.x;
      if (it < p.ph[ph].items) {
        range(p);
        return;
      }
    }
  }
  __device__ void next(const Params& p) {
    if (ph >= p.nph || ++g < g1) return;
    it += gridDim.x;
    if (it < p.ph[ph].items)
      range(p);
    else
      seek(p, ph + 1);
  }
};

// the weight row of channel c (0..63) of a tile: gate|up tiles hold gate
// rows tile*32 + c and the up rows I + tile*32 + c - 32
__device__ __forceinline__ int wrow(const Params& p, int ph, int tile, int c) {
  return ph == kGateUp ? (c < 32 ? 0 : p.I) + tile * 32 + (c & 31)
                       : tile * kChan + c;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// stamps: [0] the start; [1 + 3s] block 0's arrival at the end of segment
// s, [2 + 3s] the last block's, [3 + 3s] block 0 past the barrier after it;
// [1 + 3 kSegs + s] the arrivals counted
__device__ void arrive(const Params& p, int s) {
  if (p.stamps == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long t = global_ns();
    if (blockIdx.x == 0) p.stamps[1 + 3 * s] = t;
    if (atomicAdd(p.stamps + 1 + 3 * kSegs + s, 1ull) == gridDim.x - 1)
      p.stamps[2 + 3 * s] = t;
  }
}
__device__ void passed(const Params& p, int s) {
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    p.stamps[3 + 3 * s] = global_ns();
}

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The prologue of phase ph: the act codes and scales of its input (ctx;
// rms(h); mid; rms(y)), a warp per unit of 1024 codes of a row over the
// whole grid.  A row's sum of squares: the partials of the producing
// phase's tiles, lane l taking tiles l, l + 32, ..., then a butterfly
// (every warp of the row gets the same bits); its amax: the producing
// epilogues' atomic maximum (order-free), or for ctx from the row itself.
// Then, in the order of w4_common.cuh's fused prologue: xf = v * rsqrt(ss
// / K + eps) where rms, sc = max(amax, 1e-8) / 127, q = clip(rint(xf /
// sc)).
__device__ void prologue(const Params& p, int ph) {
  const int K = ph == kDown ? p.I : p.H;
  const bool rms = ph & 1;
  const int T = p.H / kChan;  // o's and down's tiles: the partial sums
  const float* ss_part = p.stats;
  const float* src = ph == kGateUp ? p.h : ph == kDown ? p.mid : p.yf;
  const int lane = threadIdx.x & 31;
  const int segs = K / kUnit;
  int8_t* xq = p.xq[ph];
  for (int u = blockIdx.x * kWarps + (threadIdx.x >> 5); u < p.B * segs;
       u += gridDim.x * kWarps) {
    const int r = u / segs, sg = u % segs;
    // the unit's values first: their loads and the statistics' are in
    // flight together
    float v[kUnit / 128][4];
#pragma unroll
    for (int c = 0; c < kUnit / 128; ++c) {
      const size_t i = (size_t)r * K + sg * kUnit + c * 128 + lane * 4;
      if (ph == 0) {
        const uint2 w = *reinterpret_cast<const uint2*>(p.ctx + i);
        v[c][0] = bf_lo(w.x);
        v[c][1] = bf_hi(w.x);
        v[c][2] = bf_lo(w.y);
        v[c][3] = bf_hi(w.y);
      } else {
        const float4 f = __ldcg(reinterpret_cast<const float4*>(src + i));
        v[c][0] = f.x;
        v[c][1] = f.y;
        v[c][2] = f.z;
        v[c][3] = f.w;
      }
    }
    float ss = 0.f, am = 0.f;
    if (ph == 0) {
      const uint4* row = reinterpret_cast<const uint4*>(p.ctx + (size_t)r * K);
#pragma unroll 8
      for (int i = lane; i < K / 8; i += 32) {
        const uint4 w4 = row[i];
        const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          am = fmaxf(am, fmaxf(fabsf(bf_lo(w[k])), fabsf(bf_hi(w[k]))));
      }
    } else {
      am = __int_as_float(__ldcg(p.amax + ph * p.B + r));
      if (rms)
#pragma unroll 2
        for (int t = lane; t < T; t += 32)
          ss = __fadd_rn(ss, __ldcg(ss_part + (size_t)t * p.B + r));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
      am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
    }
    float rr = 1.f;
    if (rms) {
      rr = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)K), p.eps));
      am = __fmul_rn(am, rr);
    }
    const float sc = __fdiv_rn(fmaxf(am, 1e-8f), 127.f);
#pragma unroll
    for (int c = 0; c < kUnit / 128; ++c) {
      char4 q;
      signed char* qb = reinterpret_cast<signed char*>(&q);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float t = rms ? __fmul_rn(v[c][k], rr) : v[c][k];
        qb[k] = (signed char)(int)fminf(
            fmaxf(rintf(__fdiv_rn(t, sc)), -127.f), 127.f);
      }
      *reinterpret_cast<char4*>(xq + (size_t)r * K + sg * kUnit + c * 128 +
                                lane * 4) = q;
    }
    if (sg == 0 && lane == 0) p.xs[ph][r] = sc;
  }
}

// The sums of squares (sq) and maxima of |v| of each row of an item over
// the channels of the warps w with w % 4 < nq (see the kernel's output
// map): the sums in one fixed order (a thread's four values, the quad's
// lanes, then the warps in turn) into stats[tile][row], the maxima into
// prologue ph's row amax by an atomic maximum of their bits (non-negative
// floats order as their bits).
__device__ void row_stats(const Params& p, const float (&v)[2][4], bool sq,
                          int nq, const Cursor& t, float* red, int ph) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cq = warp & 3, rb = 16 * (warp >> 2) + (lane >> 2);
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const float a[4] = {v[0][2 * hi], v[0][2 * hi + 1], v[1][2 * hi],
                        v[1][2 * hi + 1]};
    float s = 0.f, m = 0.f;
    if (sq)
      s = __fadd_rn(__fadd_rn(__fmul_rn(a[0], a[0]), __fmul_rn(a[1], a[1])),
                    __fadd_rn(__fmul_rn(a[2], a[2]), __fmul_rn(a[3], a[3])));
#pragma unroll
    for (int k = 0; k < 4; ++k) m = fmaxf(m, fabsf(a[k]));
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    if ((lane & 3) == 0 && cq < nq) {
      red[cq * kRows + rb + 8 * hi] = s;
      red[(4 + cq) * kRows + rb + 8 * hi] = m;
    }
  }
  __syncthreads();
  if (threadIdx.x < t.nv) {
    const int r = threadIdx.x;
    float s = red[r], m = red[4 * kRows + r];
    for (int q = 1; q < nq; ++q) {
      s = __fadd_rn(s, red[q * kRows + r]);
      m = fmaxf(m, red[(4 + q) * kRows + r]);
    }
    if (sq) p.stats[(size_t)t.tile * p.B + t.m0 + r] = s;
    atomicMax(p.amax + ph * p.B + t.m0 + r, __float_as_int(m));
  }
}

// The output map: warp w takes rows rb .. rb + 15 (rb = 16 (w >> 2), one
// m16 tile) of channels 16 (w & 3) .. + 15 (two n8 tiles).  Thread (g, t)
// holds out[n][e] at row rb + g + 8 (e >> 1), channel 16 (w & 3) + 8n +
// 2t + (e & 1): the x slab is read by ldmatrix twice a step (once a row
// half), the words by two warps.
template <bool kNext>
__global__ void __launch_bounds__(kThreads, 1)
layer_fused_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled tiles need 128-byte aligned bases
  Smem sm(smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rh = warp >> 2, rb = 16 * rh;  // the warp's rows
  const int cw = 16 * (warp & 3);          // the warp's channels
  const int cb = cw + 2 * t4;              // the thread's: cb + 8n + (e & 1)

  if (p.stamps != nullptr && blockIdx.x == 0 && tid == 0)
    p.stamps[0] = global_ns();
  // the meet counters and row amax, read only after the first barrier
  for (int i = blockIdx.x * kThreads + tid; i < kPhases * (p.cmax + p.B);
       i += gridDim.x * kThreads)
    p.counters[i] = 0;

  // word block of step c into ring slot `slot` (a cp.async group, empty
  // past the last step): channel row ch (512 bytes), 16-byte chunk q at
  // q ^ 4 (ch & 1), so that the lanes' reads below hit distinct banks
  auto stage_w = [&](const Cursor& c, int slot) {
    if (c.ph < p.nph) {
      // thread (q, ch0) copies chunk q of channels ch0 + 8k: rows tile*64 +
      // ch, or for gate|up the gate rows tile*32 + ch (k < 4) and the up
      // rows I + tile*32 + ch - 32
      const Phase& P = p.ph[c.ph];
      const int kp = P.K / 8, ch0 = tid >> 5, q = tid & 31;
      const bool gu = c.ph == kGateUp;
      const int32_t* src = P.w +
                           (size_t)(c.tile * (gu ? 32 : kChan) + ch0) * kp +
                           c.g * kGroup + 4 * q;
      const size_t up = gu ? (size_t)(p.I - 32) * kp : 0;
      int8_t* dst = sm.wbuf + slot * kWords + ch0 * kWordRow +
                    ((q ^ ((ch0 & 1) << 2)) << 4);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        cp_async16(dst + 8 * k * kWordRow,
                   src + (size_t)8 * k * kp + (k >= 4 ? up : 0), true);
    }
    cp_async_commit();
  };
  // the x of step c into slot `slot`: thread (row r, chunk q) copies
  // plane k's columns k*kp + gi*128 + 16q + [0, 16) of row r into plane
  // tile k at swz(r, q); zeros past B
  auto stage_x = [&](const Cursor& c, int slot) {
    const Phase& P = p.ph[c.ph];
    const int kp = P.K / 8, r = tid >> 3, q = tid & 7;
    const bool ok = r < c.nv;
    const int8_t* src =
        p.xq[c.ph] + (size_t)(c.m0 + (ok ? r : 0)) * P.K + c.g * kGroup +
        16 * q;
    int8_t* dst = sm.xbuf + slot * kStageX + swz(r, q);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      cp_async16(dst + k * kPlaneX, src + (size_t)k * kp, ok);
    cp_async_commit();
  };
  // the scales of step c: thread (channels tid >> 3 and that + 32, plane
  // tid & 7) loads their s and zs a step ahead (eight lanes read one
  // channel's 8 planes, a few sectors); store_s puts them in shared memory
  // at the end of the step before: s in slot `slot`, zs at gi `gl` of the
  // item of parity `par` (the item's corrections read them)
  __nv_bfloat16 ns[2][2];
  auto load_s = [&](const Cursor& c) {
    if (c.ph >= p.nph) return;
    const Phase& P = p.ph[c.ph];
    const int G = P.K / kGroup, gpp = G / 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t o = (size_t)wrow(p, c.ph, c.tile, (tid >> 3) + 32 * h) * G +
                       (tid & 7) * gpp + c.g;
      ns[h][0] = P.s[o];
      ns[h][1] = P.zs[o];
    }
  };
  auto store_s = [&](int slot, int par, int gl) {
    const int j = tid & 7, ch = tid >> 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sm.ssh[(slot * 8 + j) * kChan + ch + 32 * h] = ns[h][0];
      sm.zsh[((par * kMaxGi + gl) * 8 + j) * kChan + ch + 32 * h] = ns[h][1];
    }
  };
  // the pair of bf16 at q as two floats
  auto bf2 = [](const __nv_bfloat16* q, float (&f)[2]) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(q);
    f[0] = __low2float(v);
    f[1] = __high2float(v);
  };

  Cursor cc;  // the products' step
  cc.seek(p, 0);
  Cursor wc = cc;  // the word ring's, kWSlots - 1 steps ahead
  for (int k = 0; k < kWSlots - 1; ++k) {
    stage_w(wc, k);
    wc.next(p);
  }
  load_s(cc);  // stored after the first prologue
  int step = 0;  // the block's steps so far
  int ipar = 0;  // the parity of the block's items so far

  for (int ph = 0; ph < p.nph; ++ph) {
    prologue(p, ph);
    if (ph == 0) store_s(0, 0, 0);
    arrive(p, 2 * ph);
    grid.sync();
    passed(p, 2 * ph);

    const Phase& P = p.ph[ph];
    bool first = true;
    if (cc.ph == ph) stage_x(cc, step & 1);
    while (cc.ph == ph) {
      const Cursor t = cc;  // the item
      const int g0 = cc.g, g1 = cc.g1, par = ipar;
      const bool live = rb < t.nv;  // the warp's rows hold rows of B
      // the epilogue's operands, loaded now: the rows' act scales, and x
      // (o) or h (down) at the thread's outputs
      float xsr[2], ex[2][4];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = rb + g + 8 * hi;
        xsr[hi] = r < t.nv ? __ldcg(p.xs[ph] + t.m0 + r) : 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const size_t k =
                (size_t)(t.m0 + r) * p.H + t.tile * kChan + cb + 8 * n + e;
            ex[n][2 * hi + e] = r >= t.nv     ? 0.f
                                : ph == kO    ? bf(p.x[k])
                                : ph == kDown ? __ldcg(p.h + k)
                                              : 0.f;
          }
      }
      float acc[4][2][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
      bool last;
      do {
        // order of the cp.async groups: per step X(next) (or an empty
        // group at a phase's last step) and W(step + kWSlots - 1); at a
        // phase's first step X(step) comes last and everything is waited
        // for
        if (first)
          cp_async_wait<0>();
        else
          cp_async_wait<1>();
        first = false;
        __syncthreads();  // x and words landed; every warp is past step - 1
        Cursor nx = cc;
        nx.next(p);
        if (nx.ph == ph)
          stage_x(nx, (step + 1) & 1);
        else
          cp_async_commit();
        stage_w(wc, (step + kWSlots - 1) % kWSlots);
        wc.next(p);
        load_s(nx);
        const int gl = cc.g - g0;
        const int8_t* xs = sm.xbuf + (step & 1) * kStageX;
        {
          // the group sums of the step: thread (plane j, row r), stored
          // so that a thread reads its rows g and g + 8 of a row half as
          // one float2
          const int j = tid >> 5, r = tid & 31;
          int a = 0;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int4 v =
                *reinterpret_cast<const int4*>(xs + j * kPlaneX + swz(r, q));
            a = __dp4a(v.x, 0x01010101, a);
            a = __dp4a(v.y, 0x01010101, a);
            a = __dp4a(v.z, 0x01010101, a);
            a = __dp4a(v.w, 0x01010101, a);
          }
          sm.xsum[(gl * 8 + j) * kRows + (r & 16) + 2 * (r & 7) +
                  ((r >> 3) & 1)] = (float)a;
        }
        static_assert(kThreads == 8 * kRows, "a group sum a thread");

        int d[8][2][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[j][n][e] = 0;
        if (live) {
          // the lane's rows of the word block: channels cw + g and + 8
          const int8_t* wr =
              sm.wbuf + (step % kWSlots) * kWords + (cw + g) * kWordRow;
          const int sw = (g & 1) << 2;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int q = decode_b_word(kk, lane) / 4;  // b0's chunk; b1's q+4
            int b[2][8][2];
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const int8_t* w = wr + n * 8 * kWordRow;
              planes_b_frags(
                  *reinterpret_cast<const int4*>(w + ((q ^ sw) << 4)),
                  *reinterpret_cast<const int4*>(w + (((q + 4) ^ sw) << 4)),
                  b[n]);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              int a[4];
              decode_a_frag(a, xs + j * kPlaneX, rh, kk);
              mma_s8(d[j][0], a, b[0][j]);
              mma_s8(d[j][1], a, b[1][j]);
            }
          }
        }
        // the products apart from their scaling: interleaved by the
        // compiler, they wait on each other (14% slower, H100)
        asm volatile("" ::: "memory");
        if (live)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float sq[2][2];
#pragma unroll
            for (int n = 0; n < 2; ++n)
              bf2(sm.ssh + ((step & 1) * 8 + j) * kChan + cb + 8 * n, sq[n]);
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[j & 3][n][e] = mac_rn(acc[j & 3][n][e],
                                          exact_f32(d[j][n][e]), sq[n][e & 1]);
          }
        last = cc.g + 1 == g1;
        if (last) ipar ^= 1;
        store_s((step + 1) & 1, ipar, last ? 0 : gl + 1);
        ++step;
        cc = nx;
      } while (!last);

      // ---- the item's epilogue ----
      __syncthreads();  // the item's group sums and zero scales
      const int ng = g1 - g0;
      float v[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[n][e] = __fadd_rn(__fadd_rn(acc[0][n][e], acc[1][n][e]),
                              __fadd_rn(acc[2][n][e], acc[3][n][e]));
      // minus the eight planes' corrections sum_gi xsum * zs in plane
      // order (w4_mma.cuh, shared with #14)
      auto terms = [&](int gl, int j, float (&xq)[2][4], float (&z)[2][4]) {
        const float2 xv = *reinterpret_cast<const float2*>(
            sm.xsum + (gl * 8 + j) * kRows + rb + 2 * g);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float zn[2];
          bf2(sm.zsh + ((par * kMaxGi + gl) * 8 + j) * kChan + cb + 8 * n, zn);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            xq[n][e] = e < 2 ? xv.x : xv.y;
            z[n][e] = zn[e & 1];
          }
        }
      };
      minus_corrections<true>(v, ng, terms);
      const int W = P.tiles * kChan;  // the parts' row width
      if (P.splits > 1) {
        // the splits meet: each stores its part; the last to arrive sums
        // them in split order
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rb + g + 8 * (e >> 1);
            if (r < t.nv)
              p.parts[((size_t)t.split * p.B + t.m0 + r) * W +
                      t.tile * kChan + cb + 8 * n + (e & 1)] = v[n][e];
          }
        __threadfence();
        __syncthreads();
        if (tid == 0)
          *sm.flag = atomicAdd(p.counters + ph * p.cmax + t.tc, 1) ==
                     P.splits - 1;
        __syncthreads();
        if (!*sm.flag) continue;
        __threadfence();
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rb + g + 8 * (e >> 1);
            float a = 0.f;
            if (r < t.nv)
              for (int s = 0; s < P.splits; ++s)
                a = __fadd_rn(
                    a, __ldcg(p.parts + ((size_t)s * p.B + t.m0 + r) * W +
                              t.tile * kChan + cb + 8 * n + (e & 1)));
            v[n][e] = a;
          }
      }

      // the phase's epilogue: out = v * xs, then h, mid, y or q|k|v
      float o[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n][e] = rb + g + 8 * (e >> 1) < t.nv
                        ? __fmul_rn(v[n][e], xsr[e >> 1])
                        : 0.f;
      const int H = p.H;
      if (ph == kO || (kNext && ph == kDown)) {
        // h = x + out, or y = h + out; their rows' sums of squares and
        // amax over the tile for the next prologue
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rb + g + 8 * (e >> 1);
            if (r >= t.nv) continue;
            const size_t k =
                (size_t)(t.m0 + r) * H + t.tile * kChan + cb + 8 * n + (e & 1);
            o[n][e] = __fadd_rn(ex[n][e], o[n][e]);
            if (ph == kO) {
              p.h[k] = o[n][e];
            } else {
              p.yf[k] = o[n][e];
              p.y[k] = __float2bfloat16(o[n][e]);
            }
          }
        row_stats(p, o, true, 4, t, sm.red, ph + 1);
      } else if (ph == kDown) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rb + g + 8 * (e >> 1);
            if (r >= t.nv) continue;
            const size_t k =
                (size_t)(t.m0 + r) * H + t.tile * kChan + cb + 8 * n + (e & 1);
            p.y[k] = __float2bfloat16(__fadd_rn(ex[n][e], o[n][e]));
          }
      } else if (ph == kGateUp) {
        // warps with w % 4 >= 2 hold u, the others g of the same 32 mid
        // channels: mid = (g * logistic(g)) * u
        if ((warp & 3) >= 2)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sm.ep[(rb + g + 8 * (e >> 1)) * 32 + cb - 32 + 8 * n + (e & 1)] =
                  o[n][e];
        __syncthreads();
        if ((warp & 3) < 2)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = rb + g + 8 * (e >> 1), ch = cb + 8 * n + (e & 1);
              const float gv = o[n][e];
              const float u = sm.ep[r * 32 + ch];
              const float lg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gv)));
              o[n][e] = __fmul_rn(__fmul_rn(gv, lg), u);
              if (r < t.nv)
                p.mid[(size_t)(t.m0 + r) * p.I + t.tile * 32 + ch] = o[n][e];
            }
        row_stats(p, o, false, 2, t, sm.red, ph + 1);
      } else {
        const int N = P.N;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rb + g + 8 * (e >> 1);
            if (r < t.nv)
              p.qkv_out[(size_t)(t.m0 + r) * N + t.tile * kChan + cb + 8 * n +
                        (e & 1)] = __float2bfloat16(o[n][e]);
          }
      }
    }
    arrive(p, 2 * ph + 1);
    if (ph + 1 < p.nph) {
      grid.sync();
      passed(p, 2 * ph + 1);
    }
  }
}

// The launch's plan: the grid (co-resident blocks, or fewer: at most
// max_blocks when that is > 0, no more than the finest work of a phase),
// each phase's splits (fewest steps for the busiest block: the items a
// block takes times the gi of the largest split; ties to fewer splits) and
// the workspaces.  Returns 0, or an error where the card cannot run it
// cooperatively.
struct Plan {
  int grid, chunks, tmax, cmax;
  int tiles[kPhases], splits[kPhases];
  size_t f32, i32;
};

template <bool kNext>
cudaError_t plan_of(int B, int H, int I, int Nq, int max_blocks, Plan* pl) {
  cudaError_t e = prepare(layer_fused_kernel<kNext>, kSmem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, layer_fused_kernel<kNext>, kThreads, kSmem);
  if (e != cudaSuccess) return e;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int nph = kNext ? 4 : 3;
  const int K[kPhases] = {H, H, I, H};
  pl->chunks = (B + kRows - 1) / kRows;
  pl->tiles[kO] = H / kChan;
  pl->tiles[kGateUp] = I / 32;
  pl->tiles[kDown] = H / kChan;
  pl->tiles[kQkv] = kNext ? Nq / kChan : 0;
  long work = 1;
  pl->cmax = 1;
  for (int ph = 0; ph < nph; ++ph) {
    const long tc = (long)pl->tiles[ph] * pl->chunks;
    work = std::max(work, tc * (K[ph] / (8 * kGroup)));
    pl->cmax = std::max(pl->cmax, (int)tc);
  }
  int grid = per_sm * sms;
  if (max_blocks > 0 && max_blocks < grid) grid = max_blocks;
  pl->grid = (int)std::min<long>(grid, work);
  size_t parts = 0;
  for (int ph = 0; ph < kPhases; ++ph) {
    pl->splits[ph] = 1;
    if (ph >= nph) continue;
    const long tc = (long)pl->tiles[ph] * pl->chunks;
    const int gpp = K[ph] / (8 * kGroup);
    long best = -1;
    for (int s = (gpp + kMaxGi - 1) / kMaxGi; s <= gpp; ++s) {
      // in steps: the busiest block's items times their gi and epilogue
      // (about one step, three with the meet of split parts)
      const long cost = (tc * s + pl->grid - 1) / pl->grid *
                        ((gpp + s - 1) / s + (s > 1 ? 3 : 1));
      if (best < 0 || cost < best) {
        best = cost;
        pl->splits[ph] = s;
      }
    }
    if (pl->splits[ph] > 1)
      parts = std::max(parts, (size_t)pl->splits[ph] * B * pl->tiles[ph] *
                                  kChan);
  }
  pl->tmax = std::max(H / kChan, I / 32);
  pl->f32 = (size_t)B * (2 * (size_t)H + I) + kPhases * (size_t)B +
            (size_t)pl->tmax * B + parts;
  pl->i32 = (size_t)kPhases * (pl->cmax + B);
  return cudaSuccess;
}

cudaError_t plan(int B, int H, int I, int Nq, int next, int max_blocks,
                 Plan* pl) {
  if (B < 1 || H < kGroup * 8 || I < kGroup * 8 || H % (8 * kGroup) ||
      I % (8 * kGroup) || (next && (Nq < kChan || Nq % kChan)))
    return cudaErrorInvalidValue;
  return next ? plan_of<true>(B, H, I, Nq, max_blocks, pl)
              : plan_of<false>(B, H, I, Nq, max_blocks, pl);
}

}  // namespace

extern "C" {

// The plan of a launch at these shapes: out[0] the grid, [1] the shared
// memory of a block, [2..5] the splits of o, gate|up, down and q|k|v,
// [6] the f32 and [7] the int32 workspace elements, [8] the stamps.
// Returns 0, or the CUDA error of a launch the card refuses.
int lc_layer_fused_plan(int B, int H, int I, int Nq, int next,
                        int max_blocks, long long* out) {
  Plan pl;
  const cudaError_t e = plan(B, H, I, Nq, next, max_blocks, &pl);
  if (e != cudaSuccess) return (int)e;
  out[0] = pl.grid;
  out[1] = (long long)kSmem;
  for (int k = 0; k < kPhases; ++k) out[2 + k] = pl.splits[k];
  out[6] = (long long)pl.f32;
  out[7] = (long long)pl.i32;
  out[8] = kStamps;
  return 0;
}

// #15 (next = 0) and #16 (next = 1).  ctx, x (B, H) bf16; wo (H, H/8),
// wg (2I, H/8), wd (H, I/8), wq (Nq, H/8) int32 with their (N, G) bf16
// scales and zero corrections (wq, sq, zsq and qkv unused when next = 0);
// y (B, H) and qkv (B, Nq) bf16 out.  ws_f32: h (B, H), mid (B, I), y
// (B, H), the four act scales (B each), then the row statistics and the
// splits' parts; ws_i8: the four prologues' codes (B, H), (B, H), (B, I),
// (B, H); ws_i32 the meet counters and the prologues' row amax; sizes
// from lc_layer_fused_plan.
// stamps: nullptr, or that many zeroed int64.  H % 1024 == 0, I % 1024 ==
// 0, Nq % 64 == 0.  max_blocks > 0 caps the grid below the co-resident
// count.
int lc_layer_fused(const void* ctx, const void* x, const void* wo,
                   const void* so, const void* zso, const void* wg,
                   const void* sg, const void* zsg, const void* wd,
                   const void* sd, const void* zsd, const void* wq,
                   const void* sq, const void* zsq, void* y, void* qkv,
                   void* ws_f32, void* ws_i8, void* ws_i32, void* stamps,
                   int B, int H, int I, int Nq, int next, float eps,
                   int max_blocks, void* stream) {
  Plan pl;
  cudaError_t e = plan(B, H, I, Nq, next, max_blocks, &pl);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.ctx = (const __nv_bfloat16*)ctx;
  p.x = (const __nv_bfloat16*)x;
  const size_t bh = (size_t)B * H, bi = (size_t)B * I;
  float* f = (float*)ws_f32;
  int8_t* q = (int8_t*)ws_i8;
  const size_t xq_off[kPhases] = {0, bh, 2 * bh, 2 * bh + bi};
  for (int k = 0; k < kPhases; ++k) {
    p.xq[k] = q + xq_off[k];
    p.xs[k] = f + 2 * bh + bi + (size_t)k * B;
  }
  p.h = f;
  p.mid = f + bh;
  p.yf = next ? f + bh + bi : nullptr;
  p.stats = f + 2 * bh + bi + kPhases * (size_t)B;
  p.parts = p.stats + (size_t)pl.tmax * B;
  const void* w[kPhases][3] = {
      {wo, so, zso}, {wg, sg, zsg}, {wd, sd, zsd}, {wq, sq, zsq}};
  const int N[kPhases] = {H, 2 * I, H, Nq}, K[kPhases] = {H, H, I, H};
  for (int k = 0; k < kPhases; ++k) {
    Phase& P = p.ph[k];
    P.w = (const int32_t*)w[k][0];
    P.s = (const __nv_bfloat16*)w[k][1];
    P.zs = (const __nv_bfloat16*)w[k][2];
    P.N = N[k];
    P.K = K[k];
    P.tiles = pl.tiles[k];
    P.splits = pl.splits[k];
    P.items = pl.tiles[k] * pl.chunks * pl.splits[k];
  }
  p.y = (__nv_bfloat16*)y;
  p.qkv_out = (__nv_bfloat16*)qkv;
  p.counters = (int*)ws_i32;
  p.amax = p.counters + kPhases * pl.cmax;
  p.stamps = (unsigned long long*)stamps;
  p.nph = next ? 4 : 3;
  p.B = B;
  p.H = H;
  p.I = I;
  p.chunks = pl.chunks;
  p.tmax = pl.tmax;
  p.cmax = pl.cmax;
  p.eps = eps;

  void* args[] = {(void*)&p};
  e = cudaLaunchCooperativeKernel(
      next ? (const void*)layer_fused_kernel<true>
           : (const void*)layer_fused_kernel<false>,
      dim3(pl.grid), dim3(kThreads), args, kSmem,
      reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
