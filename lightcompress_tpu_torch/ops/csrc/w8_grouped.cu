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
// Bound on an H100 SXM (3.35 TB/s HBM, 1979 TOP/s int8 dense peak): at a
// prefill's shapes the bytes (each live expert's N*K codes, x, and the
// Mp*N f32 outputs) outweigh the 2*Mp*N*K operations.  The design:
//   * Both operands are plain int8 with K contiguous, the textbook wgmma
//     case: a tile is 128 rows x 128 channels (64 rows when m_tile % 128 !=
//     0), two consumer warpgroups of 64 rows each run wgmma m64n64k32 s8
//     (two per k32 step, one a 64-channel half) straight from shared
//     memory, accumulating int32 in registers (64 a thread).
//   * K goes in 128-byte stages: one TMA box of x ([rows][128]) and one of
//     the expert's codes ([128 channels][128]), both with the 128-byte
//     swizzle wgmma reads, into a ring of kStages = 4 stages (128 KB): at K
//     768 (six stages) nearly a whole tile's K is in flight.  TMA's zero
//     fill covers the K tail (K % 128) and the last expert's rows past N;
//     another expert's rows past a ragged N are computed and never stored.
//   * A producer warpgroup (one thread) issues the copies and counts them
//     on a full mbarrier per stage; each consumer warp releases a stage on
//     its empty mbarrier once its products have read it (wgmma_wait<1> keeps
//     one stage's products in flight).  The producer runs ahead into the next
//     tile, so the epilogue overlaps the next tile's loads.
//   * Persistent: one block an SM (about 197 KB of shared memory), walking
//     the tile list u = m block * NT + channel tile with a stride of the grid,
//     so the blocks in flight cover about eight M blocks: their x comes from
//     L2 to every channel tile, an expert's codes are read from HBM about once
//     (the padding-only M blocks that moe_group_selections clamps to expert
//     E - 1 follow one another and reuse its codes from L2).  An expert id
//     out of range fills its tile with NaN (no loads).
//   * Epilogue, after the K loop: each warpgroup puts its int32 tile in
//     shared memory (32 KB, 16-byte chunks swizzled by row: the fragment
//     stores and the row reads hit distinct banks); its row stores run under
//     the next tile's first products: each warp takes whole rows, 16 bytes a
//     lane, the scale products, and coalesced 16-byte stores (512
//     contiguous bytes a warp instruction; scalar stores where N % 4 != 0),
//     masked at N.  The scales are loaded before the K loop: read inside the
//     row loop, their latency made the epilogue 5 µs a tile, more than the
//     products and the loads (globaltimer stamps).
// Tried and lost (H100, the Qwen3 down): rings of 3 and 5 stages (5% and
// 3% slower than 4); 64 x 128 tiles on mma.sync with register-staged
// 64-byte K steps, the previous body, took twice as long (0.34 ms).

#include "w4_mma.cuh"

namespace {

using lcw4::mbar_expect_tx;
using lcw4::mbar_init;
using lcw4::mbar_wait;
using lcw4::sw128_desc;
using lcw4::tma_load_2d;
using lcw4::wgmma_s8_64x64;

constexpr int kBN = 128;     // channels of a tile
constexpr int kBK = 128;     // bytes of K a stage
constexpr int kStages = 4;   // ring depth

// kWG consumer warpgroups of 64 rows (2: 128-row tiles, m_tile % 128 == 0;
// 1: 64-row tiles) and one producer warpgroup
template <int kWG>
struct Cfg {
  static constexpr int kBM = 64 * kWG;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kXBytes = kBM * kBK;
  static constexpr int kStageBytes = kXBytes + kBN * kBK;
  static constexpr int kOutInts = kWG * 64 * kBN;  // the int32 staging
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kStageBytes + kOutInts * 4 + 2 * kStages * 8;
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          lcw4::smem_u32(bar))
      : "memory");
}
// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
// int offset of channel c of row r in a warpgroup's [64][128] int32
// staging: 16-byte chunk c / 4 of the row's 32 at (c / 4) ^ (r & 7)
__device__ __forceinline__ int out_swz(int r, int c) {
  return r * kBN + ((((c >> 2) ^ (r & 7))) << 2) + (c & 3);
}

template <int kWG>
__global__ void __launch_bounds__(Cfg<kWG>::kThreads, 1)
w8a8_grouped_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const float* __restrict__ xscale,
                    const float* __restrict__ scales,
                    const int32_t* __restrict__ block_eid,
                    float* __restrict__ out, int Mp, int N, int K, int E,
                    int m_tile) {
  using C = Cfg<kWG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the wgmma tiles need 1024-byte aligned bases
  unsigned char* ring =
      smem_raw + ((1024 - (lcw4::smem_u32(smem_raw) & 1023)) & 1023);
  int32_t* staged = reinterpret_cast<int32_t*>(ring + kStages * C::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + C::kOutInts);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NT = (N + kBN - 1) / kBN, units = (Mp / C::kBM) * NT;
  const int KS = (K + kBK - 1) / kBK;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * kWG);  // one arrival a consumer warp
    }
    lcw4::mbar_init_fence();
  }
  __syncthreads();
  auto expert = [&](int u) {
    return block_eid[(u / NT) * C::kBM / m_tile];
  };

  if (warp >= 4 * kWG) {  // the producer warpgroup: one thread issues
    if (warp == 4 * kWG && lane == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int e = expert(u);
        if (e < 0 || e >= E) continue;
        const int m0 = (u / NT) * C::kBM, n0 = (u % NT) * kBN;
        for (int ks = 0; ks < KS; ++ks, ++it) {
          const int slot = it % kStages;
          if (it >= kStages) mbar_wait(empty + slot, (it / kStages - 1) & 1);
          unsigned char* st = ring + slot * C::kStageBytes;
          mbar_expect_tx(full + slot, C::kStageBytes);
          tma_load_2d(st, &xmap, ks * kBK, m0, full + slot);
          tma_load_2d(st + C::kXBytes, &wmap, ks * kBK, e * N + n0,
                      full + slot);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, wl = warp & 3;
  int32_t* so = staged + wg * 64 * kBN;
  // The rows of a tile (64 of warpgroup wg): warp wl stores rows wl, wl + 4,
  // ..., lane l channels n .. n + 3 (n = n0 + 4 l), from the int32 tile in
  // `so` (NaN for an expert id out of range), with the channel scales sc
  // and lane i's xs (row wl + 4 i's act scale).
  auto store_rows = [&](bool bad, int m0, int n, const float (&sc)[4],
                        float xs_l) {
    const bool vec = (N & 3) == 0 && n + 3 < N;
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int r = wl + 4 * i;
      const float xs = __shfl_sync(0xffffffffu, xs_l, i);
      float v[4];
      if (bad) {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = __int_as_float(0x7fc00000);
      } else {
        const int4 a =
            *reinterpret_cast<const int4*>(so + out_swz(r, 4 * lane));
        v[0] = __fmul_rn(__fmul_rn(__int2float_rn(a.x), sc[0]), xs);
        v[1] = __fmul_rn(__fmul_rn(__int2float_rn(a.y), sc[1]), xs);
        v[2] = __fmul_rn(__fmul_rn(__int2float_rn(a.z), sc[2]), xs);
        v[3] = __fmul_rn(__fmul_rn(__int2float_rn(a.w), sc[3]), xs);
      }
      float* o = out + (size_t)(m0 + r) * N + n;
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (n + k < N) o[k] = v[k];
      }
    }
  };
  // a tile whose int32 outputs wait in `so`: its row stores run under the
  // next tile's first products (or after the last tile)
  bool pend = false;
  int pm0 = 0, pn = 0;
  float psc[4] = {0.f, 0.f, 0.f, 0.f}, pxs = 0.f;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int e = expert(u);
    const bool bad = e < 0 || e >= E;  // uniform over the block
    const int m0 = (u / NT) * C::kBM + 64 * wg, n0 = (u % NT) * kBN;
    // the epilogue's scales, read now so that their latency hides under
    // the K loop: lane l holds row wl + 4 (l & 15)'s act scale and the
    // channel scales of its four channels
    const int n = n0 + 4 * lane;
    float sc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sc[i] = (!bad && n + i < N) ? scales[(size_t)e * N + n + i] : 0.f;
    const float xs_l = xscale[m0 + wl + 4 * (lane & 15)];
    if (bad) {
      store_rows(true, m0, n, sc, xs_l);
      continue;
    }
    // d0: channels 0-63 of the tile, d1: 64-127; thread t of warp wl holds
    // d[4j + q] at row 16 wl + (t >> 2) + 8 (q >> 1), channel 8j + 2 (t &
    // 3) + (q & 1)
    int d0[32], d1[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d0[i] = d1[i] = 0;
    for (int ks = 0; ks < KS; ++ks, ++it) {
      const int slot = it % kStages;
      mbar_wait(full + slot, (it / kStages) & 1);
      const int8_t* xt = reinterpret_cast<const int8_t*>(
          ring + slot * C::kStageBytes + wg * 64 * kBK);
      const int8_t* wt = reinterpret_cast<const int8_t*>(
          ring + slot * C::kStageBytes + C::kXBytes);
      lcw4::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int acc = ks > 0 || kk > 0;
        wgmma_s8_64x64(d0, sw128_desc(xt + 32 * kk),
                       sw128_desc(wt + 32 * kk), acc);
        wgmma_s8_64x64(d1, sw128_desc(xt + 32 * kk),
                       sw128_desc(wt + 64 * kBK + 32 * kk), acc);
      }
      lcw4::wgmma_commit();
      if (ks == 0 && pend) {  // the previous tile's rows, under these
        store_rows(false, pm0, pn, psc, pxs);
        pend = false;
      }
      if (ks > 0) {  // the previous stage's products are done with it
        lcw4::wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + (it - 1) % kStages);
        __syncwarp();
      }
    }
    lcw4::wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + (it - 1) % kStages);
    __syncwarp();
    lcw4::wgmma_hold(d0);
    lcw4::wgmma_hold(d1);
    wg_sync(wg);  // every row of the previous tile is stored
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wl + (lane >> 2) + 8 * h;
        const int c = 8 * j + 2 * (lane & 3);
        *reinterpret_cast<int2*>(so + out_swz(r, c)) =
            make_int2(d0[4 * j + 2 * h], d0[4 * j + 2 * h + 1]);
        *reinterpret_cast<int2*>(so + out_swz(r, c + 64)) =
            make_int2(d1[4 * j + 2 * h], d1[4 * j + 2 * h + 1]);
      }
    wg_sync(wg);
    pend = true;
    pm0 = m0;
    pn = n;
#pragma unroll
    for (int i = 0; i < 4; ++i) psc[i] = sc[i];
    pxs = xs_l;
  }
  if (pend) store_rows(false, pm0, pn, psc, pxs);
}

template <int kWG>
int launch(const void* xq, const void* xscale, const void* codes,
           const void* scales, const void* block_eid, void* out, int Mp,
           int N, int K, int E, int m_tile, cudaStream_t st) {
  using C = Cfg<kWG>;
  CUtensorMap xmap, wmap;
  int rc = lcw4::tensor_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, K,
                               Mp, K, kBK, C::kBM);
  if (rc == 0)  // codes as (E * N, K) rows
    rc = lcw4::tensor_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, K,
                             (uint64_t)E * N, K, kBK, kBN);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(w8a8_grouped_kernel<kWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int units = (Mp / C::kBM) * ((N + kBN - 1) / kBN);
  w8a8_grouped_kernel<kWG><<<min(units, sms), C::kThreads, C::kSmem, st>>>(
      xmap, wmap, (const float*)xscale, (const float*)scales,
      (const int32_t*)block_eid, (float*)out, Mp, N, K, E, m_tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// #10: xq (Mp, K) int8, xscale (Mp,) f32, codes (E, N, K) int8, scales
// (E, N) f32, block_eid (Mp / m_tile,) int32; out (Mp, N) f32;
// K % 16 == 0, m_tile % 64 == 0, Mp % m_tile == 0, Mp and N > 0; xq and
// codes 16-byte aligned.
int lc_w8a8_grouped(const void* xq, const void* xscale, const void* codes,
                    const void* scales, const void* block_eid, void* out,
                    int Mp, int N, int K, int E, int m_tile, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (m_tile % 128 == 0)
    return launch<2>(xq, xscale, codes, scales, block_eid, out, Mp, N, K, E,
                     m_tile, st);
  return launch<1>(xq, xscale, codes, scales, block_eid, out, Mp, N, K, E,
                   m_tile, st);
}

}  // extern "C"
