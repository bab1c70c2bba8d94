// Stacked-expert W4A8 matmul kernels of the MoE serving path for Hopper
// (sm_90a), CUDA C++ with a plain C interface bound from Python with ctypes
// (ops/_build.py, ops/moe_matmul.py).
//
// Weight layout: E experts of untiled planes, stacked.
//   wp  (E, N, K/8) int32: nibble j of word kw of row n holds code u of
//                          weight k = j*K/8 + kw (pack_int4_planes)
//   s   (E, N, G)   bf16 : per-group scale, G = K/128
//   zs  (E, N, G)   bf16 : premultiplied zero correction z*s
// Activations are int8 in natural K order with an f32 scale per row.
//
// Every output is computed in the float order of the TPU kernels
// (_w4a8_kernel_stacked / _gathered / _grouped in
// lightcompress_tpu/ops/pallas_matmul.py): with gpp = K/1024, for gi in
// 0..gpp-1 and then plane j in 0..7 (group g = j*gpp + gi), the exact
// integer group dot d times s[g] is added to accumulator j % 4; the zero
// correction corr = sum of xsum[g]*zs[g] runs over the same (gi, j) order;
// y = ((a0 + a1) + (a2 + a3) - corr) * xscale.  Every product and sum is
// rounded on its own (__fmul_rn/__fadd_rn: no contracted multiply-adds), so
// the plain PyTorch versions, which run the same sequence of f32 ops, agree
// bit for bit.
//
// Requirements checked by the Python wrappers: K % 1024 == 0,
// N % 128 == 0, contiguous 16-byte aligned tensors on the current device.
//
// #7 (the small-M stacked kernel) takes #6's inputs and keeps the TPU
// small-M kernel's order instead: per group-block gi one f32 dot of x (int8,
// exact as bf16) with the bf16-rounded weights u*s, added to one
// accumulator; the zero correction and xscale after the loop.  Its dots sum
// inside the bf16 tensor cores, so it matches its plain version to f32
// rounding, not bit for bit.
//
// Bounds on an H100 SXM (3.35 TB/s HBM, 1979 TOP/s int8 dense peak):
//   #6, #7 stacked (B <= 256): the packed weight of all E experts read
//      once, bytes = E*(N*K/2 + 4*N*G) + x + out;
//   #8 gathered: the packed weights of the distinct experts selected
//      (memory);
//   #9 grouped: at a prefill's Mp rows the 2*rows*N*K int8 operations.
// #6 below STACKED_TILE_MIN_B rows (ops/moe_matmul.py) uses no tensor
// cores (__dp4a on the CUDA cores); #8 runs on the int8 tensor cores
// (mma.sync) in #2's planes decode tile (w4_planes_decode.cuh); #7 on
// the bf16 tensor cores (mma.sync) in #1's tile (w4_bf16_tile.cuh); #9,
// and #6 from STACKED_TILE_MIN_B rows on, run on the int8 tensor cores
// (wgmma) over TMA-fed stages, in the planes tile they share with #3
// (w4_planes_wgmma.cuh).

#include "w4_bf16_tile.cuh"
#include "w4_planes_decode.cuh"

namespace {

using namespace lcw4;

constexpr int kMoeThreads = 128;  // one output channel per thread
constexpr int kStackedRows = 8;   // rows of x per #6 block

// ((a0 + a1) + (a2 + a3) - corr) * xs, each op rounded.
__device__ __forceinline__ float finish(float a0, float a1, float a2,
                                        float a3, float corr, float xs) {
  return __fmul_rn(__fsub_rn(__fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3)),
                             corr),
                   xs);
}

// ---------------------------------------------------------------------------
// The decode block of #6: rows [0, nv) of x (row r at xrow0 + r*K,
// its act scale at xs0[r]) against one expert's weight; output row r at
// out0 + r*N.  Thread t owns channel n = blockIdx.x*128 + t and walks the
// whole of K in the TPU order, so each output's sums run in one thread.
// Per gi the block stages the MT rows' eight 128-byte groups of that gi (one
// per plane; MT KB of shared memory) and their sums, then every thread reads
// its own 512 bytes of codes (16 B a load) and finishes the eight group dots
// with __dp4a.  Design against the bound (the weight read): 128 channels a
// block, so a 14336-channel expert spreads over 112 blocks, and each lane's
// 16-byte loads walk its row; x is re-read from L2 by every block.
// ---------------------------------------------------------------------------
template <int MT>
__device__ __forceinline__ void expert_rows(
    const int8_t* __restrict__ xrow0, const float* __restrict__ xs0,
    const int32_t* __restrict__ wp_e, const __nv_bfloat16* __restrict__ s_e,
    const __nv_bfloat16* __restrict__ zs_e, float* __restrict__ out0, int nv,
    int N, int K) {
  __shared__ __align__(16) int8_t xc[MT * 8 * kGroup];
  __shared__ float xsc[MT * 8];
  const int tid = threadIdx.x;
  const int kp = K / 8, G = K / kGroup, gpp = kp / kGroup;
  const int n = blockIdx.x * kMoeThreads + tid;

  float acc[4][MT], corr[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    corr[m] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[p][m] = 0.f;
  }
  const int32_t* wrow = wp_e + (size_t)n * kp;
  for (int gi = 0; gi < gpp; ++gi) {
    __syncthreads();  // every thread is done with the previous chunk
    // xc[m][j][0..128) = x row m, plane j, group gi (natural K offset
    // j*kp + gi*128); 16 bytes a thread a step; absent rows are zeros
    for (int i = tid; i < MT * 64; i += kMoeThreads) {
      const int m = i >> 6, j = (i >> 3) & 7, q = i & 7;
      int4 v = make_int4(0, 0, 0, 0);
      if (m < nv)
        v = *reinterpret_cast<const int4*>(xrow0 + (size_t)m * K + j * kp +
                                           gi * kGroup + q * 16);
      reinterpret_cast<int4*>(xc)[i] = v;
    }
    __syncthreads();
    if (tid < MT * 8) {
      const int* p = reinterpret_cast<const int*>(xc + tid * kGroup);
      int a = 0;
      for (int q = 0; q < kGroup / 4; ++q) a = __dp4a(p[q], 0x01010101, a);
      xsc[tid] = (float)a;
    }
    __syncthreads();

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
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int xv =
              *reinterpret_cast<const int*>(xc + (m * 8 + j) * kGroup + 4 * c);
          dot[j][m] = __dp4a(packed, xv, dot[j][m]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int g = j * gpp + gi;
      const float sf = __bfloat162float(s_e[(size_t)n * G + g]);
      const float zf = __bfloat162float(zs_e[(size_t)n * G + g]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[j & 3][m] = mac_rn(acc[j & 3][m], (float)dot[j][m], sf);
        corr[m] = mac_rn(corr[m], xsc[m * 8 + j], zf);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
    if (m < nv)
      out0[(size_t)m * N + n] =
          finish(acc[0][m], acc[1][m], acc[2][m], acc[3][m], corr[m], xs0[m]);
}

// ---------------------------------------------------------------------------
// #6  Stacked-expert W4A8 matmul.  Replaces lightcompress_tpu/ops/
// pallas_matmul.py w4a8_stacked_matmul (_w4a8_kernel_stacked).
//
// out[e, b, :] = x_e[b] . W[e]^T for every expert e, B <= 256 rows.  With
// pair = 0 every expert reads the same x (B, K) (gate/up); with pair = 1
// expert e reads its own rows x[e] (E, B, K) (the down projection).  Two
// bodies, chosen by B alone (stacked_body in ops/moe_matmul.py):
//   * the decode block below (the wrapper sends B < STACKED_TILE_MIN_B
//     here): grid (N/128, ceil(B/8), E), the TPU grid's expert and N-tile
//     axes plus 8-row chunks of B, a lane per channel on __dp4a.  Bound:
//     every expert's packed weight, read once;
//   * the planes tile (lc_w4a8_stacked_tile): a block takes 64 rows of one
//     expert (the kRowsStacked / kRowsPair mappings of
//     w4_planes_wgmma.cuh), 128 channels, on wgmma; one launch, x never
//     copied per expert.  Bound: the int8 operations of E * B rows (a
//     tile pads B to a multiple of 64) beside the weight read.
// Both equal w4a8_stacked_matmul_plain bit for bit.
// ---------------------------------------------------------------------------
template <int MT>
__global__ void __launch_bounds__(kMoeThreads)
w4a8_stacked_kernel(const int8_t* __restrict__ x,
                    const float* __restrict__ xscale,
                    const int32_t* __restrict__ wp,
                    const __nv_bfloat16* __restrict__ s,
                    const __nv_bfloat16* __restrict__ zs,
                    float* __restrict__ out, int pair, int B, int N, int K) {
  const int e = blockIdx.z, m0 = blockIdx.y * MT;
  const size_t G = K / kGroup, kp = K / 8;
  const size_t xrow = pair ? (size_t)e * B + m0 : (size_t)m0;
  expert_rows<MT>(x + xrow * K, xscale + xrow, wp + (size_t)e * N * kp,
                  s + (size_t)e * N * G, zs + (size_t)e * N * G,
                  out + ((size_t)e * B + m0) * N, min(MT, B - m0), N, K);
}

// ---------------------------------------------------------------------------
// #7  Small-M stacked-expert W4A8 matmul.  Replaces lightcompress_tpu/ops/
// pallas_matmul.py w4a8_stacked_matmul_smallm (_w4a8_kernel_stacked_bf16).
//
// #6's inputs and pair mode, the TPU small-M kernel's function: per expert
// and group block gi, the dot of x's 8 groups j*gpp + gi (int8, exact in
// bf16) with the weights bf16(u * s_j), summed in f32 and added to one
// accumulator; the zero correction sums xsum*zs in (gi, j) order; y = (acc
// - corr) * xscale.  Bound on an H100 SXM: every expert's packed weight,
// read once (E*(N*K/2 + 4*N*G) bytes).  The design: #1's bf16 tensor-core
// tile (w4a16_tile.cu) with an expert grid dimension:
//   * mma.sync m16n8k16 bf16, 16 channels as A (a warp's m16 tile, 4 warps,
//     64 channels a block) and 8 tokens as B (NT n8 tiles: 8, 16 or 32
//     tokens a block; more rows are a grid dimension of 32-row chunks).
//     The A registers come from the planes words in registers (byte_pair,
//     code_pair), each bf16x2 then multiplied by its channel's {s_j, s_j}
//     in one rounded bf16x2 product: bf16(u * s_j), the TPU's rounding.
//   * Per gi the block copies its 64 rows' word block (32 KB) by cp.async
//     in #1's swizzle, and meanwhile loads its rows' int8 x of the gi's 8
//     groups (x[e] in pair mode), turns it into bf16 exactly and stores it
//     as #1's x slab, with the groups' integer sums (__dp4a, then a
//     butterfly over the 8 lanes of a group row).  One slot a block (48
//     KB at 8 tokens): four blocks an SM, the copies of one under the
//     products of another.
//   * The tensor core sums a gi's 1024 products in four chains (planes j
//     mod 4 of both bytes halves), added as (d0 + d1) + (d2 + d3) and then
//     once into the accumulator; the dot's order inside the tensor core is
//     not IEEE-sequential, so the gate is 1e-5 of max|y| against the plain
//     version (expert_rows_smallm_plain).
// Grid (ceil(B / 8 NT), N / 64, E): Qwen3-30B-A3B's gate or up (E 128, N
// 768) is 1536 blocks, Mixtral-8x7B's down in pair mode (E 8, N 4096) 512.
// ---------------------------------------------------------------------------
constexpr int kSmallmWarps = 4;
constexpr int kSmallmThreads = kSmallmWarps * 32;
constexpr int kSmallmChan = kSmallmWarps * 16;         // 64 channels a block
constexpr int kSmallmWords = kSmallmChan * kWordRow;   // 32 KB

template <int NT>
__global__ void __launch_bounds__(kSmallmThreads, NT == 1 ? 4 : 2)
w4a8_stacked_smallm_tile_kernel(const int8_t* __restrict__ x,
                                const float* __restrict__ xscale,
                                const int32_t* __restrict__ wp,
                                const __nv_bfloat16* __restrict__ s,
                                const __nv_bfloat16* __restrict__ zs,
                                float* __restrict__ out, int pair, int B,
                                int N, int K) {
  constexpr int TB = 8 * NT;          // tokens a block
  constexpr int kXRow = kGroup * 2;   // bytes of a token's bf16 plane row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  unsigned char* xs = smem + kSmallmWords;  // the x slab [8][TB][256 B]
  float* xsum_sh = reinterpret_cast<float*>(xs + 8 * TB * kXRow);
  const int kp = K / 8, G = K / kGroup, gpp = kp / kGroup;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * TB, nv = min(TB, B - m0);
  const int n0 = blockIdx.y * kSmallmChan, e = blockIdx.z;
  const size_t xrow = pair ? (size_t)e * B + m0 : (size_t)m0;
  const int8_t* x0 = x + xrow * K;
  const int32_t* wblk = wp + ((size_t)e * N + n0) * kp;
  // the lane's channels n0 + 16 warp + g and + 8 (N % 128 == 0)
  const size_t srow0 = ((size_t)e * N + n0 + 16 * warp + g) * G;
  const size_t srow1 = srow0 + (size_t)8 * G;

  // a thread's outputs, n8 tile nt, element q: channel 16 warp + g + 8 (q
  // >> 1) of the block, token 8 nt + 2t + (q & 1)
  float acc[NT][4], corr[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = corr[nt][q] = 0.f;

  for (int gi = 0; gi < gpp; ++gi) {
    __syncthreads();  // every warp is done with the words and slab of gi - 1
    // the word block of gi (row c: 512 bytes, chunk q at q ^ 4 (c & 1))
    for (int i = tid; i < kSmallmChan * 32; i += kSmallmThreads) {
      const int c = i >> 5, q = i & 31;
      cp_async16(smem + c * kWordRow + ((q ^ ((c & 1) << 2)) << 4),
                 wblk + (size_t)c * kp + gi * kGroup + 4 * q, true);
    }
    cp_async_commit();
    // the gi's scales (bf16x2 {s, s}) and zero corrections of the lane's
    // two channels
    uint32_t sv[8][2];
    float zv[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t o = (size_t)j * gpp + gi;
      const uint32_t a = __bfloat16_as_ushort(s[srow0 + o]);
      const uint32_t b = __bfloat16_as_ushort(s[srow1 + o]);
      sv[j][0] = a | (a << 16);
      sv[j][1] = b | (b << 16);
      zv[j][0] = __bfloat162float(zs[srow0 + o]);
      zv[j][1] = __bfloat162float(zs[srow1 + o]);
    }
    // the x slab of gi (plane j, token r: 256 bytes, chunk c at c ^ (r &
    // 7)) from 16-byte chunks of int8 x; item i: row i >> 3 = j TB + r, 16
    // values 16 (i & 7) .. of the row's group; the 8 items of a row are 8
    // neighbouring lanes, which sum the group.  Rows past B are zeros
#pragma unroll 1
    for (int i0 = 0; i0 < 64 * TB; i0 += 4 * kSmallmThreads) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kSmallmThreads + tid, row = i >> 3;
        const int j = row / TB, r = row % TB;
        v[u] = r < nv ? __ldg(reinterpret_cast<const int4*>(
                            x0 + (size_t)r * K + j * kp + gi * kGroup +
                            16 * (i & 7)))
                      : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kSmallmThreads + tid, row = i >> 3;
        const int r = row % TB, c = 2 * (i & 7);
        const int w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        uint32_t b[8];
        int sum = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          b[2 * q] = i8_pair_bf16((int8_t)w[q], (int8_t)(w[q] >> 8));
          b[2 * q + 1] =
              i8_pair_bf16((int8_t)(w[q] >> 16), (int8_t)(w[q] >> 24));
          sum = __dp4a(w[q], 0x01010101, sum);
        }
        unsigned char* dst = xs + row * kXRow;
        *reinterpret_cast<uint4*>(dst + ((c ^ (r & 7)) << 4)) =
            make_uint4(b[0], b[1], b[2], b[3]);
        *reinterpret_cast<uint4*>(dst + (((c + 1) ^ (r & 7)) << 4)) =
            make_uint4(b[4], b[5], b[6], b[7]);
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if ((i & 7) == 0) xsum_sh[row] = (float)sum;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the words and the slab of gi, for every thread

    // the zero correction of gi, plane by plane
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* xq = xsum_sh + j * TB + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          corr[nt][q] =
              mac_rn(corr[nt][q], xq[8 * nt + (q & 1)], zv[j][q >> 1]);
    }

    const unsigned char* wrow = smem + (16 * warp + g) * kWordRow;
    const unsigned char* wrow8 = wrow + 8 * kWordRow;
    const int sw = (g & 1) << 2;  // rows g and g + 8: one parity
    float d[4][NT][4];  // chain p: planes j = 4h + p
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[p][nt][q] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // planes 4h .. 4h + 3: bytes 2h, 2h + 1
#pragma unroll 2
      for (int kk = 0; kk < 8; ++kk) {
        const int q = 4 * kk + t;  // the chunk of words 16 kk + 4t .. + 3
        const uint4 wa =
            *reinterpret_cast<const uint4*>(wrow + ((q ^ sw) << 4));
        const uint4 wb =
            *reinterpret_cast<const uint4*>(wrow8 + ((q ^ sw) << 4));
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const int b = 2 * h + bb;
          // a0: row g, logical k 2t, 2t + 1 (words 0, 1); a1: row g + 8;
          // a2: row g, k 2t + 8, 2t + 9 (words 2, 3); a3: row g + 8
          const uint32_t pr[4] = {byte_pair(wa.x, wa.y, b),
                                  byte_pair(wb.x, wb.y, b),
                                  byte_pair(wa.z, wa.w, b),
                                  byte_pair(wb.z, wb.w, b)};
#pragma unroll
          for (int nib = 0; nib < 2; ++nib) {
            const int p = 2 * bb + nib, j = 4 * h + p;
            uint32_t a[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              a[r] = bf16x2_mul(code_pair<false>(pr[r], nib), sv[j][r & 1]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              // token 8 nt + g, plane j, physical k 16 kk + 4t .. + 3
              const int r = 8 * nt + g;
              const uint2 bv = *reinterpret_cast<const uint2*>(
                  xs + (j * TB + r) * kXRow +
                  (((2 * kk + (t >> 1)) ^ (r & 7)) << 4) + 8 * (t & 1));
              mma_bf16(d[p][nt], a, bv.x, bv.y);
            }
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[nt][q] = __fadd_rn(
            acc[nt][q], __fadd_rn(__fadd_rn(d[0][nt][q], d[1][nt][q]),
                                  __fadd_rn(d[2][nt][q], d[3][nt][q])));
  }
  const int n = n0 + 16 * warp + g;
  float* out0 = out + ((size_t)e * B + m0) * N + n;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 8 * nt + 2 * t + (q & 1);
      if (r < nv)
        out0[(size_t)r * N + 8 * (q >> 1)] = __fmul_rn(
            __fsub_rn(acc[nt][q], corr[nt][q]), xscale[xrow + r]);
    }
}

template <int NT>
int launch_smallm(const void* x, const void* xscale, const void* wp,
                  const void* s, const void* zs, void* out, int pair, int B,
                  int N, int K, int E, void* stream) {
  constexpr int TB = 8 * NT;
  const size_t smem = 128 + kSmallmWords + (size_t)8 * TB * kGroup * 2 +
                      (size_t)8 * TB * 4;
  auto kern = w4a8_stacked_smallm_tile_kernel<NT>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + TB - 1) / TB, N / kSmallmChan, E);
  kern<<<grid, kSmallmThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)x, (const float*)xscale, (const int32_t*)wp,
      (const __nv_bfloat16*)s, (const __nv_bfloat16*)zs, (float*)out, pair,
      B, N, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// #8  Expert-gathered W4A8 matmul.  Replaces lightcompress_tpu/ops/
// pallas_matmul.py w4a8_gathered_matmul (_w4a8_kernel_gathered).
//
// out[s] = x[t_idx[s]] . W[e_idx[s]]^T.  The TPU prefetches the index
// vectors as scalars for its BlockSpec maps and replicates the token row to
// 8 sublanes, one selection a grid step, so selections that share an expert
// read its weight again.  Bound on an H100 SXM: the packed weights of the
// distinct experts selected (memory).  Here the planes decode tile of #2
// (w4_planes_decode.cuh, mma.sync m16n8k32 on the int8 tensor cores) with
// gathered rows: grid (n_sel, N / C); block (s, c) reads e_idx and t_idx on
// the device and works only where s leads its expert's tile (the first of
// every 16 valid selections of the expert, gather_tile); its tile's rows
// are those selections' x rows, copied by index straight into the staged
// x tile, and its outputs go to their rows.  So each distinct expert's
// weight streams from HBM once a call, and no host sync or torch gather
// runs.  A selection with an index out of range fills its row with NaN.
// C = 32 channels a block: the down (N 4096, K 14336) at one token puts 256
// CTAs on the 132 SMs, two an SM at once, and 32 channels read 1.5-1.65x
// faster than 16 at the down on the H100 (16 puts twice the blocks on the
// SMs but reads half the bytes a word block).
// The float order is #2's, the TPU kernel's, so the result equals
// w4a8_gathered_matmul_plain bit for bit.
// ---------------------------------------------------------------------------
int launch_gathered(const void* x, const void* xscale, const void* wp,
                    const void* s, const void* zs, const void* e_idx,
                    const void* t_idx, void* out, int n_rows, int n_sel,
                    int N, int K, int E, void* stream) {
  constexpr int NT = 4;  // 32 channels a block
  if (n_sel < 1 || K % (8 * kGroup) || N % (8 * NT))
    return (int)cudaErrorInvalidValue;
  const GatherIdx gx = {(const int32_t*)e_idx, (const int32_t*)t_idx, E,
                        n_rows};
  return launch_decode_mt<NT, 16, int8_t, float, true>(
      (const int8_t*)x, xscale, wp, s, zs, (float*)out, nullptr, nullptr,
      n_sel, N, K, 0, 0.f, stream, gx);
}

}  // namespace

extern "C" {

// #6: x (B, K) int8 (pair = 0) or (E, B, K) (pair = 1), xscale (B,) or
// (E, B) f32; out (E, B, N) f32.
int lc_w4a8_stacked(const void* x, const void* xscale, const void* wp,
                    const void* s, const void* zs, void* out, int pair, int B,
                    int N, int K, int E, void* stream) {
  const dim3 grid(N / kMoeThreads, (B + kStackedRows - 1) / kStackedRows, E);
  w4a8_stacked_kernel<kStackedRows>
      <<<grid, kMoeThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          (const int8_t*)x, (const float*)xscale, (const int32_t*)wp,
          (const __nv_bfloat16*)s, (const __nv_bfloat16*)zs, (float*)out,
          pair, B, N, K);
  return (int)cudaGetLastError();
}

// #6 on the planes tile: #6's arguments, and xsum_g null or the int16
// row-sum scratch of launch_planes_wgmma (K > 49152: 64 * K / 128 values
// for each of E * ceil(B / 64) row tiles).
int lc_w4a8_stacked_tile(const void* x, const void* xscale, const void* wp,
                         const void* s, const void* zs, void* xsum_g,
                         void* out, int pair, int B, int N, int K, int E,
                         void* stream) {
  if (pair)
    return launch_planes_wgmma<float, kRowsPair>(
        x, xscale, wp, s, zs, nullptr, xsum_g, (float*)out, B, N, K, E, 0,
        stream);
  return launch_planes_wgmma<float, kRowsStacked>(
      x, xscale, wp, s, zs, nullptr, xsum_g, (float*)out, B, N, K, E, 0,
      stream);
}

// #7: #6's arguments; the 8-, 16- or 32-token tile by B (more rows are
// chunks of 32).
int lc_w4a8_stacked_smallm(const void* x, const void* xscale, const void* wp,
                           const void* s, const void* zs, void* out, int pair,
                           int B, int N, int K, int E, void* stream) {
  if (B <= 8)
    return launch_smallm<1>(x, xscale, wp, s, zs, out, pair, B, N, K, E,
                            stream);
  if (B <= 16)
    return launch_smallm<2>(x, xscale, wp, s, zs, out, pair, B, N, K, E,
                            stream);
  return launch_smallm<4>(x, xscale, wp, s, zs, out, pair, B, N, K, E,
                          stream);
}

// #8: x (n_rows, K) int8, xscale (n_rows,) f32, e_idx/t_idx (n_sel,) int32;
// out (n_sel, N) f32.
int lc_w4a8_gathered(const void* x, const void* xscale, const void* wp,
                     const void* s, const void* zs, const void* e_idx,
                     const void* t_idx, void* out, int n_rows, int n_sel,
                     int N, int K, int E, void* stream) {
  return launch_gathered(x, xscale, wp, s, zs, e_idx, t_idx, out, n_rows,
                         n_sel, N, K, E, stream);
}

// ---------------------------------------------------------------------------
// #9  Capacity-grouped W4A8 matmul.  Replaces lightcompress_tpu/ops/
// pallas_matmul.py w4a8_grouped_matmul (_w4a8_kernel_grouped,
// _xsum_slab_order).
//
// out[r] = x[r] . W[block_eid[r / m_tile]]^T over expert-sorted rows padded
// to m_tile segments (moe_group_selections), on the planes tile of
// w4_planes_wgmma.cuh (wgmma on TMA-fed tiles, shared with #3): a block's
// 64 rows lie in one expert's segment, whose id it reads itself (an id out
// of range fills the tile with NaN).  Padding rows are the zero dummy row
// with scale 1: they are computed like any other (they give 0) and the
// caller drops them on the unsort.  The TPU kernel permutes its row sums to
// the scale slab's order with a one-hot matmul (a Mosaic workaround); here
// x stays in natural order.  Bound: the int8 operations of the Mp rows and
// the f32 epilogue of every (output, group).
// ---------------------------------------------------------------------------
// x (Mp, K) int8, xscale (Mp,) f32, block_eid (Mp / m_tile,) int32;
// out (Mp, N) f32; m_tile % 64 == 0, Mp % m_tile == 0, K % 1024 == 0,
// N % 128 == 0; xsum_g null or the int16 row-sum scratch of
// launch_planes_wgmma (K > 49152).
int lc_w4a8_grouped(const void* x, const void* xscale, const void* wp,
                    const void* s, const void* zs, const void* block_eid,
                    void* xsum_g, void* out, int Mp, int N, int K, int E,
                    int m_tile, void* stream) {
  return launch_planes_wgmma(x, xscale, wp, s, zs, block_eid, xsum_g,
                             (float*)out, Mp, N, K, E, m_tile, stream);
}

}  // extern "C"
