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
// with the exact integer group dot finished before the scale is applied.
//
// Requirements checked by the Python wrappers: K % 1024 == 0, N % 64 == 0
// (#3, and #2 from PLANES_TILE_MIN_M rows: N % 128 == 0), contiguous
// tensors on the current device.  #2 below PLANES_TILE_MIN_M rows and #14
// run on the planes decode tile below; #3 (and #2 from PLANES_TILE_MIN_M
// rows) on the planes tile of w4_planes_wgmma.cuh, shared with #9 and #6.
//
// Bounds on an H100 SXM (3.35 TB/s HBM, 1979 TOP/s int8 dense tensor-core
// peak): max(bytes / 3.35 TB/s, 2*M*N*K / 1979 TOP/s), bytes = N*K/2 +
// 4*N*G + M*K*b_x + M*N*b_out: in decode (a few rows) the packed weight
// read, at M 1024 the int8 operations.

#include "w4_planes_wgmma.cuh"

namespace {

using namespace lcw4;

// ---------------------------------------------------------------------------
// The planes decode tile: #2 W4A8 decode (XT = int8_t: pre-quantized rows and
// their scales; OutT f32 or bf16).  Replaces lightcompress_tpu/ops/
// pallas_matmul.py w4a8_matmul_planes (_w4a8_kernel_fullk_combined,
// _w4a8_kernel_fullk) below PLANES_TILE_MIN_M rows.  And #14, the fused
// decode linear (XT = OutT = bf16 or f32 x, the prologue in the kernel).
// Replaces w4a8_linear_planes_fused (_w4a8_kernel_fullk_fused).
//
// Float order, each its TPU kernel's, bit for bit: for gi, then plane j
// (group g = j*gpp + gi), f32(x_g . u_g) * s_g into accumulator j % 4 (the
// product and the sum each rounded); then (a0 + a1) + (a2 + a3); then
//   #2:  minus corr = the sum of xsum_g * zs_g in (gi, j) order, times the
//        row's act scale: w4a8_rows_tpu_order (ops/w4_matmul.py), the bits
//        of #3's planes tile too, so the two bodies of #2 agree;
//   #14: minus each plane's correction sum_gi xsum * zs in plane order,
//        times the act scale of the prologue, stored in x's type:
//        _phase_dot's order (w4a8_rows_phase_dot on the kernel's own act
//        codes and scales), as #15 and #16.
// Both corrections are the epilogue of w4_mma.cuh minus_corrections, shared
// with layer_fused.cu.  #14's prologue is #13's (w4_common.cuh
// fused_row_scales, quantize8): per row ss = sum(x * x) and am = max|x|
// in one fixed order, r = rsqrt(ss / K + eps) with rms, sc = max(am * r,
// 1e-8) / 127, codes rint(x * r / sc), divided where near a tie.
//
// Bound: the packed weight read (memory), N*K/2 bytes at a few rows.  The
// design, #13's decode tile on the planes words:
//   * A block takes C = 8 NT channels (NT n8 tiles) and MT = 16 or 32 rows
//     (one or two m16 tiles of mma.sync m16n8k32 s8 x s8 -> s32); more rows
//     are a grid dimension of row chunks (innermost, so the chunks of a
//     channel tile share its words in the L2).  No K split: a split whose
//     f32 parts were added could not keep the sequential accumulators.  Its
//     8 warps are NT n8 tiles x Q = 8 / NT plane classes: warp (ct, q)
//     multiplies the planes j = q (mod Q) of every word block, so it holds
//     the accumulators a_r, r = q (mod Q), of its outputs, each over its
//     own sequence (Q = 2: a_q of planes q, q + 4 and a_{q+2} of q + 2,
//     q + 6; Q = 4: a_q of planes q, q + 4).  NT = 4 (32 channels) for #14,
//     whose every block quantizes its rows once; #2 takes 16 channels
//     (NT = 2, Q = 4) up to N 2048 (k and v: more blocks to fill the SMs),
//     32 above, as measured faster on the H100 (decode_chan,
//     ops/w4_matmul.py).
//   * One barrier a word block gi.  Words: the block's rows of word block
//     gi (512 bytes a channel, all eight planes of groups j*gpp + gi) stream
//     through a ring of cp.async slots (#2 one block ahead, #14 two); a
//     lane (g, t) reads 16 bytes at words 4t and 16 + 4t of a
//     k step and unpacks all eight planes' B fragments in registers
//     (planes_b_frags), of which it multiplies its class's.  x: the eight
//     planes' 128 columns of gi for the block's rows, in the 128-byte
//     swizzle, read by ldmatrix (decode_a_frag); #2 copies it by cp.async
//     one block ahead (zeros past M), #14 quantizes it right after the
//     barrier of gi - 1, beside gi - 1's products, from values loaded into
//     registers one block before.  The block's s and zs (all G groups) sit
//     in shared memory, channel-minor.
//   * The group sums: #2's from the staged tile (a thread a plane and row),
//     #14's from the codes (half-warp reductions); all G of them stay in
//     shared memory for the epilogue.
//   * The epilogue: the warps hand their accumulators over through shared
//     memory (the word ring); then every thread finishes outputs of one row
//     and consecutive channels: (a0 + a1) + (a2 + a3), the corrections over
//     all G groups, the act scale, the store in OutT (a bf16 output rounded
//     to nearest even, as torch's .to(bf16)).  Rows past M are never
//     stored.
// ---------------------------------------------------------------------------
constexpr int kPdWarps = 8;
constexpr int kPdThreads = kPdWarps * 32;
// word blocks in the ring: #2 copies its x and words one block ahead (two
// slots each; deeper rings measured no faster on the H100), #14 its words
// two ahead (its x comes from registers loaded a block earlier still)
constexpr int kPdSlots2 = 2;
constexpr int kPdSlots14 = 3;

// b[Q * i + q][e] for a warp's class q (runtime) without indexing the
// register array by it
template <int Q>
__device__ __forceinline__ int class_frag(const int (&b)[8][2], int i, int q,
                                          int e) {
  int v = b[Q * i][e];
#pragma unroll
  for (int r = 1; r < Q; ++r)
    if (q == r) v = b[Q * i + r][e];
  return v;
}

// two blocks an SM in 16-row tiles of int8 or bf16 x, one for 32-row tiles
// or f32 x, whose prefetched values would not fit in 128 registers a thread
template <int NT, int MT, typename XT, typename OutT>
__global__ void __launch_bounds__(kPdThreads,
                                  MT == 16 && sizeof(XT) <= 2 ? 2 : 1)
planes_decode_kernel(const XT* __restrict__ x,
                     const float* __restrict__ xscale,
                     const int32_t* __restrict__ wp,
                     const __nv_bfloat16* __restrict__ s,
                     const __nv_bfloat16* __restrict__ zs,
                     OutT* __restrict__ out, int8_t* __restrict__ act_out,
                     float* __restrict__ scale_out, int M, int N, int K,
                     int rms, float eps) {
  constexpr bool kFused = !std::is_same<XT, int8_t>::value;
  constexpr int C = 8 * NT;           // channels a block
  constexpr int Q = kPdWarps / NT;    // plane classes: warps an n8 tile
  constexpr int PW = 8 / Q;           // planes a warp
  constexpr int AW = 4 / Q;           // accumulators a warp
  constexpr int MI = MT / 16;         // m16 tiles
  constexpr int kStageX = 8 * MT * kTileRow;
  constexpr int WS = kFused ? kPdSlots14 : kPdSlots2;  // word slots
  constexpr int XS = kFused ? 2 : WS;      // x slots
  static_assert(Q == 2 || Q == 4, "a plane class holds whole accumulators");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled tiles need 128-byte aligned bases
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int kp = K / 8, G = K / kGroup, gpp = kp / kGroup;
  int8_t* wbuf = reinterpret_cast<int8_t*>(smem);        // [WS][C][512]
  int8_t* xbuf = wbuf + WS * C * kWordRow;               // [XS][8][MT][128]
  __nv_bfloat16* s_sh =
      reinterpret_cast<__nv_bfloat16*>(xbuf + XS * kStageX);  // [G][C]
  __nv_bfloat16* zs_sh = s_sh + G * C;                        // [G][C]
  int* xsum_sh = reinterpret_cast<int*>(zs_sh + G * C);       // [G][MT]
  float* row_sh = reinterpret_cast<float*>(xsum_sh + G * MT);  // [3][MT]
  float* st_sh = row_sh + 3 * MT;                       // [MT][8 warps][2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ct = warp % NT, q = warp / NT;
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * C;
  const int mv = min(MT, M - m0);
  const bool two = MI == 2 && mv > 16;  // the second m16 tile holds rows
  const bool exporter = kFused && act_out != nullptr && blockIdx.y == 0;

  // word block gi of the block's channels into slot gi % WS: row c (512
  // bytes), 16-byte chunk k at k ^ 4 (c & 1), so that the lanes' reads
  // below hit distinct banks; nothing past gpp
  auto stage_w = [&](int gi) {
    if (gi < gpp) {
      int8_t* dst = wbuf + (gi % WS) * C * kWordRow;
      for (int i = tid; i < C * 32; i += kPdThreads) {
        const int c = i >> 5, k = i & 31;
        cp_async16(dst + c * kWordRow + ((k ^ ((c & 1) << 2)) << 4),
                   wp + (size_t)(n0 + c) * kp + gi * kGroup + 4 * k, true);
      }
    }
  };
  // #2: the x of gi (plane j's columns j*kp + gi*128 + [0, 128) of the
  // block's rows) into slot gi % XS, plane tile j, row r at swz(r, c);
  // zeros past M; nothing past gpp
  auto stage_x = [&](int gi) {
    if (gi < gpp) {
      int8_t* dst = xbuf + (gi % XS) * kStageX;
      for (int i = tid; i < 8 * MT * 8; i += kPdThreads) {
        const int j = i / (8 * MT), r = (i >> 3) % MT, c = i & 7;
        const bool ok = r < mv;
        const int8_t* src = reinterpret_cast<const int8_t*>(x) +
                            (ok ? (size_t)(m0 + r) * K + j * kp +
                                      gi * kGroup + 16 * c
                                : 0);
        cp_async16(dst + j * MT * kTileRow + swz(r, c), src, ok);
      }
    }
  };

  // #14: thread (row r = tid / 16 + 16 k, chunk c16 = tid % 16) quantizes
  // values 8 c16 .. + 7 of each plane's 128 columns of gi; raw holds them,
  // loaded one word block ahead (nothing past M)
  constexpr int RPT = MT / 16;                             // rows a thread
  constexpr int kWords = kFused ? 2 * (int)sizeof(XT) : 1;  // x words a chunk
  using Raw = uint32_t[RPT][8][kWords];
  Raw raw;
  const int c16 = tid & 15;
  auto load_raw = [&](int gi) {
    if constexpr (kFused) {
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = (tid >> 4) + 16 * k;
        if (r >= mv) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint4* src = reinterpret_cast<const uint4*>(
              x + (size_t)(m0 + r) * K + j * kp + gi * kGroup + 8 * c16);
#pragma unroll
          for (int v = 0; v < kWords / 4; ++v) {
            const uint4 w4 = __ldg(src + v);
            raw[k][j][4 * v] = w4.x;
            raw[k][j][4 * v + 1] = w4.y;
            raw[k][j][4 * v + 2] = w4.z;
            raw[k][j][4 * v + 3] = w4.w;
          }
        }
      }
    }
  };

  // the block's s and zs, channel-minor ([G][C]): 16 bytes (8 groups of a
  // channel) a load
  auto load_scales = [&]() {
    for (int i = tid; i < 2 * C * (G / 8); i += kPdThreads) {
      const bool z = i >= C * (G / 8);
      const int w = z ? i - C * (G / 8) : i;
      const int c = w % C, g8 = w / C;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          (z ? zs : s) + (size_t)(n0 + c) * G + 8 * g8));
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      __nv_bfloat16* dst = (z ? zs_sh : s_sh) + 8 * g8 * C + c;
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[k * C] = e[k];
    }
  };

  float q_rr[RPT], q_sc[RPT], q_inv[RPT];
  // one cp.async group a word block: its words (#2: and its x)
  if constexpr (kFused) {
#pragma unroll
    for (int k = 0; k < WS - 1; ++k) {
      stage_w(k);
      cp_async_commit();
    }
    load_scales();
    load_raw(0);
    fused_row_scales<XT, MT, kPdWarps>(x, K, m0, mv, rms, eps, st_sh, row_sh,
                                       exporter ? scale_out : nullptr);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = min((tid >> 4) + 16 * k, MT - 1);
      q_rr[k] = row_sh[r];
      q_sc[k] = row_sh[MT + r];
      q_inv[k] = row_sh[2 * MT + r];
    }
  } else {
#pragma unroll
    for (int k = 0; k < WS - 1; ++k) {
      stage_x(k);
      stage_w(k);
      cp_async_commit();
    }
    load_scales();
    if (tid < mv) row_sh[MT + tid] = xscale[m0 + tid];
  }

  // #14: the codes of gi into x slot gi & 1 and their group sums (lanes
  // 0-15 hold one row's chunks, 16-31 the next row's).  A warp whose rows
  // all lie past M skips; a half-warp past M stores zeros and no sum
  auto quantize = [&](int gi) {
    if constexpr (kFused) {
      int8_t* xt = xbuf + (gi & 1) * kStageX;
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = (tid >> 4) + 16 * k;
        if (r - (lane >> 4) >= mv) continue;  // uniform over the warp
        const bool live = r < mv;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t lo = 0, hi = 0;
          int sum = 0;
          if (live)
            sum = quantize8<XT>(raw[k][j], rms, q_rr[k], q_sc[k], q_inv[k],
                                lo, hi);
          const int s0 = __reduce_add_sync(0xffffffffu, lane < 16 ? sum : 0);
          const int s1 = __reduce_add_sync(0xffffffffu, lane < 16 ? 0 : sum);
          *reinterpret_cast<uint2*>(xt + j * MT * kTileRow +
                                    swz(r, c16 >> 1) + 8 * (c16 & 1)) =
              make_uint2(lo, hi);
          if (live && c16 == 0)
            xsum_sh[(j * gpp + gi) * MT + r] = lane < 16 ? s0 : s1;
          if (live && exporter)
            *reinterpret_cast<uint2*>(act_out + (size_t)(m0 + r) * K +
                                      j * kp + gi * kGroup + 8 * c16) =
                make_uint2(lo, hi);
        }
      }
    }
  };
  if constexpr (kFused) {
    quantize(0);
    if (1 < gpp) load_raw(1);
  }

  // a thread's outputs, m16 tile i, element e: row 16 i + g + 8 (e >> 1),
  // channel c0 + (e & 1); acc[a]: accumulator q + Q a
  const int c0 = 8 * ct + 2 * t;
  float acc[AW][MI][4];
#pragma unroll
  for (int a = 0; a < AW; ++a)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][i][e] = 0.f;

  // the groups of word blocks 0 .. WS - 2, then per gi that of gi + WS - 1:
  // at gi every group but the newest WS - 2 has landed
  for (int gi = 0; gi < gpp; ++gi) {
    cp_async_wait<WS - 2>();
    __syncthreads();  // x and words of gi landed; every warp is past gi - 1
    if constexpr (!kFused) stage_x(gi + WS - 1);  // into the slot of gi - 1
    stage_w(gi + WS - 1);                         // into the slot of gi - 1
    cp_async_commit();
    if constexpr (kFused) {
      if (gi + 1 < gpp) {
        quantize(gi + 1);  // into the slot of gi - 1
        if (gi + 2 < gpp) load_raw(gi + 2);
      }
    }
    const int8_t* xs = xbuf + (gi % XS) * kStageX;
    if constexpr (!kFused) {
      // the group sums of the stage: thread (plane j, row r)
      if (tid < 8 * MT) {
        const int j = tid / MT, r = tid % MT;
        int a = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int4 v =
              *reinterpret_cast<const int4*>(xs + j * MT * kTileRow + swz(r, c));
          a = __dp4a(v.x, 0x01010101, a);
          a = __dp4a(v.y, 0x01010101, a);
          a = __dp4a(v.z, 0x01010101, a);
          a = __dp4a(v.w, 0x01010101, a);
        }
        xsum_sh[(j * gpp + gi) * MT + r] = a;
      }
    }

    // the lane's row of the word block: channel 8 ct + g
    const int8_t* wrow =
        wbuf + (gi % WS) * C * kWordRow + (8 * ct + g) * kWordRow;
    const int sw = (g & 1) << 2;
    int d[PW][MI][4];
#pragma unroll
    for (int p = 0; p < PW; ++p)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[p][i][e] = 0;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = decode_b_word(kk, lane) / 4;  // chunk of b0; b1 at k + 4
      int b[8][2];
      planes_b_frags(
          *reinterpret_cast<const int4*>(wrow + ((k ^ sw) << 4)),
          *reinterpret_cast<const int4*>(wrow + (((k + 4) ^ sw) << 4)), b);
#pragma unroll
      for (int p = 0; p < PW; ++p) {
        const int bq[2] = {class_frag<Q>(b, p, q, 0),
                           class_frag<Q>(b, p, q, 1)};
        const int8_t* xt = xs + (q + Q * p) * MT * kTileRow;
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if (i == 1 && !two) break;
          int a[4];
          decode_a_frag(a, xt, i, kk);
          mma_s8(d[p][i], a, bq);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < PW; ++p) {
      const __nv_bfloat162 sv2 = *reinterpret_cast<const __nv_bfloat162*>(
          s_sh + ((q + Q * p) * gpp + gi) * C + c0);
      const float sv[2] = {__low2float(sv2), __high2float(sv2)};
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if (i == 1 && !two) break;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[p % AW][i][e] =
              mac_rn(acc[p % AW][i][e], exact_f32(d[p][i][e]), sv[e & 1]);
      }
    }
  }

  // the warps hand their accumulators over through the word ring (every
  // copy landed and was read): red[a][row][channel]
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(wbuf);
#pragma unroll
  for (int a = 0; a < AW; ++a)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((q + Q * a) * MT + 16 * i + g + 8 * (e >> 1)) * C + c0 +
            (e & 1)] = acc[a][i][e];
  __syncthreads();
  for (int o = tid; o < MT * C; o += kPdThreads) {
    const int r = o / C, c = o % C;
    if (r >= mv) break;  // o grows with r
    const float* a = red + r * C + c;
    float v[1][1] = {{__fadd_rn(__fadd_rn(a[0], a[MT * C]),
                                __fadd_rn(a[2 * MT * C], a[3 * MT * C]))}};
    auto terms = [&](int gl, int j, float (&xq)[1][1], float (&z)[1][1]) {
      const int gg = j * gpp + gl;
      xq[0][0] = (float)xsum_sh[gg * MT + r];
      z[0][0] = __bfloat162float(zs_sh[gg * C + c]);
    };
    minus_corrections<kFused>(v, gpp, terms);
    store(out + (size_t)(m0 + r) * N + n0 + c,
          __fmul_rn(v[0][0], row_sh[MT + r]));
  }
}

template <bool kFused>
size_t planes_decode_smem(int C, int MT, int K) {
  constexpr int WS = kFused ? kPdSlots14 : kPdSlots2, XS = kFused ? 2 : WS;
  const size_t G = K / kGroup;
  return 128 + (size_t)WS * C * kWordRow + XS * 8 * (size_t)MT * kTileRow +
         2 * G * C * 2 + G * MT * 4 + 3 * (size_t)MT * 4 +
         (size_t)MT * kPdWarps * 2 * 4;
}

template <int NT, int MT, typename XT, typename OutT>
int launch_decode_mt(const XT* x, const void* xscale, const void* wp,
                     const void* s, const void* zs, OutT* out, void* act_out,
                     void* scale_out, int M, int N, int K, int rms, float eps,
                     void* stream) {
  const size_t smem = planes_decode_smem<!std::is_same<XT, int8_t>::value>(
      8 * NT, MT, K);
  cudaError_t e = prepare(planes_decode_kernel<NT, MT, XT, OutT>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + MT - 1) / MT, N / (8 * NT));
  planes_decode_kernel<NT, MT, XT, OutT>
      <<<grid, kPdThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
          x, (const float*)xscale, (const int32_t*)wp,
          (const __nv_bfloat16*)s, (const __nv_bfloat16*)zs, out,
          (int8_t*)act_out, (float*)scale_out, M, N, K, rms, eps);
  return (int)cudaGetLastError();
}

// one m16 tile up to 16 rows, two (32-row chunks) above
template <int NT, typename XT, typename OutT>
int launch_decode(const XT* x, const void* xscale, const void* wp,
                  const void* s, const void* zs, OutT* out, void* act_out,
                  void* scale_out, int M, int N, int K, int rms, float eps,
                  void* stream) {
  if (M < 1 || K % (8 * kGroup) || N % (8 * NT))
    return (int)cudaErrorInvalidValue;
  if (M <= 16)
    return launch_decode_mt<NT, 16>(x, xscale, wp, s, zs, out, act_out,
                                    scale_out, M, N, K, rms, eps, stream);
  return launch_decode_mt<NT, 32>(x, xscale, wp, s, zs, out, act_out,
                                  scale_out, M, N, K, rms, eps, stream);
}

template <typename OutT>
int decode_chan(const void* xq, const void* xscale, const void* wp,
                const void* s, const void* zs, OutT* out, int chan, int M,
                int N, int K, void* stream) {
  const int8_t* x = (const int8_t*)xq;
  if (chan == 16)
    return launch_decode<2>(x, xscale, wp, s, zs, out, nullptr, nullptr, M,
                            N, K, 0, 0.f, stream);
  if (chan == 32)
    return launch_decode<4>(x, xscale, wp, s, zs, out, nullptr, nullptr, M,
                            N, K, 0, 0.f, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// #2 below PLANES_TILE_MIN_M rows: xq (M, K) int8, xscale (M,) f32; out
// (M, N) bf16 (out_f32 = 0) or f32; chan: channels a block, 16 or 32.
int lc_w4a8_decode(const void* xq, const void* xscale, const void* wp,
                   const void* s, const void* zs, void* out, int out_f32,
                   int chan, int M, int N, int K, void* stream) {
  if (out_f32)
    return decode_chan(xq, xscale, wp, s, zs, (float*)out, chan, M, N, K,
                       stream);
  return decode_chan(xq, xscale, wp, s, zs, (__nv_bfloat16*)out, chan, M, N,
                     K, stream);
}

// #14: x (M, K) bf16 (x_f32 = 0) or f32 (1); out (M, N) in x's type;
// act_out (M, K) int8 and scale_out (M,) f32 may be null.
int lc_w4a8_planes_fused(const void* x, int x_f32, const void* wp,
                         const void* s, const void* zs, void* out,
                         void* act_out, void* scale_out, int M, int N, int K,
                         int rms, float eps, void* stream) {
  if (x_f32)
    return launch_decode<4>((const float*)x, nullptr, wp, s, zs, (float*)out,
                            act_out, scale_out, M, N, K, rms, eps, stream);
  return launch_decode<4>((const __nv_bfloat16*)x, nullptr, wp, s, zs,
                          (__nv_bfloat16*)out, act_out, scale_out, M, N, K,
                          rms, eps, stream);
}

// ---------------------------------------------------------------------------
// #3  W4A8 prefill, any M; and #2 from PLANES_TILE_MIN_M rows (f32 or bf16
// out).  Replaces lightcompress_tpu/ops/pallas_matmul.py
// w4a8_matmul_planes_mtiled (_w4a8_kernel_mtiled, _xsum_slab_order), and
// w4a8_matmul_planes at those rows.
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
// bit, the decode tile's too.  Bound: at M = 1024 and the Llama-3-8B
// shapes the 2*M*N*K int8 operations, and the f32 epilogue of every
// (output, group).
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
