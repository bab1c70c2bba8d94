// The planes decode tile (mma.sync m16n8k32 on the int8 tensor cores), one
// kernel body shared by #2 and #14 (w4_matmul.cu: dense rows) and #8
// (w4_moe.cu: the rows of one expert's selections, gathered by index).
#pragma once

#include "w4_planes_wgmma.cuh"

namespace lcw4 {

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
// word blocks in the ring: #2 and #8 copy their x and words one block
// ahead (two slots each; three measured 7-10% slower for #8 at 1-4 tokens
// over a Mixtral-8x7B layer on the H100), #14 its words two ahead (its x
// comes from registers loaded a block earlier still)
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

// #8's selections: out[sel] = x[t_idx[sel]] . W[e_idx[sel]]^T over E
// stacked experts, x of n_rows rows
struct GatherIdx {
  const int32_t* e_idx;
  const int32_t* t_idx;
  int E, n_rows;
};

// #8: the rows of the tile that selection sel = blockIdx.x leads.  Warp 0
// walks the n_sel selections in order, 32 a ballot: the valid selections
// of sel's expert e (t_idx in range) take ranks 0, 1, ..; a selection whose
// rank is a multiple of MT leads the tile of the MT ranks from its own, and
// writes their x rows (t_idx) to rix[0, MT) and output rows (selection
// indices) to rix[MT, 2 MT).  Returns to every thread the tile's row
// count, 0 where sel leads no tile, -1 where an index of sel is out of
// range.  So each distinct expert's weight streams once a call (a tile a
// MT selections of it); the leader's row is the tile's first.
template <int MT>
__device__ __forceinline__ int gather_tile(const GatherIdx& gx, int n_sel,
                                           int* rix) {
  const int lane = threadIdx.x & 31, sel = blockIdx.x;
  if (threadIdx.x < 32) {
    // the indices of the first 32 selections load beside sel's own (one
    // round trip: a block that leads no tile leaves after it)
    int ei = lane < n_sel ? gx.e_idx[lane] : -1;
    int ti = lane < n_sel ? gx.t_idx[lane] : -1;
    const int e = gx.e_idx[sel], ts = gx.t_idx[sel];
    int n = -1;
    if (e >= 0 && e < gx.E && ts >= 0 && ts < gx.n_rows) {
      int base = 0, rs = 0;  // valid selections of e before i0; sel's rank
      for (int i0 = 0; i0 < n_sel; i0 += 32) {
        const int i = i0 + lane;
        if (i0 > 0) {
          ei = i < n_sel ? gx.e_idx[i] : -1;
          ti = i < n_sel ? gx.t_idx[i] : -1;
        }
        const bool mem = ei == e && ti >= 0 && ti < gx.n_rows;
        const unsigned bal = __ballot_sync(0xffffffffu, mem);
        if (sel >= i0 && sel < i0 + 32)
          rs = base + __popc(bal & ((1u << (sel - i0)) - 1u));
        const int rk = base + __popc(bal & ((1u << lane) - 1u)) - rs;
        if (mem && i >= sel && rk < MT) {
          rix[rk] = ti;
          rix[MT + rk] = i;
        }
        base += __popc(bal);
        if (i0 + 32 > sel && base - rs >= MT) break;  // uniform
      }
      n = rs % MT ? 0 : min(MT, base - rs);
    }
    if (lane == 0) rix[2 * MT] = n;
  }
  __syncthreads();
  return rix[2 * MT];
}

// two blocks an SM in 16-row tiles of int8 or bf16 x, one for 32-row tiles
// or f32 x, whose prefetched values would not fit in 128 registers a
// thread.  kGather (#8): M is the selection count, block x the selection
// whose tile (gather_tile) it computes, and wp, s, zs the E stacked
// experts; x rows and output rows by index, one expert a tile
template <int NT, int MT, typename XT, typename OutT, bool kGather = false>
__global__ void __launch_bounds__(kPdThreads,
                                  MT == 16 && sizeof(XT) <= 2 ? 2 : 1)
planes_decode_kernel(const XT* __restrict__ x,
                     const float* __restrict__ xscale,
                     const int32_t* __restrict__ wp,
                     const __nv_bfloat16* __restrict__ s,
                     const __nv_bfloat16* __restrict__ zs,
                     OutT* __restrict__ out, int8_t* __restrict__ act_out,
                     float* __restrict__ scale_out, int M, int N, int K,
                     int rms, float eps, const GatherIdx gx) {
  constexpr bool kFused = !std::is_same<XT, int8_t>::value;
  static_assert(!(kFused && kGather), "#8 takes pre-quantized rows");
  constexpr int C = 8 * NT;           // channels a block
  constexpr int Q = kPdWarps / NT;    // plane classes: warps an n8 tile
  constexpr int PW = 8 / Q;           // planes a warp
  constexpr int AW = 4 / Q;           // accumulators a warp
  constexpr int MI = MT / 16;         // m16 tiles
  constexpr int kStageX = 8 * MT * kTileRow;
  constexpr int WS = kFused ? kPdSlots14 : kPdSlots2;
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
  // #8: the tile's x rows, output rows and row count
  int* rix = reinterpret_cast<int*>(st_sh + MT * kPdWarps * 2);  // [2MT + 1]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ct = warp % NT, q = warp / NT;
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * C;
  int mv = min(MT, M - m0);
  if constexpr (kGather) {
    mv = gather_tile<MT>(gx, M, rix);
    if (mv <= 0) {  // uniform over the block
      if (mv < 0)
        for (int c = tid; c < C; c += kPdThreads)
          store(out + (size_t)blockIdx.x * N + n0 + c, quiet_nan());
      return;
    }
    const size_t e = gx.e_idx[blockIdx.x];
    wp += e * N * (K / 8);
    s += e * N * (K / kGroup);
    zs += e * N * (K / kGroup);
  }
  // row r of the tile: its x row and its output row
  auto xrow = [&](int r) { return kGather ? rix[r] : m0 + r; };
  auto orow = [&](int r) { return kGather ? rix[MT + r] : m0 + r; };
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
  // zeros past M; nothing past gpp.  #8 stages nothing past its tile's
  // rows: those rows are computed from stale shared memory and never
  // stored (each output row depends on its own x row alone), 3-5% faster
  // than zero-filling them at 1-4 tokens over a Mixtral-8x7B layer on the
  // H100
  auto stage_x = [&](int gi) {
    if (gi < gpp) {
      int8_t* dst = xbuf + (gi % XS) * kStageX;
      for (int i = tid; i < 8 * MT * 8; i += kPdThreads) {
        const int j = i / (8 * MT), r = (i >> 3) % MT, c = i & 7;
        const bool ok = r < mv;
        if (kGather && !ok) continue;
        const int8_t* src = reinterpret_cast<const int8_t*>(x) +
                            (ok ? (size_t)xrow(r) * K + j * kp +
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
    if (tid < mv) row_sh[MT + tid] = xscale[xrow(tid)];
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
    store(out + (size_t)orow(r) * N + n0 + c,
          __fmul_rn(v[0][0], row_sh[MT + r]));
  }
}

template <bool kFused>
size_t planes_decode_smem(int C, int MT, int K) {
  constexpr int WS = kFused ? kPdSlots14 : kPdSlots2;
  constexpr int XS = kFused ? 2 : WS;
  const size_t G = K / kGroup;
  return 128 + (size_t)WS * C * kWordRow + XS * 8 * (size_t)MT * kTileRow +
         2 * G * C * 2 + G * MT * 4 + 3 * (size_t)MT * 4 +
         (size_t)MT * kPdWarps * 2 * 4 + (2 * (size_t)MT + 1) * 4;
}

// grid (row chunks, or with kGather the M selections; N / C channel tiles)
template <int NT, int MT, typename XT, typename OutT, bool kGather = false>
int launch_decode_mt(const XT* x, const void* xscale, const void* wp,
                     const void* s, const void* zs, OutT* out, void* act_out,
                     void* scale_out, int M, int N, int K, int rms, float eps,
                     void* stream, const GatherIdx& gx = GatherIdx{}) {
  const size_t smem =
      planes_decode_smem<!std::is_same<XT, int8_t>::value>(8 * NT, MT, K);
  auto kern = planes_decode_kernel<NT, MT, XT, OutT, kGather>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(kGather ? M : (M + MT - 1) / MT, N / (8 * NT));
  kern<<<grid, kPdThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      x, (const float*)xscale, (const int32_t*)wp, (const __nv_bfloat16*)s,
      (const __nv_bfloat16*)zs, out, (int8_t*)act_out, (float*)scale_out, M,
      N, K, rms, eps, gx);
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

}  // namespace lcw4
