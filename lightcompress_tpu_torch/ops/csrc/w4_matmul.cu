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
// run on the planes decode tile of w4_planes_decode.cuh, shared with #8;
// #3 (and #2 from PLANES_TILE_MIN_M rows) on the planes tile of
// w4_planes_wgmma.cuh, shared with #9 and #6.
//
// Bounds on an H100 SXM (3.35 TB/s HBM, 1979 TOP/s int8 dense tensor-core
// peak): max(bytes / 3.35 TB/s, 2*M*N*K / 1979 TOP/s), bytes = N*K/2 +
// 4*N*G + M*K*b_x + M*N*b_out: in decode (a few rows) the packed weight
// read, at M 1024 the int8 operations.

#include "w4_planes_decode.cuh"

namespace {

using namespace lcw4;

// #2 on the planes decode tile at `chan` channels a block (decode_chan,
// ops/w4_matmul.py)
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
