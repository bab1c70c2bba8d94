// The int8 tensor-core tiles of the W4A8 kernels on Hopper (sm_90a).
//
// The prefill tile, shared by #3 and #9 (w4_planes_wgmma.cuh, the planes
// layout) and #12 (w4_bytes.cu, the s4 byte pairs).  Replaces, as their
// prefill body, the __dp4a tiles of the TPU kernels
// lightcompress_tpu/ops/pallas_matmul.py w4a8_matmul_planes_mtiled,
// w4a8_grouped_matmul and w4a8_matmul_bytes.
//
// What bounds it on an H100 SXM (1979 TOP/s int8 dense, 3.35 TB/s HBM):
// at a prefill's rows the 2*M*N*K int8 operations, and beside them
// the exact f32 epilogue of every group (a rounded product and sum per
// output and group of 128, on the CUDA cores); at small M the packed weight
// read.  The design:
//   * A block owns 64 rows x 128 channels.  #12's 16 warps (32 x 16) run
//     mma.sync m16n8k32 s8 x s8 -> s32, the planes tile's two warpgroups
//     wgmma m64n64k32, four per group of 128 (one per 32 k), so a group's
//     integer dot sits in registers until the group's float epilogue has
//     consumed it.
//   * A stage holds two groups: two x tiles [64][128] int8 and one weight
//     tile [128][128] bytes (planes: a word block, unpacked into plane
//     tiles), copied by the tensor memory accelerator (TMA boxes one thread
//     issues, counted by an mbarrier) into 16-byte chunks swizzled by row
//     (chunk c of row r at c ^ (r & 7): the 128-byte swizzle), so that
//     fragment reads and 16-byte stores hit distinct banks and wgmma reads
//     the tiles as they lie.  The kernels keep two or three stages in
//     flight: the next stages' copies run under the current stage's
//     products.
//   * The weight codes reach the B operand as four int8 lanes of one
//     channel at four consecutive k: the s4 byte pairs (#12) give them per
//     32-bit word (sign-extended low or high nibbles, in registers); the
//     planes layout spreads them over four words (unpack4).
//   * The grid runs the row tiles innermost: the blocks in flight share
//     one weight channel tile, which the L2 then serves to every row tile.
//
// The decode tile of the planes layout (#5, w4_ksplit.cu; the template for
// the decode tiles of #2 and #14 in w4_matmul.cu and #13 in w4_bytes.cu,
// and for the bf16 tile of #1 and #4 in w4a16_tile.cu, which swaps its
// operands), below the prefill
// tile's helpers: mma.sync m16n8k32 with the B fragments unpacked in
// registers from the 32 bytes of planes words each lane reads a k step
// (decode_b_word, planes_b_frags), the A fragments from x staged in shared
// memory in the 128-byte swizzle (decode_a_frag).
#pragma once

#include <cuda.h>  // CUtensorMap

#include "w4_common.cuh"

namespace lcw4 {

constexpr int kTileM = 64;     // rows of a block tile
constexpr int kTileN = 128;    // channels of a block tile
constexpr int kTileRow = 128;  // bytes of a staged row (one group)
constexpr int kTileX = kTileM * kTileRow;  // bytes of an x tile
constexpr int kTileW = kTileN * kTileRow;  // bytes of a weight tile
constexpr int kWordRow = kGroup * 4;  // bytes of a channel's planes word block

// The mma.sync tile's warps (#12): 2 along the rows (32 each) times 8
// along the channels (kMmaNT = 2 n8 tiles, 16 channels each): 16 warps of
// 32 x 16 outputs.
constexpr int kMmaNT = 2;
constexpr int kMmaWarpsN = 8;
constexpr int kMmaThreads = 2 * kMmaWarpsN * 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows
__device__ __forceinline__ int swz(int r, int c) {
  return r * kTileRow + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(int (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d as f32, exactly for |d| < 2^22 (a group dot is at most 128*127*15):
// the bits 0x4B400000 + d are the float 1.5 * 2^23 + d.  An integer add and
// a float subtract, both on full-rate pipes (I2F is not).
__device__ __forceinline__ float exact_f32(int d) {
  return __fsub_rn(__int_as_float(0x4B400000 + d), 12582912.f);
}

// a + d * s, the product and the sum each rounded to nearest even.
__device__ __forceinline__ float mac_rn(float a, float d, float s) {
  return __fadd_rn(a, __fmul_rn(d, s));
}

// two outputs of one row, adjacent channels, as f32 or bf16 (rounded to
// nearest even)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The planes layout's int8 lanes: of four consecutive words w (the codes of
// k = kw .. kw + 3 of every plane), p[i] holds plane 2b + i (b = 0 or 2)
// in byte q = nibble 2b + i of word q.  Bytes b and b + 1 of the four
// words are gathered by two byte permutes (t0, t1), regrouped by two more
// (v0: bytes b, v1: bytes b + 1), and split into their low and high
// nibbles by masks.
__device__ __forceinline__ void unpack4(const int4 w, int b, int (&p)[4]) {
  const uint32_t sel = (uint32_t)b | ((uint32_t)(b + 4) << 4) |
                       ((uint32_t)(b + 1) << 8) | ((uint32_t)(b + 5) << 12);
  const uint32_t t0 = __byte_perm((uint32_t)w.x, (uint32_t)w.y, sel);
  const uint32_t t1 = __byte_perm((uint32_t)w.z, (uint32_t)w.w, sel);
  const uint32_t v0 = __byte_perm(t0, t1, 0x5410);
  const uint32_t v1 = __byte_perm(t0, t1, 0x7632);
  p[0] = (int)(v0 & 0x0F0F0F0Fu);
  p[1] = (int)((v0 >> 4) & 0x0F0F0F0Fu);
  p[2] = (int)(v1 & 0x0F0F0F0Fu);
  p[3] = (int)((v1 >> 4) & 0x0F0F0F0Fu);
}

// A thread's mma.sync outputs: fragment (i, j) (the warp's m16 tile i, n8
// tile j), element e, at row frag_row(i, e) and channel frag_col(j, e) of
// the block tile (mma C layout: elements 0, 1 at row g, channels 2t and
// 2t + 1; 2, 3 at row g + 8).
__device__ __forceinline__ int frag_row(int i, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp / kMmaWarpsN) * 32 + i * 16 + (lane >> 2) + ((e >> 1) << 3);
}
__device__ __forceinline__ int frag_col(int j, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp % kMmaWarpsN) * 8 * kMmaNT + j * 8 + 2 * (lane & 3) + (e & 1);
}

using Dot = int[2][kMmaNT][4];  // a thread's int32 outputs of one group

// The exact 128-deep group dot of the warp's 32 x 16 outputs: x tile xt
// [64][128] int8 (A, rows) against weight tile wt [128][128] (B, one row
// per channel), each 32-bit word of wt mapped to four int8 lanes by bx.
template <class BX>
__device__ __forceinline__ void group_dot(Dot& d, const int8_t* xt,
                                          const int8_t* wt, BX bx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (warp / kMmaWarpsN) * 32;
  const int c0 = (warp % kMmaWarpsN) * 8 * kMmaNT;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kMmaNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][j][e] = 0;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // ldmatrix x4: lane L names row L & 7 of matrix L >> 3.  A: matrices
    // (rows 0-7 | 8-15) x (k 0-15 | 16-31) of the m16 tile -> a0..a3;
    // B: (k 0-15 | 16-31) of n8 tiles 0 and 1 -> b[0], b[1]
    int a[2][4], b[kMmaNT][2], r[4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldsm_x4(a[i], xt + swz(r0 + i * 16 + (lane & 15), 2 * kk + (lane >> 4)));
    ldsm_x4(r, wt + swz(c0 + ((lane >> 4) << 3) + (lane & 7),
                        2 * kk + ((lane >> 3) & 1)));
    b[0][0] = bx(r[0]);
    b[0][1] = bx(r[1]);
    b[1][0] = bx(r[2]);
    b[1][1] = bx(r[3]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kMmaNT; ++j) mma_s8(d[i][j], a[i], b[j]);
  }
}

// ---- warpgroup products (wgmma, sm_90a) on the same swizzled tiles ----
// A tile of 128-byte rows whose 16-byte chunk c of row r sits at
// c ^ (r & 7) (swz) is, from a 1024-byte aligned base, the K-major
// 128-byte-swizzle layout of wgmma: the hardware XORs address bits 4-6
// with bits 7-9.  The descriptor: start address / 16, leading byte offset
// 1 (unused by swizzled K-major tiles), stride byte offset 1024 (8 rows of
// 128 bytes), swizzle mode 1 (128 bytes).  Step k32 of a row starts 32 k
// bytes further.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= A . B^T for a 64 x 64 int32 tile of the warpgroup: A 64 rows x
// 32 k, B 64 channels x 32 k, both K-major in shared memory (descriptors
// da, db); accumulate = 0 overwrites d.  Asynchronous: d holds the result
// after wgmma_commit and wgmma_wait.  Thread t of warp w of the warpgroup
// holds, for n8 block j, d[4j + e] at row 16w + (t >> 2) + 8 (e >> 1) and
// column 8j + 2 (t & 3) + (e & 1).
__device__ __forceinline__ void wgmma_s8_64x64(int (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins the registers of d here, so that the compiler reads them only after
// the wgmma_wait before it
__device__ __forceinline__ void wgmma_hold(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// generic-proxy writes to shared memory (st.shared, cp.async) become
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Issues the four k32 steps of one group for the warpgroup: x tile xt
// [64][128] against rows [64 wg, 64 wg + 64) of weight tile wt [128][128]
// (both 1024-byte aligned), into d.
__device__ __forceinline__ void group_wgmma(int (&d)[32], const int8_t* xt,
                                            const int8_t* wt, int wg) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_s8_64x64(d, sw128_desc(xt + 32 * kk),
                   sw128_desc(wt + wg * 64 * kTileRow + 32 * kk), kk > 0);
}

// ---- tensor-memory-accelerator copies (TMA) completing on mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}
// makes the initialised barriers visible to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the calling thread's arrival, announcing `bytes` of copies to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// waits for the phase of the given parity to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// the box at (c0, c1) (inner, outer coordinate, in elements) of the 2D
// tensor map at generic address tmap (a __grid_constant__ parameter) into
// shared memory dst, completing `bytes` on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap, int c0,
                                            int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(tmap), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// The sum of one row of one of a stage's two x tiles (x0, x1: [64][128]
// int8) in the even lanes of groups of P = kThreads / 128 threads: P
// threads share a row of tile t / (kThreads / 2), each summing 8 / P of
// its 16-byte chunks; the group's first thread holds the row's sum.
template <int kThreads>
__device__ __forceinline__ int stage_row_sum(const int8_t* x0,
                                             const int8_t* x1) {
  constexpr int P = kThreads / 128;
  const int tid = threadIdx.x, m = (tid / P) & 63, part = tid % P;
  const int8_t* xt = tid >= kThreads / 2 ? x1 : x0;
  int a = 0;
#pragma unroll
  for (int s = 0; s < 8 / P; ++s) {
    const int4 v =
        *reinterpret_cast<const int4*>(xt + swz(m, part * (8 / P) + s));
    a = __dp4a(v.x, 0x01010101, a);
    a = __dp4a(v.y, 0x01010101, a);
    a = __dp4a(v.z, 0x01010101, a);
    a = __dp4a(v.w, 0x01010101, a);
  }
#pragma unroll
  for (int o = 1; o < P; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

// ---- host: tensor maps for the TMA copies ----
// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2D tensor map over rows x cols elements of type t at base (row stride
// `stride` bytes), boxes of box_rows x box_cols elements landing with the
// 128-byte swizzle of swz (on a 1024-byte aligned destination; or another
// `swizzle`), elements out of range as zeros; returns 0, or a nonzero code.
inline int tensor_map_2d(
    CUtensorMap* m, CUtensorMapDataType t, const void* base, uint64_t cols,
    uint64_t rows, uint64_t stride, uint32_t box_cols, uint32_t box_rows,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {stride};
  const cuuint32_t box[2] = {box_cols, box_rows}, unit[2] = {1, 1};
  const CUresult r = fn(m, t, 2, const_cast<void*>(base), dims, strides, box,
                        unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

// ---- the planes decode tile (mma.sync m16n8k32, #5) ----
// 16 bytes from global to shared memory without registers; with valid
// false the 16 bytes are zeros (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lane (g, t) = (lane >> 2, lane & 3) of a warp that owns the n8 tile of
// channels c .. c + 7 reads, for k step kk (32 k) of a group of 128 words,
// the 16 bytes at word kk * 32 + 4t (its b0 k) and at kk * 32 + 16 + 4t
// (its b1 k) of channel c + g's row: four lanes read 64 contiguous bytes.
__device__ __forceinline__ int decode_b_word(int kk, int lane) {
  return kk * 32 + 4 * (lane & 3);
}

// The B fragments of all eight planes for one k step from those two loads:
// b[j][0] (k = 4t .. 4t + 3) and b[j][1] (k = 16 + 4t ..) of plane j at
// channel g, as mma.sync m16n8k32's col-major s8 B wants them.
__device__ __forceinline__ void planes_b_frags(const int4 lo, const int4 hi,
                                               int (&b)[8][2]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    int p[4];
    unpack4(lo, 2 * q, p);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[4 * q + i][0] = p[i];
    unpack4(hi, 2 * q, p);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[4 * q + i][1] = p[i];
  }
}

// The A fragment of m16 tile i at k step kk from an x tile of 128-byte
// rows in the swz layout (row r, k in the group at byte k of the row):
// ldmatrix x4, lane L naming row L & 15 of the tile, chunk 2kk + (L >> 4)
// -> a0 (rows 0-7, k 0-15), a1 (rows 8-15), a2 (rows 0-7, k 16-31), a3.
__device__ __forceinline__ void decode_a_frag(int (&a)[4], const int8_t* xt,
                                              int i, int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, xt + swz(16 * i + (lane & 15), 2 * kk + (lane >> 4)));
}

// The zero corrections of the planes decode tiles (#2, #14, #15, #16),
// subtracted from a thread's output elements v over the word blocks gl = 0
// .. ng - 1 of the caller's gi range: terms(gl, j, xs, zs) gives each
// element's group sum and zero correction of plane j's group of that word
// block.  xsum * zs is exact (at most 14 + 8 significant bits), so a fused
// multiply-add rounds once, as the product and the sum do.  kPerPlane
// (_phase_dot's order: #14, #15, #16): each plane's sum over the word
// blocks, subtracted in plane order; else (the TPU kernels' one
// correction, #2): one sum in (gi, j) order, subtracted once.  Every op
// rounded on its own.
template <bool kPerPlane, int N1, int N2, class Terms>
__device__ __forceinline__ void minus_corrections(float (&v)[N1][N2], int ng,
                                                  Terms terms) {
  constexpr int NC = kPerPlane ? 8 : 1;
  float c[NC][N1][N2];
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int a = 0; a < N1; ++a)
#pragma unroll
      for (int b = 0; b < N2; ++b) c[k][a][b] = 0.f;
  for (int gl = 0; gl < ng; ++gl)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float xs[N1][N2], zv[N1][N2];
      terms(gl, j, xs, zv);
      const int k = kPerPlane ? j : 0;
#pragma unroll
      for (int a = 0; a < N1; ++a)
#pragma unroll
        for (int b = 0; b < N2; ++b)
          c[k][a][b] = fmaf(xs[a][b], zv[a][b], c[k][a][b]);
    }
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int a = 0; a < N1; ++a)
#pragma unroll
      for (int b = 0; b < N2; ++b) v[a][b] = __fsub_rn(v[a][b], c[k][a][b]);
}

}  // namespace lcw4
