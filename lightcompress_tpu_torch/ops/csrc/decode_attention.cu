// One-token GQA decode attention over the quantized slot caches, for Hopper
// (sm_90a), CUDA C++ with a plain C interface bound from Python with ctypes
// (ops/_build.py, ops/attention.py).
//
//   #18 attn_bd_kernel<G, false>        replaces
//                                       lightcompress_tpu/ops/pallas_attention.py
//                                       decode_attention_bd (_attn_kernel_bd)
//   #19 attn_bd_flash_kernel<G, false>  replaces decode_attention_bd_flash
//                                       (_attn_kernel_bd_flash)
//   #20 attn_bd_kernel<G, true>         replaces decode_attention_bd4
//                                       (_attn_kernel_bd4)
//   #21 attn_bd_flash_kernel<G, true>   replaces decode_attention_bd4_flash
//                                       (_attn_kernel_bd4_flash)
//   #17 attn_i8_kernel                  replaces decode_attention_i8
//                                       (_attn_kernel_i8_append, masked)
//   #22 attn_kv8_kernel<G, ST>          replaces decode_attention_kv8
//                                       (_attn_kernel)
//
// Inputs shared by all but #22: the int8 query q8 (B, H, G, D) and its
// f32 scales qs (B, H, G) (ops/attention.quantize_q), bf16 per-token cache
// scales (B, H, S), int32 lengths (B,).  D = 128; G is a template argument.
// Block-diagonal caches (#18-#21): K feature-major (B, H*R, S) and V
// time-major (B, S, H*R), R code bytes per head and token: kv8 (#18, #19)
// R = D int8 codes, row h*D + d = feature d of head h; kv4 (#20, #21) R =
// D/2, one byte = two int4 codes, low nibble feature d, high nibble
// feature d + D/2.  int8 hhd cache (#17): K and V (B, H, S, D).  The TPU
// kernels of #18/#19 multiply a block-diagonal q (H*G, H*D) against the
// whole slab, a matrix-unit device; these compute what it computes, each
// head's G query rows against that head's rows of the slab.
//
// Arithmetic, in the JAX kernels' order: integer dots (__dp4a over int8 q
// and int8 codes or sign-extended nibbles, exact in int32); scores
// (f32(s) * (qs * D^-0.5)) * ks; columns >= length are masked; the max is
// floored at -1e30 (#18-#21); e = exp(s - m); pv = e * vs; ps = max(max(pv),
// 1e-20) / 127; p8 = rint(pv / ps) (round half to even, IEEE division: the
// build uses no fast-math); PV as an int32 dot times ps.  Where JAX
// multiplies and then adds, __fmul_rn/__fadd_rn keep the two roundings.
// Masked columns contribute exactly 0 in the TPU kernels, so these skip them.
//
// Bound on an H100 SXM: bytes.  A block reads each valid column's codes and
// scales once (kv8: 128 + 128 + 2 + 2 bytes per kv head and token; kv4: 64 +
// 64 + 2 + 2) against 2*G*D int operations per code byte pair, far below
// the int8 tensor-core rate.  Design: one block per (slot, kv head), grid
// (H, B); the block reads its head's K once for all G query rows and V once
// for the whole PV dot, with the scores of the valid columns held in shared
// memory (the probability scale ps is a max over the whole row, or over one
// s_block column block for #19/#21).  K column t is read down the head's
// feature rows, 4 columns to a thread, coalesced along t; a V row is one
// contiguous run of code bytes.  The whole-row kernels (#17, #18, #20) keep
// 5 * G bytes of shared memory per column, so the buffer S is bounded by
// the 227 KB a block may have (#18 at G = 4: S <= 11488; the wrapper raises
// above it and names the flash route).  No tensor cores and no TMA: at 8
// slots x 8 kv heads the 64 blocks fill half the SMs; splitting S across
// blocks (with a cross-block merge) and cp.async/TMA staging are for later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 128;                       // head_dim
constexpr int kD2 = kD / 2;                   // kv4 bytes per head and token
constexpr int kQW = kD / 4;                   // int32 words of one q row
constexpr float kScale = 0.08838834764831845f;  // 128 ** -0.5

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The four bytes of x hold two nibbles each; these return the low (or high)
// nibbles sign-extended to four int8 lanes, ready for __dp4a.
__device__ __forceinline__ int nib_lo(uint32_t x) {
  const uint32_t n = x & 0x0F0F0F0Fu;
  return (int)(n | ((n & 0x08080808u) * 0x1Eu));
}
__device__ __forceinline__ int nib_hi(uint32_t x) {
  const uint32_t n = (x >> 4) & 0x0F0F0F0Fu;
  return (int)(n | ((n & 0x08080808u) * 0x1Eu));
}

// Byte j of each of w0..w3, as bytes 0..3 of the result.
__device__ __forceinline__ uint32_t gather_byte(uint32_t w0, uint32_t w1,
                                                uint32_t w2, uint32_t w3,
                                                int j) {
  const uint32_t sel = (uint32_t)j | ((uint32_t)(j + 4) << 4);
  return __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel),
                     0x5410);
}

// Block-wide max or sum of G values per thread; every thread gets the
// result in v.  red holds kWarps * G floats.
template <int G, bool kMax>
__device__ __forceinline__ void block_reduce(float (&v)[G], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v[g], off);
      v[g] = kMax ? fmaxf(v[g], o) : v[g] + o;
    }
    if (lane == 0) red[warp * G + g] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float a = red[g];
    for (int w = 1; w < kWarps; ++w)
      a = kMax ? fmaxf(a, red[w * G + g]) : a + red[w * G + g];
    v[g] = a;
  }
  __syncthreads();
}

// Shared memory of one block over at most `cap` score columns: scores
// (later pv) f32 [G][cap], p8 int8 [G][cap], the int32 PV sums [G][D], the
// q words [G][D/4], the reduction scratch.  cap % 16 == 0 keeps every part
// 16-byte aligned and every 4-column word of p8 4-byte aligned.
template <int G>
struct Smem {
  float* sc;
  int8_t* p8;
  int* acc;
  int* qw;
  float* red;
  int cap;
  __device__ Smem(unsigned char* base, int n) : cap(n) {
    sc = reinterpret_cast<float*>(base);
    p8 = reinterpret_cast<int8_t*>(sc + (size_t)G * n);
    acc = reinterpret_cast<int*>(p8 + (size_t)G * n);
    qw = acc + G * kD;
    red = reinterpret_cast<float*>(qw + G * kQW);
  }
  static size_t bytes(int n) {
    return (size_t)G * n * 5 + (size_t)G * kD * 4 + (size_t)G * kQW * 4 +
           (size_t)kWarps * G * 4;
  }
};

template <int G>
__device__ __forceinline__ void load_q(Smem<G>& sm, const int8_t* q8,
                                       int bh) {
  const int* src = reinterpret_cast<const int*>(q8 + (size_t)bh * G * kD);
  for (int i = threadIdx.x; i < G * kQW; i += kThreads) sm.qw[i] = src[i];
  for (int i = threadIdx.x; i < G * kD; i += kThreads) sm.acc[i] = 0;
}

// Block-diagonal scores of columns [c0, c0 + n) of one (slot, kv head) into
// sm.sc (relative column), returning each thread's max per row.  kh points
// at the head's first K row (kNib: packed nibble rows, else int8 feature
// rows); rows are S bytes apart.  A thread takes 4 columns (one word of
// every row) and walks the rows 4 at a time.
template <int G, bool kNib>
__device__ __forceinline__ void bd_scores(const Smem<G>& sm,
                                          const uint32_t* kh,
                                          const __nv_bfloat16* ksh,
                                          const float (&qsc)[G], int S,
                                          int c0, int n, float (&mx)[G]) {
  constexpr int kRows = kNib ? kD2 : kD;
  const int S4 = S / 4, nw = (n + 3) / 4, w0 = c0 / 4;
  for (int c = threadIdx.x; c < nw; c += kThreads) {
    int s[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[g][j] = 0;
#pragma unroll 2
    for (int d4 = 0; d4 < kRows / 4; ++d4) {
      const uint32_t* r = kh + (size_t)(4 * d4) * S4 + w0 + c;
      const uint32_t a0 = __ldg(r), a1 = __ldg(r + S4), a2 = __ldg(r + 2 * S4),
                     a3 = __ldg(r + 3 * S4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t x = gather_byte(a0, a1, a2, a3, j);
        if constexpr (kNib) {
          const int lo = nib_lo(x), hi = nib_hi(x);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            s[g][j] = __dp4a(lo, sm.qw[g * kQW + d4], s[g][j]);
            s[g][j] = __dp4a(hi, sm.qw[g * kQW + kQW / 2 + d4], s[g][j]);
          }
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g)
            s[g][j] = __dp4a((int)x, sm.qw[g * kQW + d4], s[g][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = 4 * c + j;
      if (t >= n) continue;
      const float ksv = bf(ksh[c0 + t]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float v = __fmul_rn(__fmul_rn((float)s[g][j], qsc[g]), ksv);
        sm.sc[g * sm.cap + t] = v;
        mx[g] = fmaxf(mx[g], v);
      }
    }
  }
}

// e = exp(s - m) over the n valid columns; pv = e * vs replaces the score;
// returns the row sums of e and the row maxima of pv (block-reduced) and
// writes p8 = rint(pv / ps) for columns [0, round_up(n, 4)) (0 past n).
template <int G>
__device__ __forceinline__ void softmax_requant(const Smem<G>& sm,
                                                const __nv_bfloat16* vsh,
                                                const float (&m)[G], int c0,
                                                int n, float (&esum)[G],
                                                float (&ps)[G]) {
  float pmax[G];
#pragma unroll
  for (int g = 0; g < G; ++g) esum[g] = 0.f, pmax[g] = 0.f;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const float vsv = bf(vsh[c0 + t]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float e = expf(sm.sc[g * sm.cap + t] - m[g]);
      esum[g] += e;
      const float pv = __fmul_rn(e, vsv);
      sm.sc[g * sm.cap + t] = pv;
      pmax[g] = fmaxf(pmax[g], pv);
    }
  }
  block_reduce<G, false>(esum, sm.red);
  block_reduce<G, true>(pmax, sm.red);
#pragma unroll
  for (int g = 0; g < G; ++g) ps[g] = fmaxf(pmax[g], 1e-20f) / 127.0f;
  const int nr = (n + 3) / 4 * 4;
  for (int t = threadIdx.x; t < nr; t += kThreads) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      sm.p8[g * sm.cap + t] =
          t < n ? (int8_t)(int)rintf(sm.sc[g * sm.cap + t] / ps[g])
                : (int8_t)0;
  }
  __syncthreads();
}

// kv4 PV: sm.acc[g][d] += sum_t p8[g][t] * v[t][d] over columns [c0, c0+n);
// vh points at the head's packed bytes of column 0, rows `stride` bytes
// apart.  16 threads share a row (4 packed bytes each), 16 row quads at once.
template <int G>
__device__ __forceinline__ void bd4_pv(const Smem<G>& sm, const int8_t* vh,
                                       int stride, int c0, int n) {
  const int wc = threadIdx.x & 15, tg = threadIdx.x >> 4;
  const int nq = (n + 3) / 4;
  int alo[G][4], ahi[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) alo[g][j] = 0, ahi[g][j] = 0;
  for (int q4 = tg; q4 < nq; q4 += kThreads / 16) {
    const int t0 = 4 * q4;
    const int8_t* r = vh + (size_t)(c0 + t0) * stride + 4 * wc;
    const uint32_t a0 = __ldg(reinterpret_cast<const uint32_t*>(r));
    const uint32_t a1 = __ldg(reinterpret_cast<const uint32_t*>(r + stride));
    const uint32_t a2 =
        __ldg(reinterpret_cast<const uint32_t*>(r + 2 * stride));
    const uint32_t a3 =
        __ldg(reinterpret_cast<const uint32_t*>(r + 3 * stride));
    int pw[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      pw[g] = *reinterpret_cast<const int*>(sm.p8 + g * sm.cap + t0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t x = gather_byte(a0, a1, a2, a3, j);
      const int lo = nib_lo(x), hi = nib_hi(x);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        alo[g][j] = __dp4a(lo, pw[g], alo[g][j]);
        ahi[g][j] = __dp4a(hi, pw[g], ahi[g][j]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      atomicAdd(&sm.acc[g * kD + 4 * wc + j], alo[g][j]);
      atomicAdd(&sm.acc[g * kD + kD2 + 4 * wc + j], ahi[g][j]);
    }
  __syncthreads();
}

// int8 PV: sm.acc[g][d] += sum_t p8[g][t] * v[t][d] over columns [c0,
// c0+n); vh points at the head's D code bytes of column 0, rows `stride`
// bytes apart.  A warp owns 4-row quads, one 4-byte word of each row per
// lane (a whole 128-byte row per warp load).
template <int G>
__device__ __forceinline__ void i8_pv(const Smem<G>& sm, const int8_t* vh,
                                      int stride, int c0, int n) {
  const int wc = threadIdx.x & 31, tg = threadIdx.x >> 5;
  const int nq = (n + 3) / 4;
  int a[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[g][j] = 0;
  for (int q4 = tg; q4 < nq; q4 += kWarps) {
    const int t0 = 4 * q4;
    const int8_t* r = vh + (size_t)(c0 + t0) * stride + 4 * wc;
    const uint32_t a0 = __ldg(reinterpret_cast<const uint32_t*>(r));
    const uint32_t a1 = __ldg(reinterpret_cast<const uint32_t*>(r + stride));
    const uint32_t a2 =
        __ldg(reinterpret_cast<const uint32_t*>(r + 2 * stride));
    const uint32_t a3 =
        __ldg(reinterpret_cast<const uint32_t*>(r + 3 * stride));
    int pw[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      pw[g] = *reinterpret_cast<const int*>(sm.p8 + g * sm.cap + t0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = (int)gather_byte(a0, a1, a2, a3, j);
#pragma unroll
      for (int g = 0; g < G; ++g) a[g][j] = __dp4a(x, pw[g], a[g][j]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      atomicAdd(&sm.acc[g * kD + 4 * wc + j], a[g][j]);
  __syncthreads();
}

template <int G, bool kNib>
__device__ __forceinline__ void bd_pv(const Smem<G>& sm, const int8_t* vh,
                                      int stride, int c0, int n) {
  if constexpr (kNib)
    bd4_pv(sm, vh, stride, c0, n);
  else
    i8_pv(sm, vh, stride, c0, n);
}

template <int G>
__device__ __forceinline__ void q_scales(const float* qs, int bh,
                                         float (&qsc)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) qsc[g] = __fmul_rn(qs[bh * G + g], kScale);
}

// ---------------------------------------------------------------------------
// #18 (kNib false) and #20 (kNib true): the whole buffer in one pass;
// (ctx unnormalized, m, d).
// ---------------------------------------------------------------------------
template <int G, bool kNib>
__global__ void __launch_bounds__(kThreads)
attn_bd_kernel(const int8_t* __restrict__ q8, const float* __restrict__ qs,
               const int8_t* __restrict__ kt,
               const __nv_bfloat16* __restrict__ ks,
               const int8_t* __restrict__ vt,
               const __nv_bfloat16* __restrict__ vs,
               const int* __restrict__ lengths, float* __restrict__ ctx,
               float* __restrict__ m_out, float* __restrict__ d_out, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRow = kNib ? kD2 : kD;  // code bytes of one head and token
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, bh = b * H + h;
  Smem<G> sm(smem, S);
  const int L = min(max(lengths[b], 0), S);
  load_q(sm, q8, bh);
  float qsc[G], mx[G], esum[G], ps[G];
  q_scales(qs, bh, qsc);
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = -INFINITY;
  __syncthreads();
  const uint32_t* kh = reinterpret_cast<const uint32_t*>(
      kt + ((size_t)b * H * kRow + (size_t)h * kRow) * S);
  bd_scores<G, kNib>(sm, kh, ks + (size_t)bh * S, qsc, S, 0, L, mx);
  block_reduce<G, true>(mx, sm.red);
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = fmaxf(mx[g], -1e30f);
  softmax_requant(sm, vs + (size_t)bh * S, mx, 0, L, esum, ps);
  bd_pv<G, kNib>(sm, vt + (size_t)b * S * H * kRow + (size_t)h * kRow,
                 H * kRow, 0, L);
  for (int i = threadIdx.x; i < G * kD; i += kThreads)
    ctx[(size_t)bh * G * kD + i] = __fmul_rn((float)sm.acc[i], ps[i / kD]);
  if (threadIdx.x < G) {
    m_out[bh * G + threadIdx.x] = mx[threadIdx.x];
    d_out[bh * G + threadIdx.x] = esum[threadIdx.x];
  }
}

// ---------------------------------------------------------------------------
// #19 (kNib false) and #21 (kNib true): S in blocks of sb columns, in order
// inside the block; the running (o, m, d) stay in registers and shared
// memory:
//   m' = max(m, max(max(s_blk), -1e30)); a = exp(m - m');
//   d' = d*a + sum(e); o' = o*a + f32(p8 . v) * ps_blk.
// Blocks at or past the slot's length leave (o, m, d) unchanged in the TPU
// kernel (a = 1, e = 0), so the loop stops at the length.
// ---------------------------------------------------------------------------
template <int G, bool kNib>
__global__ void __launch_bounds__(kThreads)
attn_bd_flash_kernel(const int8_t* __restrict__ q8,
                     const float* __restrict__ qs,
                     const int8_t* __restrict__ kt,
                     const __nv_bfloat16* __restrict__ ks,
                     const int8_t* __restrict__ vt,
                     const __nv_bfloat16* __restrict__ vs,
                     const int* __restrict__ lengths,
                     float* __restrict__ ctx, float* __restrict__ m_out,
                     float* __restrict__ d_out, int S, int sb) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRow = kNib ? kD2 : kD;
  constexpr int kOut = (G * kD + kThreads - 1) / kThreads;
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, bh = b * H + h;
  Smem<G> sm(smem, sb);
  const int L = min(max(lengths[b], 0), S);
  load_q(sm, q8, bh);
  float qsc[G], m[G], d[G], o[kOut];
  q_scales(qs, bh, qsc);
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = -1e30f, d[g] = 0.f;
#pragma unroll
  for (int k = 0; k < kOut; ++k) o[k] = 0.f;
  __syncthreads();
  const uint32_t* kh = reinterpret_cast<const uint32_t*>(
      kt + ((size_t)b * H * kRow + (size_t)h * kRow) * S);
  const int8_t* vh = vt + (size_t)b * S * H * kRow + (size_t)h * kRow;
  for (int c0 = 0; c0 < L; c0 += sb) {
    const int n = min(sb, L - c0);
    float mx[G], esum[G], ps[G], alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) mx[g] = -INFINITY;
    bd_scores<G, kNib>(sm, kh, ks + (size_t)bh * S, qsc, S, c0, n, mx);
    block_reduce<G, true>(mx, sm.red);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mn = fmaxf(m[g], fmaxf(mx[g], -1e30f));
      alpha[g] = expf(m[g] - mn);
      m[g] = mn;
    }
    softmax_requant(sm, vs + (size_t)bh * S, m, c0, n, esum, ps);
    bd_pv<G, kNib>(sm, vh, H * kRow, c0, n);
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < G * kD) {
        const int g = i / kD;
        o[k] = __fadd_rn(__fmul_rn(o[k], alpha[g]),
                         __fmul_rn((float)sm.acc[i], ps[g]));
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) d[g] = __fadd_rn(__fmul_rn(d[g], alpha[g]),
                                                 esum[g]);
    __syncthreads();  // every thread has read acc and p8 of this block
    for (int i = threadIdx.x; i < G * kD; i += kThreads) sm.acc[i] = 0;
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < G * kD) ctx[(size_t)bh * G * kD + i] = o[k];
  }
  if (threadIdx.x < G) {
    m_out[bh * G + threadIdx.x] = m[threadIdx.x];
    d_out[bh * G + threadIdx.x] = d[threadIdx.x];
  }
}

// ---------------------------------------------------------------------------
// #17: int8 cache (B, H, S, D) plus the fresh token as one more softmax
// column, not requantized:
//   m = max(max(s), s_new); denom = sum(e) + e_new;
//   out = (f32(p8 . v) * ps + e_new * vns * v_new) / denom.
// Scores: 8 lanes share a cache row (16 bytes each) and add their partial
// dots with shuffles, so a warp reads four whole 128-byte rows per load.
// PV: i8_pv over the head's rows.
// ---------------------------------------------------------------------------
template <int G>
__global__ void __launch_bounds__(kThreads)
attn_i8_kernel(const int8_t* __restrict__ q8, const float* __restrict__ qs,
               const int8_t* __restrict__ kq,
               const __nv_bfloat16* __restrict__ ks,
               const int8_t* __restrict__ vq,
               const __nv_bfloat16* __restrict__ vs,
               const int8_t* __restrict__ kn,
               const __nv_bfloat16* __restrict__ kns,
               const int8_t* __restrict__ vn,
               const __nv_bfloat16* __restrict__ vns,
               const int* __restrict__ lengths, float* __restrict__ out,
               int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, bh = b * H + h;
  const int lane = threadIdx.x & 31, sub = threadIdx.x & 7;
  Smem<G> sm(smem, S);
  const int L = min(max(lengths[b], 0), S);
  load_q(sm, q8, bh);
  float qsc[G], mx[G], snew[G], esum[G], ps[G];
  q_scales(qs, bh, qsc);
  __syncthreads();

  // the fresh token's score, in every warp (no shared memory round trip)
  const int knw = reinterpret_cast<const int*>(kn + (size_t)bh * kD)[lane];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    int s = __dp4a(knw, sm.qw[g * kQW + lane], 0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    snew[g] = __fmul_rn(__fmul_rn((float)s, qsc[g]), bf(kns[bh]));
    mx[g] = -INFINITY;
  }

  const int8_t* kh = kq + (size_t)bh * S * kD;
  const __nv_bfloat16* ksh = ks + (size_t)bh * S;
  for (int tb = 0; tb < L; tb += kThreads / 8) {
    const int t = tb + (threadIdx.x >> 3);
    const bool valid = t < L;
    int4 kv = make_int4(0, 0, 0, 0);
    if (valid)
      kv = __ldg(reinterpret_cast<const int4*>(kh + (size_t)t * kD) + sub);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int* qg = sm.qw + g * kQW + 4 * sub;
      int s = __dp4a(kv.x, qg[0], 0);
      s = __dp4a(kv.y, qg[1], s);
      s = __dp4a(kv.z, qg[2], s);
      s = __dp4a(kv.w, qg[3], s);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (valid && sub == 0) {
        const float v = __fmul_rn(__fmul_rn((float)s, qsc[g]), bf(ksh[t]));
        sm.sc[g * sm.cap + t] = v;
        mx[g] = fmaxf(mx[g], v);
      }
    }
  }
  block_reduce<G, true>(mx, sm.red);
  float en[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mx[g] = fmaxf(mx[g], snew[g]);
    en[g] = expf(snew[g] - mx[g]);
  }
  softmax_requant(sm, vs + (size_t)bh * S, mx, 0, L, esum, ps);

  i8_pv(sm, vq + (size_t)bh * S * kD, kD, 0, L);

  const float vnsf = bf(vns[bh]);
  for (int i = threadIdx.x; i < G * kD; i += kThreads) {
    const int g = i / kD, dd = i % kD;
    const float pvn = __fmul_rn(en[g], vnsf);
    const float c = __fadd_rn(__fmul_rn((float)sm.acc[i], ps[g]),
                              __fmul_rn(pvn, (float)vn[(size_t)bh * kD + dd]));
    out[(size_t)bh * G * kD + i] = c / __fadd_rn(esum[g], en[g]);
  }
}

// ---------------------------------------------------------------------------
// #22: bf16 q (B, H, G, D) over the int8 cache (B, H, S, D) with per-token
// scales (B, H, S) (ST = bf16 or f32), no length mask (every column is
// read: the caller appended the fresh token), the normalized context out:
//   s = (f32 dot(bf16 q, bf16 k)) * ks * D^-0.5;  p = e / sum(e),
//   e = exp(s - max(s));  pv = bf16(p * vs);  out = f32 dot(pv, bf16 v).
// Unlike #17, q is not quantized, the dots are f32 (every product of a bf16
// q and an int8 code is exact in f32), and p is normalized and rounded to
// bf16 before PV.  Scores: 8 lanes share a cache row (16 codes each) and
// add their partial dots with shuffles.  PV: a warp takes one row at a
// time (4 features a lane, rows warp, warp + 8, ...), and the warps' sums
// are added through shared memory at the end.  Shared memory: the score
// row (G * S floats, so S is bounded by the 227 KB a block may have: S <=
// 13368 at G 4; the wrapper raises above it), q in f32, the warps' PV sums.
// ---------------------------------------------------------------------------
template <int G>
size_t kv8_smem(int S) {
  return ((size_t)G * S + (size_t)G * kD + (size_t)kWarps * G +
          (size_t)kWarps * G * kD) * 4;
}

template <int G, typename ST>
__global__ void __launch_bounds__(kThreads)
attn_kv8_kernel(const __nv_bfloat16* __restrict__ q,
                const int8_t* __restrict__ kq, const ST* __restrict__ ks,
                const int8_t* __restrict__ vq, const ST* __restrict__ vs,
                float* __restrict__ out, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, bh = b * H + h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = threadIdx.x & 7;
  float* sc = reinterpret_cast<float*>(smem);  // [G][S]
  float* qf = sc + (size_t)G * S;              // [G][kD]
  float* red = qf + G * kD;                    // [kWarps][G]
  float* part = red + kWarps * G;              // [kWarps][G][kD]
  for (int i = threadIdx.x; i < G * kD; i += kThreads)
    qf[i] = __bfloat162float(q[(size_t)bh * G * kD + i]);
  __syncthreads();

  const int8_t* kh = kq + (size_t)bh * S * kD;
  const ST* ksh = ks + (size_t)bh * S;
  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = -INFINITY;
  for (int tb = 0; tb < S; tb += kThreads / 8) {
    const int t = tb + (threadIdx.x >> 3);
    const bool valid = t < S;
    int4 kv = make_int4(0, 0, 0, 0);
    if (valid)
      kv = __ldg(reinterpret_cast<const int4*>(kh + (size_t)t * kD) + sub);
    const int8_t* c = reinterpret_cast<const int8_t*>(&kv);
    float ksv = 0.f;
    if (valid) ksv = to_f32(ksh[t]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* qg = qf + g * kD + 16 * sub;
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) a = fmaf(qg[i], (float)c[i], a);
      a += __shfl_xor_sync(0xffffffffu, a, 4);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      if (valid && sub == 0) {
        const float v = __fmul_rn(__fmul_rn(a, ksv), kScale);
        sc[g * S + t] = v;
        mx[g] = fmaxf(mx[g], v);
      }
    }
  }
  block_reduce<G, true>(mx, red);
  float sum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) sum[g] = 0.f;
  for (int t = threadIdx.x; t < S; t += kThreads)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float e = expf(sc[g * S + t] - mx[g]);
      sc[g * S + t] = e;
      sum[g] += e;
    }
  block_reduce<G, false>(sum, red);
  const ST* vsh = vs + (size_t)bh * S;
  for (int t = threadIdx.x; t < S; t += kThreads) {
    const float vsv = to_f32(vsh[t]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = __fdiv_rn(sc[g * S + t], sum[g]);
      sc[g * S + t] = __bfloat162float(__float2bfloat16(__fmul_rn(p, vsv)));
    }
  }
  __syncthreads();

  const int8_t* vh = vq + (size_t)bh * S * kD;
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;
  for (int t = warp; t < S; t += kWarps) {
    const int w = __ldg(reinterpret_cast<const int*>(vh + (size_t)t * kD) +
                        lane);
    const int8_t* c = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = sc[g * S + t];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][j] = fmaf(p, (float)c[j], acc[g][j]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[(warp * G + g) * kD + 4 * lane + j] = acc[g][j];
  __syncthreads();
  for (int i = threadIdx.x; i < G * kD; i += kThreads) {
    float a = part[i];
    for (int w = 1; w < kWarps; ++w) a += part[w * G * kD + i];
    out[(size_t)bh * G * kD + i] = a;
  }
}

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int G, bool kNib>
int launch_bd(const void* q8, const void* qs, const void* kt, const void* ks,
              const void* vt, const void* vs, const void* lengths, void* ctx,
              void* m, void* d, int B, int H, int S, int sb,
              cudaStream_t st) {
  const size_t smem = Smem<G>::bytes(sb > 0 ? sb : S);
  const dim3 grid(H, B);
  cudaError_t e;
  if (sb > 0) {
    e = prepare(attn_bd_flash_kernel<G, kNib>, smem);
    if (e != cudaSuccess) return (int)e;
    attn_bd_flash_kernel<G, kNib><<<grid, kThreads, smem, st>>>(
        (const int8_t*)q8, (const float*)qs, (const int8_t*)kt,
        (const __nv_bfloat16*)ks, (const int8_t*)vt,
        (const __nv_bfloat16*)vs, (const int*)lengths, (float*)ctx,
        (float*)m, (float*)d, S, sb);
  } else {
    e = prepare(attn_bd_kernel<G, kNib>, smem);
    if (e != cudaSuccess) return (int)e;
    attn_bd_kernel<G, kNib><<<grid, kThreads, smem, st>>>(
        (const int8_t*)q8, (const float*)qs, (const int8_t*)kt,
        (const __nv_bfloat16*)ks, (const int8_t*)vt,
        (const __nv_bfloat16*)vs, (const int*)lengths, (float*)ctx,
        (float*)m, (float*)d, S);
  }
  return (int)cudaGetLastError();
}

template <int G>
int launch_i8(const void* q8, const void* qs, const void* kq, const void* ks,
              const void* vq, const void* vs, const void* kn,
              const void* kns, const void* vn, const void* vns,
              const void* lengths, void* out, int B, int H, int S,
              cudaStream_t st) {
  const size_t smem = Smem<G>::bytes(S);
  cudaError_t e = prepare(attn_i8_kernel<G>, smem);
  if (e != cudaSuccess) return (int)e;
  attn_i8_kernel<G><<<dim3(H, B), kThreads, smem, st>>>(
      (const int8_t*)q8, (const float*)qs, (const int8_t*)kq,
      (const __nv_bfloat16*)ks, (const int8_t*)vq, (const __nv_bfloat16*)vs,
      (const int8_t*)kn, (const __nv_bfloat16*)kns, (const int8_t*)vn,
      (const __nv_bfloat16*)vns, (const int*)lengths, (float*)out, S);
  return (int)cudaGetLastError();
}

template <int G, typename ST>
int launch_kv8(const void* q, const void* kq, const void* ks, const void* vq,
               const void* vs, void* out, int B, int H, int S,
               cudaStream_t st) {
  const size_t smem = kv8_smem<G>(S);
  cudaError_t e = prepare(attn_kv8_kernel<G, ST>, smem);
  if (e != cudaSuccess) return (int)e;
  attn_kv8_kernel<G, ST><<<dim3(H, B), kThreads, smem, st>>>(
      (const __nv_bfloat16*)q, (const int8_t*)kq, (const ST*)ks,
      (const int8_t*)vq, (const ST*)vs, (float*)out, S);
  return (int)cudaGetLastError();
}

template <typename ST>
int kv8_dispatch(const void* q, const void* kq, const void* ks,
                 const void* vq, const void* vs, void* out, int B, int H,
                 int G, int S, cudaStream_t st) {
  switch (G) {
    case 1: return launch_kv8<1, ST>(q, kq, ks, vq, vs, out, B, H, S, st);
    case 2: return launch_kv8<2, ST>(q, kq, ks, vq, vs, out, B, H, S, st);
    case 4: return launch_kv8<4, ST>(q, kq, ks, vq, vs, out, B, H, S, st);
    case 8: return launch_kv8<8, ST>(q, kq, ks, vq, vs, out, B, H, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kNib>
int bd_dispatch(const void* q8, const void* qs, const void* kt,
                const void* ks, const void* vt, const void* vs,
                const void* lengths, void* ctx, void* m, void* d, int B,
                int H, int G, int S, int sb, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (sb < 0 || (sb > 0 && (sb % 16 || S % sb)))
    return (int)cudaErrorInvalidValue;
  switch (G) {
    case 1: return launch_bd<1, kNib>(q8, qs, kt, ks, vt, vs, lengths, ctx, m, d, B, H, S, sb, st);
    case 2: return launch_bd<2, kNib>(q8, qs, kt, ks, vt, vs, lengths, ctx, m, d, B, H, S, sb, st);
    case 4: return launch_bd<4, kNib>(q8, qs, kt, ks, vt, vs, lengths, ctx, m, d, B, H, S, sb, st);
    case 8: return launch_bd<8, kNib>(q8, qs, kt, ks, vt, vs, lengths, ctx, m, d, B, H, S, sb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// #20 (sb = 0) and #21 (sb > 0, sb % 16 == 0, S % sb == 0) over the kv4
// slabs; #18 and #19 over the kv8 slabs.
int lc_attn_bd4(const void* q8, const void* qs, const void* kt4,
                const void* ks, const void* vt4, const void* vs,
                const void* lengths, void* ctx, void* m, void* d, int B,
                int H, int G, int S, int sb, void* stream) {
  return bd_dispatch<true>(q8, qs, kt4, ks, vt4, vs, lengths, ctx, m, d, B,
                           H, G, S, sb, stream);
}

int lc_attn_bd(const void* q8, const void* qs, const void* kt,
               const void* ks, const void* vt, const void* vs,
               const void* lengths, void* ctx, void* m, void* d, int B,
               int H, int G, int S, int sb, void* stream) {
  return bd_dispatch<false>(q8, qs, kt, ks, vt, vs, lengths, ctx, m, d, B,
                            H, G, S, sb, stream);
}

int lc_attn_i8(const void* q8, const void* qs, const void* kq, const void* ks,
               const void* vq, const void* vs, const void* kn,
               const void* kns, const void* vn, const void* vns,
               const void* lengths, void* out, int B, int H, int G, int S,
               void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return launch_i8<1>(q8, qs, kq, ks, vq, vs, kn, kns, vn, vns, lengths, out, B, H, S, st);
    case 2: return launch_i8<2>(q8, qs, kq, ks, vq, vs, kn, kns, vn, vns, lengths, out, B, H, S, st);
    case 4: return launch_i8<4>(q8, qs, kq, ks, vq, vs, kn, kns, vn, vns, lengths, out, B, H, S, st);
    case 8: return launch_i8<8>(q8, qs, kq, ks, vq, vs, kn, kns, vn, vns, lengths, out, B, H, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// #22: q (B, H, G, D) bf16; kq, vq (B, H, S, D) int8; ks, vs (B, H, S) bf16
// (scales_f32 = 0) or f32 (1); out (B, H, G, D) f32.  Any S >= 1.
int lc_attn_kv8(const void* q, const void* kq, const void* ks, const void* vq,
                const void* vs, void* out, int B, int H, int G, int S,
                int scales_f32, void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (scales_f32)
    return kv8_dispatch<float>(q, kq, ks, vq, vs, out, B, H, G, S, st);
  return kv8_dispatch<__nv_bfloat16>(q, kq, ks, vq, vs, out, B, H, G, S, st);
}

}  // extern "C"
