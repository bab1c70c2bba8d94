// The register pieces of the bf16 tensor-core tiles of Hopper (sm_90a):
// #1 and #4 (w4a16_tile.cu) and #7 (w4_moe.cu) run mma.sync m16n8k16 bf16
// with 16 channels as A and 8 tokens as B, the A registers unpacked from
// planes words in registers.
#pragma once

#include "w4_mma.cuh"

namespace lcw4 {

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a - b on bf16x2 (as a * 1 + (-b)), exact on the small integers here
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3F803F80u), "r"(b ^ 0x80008000u));
  return d;
}

// a * b on bf16x2, each half rounded once to nearest even (as a * b +
// (-0): the product of two bf16 values is exact before that rounding)
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// byte b of word lo in bits 0-7 and of word hi in bits 16-23
__device__ __forceinline__ uint32_t byte_pair(uint32_t lo, uint32_t hi,
                                              int b) {
  return __byte_perm(lo, hi, (uint32_t)(b | (b << 4) | ((4 + b) << 8) |
                                        ((4 + b) << 12)));
}

// The bf16x2 A register of two codes from a byte pair p (byte_pair): the
// low (nib 0) or high (nib 1) nibbles as 128 + c, less 128; with kSigned
// (masked plane 7) as 128 + (c ^ 8), less 136: c - 8.
template <bool kSigned>
__device__ __forceinline__ uint32_t code_pair(uint32_t p, int nib) {
  const uint32_t v = (nib ? p >> 4 : p) & 0x000F000Fu;
  return kSigned ? bf16x2_sub(v ^ 0x43084308u, 0x43084308u)
                 : bf16x2_sub(v | 0x43004300u, 0x43004300u);
}

// two int8 values (a in the low half) as bf16x2, exactly
__device__ __forceinline__ uint32_t i8_pair_bf16(int a, int b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(exact_f32(a), exact_f32(b));
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace lcw4
