// f32-accurate products on TF32 tensor cores (3xTF32), shared by
// flash_attention.cu and rwkv_scan.cu.  Each operand is split into
// hi = tf32(x) and lo = tf32(x - hi), and mma.sync.m16n8k8 accumulates
// lo*hi + hi*lo + hi*hi in f32; the dropped lo*lo term is ~2^-22
// relative.  kernels/ref.py (tf32_rna, mm_3xtf32) emulates it exactly.
//
// Fragment layouts of m16n8k8 (lane = 4 g + tg): A a0 (g, tg), a1 (g+8,
// tg), a2 (g, tg+4), a3 (g+8, tg+4); B b0 (k tg, n g), b1 (k tg+4, n g);
// C c0 (g, 2tg), c1 (g, 2tg+1), c2 (g+8, 2tg), c3 (g+8, 2tg+1).
#pragma once

#include <stdint.h>

// cvt.rna.tf32.f32 for finite x: add half a TF32 ulp to the magnitude
// bits and clear the 13 bits below the TF32 mantissa (round to nearest,
// ties away from zero).  Two integer operations at the full rate, where
// the conversion instruction runs on the slower conversion pipe.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi, lo TF32 values (lo holds the next 11 bits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
