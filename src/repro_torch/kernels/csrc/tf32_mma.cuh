// Float32 products on the tensor cores in split TF32 ("3xTF32"), and the
// asynchronous copies that feed them.  Shared by the chunked WKV kernel
// (linear_scan.cu) and the float32 flash kernel (flash_attention.cu).
//
// mma.sync.m16n8k8 in TF32 reads 10 of a float32's 23 mantissa bits.  Each
// float32 operand x is cut into hi = tf32(x) and lo = tf32(x - hi), so that
// x = hi + lo to ~2^-21, and a product a b is hi.hi + the two cross terms
// (lo.lo, ~2^-22 of it, is dropped), each accumulated in float32.  An
// operand that is a bf16 value is exact in TF32: it is its own hi, and the
// product takes two mma.  The including file defines TF32_SPLIT: 1 for the
// split, 0 for plain TF32 (one product; for the ablation tools only).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef TF32_SPLIT
#error "define TF32_SPLIT (1: split TF32, 0: plain TF32) before including tf32_mma.cuh"
#endif

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// An operand fragment of mma.m16n8k8 in TF32: hi, and with the split, lo,
// with x = hi + lo to ~2^-21.  An operand that is EXACT (a bf16 value) is
// its own hi.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

// Split x into TF32 hi and lo in integer operations: hi rounded to nearest
// (ties away from zero, as cvt.rna) by adding half a TF32 ulp and clearing
// the low 13 bits; lo = x - hi (exact) passed whole, the tensor core
// reading only its top bits (lo truncated to TF32, ~2^-21 of x).  cvt.rna
// costs four instructions on sm_90 where this costs two.
template <bool EXACT, int N>
__device__ __forceinline__ Frag<N> split_frag(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (EXACT) {
      f.hi[e] = __float_as_uint(x[e]);
      f.lo[e] = 0u;
    } else {
      f.hi[e] = (__float_as_uint(x[e]) + 0x1000u) & 0xffffe000u;
      f.lo[e] = TF32_SPLIT ? __float_as_uint(x[e] - __uint_as_float(f.hi[e])) : 0u;
    }
  }
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a b in split TF32: hi.hi into d, the small terms into dlo (their own
// accumulator, so that the three products of a step do not wait on each
// other); the caller adds dlo to d at the end.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_split(float (&d)[4], float (&dlo)[4], const Frag<4>& a,
                                          const Frag<2>& b) {
  if (TF32_SPLIT && !A_EXACT) mma_tf32(dlo, a.lo, b.hi);
  if (TF32_SPLIT && !B_EXACT) mma_tf32(dlo, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

}  // namespace
