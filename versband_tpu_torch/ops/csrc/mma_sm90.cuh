// PTX helpers shared by the tensor-core kernels (flash_attn_fwd.cu: K1;
// flash_attn_bwd.cu: K2, K3; fused_wavenet.cu: K5) and K4's copies:
// asynchronous copies into shared memory, ldmatrix, warp-level mma.sync in
// bf16 and TF32, the bf16 pack and TF32 head/tail splits that feed it, and
// one k-step of a product in either type (mma_step: one bf16 mma, or three
// TF32 passes). Each source includes this header once; the helpers live in an
// anonymous namespace, so every library has its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from device to shared memory, asynchronously; `bytes` of them (16
// or 0) are read, the rest is filled with zeros.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// x = head + tail: the head is x rounded to TF32 (cvt.rna, 10-bit mantissa),
// the tail the exact fp32 rest, of which the tensor core reads the upper 10
// mantissa bits (a TF32 operand's low 13 bits are not read on sm_90), so
// head + tail-as-read is x to 2^-21. Rounding the tail with a second cvt.rna
// costs a second half-rate conversion per element for nothing measurable.
__device__ __forceinline__ void split_tf32(float x, uint32_t& head, uint32_t& tail) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(head) : "f"(x));
  tail = __float_as_uint(x - __uint_as_float(head));
}

// x = head + tail with the head x cut to TF32 (its low 13 bits cleared: one
// AND instead of cvt.rna's conversion) and the tail the exact fp32 rest, of
// which the tensor core reads the upper 10 mantissa bits: head + tail-as-read
// is x to 2^-20, where split_tf32 gives 2^-21. K5 splits every operand as it
// loads it, and there cvt.rna cost 0.2-0.3 ms a layer (kernel_variants.py).
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& head, uint32_t& tail) {
  head = __float_as_uint(x) & 0xffffe000u;
  tail = __float_as_uint(x - __uint_as_float(head));
}

// An A operand of one k-step: for bf16 the packed fragment in `head`; for
// fp32 the TF32 heads and tails of its four values.
struct AFrag {
  uint32_t head[4];
  uint32_t tail[4];
};

// One k-step. bf16: c += a b in one m16n8k16. fp32 (b0, b1 hold fp32 values):
// three m16n8k8 TF32 passes, the two small terms (tail.head, head.tail) into
// `small`, head.head into `c`; the caller adds the two once its chain ends,
// or passes the same accumulator twice (small terms first).
template <bool BF16>
__device__ __forceinline__ void mma_step(float (&c)[4], float (&small)[4], const AFrag& a,
                                         uint32_t b0, uint32_t b1) {
  if constexpr (BF16) {
    mma_bf16(c, a.head, b0, b1);
  } else {
    uint32_t h0, t0, h1, t1;
    split_tf32(__uint_as_float(b0), h0, t0);
    split_tf32(__uint_as_float(b1), h1, t1);
    mma_tf32(small, a.tail, h0, h1);
    mma_tf32(small, a.head, t0, t1);
    mma_tf32(c, a.head, h0, h1);
  }
}

}  // namespace
