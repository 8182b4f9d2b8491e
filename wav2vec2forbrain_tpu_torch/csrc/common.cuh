// Shared helpers for the hand-written Hopper kernels of wav2vec2forbrain_tpu_torch.
//
// Every kernel in this directory is exported through a plain C function
// (extern "C") that launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() as an int; ops/kernels.py binds them with ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w2vb {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value through the compute dtype: identity at f32, round to
// nearest even bf16 and back at bf16 (what `x.astype(compute_dtype)` does
// before a product in the JAX package).
__device__ __forceinline__ float round_cd(float v, bool cd_bf16) {
  return cd_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// Two consecutive bf16 values (4-byte aligned) as one register: the pair
// that an mma.sync fragment holds.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 values rounded to nearest-even bf16, packed (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c (a 16 x 8 f32 tile's fragment) += a (16 x 16) . b (16 x 8) on the tensor
// cores, bf16 inputs (mma.sync.m16n8k16).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero): half an ulp of TF32 added to the magnitude bits, the 13 bits below
// it cleared. Two integer operations at the full ALU rate; the cvt issues
// at a fraction of it (the kernels split by cvt were slower: PERF.md).
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = big + small + (a remainder ~2^-22 of x), both TF32: the operand split
// of the split-TF32 ("3xTF32") products, which keep ~22 bits of each
// product where one TF32 pass keeps 11
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c (a 16 x 8 f32 tile's fragment) += a (16 x 8) . b (8 x 8), TF32 inputs
// (mma.sync.m16n8k8). A fragment: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B fragment: b0 (k = t, n = g), b1 (k = t + 4, n = g);
// lane = 4 g + t.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async, L2 only); zfill: the bytes past src_bytes (0 or 16) are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stateless attention dropout, the hash of the JAX package's
// ops/pallas_attention.py::_keep_mask / _mix (and xla_attention.py::
// hash_keep_mask): a murmur3 finalizer over (seed, batch row, head, q row,
// k col) with the same constants. uint32 arithmetic wraps as in XLA.
__device__ __forceinline__ uint32_t murmur_finalize(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t attn_mix(uint32_t seed, uint32_t row, uint32_t head) {
  return seed * 0x27D4EB2Fu + row * 0x165667B1u + head * 0x9E3779B9u;
}

// keep (true) or drop query row r, key column c: the 24 high bits of the
// hash as an exact f32 uniform in [0, 1), compared with keep_prob in f32
__device__ __forceinline__ bool attn_keep(uint32_t mix, uint32_t r, uint32_t c, float keep_prob) {
  const uint32_t x = murmur_finalize(mix + r * 0x9E3779B9u + c * 0x85EBCA6Bu);
  const float u = static_cast<float>(static_cast<int>(x >> 8)) * (1.0f / 16777216.0f);
  return u < keep_prob;
}

// Blocks that need more than the 48 KB default opt in to the larger
// dynamic shared memory carve-out (up to 227 KB on Hopper).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace w2vb
