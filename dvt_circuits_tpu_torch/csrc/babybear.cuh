// BabyBear field arithmetic (p = 15·2^27 + 1) for the port's CUDA kernels.
//
// Counterpart of dvt_circuits_tpu/field/babybear.py.  Values are uint32 in
// [0, p).  Products use Montgomery form (R = 2^32) inside a kernel: one
// 32x32->64 multiply, one low multiply by -p^-1 and one wide multiply-add,
// instead of a 64-bit modulo.  Kernels take and return standard form and
// convert at their edges (to_mont / from_mont).  Montgomery form is linear,
// so sums and products by small integers stay in it; such sums are kept
// wide (uint64) and reduced once (reduce_loose).  The *_loose functions
// return a representative that may exceed p by a bounded amount; each
// states its bound.
#pragma once

#include <cstdint>

namespace bb {

constexpr uint32_t P = 2013265921u;        // 15 * 2^27 + 1
constexpr uint32_t NPRIME = 2013265919u;   // -p^-1 mod 2^32
constexpr uint32_t R2 = 1172168163u;       // 2^64 mod p

__host__ __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // < 2p < 2^32
  return s >= P ? s - P : s;
}

__host__ __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + (P - b);
}

// t < 2^32 * p  ->  t * 2^-32 mod p, in [0, p)
__host__ __device__ __forceinline__ uint32_t mont_reduce(uint64_t t) {
  uint32_t m = static_cast<uint32_t>(t) * NPRIME;
  uint64_t u = (t + static_cast<uint64_t>(m) * P) >> 32;  // < 2p
  uint32_t r = static_cast<uint32_t>(u);
  return r >= P ? r - P : r;
}

__host__ __device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  return mont_reduce(static_cast<uint64_t>(a) * b);
}

// any uint32 (not only < p) maps to its residue in Montgomery form
__host__ __device__ __forceinline__ uint32_t to_mont(uint32_t a) {
  return mont_mul(a, R2);
}

__host__ __device__ __forceinline__ uint32_t from_mont(uint32_t a) {
  return mont_reduce(a);
}

// Montgomery reduction without the final subtract: t·2^-32 mod p as a value
// below t/2^32 + p, for t < 2^64 − (2^32 − 1)·p ≈ 2.4178·p² (so that t + m·p
// fits 64 bits, m < 2^32, and the result 32).
__host__ __device__ __forceinline__ uint32_t mont_reduce_loose(uint64_t t) {
  uint32_t m = static_cast<uint32_t>(t) * NPRIME;
  return static_cast<uint32_t>((t + static_cast<uint64_t>(m) * P) >> 32);
}

__host__ __device__ __forceinline__ uint32_t mont_mul_loose(uint32_t a, uint32_t b) {
  return mont_reduce_loose(static_cast<uint64_t>(a) * b);
}

constexpr uint32_t BARRETT_M = 139810;  // floor(2^48 / p)

// w < 2^39 -> a value congruent to w below 1.0003·p (not always below p):
// q = floor((w >> 16)·floor(2^48/p) / 2^32) is at most w/p and at least
// w/p − 1.0003, so w − q·p fits 32 bits.  One shift and two multiplies
// (one a multiply-add), instead of a chain of conditional subtracts.
__host__ __device__ __forceinline__ uint32_t reduce_loose(uint64_t w) {
  uint32_t x = static_cast<uint32_t>(w >> 16);
  uint32_t q = static_cast<uint32_t>((static_cast<uint64_t>(x) * BARRETT_M) >> 32);
  return static_cast<uint32_t>(w) - q * P;
}

}  // namespace bb
