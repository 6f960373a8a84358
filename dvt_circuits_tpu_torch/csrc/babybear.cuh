// BabyBear field arithmetic (p = 15·2^27 + 1) for the port's CUDA kernels.
//
// Counterpart of dvt_circuits_tpu/field/babybear.py.  Values are uint32 in
// [0, p).  Products use Montgomery form (R = 2^32) inside a kernel: one
// 32x32->64 multiply, one low multiply by -p^-1 and one wide multiply-add,
// instead of a 64-bit modulo.  Kernels take and return standard form and
// convert at their edges (to_mont / from_mont).
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

}  // namespace bb
