// BLS12-381 base field, its quadratic extension and Jacobian point
// arithmetic for the curve kernels (csrc/curve.cu).
//
// Counterpart of dvt_circuits_tpu/curve/{fp,g1,g2}.py.  The JAX package keeps
// an Fp element as 32 limbs of 12 bits so that every partial product and
// column sum fits in an int32 lane and the column sums become one product
// against a 0/1 band matrix on the TPU's matrix unit.  Hopper multiplies
// 32 x 32 -> 64 bits in its integer pipe, so here an element is 12 words of
// 32 bits and a product is one thread's CIOS Montgomery loop (Koç, Acar,
// Kaliski 1996) with 64-bit accumulators: 2 * 12^2 + 12 = 300 32-bit
// multiplies.  The Montgomery radix is 2^384 in both layouts, so the
// Montgomery value of an element is the same integer, and after the final
// conditional subtraction (every result is below p) the limbs the kernels
// write back are the JAX package's.
//
// The point formulas are the JAX package's (g1.py:add/double, g2.py): add
// is add-2007-bl (16 field products, and the 7 of the double it also
// computes), double is dbl-2009-l (7), and add selects its special cases in
// the JAX order, so a kernel that runs the JAX algorithm's additions in its
// order writes its Jacobian limbs.
//
// Every operation takes and returns its elements by value, so the
// product's operands, accumulator and result stay in registers (C1's
// kernel has no stack frame); passed by reference, an out-of-line call
// needs its operands' addresses, so its caller keeps every operand in its
// stack frame.  The product and the point operations stay out of line:
// inlined, a point addition made kernels of tens of thousands of
// instructions that miss the instruction cache and take minutes in ptxas.
// C1 and C3 run these one-thread forms; C2 and C4 run the point operations
// spread over the lanes of a warp (bls12_381_lanes.cuh), on the same
// product inlined.
#pragma once

#include <cstdint>

namespace bls {

constexpr int NW = 12;      // 32-bit words of an element
constexpr int NLIMBS = 32;  // 12-bit limbs of the port's int64 layout

__constant__ uint32_t kP[NW] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// R mod p, R = 2^384: one in Montgomery form
__constant__ uint32_t kOne[NW] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
constexpr uint32_t kInv = 0xfffcfffdu;  // -p^-1 mod 2^32

struct Fp {
  uint32_t w[NW];
};

struct Fp2 {
  Fp c0, c1;  // c0 + c1*u, u^2 = -1
};

template <class F>
struct Jac {
  F x, y, z;
};

using G1 = Jac<Fp>;
using G2 = Jac<Fp2>;

// -- Fp ----------------------------------------------------------------------

__device__ __forceinline__ Fp fp_zero() {
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = 0;
  return r;
}

__device__ __forceinline__ Fp fp_one() {
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = kOne[i];
  return r;
}

__device__ __forceinline__ bool is_zero(const Fp& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) acc |= a.w[i];
  return acc == 0;
}

// s - p if s >= p, else s (s < 2p)
__device__ __forceinline__ Fp reduce_once(const uint32_t (&s)[NW]) {
  uint32_t d[NW];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = static_cast<uint64_t>(s[i]) - kP[i] - borrow;
    d[i] = static_cast<uint32_t>(t);
    borrow = (t >> 32) & 1;
  }
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = borrow ? s[i] : d[i];
  return r;
}

__device__ __forceinline__ Fp add(const Fp& a, const Fp& b) {
  uint32_t s[NW];
  uint64_t carry = 0;  // a + b < 2p < 2^383: no carry out of the top word
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = static_cast<uint64_t>(a.w[i]) + b.w[i] + carry;
    s[i] = static_cast<uint32_t>(t);
    carry = t >> 32;
  }
  return reduce_once(s);
}

__device__ __forceinline__ Fp sub(const Fp& a, const Fp& b) {
  uint32_t d[NW];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = static_cast<uint64_t>(a.w[i]) - b.w[i] - borrow;
    d[i] = static_cast<uint32_t>(t);
    borrow = (t >> 32) & 1;
  }
  // a < b: the difference wrapped by 2^384; adding p brings it back
  Fp r;
  uint64_t carry = 0;
  const uint32_t mask = borrow ? 0xffffffffu : 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = static_cast<uint64_t>(d[i]) + (kP[i] & mask) + carry;
    r.w[i] = static_cast<uint32_t>(t);
    carry = t >> 32;
  }
  return r;
}

// a * b * 2^-384 mod p, in [0, p): CIOS, one word of b per round, with
// 64-bit accumulators (IMAD.WIDE).  Each round is a chain of dependent
// carries: the latency that sets the time of every one-thread point
// operation.  `mul` is the out-of-line call C1 and C3 make; the probe
// (lane_probe.cu) times this inline form beside it.
__device__ __forceinline__ Fp mont_mul_inline(const Fp& a, const Fp& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi = b.w[i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = static_cast<uint64_t>(a.w[j]) * bi + t[j] + c;
      t[j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    uint64_t s = static_cast<uint64_t>(t[NW]) + c;
    t[NW] = static_cast<uint32_t>(s);
    t[NW + 1] = static_cast<uint32_t>(s >> 32);
    const uint32_t m = t[0] * kInv;
    s = static_cast<uint64_t>(m) * kP[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = static_cast<uint64_t>(m) * kP[j] + t[j] + c;
      t[j - 1] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    s = static_cast<uint64_t>(t[NW]) + c;
    t[NW - 1] = static_cast<uint32_t>(s);
    t[NW] = t[NW + 1] + static_cast<uint32_t>(s >> 32);
  }
  // t < 2p < 2^383 lies in t[0..NW-1]
  uint32_t s[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) s[j] = t[j];
  return reduce_once(s);
}

__device__ __noinline__ Fp mul(Fp a, Fp b) { return mont_mul_inline(a, b); }

__device__ __forceinline__ Fp sqr(const Fp& a) { return mul(a, a); }

// -- Fp2 ---------------------------------------------------------------------

__device__ __forceinline__ Fp2 fp2_zero() { return {fp_zero(), fp_zero()}; }

__device__ __forceinline__ Fp2 fp2_one() { return {fp_one(), fp_zero()}; }

__device__ __forceinline__ bool is_zero(const Fp2& a) { return is_zero(a.c0) && is_zero(a.c1); }

__device__ __forceinline__ Fp2 add(const Fp2& a, const Fp2& b) {
  return {add(a.c0, b.c0), add(a.c1, b.c1)};
}

__device__ __forceinline__ Fp2 sub(const Fp2& a, const Fp2& b) {
  return {sub(a.c0, b.c0), sub(a.c1, b.c1)};
}

// Karatsuba, 3 base products (g2.py:f2_mul)
__device__ __noinline__ Fp2 mul(Fp2 a, Fp2 b) {
  const Fp t0 = mul(a.c0, b.c0);
  const Fp t1 = mul(a.c1, b.c1);
  const Fp t2 = mul(add(a.c0, a.c1), add(b.c0, b.c1));
  return {sub(t0, t1), sub(sub(t2, t0), t1)};
}

// (c0 + c1 u)^2 = (c0 + c1)(c0 - c1) + 2 c0 c1 u, 2 base products (g2.py:f2_sq)
__device__ __noinline__ Fp2 sqr(Fp2 a) {
  const Fp t1 = mul(a.c0, a.c1);
  return {mul(add(a.c0, a.c1), sub(a.c0, a.c1)), add(t1, t1)};
}

// -- Jacobian points, a = 0 ---------------------------------------------------

template <class F>
__device__ __forceinline__ Jac<F> identity();

template <>
__device__ __forceinline__ G1 identity<Fp>() {
  return {fp_zero(), fp_one(), fp_zero()};
}

template <>
__device__ __forceinline__ G2 identity<Fp2>() {
  return {fp2_zero(), fp2_one(), fp2_zero()};
}

// dbl-2009-l as g1.py:double writes it; the identity maps to Z = 0
template <class F>
__device__ __noinline__ Jac<F> dbl(Jac<F> p) {
  const F A = sqr(p.x);
  const F B = sqr(p.y);
  F C = sqr(B);
  F D = sub(sub(sqr(add(p.x, B)), A), C);
  D = add(D, D);  // 2((X + B)^2 - A - C)
  const F E = add(add(A, A), A);
  const F Fv = sqr(E);
  Jac<F> r;
  const F yz = mul(p.y, p.z);
  r.z = add(yz, yz);
  r.x = sub(Fv, add(D, D));
  C = add(C, C);
  C = add(C, C);
  C = add(C, C);
  r.y = sub(mul(E, sub(D, r.x)), C);
  return r;
}

// add-2007-bl as g1.py:add writes it, branch-free as it is there: every
// lane computes the sum and the double, then takes the special cases in
// the order of its selects (P = Q -> 2P; P = -Q -> inf; Q = inf -> P;
// P = inf -> Q).  The double costs 7 products an addition that a
// branching form would skip, but with early returns, lanes of one warp
// that left an addition while others were still inside it and called it
// again faulted on the H100 (an illegal address with 32 lanes a warp, none
// with one); here all lanes make the same calls.
template <class F>
__device__ __noinline__ Jac<F> add(Jac<F> p, Jac<F> q) {
  const F z1z1 = sqr(p.z), z2z2 = sqr(q.z);
  const F u1 = mul(p.x, z2z2), u2 = mul(q.x, z1z1);
  F s1 = mul(mul(p.y, q.z), z2z2);
  const F s2 = mul(mul(q.y, p.z), z1z1);
  const F h = sub(u2, u1);
  F rr = sub(s2, s1);
  rr = add(rr, rr);  // r = 2(S2 - S1)
  const F i = sqr(add(h, h));
  const F j = mul(h, i), v = mul(u1, i);
  Jac<F> o;
  o.x = sub(sub(sqr(rr), j), add(v, v));
  s1 = mul(s1, j);
  o.y = sub(mul(rr, sub(v, o.x)), add(s1, s1));
  o.z = mul(sub(sub(sqr(add(p.z, q.z)), z1z1), z2z2), h);
  const Jac<F> d = dbl(p);
  const bool p_inf = is_zero(p.z), q_inf = is_zero(q.z);
  const bool same_x = is_zero(h), same_y = is_zero(rr);
  if (same_x && same_y) o = d;
  if (same_x && !same_y && !p_inf && !q_inf) o = identity<F>();
  if (q_inf) o = p;
  if (p_inf) o = q;
  return o;
}

// -- the port's int64 layout: 32 limbs of 12 bits per element ------------------

__device__ __forceinline__ Fp load(const int64_t* limbs) {
  Fp r;
  uint64_t acc = 0;
  int bits = 0, w = 0;
#pragma unroll
  for (int i = 0; i < NLIMBS; ++i) {
    acc |= static_cast<uint64_t>(limbs[i]) << bits;
    bits += 12;
    if (bits >= 32) {
      r.w[w++] = static_cast<uint32_t>(acc);
      acc >>= 32;
      bits -= 32;
    }
  }
  return r;
}

__device__ __forceinline__ void store(int64_t* limbs, const Fp& a) {
#pragma unroll
  for (int i = 0; i < NLIMBS; ++i) {
    const int bit = 12 * i, word = bit / 32, off = bit % 32;
    uint32_t v = a.w[word] >> off;
    if (off > 20) v |= a.w[word + 1] << (32 - off);
    limbs[i] = static_cast<int64_t>(v & 0xfffu);
  }
}

}  // namespace bls
