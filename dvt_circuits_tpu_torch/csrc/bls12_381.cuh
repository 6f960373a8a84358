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
// Field products and point operations are __noinline__: a point addition
// inlined everywhere made kernels of tens of thousands of instructions that
// miss the instruction cache and take minutes in ptxas.
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

__device__ __forceinline__ void set_zero(Fp& r) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = 0;
}

__device__ __forceinline__ void set_one(Fp& r) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = kOne[i];
}

__device__ __forceinline__ bool is_zero(const Fp& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) acc |= a.w[i];
  return acc == 0;
}

// r = s - p if s >= p, else s (s < 2p)
__device__ __forceinline__ void reduce_once(Fp& r, const uint32_t (&s)[NW]) {
  uint32_t d[NW];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = static_cast<uint64_t>(s[i]) - kP[i] - borrow;
    d[i] = static_cast<uint32_t>(t);
    borrow = (t >> 32) & 1;
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = borrow ? s[i] : d[i];
}

__device__ __forceinline__ void add(Fp& r, const Fp& a, const Fp& b) {
  uint32_t s[NW];
  uint64_t carry = 0;  // a + b < 2p < 2^383: no carry out of the top word
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = static_cast<uint64_t>(a.w[i]) + b.w[i] + carry;
    s[i] = static_cast<uint32_t>(t);
    carry = t >> 32;
  }
  reduce_once(r, s);
}

__device__ __forceinline__ void sub(Fp& r, const Fp& a, const Fp& b) {
  uint32_t d[NW];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = static_cast<uint64_t>(a.w[i]) - b.w[i] - borrow;
    d[i] = static_cast<uint32_t>(t);
    borrow = (t >> 32) & 1;
  }
  // a < b: the difference wrapped by 2^384; adding p brings it back
  uint64_t carry = 0;
  const uint32_t mask = borrow ? 0xffffffffu : 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = static_cast<uint64_t>(d[i]) + (kP[i] & mask) + carry;
    r.w[i] = static_cast<uint32_t>(t);
    carry = t >> 32;
  }
}

// r = a * b * 2^-384 mod p, in [0, p): CIOS, one word of b per round
__device__ __noinline__ void mul(Fp& r, const Fp& a, const Fp& b) {
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
  reduce_once(r, s);
}

// -- Fp2 ---------------------------------------------------------------------

__device__ __forceinline__ void set_zero(Fp2& r) {
  set_zero(r.c0);
  set_zero(r.c1);
}

__device__ __forceinline__ void set_one(Fp2& r) {
  set_one(r.c0);
  set_zero(r.c1);
}

__device__ __forceinline__ bool is_zero(const Fp2& a) { return is_zero(a.c0) && is_zero(a.c1); }

__device__ __forceinline__ void add(Fp2& r, const Fp2& a, const Fp2& b) {
  add(r.c0, a.c0, b.c0);
  add(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void sub(Fp2& r, const Fp2& a, const Fp2& b) {
  sub(r.c0, a.c0, b.c0);
  sub(r.c1, a.c1, b.c1);
}

// Karatsuba, 3 base products (g2.py:f2_mul)
__device__ __noinline__ void mul(Fp2& r, const Fp2& a, const Fp2& b) {
  Fp t0, t1, t2, sa, sb;
  mul(t0, a.c0, b.c0);
  mul(t1, a.c1, b.c1);
  add(sa, a.c0, a.c1);
  add(sb, b.c0, b.c1);
  mul(t2, sa, sb);
  sub(r.c0, t0, t1);
  sub(t2, t2, t0);
  sub(r.c1, t2, t1);
}

// (c0 + c1 u)^2 = (c0 + c1)(c0 - c1) + 2 c0 c1 u, 2 base products (g2.py:f2_sq)
__device__ __noinline__ void sqr(Fp2& r, const Fp2& a) {
  Fp s, d, t1;
  add(s, a.c0, a.c1);
  sub(d, a.c0, a.c1);
  mul(t1, a.c0, a.c1);
  mul(r.c0, s, d);
  add(r.c1, t1, t1);
}

__device__ __forceinline__ void sqr(Fp& r, const Fp& a) { mul(r, a, a); }

// -- Jacobian points, a = 0 ---------------------------------------------------

template <class F>
__device__ __forceinline__ void set_identity(Jac<F>& p) {
  set_zero(p.x);
  set_one(p.y);
  set_zero(p.z);
}

// dbl-2009-l as g1.py:double writes it; the identity maps to Z = 0
template <class F>
__device__ __noinline__ void dbl(Jac<F>& r, const Jac<F>& p) {
  F A, B, C, t, D, E, Fv, u;
  sqr(A, p.x);
  sqr(B, p.y);
  sqr(C, B);
  add(t, p.x, B);
  sqr(t, t);
  sub(D, t, A);
  sub(D, D, C);
  add(D, D, D);  // 2((X + B)^2 - A - C)
  add(E, A, A);
  add(E, E, A);
  sqr(Fv, E);
  F Z3;
  mul(Z3, p.y, p.z);
  add(r.z, Z3, Z3);
  add(u, D, D);
  sub(r.x, Fv, u);
  sub(u, D, r.x);
  mul(u, E, u);
  add(C, C, C);
  add(C, C, C);
  add(C, C, C);
  sub(r.y, u, C);
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
__device__ __noinline__ void add(Jac<F>& r, const Jac<F>& p, const Jac<F>& q) {
  F z1z1, z2z2, u1, u2, s1, s2, h, rr, t, i, j, v;
  sqr(z1z1, p.z);
  sqr(z2z2, q.z);
  mul(u1, p.x, z2z2);
  mul(u2, q.x, z1z1);
  mul(s1, p.y, q.z);
  mul(s1, s1, z2z2);
  mul(s2, q.y, p.z);
  mul(s2, s2, z1z1);
  sub(h, u2, u1);
  sub(rr, s2, s1);
  add(rr, rr, rr);  // r = 2(S2 - S1)
  add(t, h, h);
  sqr(i, t);
  mul(j, h, i);
  mul(v, u1, i);
  Jac<F> o;
  sqr(o.x, rr);
  sub(o.x, o.x, j);
  add(t, v, v);
  sub(o.x, o.x, t);
  mul(s1, s1, j);
  add(s1, s1, s1);
  sub(t, v, o.x);
  mul(o.y, rr, t);
  sub(o.y, o.y, s1);
  add(t, p.z, q.z);
  sqr(t, t);
  sub(t, t, z1z1);
  sub(t, t, z2z2);
  mul(o.z, t, h);
  Jac<F> d;
  dbl(d, p);
  const bool p_inf = is_zero(p.z), q_inf = is_zero(q.z);
  const bool same_x = is_zero(h), same_y = is_zero(rr);
  if (same_x && same_y) o = d;
  if (same_x && !same_y && !p_inf && !q_inf) set_identity(o);
  if (q_inf) o = p;
  if (p_inf) o = q;
  r = o;
}

// -- the port's int64 layout: 32 limbs of 12 bits per element ------------------

__device__ __forceinline__ void load(Fp& r, const int64_t* limbs) {
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

__device__ __forceinline__ void load(Fp2& r, const int64_t* limbs) {
  load(r.c0, limbs);
  load(r.c1, limbs + NLIMBS);
}

__device__ __forceinline__ void store(int64_t* limbs, const Fp2& a) {
  store(limbs, a.c0);
  store(limbs + NLIMBS, a.c1);
}

// -- the algorithms, one thread each -------------------------------------------

constexpr int SCALAR_BITS = 256;
constexpr int WINDOW_BITS = 4;
constexpr int NUM_WINDOWS = SCALAR_BITS / WINDOW_BITS;

// g1.py:scalar_mul_windowed for one point: T[j] = j*P by 14 additions, then
// 64 base-16 digits MSB-first, 4 doublings and one table addition each (a
// zero digit adds T[0], the identity, as the JAX loop does: where the
// accumulator is still the identity that returns T[0]'s limbs)
__device__ __noinline__ void windowed_mul(G1& acc, const G1& p, const int32_t* digits) {
  G1 table[16];
  set_identity(table[0]);
  table[1] = p;
  for (int j = 2; j < 16; ++j) add(table[j], table[j - 1], p);
  set_identity(acc);
  for (int w = 0; w < NUM_WINDOWS; ++w) {
    for (int k = 0; k < WINDOW_BITS; ++k) dbl(acc, acc);
    add(acc, acc, table[digits[w]]);
  }
}

// g2.py:scalar_mul for one point: 256 rounds of double, then add where the
// bit (little-endian order in `bits`) is set
__device__ __noinline__ void double_and_add(G2& acc, const G2& p, const int32_t* bits) {
  set_identity(acc);
  for (int i = SCALAR_BITS - 1; i >= 0; --i) {
    dbl(acc, acc);
    if (bits[i]) add(acc, acc, p);
  }
}

}  // namespace bls
