// Point operations spread over the lanes of a warp, for kernels C2 and C4
// (csrc/curve.cu).
//
// In one thread (bls12_381.cuh) a point operation is a chain of dependent
// Fp products, one after another, though many of them are independent.
// Here a point operation is a program (bls12_381_progs.cuh, written by
// curve/lanes.py): in each step every lane of the point's group does at
// most one Fp operation, a Montgomery product or a sum or difference
// 2^k1 (a +- 2^k2 b), on slots of 12 words in shared memory, and the warp
// meets at __syncwarp between steps.  A product costs a warp the same
// whether one lane or 32 issue it (~2,500 cycles of carry chains; the
// probe, csrc/lane_probe.cu), and a step of sums alone about an eighth of
// that, so the scheduler puts each wave of products in one step and the
// formulas avoid sums before products:
//   g1_dbl   8 steps, 3 with products, for 7 products;
//   g1_add   9 steps, 5 with products, for 16;
//   g2_dbl  10 steps, 3 with products, for 24 base products (schoolbook);
//   g2_add  14 steps, 5 with products, for 60.
// Every product and sum is fully reduced into [0, p), so any order of the
// JAX formulas gives the same limbs.
//
// G1 (C2) takes 4 lanes a point, 8 points a warp: its doubling's product
// steps hold 3 products, its addition's at most 4.  Every group of a warp
// runs the same steps; the JAX add's double (its P = Q case) runs only
// when a group of the warp takes it, a branch made uniform by a vote.
// G2 (C4) takes a warp a point, so a branch on its data is uniform across
// the warp: C4 adds only where the scalar's bit is set, skips the addition
// when an operand is the identity, and doubles inside it only when P = Q.
// The JAX code computes all of these every round and selects the same
// values, so the limbs are its own.
//
// `run`, the interpreter of the programs, is the only caller of the
// product, which it inlines (CIOS, bls::mont_mul_inline): one copy of the
// product a kernel, and no call through the stack a product.  The kernels
// keep their points and tables in shared memory, so nothing is indexed in
// local memory.  The host test (tests/test_torch_curve_host.py) builds this
// header with g++, a thread a lane and __syncwarp a barrier.
#pragma once

#include "bls12_381.cuh"
#include "bls12_381_progs.cuh"

namespace bls::lanes {

constexpr unsigned kFull = 0xffffffffu;
constexpr int PW = 3 * NW;  // words of a G1 point: x, y, z
constexpr int kG1Lanes = progs::kG1AddLanes;
constexpr int kG2Lanes = progs::kG2AddLanes;
constexpr int kG1Slots =
    progs::kG1AddSlots > progs::kG1DblSlots ? progs::kG1AddSlots : progs::kG1DblSlots;
constexpr int kG2Slots =
    progs::kG2AddSlots > progs::kG2DblSlots ? progs::kG2AddSlots : progs::kG2DblSlots;
static_assert(progs::kG1DblLanes == kG1Lanes && progs::kG2DblLanes == kG2Lanes, "lanes");
static_assert(32 % kG1Lanes == 0 && kG2Lanes == 32, "groups tile a warp");

constexpr int SCALAR_BITS = 256;
constexpr int WINDOW_BITS = 4;
constexpr int NUM_WINDOWS = SCALAR_BITS / WINDOW_BITS;

// An element's 12 words, at an address aligned to 16 bytes: on the card
// three 16-byte loads or stores (every slot file, slot and point the kernels
// pass is so aligned)
__device__ __forceinline__ Fp get(const uint32_t* s) {
  Fp r;
#ifdef __CUDA_ARCH__
  const uint4* v = reinterpret_cast<const uint4*>(s);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint4 q = v[k];
    r.w[4 * k] = q.x;
    r.w[4 * k + 1] = q.y;
    r.w[4 * k + 2] = q.z;
    r.w[4 * k + 3] = q.w;
  }
#else
  for (int i = 0; i < NW; ++i) r.w[i] = s[i];
#endif
  return r;
}

__device__ __forceinline__ void put(uint32_t* s, const Fp& a) {
#ifdef __CUDA_ARCH__
  uint4* v = reinterpret_cast<uint4*>(s);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    v[k] = make_uint4(a.w[4 * k], a.w[4 * k + 1], a.w[4 * k + 2], a.w[4 * k + 3]);
#else
  for (int i = 0; i < NW; ++i) s[i] = a.w[i];
#endif
}

// Words of a group's shared memory for `words` of its own: padded to 4 more
// than a multiple of 32, so that the groups of a warp, which read the same
// slot at each step, meet different banks; a multiple of 4, so that slots
// stay aligned to 16 bytes
__host__ __device__ constexpr int group_stride(int words) { return words + (36 - words % 32) % 32; }

// -- the lanes' sum and the interpreter -----------------------------------------

// a + b, or a - b where subtract is set, fully reduced (a, b < p).  Two
// chains side by side: s = a + b and d = a + b - p (take d where a + b >=
// p), or s = a - b and d = a - b + p (take d where a < b).
__device__ __forceinline__ Fp lin(const Fp& a, const Fp& b, bool subtract) {
  uint32_t s[NW], d[NW];
  uint64_t cs = subtract, cd = 1;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi = subtract ? ~b.w[i] : b.w[i];
    const uint64_t ts = static_cast<uint64_t>(a.w[i]) + bi + cs;
    s[i] = static_cast<uint32_t>(ts);
    cs = ts >> 32;
    const uint64_t td =
        static_cast<uint64_t>(a.w[i]) + bi + (subtract ? kP[i] : ~kP[i]) + cd;
    d[i] = static_cast<uint32_t>(td);
    cd = td >> 32;
  }
  // a + b: cd = 1 where a + b - p >= 0; a - b: cs = 1 where a >= b
  const bool take_d = subtract ? cs == 0 : (cd & 1) != 0;
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = take_d ? d[i] : s[i];
  return r;
}

// 2a mod p: a shift of independent words (a < p < 2^381, so no bit leaves
// the top word), then the one borrow chain of the conditional subtraction
__device__ __forceinline__ Fp twice(const Fp& a) {
  uint32_t s[NW];
  s[0] = a.w[0] << 1;
#pragma unroll
  for (int i = 1; i < NW; ++i) s[i] = a.w[i] << 1 | a.w[i - 1] >> 31;
  return reduce_once(s);
}

// One program over a group of `lanes` lanes (lane in [0, lanes)) and its
// slots; every lane of the warp runs the same steps.  The next step's
// operation is fetched before this step's work.
__device__ __noinline__ void run(const uint32_t* prog, int steps, int lanes, uint32_t* slots,
                                 int lane) {
  uint32_t op = __ldg(prog + lane);
  for (int s = 0; s < steps; ++s) {
    const uint32_t next = s + 1 < steps ? __ldg(prog + (s + 1) * lanes + lane) : 0u;
    const uint32_t kind = op >> 30;
    if (kind != 0) {
      const Fp a = get(slots + ((op >> 8) & 255u) * NW);
      Fp b = get(slots + (op & 255u) * NW);
      Fp r;
      if (kind == 1) {
        r = mont_mul_inline(a, b);
      } else {  // 2^k1 (a +- 2^k2 b)
        for (uint32_t j = 0; j < ((op >> 26) & 3u); ++j) b = twice(b);
        r = lin(a, b, kind == 3);
        for (uint32_t j = 0; j < ((op >> 28) & 3u); ++j) r = twice(r);
      }
      put(slots + ((op >> 16) & 255u) * NW, r);
    }
    __syncwarp(kFull);
    op = next;
  }
}

// The point in slots 0 .. 3E - 1 (3 coordinates of E elements) = slots
// outs[0 ..] (outs != nullptr), else slots first .. (first >= 0), else the
// identity (0, 1, 0); by the lanes of a group.  The caller syncs after.
template <int E>
__device__ __forceinline__ void set_point(uint32_t* slots, const int* outs, int first, int lane,
                                          int lanes) {
  for (int k = lane; k < 3 * E * NW; k += lanes) {
    const int e = k / NW, i = k % NW;
    uint32_t v;
    if (outs != nullptr) {
      v = slots[outs[e] * NW + i];
    } else if (first >= 0) {
      v = slots[(first + e) * NW + i];
    } else {
      v = e == E ? kOne[i] : 0u;
    }
    slots[k] = v;
  }
}

__device__ __forceinline__ bool slot_zero(const uint32_t* slots, int k) {
  return is_zero(get(slots + k * NW));
}

// -- G1, a group of kG1Lanes lanes a point: p in slots 0..2, q in 3..5 ---------

// p = 2p
__device__ __forceinline__ void g1_dbl(uint32_t* slots, int lane) {
  run(progs::kG1Dbl, progs::kG1DblSteps, kG1Lanes, slots, lane);
  set_point<1>(slots, progs::kG1DblOut, 0, lane, kG1Lanes);
  __syncwarp(kFull);
}

// p = p + q with g1.py:add's selects, in its order: P = Q -> 2P; P = -Q ->
// inf; Q = inf -> P; P = inf -> Q.  The groups of a warp run the same
// steps; the double runs only when a group of the warp takes it (a vote:
// the branch is uniform), after the other groups have taken their result.
__device__ __forceinline__ void g1_add(uint32_t* slots, int lane) {
  run(progs::kG1Add, progs::kG1AddSteps, kG1Lanes, slots, lane);
  const int* out = progs::kG1AddOut;  // sum 0..2, H 3, r' 4
  const bool p_inf = slot_zero(slots, 2), q_inf = slot_zero(slots, 5);
  const bool same_x = slot_zero(slots, out[3]), same_y = slot_zero(slots, out[4]);
  const bool twice = same_x && same_y && !p_inf && !q_inf;
  __syncwarp(kFull);  // every lane has read its flags before p changes
  if (p_inf) {
    set_point<1>(slots, nullptr, 3, lane, kG1Lanes);
  } else if (!q_inf && !twice) {
    set_point<1>(slots, same_x ? nullptr : out, -1, lane, kG1Lanes);
  }
  __syncwarp(kFull);
  if (__any_sync(kFull, twice)) {
    run(progs::kG1Dbl, progs::kG1DblSteps, kG1Lanes, slots, lane);
    if (twice) set_point<1>(slots, progs::kG1DblOut, 0, lane, kG1Lanes);
    __syncwarp(kFull);
  }
}

// g1.py:scalar_mul_windowed for the point q (slots 3..5) of a group:
// T[0] = inf, T[1] = P and T[j] = T[j - 1] + P by 14 additions in order,
// then the 64 base-16 digits MSB first, 4 doublings and an addition of
// T[digit] each (a zero digit adds T[0]).  The result lands in p (slots
// 0..2).  table: 16 x PW words; digits == nullptr for a group with no
// point, which runs the same steps on all-zero digits.
__device__ __forceinline__ void g1_windowed(uint32_t* slots, uint32_t* table,
                                            const int32_t* digits, int lane) {
  for (int k = lane; k < PW; k += kG1Lanes) {
    table[k] = k / NW == 1 ? kOne[k % NW] : 0u;
    table[PW + k] = slots[3 * NW + k];
    slots[k] = slots[3 * NW + k];
  }
  __syncwarp(kFull);
  for (int j = 2; j < 16; ++j) {
    g1_add(slots, lane);
    for (int k = lane; k < PW; k += kG1Lanes) table[j * PW + k] = slots[k];
  }
  __syncwarp(kFull);
  set_point<1>(slots, nullptr, -1, lane, kG1Lanes);
  __syncwarp(kFull);
  for (int w = 0; w < NUM_WINDOWS; ++w) {
    for (int b = 0; b < WINDOW_BITS; ++b) g1_dbl(slots, lane);
    const int d = digits != nullptr ? digits[w] : 0;
    for (int k = lane; k < PW; k += kG1Lanes) slots[3 * NW + k] = table[d * PW + k];
    __syncwarp(kFull);
    g1_add(slots, lane);
  }
}

// Node j of one level of g1.py:_tree_reduce over `len` points (in: len x
// PW words): in[j] + in[j + half] for j < half, the odd last point
// in[2 half] for j == half (as inf + it, which g1_add returns as it is),
// inf for any other j (a group past the level's nodes keeps the warp in
// step).  The node lands in p (slots 0..2).
__device__ __forceinline__ void g1_tree_node(uint32_t* slots, const uint32_t* in, int64_t len,
                                             int64_t j, int lane) {
  const int64_t half = len / 2;
  const bool pair = j < half, odd = j == half && (len & 1);
  for (int k = lane; k < PW; k += kG1Lanes) {
    const uint32_t inf = k / NW == 1 ? kOne[k % NW] : 0u;
    slots[k] = pair ? in[j * PW + k] : inf;
    slots[3 * NW + k] = pair ? in[(j + half) * PW + k] : odd ? in[2 * half * PW + k] : inf;
  }
  __syncwarp(kFull);
  g1_add(slots, lane);
}

// -- G2, a warp a point: p in slots 0..5 (x0 x1 y0 y1 z0 z1), q in 6..11 -----

// p = 2p
__device__ __forceinline__ void g2_dbl(uint32_t* slots, int lane) {
  run(progs::kG2Dbl, progs::kG2DblSteps, kG2Lanes, slots, lane);
  set_point<2>(slots, progs::kG2DblOut, 0, lane, kG2Lanes);
  __syncwarp(kFull);
}

// p = p + q, g2.py:add's selects taken as branches (uniform: one point a
// warp), so the addition runs only when neither operand is the identity
// and the double only when P = Q
__device__ __forceinline__ void g2_add(uint32_t* slots, int lane) {
  const bool p_inf = slot_zero(slots, 4) && slot_zero(slots, 5);
  const bool q_inf = slot_zero(slots, 10) && slot_zero(slots, 11);
  __syncwarp(kFull);
  if (p_inf) {
    set_point<2>(slots, nullptr, 6, lane, kG2Lanes);
    __syncwarp(kFull);
    return;
  }
  if (q_inf) return;
  run(progs::kG2Add, progs::kG2AddSteps, kG2Lanes, slots, lane);
  const int* out = progs::kG2AddOut;  // sum 0..5, H 6..7, r' 8..9
  const bool same_x = slot_zero(slots, out[6]) && slot_zero(slots, out[7]);
  const bool same_y = slot_zero(slots, out[8]) && slot_zero(slots, out[9]);
  __syncwarp(kFull);
  if (same_x && same_y) {
    g2_dbl(slots, lane);
    return;
  }
  set_point<2>(slots, same_x ? nullptr : out, -1, lane, kG2Lanes);
  __syncwarp(kFull);
}

// g2.py:scalar_mul for the point q (slots 6..11): 256 rounds from the top
// bit of a doubling and, where the bit (little-endian in `bits`) is set, an
// addition; the result in p (slots 0..5)
__device__ __forceinline__ void g2_double_and_add(uint32_t* slots, const int32_t* bits,
                                                  int lane) {
  set_point<2>(slots, nullptr, -1, lane, kG2Lanes);
  __syncwarp(kFull);
  for (int i = SCALAR_BITS - 1; i >= 0; --i) {
    g2_dbl(slots, lane);
    if (bits[i]) g2_add(slots, lane);
  }
}

}  // namespace bls::lanes
