// The Poseidon2 permutation over BabyBear, width 16: the one core that every
// entry point of kernel K1 (csrc/poseidon2.cu) runs.
//
// A state is held by L consecutive lanes of a warp (L = 1 or 4).  Lane q
// keeps K = 16 / L words, words q·K .. q·K + K - 1, in Montgomery form.
// Words are not kept below p: between layers they lie below 1.0003·p
// (reduce_loose), after an S-box below 2.012·p; to_mont gives [0, p) on the
// way in and from_mont [0, p) on the way out.  With L = 4 each lane holds
// one M4 group; the column sums of the external layer and the row sum of
// the internal layer are completed with __shfl_xor_sync over the L lanes.
//
// Work per permutation, as the algorithm defines it (the bound that
// chip_smoke.py holds every design to): 564 S-box products (8 full rounds x
// 16 words x 4 + 13 partial rounds x 4), 208 products by the internal
// diagonal 1..16 and 1,084 additions in the linear layers and round
// constants.  What this design does beyond that:
//   * S-box products are Montgomery products (3 IMAD each); only x^2 is
//     brought below p, the other three stay loose;
//   * the diagonal is multiplied as a small integer, fused with the row sum
//     (mu·s + total < 35p: one multiply-add) and reduced once per word
//     (reduce_loose: a shift and 2 IMAD);
//   * the external layer accumulates M4 and the column sums in uint64 and
//     reduces once per output word (< 162p < 2^39: reduce_loose);
//   * the next round's constants are added inside those reductions, so no
//     round constant costs a modular add of its own.
// Each reduction's input bound is stated beside it; all stay below the
// 2^39 that reduce_loose takes and the 2^64 − (2^32 − 1)·p (≈ 2.4178·p²)
// that mont_reduce_loose takes.
#pragma once

#include <cstdint>

#include "babybear.cuh"

namespace p2 {

constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int DIGEST = 8;
constexpr int ROUNDS_F = 8;
constexpr int ROUNDS_P = 13;

// Round constants in Montgomery form, in the order the core adds them.
struct Tables {
  // added by external layer k (k = 0: the initial layer, k = r + 1: after
  // full round r): the next full round's constants; after round 3 only
  // word 0 gets one (partial round 0's), after round 7 none
  uint32_t ext_next[ROUNDS_F + 1][WIDTH];
  // added to word 0 by the internal layer of partial round r < 12
  uint32_t int_next[ROUNDS_P - 1];
  // added to every word by the internal layer of partial round 12
  uint32_t int_last[WIDTH];
};

// The tables from the standard-form round constants: ext (8 x 16, row
// major) and int_rc (13).
inline Tables make_tables(const uint32_t* ext, const uint32_t* int_rc) {
  auto mont = [](uint32_t a) {
    return static_cast<uint32_t>((static_cast<uint64_t>(a % bb::P) << 32) % bb::P);
  };
  Tables t = {};
  // layer k precedes full round k, except layer 4 (partial round 0 follows)
  // and layer 8 (the end)
  for (int k = 0; k < ROUNDS_F; ++k) {
    for (int i = 0; i < WIDTH; ++i) {
      if (k != ROUNDS_F / 2) {
        t.ext_next[k][i] = mont(ext[k * WIDTH + i]);
      } else if (i == 0) {
        t.ext_next[k][i] = mont(int_rc[0]);
      }
    }
  }
  for (int r = 0; r + 1 < ROUNDS_P; ++r) t.int_next[r] = mont(int_rc[r + 1]);
  for (int i = 0; i < WIDTH; ++i) t.int_last[i] = mont(ext[(ROUNDS_F / 2) * WIDTH + i]);
  return t;
}

// x < 1.0003p -> x^7 (Montgomery form) below 2.012p
__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  uint32_t x2 = bb::mont_mul(x, x);         // < p
  uint32_t x3 = bb::mont_mul_loose(x2, x);  // < 1.47p
  uint32_t x4 = bb::mont_mul_loose(x2, x2); // < 1.47p
  return bb::mont_mul_loose(x4, x3);        // x3·x4 < 2.17p² < 2.4178p²
}

// sum over the L lanes of one state
template <int L>
__device__ __forceinline__ uint64_t lane_sum(uint64_t v) {
  if constexpr (L == 4) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
  }
  return v;
}

// s <- M_E·s + rc: M4 on each group of 4 words, plus the sum of its column
// over the 4 groups; everything wide, one reduction per word.
template <int L>
__device__ __forceinline__ void external_layer(uint32_t (&s)[WIDTH / L], const uint32_t* rc,
                                               int q) {
  constexpr int K = WIDTH / L;
  uint64_t y[K];
#pragma unroll
  for (int g = 0; g < K; g += 4) {
    uint64_t t0 = uint64_t{s[g]} + s[g + 1];
    uint64_t t1 = uint64_t{s[g + 2]} + s[g + 3];
    uint64_t t2 = 2 * uint64_t{s[g + 1]} + t1;
    uint64_t t3 = 2 * uint64_t{s[g + 3]} + t0;
    uint64_t t4 = 4 * t1 + t3;
    uint64_t t5 = 4 * t0 + t2;
    y[g] = t3 + t5;  // < 16 x 2.012p
    y[g + 1] = t5;
    y[g + 2] = t2 + t4;
    y[g + 3] = t4;
  }
  uint64_t col[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint64_t c = y[j];
#pragma unroll
    for (int g = 4; g < K; g += 4) c += y[g + j];
    col[j] = lane_sum<L>(c);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = bb::reduce_loose(y[k] + col[k & 3] + rc[q * K + k]);
}

// s <- (J + diag(1..16))·s, plus the next round's constants.
template <int L, bool LAST>
__device__ __forceinline__ void internal_layer(uint32_t (&s)[WIDTH / L], const Tables& T, int r,
                                               int q) {
  constexpr int K = WIDTH / L;
  uint64_t total = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) total += s[k];
  total = lane_sum<L>(total);  // < 15 x 1.0003p + 2.012p (word 0 after its S-box)
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t mu = static_cast<uint32_t>(q * K + k + 1);
    uint64_t v = uint64_t{mu} * s[k] + total;  // < 35p
    if constexpr (LAST) {
      v += T.int_last[q * K + k];
    } else if (k == 0) {
      if (q == 0) v += T.int_next[r];
    }
    s[k] = bb::reduce_loose(v);
  }
}

template <int L>
__device__ __forceinline__ void full_round(uint32_t (&s)[WIDTH / L], const uint32_t* rc, int q) {
#pragma unroll
  for (int k = 0; k < WIDTH / L; ++k) s[k] = sbox(s[k]);
  external_layer<L>(s, rc, q);
}

template <int L, bool LAST>
__device__ __forceinline__ void partial_round(uint32_t (&s)[WIDTH / L], const Tables& T, int r,
                                              int q) {
  const uint32_t x = sbox(s[0]);  // word 0 lives in lane 0
  if (q == 0) s[0] = x;
  internal_layer<L, LAST>(s, T, r, q);
}

// The permutation of one state held by L lanes (lane q of the state).  The
// round loops stay rolled: the unrolled permutation is some 7,000
// instructions a kernel, which takes ptxas minutes to schedule and does not
// fit the instruction caches.
template <int L>
__device__ __forceinline__ void permute(uint32_t (&s)[WIDTH / L], const Tables& T, int q) {
  external_layer<L>(s, T.ext_next[0], q);
#pragma unroll 1
  for (int r = 0; r < ROUNDS_F / 2; ++r) full_round<L>(s, T.ext_next[r + 1], q);
#pragma unroll 1
  for (int r = 0; r + 1 < ROUNDS_P; ++r) partial_round<L, false>(s, T, r, q);
  partial_round<L, true>(s, T, ROUNDS_P - 1, q);
#pragma unroll 1
  for (int r = ROUNDS_F / 2; r < ROUNDS_F; ++r) full_round<L>(s, T.ext_next[r + 1], q);
}

}  // namespace p2
