// Host build of dvt_circuits_tpu_torch/csrc/bls12_381_lanes.cuh for
// tests/test_torch_curve_host.py: the CUDA qualifiers defined away, a
// std::thread a lane, and __syncwarp a barrier of the warp's threads, so the
// lane programs run as the kernels of csrc/curve.cu run them, step by step.
//
//   g++ -std=c++20 -O1 -pthread -shared -fPIC -I <csrc> -o lib.so curve_host_lanes.cpp
//
// Elements cross as 12 words of 32 bits (Montgomery form), a G1 point as
// x, y, z (36 words), a G2 point as x0 x1 y0 y1 z0 z1 (72 words).
#include <barrier>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __constant__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))

namespace {
thread_local std::barrier<>* warp_barrier = nullptr;
thread_local int* warp_votes = nullptr;  // the warp's 32 predicates
thread_local int warp_lane = 0;
}

inline void __syncwarp(unsigned = 0xffffffffu) { warp_barrier->arrive_and_wait(); }

// every thread posts its predicate, all meet, each reads all 32, all meet
// again before any can post the next one
inline int __any_sync(unsigned, int pred) {
  warp_votes[warp_lane] = pred;
  warp_barrier->arrive_and_wait();
  int any = 0;
  for (int t = 0; t < 32; ++t) any |= warp_votes[t];
  warp_barrier->arrive_and_wait();
  return any != 0;
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

#include "bls12_381_lanes.cuh"

namespace {

using bls::NW;
namespace lanes = bls::lanes;
constexpr int PW = lanes::PW;
constexpr int kGroups = 32 / lanes::kG1Lanes;

// fn(thread) on the 32 threads of one warp
void warp(const std::function<void(int)>& fn) {
  std::barrier<> bar(32);
  int votes[32] = {};
  std::vector<std::thread> threads;
  for (int t = 0; t < 32; ++t)
    threads.emplace_back([&, t] {
      warp_barrier = &bar;
      warp_votes = votes;
      warp_lane = t;
      fn(t);
    });
  for (auto& th : threads) th.join();
}

void copy_words(uint32_t* dst, const uint32_t* src, int words, int lane, int lanes_) {
  for (int k = lane; k < words; k += lanes_) dst[k] = src[k];
}

// the identity's words: (0, 1, 0) over E elements a coordinate
void identity_words(uint32_t* dst, int e) {
  std::memset(dst, 0, 3 * e * NW * sizeof(uint32_t));
  for (int i = 0; i < NW; ++i) dst[e * NW + i] = bls::kOne[i];
}

}  // namespace

extern "C" {

void host_mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i)
    lanes::put(out + i * NW,
               bls::mont_mul_inline(lanes::get(a + i * NW), lanes::get(b + i * NW)));
}

// a + b, or a - b where subtract is set
void host_lin(const uint32_t* a, const uint32_t* b, uint32_t* out, int n, int subtract) {
  for (int i = 0; i < n; ++i)
    lanes::put(out + i * NW, lanes::lin(lanes::get(a + i * NW), lanes::get(b + i * NW), subtract));
}

// op 0: out = 2p; op 1: out = p + q (g1_add, its selects included); 4 points a warp
void host_g1_op(int op, const uint32_t* p, const uint32_t* q, uint32_t* out, int n) {
  std::vector<uint32_t> smem(kGroups * lanes::kG1Slots * NW);
  for (int w = 0; w * kGroups < n; ++w)
    warp([&](int t) {
      const int g = t / lanes::kG1Lanes, lane = t % lanes::kG1Lanes, i = w * kGroups + g;
      uint32_t* slots = smem.data() + g * lanes::kG1Slots * NW;
      if (lane == 0) {
        if (i < n) {
          std::memcpy(slots, p + i * PW, PW * 4);
          std::memcpy(slots + PW, q + i * PW, PW * 4);
        } else {
          identity_words(slots, 1);
          identity_words(slots + PW, 1);
        }
      }
      __syncwarp();
      if (op == 0)
        lanes::g1_dbl(slots, lane);
      else
        lanes::g1_add(slots, lane);
      if (i < n) copy_words(out + i * PW, slots, PW, lane, lanes::kG1Lanes);
    });
}

// op 0: out = 2p; op 1: out = p + q (g2_add); a warp a point
void host_g2_op(int op, const uint32_t* p, const uint32_t* q, uint32_t* out, int n) {
  std::vector<uint32_t> slots(lanes::kG2Slots * NW);
  for (int i = 0; i < n; ++i)
    warp([&](int lane) {
      if (lane == 0) {
        std::memcpy(slots.data(), p + i * 2 * PW, 2 * PW * 4);
        std::memcpy(slots.data() + 2 * PW, q + i * 2 * PW, 2 * PW * 4);
      }
      __syncwarp();
      if (op == 0)
        lanes::g2_dbl(slots.data(), lane);
      else
        lanes::g2_add(slots.data(), lane);
      copy_words(out + i * 2 * PW, slots.data(), 2 * PW, lane, 32);
    });
}

// C2's first launch: out[i] = digits_i * P_i (digits n x 64, MSB first)
void host_g1_windowed(const uint32_t* pts, const int32_t* digits, uint32_t* out, int n) {
  constexpr int group = lanes::kG1Slots * NW + 16 * PW;
  std::vector<uint32_t> smem(kGroups * group);
  for (int w = 0; w * kGroups < n; ++w)
    warp([&](int t) {
      const int g = t / lanes::kG1Lanes, lane = t % lanes::kG1Lanes, i = w * kGroups + g;
      uint32_t* slots = smem.data() + g * group;
      if (lane == 0) {
        if (i < n)
          std::memcpy(slots + PW, pts + i * PW, PW * 4);
        else
          identity_words(slots + PW, 1);
      }
      __syncwarp();
      lanes::g1_windowed(slots, slots + lanes::kG1Slots * NW,
                         i < n ? digits + i * lanes::NUM_WINDOWS : nullptr, lane);
      if (i < n) copy_words(out + i * PW, slots, PW, lane, lanes::kG1Lanes);
    });
}

// C2's tree: the levels of g1_tree_level_kernel, one after another; out is
// the sum (the identity for n = 0)
void host_g1_tree(const uint32_t* pts, uint32_t* out, int n) {
  if (n == 0) {
    identity_words(out, 1);
    return;
  }
  std::vector<uint32_t> a(pts, pts + n * PW), b(((n + 1) / 2) * PW);
  std::vector<uint32_t> smem(kGroups * lanes::kG1Slots * NW);
  for (int len = n; len > 1; len = (len + 1) / 2) {
    const int nodes = (len + 1) / 2;
    for (int w = 0; w * kGroups < nodes; ++w)
      warp([&](int t) {
        const int g = t / lanes::kG1Lanes, lane = t % lanes::kG1Lanes, j = w * kGroups + g;
        uint32_t* slots = smem.data() + g * lanes::kG1Slots * NW;
        lanes::g1_tree_node(slots, a.data(), len, j, lane);
        if (j < nodes) copy_words(b.data() + j * PW, slots, PW, lane, lanes::kG1Lanes);
      });
    std::copy(b.begin(), b.begin() + nodes * PW, a.begin());
  }
  std::memcpy(out, a.data(), PW * 4);
}

// C4: out[i] = bits_i * P_i (bits n x 256, little-endian)
void host_g2_scalar_mul(const uint32_t* pts, const int32_t* bits, uint32_t* out, int n) {
  std::vector<uint32_t> slots(lanes::kG2Slots * NW);
  for (int i = 0; i < n; ++i)
    warp([&](int lane) {
      if (lane == 0) std::memcpy(slots.data() + 2 * PW, pts + i * 2 * PW, 2 * PW * 4);
      __syncwarp();
      lanes::g2_double_and_add(slots.data(), bits + i * lanes::SCALAR_BITS, lane);
      copy_words(out + i * 2 * PW, slots.data(), 2 * PW, lane, 32);
    });
}

}  // extern "C"
