// Latency probes on the card, for the design of kernels C2 and C4
// (curve/lane_probe.py times them): chains of dependent operations in one
// block, in the one-thread form that C3 runs (bls12_381.cuh: the
// product and the point operations out of line) and in the lane form of C2
// and C4 (bls12_381_lanes.cuh).  A chain of `reps` operations, timed at two
// lengths, gives one operation's latency without the launch.  Not on any
// path of the port.
#include <cuda_runtime.h>

#include <cstdint>

#include "bls12_381_lanes.cuh"

namespace {

using bls::Fp;
using bls::Fp2;
using bls::G1;
using bls::G2;
using bls::NW;
namespace lanes = bls::lanes;

__device__ G1 get_g1(const uint32_t* w) {
  return {lanes::get(w), lanes::get(w + NW), lanes::get(w + 2 * NW)};
}

__device__ void put_g1(uint32_t* w, const G1& p) {
  lanes::put(w, p.x);
  lanes::put(w + NW, p.y);
  lanes::put(w + 2 * NW, p.z);
}

__device__ Fp2 get_fp2(const uint32_t* w) { return {lanes::get(w), lanes::get(w + NW)}; }

__device__ G2 get_g2(const uint32_t* w) {
  return {get_fp2(w), get_fp2(w + 2 * NW), get_fp2(w + 4 * NW)};
}

__device__ void put_g2(uint32_t* w, const G2& p) {
  const Fp2* c[3] = {&p.x, &p.y, &p.z};
  for (int k = 0; k < 3; ++k) {
    lanes::put(w + 2 * k * NW, c[k]->c0);
    lanes::put(w + (2 * k + 1) * NW, c[k]->c1);
  }
}

// thread t, `reps` times on io[t] = (x, y): form 0 x = x * y out of line
// (C3), form 1 x = x * y inline (C1, C2, C4), form 2 (x, y) = (x + y, x)
// (the lanes' sum, lanes::lin)
__global__ void fp_chain_kernel(uint32_t* io, int reps, int form) {
  uint32_t* s = io + threadIdx.x * 2 * NW;
  Fp x = lanes::get(s);
  Fp y = lanes::get(s + NW);
  if (form == 0) {
    for (int r = 0; r < reps; ++r) x = bls::mul(x, y);
  } else if (form == 1) {
    for (int r = 0; r < reps; ++r) x = bls::mont_mul_inline(x, y);
  } else {
    for (int r = 0; r < reps; ++r) {
      const Fp t = lanes::lin(x, y, false);
      y = x;
      x = t;
    }
  }
  lanes::put(s, x);
}

// p = 2p (op 0) or p = p + q (op 1), `reps` times, on io = (p, q); form 0
// one thread (bls::dbl, bls::add), form 1 a warp of groups of
// lanes::kG1Lanes lanes, each group the same point (g1_dbl, g1_add)
__global__ void g1_chain_kernel(uint32_t* io, int reps, int op, int form) {
  constexpr int stride = lanes::group_stride(lanes::kG1Slots * NW);
  __shared__ __align__(16) uint32_t smem[32 / lanes::kG1Lanes * stride];
  if (form == 0) {
    if (threadIdx.x != 0) return;
    G1 p = get_g1(io);
    const G1 q = get_g1(io + lanes::PW);
    for (int r = 0; r < reps; ++r) p = op ? bls::add(p, q) : bls::dbl(p);
    put_g1(io, p);
    return;
  }
  const int g = threadIdx.x / lanes::kG1Lanes, lane = threadIdx.x % lanes::kG1Lanes;
  uint32_t* slots = smem + g * stride;
  for (int k = lane; k < 2 * lanes::PW; k += lanes::kG1Lanes) slots[k] = io[k];
  __syncwarp();
  for (int r = 0; r < reps; ++r) {
    if (op)
      lanes::g1_add(slots, lane);
    else
      lanes::g1_dbl(slots, lane);
  }
  if (g == 0)
    for (int k = lane; k < lanes::PW; k += lanes::kG1Lanes) io[k] = slots[k];
}

// the same over G2: form 0 one thread, form 1 one warp (g2_dbl, g2_add)
__global__ void g2_chain_kernel(uint32_t* io, int reps, int op, int form) {
  __shared__ __align__(16) uint32_t slots[lanes::kG2Slots * NW];
  if (form == 0) {
    if (threadIdx.x != 0) return;
    G2 p = get_g2(io);
    const G2 q = get_g2(io + 2 * lanes::PW);
    for (int r = 0; r < reps; ++r) p = op ? bls::add(p, q) : bls::dbl(p);
    put_g2(io, p);
    return;
  }
  const int lane = threadIdx.x;
  for (int k = lane; k < 4 * lanes::PW; k += 32) slots[k] = io[k];
  __syncwarp();
  for (int r = 0; r < reps; ++r) {
    if (op)
      lanes::g2_add(slots, lane);
    else
      lanes::g2_dbl(slots, lane);
  }
  for (int k = lane; k < 2 * lanes::PW; k += 32) io[k] = slots[k];
}

// a synthetic program on one warp, a group of `lanes` lanes per 6 slots
// (slots 0..3 from io), `steps` steps: what a step of the interpreter
// costs, with products or with sums alone; group 0 writes its slots back
__global__ void program_kernel(uint32_t* io, const uint32_t* prog, int steps, int lanes) {
  __shared__ __align__(16) uint32_t smem[32 * 6 * NW];
  const int g = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  uint32_t* slots = smem + g * 6 * NW;
  for (int k = lane; k < 4 * NW; k += lanes) slots[k] = io[k];
  __syncwarp();
  lanes::run(prog, steps, lanes, slots, lane);
  if (g == 0)
    for (int k = lane; k < 4 * NW; k += lanes) io[k] = slots[k];
}

}  // namespace

extern "C" int probe_program(void* io, const void* prog, int steps, int lanes, void* stream) {
  program_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(io), static_cast<const uint32_t*>(prog), steps, lanes);
  return static_cast<int>(cudaGetLastError());
}

// threads: 1 or 32 chains side by side (one warp)
extern "C" int probe_fp_chain(void* io, int threads, int reps, int form, void* stream) {
  fp_chain_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(io), reps, form);
  return static_cast<int>(cudaGetLastError());
}

// curve 1: G1 (io: p, q as 36 words each), 2: G2 (72 words each)
extern "C" int probe_point_chain(void* io, int curve, int reps, int op, int form, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<uint32_t*>(io);
  if (curve == 1)
    g1_chain_kernel<<<1, 32, 0, s>>>(w, reps, op, form);
  else
    g2_chain_kernel<<<1, 32, 0, s>>>(w, reps, op, form);
  return static_cast<int>(cudaGetLastError());
}
