// Kernel K1: the Poseidon2 permutation over BabyBear, width 16.
//
// Replaces the Pallas kernel dvt_circuits_tpu/hash/poseidon2_pallas.py:_kernel
// (called by permute_lanes / poseidon2_permute_pallas).  Plain version:
// dvt_circuits_tpu_torch/hash/poseidon2.py:permute_plain.
//
// Bound: integer ALU work, not bytes.  One permutation moves 256 bytes
// (16 int64 words in, 16 out) but does 804 Montgomery multiplies (564 in
// the x^7 S-boxes: 8 full rounds x 16 words x 4 + 13 partial rounds x 4;
// 208 for the internal diagonal; 32 form conversions) and 1,300 modular
// adds for the linear layers: 9,152 integer instructions in the sm_90a
// build.
//
// Design: one thread per state; the 16 words stay in registers for all 21
// rounds and the round constants sit in __constant__ memory, so device
// memory is touched once on the way in and once on the way out (the TPU
// kernel kept its tile in VMEM for the same reason).  The kernel reads and
// writes the port's (N, 16) int64 standard-form layout directly, with no
// padding of N.
#include <cuda_runtime.h>

#include <cstdint>

#include "babybear.cuh"

namespace {

constexpr int WIDTH = 16;
constexpr int ROUNDS_F = 8;
constexpr int ROUNDS_P = 13;

__constant__ uint32_t EXT_RC[ROUNDS_F][WIDTH];  // Montgomery form
__constant__ uint32_t INT_RC[ROUNDS_P];
__constant__ uint32_t DIAG[WIDTH];

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  uint32_t x2 = bb::mont_mul(x, x);
  uint32_t x3 = bb::mont_mul(x2, x);
  uint32_t x4 = bb::mont_mul(x2, x2);
  return bb::mont_mul(x4, x3);
}

__device__ __forceinline__ void m4(uint32_t* x) {
  uint32_t t0 = bb::add(x[0], x[1]);
  uint32_t t1 = bb::add(x[2], x[3]);
  uint32_t t2 = bb::add(bb::add(x[1], x[1]), t1);
  uint32_t t3 = bb::add(bb::add(x[3], x[3]), t0);
  uint32_t t1x2 = bb::add(t1, t1);
  uint32_t t4 = bb::add(bb::add(t1x2, t1x2), t3);
  uint32_t t0x2 = bb::add(t0, t0);
  uint32_t t5 = bb::add(bb::add(t0x2, t0x2), t2);
  x[0] = bb::add(t3, t5);
  x[1] = t5;
  x[2] = bb::add(t2, t4);
  x[3] = t4;
}

__device__ __forceinline__ void external_linear(uint32_t* s) {
#pragma unroll
  for (int g = 0; g < WIDTH; g += 4) m4(s + g);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t sum = bb::add(bb::add(s[j], s[4 + j]), bb::add(s[8 + j], s[12 + j]));
#pragma unroll
    for (int g = 0; g < WIDTH; g += 4) s[g + j] = bb::add(s[g + j], sum);
  }
}

__device__ __forceinline__ void internal_linear(uint32_t* s) {
  uint32_t total = s[0];
#pragma unroll
  for (int i = 1; i < WIDTH; ++i) total = bb::add(total, s[i]);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = bb::add(bb::mont_mul(s[i], DIAG[i]), total);
}

__device__ __forceinline__ void full_round(uint32_t* s, int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = sbox(bb::add(s[i], EXT_RC[r][i]));
  external_linear(s);
}

__global__ void __launch_bounds__(128) poseidon2_kernel(
    const int64_t* __restrict__ in, int64_t* __restrict__ out, int64_t n) {
  int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int64_t* src = in + row * WIDTH;
  uint32_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = bb::to_mont(static_cast<uint32_t>(src[i]));
  external_linear(s);
#pragma unroll
  for (int r = 0; r < ROUNDS_F / 2; ++r) full_round(s, r);
#pragma unroll
  for (int r = 0; r < ROUNDS_P; ++r) {
    s[0] = sbox(bb::add(s[0], INT_RC[r]));
    internal_linear(s);
  }
#pragma unroll
  for (int r = ROUNDS_F / 2; r < ROUNDS_F; ++r) full_round(s, r);
  int64_t* dst = out + row * WIDTH;
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) dst[i] = static_cast<int64_t>(bb::from_mont(s[i]));
}

uint32_t host_to_mont(uint32_t a) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a % bb::P) << 32) % bb::P);
}

}  // namespace

// Standard-form tables in, Montgomery form into __constant__ memory.
extern "C" int p2_set_constants(const uint32_t* ext, const uint32_t* int_rc,
                                const uint32_t* diag) {
  uint32_t e[ROUNDS_F * WIDTH], ir[ROUNDS_P], d[WIDTH];
  for (int i = 0; i < ROUNDS_F * WIDTH; ++i) e[i] = host_to_mont(ext[i]);
  for (int i = 0; i < ROUNDS_P; ++i) ir[i] = host_to_mont(int_rc[i]);
  for (int i = 0; i < WIDTH; ++i) d[i] = host_to_mont(diag[i]);
  cudaError_t err = cudaMemcpyToSymbol(EXT_RC, e, sizeof(e));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(INT_RC, ir, sizeof(ir));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(DIAG, d, sizeof(d));
  return static_cast<int>(err);
}

// (n, 16) int64 standard form in -> out, on the caller's stream.
extern "C" int p2_permute(const void* in, void* out, long long n, void* stream) {
  constexpr int threads = 128;
  unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  poseidon2_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
