// Kernel K3: the integer multiply-add probe, 512 dependent steps
// y = y*x + 12345 in uint32 on every element.
//
// Replaces the Pallas kernel scripts/probe_vpu.py:_kernel_mul (called by
// mulchain).  Plain version: dvt_circuits_tpu_torch/probe_vpu.py:
// mulchain_plain.
//
// Bound: operations.  Each element moves 16 bytes (one int64 in, one out)
// and does 512 multiply-adds, each one IMAD: 32 IMAD per byte, far above
// the card's ~5 instructions per byte of device memory.  So the kernel
// measures the rate at which the SMs retire IMAD, the denominator of every
// integer bound in chip_smoke.py.
//
// Design: one thread per element, the chain fully unrolled into 512
// dependent IMADs (the immediate 12345 rides in the IMAD), and enough
// warps in flight (a 4M-element probe fills every SM many times over) that
// each scheduler always has a warp whose previous IMAD has retired.  The
// TPU kernel kept its (16, 2048) tile in VMEM for the same reason: the
// chain never touches memory between its first load and its last store.
// Inputs and outputs are the port's int64 tensors holding values in
// [0, 2^32); the kernel takes the low 32 bits on the way in.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CHAIN = 512;

__global__ void __launch_bounds__(256) mulchain_kernel(
    const int64_t* __restrict__ in, int64_t* __restrict__ out, int64_t n) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = static_cast<uint32_t>(in[i]);
  uint32_t y = x;
#pragma unroll
  for (int k = 0; k < CHAIN; ++k) y = y * x + 12345u;
  out[i] = static_cast<int64_t>(y);
}

}  // namespace

// n int64 elements in -> out, on the caller's stream.
extern "C" int mulchain(const void* in, void* out, long long n, void* stream) {
  constexpr int threads = 256;
  unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  mulchain_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
