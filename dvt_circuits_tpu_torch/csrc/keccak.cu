// Kernel K2: Keccak-f[1600], 24 rounds of theta, rho, pi, chi, iota.
//
// Replaces the Pallas kernel dvt_circuits_tpu/hash/keccak.py:_pallas_kernel
// (called by _keccak_pallas / keccak_f1600).  Plain version:
// dvt_circuits_tpu_torch/hash/keccak.py:keccak_f1600_plain.
//
// Bound: 64-bit logic ops.  One permutation moves 400 bytes (25 lanes in,
// 25 out) and does about 3,700 64-bit XOR/AND/NOT/rotate operations (194
// LOP3/SHF instructions per round in the sm_90a build).  On
// the prover's path it runs on a single state per `prove` (the artifact
// fingerprint), so its time there is the launch.
//
// Design: one thread per state with 25 native uint64_t lanes in registers
// (the TPU's lo/hi uint32 split is not carried over); the 24 round
// constants sit in __constant__ memory; the loops inside a round are
// unrolled so every rotation amount and lane index is a compile-time
// constant, while the 24 rounds stay a loop.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__constant__ uint64_t RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

__device__ __forceinline__ uint64_t rotl(uint64_t x, int n) {
  return n == 0 ? x : (x << n) | (x >> (64 - n));
}

__global__ void __launch_bounds__(128) keccak_kernel(
    const int64_t* __restrict__ in, int64_t* __restrict__ out, int64_t n) {
  // rotation offsets r[x][y] at lane x + 5y; pi: dst (x, y) <- src (x + 3y, x)
  constexpr int ROT[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                           25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
  int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint64_t* src = reinterpret_cast<const uint64_t*>(in) + row * 25;
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = src[i];
#pragma unroll 1
  for (int r = 0; r < 24; ++r) {
    uint64_t c[5], d[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
#pragma unroll
    for (int y = 0; y < 5; ++y) {
#pragma unroll
      for (int x = 0; x < 5; ++x) {
        int s = (x + 3 * y) % 5 + 5 * x;
        b[x + 5 * y] = rotl(a[s], ROT[s]);
      }
    }
#pragma unroll
    for (int y = 0; y < 5; ++y) {
#pragma unroll
      for (int x = 0; x < 5; ++x) {
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
      }
    }
    a[0] ^= RC[r];
  }
  uint64_t* dst = reinterpret_cast<uint64_t*>(out) + row * 25;
#pragma unroll
  for (int i = 0; i < 25; ++i) dst[i] = a[i];
}

}  // namespace

// (n, 25) int64 lanes in -> out, on the caller's stream.
extern "C" int keccak_f1600(const void* in, void* out, long long n, void* stream) {
  constexpr int threads = 128;
  unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  keccak_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
