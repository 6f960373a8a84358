// Kernels K2 and K2b: Keccak-f[1600], 24 rounds of theta, rho, pi, chi, iota.
//
// K2 (keccak_f1600) replaces the Pallas kernel
// dvt_circuits_tpu/hash/keccak.py:_pallas_kernel (called by _keccak_pallas /
// keccak_f1600) as its direct counterpart: (n, 25) states in, permuted
// states out.  K2b (keccak_sponge) is its redesign for the Keccak-256 /
// SHA3-256 sponge, the reference's one-dispatch _absorb_all: every rate
// block of every message is absorbed and permuted in ONE launch, and only
// the 4 digest lanes of each message are written.  Plain versions:
// dvt_circuits_tpu_torch/hash/keccak.py:keccak_f1600_plain and
// keccak_sponge_plain.
//
// Bound: 32-bit logic instructions (Hopper has no 64-bit logic unit).  One
// round of Keccak-f, from its definition: theta 80 (5 column parities at 2
// three-input LOP3 per half, 5 rotations by one at 2 funnel SHF, 25 lane
// XORs at one three-input LOP3 per half), rho 48 (24 rotations at 2 SHF),
// chi 50 (a ^ (~b & c) is one LOP3 per half), iota 2: 180 instructions,
// 4,320 a permutation (chip_smoke.py: K2_INSTR).  A permutation moves 400
// bytes in K2; a sponge block 136 bytes in and 32 out per message in K2b.
// On the prover's path K2b runs on one message of one block per prove or
// verify (the CLI's artifact fingerprint): there the bound is a launch.
//
// Design: one thread per state (or message) with 25 native uint64_t lanes
// in registers (the TPU's lo/hi uint32 split is not carried over); the
// permutation is one __device__ function that K2 and K2b share.  The loops
// inside a round are unrolled so every rotation amount and lane index is a
// compile-time constant, the 24 rounds stay a loop.  One thread per state
// also at one state: spreading a state over a warp (theta, pi and chi by
// __shfl_sync) shortens the launch's device time but not the call, whose
// time the host decides.  The 24 round constants sit in __constant__
// memory.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRateLanes = 17;   // 1088-bit rate of Keccak-256 / SHA3-256
constexpr int kDigestLanes = 4;  // 256-bit digest
constexpr int kThreads = 128;

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
  // n in [0, 64): the right shift is masked so that n = 0 gives x
  return (x << n) | (x >> ((64 - n) & 63));
}

// Keccak-f[1600] on 25 lanes in one thread's registers (lane x + 5y).
__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
  // rotation offsets r[x][y] at lane x + 5y; pi: dst (x, y) <- src (x + 3y, x)
  constexpr int ROT[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                           25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
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
}

__global__ void __launch_bounds__(kThreads) keccak_kernel(
    const int64_t* __restrict__ in, int64_t* __restrict__ out, int64_t n) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint64_t* src = reinterpret_cast<const uint64_t*>(in) + row * 25;
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = src[i];
  keccak_f(a);
  uint64_t* dst = reinterpret_cast<uint64_t*>(out) + row * 25;
#pragma unroll
  for (int i = 0; i < 25; ++i) dst[i] = a[i];
}

// blocks (n_blocks, n, 17) rate lanes, already padded; out (n, 4) digest
// lanes.
__global__ void __launch_bounds__(kThreads) keccak_sponge_kernel(
    const int64_t* __restrict__ blocks, int64_t n_blocks, int64_t n,
    int64_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint64_t* lanes = reinterpret_cast<const uint64_t*>(blocks);
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = 0;
#pragma unroll 1
  for (int64_t blk = 0; blk < n_blocks; ++blk) {
    const uint64_t* src = lanes + (blk * n + row) * kRateLanes;
#pragma unroll
    for (int i = 0; i < kRateLanes; ++i) a[i] ^= src[i];
    keccak_f(a);
  }
  uint64_t* dst = reinterpret_cast<uint64_t*>(out) + row * kDigestLanes;
#pragma unroll
  for (int i = 0; i < kDigestLanes; ++i) dst[i] = a[i];
}

unsigned grid_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// K2: (n, 25) int64 lanes in -> out, on the caller's stream.
extern "C" int keccak_f1600(const void* in, void* out, long long n, void* stream) {
  keccak_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// K2b: absorb (n_blocks, n, 17) int64 rate blocks -> (n, 4) digest lanes, on
// the caller's stream.
extern "C" int keccak_sponge(const void* blocks, long long n_blocks, long long n, void* out,
                             void* stream) {
  keccak_sponge_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(blocks), n_blocks, n, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
