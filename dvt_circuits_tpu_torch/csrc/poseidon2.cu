// Kernel K1: the Poseidon2 permutation over BabyBear, width 16, and the
// three loops of the prover built on it.
//
// Replaces the Pallas kernel dvt_circuits_tpu/hash/poseidon2_pallas.py:_kernel
// (called by permute_lanes / poseidon2_permute_pallas).  Plain versions, in
// dvt_circuits_tpu_torch/hash/poseidon2.py:
//   K1a p2_permute        (N, 16) states -> (N, 16)       permute_plain
//   K1b p2_hash_rows      (n, w) matrix -> (n, 8) digests  hash_rows_plain
//   K1c p2_merkle_levels  leaf digests -> every level      merkle_levels_plain
//   K1d p2_grind          lowest proof-of-work witness     grind_plain
//
// Bound: integer work, not bytes (the sponge reads its matrix once: 565 MB
// for the 2^14 x 4314 trace LDE is 0.17 ms at 3.35 TB/s, against about 8.9 M
// permutations).  All four run the one core of poseidon2_core.cuh, whose
// note counts the work.
//
// Design: the state stays in registers for a whole call: across all
// ceil(w/8) absorbs of a row (K1b), across the 21 rounds of every
// permutation.  K1b zero-pads the last chunk itself and takes the matrix's
// strides, so no padded or contiguous copy is made.  K1c writes the levels
// into one (2n - 1, 8) buffer, one launch per level and one single-block
// launch for the top levels (at most TOP_PARENTS parents), 8 words a node
// and no 16-word intermediate.  K1d builds each candidate state in its
// thread and keeps the lowest hit with one atomicMin.  Each entry point
// takes `lanes`: 1 (one thread per state) or 4 (the state split over 4
// lanes, one M4 group each).  Blocks hold 32 to 128 threads,
// the largest that still gives 4 blocks per SM of the 132, so 2^14 states
// (512 warps at 1 lane) reach every SM.
//
// Registers per thread at 1 / 4 lanes (nvcc 12.8 -Xptxas -v, sm_90a), no
// spills anywhere: permute 40 / 32, sponge 48 / 32, compress 56 / 32, grind
// 42 / 32; 688 bytes of shared memory for the tables at 4 lanes.
// chip_smoke.py prints the report of each build.
#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon2_core.cuh"

namespace {

using p2::DIGEST;
using p2::RATE;
using p2::WIDTH;

constexpr int SMS = 132;
constexpr int TOP_PARENTS = 128;

__constant__ p2::Tables TABLES;

// Lane-uniform tables (one lane per state) are read from __constant__
// memory, which broadcasts; with 4 lanes a warp reads 4 addresses at once,
// so the block first copies the tables to shared memory.
template <int L>
struct TableRef {
  __device__ __forceinline__ const p2::Tables& get(p2::Tables* sh) {
    if constexpr (L == 1) {
      return TABLES;
    } else {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(&TABLES);
      uint32_t* dst = reinterpret_cast<uint32_t*>(sh);
      for (int i = threadIdx.x; i < static_cast<int>(sizeof(p2::Tables) / 4); i += blockDim.x)
        dst[i] = src[i];
      __syncthreads();
      return *sh;
    }
  }
};

// The state this thread works on, its lane within the state, and whether
// the state exists (threads past the end compute on the last state, so
// that shuffles and barriers see every lane, and store nothing).
struct Slot {
  int64_t row;
  int q;
  bool valid;
};

template <int L>
__device__ __forceinline__ Slot slot(int64_t first, int64_t n) {
  const int64_t t = first + threadIdx.x;
  const int64_t row = t / L;
  return {row < n ? row : n - 1, static_cast<int>(t % L), row < n};
}

template <int L>
__global__ void permute_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                               int64_t n) {
  constexpr int K = WIDTH / L;
  __shared__ p2::Tables sh;
  const p2::Tables& T = TableRef<L>().get(&sh);
  const Slot at = slot<L>(static_cast<int64_t>(blockIdx.x) * blockDim.x, n);
  const int64_t* src = in + at.row * WIDTH + at.q * K;
  uint32_t s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = bb::to_mont(static_cast<uint32_t>(src[k]));
  p2::permute<L>(s, T, at.q);
  if (!at.valid) return;
  int64_t* dst = out + at.row * WIDTH + at.q * K;
#pragma unroll
  for (int k = 0; k < K; ++k) dst[k] = bb::from_mont(s[k]);
}

// Overwrite-mode sponge of one row: state[0:8] = chunk (the last chunk
// zero-padded), permute; digest = state[0:8].
template <int L>
__global__ void sponge_kernel(const int64_t* __restrict__ m, int64_t n, int64_t w,
                              int64_t row_stride, int64_t col_stride,
                              int64_t* __restrict__ out) {
  constexpr int K = WIDTH / L;
  __shared__ p2::Tables sh;
  const p2::Tables& T = TableRef<L>().get(&sh);
  const Slot at = slot<L>(static_cast<int64_t>(blockIdx.x) * blockDim.x, n);
  const int64_t* row = m + at.row * row_stride;
  uint32_t s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = 0;
  for (int64_t off = 0; off < w; off += RATE) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int word = at.q * K + k;
      if (word < RATE) {
        const int64_t c = off + word;
        s[k] = c < w ? bb::to_mont(static_cast<uint32_t>(row[c * col_stride])) : 0u;
      }
    }
    p2::permute<L>(s, T, at.q);
  }
  if (!at.valid) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int word = at.q * K + k;
    if (word < DIGEST) out[at.row * DIGEST + word] = bb::from_mont(s[k]);
  }
}

// Compress `levels` levels: parent i of a level is the permutation of its
// children 2i, 2i+1 (16 consecutive words of `in`), first 8 words, written
// to out[i].  levels > 1 only in a single block holding every parent of
// the first of them; each next level reads the one just written.
template <int L>
__global__ void compress_kernel(const int64_t* in, int64_t* out, int64_t n_out, int levels) {
  constexpr int K = WIDTH / L;
  __shared__ p2::Tables sh;
  const p2::Tables& T = TableRef<L>().get(&sh);
  for (int lev = 0; lev < levels; ++lev) {
    const Slot at = slot<L>(static_cast<int64_t>(blockIdx.x) * blockDim.x, n_out);
    const int64_t* src = in + at.row * WIDTH + at.q * K;
    uint32_t s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = bb::to_mont(static_cast<uint32_t>(src[k]));
    p2::permute<L>(s, T, at.q);
    if (at.valid) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int word = at.q * K + k;
        if (word < DIGEST) out[at.row * DIGEST + word] = bb::from_mont(s[k]);
      }
    }
    if (lev + 1 < levels) __syncthreads();
    in = out;
    out += n_out * DIGEST;
    n_out >>= 1;
  }
}

// Candidate w = start + i: the pending state with word `pos` = w mod p,
// permuted; a hit when the low bits of word 0 (standard form) are zero.
template <int L>
__global__ void grind_kernel(const int64_t* __restrict__ base, int pos, uint32_t mask,
                             int64_t start, int64_t count,
                             unsigned long long* __restrict__ best) {
  constexpr int K = WIDTH / L;
  __shared__ p2::Tables sh;
  const p2::Tables& T = TableRef<L>().get(&sh);
  const Slot at = slot<L>(static_cast<int64_t>(blockIdx.x) * blockDim.x, count);
  const int64_t w = start + at.row;
  uint32_t s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int word = at.q * K + k;
    const int64_t v = word == pos ? w % bb::P : base[word];
    s[k] = bb::to_mont(static_cast<uint32_t>(v));
  }
  p2::permute<L>(s, T, at.q);
  if (at.valid && at.q == 0 && (bb::from_mont(s[0]) & mask) == 0)
    atomicMin(best, static_cast<unsigned long long>(w));
}

unsigned block_threads(int64_t threads) {
  for (unsigned b = 128; b > 32; b >>= 1)
    if (threads >= static_cast<int64_t>(b) * 4 * SMS) return b;
  return 32;
}

unsigned grid_blocks(int64_t threads, unsigned block) {
  return static_cast<unsigned>((threads + block - 1) / block);
}

cudaStream_t as_stream(void* stream) { return static_cast<cudaStream_t>(stream); }

}  // namespace

// Standard-form tables in (round constants; the diagonal must be 1..16,
// which the core multiplies by as small integers), laid out for the core in
// Montgomery form.
extern "C" int p2_set_constants(const uint32_t* ext, const uint32_t* int_rc,
                                const uint32_t* diag) {
  for (int i = 0; i < WIDTH; ++i)
    if (diag[i] != static_cast<uint32_t>(i + 1)) return static_cast<int>(cudaErrorInvalidValue);
  const p2::Tables t = p2::make_tables(ext, int_rc);
  return static_cast<int>(cudaMemcpyToSymbol(TABLES, &t, sizeof(t)));
}

// Launches kernel<lanes> (lanes 1 or 4); any other count returns an error
// from the calling entry point.
#define P2_LAUNCH_AT(kernel, lanes, grid, block, stream, ...)                       \
  do {                                                                              \
    if ((lanes) == 4) {                                                             \
      kernel<4><<<(grid), (block), 0, as_stream(stream)>>>(__VA_ARGS__);           \
    } else if ((lanes) == 1) {                                                      \
      kernel<1><<<(grid), (block), 0, as_stream(stream)>>>(__VA_ARGS__);           \
    } else {                                                                        \
      return static_cast<int>(cudaErrorInvalidValue);                               \
    }                                                                               \
  } while (0)

#define P2_LAUNCH(kernel, lanes, threads, stream, ...)                              \
  do {                                                                              \
    const unsigned b_ = block_threads(threads);                                     \
    P2_LAUNCH_AT(kernel, lanes, grid_blocks(threads, b_), b_, stream, __VA_ARGS__); \
  } while (0)

// K1a: (n, 16) int64 standard form in -> out.
extern "C" int p2_permute(const void* in, void* out, long long n, int lanes, void* stream) {
  P2_LAUNCH(permute_kernel, lanes, n * lanes, stream, static_cast<const int64_t*>(in),
            static_cast<int64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// K1b: rows of an (n, w) int64 matrix with the given strides (in elements)
// -> (n, 8) contiguous digests.
extern "C" int p2_hash_rows(const void* m, long long n, long long w, long long row_stride,
                            long long col_stride, void* out, int lanes, void* stream) {
  P2_LAUNCH(sponge_kernel, lanes, n * lanes, stream, static_cast<const int64_t*>(m), n, w,
            row_stride, col_stride, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K1c: a (2n - 1, 8) contiguous buffer whose first n rows are the leaf
// digests (n a power of two) -> every level after them, the root last.
// Returns the number of launches through *launches.
extern "C" int p2_merkle_levels(void* buf, long long n, int lanes, void* stream,
                                int* launches) {
  int64_t* level = static_cast<int64_t*>(buf);
  *launches = 0;
  for (long long n_out = n / 2; n_out >= 1; n_out /= 2) {
    int64_t* next = level + 2 * n_out * DIGEST;
    if (n_out <= TOP_PARENTS) {
      int levels = 0;
      for (long long k = n_out; k >= 1; k /= 2) ++levels;
      const unsigned threads = static_cast<unsigned>(n_out * lanes);
      P2_LAUNCH_AT(compress_kernel, lanes, 1, threads < 32 ? 32 : threads, stream, level, next,
                   n_out, levels);
      ++*launches;
      break;
    }
    P2_LAUNCH(compress_kernel, lanes, n_out * lanes, stream, level, next, n_out, 1);
    ++*launches;
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    level = next;
  }
  return static_cast<int>(cudaGetLastError());
}

// K1d: candidates start .. start + count - 1; *best (device, preset to all
// ones by the caller) becomes the lowest hit.
extern "C" int p2_grind(const void* base, int pos, unsigned mask, long long start,
                        long long count, void* best, int lanes, void* stream) {
  P2_LAUNCH(grind_kernel, lanes, count * lanes, stream, static_cast<const int64_t*>(base), pos,
            mask, start, count, static_cast<unsigned long long*>(best));
  return static_cast<int>(cudaGetLastError());
}
