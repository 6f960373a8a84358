// Kernel C1's tiles (csrc/curve.cu:fp_mont_mul_kernel): the split of a batch
// of Fp products into tiles, the tile's layout in shared memory, the unpack
// of a row's 32 int64 limbs into bls::Fp's 12 words and the repack, and the
// loop a block runs over its tiles.  The kernel passes in how a tile's rows
// reach shared memory (bulk asynchronous copies completing on an mbarrier a
// stage) and how the block synchronizes; tests/curve_host_lanes.cpp passes
// a memcpy and a barrier of host threads, one a CUDA thread, and so runs
// this same loop on the CPU.
//
// A tile's kTile rows of an operand lie in shared memory as kGroups groups
// of kTile / kGroups consecutive rows, each group as it lies in device
// memory (256 bytes a row) and so one bulk copy, the groups 16 bytes apart.
// Thread t takes row (t % kGroups) * (kTile / kGroups) + t / kGroups and
// reads and writes it 16 bytes at a time: the eight threads of a
// quarter-warp then take one row of each group, their accesses fall on
// eight distinct groups of four banks, and none conflicts.  Rows 256 bytes
// apart, thread t on row t, would put all of them on one bank group.
// Layout, in int64 words: kStages stages of the a rows then the b rows;
// then the out rows, the product of each thread, in the same layout.
#pragma once

#include <cstdint>

#include "bls12_381.cuh"

namespace bls::tile {

constexpr int kTile = 128;   // products a tile: one a thread
constexpr int kStages = 2;   // tiles of a block in flight at once
constexpr int kGroups = 8;   // copies an operand a tile: a quarter-warp's threads
constexpr int kGroupRows = kTile / kGroups;
constexpr int kRowBytes = NLIMBS * 8;                  // 256
constexpr int kPieces = kRowBytes / 16;                // 16-byte pieces a row
constexpr int kGroupWords = kGroupRows * NLIMBS + 2;   // a group and 16 bytes
constexpr int kAreaWords = kGroups * kGroupWords;      // kTile rows
constexpr int kSmemBytes = (2 * kStages + 1) * kAreaWords * 8;
static_assert(kTile % 32 == 0 && kGroupRows > 0, "a tile is whole warps of whole groups");

__host__ __device__ __forceinline__ int64_t tile_count(int64_t n) {
  return (n + kTile - 1) / kTile;
}

// rows of tile `tile`: kTile but in the last, which may be partial
__host__ __device__ __forceinline__ int tile_rows(int64_t tile, int64_t n) {
  const int64_t left = n - tile * kTile;
  return left < kTile ? static_cast<int>(left) : kTile;
}

// the a (operand 0) or b (operand 1) rows of a stage; the out rows
__host__ __device__ __forceinline__ int64_t* in_area(int64_t* smem, int stage, int operand) {
  return smem + (2 * stage + operand) * kAreaWords;
}

__host__ __device__ __forceinline__ int64_t* out_area(int64_t* smem) {
  return smem + 2 * kStages * kAreaWords;
}

__host__ __device__ __forceinline__ int64_t* row_at(int64_t* area, int row) {
  return area + (row / kGroupRows) * kGroupWords + (row % kGroupRows) * NLIMBS;
}

__host__ __device__ __forceinline__ int thread_row(int t) {
  return (t % kGroups) * kGroupRows + t / kGroups;
}

// copy c of 2 * kGroups that bring a tile of `rows` rows in: operand c /
// kGroups, group c % kGroups; fn(dst, src, bytes) for each that holds rows
template <class Copy>
__host__ __device__ __forceinline__ void tile_copy(int64_t* smem, int stage, const int64_t* a,
                                                   const int64_t* b, int64_t tile, int rows,
                                                   int c, Copy fn) {
  const int operand = c / kGroups, g = c % kGroups;
  const int count = rows - g * kGroupRows < kGroupRows ? rows - g * kGroupRows : kGroupRows;
  if (count > 0)
    fn(in_area(smem, stage, operand) + g * kGroupWords,
       (operand ? b : a) + (tile * kTile + g * kGroupRows) * NLIMBS, count * kRowBytes);
}

// 32 limbs of 12 bits -> 12 words of 32 bits (bls::load on a row in shared memory)
__device__ __forceinline__ Fp unpack(const int64_t* row) {
  Fp r;
  uint64_t acc = 0;
  int bits = 0, w = 0;
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const longlong2 v = reinterpret_cast<const longlong2*>(row)[j];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc |= static_cast<uint64_t>(h ? v.y : v.x) << bits;
      bits += 12;
      if (bits >= 32) {
        r.w[w++] = static_cast<uint32_t>(acc);
        acc >>= 32;
        bits -= 32;
      }
    }
  }
  return r;
}

__device__ __forceinline__ int64_t limb(const Fp& a, int i) {
  const int bit = 12 * i, word = bit / 32, off = bit % 32;
  uint32_t v = a.w[word] >> off;
  if (off > 20) v |= a.w[word + 1] << (32 - off);
  return static_cast<int64_t>(v & 0xfffu);
}

// 12 words -> 32 limbs (bls::store into a row in shared memory)
__device__ __forceinline__ void pack(int64_t* row, const Fp& a) {
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    longlong2 v;
    v.x = limb(a, 2 * j);
    v.y = limb(a, 2 * j + 1);
    reinterpret_cast<longlong2*>(row)[j] = v;
  }
}

// The block's tiles first, first + stride, ... of the n products
// out = a * b * 2^-384 mod p, thread t of kTile:
//   fetch(tile, stage)  called by every thread: start the tile's a and b
//                       rows on their way into the stage (tile_copy);
//   wait(stage, parity) called by every thread: return once they are there
//                       (the stage's parity-th filling);
//   sync()              the block's barrier.
// Each tile: the thread's rows into registers; the barrier, after which the
// stage takes the tile kStages on; the product (the CIOS of bls::mul,
// inlined: an out-of-line call would keep the loop's state in a stack frame)
// into the thread's out row; the barrier; the tile's rows out to `out` 16
// bytes a thread at a time, neighbouring threads on neighbouring addresses.
template <class Fetch, class Wait, class Sync>
__device__ __forceinline__ void mont_mul_tiles(int64_t* smem, int64_t* out, int64_t n,
                                               int64_t first, int64_t stride, int t,
                                               Fetch fetch, Wait wait, Sync sync) {
  const int64_t tiles = tile_count(n);
  const int row = thread_row(t);
  for (int s = 0; s < kStages; ++s)
    if (first + s * stride < tiles) fetch(first + s * stride, s);
  int k = 0;
  for (int64_t tile = first; tile < tiles; tile += stride, ++k) {
    const int stage = k % kStages, rows = tile_rows(tile, n);
    wait(stage, (k / kStages) & 1);
    const bool live = row < rows;
    Fp x, y;
    if (live) {
      x = unpack(row_at(in_area(smem, stage, 0), row));
      y = unpack(row_at(in_area(smem, stage, 1), row));
    }
    sync();  // the stage is read, and the last tile's out rows are stored
    if (tile + kStages * stride < tiles) fetch(tile + kStages * stride, stage);
    if (live) pack(row_at(out_area(smem), row), mont_mul_inline(x, y));
    sync();
    longlong2* dst = reinterpret_cast<longlong2*>(out + tile * kTile * NLIMBS);
    for (int c = t; c < rows * kPieces; c += kTile)
      dst[c] = reinterpret_cast<const longlong2*>(row_at(out_area(smem), c / kPieces))[c % kPieces];
  }
}

}  // namespace bls::tile
