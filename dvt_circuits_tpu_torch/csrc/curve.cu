// Kernels C1-C4: BLS12-381 on the card.  The field and point arithmetic is
// csrc/bls12_381.cuh (12 x 32-bit words, CIOS Montgomery products on
// 64-bit accumulators, every operand passed by value); every entry point reads and
// writes the port's layout, 32 limbs of 12 bits in int64, Montgomery form,
// R = 2^384 (curve/fp.py), and converts at its edges.
//
// C1 fp_mont_mul replaces the XLA dvt_circuits_tpu/curve/fp.py:mont_mul
// (_mul_columns' band-matrix dot_general, _normalize, cond_sub_p).  Bound:
// bytes.  A product moves 768 bytes (two elements in, one out, 256 bytes
// each in int64 limbs) and does 300 32-bit multiplies: 0.4 multiplies a
// byte, far below the card's ~5 IMAD per byte of device memory.  A thread
// reading its own 256-byte row straight from device memory would make each
// warp load touch 32 rows 256 bytes apart, 8 bytes of each 32-byte sector.
// So a persistent grid (as many blocks as fit on the card) walks tiles of
// kTile products (csrc/fp_tile.cuh): warp 0 sends a tile's a and b rows
// into shared memory by bulk asynchronous copies (cp.async.bulk, completing
// on the stage's mbarrier), a group of consecutive rows a copy, so that one
// warp issues few copies a tile; the groups lie 16 bytes apart, so each
// thread unpacks its row with 16-byte loads on banks no other thread of its
// quarter-warp touches; kStages stages, so the next tiles stream in while
// this one is multiplied.  Each thread runs the CIOS product and packs the
// result into its out row; the block then stores the tile's rows 16 bytes
// a thread, coalesced.
//
// C2 g1_msm_windowed replaces dvt_circuits_tpu/curve/g1.py:_msm_jit
// (scalar_mul_windowed + _tree_reduce).  A group of 4 lanes per point (8
// points a warp, bls12_381_lanes.cuh) runs the 4-bit fixed-window scalar
// multiplication: a 16-entry table by 14 additions in order, kept in shared
// memory (16 x 144 bytes a point), then 64 windows of 4 doublings and one
// addition.  Then the per-point results are reduced with the JAX tree's
// pairing (i with i + half, the odd last point moved to half), one launch a
// level, each node an addition on a group of lanes, so the result is the
// JAX algorithm's Jacobian point.  Device launches a call: 1 + ceil(log2 n)
// for n >= 2 (the last level writes the limbs), 2 for n = 1 and 1 for n =
// 0 (a store).  Bound: operations, 7 products a doubling and 16 an
// addition at 300 multiplies each.  What floors it: a point's chain of 78
// additions (5 steps with products, 4 of sums alone) and 256 doublings (3
// and 5), a step with products as long as one product in one lane.
//
// C3 g1_msm_bucket replaces dvt_circuits_tpu/curve/g1.py:_msm_bucket_jit
// (argsort by digit, a Blelloch group-law scan, prefix differences, the
// binary-weight sums and the Horner).  Bound: operations, Pippenger's
// additions (chip_smoke.py:_bucket_products): every point with a nonzero
// digit once per window, 2 (2^w - 1) per window for the running sums and
// the Horner's w doublings and one addition per window.  Its first design
// ran one thread per (window, bucket) over all m digits: a warp's 32 lanes
// were 32 buckets of one window, so at each point one lane added while 31
// waited, and one bucket that held most points (equal or small scalars)
// held its window; then one thread per window ran 2 (2^w - 1) = 510
// dependent additions.  Here C3 is four launches on one stream, and no
// thread loops over all m digits or over all of a bucket's points:
//   C3a g1_bucket_sort_kernel, one block per window: a stable counting sort
//       of the m digits into 2^w buckets (chunk histograms in shared
//       memory, one exclusive scan over (bucket, chunk), a scatter of point
//       indices), so a bucket keeps its points in index order;
//   C3b g1_bucket_sum_kernel: the window's sorted nonzero entries in chunks
//       of kChunk, one thread a chunk adding its runs of equal digit (one
//       partial per (chunk, bucket)); each bucket's partials are joined by
//       a tree whose every node is added by the thread that finishes the
//       second of its halves, so a thread makes at most kChunk - 1
//       additions of points and 2 log2 (m / kChunk) joins whatever the
//       digits (an atomic counter per node only picks that thread: the
//       order of every addition is fixed, so the limbs are the same on
//       every run);
//   C3c g1_window_sum_kernel, one block per window: thread g of kGroups
//       runs the running sums of L consecutive buckets from the top (T_g and
//       U_g = sum (b - b_lo + 1) S_b), adds (b_lo - 1) T_g by a
//       double-and-add of w bits, and a tree over the groups in shared
//       memory gives W = sum b S_b: about 2L + 2w + log2 G point operations
//       deep, against 510;
//   C3d g1_horner_kernel, one thread: the windows from the most
//       significant, w doublings and one addition each.
// What now sets C3's time is the Horner's (nwin - 1) (w + 1) dependent
// point operations (144 at w = 8) and the latency of one point operation
// in one thread: the floor of this design, and the input to point
// operations spread over several lanes.  The additions run in the order of
// g1.py:msm_bucket_plain, so C3's Jacobian limbs equal the plain version's.
//
// C4 g2_scalar_mul replaces dvt_circuits_tpu/curve/g2.py:scalar_mul.  A
// warp per point (bls12_381_lanes.cuh): 256 rounds of a doubling and, where
// the bit is set, an addition over Fp^2 (schoolbook: 4 base products a
// multiply, 3 a square, all side by side), each spread over the warp's
// lanes; the branches on
// the bit and on the addition's special cases are uniform across the warp
// and pick what the JAX selects pick, so the result's limbs equal the JAX
// algorithm's.  Bound: operations.  What floors it: 256 doublings (3 steps
// with products, 7 of sums alone) and an addition a set bit (5 and 9),
// one after another.
//
// C1 runs one product a thread over tiles staged in shared memory; C3's
// stages run one point operation a thread; C2 and C4 spread each point
// operation over lanes.
#include <cuda_runtime.h>

#include <cstdint>

#include "bls12_381.cuh"
#include "bls12_381_lanes.cuh"
#include "fp_tile.cuh"

namespace {

using bls::Fp;
using bls::Fp2;
using bls::G1;
using bls::G2;

constexpr int PW = 3 * bls::NW;  // 32-bit words of a G1 point in scratch
constexpr int kSortThreads = 128;
constexpr int kSumThreads = 128;
// C3b: the sorted entries one thread adds (g1.py:BUCKET_CHUNK; C3b's time
// follows it, and 8 was the fastest of 8, 16 and 32 at every input
// curve/sweep.py c3 times); C3c: the groups of consecutive buckets a
// window is cut into, one thread each (g1.py:WINDOW_GROUPS)
constexpr int kChunk = 8;
constexpr int kGroups = 64;

// C3b's slots of partial sums a window: a bucket's partials sit from chunk
// (offsets[b] - offsets[1]) / kChunk + b - 1 on
__host__ __device__ __forceinline__ int bucket_slots(int m, int window_bits) {
  return (m + kChunk - 1) / kChunk + (1 << window_bits) - 1;
}

__device__ __forceinline__ G1 load_point(const int64_t* x, const int64_t* y, const int64_t* z,
                                         int64_t i) {
  return {bls::load(x + i * bls::NLIMBS), bls::load(y + i * bls::NLIMBS),
          bls::load(z + i * bls::NLIMBS)};
}

__device__ __forceinline__ G1 get(const uint32_t* words) {
  G1 p;
#pragma unroll
  for (int k = 0; k < bls::NW; ++k) {
    p.x.w[k] = words[k];
    p.y.w[k] = words[bls::NW + k];
    p.z.w[k] = words[2 * bls::NW + k];
  }
  return p;
}

// through L2: words another block wrote in this launch
__device__ __forceinline__ G1 get_cg(const uint32_t* words) {
  G1 p;
#pragma unroll
  for (int k = 0; k < bls::NW; ++k) {
    p.x.w[k] = __ldcg(words + k);
    p.y.w[k] = __ldcg(words + bls::NW + k);
    p.z.w[k] = __ldcg(words + 2 * bls::NW + k);
  }
  return p;
}

__device__ __forceinline__ void put(uint32_t* words, const G1& p) {
#pragma unroll
  for (int k = 0; k < bls::NW; ++k) {
    words[k] = p.x.w[k];
    words[bls::NW + k] = p.y.w[k];
    words[2 * bls::NW + k] = p.z.w[k];
  }
}

__device__ __forceinline__ void store_point(int64_t* out, const G1& p) {
  bls::store(out, p.x);
  bls::store(out + bls::NLIMBS, p.y);
  bls::store(out + 2 * bls::NLIMBS, p.z);
}

// bulk asynchronous copy of `bytes` (a multiple of 16) from device memory to
// shared memory, counted on the mbarrier `bar` as it lands
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src), "r"(bytes),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// C1: out[i] = a[i] * b[i] * 2^-384 mod p; a, b and out 16-byte aligned.
// The second launch bound lets ptxas take the registers the product needs:
// without it, ptxas caps them low enough to keep a value in a stack frame.
__global__ void __launch_bounds__(bls::tile::kTile, 1) fp_mont_mul_kernel(
    const int64_t* __restrict__ a, const int64_t* __restrict__ b, int64_t* __restrict__ out,
    int64_t n) {
  namespace tile = bls::tile;
  extern __shared__ __align__(16) int64_t slots[];  // fp_tile.cuh's layout
  __shared__ __align__(8) uint64_t full[tile::kStages];
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < tile::kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       static_cast<uint32_t>(__cvta_generic_to_shared(full + s)))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // warp 0: lane 0 arms the stage's barrier with the tile's bytes, then
  // lanes 0 .. 2 kGroups - 1 send its groups of rows, a then b, one bulk
  // copy each
  auto fetch = [&](int64_t k, int stage) {
    if (t >= 32) return;
    const int rows = tile::tile_rows(k, n);
    if (t == 0)
      asm volatile(
          "fence.proxy.async.shared::cta;\n\t"
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              static_cast<uint32_t>(__cvta_generic_to_shared(full + stage))),
          "r"(rows * 2 * tile::kRowBytes)
          : "memory");
    __syncwarp();
    for (int c = t; c < 2 * tile::kGroups; c += 32)
      tile::tile_copy(slots, stage, a, b, k, rows, c,
                      [&](int64_t* dst, const int64_t* src, int bytes) {
                        bulk_copy(dst, src, bytes, full + stage);
                      });
  };
  tile::mont_mul_tiles(
      slots, out, n, blockIdx.x, gridDim.x, t, fetch,
      [&](int stage, uint32_t parity) { mbar_wait(full + stage, parity); },
      [] { __syncthreads(); });
}

// -- C2 ----------------------------------------------------------------------

namespace lanes = bls::lanes;

// C2's groups a block: one warp (the per-point pass, whose tables fill the
// shared memory), or two (the tree)
constexpr int kG1Groups = 32 / lanes::kG1Lanes;
constexpr int kTreeGroups = 64 / lanes::kG1Lanes;
constexpr int kG1GroupWords = lanes::kG1Slots * bls::NW;
constexpr int kWindowedStride = lanes::group_stride(kG1GroupWords + 16 * PW);
constexpr int kTreeStride = lanes::group_stride(kG1GroupWords);

// C2's first launch: group g of the block takes point i, its scalar
// multiplication by its digits into partial[i]; a group past n runs on the
// identity and all-zero digits, so every warp stays whole at __syncwarp
__global__ void __launch_bounds__(32) g1_windowed_kernel(
    const int64_t* __restrict__ x, const int64_t* __restrict__ y, const int64_t* __restrict__ z,
    const int32_t* __restrict__ digits, uint32_t* __restrict__ partial, int64_t n) {
  __shared__ __align__(16) uint32_t smem[kG1Groups * kWindowedStride];
  const int g = threadIdx.x / lanes::kG1Lanes, lane = threadIdx.x % lanes::kG1Lanes;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kG1Groups + g;
  const bool live = i < n;
  uint32_t* slots = smem + g * kWindowedStride;
  if (lane < 3) {  // q = P, a coordinate a lane
    const int64_t* c = lane == 0 ? x : lane == 1 ? y : z;
    lanes::put(slots + (3 + lane) * bls::NW,
               live ? bls::load(c + i * bls::NLIMBS) : lane == 1 ? bls::fp_one() : bls::fp_zero());
  }
  __syncwarp();
  lanes::g1_windowed(slots, slots + kG1GroupWords,
                     live ? digits + i * lanes::NUM_WINDOWS : nullptr, lane);
  if (live)
    for (int k = lane; k < PW; k += lanes::kG1Lanes) partial[i * PW + k] = slots[k];
}

// One level of g1.py:_tree_reduce over len points: node j = in[j] +
// in[j + half], or the odd last point at j = half, into out[j]; at len = 2
// the one node is the result, written as int64 limbs to `limbs`
__global__ void __launch_bounds__(64) g1_tree_level_kernel(const uint32_t* __restrict__ in,
                                                           uint32_t* __restrict__ out, int64_t len,
                                                           int64_t* __restrict__ limbs) {
  __shared__ __align__(16) uint32_t smem[kTreeGroups * kTreeStride];
  const int g = threadIdx.x / lanes::kG1Lanes, lane = threadIdx.x % lanes::kG1Lanes;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kTreeGroups + g;
  uint32_t* slots = smem + g * kTreeStride;
  lanes::g1_tree_node(slots, in, len, j, lane);
  if (j >= (len + 1) / 2) return;
  if (limbs != nullptr) {
    if (lane < 3) bls::store(limbs + lane * bls::NLIMBS, lanes::get(slots + lane * bls::NW));
  } else {
    for (int k = lane; k < PW; k += lanes::kG1Lanes) out[j * PW + k] = slots[k];
  }
}

// C2 for n <= 1: the one point, or the identity
__global__ void g1_store_kernel(const uint32_t* __restrict__ pts, int64_t n,
                                int64_t* __restrict__ out) {
  store_point(out, n > 0 ? get(pts) : bls::identity<Fp>());
}

// -- C3 ----------------------------------------------------------------------

// C3a, block v = window v: idx[v][offsets[v][b] ...] = the points whose
// digit is b, in index order; offsets[v][2^w] = m.  Thread t counts, then
// scatters, the contiguous chunk of points [t * per, (t + 1) * per).  Also
// zeroes C3b's counters of joined halves.
__global__ void __launch_bounds__(kSortThreads) g1_bucket_sort_kernel(
    const int32_t* __restrict__ digits, int m, int nwin, int window_bits,
    int32_t* __restrict__ idx, int32_t* __restrict__ offsets, unsigned* __restrict__ arrive) {
  extern __shared__ int32_t cnt[];  // (2^w, T), bucket-major: cnt[b * T + t]
  __shared__ int32_t seg[kSortThreads];
  const int v = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const int nbk = 1 << window_bits;
  const int per = (m + T - 1) / T;
  const int lo = min(m, t * per), hi = min(m, lo + per);
  for (int b = 0; b < nbk; ++b) cnt[b * T + t] = 0;
  for (int i = lo; i < hi; ++i) ++cnt[digits[static_cast<int64_t>(i) * nwin + v] * T + t];
  __syncthreads();
  // exclusive scan of cnt in its flat order: thread t takes the run
  // [t * nbk, (t + 1) * nbk), thread 0 scans the T run totals
  int32_t sum = 0;
  for (int k = 0; k < nbk; ++k) sum += cnt[t * nbk + k];
  seg[t] = sum;
  __syncthreads();
  if (t == 0) {
    int32_t run = 0;
    for (int k = 0; k < T; ++k) {
      const int32_t c = seg[k];
      seg[k] = run;
      run += c;
    }
  }
  __syncthreads();
  int32_t run = seg[t];
  for (int k = 0; k < nbk; ++k) {
    const int32_t c = cnt[t * nbk + k];
    cnt[t * nbk + k] = run;
    run += c;
  }
  __syncthreads();
  int32_t* off = offsets + v * (nbk + 1);
  for (int b = t; b < nbk; b += T) off[b] = cnt[b * T];
  if (t == 0) off[nbk] = m;
  const int nslots = bucket_slots(m, window_bits);
  for (int k = t; k < nslots; k += T) arrive[static_cast<int64_t>(v) * nslots + k] = 0;
  __syncthreads();  // the scatter below moves the starts just read
  for (int i = lo; i < hi; ++i) {
    const int d = digits[static_cast<int64_t>(i) * nwin + v];
    idx[static_cast<int64_t>(v) * m + cnt[d * T + t]++] = i;
  }
}

// C3b's slot of bucket b's first partial: chunk (offsets[b] - o1) / kChunk
// of the window's nonzero entries, moved up by b - 1 so that every bucket's
// partials are consecutive and no two buckets share a slot
__device__ __forceinline__ int first_slot(const int32_t* off, int b) {
  return (off[b] - off[1]) / kChunk + b - 1;
}

// the partials of bucket b: one for each chunk its entries touch
__device__ __forceinline__ int partial_count(const int32_t* off, int b) {
  if (off[b + 1] == off[b]) return 0;
  return (off[b + 1] - 1 - off[1]) / kChunk - (off[b] - off[1]) / kChunk + 1;
}

// C3b's tree over bucket d's partials, entered for partial j of chunk c,
// already in its slot: at span h (1, 2, 4, ...) node p = j rounded down to
// 2h is node p + node p + h when p + h < count, else node p unchanged (the
// tree j + s -> j of g1.py:bucket_sums_plain), and stays in slot p.  The two
// halves of a node are added by the thread that finishes the second: the
// counter of the right half tells which one that is.  The counter decides
// who adds, never the order, and is back at 0 when the launch ends.  The
// root is S_{v,d}.
__device__ __forceinline__ void join_partials(uint32_t* part, unsigned* arrive, uint32_t* out,
                                              const int32_t* off, int c, int d) {
  const int first = first_slot(off, d), count = partial_count(off, d);
  uint32_t* node = part + static_cast<int64_t>(first) * PW;
  int j = c + d - 1 - first;
  G1 acc;
  for (int h = 1; h < count; h *= 2) {
    const int p = j & ~(2 * h - 1), r = p + h;
    if (r >= count) continue;  // no right half: j == p goes up as it is
    __threadfence();
    if (atomicAdd(arrive + first + r, 1u) == 0) return;  // the other half adds
    __threadfence();
    arrive[first + r] = 0;
    acc = bls::add(get_cg(node + static_cast<int64_t>(p) * PW),
                   get_cg(node + static_cast<int64_t>(r) * PW));
    put(node + static_cast<int64_t>(p) * PW, acc);
    j = p;
  }
  put(out + static_cast<int64_t>(d - 1) * PW, acc);  // every path to the root adds once
}

// C3b, blocks (x, v) for window v: thread c adds the runs of equal digit in
// chunk c of the window's sorted nonzero entries (one point read per entry,
// one addition per entry after a run's first).  A run that is its whole
// bucket writes S_{v,b} to buckets[v][b - 1]; the others are partials, and
// only the chunk's first and last runs can be: after its chunk, the thread
// takes those two into their buckets' trees (join_partials), so the warp's
// additions stay in step.  An empty bucket's sum is the identity.  A thread
// adds at most kChunk - 1 points and joins at most log2 of each of the two
// buckets' partials.
__global__ void __launch_bounds__(kSumThreads) g1_bucket_sum_kernel(
    const int64_t* __restrict__ x, const int64_t* __restrict__ y, const int64_t* __restrict__ z,
    const int32_t* __restrict__ digits, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ offsets, int m, int nwin, int window_bits, int nslots,
    uint32_t* partial, unsigned* arrive, uint32_t* __restrict__ buckets) {
  __shared__ int32_t off[257];
  const int v = blockIdx.y, nbk = 1 << window_bits, nb = nbk - 1;
  for (int b = threadIdx.x; b <= nbk; b += blockDim.x) off[b] = offsets[v * (nbk + 1) + b];
  __syncthreads();
  uint32_t* out = buckets + static_cast<int64_t>(v) * nb * PW;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  for (int b = 1 + c; b <= nb; b += gridDim.x * blockDim.x)
    if (off[b + 1] == off[b]) put(out + static_cast<int64_t>(b - 1) * PW, bls::identity<Fp>());
  const int s0 = off[1] + c * kChunk;
  if (s0 >= m) return;
  const int32_t* order = idx + static_cast<int64_t>(v) * m;
  uint32_t* part = partial + static_cast<int64_t>(v) * nslots * PW;
  const int s1 = min(m, s0 + kChunk);
  int i = order[s0];
  int d = digits[static_cast<int64_t>(i) * nwin + v];
  const int d0 = d;
  G1 acc = load_point(x, y, z, i);
  for (int s = s0 + 1;; ++s) {
    int e = 0;
    if (s < s1) {
      i = order[s];
      e = digits[static_cast<int64_t>(i) * nwin + v];
      if (e == d) {
        acc = bls::add(acc, load_point(x, y, z, i));
        continue;
      }
    }
    put(partial_count(off, d) == 1 ? out + static_cast<int64_t>(d - 1) * PW
                                   : part + static_cast<int64_t>(c + d - 1) * PW,
        acc);
    if (s == s1) break;
    acc = load_point(x, y, z, i);
    d = e;
  }
  unsigned* arr = arrive + static_cast<int64_t>(v) * nslots;
  for (int k = 0; k < 2; ++k) {
    const int b = k ? d : d0;
    if ((k == 0 || d != d0) && partial_count(off, b) > 1) join_partials(part, arr, out, off, c, b);
  }
}

// C3c, block v = window v, thread g = group g of L consecutive buckets
// [b_lo, b_hi]: R = sum S_b and U = sum (b - b_lo + 1) S_b by running sums
// from b_hi down, then W_g = U + (b_lo - 1) R (w bits of double-and-add
// from the top); a tree over the groups (g and g + s at level s) in shared
// memory gives W_v = sum_b b S_b in windows[v].  R and U wait in shared
// memory and the running sums make one call of add a step: with two calls
// a step, ptxas spilled inside this kernel's copy of add.
__global__ void __launch_bounds__(kGroups) g1_window_sum_kernel(
    const uint32_t* __restrict__ buckets, int nwin, int window_bits,
    uint32_t* __restrict__ windows) {
  __shared__ uint32_t sw[2 * kGroups * PW];
  const int v = blockIdx.x, g = threadIdx.x;
  const int nb = (1 << window_bits) - 1;
  const int len = (nb + kGroups - 1) / kGroups, ng = (nb + len - 1) / len;
  uint32_t* R = sw + (kGroups + g) * PW;
  uint32_t* U = sw + g * PW;
  if (g < ng) {
    const uint32_t* S = buckets + static_cast<int64_t>(v) * nb * PW;  // S_b at b - 1
    const int b_lo = g * len + 1, b_hi = min(b_lo + len - 1, nb);
    put(R, get(S + (b_hi - 1) * PW));
    put(U, get(R));
    // one call site: step 2i adds S_b (b = b_hi - 1 - i) into R, step
    // 2i + 1 adds R into U
    for (int k = 0; k < 2 * (b_hi - b_lo); ++k) {
      uint32_t* to = k & 1 ? U : R;
      const uint32_t* from = k & 1 ? R : S + (b_hi - 2 - k / 2) * PW;
      put(to, bls::add(get(to), get(from)));
    }
    G1 q = bls::identity<Fp>();
    for (int j = window_bits - 1; j >= 0; --j) {
      q = bls::dbl(q);
      if (((b_lo - 1) >> j) & 1) q = bls::add(q, get(R));
    }
    put(U, bls::add(get(U), q));
  }
  __syncthreads();
  for (int s = 1; s < ng; s *= 2) {
    if (g % (2 * s) == 0 && g + s < ng) put(U, bls::add(get(U), get(U + s * PW)));
    __syncthreads();
  }
  if (g == 0) put(windows + static_cast<int64_t>(v) * PW, get(sw));
}

// C3d, one thread: the windows, most significant first, joined by
// window_bits doublings each
__global__ void g1_horner_kernel(const uint32_t* __restrict__ windows, int nwin, int window_bits,
                                 int64_t* __restrict__ out) {
  G1 acc = get(windows);
  for (int w = 1; w < nwin; ++w) {
    for (int k = 0; k < window_bits; ++k) acc = bls::dbl(acc);
    acc = bls::add(acc, get(windows + w * PW));
  }
  store_point(out, acc);
}

// C4, block i = point i, one warp: lane e < 6 loads and stores element e
// (coordinate e / 2, component e % 2)
__global__ void __launch_bounds__(32) g2_scalar_mul_kernel(
    const int64_t* __restrict__ x, const int64_t* __restrict__ y, const int64_t* __restrict__ z,
    const int32_t* __restrict__ bits, int64_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t slots[lanes::kG2Slots * bls::NW];
  const int64_t i = blockIdx.x;
  const int lane = threadIdx.x, c = lane / 2, part = lane % 2;
  const int64_t at = (i * 2 + part) * bls::NLIMBS;  // (n, 2, 32) limbs a coordinate
  if (lane < 6) {
    const int64_t* src = c == 0 ? x : c == 1 ? y : z;
    lanes::put(slots + (6 + lane) * bls::NW, bls::load(src + at));
  }
  __syncwarp();
  lanes::g2_double_and_add(slots, bits + i * lanes::SCALAR_BITS, lane);
  if (lane < 6) bls::store(out + c * n * 2 * bls::NLIMBS + at, lanes::get(slots + lane * bls::NW));
}

unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// out[i] = a[i] * b[i] * 2^-384 mod p for n elements of 32 int64 limbs; a,
// b and out contiguous and 16-byte aligned.  One launch: as many blocks as
// the card holds at once, at most one a tile.
extern "C" int fp_mont_mul(const void* a, const void* b, void* out, long long n, void* stream) {
  static int resident[64] = {};  // blocks the whole card holds at once, by device
  int device;
  if (cudaError_t e = cudaGetDevice(&device)) return static_cast<int>(e);
  int& blocks = resident[device % 64];
  if (blocks == 0) {
    int sms, per_sm;
    if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))
      return static_cast<int>(e);
    if (cudaError_t e = cudaFuncSetAttribute(fp_mont_mul_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             bls::tile::kSmemBytes))
      return static_cast<int>(e);
    if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fp_mont_mul_kernel, bls::tile::kTile, bls::tile::kSmemBytes))
      return static_cast<int>(e);
    blocks = sms * per_sm;
  }
  const int64_t tiles = bls::tile::tile_count(n);
  const unsigned grid = static_cast<unsigned>(tiles < blocks ? tiles : blocks);
  fp_mont_mul_kernel<<<grid, bls::tile::kTile, bls::tile::kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b),
      static_cast<int64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// C1's products a tile (the tests' and chip_smoke.py's tail sizes)
extern "C" int fp_mont_mul_tile() { return bls::tile::kTile; }

// out (3 x 32 int64 limbs, Jacobian) = sum_i digits_i * P_i for n points
// (x, y, z: n x 32 int64 limbs each; digits: n x 64 int32, MSB first);
// partial: (n + ceil(n / 2)) x 36 words of scratch, two buffers the tree's
// levels go back and forth between.  1 + ceil(log2 n) launches (n >= 2).
extern "C" int g1_msm_windowed(const void* x, const void* y, const void* z, const void* digits,
                               void* out, void* partial, long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto limbs = static_cast<int64_t*>(out);
  uint32_t* a = static_cast<uint32_t*>(partial);
  uint32_t* b = a + n * PW;
  if (n > 0) {
    g1_windowed_kernel<<<blocks_for(n, kG1Groups), 32, 0, s>>>(
        static_cast<const int64_t*>(x), static_cast<const int64_t*>(y),
        static_cast<const int64_t*>(z), static_cast<const int32_t*>(digits), a, n);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  if (n <= 1) {
    g1_store_kernel<<<1, 1, 0, s>>>(a, n, limbs);
    return static_cast<int>(cudaGetLastError());
  }
  for (long long len = n; len > 1; len = (len + 1) / 2) {
    g1_tree_level_kernel<<<blocks_for((len + 1) / 2, kTreeGroups), 64, 0, s>>>(
        a, b, len, len == 2 ? limbs : nullptr);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    uint32_t* t = a;
    a = b;
    b = t;
  }
  return 0;
}

// C3's four launches, one entry point each, for m points (x, y, z: m x 32
// int64 limbs each) and nwin windows of window_bits bits (digits: m x nwin
// int32, MSB first).  Scratch: idx nwin x m and offsets nwin x (2^w + 1)
// int32, arrive nwin x nslots unsigned and partial nwin x nslots x 36 words
// with nslots = bucket_slots(m, window_bits), buckets nwin x (2^w - 1) x 36
// words, windows nwin x 36 words; out 3 x 32 int64 limbs (Jacobian).

// C3a
extern "C" int g1_bucket_sort(const void* digits, int window_bits, int m, int nwin, void* idx,
                              void* offsets, void* arrive, void* stream) {
  const int shared = (1 << window_bits) * kSortThreads * static_cast<int>(sizeof(int32_t));
  if (cudaError_t e = cudaFuncSetAttribute(
          g1_bucket_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared))
    return static_cast<int>(e);
  g1_bucket_sort_kernel<<<nwin, kSortThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(digits), m, nwin, window_bits, static_cast<int32_t*>(idx),
      static_cast<int32_t*>(offsets), static_cast<unsigned*>(arrive));
  return static_cast<int>(cudaGetLastError());
}

// C3b
extern "C" int g1_bucket_sums(const void* x, const void* y, const void* z, const void* digits,
                              const void* idx, const void* offsets, int window_bits, int m,
                              int nwin, void* partial, void* arrive, void* buckets,
                              void* stream) {
  const dim3 grid(blocks_for((m + kChunk - 1) / kChunk, kSumThreads), nwin);
  g1_bucket_sum_kernel<<<grid, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<const int64_t*>(y),
      static_cast<const int64_t*>(z), static_cast<const int32_t*>(digits),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(offsets), m, nwin,
      window_bits, bucket_slots(m, window_bits), static_cast<uint32_t*>(partial),
      static_cast<unsigned*>(arrive), static_cast<uint32_t*>(buckets));
  return static_cast<int>(cudaGetLastError());
}

// C3c
extern "C" int g1_window_sums(const void* buckets, int window_bits, int nwin, void* windows,
                              void* stream) {
  const int nb = (1 << window_bits) - 1;
  const int len = (nb + kGroups - 1) / kGroups, ng = (nb + len - 1) / len;
  g1_window_sum_kernel<<<nwin, (ng + 31) / 32 * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(buckets), nwin, window_bits, static_cast<uint32_t*>(windows));
  return static_cast<int>(cudaGetLastError());
}

// C3d
extern "C" int g1_horner(const void* windows, int window_bits, int nwin, void* out,
                         void* stream) {
  g1_horner_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(windows), nwin, window_bits, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out (3 x n x 2 x 32 int64 limbs, Jacobian over Fp^2) = bits_i * P_i for n
// G2 points (x, y, z: n x 2 x 32 int64 limbs each; bits: n x 256 int32,
// little-endian)
extern "C" int g2_scalar_mul(const void* x, const void* y, const void* z, const void* bits,
                             void* out, long long n, void* stream) {
  g2_scalar_mul_kernel<<<static_cast<unsigned>(n), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<const int64_t*>(y),
      static_cast<const int64_t*>(z), static_cast<const int32_t*>(bits),
      static_cast<int64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
