// Kernels C1-C4: BLS12-381 on the card.  The field and point arithmetic is
// csrc/bls12_381.cuh (12 x 32-bit words, CIOS Montgomery products); every
// entry point reads and writes the port's layout, 32 limbs of 12 bits in
// int64, Montgomery form, R = 2^384 (curve/fp.py), and converts at its
// edges.
//
// C1 fp_mont_mul replaces the XLA dvt_circuits_tpu/curve/fp.py:mont_mul
// (_mul_columns' band-matrix dot_general, _normalize, cond_sub_p).  One
// thread per product.  Bound: bytes.  A product moves 768 bytes (two
// elements in, one out, 256 bytes each in int64 limbs) and does 300 32-bit
// multiplies: 0.4 multiplies a byte, far below the card's ~5 IMAD per byte
// of device memory.
//
// C2 g1_msm_windowed replaces dvt_circuits_tpu/curve/g1.py:_msm_jit
// (scalar_mul_windowed + _tree_reduce).  One thread per point runs the
// 4-bit fixed-window scalar multiplication (a 16-entry table by 14
// additions, then 64 windows of 4 doublings and one addition); a second
// launch of one block reduces the per-point results with the JAX tree's
// pairing (i, i + half per level), so the result is the JAX algorithm's
// Jacobian point.  Blocks run in no order, so nothing carries across
// blocks: the reduction is its own launch.  Bound: operations, 7 products a
// doubling and 16 an addition at 300 multiplies each.
//
// C3 g1_msm_bucket replaces dvt_circuits_tpu/curve/g1.py:_msm_bucket_jit.
// The TPU version sorts each window's points by digit and takes bucket sums
// as differences of a group-law prefix scan, because the TPU has no
// data-dependent scatter; here each (window, bucket) is one thread that
// adds the points whose digit is its bucket (the digits of a warp's
// buckets are one broadcast load), one thread per window forms
// sum_b b * S_b as a running sum from the top bucket down, and one thread
// runs the cross-window Horner.  Three launches; the result equals the JAX
// algorithm's as an affine point (its additions run in another order).
// Bound: operations, Pippenger's additions: every point with a nonzero
// digit once per window, 2 (2^w - 1) per window for the running sums, and
// the Horner's doublings and additions.
//
// C4 g2_scalar_mul replaces dvt_circuits_tpu/curve/g2.py:scalar_mul.  One
// thread per point, 256 double-and-add rounds over Fp^2 (Karatsuba, 3 base
// products a multiply, 2 a square) in the JAX formulas and selects: the
// result's limbs equal the JAX algorithm's.  Bound: operations.
//
// The designs are the simplest that are right: one thread per point keeps
// most of the card idle at a few thousand points, and the point operations
// keep their temporaries in local memory (ptxas -v reports the stack and
// spills).
#include <cuda_runtime.h>

#include <cstdint>

#include "bls12_381.cuh"

namespace {

using bls::Fp;
using bls::Fp2;
using bls::G1;
using bls::G2;

constexpr int PW = 3 * bls::NW;  // 32-bit words of a G1 point in scratch

__device__ __forceinline__ void load_point(G1& p, const int64_t* x, const int64_t* y,
                                           const int64_t* z, int64_t i) {
  bls::load(p.x, x + i * bls::NLIMBS);
  bls::load(p.y, y + i * bls::NLIMBS);
  bls::load(p.z, z + i * bls::NLIMBS);
}

__device__ __forceinline__ void get(G1& p, const uint32_t* words) {
#pragma unroll
  for (int k = 0; k < bls::NW; ++k) {
    p.x.w[k] = words[k];
    p.y.w[k] = words[bls::NW + k];
    p.z.w[k] = words[2 * bls::NW + k];
  }
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

__global__ void __launch_bounds__(256) fp_mont_mul_kernel(const int64_t* __restrict__ a,
                                                          const int64_t* __restrict__ b,
                                                          int64_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp x, y, r;
  bls::load(x, a + i * bls::NLIMBS);
  bls::load(y, b + i * bls::NLIMBS);
  bls::mul(r, x, y);
  bls::store(out + i * bls::NLIMBS, r);
}

__global__ void __launch_bounds__(128) g1_windowed_kernel(
    const int64_t* __restrict__ x, const int64_t* __restrict__ y, const int64_t* __restrict__ z,
    const int32_t* __restrict__ digits, uint32_t* __restrict__ partial, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  G1 p, acc;
  load_point(p, x, y, z, i);
  bls::windowed_mul(acc, p, digits + i * bls::NUM_WINDOWS);
  put(partial + i * PW, acc);
}

// one block: levels of pts[i] += pts[i + half], the odd last point moved to
// pts[half], as g1.py:_tree_reduce pairs them
__global__ void __launch_bounds__(128) g1_tree_reduce_kernel(uint32_t* __restrict__ pts,
                                                             int64_t n, int64_t* __restrict__ out) {
  for (int64_t len = n; len > 1;) {
    const int64_t half = len / 2;
    for (int64_t i = threadIdx.x; i < half; i += blockDim.x) {
      G1 a, b;
      get(a, pts + i * PW);
      get(b, pts + (i + half) * PW);
      bls::add(a, a, b);
      put(pts + i * PW, a);
    }
    __syncthreads();
    if (len & 1) {
      for (int k = threadIdx.x; k < PW; k += blockDim.x) pts[half * PW + k] = pts[2 * half * PW + k];
      __syncthreads();
    }
    len = half + (len & 1);
  }
  if (threadIdx.x == 0) {
    G1 r;
    if (n > 0) {
      get(r, pts);
    } else {
      bls::set_identity(r);
    }
    store_point(out, r);
  }
}

// thread t = window * nb + (bucket - 1): the sum of the points whose digit
// in that window is the bucket
__global__ void __launch_bounds__(128) g1_bucket_kernel(
    const int64_t* __restrict__ x, const int64_t* __restrict__ y, const int64_t* __restrict__ z,
    const int32_t* __restrict__ digits, int64_t m, int nwin, int nb,
    uint32_t* __restrict__ buckets) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(nwin) * nb) return;
  const int w = static_cast<int>(t / nb);
  const int b = static_cast<int>(t % nb) + 1;
  G1 s, p;
  bls::set_identity(s);
  for (int64_t i = 0; i < m; ++i) {
    if (digits[i * nwin + w] != b) continue;
    load_point(p, x, y, z, i);
    bls::add(s, s, p);
  }
  put(buckets + t * PW, s);
}

// thread w: sum_b b * S_b = sum over b from the top of the running sum
__global__ void __launch_bounds__(32) g1_window_sum_kernel(const uint32_t* __restrict__ buckets,
                                                           int nwin, int nb,
                                                           uint32_t* __restrict__ windows) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nwin) return;
  G1 running, acc, s;
  bls::set_identity(running);
  bls::set_identity(acc);
  for (int b = nb - 1; b >= 0; --b) {
    get(s, buckets + (static_cast<int64_t>(w) * nb + b) * PW);
    bls::add(running, running, s);
    bls::add(acc, acc, running);
  }
  put(windows + w * PW, acc);
}

// one thread: the windows, most significant first, joined by window_bits
// doublings each
__global__ void g1_horner_kernel(const uint32_t* __restrict__ windows, int nwin, int window_bits,
                                 int64_t* __restrict__ out) {
  G1 acc, s;
  get(acc, windows);
  for (int w = 1; w < nwin; ++w) {
    for (int k = 0; k < window_bits; ++k) bls::dbl(acc, acc);
    get(s, windows + w * PW);
    bls::add(acc, acc, s);
  }
  store_point(out, acc);
}

__global__ void __launch_bounds__(64) g2_scalar_mul_kernel(
    const int64_t* __restrict__ x, const int64_t* __restrict__ y, const int64_t* __restrict__ z,
    const int32_t* __restrict__ bits, int64_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr int E = 2 * bls::NLIMBS;  // int64 limbs of an Fp^2 element
  G2 p, acc;
  bls::load(p.x, x + i * E);
  bls::load(p.y, y + i * E);
  bls::load(p.z, z + i * E);
  bls::double_and_add(acc, p, bits + i * bls::SCALAR_BITS);
  bls::store(out + i * E, acc.x);
  bls::store(out + (n + i) * E, acc.y);
  bls::store(out + (2 * n + i) * E, acc.z);
}

unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// out[i] = a[i] * b[i] * 2^-384 mod p for n elements of 32 int64 limbs
extern "C" int fp_mont_mul(const void* a, const void* b, void* out, long long n, void* stream) {
  fp_mont_mul_kernel<<<blocks_for(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b),
      static_cast<int64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// out (3 x 32 int64 limbs, Jacobian) = sum_i digits_i * P_i for n points
// (x, y, z: n x 32 int64 limbs each; digits: n x 64 int32, MSB first);
// partial: n x 36 words of scratch.  Two launches.
extern "C" int g1_msm_windowed(const void* x, const void* y, const void* z, const void* digits,
                               void* out, void* partial, long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pts = static_cast<uint32_t*>(partial);
  if (n > 0) {
    g1_windowed_kernel<<<blocks_for(n, 128), 128, 0, s>>>(
        static_cast<const int64_t*>(x), static_cast<const int64_t*>(y),
        static_cast<const int64_t*>(z), static_cast<const int32_t*>(digits), pts, n);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  g1_tree_reduce_kernel<<<1, 128, 0, s>>>(pts, n, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out (3 x 32 int64 limbs, Jacobian) = sum_i sum_w digit_{i,w} 2^(w_bits *
// (nwin - 1 - w)) P_i for m points and nwin windows of window_bits bits
// (digits: m x nwin int32, MSB first); buckets: nwin x (2^w - 1) x 36 words
// and windows: nwin x 36 words of scratch.  Three launches.
extern "C" int g1_msm_bucket(const void* x, const void* y, const void* z, const void* digits,
                             int window_bits, long long m, int nwin, void* out, void* buckets,
                             void* windows, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int nb = (1 << window_bits) - 1;
  auto bk = static_cast<uint32_t*>(buckets);
  auto win = static_cast<uint32_t*>(windows);
  g1_bucket_kernel<<<blocks_for(static_cast<int64_t>(nwin) * nb, 128), 128, 0, s>>>(
      static_cast<const int64_t*>(x), static_cast<const int64_t*>(y),
      static_cast<const int64_t*>(z), static_cast<const int32_t*>(digits), m, nwin, nb, bk);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  g1_window_sum_kernel<<<blocks_for(nwin, 32), 32, 0, s>>>(bk, nwin, nb, win);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  g1_horner_kernel<<<1, 1, 0, s>>>(win, nwin, window_bits, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out (3 x n x 2 x 32 int64 limbs, Jacobian over Fp^2) = bits_i * P_i for n
// G2 points (x, y, z: n x 2 x 32 int64 limbs each; bits: n x 256 int32,
// little-endian)
extern "C" int g2_scalar_mul(const void* x, const void* y, const void* z, const void* bits,
                             void* out, long long n, void* stream) {
  g2_scalar_mul_kernel<<<blocks_for(n, 64), 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<const int64_t*>(y),
      static_cast<const int64_t*>(z), static_cast<const int32_t*>(bits),
      static_cast<int64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
