// flip_corrupt: fused bit-flip corruption + dequantisation for sm_90a,
// batched over (grid point x stored int leaf).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flip_corrupt/flip_corrupt.py:flip_corrupt_pallas
//   (body _kernel, counter-hash mode)
// as the reference's sweep runs it: vmapped over the (p, trial) points of a
// p-chunk (src/repro/core/evaluate.py:_sweep_fn), one batched call a chunk.
// It is bit-exact with the oracle repro.kernels.flip_corrupt.ref at every
// point.  Per b-bit code at flat index i (= row * C + col of the (-1, C)
// view) of a leaf, at a point with the leaf's int32 seed and threshold thr:
//   for each bit plane t < b: r = mix32(mix32(i*0x9E3779B9 + seed*0x85EBCA6B
//                                             + t*0xC2B2AE35))
//                             flip bit t where (r >> 8) < thr
//   x = (code & (2^b - 1)) ^ mask; sign-extend from bit b-1 (b = 1: 2x - 1)
//   out = float(x) * scale
// with thr = floor(float32(p) * 2^24) computed on the host exactly as the
// reference's flip_threshold does.  All hash arithmetic is uint32 and wraps
// mod 2^32, as it does in the reference.  The TPU's hardware PRNG mode
// (pltpu.prng_seed) has no counterpart here: the port always uses the hash.
// The single-leaf flip_corrupt is the one-point, one-leaf call of this
// kernel.
//
// What bounds it on the H100: each code is read once and written as four
// bytes at each of G points, and a code at a point takes 24 * b + 8 integer
// operations (two mix32 chains per bit plane; 8 at p = 0 or 1, where the
// mask needs no hash).  A sweep's chunk of the isolet LogHD model (6 p x 3
// trials = 18 points of 100,260 codes) writes 7.2 MB (2.2 us at 3.35 TB/s)
// and at 4 bits takes 159 M int32 operations (4.7 us at 33.5 Tops/s): the
// operations bound it at 4 bits, the bytes at 1 bit.  One point alone is
// under a microsecond of either, so there the launch bounds it.
//
// Design:
// - One launch covers up to kMaxLeaves leaves at up to kMaxPoints points,
//   passed by value in a __grid_constant__ parameter struct (2.8 KB of the
//   4 KB Hopper takes), so a chunk needs no host-to-device copy.  Leaf l at
//   point g is written to the contiguous row out_l[g] of a (G, N_l) output.
// - A block of 128 threads owns a tile of one (leaf, point): blocks map to
//   (leaf, point, tile) in that order through each leaf's first block.  A
//   tile is one group of 4 codes a thread (512 codes) while the grid fits
//   in one wave of the card (the blocks it holds at once, which the
//   wrapper reads once a device through flip_corrupt_wave: a lone point,
//   196 blocks at (10, 10,000)), else two groups (1,024 codes), which halves each
//   thread's fixed cost of mapping its block and keeps two loads in
//   flight: 1,782 blocks at the chunk above.  (On an NVIDIA H100 80GB HBM3
//   at 700 W, two groups took the chunks from 4.83 to 4.2 us at 1 bit and
//   from 10.2 to 8.3 us on conventional's (26, 10,000), and cost the lone
//   point 0.2 us; 64 or 256 threads a block, four groups or one code a
//   thread were no faster.)
// - bits is a template parameter (1..8), chosen per block by a switch on the
//   leaf's bits, so the plane loop unrolls.  A thread owns 4 consecutive
//   codes: one 4-byte load, issued before the hashing (the masks do not
//   depend on the codes), and one 16-byte store; its 4 x b hash chains are
//   independent and interleave.  The per-code base i*0x9E3779B9 +
//   seed*0x85EBCA6B is formed once and each plane adds its constant.
// - A leaf whose codes are not 4-byte aligned or whose output row is not
//   16-byte aligned (N % 4 != 0 at a point g > 0), and the last N % 4 codes
//   of a tile, take a scalar path with bounds checks.
// - thr == 0 (every sweep's p = 0 row) gives a zero mask without hashing;
//   thr == 2^24 (p = 1) a full mask.  Both are the bits the hash would give:
//   (r >> 8) < 2^24 always holds.
// - The scale is read from device memory, so the host never waits on the
//   device for it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 4;
constexpr int kMaxLeaves = 4;
constexpr int kMaxPoints = 128;

struct Leaf {
  const int8_t* codes;
  float* out;               // (G, n) float32
  const float* scale;       // one float32
  long long n;
  long long tiles;          // ceil(n / codes a tile)
  long long first_block;    // this leaf's blocks: [first_block, + G * tiles)
  int bits;
};

struct Params {
  Leaf leaf[kMaxLeaves];
  int n_leaves;
  uint32_t thr[kMaxPoints];
  uint32_t seed[kMaxPoints][kMaxLeaves];
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The flip mask of the code whose hash base is `base` (its index and seed
// terms): bit t set where plane t's word falls below thr.
template <int BITS>
__device__ __forceinline__ int flip_mask(uint32_t base, uint32_t thr) {
  if (thr == 0u) return 0;
  if (thr >= (1u << 24)) return (1 << BITS) - 1;
  int mask = 0;
#pragma unroll
  for (int t = 0; t < BITS; ++t) {
    const uint32_t r = mix32(mix32(base + static_cast<uint32_t>(t) *
                                              0xC2B2AE35u));
    mask |= static_cast<int>((r >> 8) < thr) << t;
  }
  return mask;
}

// Flip, sign-extend from bit BITS-1 and dequantize one code.
template <int BITS>
__device__ __forceinline__ float decode(int code, int mask, float s) {
  const int x = (code & ((1 << BITS) - 1)) ^ mask;
  if (BITS == 1) return static_cast<float>(2 * x - 1) * s;
  constexpr int kHalf = 1 << (BITS - 1);
  return static_cast<float>((x ^ kHalf) - kHalf) * s;
}

// This thread's 4 codes from flat index i0 of a leaf of n codes; out is the
// point's output row.
template <int BITS>
__device__ __forceinline__ void corrupt4(const int8_t* __restrict__ codes,
                                         float* __restrict__ out,
                                         long long n, long long i0,
                                         uint32_t key, uint32_t thr, float s,
                                         bool vec) {
  const uint32_t base = static_cast<uint32_t>(i0) * 0x9E3779B9u + key;
  if (vec && i0 + kVec <= n) {
    const char4 c = *reinterpret_cast<const char4*>(codes + i0);
    const int m0 = flip_mask<BITS>(base, thr);
    const int m1 = flip_mask<BITS>(base + 0x9E3779B9u, thr);
    const int m2 = flip_mask<BITS>(base + 2u * 0x9E3779B9u, thr);
    const int m3 = flip_mask<BITS>(base + 3u * 0x9E3779B9u, thr);
    float4 v;
    v.x = decode<BITS>(c.x, m0, s);
    v.y = decode<BITS>(c.y, m1, s);
    v.z = decode<BITS>(c.z, m2, s);
    v.w = decode<BITS>(c.w, m3, s);
    *reinterpret_cast<float4*>(out + i0) = v;
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const long long i = i0 + e;
    if (i < n)
      out[i] = decode<BITS>(codes[i],
                            flip_mask<BITS>(base + e * 0x9E3779B9u, thr), s);
  }
}

// A tile is GROUPS x kThreads x kVec codes; a thread takes kVec codes in
// each of its GROUPS groups, the groups kThreads * kVec codes apart.
template <int GROUPS>
__global__ void __launch_bounds__(kThreads)
    flip_corrupt_kernel(const __grid_constant__ Params prm) {
  const long long b = blockIdx.x;
  int l = 0;
#pragma unroll
  for (int k = 1; k < kMaxLeaves; ++k)
    if (k < prm.n_leaves && b >= prm.leaf[k].first_block) l = k;
  const Leaf& leaf = prm.leaf[l];
  // the grid holds under 2^31 blocks, so 32-bit division does
  const uint32_t r = static_cast<uint32_t>(b - leaf.first_block);
  const uint32_t tiles = static_cast<uint32_t>(leaf.tiles);
  const int g = static_cast<int>(r / tiles);
  const long long tile = r - static_cast<uint32_t>(g) * tiles;
  const long long i0 = tile * (GROUPS * kThreads * kVec) + threadIdx.x * kVec;
  float* out = leaf.out + g * leaf.n;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(leaf.codes) & 3) == 0) &&
      ((reinterpret_cast<uintptr_t>(out) & 15) == 0);
  const uint32_t key = prm.seed[g][l] * 0x85EBCA6Bu;
  const uint32_t thr = prm.thr[g];
  const float s = *leaf.scale;
  switch (leaf.bits) {
#define FC_BITS(B)                                                     \
  case B:                                                              \
    _Pragma("unroll") for (int j = 0; j < GROUPS; ++j)                 \
        corrupt4<B>(leaf.codes, out, leaf.n, i0 + j * kThreads * kVec, \
                    key, thr, s, vec);                                 \
    break;
    FC_BITS(1) FC_BITS(2) FC_BITS(3) FC_BITS(4)
    FC_BITS(5) FC_BITS(6) FC_BITS(7) FC_BITS(8)
#undef FC_BITS
    default:
      break;
  }
}

// Each leaf's tiles of `tile` codes and first block, at G points; returns
// the blocks of the launch.
long long plan_tiles(Params& prm, int G, long long tile) {
  long long blocks = 0;
  for (int l = 0; l < prm.n_leaves; ++l) {
    Leaf& leaf = prm.leaf[l];
    leaf.tiles = (leaf.n + tile - 1) / tile;
    leaf.first_block = blocks;
    blocks += G * leaf.tiles;
  }
  return blocks;
}

}  // namespace

// n_leaves (1..kMaxLeaves) leaves, each 5 int64 in `leaves`: codes (int8,
// n_l codes with `bits` (1..8) significant bits), out (G x n_l float32,
// row g the leaf at point g), scale (one float32 on the device), n_l, bits.
// G (1..kMaxPoints) points: thr[g] = floor(float32(p_g) * 2^24) and
// seeds[g * n_leaves + l], leaf l's int32 seed at point g reinterpreted as
// uint32.  wave: flip_corrupt_wave() of the device; a launch of more
// one-group tiles than that takes two groups a thread.  Launches one kernel on `stream` (none when every leaf is empty)
// and returns its cudaError_t (0 on success); cudaErrorInvalidValue, with
// nothing launched, for counts or bits out of range.
extern "C" int flip_corrupt_launch(int n_leaves, const long long* leaves,
                                   int G, const unsigned int* thr,
                                   const unsigned int* seeds, long long wave,
                                   void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || G < 1 || G > kMaxPoints)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm = {};
  prm.n_leaves = n_leaves;
  for (int l = 0; l < n_leaves; ++l) {
    const long long* d = leaves + 5 * l;
    Leaf& leaf = prm.leaf[l];
    leaf.codes = reinterpret_cast<const int8_t*>(d[0]);
    leaf.out = reinterpret_cast<float*>(d[1]);
    leaf.scale = reinterpret_cast<const float*>(d[2]);
    leaf.n = d[3];
    leaf.bits = static_cast<int>(d[4]);
    if (leaf.n < 0 || leaf.bits < 1 || leaf.bits > 8)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int g = 0; g < G; ++g) {
    prm.thr[g] = thr[g];
    for (int l = 0; l < n_leaves; ++l)
      prm.seed[g][l] = seeds[g * n_leaves + l];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks = plan_tiles(prm, G, kThreads * kVec);
  if (blocks == 0) return 0;
  if (blocks > wave) {
    blocks = plan_tiles(prm, G, 2 * kThreads * kVec);
    if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    flip_corrupt_kernel<2><<<static_cast<unsigned int>(blocks), kThreads, 0,
                             st>>>(prm);
  } else {
    flip_corrupt_kernel<1><<<static_cast<unsigned int>(blocks), kThreads, 0,
                             st>>>(prm);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the one-group kernel that the current device holds at once
// (resident blocks per SM times the SMs); a negative cudaError_t on error.
extern "C" int flip_corrupt_wave() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flip_corrupt_kernel<1>, kThreads, 0);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}
