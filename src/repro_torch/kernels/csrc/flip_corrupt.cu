// flip_corrupt: fused bit-flip corruption + dequantisation for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flip_corrupt/flip_corrupt.py:flip_corrupt_pallas
//   (body _kernel, counter-hash mode)
// and is bit-exact with its oracle repro.kernels.flip_corrupt.ref.
// Per b-bit code at flat index i (= row * C + col of the (-1, C) view):
//   for each bit plane t < b: r = mix32(mix32(i*0x9E3779B9 + seed*0x85EBCA6B
//                                             + t*0xC2B2AE35))
//                             flip bit t where (r >> 8) < thr
//   x = (code & (2^b - 1)) ^ mask; sign-extend from bit b-1 (b = 1: 2x - 1)
//   out = float(x) * scale
// with thr = floor(float32(p) * 2^24) computed on the host exactly as the
// reference's flip_threshold does.  All hash arithmetic is uint32 and wraps
// mod 2^32, as it does in the reference.  The TPU's hardware PRNG mode
// (pltpu.prng_seed) has no counterpart here: the port always uses the hash.
//
// What bounds it on the H100: one byte read and four written per code, and
// about 25 integer operations per code and bit plane.  At the sweep's
// shapes (10 x 10000 bundles, 26 x 10 profiles) that is under 1 MB, so the
// launch bounds it.
//
// Design: elementwise.  Each thread handles four codes, strided by the block
// width so that a warp's loads and stores are contiguous.  The scale is read
// from device memory, so the host never waits on the device for it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t idx, uint32_t seed,
                                             uint32_t plane) {
  uint32_t x = idx * 0x9E3779B9u;
  x += seed * 0x85EBCA6Bu;
  x += plane * 0xC2B2AE35u;
  return mix32(mix32(x));
}

__global__ void __launch_bounds__(kThreads)
    flip_corrupt_kernel(const int8_t* __restrict__ codes,
                        const float* __restrict__ scale,
                        float* __restrict__ out, long long N, int bits,
                        uint32_t seed, uint32_t thr) {
  const float s = *scale;
  const int low = (1 << bits) - 1;
  const long long base = (long long)blockIdx.x * (kThreads * kPerThread);
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const long long i = base + e * kThreads + threadIdx.x;
    if (i >= N) return;
    const uint32_t idx = static_cast<uint32_t>(i);  // the reference's wrap
    int mask = 0;
    for (int t = 0; t < bits; ++t) {
      const uint32_t r = hash_u32(idx, seed, static_cast<uint32_t>(t));
      mask |= static_cast<int>((r >> 8) < thr) << t;
    }
    int x = (static_cast<int>(codes[i]) & low) ^ mask;
    float val;
    if (bits == 1) {
      val = static_cast<float>(2 * x - 1);
    } else {
      if (x & (1 << (bits - 1))) x -= 1 << bits;
      val = static_cast<float>(x);
    }
    out[i] = val * s;
  }
}

}  // namespace

// codes: N int8 codes with `bits` (1..8) significant bits; scale: one
// float32 on the device; out: N float32.  seed is the reference's int32 seed
// reinterpreted as uint32; thr = floor(float32(p) * 2^24).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flip_corrupt_launch(const void* codes, const void* scale,
                                   void* out, long long N, int bits,
                                   unsigned int seed, unsigned int thr,
                                   void* stream) {
  const long long per_block = kThreads * kPerThread;
  const long long blocks = (N + per_block - 1) / per_block;
  flip_corrupt_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const float*>(scale),
      static_cast<float*>(out), N, bits, seed, thr);
  return static_cast<int>(cudaGetLastError());
}
