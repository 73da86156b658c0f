// hdc_encode: the fused HDC random-projection encoder for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/hdc_encode/hdc_encode.py:hdc_encode_pallas
//   (body _kernel)
// together with the two row normalisations of its wrapper (ops.py), and
// computes the same function:
//   z   = x W                                 x (B, F), W (F, D) float32
//   h   = cos(z + b) * sin(z) | z | sign(z)   kind "cos" | "rp" | "rp_sign"
//   out = l2n(l2n(h) - center)                l2n(v) = v / (||v|| + 1e-12)
// for bias and center (D,), all float32.  This is every encode of the port:
// fit, predict and each raw-feature service cycle.
//
// What bounds it on the H100: operations once a batch has more than a few
// rows.  At a 64-row service bucket of isolet (F = 617, D = 10,000) it does
// 2 B F D = 0.79 GFLOP, 11.8 us at the 67 TFLOP/s float32 rate, against
// 27 MB of x, W and the output, 8.2 us at 3.35 TB/s; at B = 1 it is a GEMV
// whose time is the read of W (24.7 MB, which the 50 MB L2 can hold).
//
// Design: the first kernel is a tiled SIMT GEMM in full float32, with no
// tensor cores and no TF32.  A block of 128 threads owns a 32 x 64 tile of
// the output; it walks F in steps of 32, staging a 32 x 32 tile of x
// (transposed) and a 32 x 64 tile of W in shared memory, while the next
// step's tiles are already loading into registers.  Each thread keeps a
// 4 x 4 register tile of sums and adds x[b, f] * W[f, d] with fmaf in the
// order f = 0, 1, ..., F-1, so an element's value depends on neither B nor
// the row's position: no split-K, and the tile does not change with B.  The
// epilogue applies the nonlinearity with the accurate cosf / sinf (z + b
// reaches past 2 pi; no fast math) and writes h.  Ragged B, F and D are
// masked by zero-filled tiles; nothing is padded outside the kernel.
//
// The second kernel normalises each row in place, one block per row: it
// sums h^2 in a fixed order (each thread strides the row in order, then
// warp shuffles, then its eight warps in order), forms u = h / (||h|| +
// 1e-12) - center, sums u^2 the same way and writes u / (||u|| + 1e-12).
// The TPU kernel left these reductions to XLA in its wrapper; torch's own
// row norm on CUDA picks its reduction strategy by shape, so a row encoded
// in a batch of 1 and of 1,559 could differ in its last bits.  Here every
// row is reduced by the same code whatever B is, with no atomics.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 32;        // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 32;        // features per step
constexpr int kTM = 4;         // rows per thread
constexpr int kTN = 4;         // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 128
constexpr int kXLoads = kBM * kBK / kThreads;         // 8
constexpr int kWLoads = kBK * kBN / kThreads;         // 16

constexpr int kNormThreads = 256;
constexpr int kNormWarps = kNormThreads / 32;

__device__ __forceinline__ float nonlin(float z, float b, int kind) {
  if (kind == 0) return cosf(z + b) * sinf(z);
  if (kind == 1) return z;
  return z > 0.f ? 1.f : (z < 0.f ? -1.f : z);
}

__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out,
                int B, int F, int D, int kind) {
  __shared__ __align__(16) float xs[kBK][kBM + 4];
  __shared__ __align__(16) float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float xr[kXLoads], wr[kWLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = m0 + idx / kBK, c = k0 + idx % kBK;
      xr[i] = (r < B && c < F) ? x[(size_t)r * F + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = k0 + idx / kBN, c = n0 + idx % kBN;
      wr[i] = (r < F && c < D) ? w[(size_t)r * D + c] : 0.f;
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < F; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int idx = tid + i * kThreads;
      xs[idx % kBK][idx / kBK] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = tid + i * kThreads;
      ws[idx / kBN][idx % kBN] = wr[i];
    }
    __syncthreads();
    if (k0 + kBK < F) load(k0 + kBK);   // in flight during this step
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * kTM]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * kTN]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int col = n0 + tx * kTN + j;
    if (col >= D) continue;
    const float b = bias[col];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = m0 + ty * kTM + i;
      if (row < B) out[(size_t)row * D + col] = nonlin(acc[i][j], b, kind);
    }
  }
}

// The block-wide sum of one value per thread, in a fixed order; every
// thread gets the result.
__device__ __forceinline__ float block_sum(float s, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __syncthreads();  // red is free: every thread read the previous sum
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kNormWarps; ++i) total += red[i];
  return total;
}

__global__ void __launch_bounds__(kNormThreads)
    normalize_kernel(float* __restrict__ out, const float* __restrict__ center,
                     int D) {
  __shared__ float red[kNormWarps];
  float* row = out + (size_t)blockIdx.x * D;

  float s = 0.f;
  for (int d = threadIdx.x; d < D; d += kNormThreads) s = fmaf(row[d], row[d], s);
  const float n1 = sqrtf(block_sum(s, red)) + 1e-12f;

  s = 0.f;
  for (int d = threadIdx.x; d < D; d += kNormThreads) {
    const float u = row[d] / n1 - center[d];
    s = fmaf(u, u, s);
  }
  const float n2 = sqrtf(block_sum(s, red)) + 1e-12f;

  for (int d = threadIdx.x; d < D; d += kNormThreads)
    row[d] = (row[d] / n1 - center[d]) / n2;
}

}  // namespace

// x: (B, F), w: (F, D), bias and center: (D,), all float32 row-major;
// out: (B, D) float32.  kind: 0 cos, 1 rp, 2 rp_sign.  Returns the
// cudaError_t of the two launches (0 on success).
extern "C" int hdc_encode_launch(const void* x, const void* w,
                                 const void* bias, const void* center,
                                 void* out, int B, int F, int D, int kind,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(out);
  const dim3 grid((D + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  gemm_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), op, B, F, D, kind);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  normalize_kernel<<<B, kNormThreads, 0, s>>>(
      op, static_cast<const float*>(center), D);
  return static_cast<int>(cudaGetLastError());
}
