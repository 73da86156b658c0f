// bundle_update: one training minibatch update of bundles or prototypes for
// sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/bundle_update/bundle_update.py:bundle_update_pallas
//   (body _kernel)
// together with the normalisation epilogue of its wrapper (ops.py), and
// computes the same function:
//   U = M + (lr * C)^T H,        out_j = U_j / (||U_j|| + 1e-12)
// for bundles M (n, D), coefficients C (B, n) and queries H (B, D), all
// float32.  lr is folded into C while C is staged, as the TPU wrapper folds
// it before the contraction.  This is the step of both training updates:
// Eq. 9 refinement (C = t - A) and OnlineHD (C = pull/push one-hots).
//
// What bounds it on the H100: bytes.  It must read M and H once and write
// U once: (2nD + BD + Bn) * 4 bytes, 3.4 MB at the LogHD refine shape
// (n, B, D) = (10, 64, 10000), about 1 us at 3.35 TB/s, against 2nBD =
// 13 MFLOP, 0.2 us at the float32 rate.  At these sizes a call costs its
// launch latency more than either.
//
// Design: the first kernel gives each thread one column d of one chunk of
// up to 32 bundle rows (a second grid dimension walks the chunks, so n is
// not capped).  The block stages up to 128 batch rows of lr * C in shared
// memory at a time; every thread then walks the batch in order b = 0..B-1,
// reads H[b, d] (neighbouring threads on neighbouring columns, coalesced)
// and adds C[b, j] * H[b, d] into the register accumulator of each row j,
// which starts at M[j, d].  It writes its U column, and the block reduces
// U^2 over its 128 columns per row (warp shuffles, then the four warps in
// order) into one partial sum per (row, block).  The second kernel sums a
// row's partials in a fixed order and divides the row by sqrt(ss) + 1e-12.
// The TPU kernel carried ss in VMEM scratch across its sequential D grid;
// CUDA blocks have no order, so the partials take its place.  No atomics:
// every sum has one fixed order, so a fit repeats bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // D columns per block, one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kBChunk = 128;    // batch rows of C staged per pass

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// kC bundle rows per grid-y chunk: 8, 16 or 32, the smallest that holds n.
template <int kC>
__global__ void __launch_bounds__(kThreads)
    update_kernel(const float* __restrict__ m, const float* __restrict__ c,
                  const float* __restrict__ h, float lr, float* __restrict__ u,
                  float* __restrict__ partial, int B, int D, int n) {
  __shared__ float cs[kBChunk][kC];
  __shared__ float red[kWarps][kC];

  const int col = blockIdx.x * kThreads + threadIdx.x;
  const int j0 = blockIdx.y * kC;
  const int nc = min(kC, n - j0);
  const bool live = col < D;

  float acc[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j)
    acc[j] = (live && j < nc) ? m[(size_t)(j0 + j) * D + col] : 0.f;

  for (int b0 = 0; b0 < B; b0 += kBChunk) {
    const int bc = min(kBChunk, B - b0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < kBChunk * kC; i += kThreads) {
      const int b = i / kC, j = i % kC;
      cs[b][j] = (b < bc && j < nc) ? c[(size_t)(b0 + b) * n + j0 + j] * lr
                                    : 0.f;
    }
    __syncthreads();
    if (live) {
      const float* hp = h + (size_t)b0 * D + col;
#pragma unroll 4
      for (int b = 0; b < bc; ++b) {
        const float x = hp[(size_t)b * D];
#pragma unroll
        for (int j = 0; j < kC; ++j) acc[j] = fmaf(cs[b][j], x, acc[j]);
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    if (j < nc) {
      if (live) u[(size_t)(j0 + j) * D + col] = acc[j];
      const float s = warp_sum(live ? acc[j] * acc[j] : 0.f);
      if (lane == 0) red[warp][j] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < nc) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    partial[(size_t)(j0 + threadIdx.x) * gridDim.x + blockIdx.x] = s;
  }
}

// grid (D blocks, n): every block of a row sums the row's partials in the
// same order, so all of them divide by the same denominator.
__global__ void __launch_bounds__(kThreads)
    normalize_kernel(float* __restrict__ u,
                     const float* __restrict__ partial, int D, int parts) {
  __shared__ float red[kWarps];
  const int row = blockIdx.y;
  const float* pr = partial + (size_t)row * parts;
  float s = 0.f;
  for (int t = threadIdx.x; t < parts; t += kThreads) s += pr[t];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float ss = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) ss += red[w];
  const float denom = sqrtf(ss) + 1e-12f;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col < D) u[(size_t)row * D + col] /= denom;
}

template <int kC>
void launch_update(const float* m, const float* c, const float* h, float lr,
                   float* u, float* partial, int B, int D, int n,
                   cudaStream_t s) {
  const dim3 grid((D + kThreads - 1) / kThreads, (n + kC - 1) / kC);
  update_kernel<kC><<<grid, kThreads, 0, s>>>(m, c, h, lr, u, partial, B, D,
                                              n);
}

}  // namespace

// Columns of the partial-sum scratch the wrapper allocates: (n, parts).
extern "C" int bundle_update_parts(int D) {
  return (D + kThreads - 1) / kThreads;
}

// m: (n, D), c: (B, n), h: (B, D), all float32 row-major; out: (n, D);
// partial: (n, bundle_update_parts(D)) float32 scratch.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int bundle_update_launch(const void* m, const void* c,
                                    const void* h, float lr, void* out,
                                    void* partial, int B, int D, int n,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mp = static_cast<const float*>(m);
  const float* cp = static_cast<const float*>(c);
  const float* hp = static_cast<const float*>(h);
  float* up = static_cast<float*>(out);
  float* pp = static_cast<float*>(partial);
  if (n <= 8)
    launch_update<8>(mp, cp, hp, lr, up, pp, B, D, n, s);
  else if (n <= 16)
    launch_update<16>(mp, cp, hp, lr, up, pp, B, D, n, s);
  else
    launch_update<32>(mp, cp, hp, lr, up, pp, B, D, n, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int parts = bundle_update_parts(D);
  normalize_kernel<<<dim3(parts, n), kThreads, 0, s>>>(up, pp, D, parts);
  return static_cast<int>(cudaGetLastError());
}
