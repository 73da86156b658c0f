// bundle_sim: batched query x bundle cosine similarity for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/bundle_sim/bundle_sim.py:bundle_sim_pallas (body _kernel)
// and computes the same function:
//   A[b, j] = <h_b, M_j> * rsqrt(||h_b||^2 + 1e-12)
// for queries h (B, D) in float32 or bfloat16 and pre-normalised bundles
// M (n, D) in float32, with float32 accumulation.  Output (B, n) float32.
//
// What bounds it on the H100: device-memory bytes.  At the predict shape
// (B = 1559, D = 10000, n = 10) the kernel must read 62 MB of h and only
// 400 KB of M, which the 50 MB L2 holds; it does 2*B*D*(n+1) flops, about
// 0.34 GFLOP, far below what the card could do in the time the bytes take.
// What a simple design pays instead is re-reading M: every query row needs
// all n*D bundle values, ten times the bytes of its own row at n = 10.  Read
// from L1/L2 once per row, M costs 1559 x 400 KB = 0.6 GB of cache traffic.
//
// Design: one warp per query row, eight rows per block, all sharing one copy
// of M.  The block walks D in tiles of kTile columns.  Its 256 threads copy
// the tile's kC x kTile slice of M into shared memory with coalesced loads;
// each warp then streams its row's kTile values of h (lanes on neighbouring
// columns) and keeps up to 32 dot products plus ||h||^2 in registers, reading
// M from shared memory without bank conflicts.  The next tile's M slice and
// h values are loaded into registers while the current tile is computed, so
// their latency overlaps the arithmetic.  Shuffles reduce the partial sums
// across the warp and lane j writes column j.  For n > 32 the grid's second
// dimension walks chunks of 32 bundles, each recomputing ||h||^2, so n is
// not capped.  Loads are 4 (or 2) bytes a lane, so any D and any alignment
// work.  The TPU kernel's sequential D grid with VMEM accumulators has no
// counterpart: the D loop runs inside the block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;     // query rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 256;    // D columns per shared-memory tile
constexpr int kPerLane = kTile / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// kC bundles per grid-y slice: 8, 16 or 32, the smallest that holds n.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
    bundle_sim_kernel(const T* __restrict__ h, const float* __restrict__ m,
                      float* __restrict__ out, int B, int D, int n) {
  constexpr int kStage = kC * kTile / kThreads;  // M values a thread copies
  __shared__ float ms[kC][kTile];

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int j0 = blockIdx.y * kC;
  const int nc = min(kC, n - j0);
  // rows past B still help stage M and meet every barrier; they write nothing
  const T* hr = h + (size_t)min(row, B - 1) * D;
  const float* mr = m + (size_t)j0 * D;

  float mreg[kStage], hreg[kPerLane];
  auto load_tile = [&](int t0) {
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int j = i / kTile, col = t0 + i % kTile;
      mreg[k] = (j < nc && col < D) ? __ldg(mr + (size_t)j * D + col) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kPerLane; ++s) {
      const int col = t0 + s * 32 + lane;
      hreg[s] = col < D ? to_f32(hr[col]) : 0.f;
    }
  };

  float acc[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) acc[j] = 0.f;
  float nrm = 0.f;

  load_tile(0);
  for (int t0 = 0; t0 < D; t0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = threadIdx.x + k * kThreads;
      ms[i / kTile][i % kTile] = mreg[k];
    }
    float x[kPerLane];
#pragma unroll
    for (int s = 0; s < kPerLane; ++s) x[s] = hreg[s];
    __syncthreads();
    if (t0 + kTile < D) load_tile(t0 + kTile);  // in flight during the math
#pragma unroll
    for (int s = 0; s < kPerLane; ++s) {
      nrm = fmaf(x[s], x[s], nrm);
#pragma unroll
      for (int j = 0; j < kC; ++j)
        if (j < nc) acc[j] = fmaf(x[s], ms[j][s * 32 + lane], acc[j]);
    }
  }

  nrm = warp_sum(nrm);
  float mine = 0.f;
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    if (j < nc) {
      const float s = warp_sum(acc[j]);
      if (lane == j) mine = s;
    }
  }
  if (row < B && lane < nc)
    out[(size_t)row * n + j0 + lane] = mine * rsqrtf(nrm + 1e-12f);
}

template <typename T, int kC>
void launch_chunk(const void* h, const void* m, void* out, int B, int D,
                  int n, cudaStream_t s) {
  const dim3 grid((B + kWarps - 1) / kWarps, (n + kC - 1) / kC);
  bundle_sim_kernel<T, kC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(h), static_cast<const float*>(m),
      static_cast<float*>(out), B, D, n);
}

template <typename T>
void launch(const void* h, const void* m, void* out, int B, int D, int n,
            cudaStream_t s) {
  if (n <= 8)
    launch_chunk<T, 8>(h, m, out, B, D, n, s);
  else if (n <= 16)
    launch_chunk<T, 16>(h, m, out, B, D, n, s);
  else
    launch_chunk<T, 32>(h, m, out, B, D, n, s);
}

}  // namespace

// h: (B, D) float32 (h_bf16 = 0) or bfloat16 (h_bf16 = 1), row-major;
// m: (n, D) float32; out: (B, n) float32.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int bundle_sim_launch(const void* h, const void* m, void* out,
                                 int B, int D, int n, int h_bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_bf16)
    launch<__nv_bfloat16>(h, m, out, B, D, n, s);
  else
    launch<float>(h, m, out, B, D, n, s);
  return static_cast<int>(cudaGetLastError());
}
