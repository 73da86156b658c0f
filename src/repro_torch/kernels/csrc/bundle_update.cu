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
// What bounds it on the H100: bytes, in principle.  It must read M and H
// once and write U once: (2nD + BD + Bn) * 4 bytes, 3.4 MB at the LogHD
// refine shape (n, B, D) = (10, 64, 10000), about 1 us at 3.35 TB/s,
// against 2nBD = 13 MFLOP, 0.2 us at the float32 rate.  At these sizes
// the time is a chain of memory round trips, not bandwidth: loading M, C
// and H, the partial sums, a grid-wide barrier, the row norms, the
// write.  The design keeps that chain to one launch and every load of a
// link in flight at once.
//
// Design: one cooperative launch.  The work is cut into tiles of 64
// columns x kJ bundle rows (kJ = n rounded up to a multiple of 4, at most
// 32), 157 tiles at D = 10,000; as many blocks start as there are tiles,
// or as many as the card holds at once (the grid barrier needs them all
// resident; the wrapper reads the occupancy through
// bundle_update_capacity), and a block walks tiles b, b + gridDim.x, ...
// In a tile, four groups of 64 threads split the batch: group p takes rows
// b = p, p + 4, ..., 16 loads of H in flight per thread while lr * C is
// staged in shared memory (all rows of a chunk of 256 copied at once by
// cp.async, then scaled by lr), the next 16 loading while this 16's FMAs
// run; each thread keeps kJ register accumulators.  The groups' sums meet
// in shared memory and are added in group order 0, 1, 2, 3 to M; each
// thread then holds kJ / 4 entries of U, and the block reduces U^2 over the
// tile's 64 columns per row (warp shuffles, then the row's two warps in
// order) into one partial sum per (row, column block).  Then the grid
// barrier (cooperative_groups::this_grid().sync()); after it every block
// sums each of its rows' partials in column-block order (one warp a row,
// eight loads a lane in flight, then a shuffle tree, so every block gets
// the same bits) and writes U / (sqrt(ss) + 1e-12).  A block's first tile
// keeps U in registers across the barrier, so U is written once; a later
// tile (only when the tiles outnumber the resident blocks, as at n = 100)
// waits in the output, unnormalised, and is read back.  No atomics: every
// sum has one fixed order, so a fit repeats bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 64;                  // D columns per block
constexpr int kParts = 4;                  // groups that split the batch
constexpr int kThreads = kCols * kParts;   // 256
constexpr int kWarps = kThreads / 32;
constexpr int kBChunk = 256;               // batch rows of lr * C staged
constexpr int kLoads = 16;                 // H loads a thread issues at once
constexpr int kDenomLoads = 8;             // partials a lane loads at once

// cp.async of 4 bytes; a false predicate reads nothing and writes zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Tiles of kCols columns x kJ bundle rows, tile = row chunk * col_blocks
// + column block; block b takes tiles b, b + gridDim.x, ...  partial:
// (n, col_blocks).
template <int kJ>
__global__ void __launch_bounds__(kThreads)
    update_kernel(const float* __restrict__ m, const float* __restrict__ c,
                  const float* __restrict__ h, float lr, float* __restrict__ u,
                  float* partial, int B, int D, int n, int col_blocks,
                  int tiles) {
  constexpr int kR = kJ / kParts;   // rows of U a thread holds
  union __align__(16) Shared {
    float cs[kBChunk][kJ];          // lr * C, while the batch is summed
    float sums[kParts][kJ][kCols];  // each group's sums, after
  };
  __shared__ Shared sh;
  __shared__ float red[kWarps][kR];
  __shared__ float denom[kJ];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int cl = tid % kCols, p = tid / kCols;
  float uv[kR];   // U of the block's first tile, kept across the barrier

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int cb = tile % col_blocks, j0 = tile / col_blocks * kJ;
    const int col = cb * kCols + cl;
    const bool live = col < D;
    const int nc = min(kJ, n - j0);

    // M for the rows this thread holds after the combine, loaded early
    float mv[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int j = p + kParts * i;
      mv[i] = (live && j < nc) ? m[(size_t)(j0 + j) * D + col] : 0.f;
    }

    float acc[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[j] = 0.f;

    const float* hcol = h + col;
    // H[b0 + bb, col] for bb = p + kParts (r + l), l < kLoads, zero past
    // the chunk's bc rows
    auto load_h = [&](float(&hv)[kLoads], int b0, int r, int bc) {
#pragma unroll
      for (int l = 0; l < kLoads; ++l) {
        const int bb = p + kParts * (r + l);
        hv[l] = live && bb < bc ? hcol[(size_t)(b0 + bb) * D] : 0.f;
      }
    };
    // acc += lr * C[bb, j] H[bb, col] for the rows of hv, in row order
    auto fma_h = [&](const float(&hv)[kLoads], int r, int bc) {
#pragma unroll
      for (int l = 0; l < kLoads; ++l) {
        const int bb = p + kParts * (r + l);
        if (bb < bc) {
          // a row of lr * C, four bundle rows per shared-memory load
          const float4* cr = reinterpret_cast<const float4*>(sh.cs[bb]);
#pragma unroll
          for (int q = 0; q < kJ / 4; ++q) {
            const float4 cq = cr[q];
            acc[4 * q] = fmaf(cq.x, hv[l], acc[4 * q]);
            acc[4 * q + 1] = fmaf(cq.y, hv[l], acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(cq.z, hv[l], acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(cq.w, hv[l], acc[4 * q + 3]);
          }
        }
      }
    };
    float ha[kLoads], hb[kLoads];
    for (int b0 = 0; b0 < B; b0 += kBChunk) {
      const int bc = min(kBChunk, B - b0);
      load_h(ha, b0, 0, bc);  // in flight while lr * C is staged
      __syncthreads();        // every thread is done with the shared arrays
      // the chunk's rows of C, every copy in flight at once, then scaled
      // by lr in place by the thread that copied them
      for (int i = tid; i < bc * kJ; i += kThreads) {
        const int b = i / kJ, j = i % kJ;
        cp_async4(&sh.cs[b][j], j < nc ? c + (size_t)(b0 + b) * n + j0 + j : c,
                  j < nc);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      for (int i = tid; i < bc * kJ; i += kThreads) sh.cs[i / kJ][i % kJ] *= lr;
      __syncthreads();
      // rounds of kLoads rows, the next round's loads in flight during
      // this round's FMAs (two register arrays in turn)
      for (int r = 0; p + kParts * r < bc; r += 2 * kLoads) {
        const bool more = p + kParts * (r + kLoads) < bc;
        if (more) load_h(hb, b0, r + kLoads, bc);
        fma_h(ha, r, bc);
        if (!more) break;
        if (p + kParts * (r + 2 * kLoads) < bc)
          load_h(ha, b0, r + 2 * kLoads, bc);
        fma_h(hb, r + kLoads, bc);
      }
    }

    __syncthreads();  // cs is dead; sums takes its place
#pragma unroll
    for (int j = 0; j < kJ; ++j) sh.sums[p][j][cl] = acc[j];
    __syncthreads();

    // U = M + the groups' sums in group order; then sum U^2 per row over
    // the tile's columns: the warp's 32, then the row's two warps in order
    float ut[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int j = p + kParts * i;
      float s = sh.sums[0][j][cl];
#pragma unroll
      for (int q = 1; q < kParts; ++q) s += sh.sums[q][j][cl];
      ut[i] = (live && j < nc) ? mv[i] + s : 0.f;
      const float ss = warp_sum(ut[i] * ut[i]);
      if (lane == 0) red[warp][i] = ss;
    }
    __syncthreads();
    if (tid < nc) {
      const int q = tid % kParts, i = tid / kParts;
      constexpr int kWarpsPerPart = kCols / 32;
      float s = red[q * kWarpsPerPart][i];
#pragma unroll
      for (int w = 1; w < kWarpsPerPart; ++w)
        s += red[q * kWarpsPerPart + w][i];
      partial[(size_t)(j0 + tid) * col_blocks + cb] = s;
    }
    if (tile == blockIdx.x) {
#pragma unroll
      for (int i = 0; i < kR; ++i) uv[i] = ut[i];
    } else {   // a later tile waits in `u`, unnormalised
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int j = p + kParts * i;
        if (live && j < nc) u[(size_t)(j0 + j) * D + col] = ut[i];
      }
    }
  }

  cg::this_grid().sync();

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int cb = tile % col_blocks, j0 = tile / col_blocks * kJ;
    const int col = cb * kCols + cl;
    const bool live = col < D;
    const int nc = min(kJ, n - j0);
    __syncthreads();  // denom is free
    // each row's partials summed in column-block order (lanes striding,
    // then a shuffle tree), so every block gets the same bits
    for (int j = warp; j < nc; j += kWarps) {
      const float* pr = partial + (size_t)(j0 + j) * col_blocks;
      float s = 0.f;
      for (int q0 = lane; q0 < col_blocks; q0 += 32 * kDenomLoads) {
        float v[kDenomLoads];   // all in flight, then added in order
#pragma unroll
        for (int l = 0; l < kDenomLoads; ++l) {
          const int q = q0 + 32 * l;
          v[l] = q < col_blocks ? __ldcg(pr + q) : 0.f;
        }
#pragma unroll
        for (int l = 0; l < kDenomLoads; ++l) s += v[l];
      }
      s = warp_sum(s);
      if (lane == 0) denom[j] = sqrtf(s) + 1e-12f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int j = p + kParts * i;
      if (live && j < nc) {
        float* up = u + (size_t)(j0 + j) * D + col;
        *up = (tile == blockIdx.x ? uv[i] : __ldcg(up)) / denom[j];
      }
    }
  }
}

template <int kJ>
int capacity() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, update_kernel<kJ>, kThreads, 0);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

template <int kJ>
cudaError_t launch(const float* m, const float* c, const float* h, float lr,
                   float* u, float* partial, int B, int D, int n,
                   int col_blocks, int tiles, int blocks, cudaStream_t s) {
  void* args[] = {&m, &c, &h, &lr, &u, &partial, &B, &D, &n, &col_blocks,
                  &tiles};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(update_kernel<kJ>), dim3(blocks),
      dim3(kThreads), args, 0, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

#define BU_ROWS(X) X(4) X(8) X(12) X(16) X(20) X(24) X(28) X(32)

// Blocks of the kJ-row kernel that the current device holds at once (all
// must be resident for the grid barrier); a negative cudaError_t on error,
// -1 for a kJ that was not compiled.
extern "C" int bundle_update_capacity(int kj) {
  switch (kj) {
#define BU_CAP(K) \
  case K:         \
    return capacity<K>();
    BU_ROWS(BU_CAP)
#undef BU_CAP
    default:
      return -1;
  }
}

// m: (n, D), c: (B, n), h: (B, D), all float32 row-major; out: (n, D);
// partial: (n, col_blocks) float32 scratch.  kj, col_blocks, tiles, blocks
// and threads come from ops.py's update_geometry and must match the
// compiled kernel (else cudaErrorInvalidValue, nothing launched); blocks is
// at most bundle_update_capacity(kj).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int bundle_update_launch(const void* m, const void* c,
                                    const void* h, float lr, void* out,
                                    void* partial, int B, int D, int n,
                                    int kj, int col_blocks, int tiles,
                                    int blocks, int threads, void* stream) {
  if (threads != kThreads || (long long)col_blocks * kCols < D ||
      (long long)tiles * kj < (long long)n * col_blocks || blocks < 1 ||
      blocks > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* mp = static_cast<const float*>(m);
  const float* cp = static_cast<const float*>(c);
  const float* hp = static_cast<const float*>(h);
  float* up = static_cast<float*>(out);
  float* pp = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kj) {
#define BU_LAUNCH(K)                                                       \
  case K:                                                                  \
    return static_cast<int>(launch<K>(mp, cp, hp, lr, up, pp, B, D, n,     \
                                      col_blocks, tiles, blocks, s));
    BU_ROWS(BU_LAUNCH)
#undef BU_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
