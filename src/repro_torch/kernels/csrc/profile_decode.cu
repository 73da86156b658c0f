// profile_decode: nearest-profile decode scores for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/profile_decode/profile_decode.py:profile_decode_pallas
//   (body _kernel)
// and computes the same function:
//   scores[b, c] = 2 <A_b, P_c> - ||P_c||^2 - ||A_b||^2   (= -||A_b - P_c||^2)
// for activations A (B, n) and profiles P (C, n), both float32 or both
// bfloat16, accumulated in float32.  Output (B, C) float32.
//
// What bounds it on the H100: at the classifier's shapes (B = 1559, n = 10,
// C = 26) it reads 62 KB and 1 KB and writes 162 KB, so it is bound by the
// launch, and beyond that by writing the output: the work is 2*B*C*n flops.
//
// Design: a 2-D grid of 32 x 32 output tiles, one block of 32 x 8 threads
// per tile, each thread owning four rows of one column.  The A and P tiles
// are staged in shared memory 32 columns of n at a time (padded rows, so
// the column reads are free of bank conflicts), and the loop over n also
// accumulates both squared norms inside the block, so nothing but the
// scores is written.  A warp shares one tile row, so its reads of A are
// broadcasts and its stores of the output are 128 contiguous bytes.  The
// TPU version kept n whole at 128 lanes; here n is looped, so any n works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;  // output rows and columns per block
constexpr int kRows = 8;   // blockDim.y; each thread owns kTile / kRows rows
constexpr int kK = 32;     // n staged per step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kTile * kRows)
    profile_decode_kernel(const T* __restrict__ a, const T* __restrict__ p,
                          float* __restrict__ out, int B, int C, int n) {
  __shared__ float as[kTile][kK + 1];
  __shared__ float ps[kTile][kK + 1];
  constexpr int kPer = kTile / kRows;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;

  float dot[kPer], asq[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) dot[r] = asq[r] = 0.f;
  float psq = 0.f;

  for (int k0 = 0; k0 < n; k0 += kK) {
    const int k = k0 + tx;
#pragma unroll
    for (int i = ty; i < kTile; i += kRows) {
      const int b = b0 + i, c = c0 + i;
      as[i][tx] = (b < B && k < n) ? to_f32(a[(size_t)b * n + k]) : 0.f;
      ps[i][tx] = (c < C && k < n) ? to_f32(p[(size_t)c * n + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      const float pv = ps[tx][kk];
      psq = fmaf(pv, pv, psq);
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const float av = as[ty + kRows * r][kk];
        dot[r] = fmaf(av, pv, dot[r]);
        asq[r] = fmaf(av, av, asq[r]);
      }
    }
    __syncthreads();
  }

  const int c = c0 + tx;
  if (c >= C) return;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int b = b0 + ty + kRows * r;
    if (b < B) out[(size_t)b * C + c] = 2.f * dot[r] - psq - asq[r];
  }
}

}  // namespace

// a: (B, n), p: (C, n), both float32 (bf16 = 0) or both bfloat16 (bf16 = 1),
// row-major; out: (B, C) float32.  Returns the cudaError_t of the launch.
extern "C" int profile_decode_launch(const void* a, const void* p, void* out,
                                     int B, int C, int n, int bf16,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((C + kTile - 1) / kTile, (B + kTile - 1) / kTile);
  const dim3 block(kTile, kRows);
  if (bf16)
    profile_decode_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(p), static_cast<float*>(out), B, C,
        n);
  else
    profile_decode_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(p),
        static_cast<float*>(out), B, C, n);
  return static_cast<int>(cudaGetLastError());
}
