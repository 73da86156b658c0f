// loghd_head: the LogHD vocab head of the decoder LM for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/loghd_head/loghd_head.py:loghd_head_pallas (body _kernel)
// and computes the same function:
//   A = h M^T,   logits[b, v] = 2 A_b . P_v - ||P_v||^2 - ||A_b||^2
//                             = -||A_b - P_v||^2
// for hidden states h (B, D) and bundles M (n, D), each float32 or bfloat16
// (widened on load), and vocab profiles P (V, n) in float32 or bfloat16.
// Output (B, V) float32.
//
// What bounds it on the H100: bytes.  At the serving step (B, D, n, V) =
// (4, 2048, 20, 151936) in bf16 it must read 6.1 MB of P and write 2.4 MB of
// logits, about 2.6 us at 3.35 TB/s; at a 512-row forward the 311 MB of
// logits (93 us), against 1.6 G multiply-adds.
//
// Design: two launches chained by programmatic dependent launch (PDL).
//  - The A stage: a block of 256 threads computes A[b, j] = <h_b, M_j> for
//    one (row, bundle) below 64 rows (the most blocks for a decode step) and
//    for 4 rows x 4 bundles from 64 rows (h and M read a quarter as often:
//    at 512 rows the one-pair blocks took 16.5 us on an H100); either way
//    each thread sums its D / 256 elements (batches of 8 loads in flight) in
//    d order with fmaf, and the block reduces the threads by a fixed shuffle
//    tree and its 8 warps in order, into a (B, n) float32 scratch.  Its
//    blocks signal launch_dependents as they start.
//  - The score stage (score_stage.cuh, shared with profile_decode) is
//    launched as a programmatic dependent: its blocks start while the A stage
//    runs and issue the 16-byte copies of their span of P, then wait
//    (griddepcontrol.wait) for A, copy their rows of A, and compute 2 A P^T
//    on the tensor cores (A split into a TF32 high part and its remainder: two products
//    against a bf16 P, three against a float32 P) before the 16-byte stores of
//    the logits.  So the decode step pays for the A stage and the score
//    stage's tail, not for two launches and a P read in series.
//  - The TPU kernel kept A in VMEM scratch across its sequential grid; CUDA
//    blocks have no such order, and recomputing A per block of V would cost
//    B n D multiply-adds per block.
// Every sum has one order that depends on neither B nor the grid, so a row's
// logits are bitwise the same at any batch size; a bf16 P read as stored
// gives the bits of its float32 widening (its remainder products are exact
// zeros).
#include "score_stage.cuh"

namespace {

constexpr int kMaxN = 64;         // bundles supported (n = 20 at V = 151936)
constexpr int kActThreads = 256;  // threads per (b, j) dot product
constexpr int kActBatch = 8;      // loads of h and M in flight per thread
constexpr int kActRowsMin = 64;   // rows from which a block takes 4 x 4

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A[b, j] = <h_b, M_j> for kR rows x kJ bundles a block: grid
// (ceil(B / kR), ceil(n / kJ)).  Every (b, j) is summed in the one order of
// a single dot product: thread t takes d = t + 256 i (i in order, fmaf),
// then the xor shuffle tree, then the 8 warps in order; so kR and kJ do not
// change a bit, and large B reads h and M kR and kJ times less often.
template <typename TH, typename TM, int kR, int kJ>
__global__ void __launch_bounds__(kActThreads)
    acts_kernel(const TH* __restrict__ h, const TM* __restrict__ m,
                float* __restrict__ a, int B, int D, int n) {
  // the score stage may start now: its prologue reads only P
  score::launch_dependents();
  __shared__ float red[kActThreads / 32][kR * kJ];
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * kR, j0 = blockIdx.y * kJ;
  float acc[kR][kJ];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int q = 0; q < kJ; ++q) acc[r][q] = 0.f;
  for (int d0 = t; d0 < D; d0 += kActThreads * kActBatch) {
    float hv[kR][kActBatch], mv[kJ][kActBatch];
#pragma unroll
    for (int k = 0; k < kActBatch; ++k) {
      const int d = d0 + k * kActThreads;
#pragma unroll
      for (int r = 0; r < kR; ++r)
        hv[r][k] = (d < D && b0 + r < B)
                       ? score::to_f32(h[(size_t)(b0 + r) * D + d])
                       : 0.f;
#pragma unroll
      for (int q = 0; q < kJ; ++q)
        mv[q][k] = (d < D && j0 + q < n)
                       ? score::to_f32(m[(size_t)(j0 + q) * D + d])
                       : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kActBatch; ++k)
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int q = 0; q < kJ; ++q)
          acc[r][q] = fmaf(hv[r][k], mv[q][k], acc[r][q]);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int q = 0; q < kJ; ++q) {
      const float s = warp_sum(acc[r][q]);
      if ((t & 31) == 0) red[t >> 5][r * kJ + q] = s;
    }
  __syncthreads();
  if (t < kR * kJ) {
    const int r = t / kJ, q = t % kJ;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kActThreads / 32; ++w) s += red[w][t];
    if (b0 + r < B && j0 + q < n) a[(size_t)(b0 + r) * n + j0 + q] = s;
  }
}

// one row and one bundle a block (the most blocks) up to kActRowsMin rows;
// beyond, 4 rows x 4 bundles a block
template <typename TH, typename TM>
cudaError_t launch_acts(const void* h, const void* m, float* a, int B, int D,
                        int n, cudaStream_t s) {
  const TH* hp = static_cast<const TH*>(h);
  const TM* mp = static_cast<const TM*>(m);
  if (B < kActRowsMin)
    acts_kernel<TH, TM, 1, 1><<<dim3(B, n), kActThreads, 0, s>>>(hp, mp, a,
                                                                 B, D, n);
  else
    acts_kernel<TH, TM, 4, 4><<<dim3((B + 3) / 4, (n + 3) / 4), kActThreads,
                                0, s>>>(hp, mp, a, B, D, n);
  return cudaGetLastError();
}

template <int kS>
cudaError_t launch_scores(const float* a, const void* p, float* out, int B,
                          int V, int n, int p_bf16, int chunks, int wc, int t,
                          int row_blocks, int v_blocks, int smem, int pdl,
                          cudaStream_t s) {
  return p_bf16
             ? score::launch<float, __nv_bfloat16, kS, false>(
                   a, static_cast<const __nv_bfloat16*>(p), out, B, V, n,
                   chunks, wc, t, row_blocks, v_blocks, smem, pdl, 0, s)
             : score::launch<float, float, kS, false>(
                   a, static_cast<const float*>(p), out, B, V, n, chunks, wc,
                   t, row_blocks, v_blocks, smem, pdl, 0, s);
}

}  // namespace

// Blocks of the score stage (k-steps ks, P bfloat16 when p_bf16) with
// `smem` bytes that the current device holds at once; a negative
// cudaError_t on error, -1 for a ks that was not compiled.
extern "C" int loghd_head_capacity(int ks, int p_bf16, int smem) {
  switch (ks) {
#define LH_CAP(K)                                                    \
  case K:                                                            \
    return p_bf16 ? score::capacity<float, __nv_bfloat16, K, false>(smem)   \
                  : score::capacity<float, float, K, false>(smem);
    SCORE_STEPS(LH_CAP)
#undef LH_CAP
    default:
      return -1;
  }
}

// h: (B, D), m: (n, D), p: (V, n), each float32 (flag 0) or bfloat16
// (flag 1), row-major; a: (B, n) float32 scratch; out: (B, V) float32.
// ks, chunks, wc, t, row_blocks, v_blocks and smem come from ops.py's
// loghd_head_geometry and must describe a score stage this file can run
// (score::valid), with 0 < n <= 64 and B <= 2^31 - 1 (else
// cudaErrorInvalidValue, nothing launched).  pdl = 1 launches the score stage
// as a programmatic dependent of the A stage.  Returns the first
// cudaError_t (0 on success).
extern "C" int loghd_head_launch(const void* h, const void* m, const void* p,
                                 void* a, void* out, int B, int D, int n,
                                 int V, int h_bf16, int m_bf16, int p_bf16,
                                 int ks, int chunks, int wc, int t,
                                 int row_blocks, int v_blocks, int smem,
                                 int pdl, void* stream) {
  if (D <= 0 || n <= 0 || n > kMaxN ||
      !score::valid(B, V, n, 4, p_bf16 ? 2 : 4, ks, chunks, wc, t,
                    row_blocks, v_blocks, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* af = static_cast<float*>(a);
  cudaError_t e;
  if (h_bf16 && m_bf16)
    e = launch_acts<__nv_bfloat16, __nv_bfloat16>(h, m, af, B, D, n, s);
  else if (h_bf16)
    e = launch_acts<__nv_bfloat16, float>(h, m, af, B, D, n, s);
  else if (m_bf16)
    e = launch_acts<float, __nv_bfloat16>(h, m, af, B, D, n, s);
  else
    e = launch_acts<float, float>(h, m, af, B, D, n, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* o = static_cast<float*>(out);
  switch (ks) {
#define LH_LAUNCH(K)                                                      \
  case K:                                                                 \
    return static_cast<int>(launch_scores<K>(af, p, o, B, V, n, p_bf16,   \
                                             chunks, wc, t, row_blocks, \
                                             v_blocks, smem, pdl, s));
    SCORE_STEPS(LH_LAUNCH)
#undef LH_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
