// loghd_head: the LogHD vocab head of the decoder LM for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/loghd_head/loghd_head.py:loghd_head_pallas (body _kernel)
// and computes the same function:
//   A = h M^T,   logits[b, v] = 2 A_b . P_v - ||P_v||^2 - ||A_b||^2
//                             = -||A_b - P_v||^2
// for hidden states h (B, D) and bundles M (n, D), each float32 or bfloat16
// (widened on load), and vocab profiles P (V, n) in float32 or bfloat16.
// Widening a bf16 profile is exact, so reading the stored bf16 P gives the
// same logits as casting it to float32 first, as the JAX dispatch does.
// Everything is summed in float32 with fmaf: no tensor cores, no TF32, no
// fast math.  Output (B, V) float32.
//
// What bounds it on the H100: bytes.  At the serving step (B, D, n, V) =
// (4, 2048, 20, 151936) in bf16 it must read 6.1 MB of P and write 2.4 MB of
// logits, about 2.6 us at 3.35 TB/s, against 2BVn = 24 MFLOP, 0.4 us at the
// float32 rate.  At a 512-row prefill the 311 MB of logits dominate (93 us)
// and the 3.1 GFLOP come to half of that.
//
// Design: two launches.  The TPU kernel computes A on its first V tile into
// VMEM scratch and reuses it on every later tile, which relies on the TPU
// running its grid in order and keeping scratch between steps; CUDA blocks
// have neither, and recomputing A in every V block would cost B n D FMAs
// per block (12.5 G at a 512-row prefill).  So the first kernel computes A
// alone, one block of 256 threads per (row b, bundle j): each thread loads
// its D / 256 elements of h_b and M_j in batches of 8 (all in flight at
// once), sums them in d order with fmaf, and the block reduces the threads
// with a fixed shuffle tree and its 8 warps in order, into a (B, n)
// float32 scratch.  The second kernel gives each thread one v and each
// block 256 consecutive v and up to 64 rows: a thread loads P_v's n values
// into registers (all loads in flight at once; the warp's 32 rows are one
// contiguous span, which L1 serves) and sums ||P_v||^2; the block walks
// its rows in tiles of 32 staged in shared memory (rows padded with zeros
// to whole float4s, so a thread reads four values of A_b per load), sums
// ||A_b||^2 in a fixed order, and each thread writes out[b, v],
// neighbouring threads on neighbouring v (coalesced).  An earlier version
// that staged the P tile through shared memory took 15.4 us of device time
// at the serving step, where this one takes 6.5 us (chip_smoke.py, NVIDIA
// H100 80GB HBM3, 700 W).
// Every sum has one order that depends on neither B nor the grid, so a
// row's logits are bitwise the same at any batch size.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;         // bundles supported (n = 20 at V = 151936)
constexpr int kActThreads = 256;  // threads per (b, j) dot product
constexpr int kActBatch = 8;      // loads of h and M in flight per thread
constexpr int kThreads = 256;     // v per block of the second kernel
constexpr int kRowTile = 32;      // rows of A staged in shared memory at once
constexpr int kRowsPerBlock = 64; // rows of the output per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A[b, j] = <h_b, M_j>: grid (B, n), one block per dot product.
template <typename TH, typename TM>
__global__ void __launch_bounds__(kActThreads)
    acts_kernel(const TH* __restrict__ h, const TM* __restrict__ m,
                float* __restrict__ a, int D, int n) {
  __shared__ float red[kActThreads / 32];
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;
  const int j = blockIdx.y;
  const TH* hr = h + b * D;
  const TM* mr = m + (size_t)j * D;
  float acc = 0.f;
  for (int d0 = t; d0 < D; d0 += kActThreads * kActBatch) {
    float hv[kActBatch], mv[kActBatch];
#pragma unroll
    for (int k = 0; k < kActBatch; ++k) {
      const int d = d0 + k * kActThreads;
      hv[k] = d < D ? to_f32(hr[d]) : 0.f;
      mv[k] = d < D ? to_f32(mr[d]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kActBatch; ++k) acc = fmaf(hv[k], mv[k], acc);
  }
  acc = warp_sum(acc);
  if ((t & 31) == 0) red[t >> 5] = acc;
  __syncthreads();
  if (t == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kActThreads / 32; ++w) s += red[w];
    a[b * n + j] = s;
  }
}

// A row of A in shared memory, padded with zeros to whole float4s.
__host__ __device__ inline int a_stride(int n) { return (n + 3) & ~3; }

// kN: register slots for one profile, 32 or 64, the smaller that holds n.
// At kN = 32 the registers are capped at 85 a thread, so that three blocks
// share an SM.
template <typename TP, int kN>
__global__ void __launch_bounds__(kThreads, kN <= 32 ? 3 : 1)
    decode_kernel(const float* __restrict__ a, const TP* __restrict__ p,
                  float* __restrict__ out, int B, int V, int n) {
  extern __shared__ float4 smem4[];
  const int n4 = a_stride(n);
  float* as = reinterpret_cast<float*>(smem4);  // kRowTile x n4
  float* asq = as + kRowTile * n4;              // kRowTile

  const int t = threadIdx.x;
  const int v = blockIdx.x * kThreads + t;
  const bool live = v < V;
  const TP* pv = p + (size_t)min(v, V - 1) * n;
  float pr[kN];
  float p_sq = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) pr[j] = (j < n && live) ? to_f32(pv[j]) : 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j)
    if (j < n) p_sq = fmaf(pr[j], pr[j], p_sq);

  const int b_begin = blockIdx.y * kRowsPerBlock;
  const int b_end = min(B, b_begin + kRowsPerBlock);
  float* col = out + v;
  for (int b0 = b_begin; b0 < b_end; b0 += kRowTile) {
    const int nb = min(kRowTile, b_end - b0);
    __syncthreads();  // every thread is done with the previous row tile
    for (int i = t; i < nb * n4; i += kThreads) {
      const int r = i / n4, c = i - r * n4;
      as[i] = c < n ? a[(size_t)(b0 + r) * n + c] : 0.f;
    }
    __syncthreads();
    if (t < nb) {
      float s = 0.f;
      for (int j = 0; j < n; ++j) s = fmaf(as[t * n4 + j], as[t * n4 + j], s);
      asq[t] = s;
    }
    __syncthreads();
    if (live) {
      for (int r = 0; r < nb; ++r) {
        const float4* ar = reinterpret_cast<const float4*>(as + r * n4);
        float dot = 0.f;
#pragma unroll
        for (int q = 0; q < kN / 4; ++q) {
          if (4 * q < n) {  // the zero padding adds fmaf(0, 0, dot) = dot
            const float4 x = ar[q];
            dot = fmaf(x.x, pr[4 * q], dot);
            dot = fmaf(x.y, pr[4 * q + 1], dot);
            dot = fmaf(x.z, pr[4 * q + 2], dot);
            dot = fmaf(x.w, pr[4 * q + 3], dot);
          }
        }
        col[(size_t)(b0 + r) * V] = 2.f * dot - p_sq - asq[r];
      }
    }
  }
}

template <typename TH, typename TM>
void launch_acts(const void* h, const void* m, float* a, int B, int D, int n,
                 cudaStream_t s) {
  acts_kernel<TH, TM><<<dim3(B, n), kActThreads, 0, s>>>(
      static_cast<const TH*>(h), static_cast<const TM*>(m), a, D, n);
}

template <typename TP, int kN>
cudaError_t launch_decode(const float* a, const void* p, float* out, int B,
                          int V, int n, cudaStream_t s) {
  const size_t smem = sizeof(float) * (kRowTile * a_stride(n) + kRowTile);
  const dim3 grid((V + kThreads - 1) / kThreads,
                  (B + kRowsPerBlock - 1) / kRowsPerBlock);
  decode_kernel<TP, kN><<<grid, kThreads, smem, s>>>(
      a, static_cast<const TP*>(p), out, B, V, n);
  return cudaSuccess;
}

template <typename TP>
cudaError_t launch_decode_n(const float* a, const void* p, float* out, int B,
                            int V, int n, cudaStream_t s) {
  return n <= 32 ? launch_decode<TP, 32>(a, p, out, B, V, n, s)
                 : launch_decode<TP, 64>(a, p, out, B, V, n, s);
}

}  // namespace

// h: (B, D), m: (n, D), p: (V, n), each float32 (flag 0) or bfloat16
// (flag 1), row-major; a: (B, n) float32 scratch; out: (B, V) float32.
// Requires B, D, n, V > 0, n <= 64 and ceil(B / 64) <= 65535.  Launches two
// kernels on `stream` and returns the first cudaError_t (0 on success).
extern "C" int loghd_head_launch(const void* h, const void* m, const void* p,
                                 void* a, void* out, int B, int D, int n,
                                 int V, int h_bf16, int m_bf16, int p_bf16,
                                 void* stream) {
  if (B <= 0 || D <= 0 || n <= 0 || n > kMaxN || V <= 0 ||
      (B + kRowsPerBlock - 1) / kRowsPerBlock > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* af = static_cast<float*>(a);
  if (h_bf16 && m_bf16)
    launch_acts<__nv_bfloat16, __nv_bfloat16>(h, m, af, B, D, n, s);
  else if (h_bf16)
    launch_acts<__nv_bfloat16, float>(h, m, af, B, D, n, s);
  else if (m_bf16)
    launch_acts<float, __nv_bfloat16>(h, m, af, B, D, n, s);
  else
    launch_acts<float, float>(h, m, af, B, D, n, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = p_bf16 ? launch_decode_n<__nv_bfloat16>(af, p, static_cast<float*>(out),
                                              B, V, n, s)
             : launch_decode_n<float>(af, p, static_cast<float*>(out), B, V,
                                      n, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
