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
// What bounds it on the H100: at the classifier's shapes (B <= 1,559,
// n = 10 or 20, C = 26) it reads under 130 KB and writes under 170 KB, so the
// launch bounds it; at the extreme-classification C = 2^16 the output.
//
// Design: the score stage of score_stage.cuh, shared with loghd_head: the
// tile fitted to C (at C = 26 a warp covers 32 profiles and the 8 warps of a
// block take 8 row tiles) and to n (k-steps of 8 up to n, not a fixed 32),
// P staged once per block by 16-byte copies, 2 A P^T on the tensor cores in
// 3xTF32 (one product in bf16, which TF32 holds exactly), 16-byte stores.
// On the predict path it follows bundle_sim, which produces A: launched as a
// programmatic dependent (pdl = 1), its launch and its P prologue run under
// bundle_sim's tail, and griddepcontrol.wait holds the reads of A until
// bundle_sim has finished.  The caller asks for that only where the kernel
// launched just before on the stream does not write P.
#include "score_stage.cuh"

// Blocks of the kernel (k-steps ks, bfloat16 when bf16) with `smem` bytes
// that the current device holds at once; a negative cudaError_t on error,
// -1 for a ks that was not compiled.
extern "C" int profile_decode_capacity(int ks, int bf16, int smem) {
  switch (ks) {
#define PD_CAP(K)                                                        \
  case K:                                                                \
    return bf16 ? score::capacity<__nv_bfloat16, __nv_bfloat16, K, true>(smem) \
                : score::capacity<float, float, K, true>(smem);
    SCORE_STEPS(PD_CAP)
#undef PD_CAP
    default:
      return -1;
  }
}

// a: (B, n), p: (C, n), both float32 (bf16 = 0) or both bfloat16 (bf16 = 1),
// row-major; out: (B, C) float32.  ks, chunks, wc, t, row_blocks,
// v_blocks and smem come from ops.py's profile_decode_geometry and must
// describe a launch this file can run (score::valid; else
// cudaErrorInvalidValue, nothing launched).  pdl = 1 launches as a
// programmatic dependent of the kernel before it on `stream`.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int profile_decode_launch(const void* a, const void* p, void* out,
                                     int B, int C, int n, int bf16, int ks,
                                     int chunks, int wc, int t,
                                     int row_blocks, int v_blocks, int smem,
                                     int pdl, void* stream) {
  if (!score::valid(B, C, n, bf16 ? 2 : 4, bf16 ? 2 : 4, ks, chunks, wc, t,
                    row_blocks, v_blocks, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (ks) {
#define PD_LAUNCH(K)                                                       \
  case K:                                                                  \
    return static_cast<int>(                                               \
        bf16 ? score::launch<__nv_bfloat16, __nv_bfloat16, K, true>(             \
                   static_cast<const __nv_bfloat16*>(a),                   \
                   static_cast<const __nv_bfloat16*>(p), o, B, C, n,       \
                   chunks, wc, t, row_blocks, v_blocks, smem, pdl, pdl, s)   \
             : score::launch<float, float, K, true>(                             \
                   static_cast<const float*>(a),                           \
                   static_cast<const float*>(p), o, B, C, n, chunks, wc,   \
                   t, row_blocks, v_blocks, smem, pdl, pdl, s));
    SCORE_STEPS(PD_LAUNCH)
#undef PD_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
