// score_stage.cuh: the nearest-profile score stage shared by
// profile_decode.cu and loghd_head.cu (sm_90a).
//
// Computes, for activations A (B, n) and profiles P (C, n),
//   out[b, c] = 2 <A_b, P_c> - ||P_c||^2 - ||A_b||^2      (= -||A_b - P_c||^2)
// into out (B, C) float32.  A is float32 or bfloat16, P float32 or bfloat16,
// each widened to float32 on load.  It is the whole of profile_decode (C = 26
// classes up to C = 2^16) and the second launch of loghd_head (C = the
// 151,936-word vocabulary).
//
// What bounds it: the output.  At the LM head the logits are 311 MB at 512
// rows (93 us at 3.35 TB/s) against 1.6 G multiply-adds; at the decode step
// (B = 4) the 6.1 MB of bf16 profiles; at the classifier's shapes the launch.
//
// Design.
//  - A block is 8 warps.  A warp owns 32 consecutive profiles (four MMA
//    n-tiles of 8) and walks row tiles of 16 rows; the 8 warps are wc warp
//    columns x wr = 8 / wc warp rows, wc fitted to C (1 at C = 26, 8 at the
//    vocabulary).  A block covers vb = 32 wc profiles and rows = 16 wr t rows
//    (t row tiles a warp).  A warp walking several spans of profiles in turn
//    (so that a decode step's blocks all fit at once) was slower on an H100:
//    8.0-9.3 us against 7.5 at B = 4.
//  - Prologue: the block's profiles are one contiguous span of vb n
//    elements of P, its rows of A another; both are fetched by 16-byte
//    cp.async (the last bytes of a tensor element by element), P before
//    griddepcontrol.wait, A after it.  Launched as a programmatic dependent
//    of bundle_sim (profile_decode on the predict path), a block also lands
//    P and builds its fragments and norms before the wait, under
//    bundle_sim's tail; after loghd_head's short A stage, or launched alone,
//    the two copies overlap and the fragments follow.
//  - ||P_c||^2 and ||A_b||^2 come from the MMA fragments themselves: a lane
//    sums the squares of its k (k % 4 == tq) in k order, then the quad adds
//    its lanes as (t0 + t1) + (t2 + t3); no pass over n in shared memory.
//  - 2 A P^T on the tensor cores, mma.sync.m16n8k8 in TF32 (rows x profiles x
//    n): a float32 operand is split into a TF32 high part and its remainder
//    (exact), and a product takes lo*hi and hi*lo into one float32
//    accumulator and hi*hi into another (3xTF32; two short dependency
//    chains, added at the end: profile_decode), or all three into one
//    (loghd_head, whose bf16-profile kernels need their registers for three
//    blocks an SM: two accumulators spilled there); a bf16 operand is exact
//    in TF32, its remainder is 0 and its products are skipped.  So a bf16 P
//    takes two products against a float32 A, and a bf16 P and its float32
//    widening give the same bits (the skipped product adds exact zeros).
//    Up to n = 32 (ks <= 4) a warp keeps its profiles' fragments in registers
//    across its row tiles; beyond, it reloads them from shared memory per row
//    tile and per chunk of 64 columns of n.
//  - Epilogue: 2 (lo + hi) - ||P||^2 - ||A||^2 into the warp's staging tile
//    in shared memory, then out by whole rows: 16-byte streaming stores, 8
//    lanes a 128-byte row segment (a row a store, 4 bytes a lane, where
//    C % 4 != 0).  Scattered 4-byte stores, 16 rows a store, cost
//    profile_decode 3 us at 1,559 rows on an H100.
//
// Rows independent of B, and determinism.  A row's sums run in one order
// fixed by n: ||.||^2 as above, the k-steps in order into each accumulator
// (lo*hi before hi*lo), then lo + hi.  Row b sits at row b % 16 of its MMA
// tile and profile c at column c % 8 of its n-tile for every geometry, and
// nothing uses atomics, so a row's bits depend on neither B nor the launch
// geometry.
// The geometry is computed in Python (kernels/score_stage.py) and checked
// again here (score::valid).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Everything here has internal linkage: each kernel library compiles its own
// copy, and two libraries loaded in one process must not resolve each
// other's kernels (a shared float32 instantiation would otherwise take the
// shared-memory attribute of the other library's kernel).
namespace score {
namespace {

constexpr int kThreads = 256;       // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kWarpV = 32;          // profiles a warp: four n-tiles of 8
constexpr int kNT = kWarpV / 8;
constexpr int kTileRows = 16;       // rows of an MMA tile
constexpr int kMaxWarpTiles = 8;    // wr * t: at most 128 rows a block
constexpr int kHoldSteps = 4;       // fragments held in registers to n = 32
constexpr int kChunkSteps = 8;      // k-steps of a chunk beyond n = 32
constexpr int kSmemMax = 232448 - 1024;  // dynamic, per block

constexpr int kStagePitch = kWarpV + 4;  // a staged output row, in floats

// blocks an SM must hold (registers capped to fit): 3 with bf16 profiles,
// whose fragments have no remainder, 2 with float32 ones
template <typename TP>
__host__ __device__ constexpr int min_blocks() {
  return std::is_same<TP, float>::value ? 2 : 3;
}

// rows of A a block holds: its rows, or B rounded up to a tile if fewer
__host__ __device__ constexpr int rows_held(int rows, int B) {
  return rows < (B + kTileRows - 1) / kTileRows * kTileRows
             ? rows
             : (B + kTileRows - 1) / kTileRows * kTileRows;
}

// dynamic shared memory of a block, in bytes: the span of P and the rows of
// A it holds, each rounded up to 16 bytes, and a staging tile a warp
__host__ __device__ constexpr long long smem_bytes(int vb, int n, int p_esize,
                                                   int held, int a_esize) {
  return ((long long)vb * n * p_esize + 15) / 16 * 16 +
         ((long long)held * n * a_esize + 15) / 16 * 16 +
         4LL * kWarps * kTileRows * kStagePitch;
}

// the k-steps of 8 a chunk: the smallest of 2, 3, 4 that holds n, else 8
__host__ __device__ constexpr int steps_for(int n) {
  return n <= 16 ? 2 : n <= 24 ? 3 : n <= 32 ? 4 : kChunkSteps;
}

// A launch this file can run: every (row, profile) covered once, the
// compiled k-steps and chunks those n needs, and the shared memory stated.
inline bool valid(int B, int C, int n, int a_esize, int p_esize, int ks,
                  int chunks, int wc, int t, int row_blocks, int v_blocks,
                  int smem) {
  if (B < 1 || C < 1 || n < 1 || ks != steps_for(n)) return false;
  if (chunks < 1 || (long long)8 * ks * chunks < n ||
      (long long)8 * ks * (chunks - 1) >= n)
    return false;
  if (wc != 1 && wc != 2 && wc != 4 && wc != 8) return false;
  const int wr = kWarps / wc;
  if (t < 1 || wr * t > kMaxWarpTiles) return false;
  const long long rows = (long long)kTileRows * wr * t;
  const long long vb = (long long)kWarpV * wc;
  if ((long long)row_blocks * rows < B || (long long)(row_blocks - 1) * rows >= B)
    return false;
  if ((long long)v_blocks * vb < C || (long long)(v_blocks - 1) * vb >= C)
    return false;
  if (v_blocks > 65535) return false;
  // row and element indices are ints
  if ((long long)row_blocks * rows + kTileRows > 0x7fffffffLL) return false;
  return smem == smem_bytes(static_cast<int>(vb), n, p_esize,
                            rows_held(static_cast<int>(rows), B), a_esize) &&
         smem <= kSmemMax;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// v = hi + lo, hi rounded to TF32 (the tensor core reads the top 19 bits);
// lo is exact.  A value with 16 zero low bits (a widened bf16) is its own hi.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Programmatic dependent launch: a dependent grid may start once every block
// of this grid has signalled (or exited); the dependent waits for this grid's
// completion and memory before it reads what this grid writes.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// `elems` elements from global `src` into shared `dst`: 16-byte cp.async
// where `vec` (src 16-byte aligned), the bytes past the last whole 16 (the
// end of the tensor) element by element; complete after cp.async.wait_all
// and a barrier
template <typename T>
__device__ __forceinline__ void copy_span(T* dst, const T* src,
                                          long long elems, int vec, int tid) {
  long long done = 0;
  if (vec) {
    const long long n16 = elems * (long long)sizeof(T) / 16;
#pragma unroll 1
    for (long long i = tid; i < n16; i += kThreads)
      cp_async16(reinterpret_cast<unsigned char*>(dst) + 16 * i,
                 reinterpret_cast<const unsigned char*>(src) + 16 * i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    done = n16 * 16 / (long long)sizeof(T);
  }
#pragma unroll 1
  for (long long e = done + tid; e < elems; e += kThreads) dst[e] = src[e];
}

// (t0 + t1) + (t2 + t3) over the four lanes of a quad, the same bits in each
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// grid (row_blocks, v_blocks), kThreads threads; see the note at the top
template <typename TA, typename TP, int kS, bool kSplit>
__global__ void __launch_bounds__(kThreads, min_blocks<TP>())
    score_kernel(const TA* __restrict__ a, const TP* __restrict__ p,
                 float* __restrict__ out, int B, int C, int n, int chunks,
                 int wc, int t, int early, int a_vec, int p_vec,
                 int out_vec) {
  constexpr bool kALo = std::is_same<TA, float>::value;  // A has a remainder
  constexpr bool kPLo = std::is_same<TP, float>::value;  // P has a remainder
  constexpr bool kHold = kS <= kHoldSteps;               // then chunks == 1
  constexpr int kH = kHold ? kS : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int wr = kWarps / wc;
  const int rows = kTileRows * wr * t;
  const int vb = kWarpV * wc;
  const int r0 = blockIdx.x * rows;
  const int v0 = blockIdx.y * vb;
  const int cnt = min(vb, C - v0);       // profiles in this block's span
  const int nrow = min(rows, B - r0);    // rows of A in this block

  TP* ps = reinterpret_cast<TP*>(smem_raw);                 // [cnt][n]
  TA* as = reinterpret_cast<TA*>(
      smem_raw + ((size_t)vb * n * sizeof(TP) + 15) / 16 * 16);  // [nrow][n]
  float* stage = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(as) +
      ((size_t)rows_held(rows, B) * n * sizeof(TA) + 15) / 16 * 16);

  // warp (wrow, wcol), lane (gq, tq) of the MMA
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wcol = warp % wc, wrow = warp / wc;
  float* st = stage + warp * kTileRows * kStagePitch;   // [16][kStagePitch]
  const int vl = wcol * kWarpV;            // the warp's first profile
  const bool active = vl < cnt;            // warp-uniform
  // P[vl + 8 nt + gq][k] and A[r][k] as float32, zeros past C, B, n
  auto p_at = [&](int nt, int k) {
    const int vv = vl + 8 * nt + gq;
    return (vv < cnt && k < n) ? to_f32(ps[(size_t)vv * n + k]) : 0.f;
  };
  auto a_at = [&](int r, int k) {
    return (r < nrow && k < n) ? to_f32(as[(size_t)r * n + k]) : 0.f;
  };
  // the TF32 parts of a value (a bf16 operand is its own high part)
  auto split = [](float x, bool lo_part, uint32_t& hi, uint32_t& lo) {
    if (lo_part) {
      split_tf32(x, hi, lo);
    } else {
      hi = __float_as_uint(x);
      lo = 0u;
    }
  };

  // the B fragments of the warp's four n-tiles (k = 8 s + tq, + 4), held in
  // registers up to n = 32, and ||P_v||^2 of v = vl + 8 nt + gq: this lane's
  // k in order, then the quad; the epilogue's profiles 2 tq and 2 tq + 1 are
  // those of quads 2 tq and 2 tq + 1
  uint32_t ph[kH][kNT][2], pl[kH][kNT][2];
  float pq[kNT][2];
  auto p_side = [&]() {
    float sp[kNT];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) sp[nt] = 0.f;
    for (int c = 0; c < (kHold ? 1 : chunks); ++c) {
#pragma unroll
      for (int s = 0; s < kS; ++s) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = p_at(nt, (c * kS + s) * 8 + tq + 4 * e);
            sp[nt] = fmaf(x, x, sp[nt]);
            if constexpr (kHold) split(x, kPLo, ph[s][nt][e], pl[s][nt][e]);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float q = quad_sum(sp[nt]);
      pq[nt][0] = __shfl_sync(0xffffffffu, q, 8 * tq);
      pq[nt][1] = __shfl_sync(0xffffffffu, q, 8 * tq + 4);
    }
  };

  // ---- prologue: P's span, then, once the kernel before this one is done
  // (griddepcontrol.wait; at once when not launched as its dependent), A's
  // rows.  early: P lands and its fragments and norms are built before the
  // wait, under a long kernel before (bundle_sim); else the two copies
  // overlap and the fragments follow (alone, or after loghd_head's short A
  // stage, where building them first cost the decode step 1 us on an H100).
  copy_span(ps, p + (size_t)v0 * n, (long long)cnt * n, p_vec, tid);
  if (early) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (active) p_side();
  }
  wait_prerequisites();
  copy_span(as, a + (size_t)r0 * n, (long long)nrow * n, a_vec, tid);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (!active) return;
  if (!early) p_side();

  for (int tile = wrow; tile < wr * t; tile += wr) {
    const int rl = tile * kTileRows;
    if (rl >= nrow) break;
    // kSplit: the remainder products in lo and the high ones in hi (two
    // short dependency chains), added at the end; else all in hi (lo stays
    // 0), which leaves registers for three blocks an SM
    float lo[kNT][4], hi[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) lo[nt][e] = hi[nt][e] = 0.f;
    float sa0 = 0.f, sa1 = 0.f;   // ||A||^2 of rows rl + gq, rl + gq + 8
    for (int c = 0; c < chunks; ++c) {
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int k0 = (c * kS + s) * 8 + tq;
        const float av[4] = {a_at(rl + gq, k0), a_at(rl + gq + 8, k0),
                             a_at(rl + gq, k0 + 4), a_at(rl + gq + 8, k0 + 4)};
        sa0 = fmaf(av[0], av[0], sa0);
        sa0 = fmaf(av[2], av[2], sa0);
        sa1 = fmaf(av[1], av[1], sa1);
        sa1 = fmaf(av[3], av[3], sa1);
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(av[e], kALo, ah[e], al[e]);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          uint32_t bh[2], bl[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (kHold) {
              bh[e] = ph[s][nt][e];
              bl[e] = pl[s][nt][e];
            } else {
              split(p_at(nt, k0 + 4 * e), kPLo, bh[e], bl[e]);
            }
          }
          float(&rem)[4] = kSplit ? lo[nt] : hi[nt];
          if constexpr (kALo) mma8(rem, al, bh[0], bh[1]);
          if constexpr (kPLo) mma8(rem, ah, bl[0], bl[1]);
          mma8(hi[nt], ah, bh[0], bh[1]);
        }
      }
    }
    // ---- epilogue: 2 (lo + hi, or hi) - ||P||^2 - ||A||^2 of rows rl + gq
    // (entries 0, 1) and rl + gq + 8 (2, 3), profiles 8 nt + 2 tq (+ 1),
    // into this warp's staging tile, then out by whole rows
    const float a0 = quad_sum(sa0), a1 = quad_sum(sa1);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = kSplit ? lo[nt][e] + hi[nt][e] : hi[nt][e];
      const int col = 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(st + gq * kStagePitch + col) =
          make_float2(2.f * d[0] - pq[nt][0] - a0, 2.f * d[1] - pq[nt][1] - a0);
      *reinterpret_cast<float2*>(st + (gq + 8) * kStagePitch + col) =
          make_float2(2.f * d[2] - pq[nt][0] - a1, 2.f * d[3] - pq[nt][1] - a1);
    }
    __syncwarp();
    const int rhere = min(kTileRows, B - (r0 + rl));
    const int chere = min(kWarpV, C - (v0 + vl));
    float* orow = out + (size_t)(r0 + rl) * C + v0 + vl;
    if (out_vec) {
      // 8 lanes a row, 16 bytes each: 4 rows of 128 bytes a store
#pragma unroll
      for (int i = 0; i < kTileRows / 4; ++i) {
        const int r = 4 * i + (lane >> 3), c = 4 * (lane & 7);
        if (r < rhere && c < chere)
          __stcs(reinterpret_cast<float4*>(orow + (size_t)r * C + c),
                 *reinterpret_cast<const float4*>(st + r * kStagePitch + c));
      }
    } else {
      // a row a store, 4 bytes a lane
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
        if (r < rhere && lane < chere)
          orow[(size_t)r * C + lane] = st[r * kStagePitch + lane];
    }
    __syncwarp();
  }
}

template <typename TA, typename TP, int kS, bool kSplit>
cudaError_t allow_smem() {
  // per host thread, a bit per device whose kernel took the attribute
  thread_local unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(score_kernel<TA, TP, kS, kSplit>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

// blocks of this kernel with `smem` bytes the current device holds at once
// (blocks per SM x SMs); a negative cudaError_t on error
template <typename TA, typename TP, int kS, bool kSplit>
int capacity(int smem) {
  cudaError_t err = allow_smem<TA, TP, kS, kSplit>();
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, score_kernel<TA, TP, kS, kSplit>, kThreads, smem);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// One launch on `s`; with `pdl` set, as a programmatic dependent of the
// kernel before it on the stream (its prologue reads only P), building P's
// fragments before the wait where `early`.  The arguments passed
// score::valid.
template <typename TA, typename TP, int kS, bool kSplit>
cudaError_t launch(const TA* a, const TP* p, float* out, int B, int C, int n,
                   int chunks, int wc, int t, int row_blocks, int v_blocks,
                   int smem, int pdl, int early, cudaStream_t s) {
  cudaError_t err = allow_smem<TA, TP, kS, kSplit>();
  if (err != cudaSuccess) return err;
  const int a_vec = reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int p_vec = reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const int out_vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_blocks, v_blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, score_kernel<TA, TP, kS, kSplit>, a, p, out,
                           B, C, n, chunks, wc, t, early, a_vec, p_vec,
                           out_vec);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace score

// the compiled k-steps of a chunk (score::steps_for)
#define SCORE_STEPS(X) X(2) X(3) X(4) X(8)
