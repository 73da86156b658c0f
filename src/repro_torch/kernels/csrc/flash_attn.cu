// flash_attn: fused causal attention, forward and backward, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package leaves attention to XLA as
// jnp einsums (src/repro/models/attention.py:107, _sdpa), and the port
// followed it line by line: each 512-query chunk materialised its (B, H,
// 512, T) logits in float32, masked the full square with a `where`,
// softmaxed and cast them, and ran under its own checkpoint, so every pass
// made the same float32 round trips through device memory.  This file
// computes the same function with nothing of size S x T leaving the chip:
//   o[b, i, h] = sum_j p_ij v[b, j, h / g],
//   p_ij = softmax_j(scale q[b, i, h] . k[b, j, h / g]) over keys j with
//   j <= q0 + i (causal) and j < T,
// for q (B, S, H, d), k (B, T, KVH, d), v (B, T, KVH, dv), g = H / KVH,
// bf16 in and out, and the gradients dq, dk, dv of a loss through o.
//
// What bounds it on the H100.  The causal core is 2 B H S T (d + dv) / 2
// multiply-adds forward and about 2.5 times that backward, all on the
// tensor cores: at granite's training shape (8 x 4,096, 16 heads of 64)
// 2.75e11 flops a layer forward, 0.28 ms at 989 TFLOP/s; the bytes (q, k,
// v, o once) are 50 MB, 15 us at 3.35 TB/s.  So the kernel is bound by
// operations, and what stands between it and that bound is keeping the
// tensor cores fed: the scores and the softmax statistics stay in
// registers, the tiles arrive by TMA while the previous ones are in use,
// and no tile above the causal diagonal is loaded.
//
// The forward: one block a (128-query tile, query head, batch row), 384
// threads in three warpgroups.  Warpgroup 2 is the producer: one thread
// issues TMA copies (128-byte swizzle, rows past the tensor arrive as
// zeros) of the q tile once and of the k / v tiles of 128 keys into a ring
// of two stages, each guarded by a full and an empty mbarrier.  The
// consumers, warpgroups 0 and 1, take 64 query rows each: S = Q K^T by
// wgmma from shared memory into float32 registers, the online softmax in
// base 2 with the scale times log2 e folded into one multiply, P rounded to
// bf16 in registers and fed as the register operand of the P V wgmma.
// Only tiles that reach past the diagonal or past T are masked.  The
// epilogue writes o in bf16 straight into the (B, S, H * dv) layout that
// the output projection reads, and the log-sum-exp in float32 as (B, H,
// S_pad).  Query heads of one group are adjacent in the grid, so their
// k / v tiles are read from L2; the longest (last) query tiles go first.
//
// The backward: a pass computes delta = rowsum(dO * O) in float32.  The
// main kernel runs one block a (128-key tile, KV head, batch row): the
// producer copies k and v once, then for each query head of the group and
// each 64-query tile from the diagonal down, q, dO and the tile's lse and
// delta into a two-stage ring.  Each consumer warpgroup owns 64 keys and
// computes S^T = K Q^T and dP^T = V dO^T, recomputes P^T from the saved
// lse, dS^T = P^T (dP^T - delta) scale in float32, then dV += P^T dO and
// dK += dS^T Q with P^T and dS^T rounded to bf16 as register operands; dK
// and dV stay in registers over the whole group and are written once, no
// atomics.  dS^T goes through shared memory (double-buffered, swizzled as
// TMA would) for dQ^T = K^T dS^T, each warpgroup half of the tile's
// queries, staged as a float32 tile and added into a float32 (B, S, H, d)
// workspace by a TMA reduce-add; the wrapper rounds it to bf16 once at the
// end.
//
// Every product is m64n64k16 in bf16 with float32 accumulators (dQ's
// m64n32k16); larger widths issue several.  Instantiated widths (d, dv): (64, 64), (128,
// 128), (192, 128); ops.py sends other widths to the einsum path.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;   // two consumer warpgroups and a producer
constexpr int kBM = 128;        // forward: query rows a block
constexpr int kBN = 128;        // key rows a tile (forward) / a block (backward)
constexpr int kBQ = 64;         // backward: query rows a step
constexpr int kStages = 2;
constexpr int kBox = 64 * 2;    // bytes of a row of one 64-column box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// a wait whose bytes never arrive traps (a launch error) instead of
// hanging the card; a sound wait ends in microseconds
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 22)) __trap();
  }
}

// the box at coordinates (c0, c1, c2, c3) of a 4-D tensor map into dst
__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, int c3,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a tile stored as TMA's 128-byte swizzle writes it:
// rows of 128 bytes (64 bf16), 8-row groups 1,024 bytes apart.  K-major
// operands step along K by 32 bytes inside a row; MN-major ones (64 wide in
// MN, so the leading offset is never crossed) step along K by 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) |
         ((uint64_t)(1024 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// the descriptor of the operand `bytes` past the one `base` describes
__device__ __forceinline__ uint64_t desc_at(uint64_t base, int bytes) {
  return base + (uint64_t)(bytes >> 4);
}
// each iteration's descriptor bases, opaque to the compiler: it forms each
// operand's descriptor where the product is issued instead of keeping
// dozens of loop-invariant ones live in registers
__device__ __forceinline__ void opaque(uint64_t& d) {
  asm volatile("" : "+l"(d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulators across an asynchronous wgmma
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OUT32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64 a warpgroup) (+)= A B over 16 of K, both operands in shared
// memory; kTA / kTB = 1 for an MN-major operand
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));
}
// the same at 32 columns (d: 64 x 32 a warpgroup)
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));
}
// the same with A from registers: the m16n8k16 A fragment of each warp's
// 16 rows, two bf16 a register
template <int kTB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(kTB));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// the register A operand of one k16 step from a 64 x 64 accumulator: its
// columns 16 kk .. 16 kk + 15
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&d)[32],
                                       int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

struct FwdArgs {
  bf16* o;        // (B, S, H * dv)
  float* lse;     // (B, H, s_pad)
  int S, T, H, groups, q0, causal, s_pad;
  float scale_log2;   // scale * log2 e
};

template <int D, int DV>
struct FwdSmem {
  static constexpr int kQ = kBM * D * 2;
  static constexpr int kK = kBN * D * 2;
  static constexpr int kV = kBN * DV * 2;
  static constexpr int kBars = kQ + kStages * (kK + kV);
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, FwdArgs a) {
  using L = FwdSmem<D, DV>;
  constexpr int KD = D / 64, KV = DV / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* sq = sm;
  uint8_t* sk = sm + L::kQ;                     // [stage][KD][kBN rows]
  uint8_t* sv = sk + kStages * L::kK;           // [stage][KV][kBN rows]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int h = blockIdx.x, b = blockIdx.z;
  const int qs = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int kvh = h / a.groups;
  const int kv_end = a.causal ? min(a.T, a.q0 + qs + kBM) : a.T;
  const int n_kv = kv_end > 0 ? (kv_end + kBN - 1) / kBN : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      mbar_expect(qbar, L::kQ);
      for (int c = 0; c < KD; ++c)
        tma_4d(sq + c * kBM * kBox, &mq, c * 64, h, qs, b, qbar);
      for (int i = 0; i < n_kv; ++i) {
        const int s = i % kStages, u = i / kStages;
        if (u > 0) mbar_wait(&empty[s], (u - 1) & 1);
        mbar_expect(&full[s], L::kK + L::kV);
        uint8_t* dk = sk + s * L::kK;
        uint8_t* dv = sv + s * L::kV;
        for (int c = 0; c < KD; ++c)
          tma_4d(dk + c * kBN * kBox, &mk, c * 64, kvh, i * kBN, b, &full[s]);
        for (int c = 0; c < KV; ++c)
          tma_4d(dv + c * kBN * kBox, &mv, c * 64, kvh, i * kBN, b, &full[s]);
      }
    }
    return;
  }
  reg_alloc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int r0 = qs + wg * 64 + warp * 16 + lane / 4;   // rows r0, r0 + 8
  const int cq = 2 * (lane % 4);                        // column in an 8-group
  float o[KV][32];
#pragma unroll
  for (int n = 0; n < KV; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  mbar_wait(qbar, 0);

  for (int it = 0; it < n_kv; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint8_t* tk = sk + s * L::kK;
    const uint8_t* tv = sv + s * L::kV;
    float sc[2][32];
#pragma unroll
    for (int n = 0; n < 2; ++n) pin(sc[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = sw128_desc(sq + (kk / 4) * kBM * kBox +
                                     wg * 64 * kBox + (kk % 4) * 32);
#pragma unroll
      for (int n = 0; n < 2; ++n)
        wgmma_ss<0, 0>(sc[n], da,
                       sw128_desc(tk + (kk / 4) * kBN * kBox +
                                  n * 64 * kBox + (kk % 4) * 32),
                       kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int n = 0; n < 2; ++n) pin(sc[n]);

    const int ks = it * kBN;
    if (ks + kBN > a.T || (a.causal && ks + kBN - 1 > a.q0 + qs + wg * 64)) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = ks + n * 64 + 8 * (i / 4) + cq + (i & 1);
          const int row = r0 + ((i & 2) ? 8 : 0);
          if (col >= a.T || (a.causal && col > a.q0 + row))
            sc[n][i] = -INFINITY;
        }
    }
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x0 = fmaxf(x0, fmaxf(sc[n][4 * j], sc[n][4 * j + 1]));
        x1 = fmaxf(x1, fmaxf(sc[n][4 * j + 2], sc[n][4 * j + 3]));
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
    }
    const float n0 = fmaxf(m0, x0 * a.scale_log2);
    const float n1 = fmaxf(m1, x1 * a.scale_log2);
    // a row with nothing visible yet keeps its zeros
    const float b0 = n0 == -INFINITY ? 0.f : n0;
    const float b1 = n1 == -INFINITY ? 0.f : n1;
    const float al0 = ex2(m0 - b0), al1 = ex2(m1 - b1);
    m0 = n0, m1 = n1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[n][4 * j] = ex2(fmaf(sc[n][4 * j], a.scale_log2, -b0));
        sc[n][4 * j + 1] = ex2(fmaf(sc[n][4 * j + 1], a.scale_log2, -b0));
        sc[n][4 * j + 2] = ex2(fmaf(sc[n][4 * j + 2], a.scale_log2, -b1));
        sc[n][4 * j + 3] = ex2(fmaf(sc[n][4 * j + 3], a.scale_log2, -b1));
        s0 += sc[n][4 * j] + sc[n][4 * j + 1];
        s1 += sc[n][4 * j + 2] + sc[n][4 * j + 3];
      }
    l0 = l0 * al0 + s0;
    l1 = l1 * al1 + s1;
#pragma unroll
    for (int n = 0; n < KV; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[n][4 * j] *= al0, o[n][4 * j + 1] *= al0;
        o[n][4 * j + 2] *= al1, o[n][4 * j + 3] *= al1;
      }
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) a_frag(pa[kk], sc[kk / 4], kk % 4);
#pragma unroll
    for (int n = 0; n < KV; ++n) pin(o[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int n = 0; n < KV; ++n)
        wgmma_rs<1>(o[n], pa[kk],
                    sw128_desc(tv + n * kBN * kBox + kk * 16 * kBox));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int n = 0; n < KV; ++n) pin(o[n]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float i1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const long long ld = (long long)a.H * DV;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= a.S) continue;
    const float inv = half ? i1 : i0;
    bf16* out = a.o + ((long long)b * a.S + row) * ld + (long long)h * DV;
#pragma unroll
    for (int n = 0; n < KV; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(out + n * 64 + 8 * j + cq) =
            pack_bf16(o[n][4 * j + 2 * half] * inv,
                      o[n][4 * j + 2 * half + 1] * inv);
    if ((lane & 3) == 0) {
      const float m = half ? m1 : m0, l = half ? l1 : l0;
      a.lse[((long long)b * a.H + h) * a.s_pad + row] =
          l > 0.f ? (m + __log2f(l)) * kLn2 : -INFINITY;
    }
  }
}

// delta[b, h, s] = sum_e dO[b, s, h, e] O[b, s, h, e] in float32, one warp
// a row; rows s in [S, s_pad) get 0
template <int DV>
__global__ void delta_kernel(const bf16* __restrict__ dout, long long dsb,
                             long long dss, long long dsh,
                             const bf16* __restrict__ out, float* delta,
                             int B, int S, int H, int s_pad) {
  const long long rows = (long long)B * H * s_pad;
  const int lane = threadIdx.x % 32;
  for (long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / 32;
       r < rows; r += (long long)gridDim.x * blockDim.x / 32) {
    const int s = r % s_pad;
    const int h = (r / s_pad) % H;
    const int b = r / ((long long)s_pad * H);
    float acc = 0.f;
    if (s < S) {
      const bf16* g = dout + b * dsb + s * dss + h * dsh;
      const bf16* o = out + (((long long)b * S + s) * H + h) * DV;
      for (int e = 2 * lane; e < DV; e += 64) {
        const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(g + e);
        const __nv_bfloat162 ov = *reinterpret_cast<const __nv_bfloat162*>(o + e);
        acc += __bfloat162float(gv.x) * __bfloat162float(ov.x) +
               __bfloat162float(gv.y) * __bfloat162float(ov.y);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) delta[r] = acc;
  }
}

struct BwdArgs {
  bf16* dk;       // (B, T, KVH, d)
  bf16* dv;       // (B, T, KVH, dv)
  int S, T, H, KVH, groups, q0, causal;
  float scale_log2, scale;
};

template <int D, int DV>
struct BwdSmem {
  static constexpr int kK = kBN * D * 2;
  static constexpr int kV = kBN * DV * 2;
  static constexpr int kQ = kBQ * D * 2;
  static constexpr int kO = kBQ * DV * 2;
  static constexpr int kStage = kQ + kO;            // q and dO boxes
  static constexpr int kRows = 2 * kBQ * 4;         // lse and delta
  static constexpr int kLoad = kStage + kRows;      // a stage's bytes
  static constexpr int kDs = kBN * kBQ * 2;         // dS^T, bf16
  static constexpr int kDq = kBQ / 2 * 64 * 4;      // a dQ tile, float32
  static constexpr int kRowsAt = kK + kV + kStages * kStage + 2 * kDs +
                                 2 * kDq;
  static constexpr int kBars = kRowsAt + kStages * kRows;
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_kernel(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv,
               const __grid_constant__ CUtensorMap mdo,
               const __grid_constant__ CUtensorMap mlse,
               const __grid_constant__ CUtensorMap mdelta,
               const __grid_constant__ CUtensorMap mdq, BwdArgs a) {
  using L = BwdSmem<D, DV>;
  constexpr int KD = D / 64, KV = DV / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* sk = sm;                       // [KD][kBN rows]
  uint8_t* sv = sk + L::kK;               // [KV][kBN rows]
  uint8_t* st = sv + L::kV;               // stages: q [KD], dO [KV]
  uint8_t* sds = st + kStages * L::kStage;   // [2][kBN rows x 64 queries]
  uint8_t* sdq = sds + 2 * L::kDs;        // [warpgroup][32 queries x 64]
  uint8_t* srows = sm + L::kRowsAt;       // stages: lse, delta
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int kvh = blockIdx.x, b = blockIdx.z;
  const int ks = blockIdx.y * kBN;
  const int n_qt = (a.S + kBQ - 1) / kBQ;
  const int i_min = a.causal ? max(0, ks - a.q0) : 0;
  const int qt0 = i_min < a.S ? i_min / kBQ : n_qt;
  const int per_head = n_qt - qt0;
  const int n_it = a.groups * per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      mbar_expect(kvbar, L::kK + L::kV);
      for (int c = 0; c < KD; ++c)
        tma_4d(sk + c * kBN * kBox, &mk, c * 64, kvh, ks, b, kvbar);
      for (int c = 0; c < KV; ++c)
        tma_4d(sv + c * kBN * kBox, &mv, c * 64, kvh, ks, b, kvbar);
      for (int i = 0; i < n_it; ++i) {
        const int s = i % kStages, u = i / kStages;
        const int h = kvh * a.groups + i / per_head;
        const int q = (qt0 + i % per_head) * kBQ;
        if (u > 0) mbar_wait(&empty[s], (u - 1) & 1);
        mbar_expect(&full[s], L::kLoad);
        uint8_t* t = st + s * L::kStage;
        for (int c = 0; c < KD; ++c)
          tma_4d(t + c * kBQ * kBox, &mq, c * 64, h, q, b, &full[s]);
        for (int c = 0; c < KV; ++c)
          tma_4d(t + L::kQ + c * kBQ * kBox, &mdo, c * 64, h, q, b,
                 &full[s]);
        const int row = b * a.H + h;
        tma_2d(srows + s * L::kRows, &mlse, q, row, &full[s]);
        tma_2d(srows + s * L::kRows + kBQ * 4, &mdelta, q, row, &full[s]);
      }
    }
    return;
  }
  reg_alloc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int rl = wg * 64 + warp * 16 + lane / 4;   // key rows rl, rl + 8 of the tile
  const int cq = 2 * (lane % 4);
  float dk[KD][32], dv[KV][32];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[n][i] = 0.f;
#pragma unroll
  for (int n = 0; n < KV; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[n][i] = 0.f;
  mbar_wait(kvbar, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int h = kvh * a.groups + it / per_head;
    const int qs = (qt0 + it % per_head) * kBQ;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint8_t* tq = st + s * L::kStage;
    const uint8_t* tdo = tq + L::kQ;
    const float* tl = reinterpret_cast<const float*>(srows + s * L::kRows);
    const float* td = tl + kBQ;
    uint64_t gk = sw128_desc(sk + wg * 64 * kBox);
    uint64_t gv = sw128_desc(sv + wg * 64 * kBox);
    uint64_t gq = sw128_desc(tq), go = sw128_desc(tdo);
    opaque(gk), opaque(gv), opaque(gq), opaque(go);
    float p[32], ds[32];
    pin(p);
    pin(ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(p, desc_at(gk, (kk / 4) * kBN * kBox + (kk % 4) * 32),
                     desc_at(gq, (kk / 4) * kBQ * kBox + (kk % 4) * 32),
                     kk > 0);
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      wgmma_ss<0, 0>(ds, desc_at(gv, (kk / 4) * kBN * kBox + (kk % 4) * 32),
                     desc_at(go, (kk / 4) * kBQ * kBox + (kk % 4) * 32),
                     kk > 0);
    wgmma_commit();
    wgmma_wait0();
    pin(p);
    pin(ds);

    // P^T and dS^T: row = key ks + rl (+ 8), column = query qs + c; each
    // pair of columns packed at once into the bf16 A operands of the dV
    // and dK products, so that the float32 tiles die as they are read
    const bool edge = ks + kBN > a.T || qs + kBQ > a.S ||
                      (a.causal && ks + kBN - 1 > a.q0 + qs);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + cq;   // queries c, c + 1 of this 8-column group
      const float2 lse = *reinterpret_cast<const float2*>(tl + c);
      const float2 dlt = *reinterpret_cast<const float2*>(td + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * j + 2 * half;
        float pv[2], dv2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = ex2(fmaf(p[i + e], a.scale_log2,
                             -(e ? lse.y : lse.x) * kLog2e));
          if (edge) {
            const int key = ks + rl + 8 * half, qry = qs + c + e;
            if (key >= a.T || qry >= a.S || (a.causal && key > a.q0 + qry))
              x = 0.f;
          }
          pv[e] = x;
          dv2[e] = x == 0.f ? 0.f
                            : x * (ds[i + e] - (e ? dlt.y : dlt.x)) * a.scale;
        }
        pa[j / 2][(j & 1) * 2 + half] = pack_bf16(pv[0], pv[1]);
        da[j / 2][(j & 1) * 2 + half] = pack_bf16(dv2[0], dv2[1]);
      }
    }
    // dS^T (keys x 64 queries) into shared memory in the 128-byte swizzle,
    // before the products that read its registers are issued
    uint8_t* dsb = sds + (it & 1) * L::kDs;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rl + 8 * half;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dsb + r * kBox + ((j ^ (r & 7)) << 4) +
                                     cq * 2) =
            da[j / 2][(j & 1) * 2 + half];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
    for (int n = 0; n < KV; ++n) pin(dv[n]);
#pragma unroll
    for (int n = 0; n < KD; ++n) pin(dk[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < KV; ++n)
        wgmma_rs<1>(dv[n], pa[kk],
                    desc_at(go, n * kBQ * kBox + kk * 16 * kBox));
#pragma unroll
      for (int n = 0; n < KD; ++n)
        wgmma_rs<1>(dk[n], da[kk],
                    desc_at(gq, n * kBQ * kBox + kk * 16 * kBox));
    }
    wgmma_commit();
    // their register operands are free once they end, before dQ's
    // accumulators are live; the stage is read no more
    wgmma_wait0();
    if (lane == 0) mbar_arrive(&empty[s]);
    bar_sync(1, 256);

    // dQ^T = K^T dS^T over all 128 keys: warpgroup wg takes queries 32 wg
    // .. 32 wg + 31 of the tile (B starts half-way along dS^T's 128-byte
    // rows), 64 columns of d at a time, staged as a (32 queries x 64)
    // float32 tile and added into dq by one TMA reduction (rows past S
    // dropped by the copy)
    float* tile = reinterpret_cast<float*>(sdq + wg * L::kDq);
#pragma unroll
    for (int m = 0; m < KD; ++m) {
      float dq[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) dq[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(dq[i])::"memory");
      wgmma_fence();
      uint64_t gt = sw128_desc(sk + m * kBN * kBox);
      uint64_t gs = sw128_desc(dsb + wg * 64);
      opaque(gt), opaque(gs);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_ss32<1, 1>(dq, desc_at(gt, kk * 16 * kBox),
                         desc_at(gs, kk * 16 * kBox), 1);
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(dq[i])::"memory");
      // the previous reduction has read the tile
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      bar_sync(2 + wg, 128);
      // element (d = warp 16 + lane / 4 (+ 8), query) at [query][d]
#pragma unroll
      for (int i = 0; i < 16; ++i)
        tile[(8 * (i / 4) + cq + (i & 1)) * 64 + warp * 16 + lane / 4 +
             ((i & 2) ? 8 : 0)] = dq[i];
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(2 + wg, 128);
      if (tid == 0) {
        asm volatile(
            "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
            " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                reinterpret_cast<uint64_t>(&mdq)),
            "r"(smem_u32(tile)), "r"(m * 64), "r"(h), "r"(qs + 32 * wg),
            "r"(b)
            : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
#pragma unroll
    for (int n = 0; n < KV; ++n) pin(dv[n]);
#pragma unroll
    for (int n = 0; n < KD; ++n) pin(dk[n]);
  }
  // the reductions have finished with shared memory
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

  // dK and dV, bf16, rows past T dropped
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = ks + rl + 8 * half;
    if (key >= a.T) continue;
    const long long row = ((long long)b * a.T + key) * a.KVH + kvh;
    bf16* ok = a.dk + row * D;
    bf16* ov = a.dv + row * DV;
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(ok + n * 64 + 8 * j + cq) =
            pack_bf16(dk[n][4 * j + 2 * half], dk[n][4 * j + 2 * half + 1]);
#pragma unroll
    for (int n = 0; n < KV; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(ov + n * 64 + 8 * j + cq) =
            pack_bf16(dv[n][4 * j + 2 * half], dv[n][4 * j + 2 * half + 1]);
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library links only the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault);
    if (err != cudaSuccess) return err;
    if (fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// a (B, L, heads, width) tensor with element strides (sb, sl, sh, 1), read
// (bf16, 128-byte swizzle) or reduced into (float32, dense) in boxes of
// (64 columns, 1 head, rows, 1); rows past L read as zeros and are not
// written
cudaError_t heads_map(CUtensorMap* map, const void* p, int B, int L,
                      int heads, int width, long long sb, long long sl,
                      long long sh, int rows, bool f32 = false) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                              (cuuint64_t)L, (cuuint64_t)B};
  const int es = f32 ? 4 : 2;
  const cuuint64_t strides[3] = {(cuuint64_t)sh * es, (cuuint64_t)sl * es,
                                 (cuuint64_t)sb * es};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(p), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a (rows, s_pad) float32 matrix read in boxes of 64 columns of one row
cudaError_t rows_map(CUtensorMap* map, const void* p, int rows, int s_pad) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)s_pad, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)s_pad * 4};
  const cuuint32_t box[2] = {kBQ, 1};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes, unsigned* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (*done >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 32) *done |= 1u << dev;
  return err;
}

template <int D, int DV>
cudaError_t launch_fwd(const CUtensorMap& mq, const CUtensorMap& mk,
                       const CUtensorMap& mv, const FwdArgs& a, int B,
                       cudaStream_t s) {
  thread_local unsigned done = 0;
  const int bytes = FwdSmem<D, DV>::kBytes;
  cudaError_t err = set_smem(fwd_kernel<D, DV>, bytes, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, (a.S + kBM - 1) / kBM, B);
  fwd_kernel<D, DV><<<grid, kThreads, bytes, s>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_bwd(const CUtensorMap* maps, const BwdArgs& a, int B,
                       cudaStream_t s) {
  thread_local unsigned done = 0;
  const int bytes = BwdSmem<D, DV>::kBytes;
  cudaError_t err = set_smem(bwd_kernel<D, DV>, bytes, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.KVH, (a.T + kBN - 1) / kBN, B);
  bwd_kernel<D, DV><<<grid, kThreads, bytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], a);
  return cudaGetLastError();
}

bool pair_ok(int d, int dv) {
  return (d == 64 && dv == 64) || (d == 128 && dv == 128) ||
         (d == 192 && dv == 128);
}

}  // namespace

// q (B, S, H, d), k (B, T, KVH, d), v (B, T, KVH, dv) bf16 with element
// strides (b, s, h) and the last dimension contiguous, each stride a
// multiple of 8 elements and each pointer 16-byte aligned; o (B, S, H * dv)
// bf16 and lse (B, H, s_pad) float32, contiguous.  Query i sees key j iff
// j < T and, when causal, j <= q0 + i.  Returns the cudaError_t (0 on
// success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int S, int T, int H,
                              int KVH, int d, int dv, long long qsb,
                              long long qss, long long qsh, long long ksb,
                              long long kss, long long ksh, long long vsb,
                              long long vss, long long vsh, int q0,
                              int causal, float scale, int s_pad,
                              void* stream) {
  if (!pair_ok(d, dv) || B < 1 || S < 1 || T < 1 || KVH < 1 || H % KVH ||
      s_pad < S || s_pad % 4 || q0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  cudaError_t err = heads_map(&mq, q, B, S, H, d, qsb, qss, qsh, kBM);
  if (err == cudaSuccess)
    err = heads_map(&mk, k, B, T, KVH, d, ksb, kss, ksh, kBN);
  if (err == cudaSuccess)
    err = heads_map(&mv, v, B, T, KVH, dv, vsb, vss, vsh, kBN);
  if (err != cudaSuccess) return static_cast<int>(err);
  FwdArgs a;
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.S = S, a.T = T, a.H = H, a.groups = H / KVH, a.q0 = q0;
  a.causal = causal, a.s_pad = s_pad, a.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) err = launch_fwd<64, 64>(mq, mk, mv, a, B, s);
  else if (d == 128) err = launch_fwd<128, 128>(mq, mk, mv, a, B, s);
  else err = launch_fwd<192, 128>(mq, mk, mv, a, B, s);
  return static_cast<int>(err);
}

// The gradients of flash_attn_fwd's o: dout (B, S, H * dv) bf16 with
// element strides (b, s, h) as q's; o and lse as the forward wrote them;
// delta (B, H, s_pad) float32 scratch; dq (B, S, H, d) float32, zeroed,
// summed into; dk (B, T, KVH, d) and dv (B, T, KVH, dv) bf16, written.
// Two launches: delta, then the main kernel.
extern "C" int flash_attn_bwd(const void* dout, const void* q, const void* k,
                              const void* v, const void* o, const void* lse,
                              void* delta, void* dq, void* dk, void* dv,
                              int B, int S, int T, int H, int KVH, int d,
                              int dvw, long long dsb, long long dss,
                              long long dsh, long long qsb, long long qss,
                              long long qsh, long long ksb, long long kss,
                              long long ksh, long long vsb, long long vss,
                              long long vsh, int q0, int causal, float scale,
                              int s_pad, void* stream) {
  if (!pair_ok(d, dvw) || B < 1 || S < 1 || T < 1 || KVH < 1 || H % KVH ||
      s_pad < S || s_pad % 4 || q0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * H * s_pad;
  const long long want = (rows + 7) / 8;   // 8 warps a block, a row each
  const int blocks = (int)(want < 132LL * 16 ? want : 132LL * 16);
  const bf16* g = static_cast<const bf16*>(dout);
  const bf16* op = static_cast<const bf16*>(o);
  float* dl = static_cast<float*>(delta);
  if (dvw == 64)
    delta_kernel<64><<<blocks, 256, 0, s>>>(g, dsb, dss, dsh, op, dl, B, S,
                                            H, s_pad);
  else
    delta_kernel<128><<<blocks, 256, 0, s>>>(g, dsb, dss, dsh, op, dl, B, S,
                                             H, s_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[7];
  err = heads_map(&maps[0], q, B, S, H, d, qsb, qss, qsh, kBQ);
  if (err == cudaSuccess)
    err = heads_map(&maps[1], k, B, T, KVH, d, ksb, kss, ksh, kBN);
  if (err == cudaSuccess)
    err = heads_map(&maps[2], v, B, T, KVH, dvw, vsb, vss, vsh, kBN);
  if (err == cudaSuccess)
    err = heads_map(&maps[3], dout, B, S, H, dvw, dsb, dss, dsh, kBQ);
  if (err == cudaSuccess) err = rows_map(&maps[4], lse, B * H, s_pad);
  if (err == cudaSuccess) err = rows_map(&maps[5], delta, B * H, s_pad);
  if (err == cudaSuccess)
    err = heads_map(&maps[6], dq, B, S, H, d, (long long)S * H * d,
                    (long long)H * d, d, kBQ / 2, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  BwdArgs a;
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.S = S, a.T = T, a.H = H, a.KVH = KVH, a.groups = H / KVH, a.q0 = q0;
  a.causal = causal, a.scale_log2 = scale * kLog2e, a.scale = scale;
  if (d == 64) err = launch_bwd<64, 64>(maps, a, B, s);
  else if (d == 128) err = launch_bwd<128, 128>(maps, a, B, s);
  else err = launch_bwd<192, 128>(maps, a, B, s);
  return static_cast<int>(err);
}
