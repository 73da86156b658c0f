// bundle_sim: batched query x bundle cosine similarity for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/bundle_sim/bundle_sim.py:bundle_sim_pallas (body _kernel)
// and computes the same function:
//   A[b, j] = <h_b, M_j> * rsqrt(||h_b||^2 + 1e-12)
// for queries h (B, D) in float32 or bfloat16 and pre-normalised bundles
// M (n, D) in float32, with float32 accumulation.  Output (B, n) float32.
// It is every predict of the four families, every re-predict of the sweep
// and every serving cycle (api/dispatch.py `_activations`).
//
// What bounds it on the H100.  Device-memory bytes: at the predict batch
// (B = 1,559, D = 10,000) h is 62 MB against M's 0.4-1 MB, so the bound is
// 18.8 us.  At a serving bucket (B <= 64) the bound is under 1.1 us and the
// call is latency: what matters is how many SMs it reaches.  What stood
// between the first kernel (one block per 8 rows, 40 serial tiles of D) and
// those bounds: 8 blocks on 132 SMs at B = 64, one 4-byte load a lane in
// flight, and M read from shared memory once per element of h.  Costs that
// showed on the way here (PERF.md section 6): 16-byte shared-memory loads
// cost a warp 4 cycles even when its lanes share the address, so a SIMT
// kernel that reads M for every row saturates shared memory; copies issued
// by the computing warps stall them (cp.async) and one warp cannot issue
// enough of them; TMA boxes of 128-byte rows stream slower than 1 KB rows;
// a cluster barrier that releases memory waits about a microsecond for
// the block's global stores under load; and mma.sync in TF32 runs near a
// quarter of the tensor cores' wgmma rate, so 3xTF32 is what bounds n = 26.
//
// Design.
//  - A row's dot products and its ||h||^2 are split along D over a
//    thread-block cluster of S <= 8 blocks: block rank r owns the columns
//    [r chunk, (r + 1) chunk), and chunk and S follow from D alone.  At
//    B = 64 that is 4 row tiles x 8 ranks = 32 blocks (was 8); at B = 1,
//    8 blocks (was 1).
//  - A block keeps its chunk of kC bundles of M in shared memory, and its
//    cluster walks row tiles g, g + G, ... of 16 rows (G clusters, as many
//    as the card holds at once), so M crosses from L2 once per block.
//  - One producer warp brings h in by TMA, one box of 16 rows x 256
//    columns a stage (a tensor map a call, cached for a repeated pointer;
//    zeros past B and D), in a ring of 2-4 stages with full / empty
//    mbarriers, so up to 64 KB of h is in flight per SM and the stream runs
//    on across tile boundaries; with the first tile's passes it brings this
//    block's M in boxes of kC bundles x 32 columns with TMA's 128-byte
//    swizzle.  Where D or a pointer rules TMA out, the producer's lanes
//    load and store the same layouts themselves.
//  - Eight consumer warps compute on the tensor cores in 3xTF32
//    (mma.sync.m16n8k8.tf32; each operand split into a TF32 high part and
//    its remainder, lo*hi, hi*lo and hi*hi into separate float32
//    accumulators), which keeps float32 accuracy to about 2^-21 relative
//    per product.  Warp w takes columns [32 w, 32 w + 32) of every pass,
//    all 16 rows and all kC bundles: each value of h and of M is read from
//    shared memory once per warp, and every (row, bundle) sum sits in one
//    lane.  MMA row (and bundle column) g stands for tile row (and bundle)
//    pi(g), which with the swizzle keeps M's loads free of bank conflicts.
//    When kC % 8 == 2 (n = 10, 26) the last 2 bundles are done in float32
//    FMAs on the same registers of h instead of a mostly empty n-tile.
//  - At the end of a tile the 4 lanes of a row sum its ||h||^2 (and the
//    FMA bundles) by shuffles, warps w and w + 4 add their partials, the
//    four pairs are added in order, and each block pushes its kC + 1
//    partials of every row into the shared memory of the row's owner (rank
//    row % S) by st.async, counted on the owner's mbarrier; the owner adds
//    the S partials in rank order, scales and stores one tile later.  Two
//    slot sets alternate by tile; a relaxed cluster barrier keeps a set
//    from being overwritten before its owner has read it, and no barrier
//    waits for memory.
//  - n > 32 (or a chunk of M too large for one block) is cut into grid-y
//    chunks of kC bundles, each recomputing ||h||^2 in the same order.
//
// Rows independent of B, and determinism.  Every row's sums run in one
// order fixed by D and n: the passes in order, in each the warp's two
// halves and two k-steps with the three products apart, the MMA's own order
// within a step (which does not depend on the row's place in the tile),
// then warps (w + (w + 4)) in order 0..3, ranks 0..S-1.  Rows past B are
// zeros and touch no other row, and nothing uses atomics: a row computed
// alone, in a bucket of 64 or in a batch of 1,559 has the same bits, and
// every call repeats.  The launch geometry is computed in ops.py
// (`bundle_sim_geometry`) and checked here.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumers = 256;            // 8 warps: the products
constexpr int kThreads = kConsumers + 32;  // and one producer warp: copies
constexpr int kWarps = kConsumers / 32;    // warp w: columns [32 w, + 32)
constexpr int kRows = 16;                  // rows a tile: one MMA's M
constexpr int kPass = kWarps * 32;         // 256 columns a pass
constexpr int kLine = 128;                 // bytes of an M box row
constexpr int kStageBytes = kRows * kPass * 4;   // a stage of float32 h
constexpr int kMaxCluster = 8;
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448 - 128;     // dynamic, beside the mbarriers
// warps w and w + 4 add their partials: four sets of kRows x row_pitch
constexpr int kRedSets = kWarps / 2;
// two slot sets for the partials of the rows a block owns: at most
// ceil(kRows / S) rows x S ranks <= kRows + kMaxCluster - 1, padded
constexpr int kSlotRows = 2 * (kRows + kMaxCluster);

// a row's kc + 1 partial sums, padded to whole float4s
__host__ __device__ constexpr int row_pitch(int kc) { return (kc + 4) & ~3; }
// the rows of M a block holds: kc, padded to whole 8-bundle n-tiles
__host__ __device__ constexpr int m_rows(int kc) { return (kc + 7) & ~7; }

// dynamic shared memory of a block, in bytes: 1 KB to align the rest to
// 1024 (the 128-byte swizzle's period), M's chunk (m_rows(kc) x chunk
// floats), the ring of h stages, the per-warp partials and the slot sets
constexpr long long smem_bytes(int kc, int chunk, int stages) {
  return 1024 + 4LL * m_rows(kc) * chunk + (long long)stages * kStageBytes +
         4LL * (kRedSets * kRows + kSlotRows) * row_pitch(kc);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// arrive, and expect `bytes` of copies before the phase completes
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
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// the box of `map` at (column x, row y) into dst, completed on `bar`;
// entries outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// the consumer warps' own barrier (the producer warp never waits on it)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// the address of the same shared-memory location in block `rank` of the
// cluster
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}
// 16 bytes into another block's shared memory, counted on its mbarrier
__device__ __forceinline__ void st_async(uint32_t dst, float4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// v = hi + lo, hi rounded to TF32 (the tensor core reads the top 19 bits
// of both); lo is exact
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four staged values of h from shared memory, as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The 128-byte swizzle of an M box: row r's 16-byte unit q lies at unit
// q ^ (r & 7) of the row's 128 bytes.
__device__ __forceinline__ int swizzle(int r, int byte) {
  return r * kLine + ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
}
// The MMA's fragment row (and bundle column) g stands for tile row (and
// bundle) pi(g): the bundles g and g + 1 that one quarter of a warp reads
// then differ in bit 2 and the swizzle puts them on different banks.
__device__ __forceinline__ int pi(int g) { return (g & 1) << 2 | g >> 1; }

// grid (S * G clusters, bundle chunks), clusters of S blocks along x; see
// the note at the top of the file
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, 1)
    bundle_sim_kernel(const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap mmap,
                      const T* __restrict__ h, const float* __restrict__ m,
                      float* __restrict__ out, int B, int D, int n, int chunk,
                      int tiles, int stages, int h_tma, int m_tma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages + 2];
  constexpr int kV = row_pitch(kC);        // a row's n + 1 partial sums
  constexpr int kNT = kC / 8;              // MMA n-tiles of 8 bundles
  constexpr int kF = kC % 8;               // and bundles done in FMAs
  constexpr int kMSeg = m_rows(kC) * kLine;  // an M box: kC rows x 32 cols
  constexpr int kEsize = static_cast<int>(sizeof(T));
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = gridDim.x / S, g = blockIdx.x / S;
  const int j0 = blockIdx.y * kC, nc = min(kC, n - j0);
  const int passes = chunk / kPass;
  const int c0 = rank * chunk, c_end = min(D, c0 + chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (kRows + S - 1) / S;     // rows a rank owns, at most
  // the block's items: tile g + (it / passes) G, pass it % passes
  const int items = (tiles - g + G - 1) / G * passes;

  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ms = base;                // [chunk / 32][kC rows][128 B]
  unsigned char* ring = ms + (size_t)m_rows(kC) * chunk * 4;  // [stages]
  float* red = reinterpret_cast<float*>(ring + stages * kStageBytes);
  float* slots = red + kRedSets * kRows * kV;  // [2][per][S][kV]
  uint64_t* full = bars;                   // [kMaxStages]
  uint64_t* empty = bars + kMaxStages;     // [kMaxStages]
  uint64_t* landed = bars + 2 * kMaxStages;  // [2]: a slot set's pushes

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWarps);
    }
    mbar_init(&landed[0], 1);
    mbar_init(&landed[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every rank must be running before another writes into its shared
  // memory: arrive now, wait before the first push
  cluster_arrive_relaxed();

  if (warp == kWarps) {
    // ---- the producer warp: item it lands in slot it % stages, h by TMA
    // (boxes of 16 rows x 128 bytes, zeros past B and D), with the first
    // tile's passes this block's M (boxes of kC bundles x 32 columns,
    // zeros past n and D); where D or a pointer rules TMA out, the lanes
    // load and store the same swizzled layout themselves
    for (int it = 0; it < items; ++it) {
      const int slot = it % stages;
      if (it >= stages) mbar_wait(&empty[slot], (it / stages - 1) & 1);
      const int tile = g + it / passes * G, pass = it % passes;
      const int row0 = tile * kRows, col0 = c0 + pass * kPass;
      const bool with_m = it < passes;
      unsigned char* st = ring + slot * kStageBytes;
      unsigned char* mp = ms + (size_t)pass * kWarps * kMSeg;
      if (!h_tma) {
        for (int i = lane; i < kRows * kPass; i += 32) {
          const int r = i / kPass, c = i % kPass;
          const bool in = row0 + r < B && col0 + c < c_end;
          reinterpret_cast<T*>(st)[r * kPass + c] =
              from_f32<T>(in ? to_f32(h[(size_t)(row0 + r) * D + col0 + c])
                             : 0.f);
        }
      }
      if (with_m && !m_tma) {
        for (int i = lane; i < kC * kPass; i += 32) {
          const int j = i / kPass, c = i % kPass;
          const bool in = j < nc && col0 + c < c_end;
          *reinterpret_cast<float*>(mp + c / 32 * kMSeg +
                                    swizzle(j, c % 32 * 4)) =
              in ? m[(size_t)(j0 + j) * D + col0 + c] : 0.f;
        }
      }
      __syncwarp();
      if (lane == 0) {
        const bool tma_m = with_m && m_tma;
        // an M box lands kC rows of 128 bytes (its slot holds m_rows(kC))
        mbar_expect(&full[slot], (h_tma ? kRows * kPass * kEsize : 0) +
                                     (tma_m ? kWarps * kC * kLine : 0));
        if (h_tma) tma_load(st, &hmap, col0, row0, &full[slot]);
        if (tma_m)
          for (int s = 0; s < kWarps; ++s)
            tma_load(mp + s * kMSeg, &mmap, col0 + 32 * s, j0, &full[slot]);
      }
      __syncwarp();
      if (pass == passes - 1) {  // keep step with the consumers' barriers
        cluster_wait();
        cluster_arrive_relaxed();
      }
    }
    // every load is issued: a programmatic dependent (profile_decode) may
    // start its prologue; it waits for this grid before it reads the output
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    cluster_wait();
    return;
  }

  // ---- the consumer warps
  const int gr = lane >> 2, t = lane & 3;  // the MMA's group and thread
  const int rho = pi(gr);                  // tile rows rho, rho + 8
  // an accumulator per n-tile and 3xTF32 product; the kF bundles past the
  // last full n-tile are done in float32 FMAs on the same registers of h
  // (kC = 10 and 26 are 1 and 3 n-tiles and 2 FMA bundles), each lane
  // over its own columns
  float acc[kNT > 0 ? kNT : 1][3][4], fma_acc[2][kF > 0 ? kF : 1], nrm[2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][c][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kF; ++j) fma_acc[0][j] = fma_acc[1][j] = 0.f;
  nrm[0] = nrm[1] = 0.f;
  int done = 0, pending = -1;              // tiles pushed; the last one

  // the owner's part of the pending tile: its rows' S partials in rank
  // order, scaled; at most 2 outputs a thread
  float outv[2];
  auto gather = [&](const float* slot) {
    const int owned = (kRows - rank + S - 1) / S;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = threadIdx.x + k * kConsumers;
      if (i < owned * kC) {
        const int lr = i / kC, j = i % kC;
        const float* ps = slot + lr * S * kV;
        float dot = 0.f, ss = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          if (r < S) {
            dot += ps[r * kV + j];
            ss += ps[r * kV + kC];
          }
        }
        outv[k] = dot * rsqrtf(ss + 1e-12f);
      }
    }
  };
  auto store = [&](int tile) {
    const int owned = (kRows - rank + S - 1) / S;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = threadIdx.x + k * kConsumers;
      const int lr = i / kC, j = i % kC;
      const int grow = tile * kRows + rank + lr * S;
      if (i < owned * kC && grow < B && j < nc)
        out[(size_t)grow * n + j0 + j] = outv[k];
    }
  };

  for (int it = 0; it < items; ++it) {
    const int slot = it % stages;
    mbar_wait(&full[slot], (it / stages) & 1);
    const int pass = it % passes;
    const unsigned char* st = ring + slot * kStageBytes;
    const unsigned char* mp = ms + (size_t)(pass * kWarps + warp) * kMSeg;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // rows rho and rho + 8, columns 32 warp + 16 half + 4 t + 0..3 of the
      // pass; the MMA's k = t and t + 4 take columns (+0, +1), then (+2, +3)
      const T* sr = reinterpret_cast<const T*>(st) + warp * 32 + half * 16 +
                    4 * t;
      const float4 x0 = load4(sr + rho * kPass);
      const float4 x1 = load4(sr + (rho + 8) * kPass);
      nrm[0] = fmaf(x0.x, x0.x, nrm[0]);
      nrm[0] = fmaf(x0.y, x0.y, nrm[0]);
      nrm[0] = fmaf(x0.z, x0.z, nrm[0]);
      nrm[0] = fmaf(x0.w, x0.w, nrm[0]);
      nrm[1] = fmaf(x1.x, x1.x, nrm[1]);
      nrm[1] = fmaf(x1.y, x1.y, nrm[1]);
      nrm[1] = fmaf(x1.z, x1.z, nrm[1]);
      nrm[1] = fmaf(x1.w, x1.w, nrm[1]);
      uint32_t ah[8], al[8];
      split_tf32(x0.x, ah[0], al[0]);
      split_tf32(x1.x, ah[1], al[1]);
      split_tf32(x0.y, ah[2], al[2]);
      split_tf32(x1.y, ah[3], al[3]);
      split_tf32(x0.z, ah[4], al[4]);
      split_tf32(x1.z, ah[5], al[5]);
      split_tf32(x0.w, ah[6], al[6]);
      split_tf32(x1.w, ah[7], al[7]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float4 mv = *reinterpret_cast<const float4*>(
            mp + swizzle(nt * 8 + rho, (half * 16 + 4 * t) * 4));
        uint32_t bh[4], bl[4];
        split_tf32(mv.x, bh[0], bl[0]);
        split_tf32(mv.y, bh[1], bl[1]);
        split_tf32(mv.z, bh[2], bl[2]);
        split_tf32(mv.w, bh[3], bl[3]);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int a = 4 * ks, b = 2 * ks;
          mma_tf32(acc[nt][0], al[a], al[a + 1], al[a + 2], al[a + 3],
                   bh[b], bh[b + 1]);
          mma_tf32(acc[nt][1], ah[a], ah[a + 1], ah[a + 2], ah[a + 3],
                   bl[b], bl[b + 1]);
          mma_tf32(acc[nt][2], ah[a], ah[a + 1], ah[a + 2], ah[a + 3],
                   bh[b], bh[b + 1]);
        }
      }
      {
        // bundles 8 kNT + j: rows rho, rho + 8 against this lane's 4
        // columns, in column order
#pragma unroll
        for (int j = 0; j < kF; ++j) {
          const float4 mv = *reinterpret_cast<const float4*>(
              mp + swizzle(8 * kNT + j, (half * 16 + 4 * t) * 4));
          float& s0 = fma_acc[0][j];
          float& s1 = fma_acc[1][j];
          s0 = fmaf(x0.x, mv.x, s0);
          s0 = fmaf(x0.y, mv.y, s0);
          s0 = fmaf(x0.z, mv.z, s0);
          s0 = fmaf(x0.w, mv.w, s0);
          s1 = fmaf(x1.x, mv.x, s1);
          s1 = fmaf(x1.y, mv.y, s1);
          s1 = fmaf(x1.z, mv.z, s1);
          s1 = fmaf(x1.w, mv.w, s1);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);   // the slot may be refilled
    if (pass != passes - 1) continue;

    // ---- the tile is done: its partials go to the rows' owners
    const int tile = g + it / passes * G;
    // ||h||^2 and the FMA bundles over the 4 lanes of a row:
    // (t0 + t1) + (t2 + t3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      nrm[r] += __shfl_xor_sync(0xffffffffu, nrm[r], 1);
      nrm[r] += __shfl_xor_sync(0xffffffffu, nrm[r], 2);
#pragma unroll
      for (int j = 0; j < kF; ++j) {
        fma_acc[r][j] += __shfl_xor_sync(0xffffffffu, fma_acc[r][j], 1);
        fma_acc[r][j] += __shfl_xor_sync(0xffffffffu, fma_acc[r][j], 2);
      }
    }
    // a warp's sum of each (row, bundle): (lo hi + hi lo) + hi hi
    float dot[kNT > 0 ? kNT : 1][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dot[nt][e] = (acc[nt][0][e] + acc[nt][1][e]) + acc[nt][2][e];
    // warps w + 4 store, warps w add theirs: (w) + (w + 4); the fragment's
    // entry e is tile row rho + 8 (e / 2), bundle nt 8 + pi(2 t + e % 2)
    float* rw = red + (warp & 3) * kRows * kV;
    consumer_sync();                       // the last tile's push read red
#pragma unroll
    for (int pair = 1; pair >= 0; --pair) {
      if ((warp >> 2) == pair) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* q = rw + (rho + (e >> 1) * 8) * kV + nt * 8 +
                       pi(2 * t + (e & 1));
            *q = pair ? dot[nt][e] : dot[nt][e] + *q;
          }
        }
        if (t == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float* q = rw + (rho + 8 * r) * kV;
            q[kC] = pair ? nrm[r] : nrm[r] + q[kC];
#pragma unroll
            for (int j = 0; j < kF; ++j) {
              float& v = q[8 * kNT + j];
              v = pair ? fma_acc[r][j] : fma_acc[r][j] + v;
            }
          }
        }
      }
      consumer_sync();
    }
    // every rank has read the slot set this push overwrites (its tile
    // before last); then the block's partial of each row (the four pairs in
    // order) goes into slot `rank` of the row's owner (rank row % S) by
    // st.async, counted on the owner's `landed` barrier of that set
    cluster_wait();
    const int set = done & 1;
    float* slot_set = slots + set * per * S * kV;
    for (int i = threadIdx.x; i < kRows * kV / 4; i += kConsumers) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kRedSets; ++w) {
        const float4 p = reinterpret_cast<const float4*>(red)[
            w * kRows * kV / 4 + i];
        s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
      }
      const int row = i / (kV / 4), j = i % (kV / 4) * 4;
      st_async(map_rank(slot_set + (row / S * S + rank) * kV + j, row % S),
               s, map_rank(&landed[set], row % S));
    }
    if (threadIdx.x == 0)   // the bytes the S ranks push into this block
      mbar_expect(&landed[set],
                  S * ((kRows - rank + S - 1) / S) * kV * 4);
    // the previous tile's partials: gathered, then this block's reads of
    // its set are done (the relaxed arrive), then the outputs are stored
    if (pending >= 0) {
      mbar_wait(&landed[set ^ 1], ((done - 1) >> 1) & 1);
      gather(slots + (set ^ 1) * per * S * kV);
    }
    cluster_arrive_relaxed();
    if (pending >= 0) store(pending);
    pending = tile;
    ++done;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][c][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kF; ++j) fma_acc[0][j] = fma_acc[1][j] = 0.f;
    nrm[0] = nrm[1] = 0.f;
  }
  // the last tile's partials; the producer keeps step with this wait
  cluster_wait();
  mbar_wait(&landed[(done - 1) & 1], ((done - 1) >> 1) & 1);
  gather(slots + ((done - 1) & 1) * per * S * kV);
  store(pending);
}

template <typename T, int kC>
cudaError_t allow_smem() {
  // per host thread, a bit per device whose kernel took the attribute
  thread_local unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(bundle_sim_kernel<T, kC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

cudaLaunchConfig_t config(dim3 grid, int cluster, int smem, cudaStream_t s,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int kC>
int capacity(int cluster, int smem) {
  cudaError_t err = allow_smem<T, kC>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(dim3(cluster), cluster, smem, 0, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, bundle_sim_kernel<T, kC>,
                                       &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library links only the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// a (rows x cols) row-major tensor in boxes of box_rows x box_cols, zeros
// outside
cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType type,
                       const void* ptr, int rows, int cols, int esize,
                       int box_cols, int box_rows,
                       CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault);
    if (err != cudaSuccess) return err;
    if (fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of the last (pointer, shape) this host thread launched
// with, per role: a map encodes the address and shape, so it is reused only
// for the same ones (h's and M's pointers repeat when the caching allocator
// hands back the same block).
struct MapCache {
  const void* ptr = nullptr;
  int rows = -1, cols = -1, esize = 0, box_rows = 0, dev = -1;
  CUtensorMap map = {};
};

cudaError_t cached_map(MapCache& c, CUtensorMapDataType type, const void* ptr,
                       int rows, int cols, int esize, int box_cols,
                       int box_rows, CUtensorMapSwizzle swizzle, int dev,
                       const CUtensorMap** out) {
  // box_cols and the swizzle are fixed per cache (one for h, one for M)
  if (c.ptr != ptr || c.rows != rows || c.cols != cols || c.esize != esize ||
      c.box_rows != box_rows || c.dev != dev) {
    c.ptr = nullptr;
    const cudaError_t err = encode_map(&c.map, type, ptr, rows, cols, esize,
                                       box_cols, box_rows, swizzle);
    if (err != cudaSuccess) return err;
    c.ptr = ptr, c.rows = rows, c.cols = cols, c.esize = esize;
    c.box_rows = box_rows, c.dev = dev;
  }
  *out = &c.map;
  return cudaSuccess;
}

template <typename T, int kC>
cudaError_t launch(const void* h, const void* m, void* out, int B, int D,
                   int n, int chunk, int cluster, int clusters, int n_chunks,
                   int tiles, int stages, int smem, cudaStream_t s) {
  thread_local MapCache h_cache, m_cache;
  static const CUtensorMap kNone = {};
  cudaError_t err = allow_smem<T, kC>();
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // TMA needs 16-byte aligned bases and rows
  const int esize = static_cast<int>(sizeof(T));
  const int h_tma = (long long)D * esize % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(h) % 16 == 0;
  const int m_tma = D % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0;
  const CUtensorMap* hmap = &kNone;
  const CUtensorMap* mmap = &kNone;
  if (h_tma) {
    err = cached_map(h_cache,
                     esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     h, B, D, esize, kPass, kRows, CU_TENSOR_MAP_SWIZZLE_NONE,
                     dev, &hmap);
    if (err != cudaSuccess) return err;
  }
  if (m_tma) {
    err = cached_map(m_cache, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, m, n, D, 4,
                     kLine / 4, kC, CU_TENSOR_MAP_SWIZZLE_128B, dev, &mmap);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(dim3(cluster * clusters, n_chunks), cluster, smem, s, attr);
  err = cudaLaunchKernelEx(&cfg, bundle_sim_kernel<T, kC>, *hmap, *mmap,
                           static_cast<const T*>(h),
                           static_cast<const float*>(m),
                           static_cast<float*>(out), B, D, n, chunk, tiles,
                           stages, h_tma, m_tma);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

#define BS_BUNDLES(X) X(2) X(8) X(10) X(16) X(18) X(24) X(26) X(32)

// Clusters of the kc-bundle kernel (h bfloat16 when h_bf16) with `cluster`
// blocks of `smem` bytes that the current device holds at once; a negative
// cudaError_t on error, -1 for a kc that was not compiled.
extern "C" int bundle_sim_capacity(int kc, int h_bf16, int cluster,
                                   int smem) {
  switch (kc) {
#define BS_CAP(K)                                                  \
  case K:                                                          \
    return h_bf16 ? capacity<__nv_bfloat16, K>(cluster, smem)      \
                  : capacity<float, K>(cluster, smem);
    BS_BUNDLES(BS_CAP)
#undef BS_CAP
    default:
      return -1;
  }
}

// h: (B, D) float32 (h_bf16 = 0) or bfloat16 (h_bf16 = 1), row-major;
// m: (n, D) float32; out: (B, n) float32.  kc, chunk, cluster, clusters,
// n_chunks, tiles, stages and smem come from ops.py's bundle_sim_geometry
// and must describe a launch this file can run (else cudaErrorInvalidValue,
// nothing launched).  16-byte copies are used where D and the pointers
// allow them.  Returns the cudaError_t of the launch (0 on success).
extern "C" int bundle_sim_launch(const void* h, const void* m, void* out,
                                 int B, int D, int n, int h_bf16, int kc,
                                 int chunk, int cluster, int clusters,
                                 int n_chunks, int tiles, int stages,
                                 int smem, void* stream) {
  if (B < 1 || D < 1 || n < 1 || chunk < kPass || chunk % kPass != 0 ||
      cluster < 1 || cluster > kMaxCluster ||
      (long long)cluster * chunk < D || (long long)(cluster - 1) * chunk >= D ||
      (long long)tiles * kRows < B || (long long)(tiles - 1) * kRows >= B ||
      clusters < 1 || clusters > tiles ||
      (long long)cluster * clusters > 0x7fffffffLL ||
      (long long)n_chunks * kc < n || (long long)(n_chunks - 1) * kc >= n ||
      n_chunks > 65535 || stages < 2 || stages > kMaxStages ||
      smem_bytes(kc, chunk, stages) != smem ||
      smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kc) {
#define BS_LAUNCH(K)                                                        \
  case K:                                                                   \
    return static_cast<int>(                                                \
        h_bf16 ? launch<__nv_bfloat16, K>(h, m, out, B, D, n, chunk,        \
                                          cluster, clusters, n_chunks,      \
                                          tiles, stages, smem, s)           \
               : launch<float, K>(h, m, out, B, D, n, chunk, cluster,       \
                                  clusters, n_chunks, tiles, stages, smem,  \
                                  s));
    BS_BUNDLES(BS_LAUNCH)
#undef BS_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
