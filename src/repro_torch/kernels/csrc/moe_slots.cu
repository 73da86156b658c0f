// moe_slots: each MoE choice's capacity slot in its expert's buffer, for
// sm_90a.
//
// Replaces no TPU kernel.  It replaces jnp.cumsum over the (N, E) one-hot of
// the chosen experts at src/repro/models/moe.py:101-102, which XLA handles
// well on a TPU and which PyTorch runs on the card as an outer-dimension scan
// with one thread a column (101 ms a call at granite's training shape).  For
// the token-major flattened expert ids ids (N,) int64 in [0, E) it computes
//   slot[i] = #{ j < i : ids[j] == ids[i] },   keep[i] = slot[i] < cap,
//   slots[i] = keep[i] ? slot[i] : cap - 1
// as int64 slots and bool keep flags, the exact integers of the one-hot
// route.  An id outside [0, E) gets slot cap - 1 and keep 0 and counts for
// no expert.
//
// What bounds it on the H100: bytes.  It reads the ids (8 N bytes) and
// writes slots and keep (9 N bytes): 4.46 MB at (N, E) = (262,144, 32),
// about 1.3 us at 3.35 TB/s; the ids' second read (pass 2) comes from L2.
//
// Design: never materialise the (N, E) one-hot.  The choices are cut into
// tiles of kTile = 2048 (8 warps x 8 steps of 32); a block takes a
// contiguous run of tiles, one tile a block up to kMaxBlocks blocks (one
// wave at granite's 128 tiles), more tiles a block beyond.
//   Pass 1 (moe_counts_kernel): each block counts its choices per expert in
//   shared memory (one shared atomic per group of equal ids in a warp step,
//   order-free integer sums) into the (G, E) int32 scratch.
//   Pass 2 (moe_ranks_kernel): each block sums the counts of the blocks
//   before it, column by column, into a running per-expert offset.  Then,
//   tile by tile, each warp counts its 256 choices per expert (its ids kept
//   in registers), the block turns the warps' counts into exclusive offsets
//   (one thread an expert, warps in order), and each warp walks its choices
//   in order, 32 at a time: __match_any_sync on the id gives the lanes of a
//   group, popc(peers & lanemask_lt) each lane's rank in it, and the group's
//   lowest lane moves the warp's offset on by the group's size.
// Launched as a programmatic dependent of pass 1 (pdl = 1, common.pdl),
// pass 2 loads its first tile's ids before griddepcontrol.wait and the
// counts after it.  Every sum is of integers and every rank comes from a
// fixed order, so the result is exact and repeats bit for bit; no global
// atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 8;                        // 32-choice steps a warp
constexpr int kTile = kWarps * kSteps * 32;      // 2048 choices a tile
constexpr int kMaxExperts = 256;
constexpr int kMaxBlocks = 256;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// the id of choice i as an int, -1 past the end or outside [0, E)
__device__ __forceinline__ int load_id(const int64_t* ids, int64_t i,
                                       int64_t n, int e) {
  if (i >= n) return -1;
  const long long v = __ldg(reinterpret_cast<const long long*>(ids) + i);
  return (v >= 0 && v < e) ? static_cast<int>(v) : -1;
}

// the tiles [first, last) of block b of `blocks` over `tiles` tiles
__device__ __forceinline__ void block_tiles(int b, int blocks, int tiles,
                                            int* first, int* last) {
  const int per = (tiles + blocks - 1) / blocks;
  *first = b * per;
  *last = min(tiles, *first + per);
}

// Pass 1: counts[b, e] = choices of block b's tiles with id e.
__global__ void __launch_bounds__(kThreads)
    moe_counts_kernel(const int64_t* __restrict__ ids,
                      int* __restrict__ counts, int64_t n, int e, int tiles) {
  __shared__ int hist[kMaxExperts];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int x = threadIdx.x; x < e; x += kThreads) hist[x] = 0;
  __syncthreads();
  // pass 2 may start its prologue (its first ids) now
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  int first, last;
  block_tiles(blockIdx.x, gridDim.x, tiles, &first, &last);
  for (int t = first; t < last; ++t) {
    const int64_t base = static_cast<int64_t>(t) * kTile + warp * kSteps * 32;
    int id[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      id[s] = load_id(ids, base + s * 32 + lane, n, e);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const unsigned peers = __match_any_sync(0xffffffffu, id[s]);
      if (id[s] >= 0 && (peers & lanemask_lt()) == 0)
        atomicAdd(&hist[id[s]], __popc(peers));
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < e; x += kThreads)
    counts[static_cast<int64_t>(blockIdx.x) * e + x] = hist[x];
}

// Pass 2: the slots and keep flags of block b's tiles.
__global__ void __launch_bounds__(kThreads)
    moe_ranks_kernel(const int64_t* __restrict__ ids,
                     const int* __restrict__ counts,
                     int64_t* __restrict__ slots, uint8_t* __restrict__ keep,
                     int64_t n, int e, int cap, int tiles) {
  __shared__ int offset[kMaxExperts];            // choices before this tile
  __shared__ int warp_off[kWarps][kMaxExperts];  // per warp: counts, offsets
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = lanemask_lt();
  int first, last;
  block_tiles(blockIdx.x, gridDim.x, tiles, &first, &last);
  int id[kSteps];
  const int64_t warp_base = warp * kSteps * 32;
  // the first tile's ids: input, not pass 1's output, so before the wait
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
    id[s] = load_id(ids, static_cast<int64_t>(first) * kTile + warp_base +
                             s * 32 + lane, n, e);
  for (int x = threadIdx.x; x < e; x += kThreads) offset[x] = 0;
  __syncthreads();
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // offset[x] = sum of counts[b', x] over the blocks b' before this one,
  // eight independent loads a thread in flight
  const int prior = blockIdx.x * e;
  for (int j0 = threadIdx.x; j0 < prior; j0 += 8 * kThreads) {
    int v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u * kThreads;
      v[u] = j < prior ? __ldcg(counts + j) : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u * kThreads;
      if (j < prior && v[u] != 0) atomicAdd(&offset[j % e], v[u]);
    }
  }
  for (int t = first; t < last; ++t) {
    const int64_t base = static_cast<int64_t>(t) * kTile + warp_base;
    if (t != first) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        id[s] = load_id(ids, base + s * 32 + lane, n, e);
    }
    // this warp's choices per expert; only a group's lowest lane writes,
    // one group an id a step, steps in order
    int* mine = warp_off[warp];
    for (int x = lane; x < e; x += 32) mine[x] = 0;
    __syncwarp();
    unsigned peers[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      peers[s] = __match_any_sync(0xffffffffu, id[s]);
      if (id[s] >= 0 && (peers[s] & lt) == 0)
        mine[id[s]] += __popc(peers[s]);
      __syncwarp();
    }
    __syncthreads();
    // exclusive offsets: expert x's choices before each warp's
    for (int x = threadIdx.x; x < e; x += kThreads) {
      int run = offset[x];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_off[w][x];
        warp_off[w][x] = run;
        run += c;
      }
      offset[x] = run;
    }
    __syncthreads();
    // ranks, in order
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int64_t i = base + s * 32 + lane;
      const int v = id[s];
      const int slot = v >= 0 ? mine[v] + __popc(peers[s] & lt) : cap;
      __syncwarp();
      if (v >= 0 && (peers[s] & lt) == 0) mine[v] += __popc(peers[s]);
      __syncwarp();
      if (i < n) {
        const bool k = slot < cap;
        slots[i] = k ? slot : cap - 1;
        keep[i] = k;
      }
    }
    // the next tile's counts overwrite this warp's row only after every
    // lane has read it
    __syncwarp();
  }
}

// Blocks of a call over n >= 1 choices: one a tile, and where the tiles
// outnumber kMaxBlocks, an equal run of tiles a block (ops.py's
// moe_slots_blocks).
int blocks_for(long long n) {
  const long long tiles = (n + kTile - 1) / kTile;
  const long long per = (tiles + kMaxBlocks - 1) / kMaxBlocks;
  return static_cast<int>((tiles + per - 1) / per);
}

}  // namespace

// ids: (n,) int64; slots: (n,) int64; keep: (n,) bool; counts: (blocks, e)
// int32 scratch, blocks = blocks_for(n).  1 <= e <= kMaxExperts,
// 1 <= cap, 1 <= n < 2^31 (else cudaErrorInvalidValue, nothing launched).
// Two launches on `stream`, the second a programmatic dependent of the
// first where pdl = 1.  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int moe_slots_launch(const void* ids, void* slots, void* keep,
                                void* counts, long long n, int e, int cap,
                                int blocks, int pdl, void* stream) {
  if (n < 1 || n >= (1LL << 31) || e < 1 || e > kMaxExperts || cap < 1 ||
      blocks != blocks_for(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>((n + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* in = static_cast<const int64_t*>(ids);
  int* cnt = static_cast<int*>(counts);
  moe_counts_kernel<<<blocks, kThreads, 0, s>>>(in, cnt, n, e, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, moe_ranks_kernel, in,
                           static_cast<const int*>(cnt),
                           static_cast<int64_t*>(slots),
                           static_cast<uint8_t*>(keep),
                           static_cast<int64_t>(n), e, cap, tiles);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
