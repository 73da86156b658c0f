// hdc_encode: the fused HDC random-projection encoder for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/hdc_encode/hdc_encode.py:hdc_encode_pallas
//   (body _kernel)
// together with the two row normalisations of its wrapper (ops.py), and
// computes the same function:
//   z   = x W                                 x (B, F), W (F, D) float32
//   h   = cos(z + b) * sin(z) | z | sign(z)   kind "cos" | "rp" | "rp_sign"
//   out = l2n(l2n(h) - center)                l2n(v) = v / (||v|| + 1e-12)
// for bias and center (D,), all float32.  This is every encode of the port:
// fit, predict and each raw-feature service cycle.
//
// What bounds it on the H100.  The function needs 2 B F D flops and the
// bytes of x, W, bias, center and the output.  In float32 outside the
// tensor cores (67 TFLOP/s) that is 11.8 us at a 64-row service bucket of
// isolet (F = 617, D = 10,000) and 287 us at the 1,559-row predict batch,
// so a SIMT kernel can at best tie cuBLAS's SGEMM.  The product here runs
// on the tensor cores as 3xTF32, three TF32 products per float32 one: its
// ceiling is 495 / 3 = 165 TFLOP/s, so B = 64 is bound by bytes (W is
// 24.7 MB: 8.2 us), B = 1,559 by operations (116 us), B = 1 by the read of
// W (7.4 us).  chip_smoke.py states the bound in these units; PERF.md
// holds the times measured beside it.  What holds the kernel back from
// them is shared memory, through which both TF32 parts of W^T are written
// and then read by wgmma (about 70 KB a 32-feature stage), and the
// normalisation's latency chain at large B.
//
// The product: one block a 64 x 80 output tile (64 rows hold a whole
// service bucket, so W streams from device memory once a bucket; D =
// 10,000 is 125 blocks, under one wave of 132 SMs), 512 threads in two
// roles, the K loop in stages of 32 features.
//  - 3xTF32: each operand is split, v = hi + lo, hi = v rounded to TF32 by
//    two integer ops, lo = v - hi exactly and handed to the tensor core as
//    it is (it reads the top 19 bits); each element adds lo*hi, hi*lo and
//    hi*hi per 8 features with float32 accumulators.  That keeps float32
//    accuracy (lo*lo, about 2^-21 of the product, is dropped); it is an
//    algorithm inside the kernel, independent of torch's TF32 switch.
//  - Three producer warpgroups.  W lands in an 8-stage ring: one TMA copy a
//    stage (a tensor map made on the host, the driver's encoder found with
//    cudaGetDriverEntryPoint, so the library links nothing new; an mbarrier
//    a slot; rows past F and columns past D arrive as zeros), or 4-byte
//    cp.async when D % 4 != 0 (TMA needs 16-byte rows).  TMA frees the
//    producers' issue slots for the split: with W by cp.async at every D
//    the kernel took 1.1-1.3x as long at B = 1, 64 and 1,559 (PERF.md
//    section 6).  The producers then split the stage's W^T into the two
//    TF32 parts in wgmma's K-major layout without swizzle (core matrices
//    of 8 columns x 4 features, 128 contiguous bytes, two a k8 step), four
//    values and two 16-byte stores a thread, into one of three parts
//    buffers.
//  - One consumer warpgroup reads x from global memory (small, in L2) a
//    stage ahead, splits it in registers into the A fragments, and issues
//    wgmma.m64n80k8.tf32 with A from registers and B from the parts buffer.
//  - Named barriers hand the parts buffers over (full: producers arrive,
//    the consumer waits; free: the other way round).
//  - The epilogue stages the accumulators in shared memory so that all 512
//    threads apply the nonlinearity, cos and sin on the special-function
//    units after an explicit reduction to [-pi, pi] with a two-part 2 pi
//    (absolute error about 2^-21 each for |z + b| up to about 1e4; the
//    accurate cosf / sinf were the epilogue's largest cost), store h with
//    whole 32-byte sectors, and write one partial sum of h^2 per (row,
//    column block).
//
// The normalisation: a second launch covers each row with a cluster of up
// to 8 blocks, each owning a contiguous chunk of columns, its chunk held
// in registers (h read once) and fetched while the row before is being
// normalised.  Every block forms n1 = sqrt(sum of the row's partials, in
// column-block order) + 1e-12, sums u^2 of its chunk with u = h / n1 -
// center, and stores that sum into its rank's slot in every block of the
// cluster through distributed shared memory; after one cluster barrier a
// row each block adds the slots in rank order and writes u / (||u|| +
// 1e-12).  The slots alternate with the row's parity, so one barrier a row
// suffices.  The exact form is kept: the shortcut ||u||^2 = ||h||^2 / n1^2
// - 2 h.c / n1 + ||c||^2 would cancel, because center is the training mean
// of l2n(h) and is not small.
//
// Rows independent of B, and determinism.  Every output element sums its
// products over features in the order 0, 8, 16, ..., the three products of
// each step in the same order, with no split-K; wgmma computes each element
// from its own row and column (rows past B hold zeros or anything), so a
// row's z does not depend on the other rows or on its place in a tile.  The
// column tile, the partial sums and the cluster depend on F and D only,
// and nothing uses atomics: a row encoded alone, in a bucket of 64 or in a
// batch of 1,559 has the same bits, and every call repeats.  The launch
// geometry is computed in ops.py (`encode_geometry`) and checked here
// against the compiled tiles.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 64;        // output rows per block: one wgmma M
constexpr int kBN = 80;        // output columns per block: the wgmma N
constexpr int kBK = 32;        // features per pipeline stage
constexpr int kStages = 8;     // depth of the ring of W stages
constexpr int kBuffers = 3;    // parts buffers between producers and consumer
constexpr int kConsumers = 128;                    // one warpgroup: wgmma
constexpr int kProducers = 384;                    // three: copies, splits
constexpr int kThreads = kConsumers + kProducers;  // 512
constexpr int kWPitch = kBN;   // a landed W row (dense, as TMA writes it)
constexpr int kWStage = kBK * kWPitch;
// one TF32 part (hi or lo) of a stage's W^T (kBN x kBK) in the wgmma
// layout of K-major core matrices
constexpr int kPart = kBN * kBK;
constexpr int kSmemBytes =
    (kStages * kWStage + kBuffers * 2 * kPart) * 4;   // 143,360
constexpr int kEpiPitch = kBN + 8;   // the accumulator tile, staged

constexpr int kNormThreads = 256;
constexpr int kNormWarps = kNormThreads / 32;
constexpr int kNormPer = 8;    // row entries a normalising thread holds
constexpr int kMaxCluster = 8;

static_assert(kBM == 64 && kBN == 80 && kBK % 8 == 0, "tile shape");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 4 bytes; a false predicate reads nothing and fills zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// mbarriers of the W ring, completed by the bytes of a TMA copy
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
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// the (kBK x kBN) box of W at (column n0, feature k0) into ring slot dst;
// rows past F and columns past D arrive as zeros
__device__ __forceinline__ void tma_load_w(float* dst, const CUtensorMap* map,
                                           int n0, int k0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(n0), "r"(k0),
      "r"(smem_u32(bar))
      : "memory");
}

// v = hi + lo: hi is v rounded to TF32 (10 mantissa bits; integer ops, v
// finite), lo = v - hi exactly, handed to the tensor core as it is (it
// reads the top 19 bits of a TF32 operand), so hi + lo carries 21 bits.
__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
  lo = v - hi;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  float h, l;
  split_tf32(v, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
}

// wgmma descriptor of a K-major operand without swizzle: 8-row x 16-byte
// core matrices of 128 contiguous bytes, the two of a k8 step 128 bytes
// apart (leading offset), successive 8-row groups 256 bytes apart (stride
// offset).
__device__ __forceinline__ uint64_t kmajor_desc(const float* p) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) |
         ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

// d (64 x 80 per warpgroup) += A B for one k8 step, A from registers (the
// m16n8k8 fragment of each warp's 16 rows), B from shared memory, TF32
// in, float32 accumulators
__device__ __forceinline__ void wgmma_k8(float (&d)[40], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// named barriers: 1 the producers, kBarFull + b "parts buffer b is full",
// kBarEmpty + b "parts buffer b is free"; the last two count every thread
// of the block
constexpr int kBarProducers = 1, kBarFull = 2, kBarEmpty = 2 + kBuffers;
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// shared-memory writes of this thread, visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x - 2 pi round(x / 2 pi), with 2 pi in two parts: within [-pi, pi] and
// good to a few ulp of x for |x| up to about 1e4
__device__ __forceinline__ float reduce_2pi(float x) {
  const float k = rintf(x * 0.159154943f);
  return fmaf(k, 1.7484555e-7f, fmaf(-k, 6.28318548f, x));
}

// cos(z + b) sin(z) on the special-function units, each argument reduced
// first (absolute error about 2^-21 each on [-pi, pi])
__device__ __forceinline__ float nonlin(float z, float b, int kind) {
  if (kind == 0) return __cosf(reduce_2pi(z + b)) * __sinf(reduce_2pi(z));
  if (kind == 1) return z;
  return z > 0.f ? 1.f : (z < 0.f ? -1.f : z);
}

// W^T quads (four consecutive features of one column of W) of a stage
constexpr int kWQuads = kBN * kBK / 4;
constexpr int kWPer = (kWQuads + kProducers - 1) / kProducers;

// What one producer thread copies and splits in every stage.  The offsets
// are fixed for the whole block; a stage adds only its first feature k0.
//  - without TMA, W copies of 4 bytes into the ring slot; columns past D
//    are not copied (they feed only columns that are not kept), rows past
//    F are zero-filled.
//  - the split: W^T quads (column n, features 4 kq + 0..3 of the landed
//    tile) into TF32 parts, each a core-matrix row of the wgmma layout: for
//    each k8 step, the 8-column groups, each two core matrices (k 0-3,
//    4-7) of 8 rows x 4 floats (16 bytes a row, 128 bytes a matrix); one
//    16-byte store to each part.
struct Producer {
  static constexpr int kCopies = (kBK * kBN + kProducers - 1) / kProducers;
  long long wsrc[kCopies];   // offset in w at k0 = 0; -1: nothing to copy
  int wdst[kCopies], wrow[kCopies];
  int wq_src[kWPer], wq_dst[kWPer];   // -1: no quad

  __device__ __forceinline__ Producer(int n0, int D) {
    const int tid = threadIdx.x - kConsumers;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int idx = tid + kProducers * i;
      const int r = idx / kBN, c = idx % kBN;
      const bool ok = idx < kBK * kBN && n0 + c < D;
      wsrc[i] = ok ? (long long)r * D + n0 + c : -1;
      wdst[i] = r * kWPitch + c;
      wrow[i] = r;
    }
#pragma unroll
    for (int i = 0; i < kWPer; ++i) {
      const int q = tid + kProducers * i, n = q % kBN, kq = q / kBN;
      wq_src[i] = q < kWQuads ? 4 * kq * kWPitch + n : -1;
      wq_dst[i] =
          ((kq / 2 * (kBN / 8) + n / 8) * 2 + kq % 2) * 32 + (n % 8) * 4;
    }
  }

  __device__ __forceinline__ void load_w(float* ws,
                                         const float* __restrict__ w, int k0,
                                         int F, int D) const {
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      if (wsrc[i] < 0) continue;
      const bool ok = k0 + wrow[i] < F;
      cp_async4(ws + wdst[i], ok ? w + (size_t)k0 * D + wsrc[i] : w, ok);
    }
  }

  __device__ __forceinline__ void split(const float* ws, float* hi,
                                        float* lo) const {
#pragma unroll
    for (int i = 0; i < kWPer; ++i) {
      if (wq_src[i] < 0) continue;
      float4 h, l;
      const float* src = ws + wq_src[i];
      split_tf32(src[0], h.x, l.x);
      split_tf32(src[kWPitch], h.y, l.y);
      split_tf32(src[2 * kWPitch], h.z, l.z);
      split_tf32(src[3 * kWPitch], h.w, l.w);
      *reinterpret_cast<float4*>(hi + wq_dst[i]) = h;
      *reinterpret_cast<float4*>(lo + wq_dst[i]) = l;
    }
  }
};

// grid (row blocks, column blocks); partial: (B, gridDim.y).  kTma: W
// lands by TMA through `wmap` (D % 4 == 0 and w 16-byte aligned), else by
// 4-byte cp.async.
template <bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out,
                float* __restrict__ partial, int B, int F, int D, int kind) {
  extern __shared__ __align__(128) float smem[];
  __shared__ uint64_t wbar[kStages];
  float* wring = smem;
  float* parts = wring + kStages * kWStage;   // [buffer][hi, lo][kPart]
  float* tile = smem;   // the accumulators, staged for the epilogue

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int ktiles = (F + kBK - 1) / kBK;
  if (kTma && threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&wbar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producers: W of stage kt lands in ring slot kt % kStages, x of stage
    // kt + 1 is read into registers while stage kt is split into parts
    // buffer kt % kBuffers (once the consumer has released it)
    const Producer plan(n0, D);
    const bool leader = threadIdx.x == kConsumers;
    // stage j of W into ring slot j % kStages
    auto land_w = [&](int j) {
      float* ws = wring + (j % kStages) * kWStage;
      if (!kTma) {
        plan.load_w(ws, w, j * kBK, F, D);
      } else if (leader) {
        mbar_expect(&wbar[j % kStages], kWStage * 4);
        tma_load_w(ws, &wmap, n0, j * kBK, &wbar[j % kStages]);
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < ktiles) land_w(s);
      cp_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      if (kTma)   // stage kt of W has landed
        mbar_wait(&wbar[kt % kStages], (kt / kStages) & 1);
      else        // this thread's copies of it have landed
        cp_wait<kStages - 2>();
      bar_sync(kBarProducers, kProducers);   // everyone's; slot kt-1 free
      if (kt + kStages - 1 < ktiles) land_w(kt + kStages - 1);
      cp_commit();
      const int b = kt % kBuffers;
      if (kt >= kBuffers) bar_sync(kBarEmpty + b, kThreads);
      float* hi = parts + b * 2 * kPart;
      plan.split(wring + (kt % kStages) * kWStage, hi, hi + kPart);
      fence_async_smem();
      bar_arrive(kBarFull + b, kThreads);
    }
    cp_wait<0>();
  } else {
    // the consumer warpgroup: x read from global memory (small, in L2) a
    // stage ahead and split in registers into its TF32 parts, the A
    // fragments of wgmma (thread g, t of warp w: rows 16 w + g (+ 8),
    // features t (+ 4) of each k8 step); every element, per k8 step in
    // order, += lo*hi, hi*lo, hi*hi
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = m0 + warp * 16 + g;
    const float* xr[2] = {r0 < B ? x + (size_t)r0 * F : nullptr,
                          r0 + 8 < B ? x + (size_t)(r0 + 8) * F : nullptr};
    float xv[kBK / 8][4];   // [k8 step][a0..a3]
    auto load_x = [&](int k0) {
#pragma unroll
      for (int kc = 0; kc < kBK / 8; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + 8 * kc + t + (e >> 1) * 4;
          const float* row = xr[e & 1];
          xv[kc][e] = row && k < F ? row[k] : 0.f;
        }
    };
    float d[40];
#pragma unroll
    for (int i = 0; i < 40; ++i) d[i] = 0.f;
    load_x(0);
    for (int kt = 0; kt < ktiles; ++kt) {
      const int b = kt % kBuffers;
      uint32_t ah[kBK / 8][4], al[kBK / 8][4];
#pragma unroll
      for (int kc = 0; kc < kBK / 8; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(xv[kc][e], ah[kc][e], al[kc][e]);
      if (kt + 1 < ktiles) load_x((kt + 1) * kBK);
      bar_sync(kBarFull + b, kThreads);
      const float* hi = parts + b * 2 * kPart;
      const float* lo = hi + kPart;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBK / 8; ++kc) {
        const int bo = kc * (kBN / 8) * 64;
        wgmma_k8(d, al[kc], kmajor_desc(hi + bo));
        wgmma_k8(d, ah[kc], kmajor_desc(lo + bo));
        wgmma_k8(d, ah[kc], kmajor_desc(hi + bo));
      }
      wgmma_commit();
      wgmma_wait<0>();   // its A registers and parts buffer are free
      if (kt + kBuffers < ktiles) bar_arrive(kBarEmpty + b, kThreads);
    }
    wgmma_wait<0>();
    // stage the 64 x 80 accumulators (rows 16 warp + g (+ 8), columns
    // 8 i + 2 t (+ 1)) for all threads of the block
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(
            tile + (warp * 16 + g + 8 * half) * kEpiPitch + 8 * i + 2 * t) =
            make_float2(d[4 * i + 2 * half], d[4 * i + 2 * half + 1]);
  }
  __syncthreads();

  // epilogue, every thread: eight threads a row, each taking the column
  // pairs p, p + 8, ..., p + 32 of its part p, so a warp's stores cover
  // whole 32-byte sectors; h = nonlin(z + bias) stored, and the row's sum
  // of h^2 over the block's 80 columns in a fixed order: each thread's ten
  // (pair, then the two of a pair), then the eight threads (xor 1, 2, 4:
  // all eight get the same sum)
  constexpr int kPairs = kBN / 16;
  static_assert(kThreads == kBM * 8 && kBN % 16 == 0, "epilogue layout");
  const int rl = threadIdx.x >> 3, part = threadIdx.x & 7;
  const int row = m0 + rl;
  float2 hv[kPairs];
  float ss = 0.f;
  if (row < B) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int c = 2 * (part + 8 * i), col = n0 + c;
      const float2 z =
          *reinterpret_cast<const float2*>(tile + rl * kEpiPitch + c);
      hv[i].x = col < D ? nonlin(z.x, bias[col], kind) : 0.f;
      hv[i].y = col + 1 < D ? nonlin(z.y, bias[col + 1], kind) : 0.f;
      ss = fmaf(hv[i].x, hv[i].x, ss);
      ss = fmaf(hv[i].y, hv[i].y, ss);
    }
  }
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  ss += __shfl_xor_sync(0xffffffffu, ss, 4);
  if (row < B) {
    float* op = out + (size_t)row * D + n0;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int c = 2 * (part + 8 * i);
      if ((D & 1) == 0 && n0 + c + 1 < D) {
        *reinterpret_cast<float2*>(op + c) = hv[i];
      } else {
        if (n0 + c < D) op[c] = hv[i].x;
        if (n0 + c + 1 < D) op[c + 1] = hv[i].y;
      }
    }
    if (part == 0) partial[(size_t)row * gridDim.y + blockIdx.y] = ss;
  }
}

// The block-wide sum of one value per thread, in a fixed order; every
// thread gets the result.
__device__ __forceinline__ float block_sum(float s, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __syncthreads();  // red is free: every thread read the previous sum
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kNormWarps; ++i) total += red[i];
  return total;
}

// grid (cluster * row clusters), clusters of `cluster` blocks along x; a
// cluster normalises rows c, c + row clusters, ...; block rank r owns
// columns [r chunk, (r + 1) chunk).  A chunk of at most kNormThreads *
// kNormPer entries is held in registers, read once and fetched while the
// row before is normalised; a longer one is read twice.
__global__ void __launch_bounds__(kNormThreads)
    normalize_kernel(float* __restrict__ out, const float* __restrict__ center,
                     const float* __restrict__ partial, int B, int D,
                     int parts, int chunk) {
  __shared__ float red[kNormWarps];
  __shared__ float cluster_ss[2][kMaxCluster];   // by row parity, by rank
  cg::cluster_group cluster = cg::this_cluster();
  const int size = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int d0 = rank * chunk, d1 = min(D, d0 + chunk);
  const bool in_regs = d1 - d0 <= kNormThreads * kNormPer;
  float cv[kNormPer];   // this thread's entries of center, for every row
#pragma unroll
  for (int i = 0; i < kNormPer; ++i) {
    const int d = d0 + threadIdx.x + i * kNormThreads;
    cv[i] = in_regs && d < d1 ? center[d] : 0.f;
  }

  // a row's partial sums of h^2 (this thread's share, in order) and, when
  // it fits, this block's chunk of the row
  auto fetch = [&](int row, float(&v)[kNormPer], float& s) {
    const float* pr = partial + (size_t)row * parts;
    s = 0.f;
    for (int i = threadIdx.x; i < parts; i += kNormThreads) s += pr[i];
    if (in_regs) {
      const float* h = out + (size_t)row * D;
#pragma unroll
      for (int i = 0; i < kNormPer; ++i) {
        const int d = d0 + threadIdx.x + i * kNormThreads;
        v[i] = d < d1 ? h[d] : 0.f;
      }
    }
  };
  const int stride = gridDim.x / size;
  float v[kNormPer], s;
  int row = blockIdx.x / size;
  if (row < B) fetch(row, v, s);
  int parity = 0;
  for (; row < B; row += stride) {
    float* h = out + (size_t)row * D;
    // the next row's loads fly while this row is normalised
    float vn[kNormPer], sn = 0.f;
    if (row + stride < B) fetch(row + stride, vn, sn);
    const float n1 = sqrtf(block_sum(s, red)) + 1e-12f;

    s = 0.f;
    if (in_regs) {
#pragma unroll
      for (int i = 0; i < kNormPer; ++i) {
        const int d = d0 + threadIdx.x + i * kNormThreads;
        if (d < d1) {
          v[i] = v[i] / n1 - cv[i];
          s = fmaf(v[i], v[i], s);
        }
      }
    } else {
      for (int d = d0 + threadIdx.x; d < d1; d += kNormThreads) {
        const float u = h[d] / n1 - center[d];
        s = fmaf(u, u, s);
      }
    }
    s = block_sum(s, red);
    // this block's sum goes to slot `rank` of every block of the cluster;
    // after the barrier each block adds the slots in rank order.  Slots
    // alternate by row: a block writes a row's slots only after the
    // barrier of the row before, by which every block has read them.
    if (threadIdx.x < size)
      *cluster.map_shared_rank(&cluster_ss[parity][rank], threadIdx.x) = s;
    cluster.sync();
    float ss = 0.f;
    for (int r = 0; r < size; ++r) ss += cluster_ss[parity][r];
    const float n2 = sqrtf(ss) + 1e-12f;
    parity ^= 1;

    if (in_regs) {
#pragma unroll
      for (int i = 0; i < kNormPer; ++i) {
        const int d = d0 + threadIdx.x + i * kNormThreads;
        if (d < d1) h[d] = v[i] / n2;
      }
    } else {
      for (int d = d0 + threadIdx.x; d < d1; d += kNormThreads)
        h[d] = (h[d] / n1 - center[d]) / n2;
    }
#pragma unroll
    for (int i = 0; i < kNormPer; ++i) v[i] = vn[i];
    s = sn;
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

cudaError_t w_tensor_map(CUtensorMap* map, const float* w, int F, int D) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault);
    if (err != cudaSuccess) return err;
    if (fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)F};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 4};
  const cuuint32_t box[2] = {kBN, kBK};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(w), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool kTma>
cudaError_t launch_gemm(dim3 grid, int smem, const float* x, const float* w,
                        const float* bias, float* out, float* partial, int B,
                        int F, int D, int kind, cudaStream_t s) {
  // the last tensor map and the devices whose kernel took the shared-memory
  // size, per host thread (a serving thread and the caller's may launch at
  // once); a map encodes the pointer and shape of W, so it is reused only
  // for the same ones
  thread_local CUtensorMap map = {};
  thread_local const float* map_w = nullptr;
  thread_local int map_f = -1, map_d = -1, map_dev = -1;
  thread_local unsigned smem_set = 0;   // bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (kTma && (w != map_w || F != map_f || D != map_d || dev != map_dev)) {
    err = w_tensor_map(&map, w, F, D);
    if (err != cudaSuccess) return err;
    map_w = w, map_f = F, map_d = D, map_dev = dev;
  }
  if (dev >= 32 || !(smem_set >> dev & 1u)) {
    err = cudaFuncSetAttribute(
        gemm_kernel<kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 32) smem_set |= 1u << dev;
  }
  gemm_kernel<kTma><<<grid, kThreads, smem, s>>>(map, x, w, bias, out,
                                                 partial, B, F, D, kind);
  return cudaGetLastError();
}

}  // namespace

// x: (B, F), w: (F, D), bias and center: (D,), all float32 row-major;
// out: (B, D) float32; partial: (B, gemm_grid_y) float32 scratch.  kind:
// 0 cos, 1 rp, 2 rp_sign.  tma: 1 (W lands by TMA) when D % 4 == 0 and w
// is 16-byte aligned.  The geometry comes from ops.py's encode_geometry
// and must match the compiled tiles (else cudaErrorInvalidValue, nothing
// launched).
// Returns the cudaError_t of the two launches (0 on success).
extern "C" int hdc_encode_launch(const void* x, const void* w,
                                 const void* bias, const void* center,
                                 void* out, void* partial, int B, int F,
                                 int D, int kind, int tma, int gemm_gx,
                                 int gemm_gy, int gemm_threads, int smem,
                                 int stages, int cluster, int norm_rows,
                                 int norm_threads, int chunk, void* stream) {
  if (gemm_threads != kThreads || smem != kSmemBytes || stages != kStages ||
      norm_threads != kNormThreads || (long long)gemm_gx * kBM < B ||
      (long long)gemm_gy * kBN < D || cluster < 1 || cluster > kMaxCluster ||
      (long long)cluster * chunk < D || norm_rows < 1 || norm_rows > B ||
      kind < 0 || kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(partial);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(bias);
  const dim3 grid(gemm_gx, gemm_gy);
  cudaError_t err =
      tma ? launch_gemm<true>(grid, smem, xp, wp, bp, op, pp, B, F, D, kind,
                                s)
            : launch_gemm<false>(grid, smem, xp, wp, bp, op, pp, B, F, D,
                                 kind, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster) * norm_rows);
  cfg.blockDim = dim3(kNormThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, normalize_kernel, op,
                           static_cast<const float*>(center),
                           static_cast<const float*>(pp), B, D, gemm_gy,
                           chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
