// The row engine of the Hopper field kernels (train.cu: K6 / K7's
// train_rows; march.cu: K1's march_rows). Rows are (ray, sample) pairs in
// tiles of 128, two warpgroups of 64; every layer is one wgmma product per
// warpgroup with A from registers (the previous layer's accumulator, biased,
// relu'd and rounded to bf16 in place) and B from a ring of weight stages
// that cp.async.bulk fills from a pre-swizzled image of the layer's K-tiles
// (one job a K-tile) behind full / empty mbarriers. sm_90a only.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTileRows = 128;       // two warpgroups of 64 rows
constexpr int kRowThreads = 256;
constexpr int kStageBytes = 16384;   // the largest weight job: 64 x 128 bf16
constexpr int kRingStages = 6;

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d (64 x 128 f32) += A (64 x 16 bf16, fragment registers) * B (16 x 128,
// shared, MN-major).
__device__ __forceinline__ void wgmma_64x128x16_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : D2R_F16(d, 0), D2R_F16(d, 16), D2R_F16(d, 32), D2R_F16(d, 48)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db));
}

// This thread's place in its warpgroup: rows rloc and rloc + 8 of the
// warpgroup's 64, columns 2q, 2q + 1 of every 8 (the wgmma layouts).
struct Lane {
  int tid, wg, warp, rr, q, rloc;
};

__device__ __forceinline__ Lane lane_of() {
  Lane l;
  l.tid = threadIdx.x;
  // Through a shuffle, so that the compiler knows it uniform across the warp.
  l.wg = __shfl_sync(0xffffffffu, l.tid >> 7, 0);
  l.warp = l.tid >> 5;
  l.rr = (l.tid & 31) >> 2;
  l.q = l.tid & 3;
  l.rloc = (l.warp & 3) * 16 + l.rr;
  return l;
}

// The weight ring. Job n of the block lands in stage n % kRingStages; all 8
// warps arrive on the stage's empty barrier when their products are done
// with it (jobs are released in order, one behind the products in flight),
// and thread 0 then refills the stage the job before left.
struct Ring {
  uint32_t base, bars;
  const int* off;    // byte offsets into the image of the program's jobs
  const int* bytes;
  const unsigned char* img;
  int per_step, total, n, rel;  // n: the next job to wait for; rel: to release
};

__device__ __forceinline__ void ring_request(const Ring& r, int j) {
  const int s = j % kRingStages, loc = j % r.per_step;
  const uint32_t full = r.bars + 8 * s;
  mbar_expect_tx(full, r.bytes[loc]);
  bulk_load(r.base + s * kStageBytes, r.img + r.off[loc], r.bytes[loc], full);
}

__device__ __forceinline__ uint32_t ring_wait(const Ring& r) {
  const int s = r.n % kRingStages;
  mbar_wait(r.bars + 8 * s, (r.n / kRingStages) & 1);
  return r.base + s * kStageBytes;
}

__device__ __forceinline__ uint32_t ring_next(Ring& r) {
  const uint32_t stage = ring_wait(r);
  ++r.n;
  return stage;
}

// This warp is done with job rel (its products have completed).
__device__ __forceinline__ void ring_release(Ring& r) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.bars + 8 * (kRingStages + r.rel % kRingStages));
  const int prev = r.rel - 1;
  if (threadIdx.x == 0 && prev >= 0 && prev + kRingStages < r.total) {
    mbar_wait(r.bars + 8 * (kRingStages + prev % kRingStages), (prev / kRingStages) & 1);
    ring_request(r, prev + kRingStages);
  }
  __syncwarp();  // thread 0's lanes wait for it before the next wgmma
  ++r.rel;
}

// acc (64 x 128) += A (fragments a[A0 .. A0 + 4 NK)) * the job in `stage`
// (16 NK rows x 128 columns: two chunks of 64), issued as one wgmma group.
template <int NK, int A0, int NA>
__device__ __forceinline__ void mma128(float (&acc)[64], const uint32_t (&a)[NA], uint32_t stage) {
  static_assert(A0 + 4 * NK <= NA, "fragments");
  const uint64_t db = sw128_desc(stage, NK * 16 * 128, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    wgmma_64x128x16_rs(acc, a[A0 + 4 * kk], a[A0 + 4 * kk + 1], a[A0 + 4 * kk + 2],
                       a[A0 + 4 * kk + 3], db + 128 * kk);
  wgmma_commit();
}

// The same into a 64-column accumulator (a job of 16 NK rows x 64).
template <int NK, int A0, int NA>
__device__ __forceinline__ void mma64(float (&acc)[32], const uint32_t (&a)[NA], uint32_t stage) {
  static_assert(A0 + 4 * NK <= NA, "fragments");
  const uint64_t db = sw128_desc(stage, NK * 16 * 128, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    wgmma_64x64x16_rs(acc, a[A0 + 4 * kk], a[A0 + 4 * kk + 1], a[A0 + 4 * kk + 2],
                      a[A0 + 4 * kk + 3], db + 128 * kk);
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
}

// Retires the oldest job in flight: with kAll every group, else all but the
// newest (whose products still run).
template <bool kAll>
__device__ __forceinline__ void retire(Ring& ring) {
  if (kAll) wgmma_wait<0>();
  else wgmma_wait<1>();
  ring_release(ring);
}

// One job of the ring into acc: wait for it, multiply, release it.
template <int NK, int A0, int NA>
__device__ __forceinline__ void job128(Ring& ring, float (&acc)[64], const uint32_t (&a)[NA]) {
  mma128<NK, A0>(acc, a, ring_next(ring));
  retire<true>(ring);
}
template <int NK, int A0, int NA>
__device__ __forceinline__ void job64(Ring& ring, float (&acc)[32], const uint32_t (&a)[NA]) {
  mma64<NK, A0>(acc, a, ring_next(ring));
  retire<true>(ring);
}

// acc += a (K = 256) * a layer's four K-tile jobs, one group in flight while
// the next is issued; with kSkip a fifth job first takes enc (layer 3's
// [enc | h2] input).
template <bool kSkip>
__device__ __forceinline__ void k256_128(Ring& ring, float (&acc)[64], const uint32_t (&enc)[16],
                                         const uint32_t (&a)[64]) {
  if (kSkip) mma128<4, 0>(acc, enc, ring_next(ring));
  mma128<4, 0>(acc, a, ring_next(ring));
  if (kSkip) retire<false>(ring);
  mma128<4, 16>(acc, a, ring_next(ring));
  retire<false>(ring);
  mma128<4, 32>(acc, a, ring_next(ring));
  retire<false>(ring);
  mma128<4, 48>(acc, a, ring_next(ring));
  retire<false>(ring);
  retire<true>(ring);
}
__device__ __forceinline__ void k256_64(Ring& ring, float (&acc)[32], const uint32_t (&a)[64]) {
  mma64<4, 0>(acc, a, ring_next(ring));
  mma64<4, 16>(acc, a, ring_next(ring));
  retire<false>(ring);
  mma64<4, 32>(acc, a, ring_next(ring));
  retire<false>(ring);
  mma64<4, 48>(acc, a, ring_next(ring));
  retire<false>(ring);
  retire<true>(ring);
}

// out[32 H + j] = bf16(relu(acc[2j] + b), relu(acc[2j + 1] + b)): half H of a
// 256-wide layer's output as the next product's A fragments. Accumulator
// element i is row rloc + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2q + (i & 1);
// fragment register j of k-slice j >> 2 holds elements 2 (j & 3), +1 of it.
template <int H>
__device__ __forceinline__ void bias_relu(const float (&acc)[64], const float* __restrict__ bias,
                                          uint32_t (&out)[64], const Lane& l) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 128 * H + 8 * (j >> 1) + 2 * l.q);
    out[32 * H + j] = pack_bf16(fmaxf(acc[2 * j] + b.x, 0.0f), fmaxf(acc[2 * j + 1] + b.y, 0.0f));
  }
}

}  // namespace
