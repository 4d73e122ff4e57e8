// Inline-PTX parts of the Hopper kernels (attention.cu, train.cu): shared
// memory addresses, mbarriers, bulk copies, wgmma descriptors and the wgmma
// shapes both sources use; and the launchers' shared-memory opt-in (all
// three sources). sm_90a only.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Orders this thread's shared-memory writes before reads by the async proxy
// (wgmma operands, TMA).
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled tile whose rows are 128
// bytes (64 bf16) and whose base is 1024-byte aligned. K-major operands
// (rows = M or N, the 64 columns = K): sbo is the distance between groups of
// 8 rows, lbo is unused. MN-major operands (rows = K, columns = 64 of M or
// N): sbo is the distance between groups of 8 K rows, lbo the distance
// between chunks of 64 columns.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFFu) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}
// Byte offset of 16-byte chunk c of row r in such a tile.
__device__ __forceinline__ uint32_t sw128_off(int r, int c) {
  return uint32_t(r) * 128u + (uint32_t(c ^ (r & 7)) << 4);
}

#define D2R_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D2R_F16(d, i) D2R_F4(d, i), D2R_F4(d, i + 4), D2R_F4(d, i + 8), D2R_F4(d, i + 12)

// d (64 x 64 f32) += A (64 x 16 bf16, this thread's fragment registers) * B
// (16 x 64, shared, MN-major: rows = K).
__device__ __forceinline__ void wgmma_64x64x16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                  uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"  // accumulate
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : D2R_F16(d, 0), D2R_F16(d, 16)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db));
}

// Two f32 rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Spins until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Raises a kernel's dynamic shared-memory limit to `bytes` on the current
// device, once a device: `done` holds one bit a device, set with an atomic
// OR, so that launches that alternate between cards, or come from several
// host threads, neither raise it again nor race. Raising it twice is
// harmless, so two threads that both find the bit clear may both call.
// Devices past the 64th raise it on every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<unsigned long long>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done->load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && bit) done->fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace
