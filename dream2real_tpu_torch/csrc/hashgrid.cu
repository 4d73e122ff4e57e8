// Multiresolution hash encoding (H1) for the hash-grid NeRF field, forward
// and the table's gradient.
//
// Replaces no Pallas kernel: the JAX package encodes with plain jnp gathers
// (dream2real_tpu/nerf/hashgrid.py::hash_encode) and trains the MLP field on
// the TPU instead, because hash tables are a poor fit there. It was added so
// that Instant-NGP's field trains on the card without the plain version's
// per-level index tensors (8 int64 corners a point a level, about 16 MB a
// level at a training step's 2^18 points) and index_select's scatter-add.
//
// Computes what nerf/hashgrid.py::hash_encode_plain computes, for N points
// in [0, 1]^3 (clamped here) and an (L, T, F) float32 table, T a power of
// two: per level l at resolution res_l, the cell x0 = clamp(floor(p res_l),
// 0, res_l - 1) and weights w = p res_l - x0; the 8 corners (x fastest)
// indexed densely (x + (res+1) (y + (res+1) z)) where the level's dense grid
// fits in T, else by instant-ngp's spatial hash (x ^ y 2654435761 ^ z
// 805459861), both & (T - 1); the corner weight (wx wy) wz from w or 1 - w;
// the feature the sum over corners, in order, of entry * weight. Every
// product and sum rounds separately (no contraction into FMAs), in float32,
// as the plain version does; the output is rounded to bf16 once. The
// backward adds dL/dfeature * corner weight into a float32 table gradient
// the caller zeroed, with atomics (their order, so the sums' rounding, varies
// from run to run). No positions gradient: the field's positions take none.
//
// Bound on the H100: latency of the gathers and atomics, not bytes or
// operations. The bytes a call cannot avoid are 12 of position in and 2 F L
// of features out a point (the backward: the feature gradient in and the
// table gradient written once); the 8 corner reads or atomics a point a
// level are 32-byte sectors scattered over a table of L T F 4 bytes (64 MiB
// at the published widths), most of them L2 hits for the coarse, dense
// levels and misses for the fine, hashed ones.
//
// Design: one thread a (point, level), the level fastest, so a warp writes
// its points' features as one contiguous run and reads their positions
// together; F features of a corner are one vector load (and, for F = 2, one
// float2 atomic). The level's resolution and kind come as kernel arguments
// (a struct by value), so a launch copies nothing from the host and can be
// captured in a CUDA graph. The level's arithmetic (the cell, the corners'
// rows and weights, the sum) is hash.cuh's, which H2 (hash_march.cu) shares.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

using hashenc::Levels;
using hashenc::kMaxLevels;

constexpr int kThreads = 256;

// Point p's position, clamped to [0, 1]^3.
__device__ __forceinline__ void clamped(const float* __restrict__ pos, int p, float q[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) q[d] = hashenc::hash_clamp01(pos[3 * p + d]);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_fwd(const float* __restrict__ pos, const float* __restrict__ table, int n, int L,
             uint32_t T, Levels lv, __nv_bfloat16* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n * L) return;
  const int p = t / L, l = t - p * L;
  float q[3];
  clamped(pos, p, q);
  float acc[F];
  hashenc::hash_level<F>(q, table + size_t(l) * T * F, lv.res[l], lv.dense[l] != 0, T - 1u, acc);
  __nv_bfloat16* o = out + size_t(t) * F;
#pragma unroll
  for (int f = 0; f < F; ++f) o[f] = __float2bfloat16_rn(acc[f]);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_bwd(const float* __restrict__ pos, const __nv_bfloat16* __restrict__ dout, int n, int L,
             uint32_t T, Levels lv, float* __restrict__ dtable) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n * L) return;
  const int p = t / L, l = t - p * L;
  const int res = lv.res[l];
  const bool dense = lv.dense[l] != 0;
  float q[3];
  clamped(pos, p, q);
  uint32_t x0[3];
  float w[3];
  hashenc::hash_locate(q, res, x0, w);
  float g[F];
#pragma unroll
  for (int f = 0; f < F; ++f) g[f] = __bfloat162float(dout[size_t(t) * F + f]);
  float* level = dtable + size_t(l) * T * F;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float wc;
    const uint32_t idx = hashenc::hash_corner(c, x0, w, res, dense, T - 1u, &wc);
    float* row = level + size_t(idx) * F;
    if constexpr (F == 2) {
      atomicAdd(reinterpret_cast<float2*>(row), make_float2(__fmul_rn(g[0], wc),
                                                            __fmul_rn(g[1], wc)));
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) atomicAdd(row + f, __fmul_rn(g[f], wc));
    }
  }
}

// The arguments both launches share, checked; false on a shape the kernels
// do not take.
bool levels_of(int n, int L, int F, int log2_t, const int* res, const int* dense, Levels* lv) {
  if (n < 0 || L <= 0 || L > kMaxLevels || log2_t < 0 || log2_t > 30) return false;
  if (F != 1 && F != 2 && F != 4 && F != 8) return false;
  if (int64_t(n) * L >= (int64_t(1) << 31)) return false;
  for (int l = 0; l < L; ++l) {
    if (res[l] < 1) return false;
    lv->res[l] = res[l];
    lv->dense[l] = dense[l];
  }
  return true;
}

}  // namespace

// The features of n points: pos (n, 3) f32, table (L, 2^log2_t, F) f32,
// res / dense the levels' resolutions and kinds (host arrays of L) ->
// out (n, L F) bf16.
extern "C" int d2r_hash_fwd(const void* pos, const void* table, int n, int L, int F, int log2_t,
                            const int* res, const int* dense, void* out, void* stream) {
  Levels lv = {};
  if (!levels_of(n, L, F, log2_t, res, dense, &lv)) return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaSuccess);
  const int blocks = int((int64_t(n) * L + kThreads - 1) / kThreads);
  const uint32_t T = 1u << log2_t;
  const float* p = static_cast<const float*>(pos);
  const float* tab = static_cast<const float*>(table);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: hash_fwd<1><<<blocks, kThreads, 0, s>>>(p, tab, n, L, T, lv, o); break;
    case 2: hash_fwd<2><<<blocks, kThreads, 0, s>>>(p, tab, n, L, T, lv, o); break;
    case 4: hash_fwd<4><<<blocks, kThreads, 0, s>>>(p, tab, n, L, T, lv, o); break;
    default: hash_fwd<8><<<blocks, kThreads, 0, s>>>(p, tab, n, L, T, lv, o); break;
  }
  return int(cudaGetLastError());
}

// The table's gradient: dout (n, L F) bf16 -> added into dtable (L, 2^log2_t,
// F) f32, which the caller zeroes.
extern "C" int d2r_hash_bwd(const void* pos, const void* dout, int n, int L, int F, int log2_t,
                            const int* res, const int* dense, void* dtable, void* stream) {
  Levels lv = {};
  if (!levels_of(n, L, F, log2_t, res, dense, &lv)) return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaSuccess);
  const int blocks = int((int64_t(n) * L + kThreads - 1) / kThreads);
  const uint32_t T = 1u << log2_t;
  const float* p = static_cast<const float*>(pos);
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(dout);
  float* dt = static_cast<float*>(dtable);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: hash_bwd<1><<<blocks, kThreads, 0, s>>>(p, g, n, L, T, lv, dt); break;
    case 2: hash_bwd<2><<<blocks, kThreads, 0, s>>>(p, g, n, L, T, lv, dt); break;
    case 4: hash_bwd<4><<<blocks, kThreads, 0, s>>>(p, g, n, L, T, lv, dt); break;
    default: hash_bwd<8><<<blocks, kThreads, 0, s>>>(p, g, n, L, T, lv, dt); break;
  }
  return int(cudaGetLastError());
}
