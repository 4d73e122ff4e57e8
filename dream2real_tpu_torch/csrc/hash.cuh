// The multiresolution hash encoding's per-level arithmetic, shared by H1
// (hashgrid.cu: one thread a (point, level)) and H2 (hash_march.cu: one
// thread a ray, every level of each of its samples), so that both encode a
// point with the same operations: nerf/hashgrid.py::hash_encode_plain's.
//
// A point q in [0, 1]^3 (clamped by the caller, hash_clamp01) at resolution
// res: the cell x0 = clamp(floor(q res), 0, res - 1) and weights w = q res -
// x0; corner c (x fastest) indexed densely (x + (res+1) (y + (res+1) z))
// where the level's dense grid fits in the table, else by instant-ngp's
// spatial hash (x ^ y 2654435761 ^ z 805459861), both & (T - 1); its weight
// (wx wy) wz from w or 1 - w. Every product and sum rounds separately (no
// contraction into FMAs), in float32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hashenc {

constexpr int kMaxLevels = 32;
constexpr uint32_t kPrimeY = 2654435761u;
constexpr uint32_t kPrimeZ = 805459861u;

// Each level's resolution and kind (1: dense), passed to a kernel by value.
struct Levels {
  int res[kMaxLevels];
  int dense[kMaxLevels];
};

__device__ __forceinline__ float hash_clamp01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// The cell and the interpolation weights of the clamped point q at res.
__device__ __forceinline__ void hash_locate(const float q[3], int res, uint32_t x0[3], float w[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float xf = __fmul_rn(q[d], float(res));
    const int xi = min(max(int(floorf(xf)), 0), res - 1);
    x0[d] = uint32_t(xi);
    w[d] = __fsub_rn(xf, float(xi));
  }
}

// Corner c's table row (x fastest) and weight.
__device__ __forceinline__ uint32_t hash_corner(int c, const uint32_t x0[3], const float w[3],
                                                int res, bool dense, uint32_t mask,
                                                float* weight) {
  const uint32_t x = x0[0] + (c & 1), y = x0[1] + ((c >> 1) & 1), z = x0[2] + ((c >> 2) & 1);
  const float wx = (c & 1) ? w[0] : __fsub_rn(1.0f, w[0]);
  const float wy = (c & 2) ? w[1] : __fsub_rn(1.0f, w[1]);
  const float wz = (c & 4) ? w[2] : __fsub_rn(1.0f, w[2]);
  *weight = __fmul_rn(__fmul_rn(wx, wy), wz);
  uint32_t idx;
  if (dense) {
    const uint32_t s = uint32_t(res) + 1u;
    idx = x + s * (y + s * z);
  } else {
    idx = x ^ (y * kPrimeY) ^ (z * kPrimeZ);
  }
  return idx & mask;
}

template <int F>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<4> { using T = float4; };

// The F features of one table row, one vector load (two for F = 8).
template <int F>
__device__ __forceinline__ void hash_load_row(const float* __restrict__ row, float out[F]) {
  if constexpr (F == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
    const typename Vec<F>::T v = __ldg(reinterpret_cast<const typename Vec<F>::T*>(row));
    const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
    for (int i = 0; i < F; ++i) out[i] = f[i];
  }
}

// The level's F features of q (clamped): the sum over corners, in order, of
// entry * weight, in float32 (not rounded here).
template <int F>
__device__ __forceinline__ void hash_level(const float q[3], const float* __restrict__ level,
                                           int res, bool dense, uint32_t mask, float acc[F]) {
  uint32_t x0[3];
  float w[3];
  hash_locate(q, res, x0, w);
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float wc;
    const uint32_t idx = hash_corner(c, x0, w, res, dense, mask, &wc);
    float e[F];
    hash_load_row<F>(level + size_t(idx) * F, e);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(e[f], wc));
  }
}

}  // namespace hashenc
