// Fused NeRF training kernels K5-K8 for the flagship mlp field.
//
// Replaces: dream2real_tpu/nerf/train_kernel.py, the Pallas bodies
//   K5 _density_sampler_kernel (density_sample_fused),
//   K6 _train_fwd_kernel (render_train_fused forward),
//   K7 _train_bwd_kernel (render_train_fused backward),
//   K8 _density_weights_kernel (density_weights_fused).
// Rays are flat, each with its own origin and its own sorted sample
// positions ts (R, S). Per sample: the deg-10 frequency encoding (affine
// angles in t), the 5x256 trunk with the skip at layer 3, the unfolded head
// h4 = [sigma | geo 15] (bf16), the 3-layer colour MLP on [geo | SH deg 4],
// sigma masked to the field box, and the front-to-back composite (last delta
// 1e2). bf16 matmul inputs with f32 accumulation and bias, bf16 rounding
// between layers, f32 exp / sigmoid / composite, as the reference. The
// sample position, encoding angles and world position are single-rounding
// fused multiply-adds, as the reference's compiled kernel computes them.
//
// Bound on the H100: tensor-core operations. Per sample 233,472 trunk MACs
// (231,424 for the density-only K5/K8) and 6,592 colour MACs; K7 recomputes
// the forward and does about twice its matmul work again. Inputs and outputs
// are a few MB (ts is 2 MB at 8192 x 64).
//
// Design. A block owns 64 rays and keeps every activation of the current
// sample resident in shared memory, one bf16 row per ray:
//   [h0 256 | h1 256 | enc 64 | h2 256 | h3 256 | h4 16 | SH 16 | c0 64 | c1 64 | d16 16]
// so that [enc | h2] is layer 3's input and [h4 | SH] the colour layer's
// (whose packed weight has a zero row against sigma). Matmuls of the rows
// (x @ W) use WMMA bf16 fragments with f32 accumulators: warp w owns 16 rays
// (w & 3) and every other 16-column tile (w >> 2); the weights stream from L2
// through one shared K-tile that all warps read. K7 walks the samples in
// forward order, recomputes them, and closes the composite backward with the
// running prefix P_s of w_j g_j and G_total from the saved outputs. Its
// backward matmuls write each delta in place over the activation it masks
// (once that activation's weight gradient is taken). Weight gradients are
// block-level GEMMs over the block's 64 rays (activation^T x delta) added,
// sample by sample, into the block's own f32 partial in device memory; a
// second kernel sums the partials in block order. No atomics: the gradients
// are the same from run to run, and the ray-gradient chain (a runtime flag)
// never touches them. Rays past the end are bounds-checked: they march at
// t = 0 with zero cotangents, so they add exactly zero to every gradient.
// Weight layout: dream2real_tpu_torch/nerf/train_kernel.py (W_LAYOUT,
// B_LAYOUT, G_LAYOUT).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kRays = 64;   // rays per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLd = 1272;   // activation row: 1264 columns + 8 pad (bf16)
constexpr int kKT = 32;     // weight rows staged per tile
constexpr int kWLd = 328;   // widest layer (320) + 8 pad
constexpr int kFLd = 88;    // per-ray f32 row

// Activation columns (multiples of 16: WMMA tiles start there).
constexpr int kH0 = 0, kH1 = 256, kEnc = 512, kH2 = 576, kH3 = 832, kH4 = 1088, kSh = 1104,
              kC0 = 1120, kC1 = 1184, kD16 = 1248;
// Per-ray f32 columns.
constexpr int kFRgb = 0;   // rgb logits 0..2, dx_sigma at 3
constexpr int kFGeo = 4;   // 16: dcin, then dh4 = [dx_sigma | dgeo 15]
constexpr int kFEnc = 20;  // 64: dL/denc (ray gradients); K5's coarse weights

// Packed bf16 weights, each (K x N) row-major.
constexpr int kW0 = 0, kW1 = 16384, kW2 = 81920, kW3 = 147456, kW4 = 229376, kCW0 = 233472,
              kCW1 = 235520, kCW2 = 239616;
constexpr int kW4T = 240640, kW3T = 244736, kW2T = 326656, kW1T = 392192, kW0T = 457728,
              kCW2T = 474112, kCW1T = 475136, kCW0T = 479232;
constexpr int kB0 = 0, kB1 = 256, kB2 = 512, kB3 = 768, kB4 = 1024;
// f32 gradient partial of one block.
constexpr int kGW0 = 0, kGW1 = 16384, kGW2 = 81920, kGW3 = 147456, kGW4 = 229376,
              kGCW0 = 233472, kGCW1 = 235520, kGCW2 = 239616, kGB0 = 240640, kGB1 = 240896,
              kGB2 = 241152, kGB3 = 241408, kGB4 = 241664;
constexpr int kGSize = 241680;

constexpr size_t kActBytes = size_t(kRays) * kLd * 2;
constexpr size_t kWBytes = size_t(kKT) * kWLd * 2;
constexpr size_t kScratchBytes = size_t(kWarps) * 256 * 4;
constexpr size_t kColBytes = size_t(4) * 320 * 4;
constexpr size_t kFBytes = size_t(kRays) * kFLd * 4;
constexpr size_t kSmemBytes = kActBytes + kWBytes + kScratchBytes + kColBytes + kFBytes;

constexpr float kPi = 3.14159265358979323846f;

struct Smem {
  bf16* act;
  bf16* w;
  float* scratch;
  float* colsum;  // (4 warp rows) x 320 column sums of a bias gradient
  float* f;
};

__device__ __forceinline__ Smem smem_layout(unsigned char* raw) {
  Smem sm;
  sm.act = reinterpret_cast<bf16*>(raw);
  sm.w = reinterpret_cast<bf16*>(raw + kActBytes);
  sm.scratch = reinterpret_cast<float*>(raw + kActBytes + kWBytes);
  sm.colsum = reinterpret_cast<float*>(raw + kActBytes + kWBytes + kScratchBytes);
  sm.f = reinterpret_cast<float*>(raw + kActBytes + kWBytes + kScratchBytes + kColBytes);
  return sm;
}

enum Epilogue {
  kBiasRelu,   // act[out + c] = bf16(relu(v + b[c]))
  kBias,       // act[out + c] = bf16(v + b[c])
  kRelu,       // act[out + c] = bf16(relu(v))
  kRgbOut,     // f[kFRgb + c] = v, c < 3
  kMask,       // act[out + c] = bf16(act[out + c] > 0 ? v : 0)
  kMaskBias,   // the same, and the masked f32 column sums into colsum
  kToF,        // f[kFGeo + c] = v
  kDhcat,      // c < 64: f[kFEnc + c] = v (ray gradients); else kMaskBias into h2
  kDencAdd,    // f[kFEnc + c] += v
};

// out(64 x N) = act[:, a_col : a_col + K] @ W (K x N, row-major in device
// memory), then the epilogue. Starts with a block barrier: every earlier
// write to the activations is visible.
template <int N, int K, int EPI>
__device__ __forceinline__ void gemm_rows(const Smem& sm, int a_col, const bf16* __restrict__ W,
                                          const float* __restrict__ bias, int out_col,
                                          bool ray_grads) {
  constexpr int NT = N / 16;
  constexpr int NJ = (NT + 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 3, cg = warp >> 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.0f);
  const bf16* a_base = sm.act + (rg * 16) * kLd + a_col;
  constexpr int kVec = N / 8;
  for (int kt = 0; kt < K; kt += kKT) {
    const int rows = (K - kt) < kKT ? (K - kt) : kKT;
    __syncthreads();  // the previous tile (and earlier epilogues) are done
    for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
      const int r = i / kVec, c = (i - r * kVec) * 8;
      *reinterpret_cast<uint4*>(sm.w + r * kWLd + c) =
          *reinterpret_cast<const uint4*>(W + size_t(kt + r) * N + c);
    }
    __syncthreads();
    for (int kk = 0; kk < rows; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_base + kt + kk, kLd);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = cg + 2 * j;
        if (n < NT) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, sm.w + kk * kWLd + n * 16, kWLd);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
  }
  float* scr = sm.scratch + warp * 256;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = cg + 2 * j;
    if (n >= NT) continue;
    __syncwarp();
    wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int row = rg * 16 + (e >> 4);
      const int c = n * 16 + (e & 15);
      const float v = scr[e];
      bf16* arow = sm.act + row * kLd;
      float* frow = sm.f + row * kFLd;
      if constexpr (EPI == kBiasRelu) {
        arow[out_col + c] = __float2bfloat16_rn(fmaxf(v + bias[c], 0.0f));
      } else if constexpr (EPI == kBias) {
        arow[out_col + c] = __float2bfloat16_rn(v + bias[c]);
      } else if constexpr (EPI == kRelu) {
        arow[out_col + c] = __float2bfloat16_rn(fmaxf(v, 0.0f));
      } else if constexpr (EPI == kRgbOut) {
        if (c < 3) frow[kFRgb + c] = v;
      } else if constexpr (EPI == kMask || EPI == kMaskBias) {
        const float m = __bfloat162float(arow[out_col + c]) > 0.0f ? v : 0.0f;
        arow[out_col + c] = __float2bfloat16_rn(m);
        scr[e] = m;
      } else if constexpr (EPI == kToF) {
        frow[kFGeo + c] = v;
      } else if constexpr (EPI == kDhcat) {
        if (c < 64) {
          if (ray_grads) frow[kFEnc + c] = v;
        } else {
          const float m = __bfloat162float(arow[kH2 + c - 64]) > 0.0f ? v : 0.0f;
          arow[kH2 + c - 64] = __float2bfloat16_rn(m);
          scr[e] = m;
        }
      } else if constexpr (EPI == kDencAdd) {
        frow[kFEnc + c] = v + frow[kFEnc + c];
      }
    }
    if constexpr (EPI == kMaskBias || EPI == kDhcat) {
      const int base = (EPI == kDhcat) ? n * 16 - 64 : n * 16;
      if (base >= 0) {
        __syncwarp();
        if (lane < 16) {
          float s = 0.0f;
          for (int i = 0; i < 16; ++i) s += scr[i * 16 + lane];
          sm.colsum[rg * 320 + base + lane] = s;
        }
      }
    }
  }
}

// db[c] (+)= sum over the block's rays of the last kMaskBias / kDhcat delta,
// in a fixed order.
template <int N>
__device__ __forceinline__ void bias_reduce(const Smem& sm, float* __restrict__ db, bool first) {
  __syncthreads();
  for (int c = threadIdx.x; c < N; c += kThreads) {
    const float v = ((sm.colsum[c] + sm.colsum[320 + c]) + sm.colsum[640 + c]) + sm.colsum[960 + c];
    db[c] = first ? v : db[c] + v;
  }
}

// dW (K x N, f32 row-major in device memory) (+)= act[:, a_col : a_col + K]^T
// @ act[:, d_col : d_col + N] over the block's 64 rays. Each warp takes four
// 16x16 output tiles at a time, so that their loads overlap.
template <int K, int N>
__device__ __forceinline__ void grad_gemm(const Smem& sm, int a_col, int d_col,
                                          float* __restrict__ dW, bool first) {
  constexpr int NT = N / 16, T = (K / 16) * NT, kBatch = 4;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  for (int t0 = warp * kBatch; t0 < T; t0 += kWarps * kBatch) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int t = t0 + i;
      if (t < T) {
        if (first) {
          wmma::fill_fragment(acc[i], 0.0f);
        } else {
          wmma::load_matrix_sync(acc[i], dW + (t / NT) * 16 * N + (t % NT) * 16, N,
                                 wmma::mem_row_major);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRays; r += 16) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int t = t0 + i;
        if (t < T) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
          wmma::load_matrix_sync(a, sm.act + r * kLd + a_col + (t / NT) * 16, kLd);
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, sm.act + r * kLd + d_col + (t % NT) * 16, kLd);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int t = t0 + i;
      if (t < T) {
        wmma::store_matrix_sync(dW + (t / NT) * 16 * N + (t % NT) * 16, acc[i], N,
                                wmma::mem_row_major);
      }
    }
  }
}

// The field at the current sample: enc -> h0..h4, then (colour) c0, c1 and
// the rgb logits.
template <bool kColour>
__device__ __forceinline__ void field_forward(const Smem& sm, const bf16* __restrict__ W,
                                              const float* __restrict__ B) {
  gemm_rows<256, 64, kBiasRelu>(sm, kEnc, W + kW0, B + kB0, kH0, false);
  gemm_rows<256, 256, kBiasRelu>(sm, kH0, W + kW1, B + kB1, kH1, false);
  gemm_rows<256, 256, kBiasRelu>(sm, kH1, W + kW2, B + kB2, kH2, false);
  gemm_rows<256, 320, kBiasRelu>(sm, kEnc, W + kW3, B + kB3, kH3, false);
  gemm_rows<16, 256, kBias>(sm, kH3, W + kW4, B + kB4, kH4, false);
  if (kColour) {
    gemm_rows<64, 32, kRelu>(sm, kH4, W + kCW0, nullptr, kC0, false);
    gemm_rows<64, 64, kRelu>(sm, kC0, W + kCW1, nullptr, kC1, false);
    gemm_rows<16, 64, kRgbOut>(sm, kC1, W + kCW2, nullptr, 0, false);
  }
  __syncthreads();
}

__device__ __forceinline__ float pick3(const float* v, int c) {
  return c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
}

// One ray of the block: four threads share it (q = 0..3); q == 0 owns its
// composite state.
struct Ray {
  int r, q;
  long g;
  bool in_range;
  float o[3], d[3], lo[3], hi[3], scale[3], a3[3], b3[3], dn;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origins,
                                        const float* __restrict__ dirs, int n_rays,
                                        const float* __restrict__ box) {
  Ray ray;
  ray.r = threadIdx.x & (kRays - 1);
  ray.q = threadIdx.x / kRays;
  ray.g = long(blockIdx.x) * kRays + ray.r;
  ray.in_range = ray.g < n_rays;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ray.o[c] = ray.in_range ? origins[ray.g * 3 + c] : 0.0f;
    ray.d[c] = ray.in_range ? dirs[ray.g * 3 + c] : (c == 2 ? 1.0f : 0.0f);
    ray.lo[c] = box[c];
    ray.hi[c] = box[3 + c];
    ray.scale[c] = 2.0f / (ray.hi[c] - ray.lo[c]);
    ray.a3[c] = fmaf(ray.o[c], ray.scale[c], -2.0f * ray.lo[c] / (ray.hi[c] - ray.lo[c]) - 1.0f);
    ray.b3[c] = __fmul_rn(ray.d[c], ray.scale[c]);
  }
  ray.dn = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(ray.d[0], ray.d[0]), __fmul_rn(ray.d[1], ray.d[1])),
                           __fmul_rn(ray.d[2], ray.d[2])));
  return ray;
}

// SH basis of the unit direction (model.sh_encode_deg4), constant along the ray.
__device__ __forceinline__ void write_sh(const Smem& sm, const Ray& ray) {
  if (ray.q != 0) return;
  const float x = ray.d[0] / ray.dn, y = ray.d[1] / ray.dn, z = ray.d[2] / ray.dn;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  const float sh[16] = {
      0.28209479177387814f,
      -0.48860251190291987f * y,
      0.48860251190291987f * z,
      -0.48860251190291987f * x,
      1.0925484305920792f * xy,
      -1.0925484305920792f * yz,
      0.94617469575755997f * zz - 0.31539156525251999f,
      -1.0925484305920792f * xz,
      0.54627421529603959f * (xx - yy),
      0.59004358992664352f * y * (-3.0f * xx + yy),
      2.8906114426405538f * xy * z,
      0.45704579946446572f * y * (1.0f - 5.0f * zz),
      0.3731763325901154f * z * (5.0f * zz - 3.0f),
      0.45704579946446572f * x * (1.0f - 5.0f * zz),
      1.4453057213202769f * z * (xx - yy),
      0.59004358992664352f * x * (-xx + 3.0f * yy),
  };
  bf16* arow = sm.act + ray.r * kLd;
#pragma unroll
  for (int k = 0; k < 16; ++k) arow[kSh + k] = __float2bfloat16_rn(sh[k]);
}

__device__ __forceinline__ float angle(const Ray& ray, int idx, float t) {
  const int j = idx / 3, c = idx - 3 * j;
  const float freq = ldexpf(kPi, j);
  return fmaf(__fmul_rn(pick3(ray.b3, c), freq), t, __fmul_rn(pick3(ray.a3, c), freq));
}

// Encoding [p2 | sin(ang) | cos(ang) | 0] of sample position t, ang = A + B t
// with A = a3 f_j, B = b3 f_j (freq-major, like posenc).
__device__ __forceinline__ void encode(const Smem& sm, const Ray& ray, float t) {
  bf16* arow = sm.act + ray.r * kLd + kEnc;
  for (int idx = ray.q; idx < 30; idx += 4) {
    float sv, cv;
    sincosf(angle(ray, idx, t), &sv, &cv);
    arow[3 + idx] = __float2bfloat16_rn(sv);
    arow[33 + idx] = __float2bfloat16_rn(cv);
  }
  if (ray.q == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) arow[c] = __float2bfloat16_rn(fmaf(ray.b3[c], t, ray.a3[c]));
  } else if (ray.q == 1) {
    arow[63] = __float2bfloat16_rn(0.0f);
  }
}

// sigma at sample position t: trunc_exp of the bf16 head, zero outside the box.
__device__ __forceinline__ float sample_sigma(const Smem& sm, const Ray& ray, float t) {
  float sigma = expf(fminf(fmaxf(__bfloat162float(sm.act[ray.r * kLd + kH4]), -15.0f), 15.0f));
  bool inside = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float pc = fmaf(ray.d[c], t, ray.o[c]);
    inside = inside && pc >= ray.lo[c] && pc <= ray.hi[c];
  }
  return inside ? sigma : 0.0f;
}

__device__ __forceinline__ float sample_t(const float* __restrict__ ts, const Ray& ray, int S,
                                          int s) {
  return ray.in_range ? ts[ray.g * S + s] : 0.0f;
}

__device__ __forceinline__ float sample_delta(const float* __restrict__ ts, const Ray& ray, int S,
                                              int s, float t) {
  return s == S - 1 ? 1e2f : sample_t(ts, ray, S, s + 1) - t;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// K6: per-ray composite of the full field at ts.
__global__ void __launch_bounds__(kThreads, 1)
    train_fwd_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                     const float* __restrict__ ts, int n_rays, int S,
                     const float* __restrict__ box, const bf16* __restrict__ W,
                     const float* __restrict__ B, float min_trans, float* __restrict__ out_rgb,
                     float* __restrict__ out_alpha, float* __restrict__ out_depth) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem sm = smem_layout(smem_raw);
  const Ray ray = load_ray(origins, dirs, n_rays, box);
  write_sh(sm, ray);
  float trans = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f, acc_d = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float t = sample_t(ts, ray, S, s);
    encode(sm, ray, t);
    field_forward<true>(sm, W, B);
    if (ray.q == 0) {
      const float sigma = sample_sigma(sm, ray, t);
      const float* fr = sm.f + ray.r * kFLd;
      const float a = 1.0f - expf(-sigma * sample_delta(ts, ray, S, s, t) * ray.dn);
      const float w = (trans < min_trans) ? 0.0f : a * trans;
      acc_r += w * sigmoid(fr[kFRgb + 0]);
      acc_g += w * sigmoid(fr[kFRgb + 1]);
      acc_b += w * sigmoid(fr[kFRgb + 2]);
      acc_a += w;
      acc_d += w * t;
      // Written exactly as the reference: (1 - a) + 1e-10, never reassociated.
      trans = trans * (1.0f - a + 1e-10f);
    }
  }
  if (ray.q == 0 && ray.in_range) {
    out_rgb[ray.g * 3 + 0] = acc_r;
    out_rgb[ray.g * 3 + 1] = acc_g;
    out_rgb[ray.g * 3 + 2] = acc_b;
    out_alpha[ray.g] = acc_a;
    out_depth[ray.g] = acc_d;
  }
}

// Coarse density pass shared by K5 and K8: the composite weight of sample s
// goes to out[s] (stride `stride`) of the ray's owner thread.
__device__ __forceinline__ void coarse_pass(const Smem& sm, const Ray& ray,
                                            const float* __restrict__ ts, int S,
                                            const bf16* __restrict__ W,
                                            const float* __restrict__ B, float min_trans,
                                            float* out, int stride) {
  float trans = 1.0f;
  for (int s = 0; s < S; ++s) {
    const float t = sample_t(ts, ray, S, s);
    encode(sm, ray, t);
    field_forward<false>(sm, W, B);
    if (ray.q == 0) {
      const float sigma = sample_sigma(sm, ray, t);
      const float a = 1.0f - expf(-sigma * sample_delta(ts, ray, S, s, t) * ray.dn);
      if (out != nullptr) out[s * stride] = (trans < min_trans) ? 0.0f : a * trans;
      trans = trans * (1.0f - a + 1e-10f);
    }
  }
}

// K8: coarse composite weights (R, S).
__global__ void __launch_bounds__(kThreads, 1)
    density_weights_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                           const float* __restrict__ ts, int n_rays, int S,
                           const float* __restrict__ box, const bf16* __restrict__ W,
                           const float* __restrict__ B, float min_trans,
                           float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem sm = smem_layout(smem_raw);
  const Ray ray = load_ray(origins, dirs, n_rays, box);
  coarse_pass(sm, ray, ts, S, W, B, min_trans, ray.in_range ? out + ray.g * S : nullptr, 1);
}

// K5: coarse pass over nc samples, then n_draw sorted inverse-CDF draws from
// the defensive mixture w + mix_ratio * mean(w) + 1e-8 (mix_ratio =
// mix / (1 - mix)): the draws are normalised prefix sums of Exp(1) numbers,
// ascending by construction, and the bin pointer only moves forward. The CDF
// is a sequential f32 prefix sum, strictly increasing, so the forward scan
// picks the bin the reference's one-hot picks.
__global__ void __launch_bounds__(kThreads, 1)
    density_sample_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                          const float* __restrict__ ts_c, const float* __restrict__ exps,
                          int n_rays, int nc, int n_draw, const float* __restrict__ box,
                          const bf16* __restrict__ W, const float* __restrict__ B,
                          float min_trans, float mix_ratio, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem sm = smem_layout(smem_raw);
  const Ray ray = load_ray(origins, dirs, n_rays, box);
  float* wts = sm.f + ray.r * kFLd + kFEnc;
  coarse_pass(sm, ray, ts_c, nc, W, B, min_trans, wts, 1);
  if (ray.q != 0 || !ray.in_range) return;
  const float* tr = ts_c + ray.g * nc;
  const float* e = exps + ray.g * (n_draw + 1);
  float wsum = 0.0f;
  for (int k = 0; k < nc; ++k) wsum = __fadd_rn(wsum, wts[k]);
  const float floor_w = __fmul_rn(mix_ratio, wsum / float(nc));
  float total = 0.0f;
  for (int k = 0; k < nc; ++k) total = __fadd_rn(total, __fadd_rn(__fadd_rn(wts[k], floor_w), 1e-8f));
  float s_total = 0.0f;
  for (int i = 0; i <= n_draw; ++i) s_total = __fadd_rn(s_total, e[i]);
  int k = 0;
  float cdf_lo = 0.0f;
  float cdf_hi = __fadd_rn(__fadd_rn(wts[0], floor_w), 1e-8f) / total;
  float prefix = 0.0f;
  for (int i = 0; i < n_draw; ++i) {
    prefix = __fadd_rn(prefix, e[i]);
    const float u = prefix / s_total;
    while (k < nc - 1 && u >= cdf_hi) {
      ++k;
      cdf_lo = cdf_hi;
      cdf_hi = __fadd_rn(cdf_hi, __fadd_rn(__fadd_rn(wts[k], floor_w), 1e-8f) / total);
    }
    const float lo = k == 0 ? tr[0] : 0.5f * (tr[k] + tr[k - 1]);
    const float hi = k == nc - 1 ? tr[nc - 1] : 0.5f * (tr[k + 1] + tr[k]);
    const float span = cdf_hi - cdf_lo;
    const float denom = span < 1e-8f ? 1.0f : span;
    out[ray.g * n_draw + i] = lo + __fmul_rn((u - cdf_lo) / denom, hi - lo);
  }
}

// K7: recompute-forward backward. Writes this block's gradient partial and,
// with ray_grads, the origin / direction gradients of its rays.
__global__ void __launch_bounds__(kThreads, 1)
    train_bwd_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                     const float* __restrict__ ts, int n_rays, int S,
                     const float* __restrict__ box, const bf16* __restrict__ W,
                     const float* __restrict__ B, float min_trans,
                     const float* __restrict__ dC, const float* __restrict__ dA,
                     const float* __restrict__ dD, const float* __restrict__ C,
                     const float* __restrict__ A, const float* __restrict__ D, int ray_grads,
                     float* __restrict__ partials, float* __restrict__ d_origins,
                     float* __restrict__ d_dirs) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem sm = smem_layout(smem_raw);
  const Ray ray = load_ray(origins, dirs, n_rays, box);
  float* part = partials + size_t(blockIdx.x) * kGSize;
  write_sh(sm, ray);
  const bool owner = ray.q == 0;
  bf16* arow = sm.act + ray.r * kLd;
  float* frow = sm.f + ray.r * kFLd;

  // Cotangents of the ray's outputs; a ray past the end has zero ones.
  float dc[3] = {0.0f, 0.0f, 0.0f}, da = 0.0f, dd = 0.0f, g_total = 0.0f;
  if (owner && ray.in_range) {
#pragma unroll
    for (int c = 0; c < 3; ++c) dc[c] = dC[ray.g * 3 + c];
    da = dA[ray.g];
    dd = dD[ray.g];
    const float* Cr = C + ray.g * 3;
    g_total = ((dc[0] * Cr[0] + dc[1] * Cr[1]) + dc[2] * Cr[2]) + da * A[ray.g] + dd * D[ray.g];
  }
  float trans = 1.0f, P = 0.0f;
  float g_o[3] = {0.0f, 0.0f, 0.0f}, g_d[3] = {0.0f, 0.0f, 0.0f};

  for (int s = 0; s < S; ++s) {
    const bool first = s == 0;
    const float t = sample_t(ts, ray, S, s);
    // The last weight-gradient product of the previous sample reads the
    // encoding: every warp is done with it before it is overwritten.
    __syncthreads();
    encode(sm, ray, t);
    field_forward<true>(sm, W, B);

    // Composite backward, closed in this forward-ordered pass:
    // dL/dsigma_s = dl dn [m T g (1 - a) - U (1 - a) / max(1 - a, 1e-10)],
    // U = G_total - P_s; trunc_exp's gradient is y dx.
    if (owner) {
      const float sigma = sample_sigma(sm, ray, t);
      const float dl = sample_delta(ts, ray, S, s, t);
      const float a = 1.0f - expf(-sigma * dl * ray.dn);
      const float m = trans >= min_trans ? 1.0f : 0.0f;
      const float w = m * a * trans;
      float rgb[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = sigmoid(frow[kFRgb + c]);
      const float g = ((dc[0] * rgb[0] + dc[1] * rgb[1]) + dc[2] * rgb[2]) + da + dd * t;
      P = P + w * g;
      const float U = g_total - P;
      const float one_m_a = 1.0f - a;
      const float ratio = one_m_a / fmaxf(one_m_a, 1e-10f);
      const float dsigma = dl * ray.dn * (m * trans * g * one_m_a - U * ratio);
      frow[kFRgb + 3] = ray.in_range ? dsigma * sigma : 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float v = c < 3 && ray.in_range ? w * dc[c] * rgb[c] * (1.0f - rgb[c]) : 0.0f;
        arow[kD16 + c] = __float2bfloat16_rn(v);
      }
      trans = trans * (1.0f - a + 1e-10f);
    }

    // Colour head (no biases): rgb = sigmoid(c1 @ cw2).
    grad_gemm<64, 16>(sm, kC1, kD16, part + kGCW2, first);
    gemm_rows<64, 16, kMask>(sm, kD16, W + kCW2T, nullptr, kC1, false);
    grad_gemm<64, 64>(sm, kC0, kC1, part + kGCW1, first);
    gemm_rows<64, 64, kMask>(sm, kC1, W + kCW1T, nullptr, kC0, false);
    grad_gemm<32, 64>(sm, kH4, kC0, part + kGCW0, first);
    gemm_rows<16, 64, kToF>(sm, kC0, W + kCW0T, nullptr, 0, false);
    __syncthreads();
    // dh4 = [dx_sigma | dgeo 15]: its f32 column sums are db4, its bf16
    // rounding feeds the trunk.
    if (owner) {
      frow[kFGeo] = frow[kFRgb + 3];
#pragma unroll
      for (int c = 0; c < 16; ++c) arow[kD16 + c] = __float2bfloat16_rn(frow[kFGeo + c]);
    }
    __syncthreads();
    if (threadIdx.x < 16) {
      float sum = 0.0f;
      for (int r = 0; r < kRays; ++r) sum += sm.f[r * kFLd + kFGeo + threadIdx.x];
      part[kGB4 + threadIdx.x] = first ? sum : part[kGB4 + threadIdx.x] + sum;
    }

    // Trunk: each delta overwrites the activation whose mask it applies.
    grad_gemm<256, 16>(sm, kH3, kD16, part + kGW4, first);
    gemm_rows<256, 16, kMaskBias>(sm, kD16, W + kW4T, nullptr, kH3, false);
    bias_reduce<256>(sm, part + kGB3, first);
    grad_gemm<320, 256>(sm, kEnc, kH3, part + kGW3, first);
    gemm_rows<320, 256, kDhcat>(sm, kH3, W + kW3T, nullptr, 0, ray_grads != 0);
    bias_reduce<256>(sm, part + kGB2, first);
    grad_gemm<256, 256>(sm, kH1, kH2, part + kGW2, first);
    gemm_rows<256, 256, kMaskBias>(sm, kH2, W + kW2T, nullptr, kH1, false);
    bias_reduce<256>(sm, part + kGB1, first);
    grad_gemm<256, 256>(sm, kH0, kH1, part + kGW1, first);
    gemm_rows<256, 256, kMaskBias>(sm, kH1, W + kW1T, nullptr, kH0, false);
    bias_reduce<256>(sm, part + kGB0, first);
    grad_gemm<64, 256>(sm, kEnc, kH0, part + kGW0, first);
    if (!ray_grads) continue;

    // Origin / direction gradients of the geometric path: dL/denc through
    // the encoding (its bf16 cast taken as the identity) to the position.
    gemm_rows<64, 256, kDencAdd>(sm, kH0, W + kW0T, nullptr, 0, true);
    __syncthreads();
    if (owner && ray.in_range) {
      const float* de = frow + kFEnc;
      float dp2[3] = {de[0], de[1], de[2]};
      for (int j = 0; j < 10; ++j) {
        const float freq = ldexpf(kPi, j);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float sv, cv;
          sincosf(angle(ray, 3 * j + c, t), &sv, &cv);
          const float dang = de[3 + 3 * j + c] * cv - de[33 + 3 * j + c] * sv;
          dp2[c] = dp2[c] + freq * dang;
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float dpos = dp2[c] * ray.scale[c];
        g_o[c] = g_o[c] + dpos;
        g_d[c] = g_d[c] + dpos * t;
      }
    }
  }
  if (owner && ray.in_range && ray_grads) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      d_origins[ray.g * 3 + c] = g_o[c];
      d_dirs[ray.g * 3 + c] = g_d[c];
    }
  }
}

// grads[i] = sum over blocks b = 0, 1, ... of partials[b][i], in that order.
__global__ void reduce_partials_kernel(const float* __restrict__ partials, int n_blocks,
                                       float* __restrict__ grads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kGSize) return;
  float s = partials[i];
  for (int b = 1; b < n_blocks; ++b) s += partials[size_t(b) * kGSize + i];
  grads[i] = s;
}

template <typename Kernel>
int allow_smem(Kernel kernel) {
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(kSmemBytes)));
}

int blocks_for(int n_rays) { return (n_rays + kRays - 1) / kRays; }

}  // namespace

extern "C" int d2r_train_fwd(const void* origins, const void* dirs, const void* ts, int n_rays,
                             int S, const void* box, const void* w, const void* b,
                             float min_trans, void* rgb, void* alpha, void* depth,
                             void* stream) {
  if (n_rays <= 0) return 0;
  if (int err = allow_smem(train_fwd_kernel)) return err;
  train_fwd_kernel<<<blocks_for(n_rays), kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origins), static_cast<const float*>(dirs),
      static_cast<const float*>(ts), n_rays, S, static_cast<const float*>(box),
      static_cast<const bf16*>(w), static_cast<const float*>(b), min_trans,
      static_cast<float*>(rgb), static_cast<float*>(alpha), static_cast<float*>(depth));
  return int(cudaGetLastError());
}

extern "C" int d2r_density_weights(const void* origins, const void* dirs, const void* ts,
                                   int n_rays, int S, const void* box, const void* w,
                                   const void* b, float min_trans, void* out, void* stream) {
  if (n_rays <= 0) return 0;
  if (int err = allow_smem(density_weights_kernel)) return err;
  density_weights_kernel<<<blocks_for(n_rays), kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origins), static_cast<const float*>(dirs),
      static_cast<const float*>(ts), n_rays, S, static_cast<const float*>(box),
      static_cast<const bf16*>(w), static_cast<const float*>(b), min_trans,
      static_cast<float*>(out));
  return int(cudaGetLastError());
}

extern "C" int d2r_density_sample(const void* origins, const void* dirs, const void* ts_c,
                                  const void* exps, int n_rays, int nc, int n_draw,
                                  const void* box, const void* w, const void* b,
                                  float min_trans, float mix_ratio, void* out, void* stream) {
  if (n_rays <= 0) return 0;
  if (nc < 2 || nc > 64) return int(cudaErrorInvalidValue);
  if (int err = allow_smem(density_sample_kernel)) return err;
  density_sample_kernel<<<blocks_for(n_rays), kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origins), static_cast<const float*>(dirs),
      static_cast<const float*>(ts_c), static_cast<const float*>(exps), n_rays, nc, n_draw,
      static_cast<const float*>(box), static_cast<const bf16*>(w), static_cast<const float*>(b),
      min_trans, mix_ratio, static_cast<float*>(out));
  return int(cudaGetLastError());
}

extern "C" int d2r_train_bwd(const void* origins, const void* dirs, const void* ts, int n_rays,
                             int S, const void* box, const void* w, const void* b,
                             float min_trans, const void* dC, const void* dA, const void* dD,
                             const void* C, const void* A, const void* D, int ray_grads,
                             void* partials, void* grads, void* d_origins, void* d_dirs,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rays <= 0) return int(cudaMemsetAsync(grads, 0, sizeof(float) * kGSize, st));
  if (int err = allow_smem(train_bwd_kernel)) return err;
  const int blocks = blocks_for(n_rays);
  train_bwd_kernel<<<blocks, kThreads, kSmemBytes, st>>>(
      static_cast<const float*>(origins), static_cast<const float*>(dirs),
      static_cast<const float*>(ts), n_rays, S, static_cast<const float*>(box),
      static_cast<const bf16*>(w), static_cast<const float*>(b), min_trans,
      static_cast<const float*>(dC), static_cast<const float*>(dA),
      static_cast<const float*>(dD), static_cast<const float*>(C),
      static_cast<const float*>(A), static_cast<const float*>(D), ray_grads,
      static_cast<float*>(partials), static_cast<float*>(d_origins),
      static_cast<float*>(d_dirs));
  if (cudaError_t err = cudaGetLastError()) return int(err);
  reduce_partials_kernel<<<(kGSize + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partials), blocks, static_cast<float*>(grads));
  return int(cudaGetLastError());
}
