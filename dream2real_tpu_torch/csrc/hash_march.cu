// Fused crop march of a hash-grid field (H2): every crop ray of a clip group
// marched through the object's box, each sample through the hash encoding,
// the density MLP, the colour MLP and the front-to-back composite, in one
// launch; nothing per sample goes to memory.
//
// Replaces no Pallas kernel: the JAX package scores with the MLP field only
// (hash tables suit the TPU badly). It was added so that Dream2Real's own
// scoring configuration, instant-ngp fields rendered for every candidate
// pose and scored by CLIP, runs on the card without the plain render's
// per-sample tensors (H1's features, cuBLAS for the two small MLPs and the
// elementwise glue over every crop ray, dead ones included).
//
// Computes what nerf/render.py::render_rays(field, origins, dirs, settings,
// march_aabb=box) computes for the hash-grid field at the crop settings
// (n_fine 0), over the live rays that nerf/hash_march.py compacts on the
// device, each operation rounded as the plain path rounds it:
// - samples at t0 + (t1 - t0) ((s + 0.5) (1 / S)), positions o + d t, both
//   products and sums rounded separately (torch multiplies by the scalar's
//   reciprocal);
// - the encoding as H1 computes it (hash.cuh: float32 sums over the float32
//   table in H1's corner order), one rounding to bf16, in either layout of
//   the 32 features the density MLP takes: 16 levels of 2 (the instant-ngp
//   paper's NeRF, section 5.4) or 8 of 4 (a template parameter, F);
// - the bias-free density MLP 32 -> 64 -> 16 and colour MLP [geo 15 | SH 16]
//   -> 64 -> 64 -> 3: bf16 inputs, float32 sums (tensor-core products, as
//   the plain path's cuBLAS GEMMs), each layer's output rounded to bf16,
//   ReLU between layers;
// - sigma = exp(clamp(h0, -15, 15)), zero outside the field's box and the
//   march box; alpha = 1 - exp(-sigma delta |d|), the last delta 1e2; the
//   weight alpha T, zero where T is under the transmittance cut; T *= (1 -
//   alpha) + 1e-10; rgb = 1 / (1 + exp(-logit)).
// |d| comes in (torch.linalg.norm's, as render_rays takes it). The sums
// over samples run in order here and the products' sums in the tensor
// cores' order; torch may add them in others, so rgb, alpha and depth agree
// to float32 rounding.
//
// Exact early exit: T never grows (every factor is at most 1 in float32),
// so once a ray's T is under the cut every later weight is zero and the
// ray stops. A sample outside both boxes has sigma 0, alpha 0, weight 0 and
// a factor of exactly 1, and a sample of weight 0 adds nothing: where no ray
// of a warp needs them, the warp skips the encoding and both MLPs for the
// first and the colour MLP for the second. A row of a product depends on
// its own ray alone, so without the exit (early 0), every sample of a live
// ray computed, the results are the same bit for bit.
//
// Bound on the H100: latency of the table's gathers (16 levels x 8 corners
// of 8 bytes a sample, or 8 x 8 of 16, scattered over the 64 MiB table, the
// fine levels L2 misses), not bytes or operations: a live ray reads 44
// bytes (its origin, direction, |d|, range and index) and writes 20, and
// the MLPs' 9,344 multiply-adds a sample are tensor-core products.
//
// Design: a warp takes 32 rays, one a lane, and its lanes step through their
// samples together. Each lane encodes its own ray's sample (one thread a
// ray for the gathers); the MLPs then run as mma.sync m16n8k16 bf16
// products with float32 sums over the warp's 32 rays (two 16-row tiles),
// each layer's inputs in shared memory as a column a ray (read as A
// fragments by ldmatrix .trans, written back rounded from the products'
// fragments), the weights as B fragments packed once a block in shared
// memory. A lane whose ray has exited, or whose sample is outside the boxes,
// idles through the warp's products. 256 threads a block, a persistent grid
// of as many blocks as fit on the SMs, the warps taking 32 live rays at a
// time, count read on the device (the launch copies nothing from the host
// and can be captured). The launch raises the shared-memory limit and
// reads the grid's size once a device (each card keeps its own; the
// imagine loop launches under every card of its mesh).
//
// Measured on an H100 (700 W) on the first clip group of the cell
// ngp-clip-vitl14-336.shopping_grid (32 x 208^2 crop rays, 316 K of them
// live, nearly all of their 20 samples needed): this design 3.13 ms (128
// registers, no spill); with 3 blocks an SM (80 registers) 3.14. One thread
// a ray with FMAs from shared memory, the weights as float32 broadcasts,
// took 5.90 ms (128 registers, 64 to 82 bytes spilled): the MLPs alone 4.22
// ms, the encoding alone 1.61; its variants (blocks of 128, 3 blocks an SM,
// other unrolls, no sample skips) 5.96 to 7.38.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"
#include "hopper.cuh"

namespace {

using hashenc::Levels;

constexpr int kThreads = 256;
constexpr int kIn = 32;  // the encoding's features: 16 levels x 2, or 8 x 4
constexpr int kHid = 64, kDens = 16, kGeo = 15, kSh = 16, kCin = kGeo + kSh;
// The packed weights (float32 of bf16 values), (in, out) row-major.
constexpr int kW0 = 0;                   // sigma_w0 (32, 64)
constexpr int kW1 = kW0 + kIn * kHid;    // sigma_w1 (64, 16)
constexpr int kC0 = kW1 + kHid * kDens;  // color_w0 (31, 64)
constexpr int kC1 = kC0 + kCin * kHid;   // color_w1 (64, 64)
constexpr int kC2 = kC1 + kHid * kHid;   // color_w2 (64, 4): 3 used, a zero column
constexpr int kNW = kC2 + kHid * 4;      // 9,408 floats
constexpr int kWarps = kThreads / 32;
// The MLPs as mma.sync m16n8k16 products over a warp's 32 rays: each
// layer's weights as B fragments (two bf16 pairs a lane a 16 x 8 tile),
// (k-step, n-tile) major, K padded to 16, N to 8, in shared memory.
constexpr int kFragW0 = 0, kFragW1 = kFragW0 + 2 * 8, kFragC0 = kFragW1 + 4 * 2,
              kFragC1 = kFragC0 + 2 * 8, kFragC2 = kFragC1 + 4 * 8, kFrags = kFragC2 + 4 * 1;
constexpr int kFragBytes = kFrags * 32 * 8;
// The activations: row k of a thread's column is its ray's input k of the
// layer under way (rows 0-63), the SH of its ray (rows 64-79), zeros (80).
constexpr int kShRow = 64, kZeroRow = 80, kActRows = 81;
constexpr int kSmem = kFragBytes + kActRows * kThreads * 2;

// Degree-4 real SH of the unit direction, each term in nerf/model.py's
// order of operations, rounded to bf16 and packed in pairs.
__device__ __forceinline__ void sh_packed(float x, float y, float z, uint32_t out[kSh / 2]) {
  const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y), zz = __fmul_rn(z, z);
  const float xy = __fmul_rn(x, y), yz = __fmul_rn(y, z), xz = __fmul_rn(x, z);
  const float omz = __fsub_rn(1.0f, __fmul_rn(5.0f, zz));
  float s[kSh];
  s[0] = 0.28209479177387814f;
  s[1] = __fmul_rn(-0.48860251190291987f, y);
  s[2] = __fmul_rn(0.48860251190291987f, z);
  s[3] = __fmul_rn(-0.48860251190291987f, x);
  s[4] = __fmul_rn(1.0925484305920792f, xy);
  s[5] = __fmul_rn(-1.0925484305920792f, yz);
  s[6] = __fsub_rn(__fmul_rn(0.94617469575755997f, zz), 0.31539156525251999f);
  s[7] = __fmul_rn(-1.0925484305920792f, xz);
  s[8] = __fmul_rn(0.54627421529603959f, __fsub_rn(xx, yy));
  s[9] = __fmul_rn(__fmul_rn(0.59004358992664352f, y), __fadd_rn(__fmul_rn(-3.0f, xx), yy));
  s[10] = __fmul_rn(__fmul_rn(2.8906114426405538f, xy), z);
  s[11] = __fmul_rn(__fmul_rn(0.45704579946446572f, y), omz);
  s[12] = __fmul_rn(__fmul_rn(0.3731763325901154f, z),
                    __fsub_rn(__fmul_rn(5.0f, zz), 3.0f));
  s[13] = __fmul_rn(__fmul_rn(0.45704579946446572f, x), omz);
  s[14] = __fmul_rn(__fmul_rn(1.4453057213202769f, z), __fsub_rn(xx, yy));
  s[15] = __fmul_rn(__fmul_rn(0.59004358992664352f, x), __fadd_rn(-xx, __fmul_rn(3.0f, yy)));
#pragma unroll
  for (int i = 0; i < kSh / 2; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
    out[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
}

__device__ __forceinline__ bool inside(const float p[3], const float lo[3], const float hi[3]) {
  return p[0] >= lo[0] && p[0] <= hi[0] && p[1] >= lo[1] && p[1] <= hi[1] && p[2] >= lo[2] &&
         p[2] <= hi[2];
}


// Row k of a layer's input in the activation buffer: the layer's own rows,
// or for the colour MLP [geo 15 (rows 1-15, left by the density) | SH 16 |
// a zero].
struct Rows {
  __device__ __forceinline__ int operator()(int k) const { return k; }
};
struct ColourRows {
  __device__ __forceinline__ int operator()(int k) const {
    return k < kGeo ? 1 + k : (k < kCin ? kShRow + (k - kGeo) : kZeroRow);
  }
};

// A fragments of the warp's 32 rays (two m-tiles) over KS k-steps, from
// the rows' transposed storage (ldmatrix .trans: row k holds the rays).
template <int KS, class Map>
__device__ __forceinline__ void load_a(uint32_t a[2][4][4], uint32_t act_s, int col0, int lane,
                                       Map rows) {
  const int i = lane & 7, mat = lane >> 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int k = ks * 16 + i + ((mat >> 1) << 3);
      const int m = mt * 16 + ((mat & 1) << 3);
      const uint32_t addr = act_s + uint32_t((rows(k) * kThreads + col0 + m) * 2);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(a[mt][ks][0]), "=r"(a[mt][ks][1]), "=r"(a[mt][ks][2]), "=r"(a[mt][ks][3])
          : "r"(addr));
    }
  }
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// One layer over the warp's rays: out[m][n] = sum_k in[m][k] W[k][n] in
// float32, rounded to bf16 (through a ReLU if kRelu) into rows n < kStore.
template <int KS, int NT, bool kRelu, int kStore>
__device__ __forceinline__ void mma_layer(const uint2* __restrict__ frags, const uint32_t a[2][4][4],
                                          __nv_bfloat16* act0, int col0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float d[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint2 b = frags[(ks * NT + nt) * 32 + lane];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(d[mt], a[mt][ks], b);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = nt * 8 + 2 * t + (e & 1), m = mt * 16 + g + ((e >> 1) << 3);
        if (n < kStore)
          act0[n * kThreads + col0 + m] = __float2bfloat16_rn(kRelu ? fmaxf(d[mt][e], 0.0f) : d[mt][e]);
      }
    }
  }
}

// The B fragments of every layer from the packed float32 weights: a tile's
// lane (g, t) holds W[k][n] for n = 8 nt + g and k = 16 ks + 2t, +1, +8, +9
// (zero past the layer's K and N).
__device__ void pack_frags(const float* __restrict__ w, uint2* frags) {
  for (int idx = threadIdx.x; idx < kFrags * 32; idx += kThreads) {
    const int f = idx >> 5, lane = idx & 31, g = lane >> 2, t = lane & 3;
    int base, off, K, stride, N, NT;
    if (f < kFragW1) { base = kFragW0; off = kW0; K = kIn; stride = kHid; N = kHid; NT = 8; }
    else if (f < kFragC0) { base = kFragW1; off = kW1; K = kHid; stride = kDens; N = kDens; NT = 2; }
    else if (f < kFragC1) { base = kFragC0; off = kC0; K = kCin; stride = kHid; N = kHid; NT = 8; }
    else if (f < kFragC2) { base = kFragC1; off = kC1; K = kHid; stride = kHid; N = kHid; NT = 8; }
    else { base = kFragC2; off = kC2; K = kHid; stride = 4; N = 3; NT = 1; }
    const int ks = (f - base) / NT, nt = (f - base) % NT, n = nt * 8 + g;
    uint32_t r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = ks * 16 + 2 * t + 8 * h;
      const float lo = (k < K && n < N) ? w[off + k * stride + n] : 0.0f;
      const float hi = (k + 1 < K && n < N) ? w[off + (k + 1) * stride + n] : 0.0f;
      const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
      r[h] = *reinterpret_cast<const uint32_t*>(&v);
    }
    frags[idx] = make_uint2(r[0], r[1]);
  }
}

template <int F, bool kEarly>
__global__ void __launch_bounds__(kThreads, 2)
    hash_march(const float* __restrict__ origins, const float* __restrict__ dirs,
               const float* __restrict__ dnorm, const float* __restrict__ t0s,
               const float* __restrict__ t1s, const int* __restrict__ live,
               const int* __restrict__ count, int R, const float* __restrict__ box_in,
               const float* __restrict__ table, uint32_t T, Levels lv,
               const float* __restrict__ weights, int S, float min_t,
               float* __restrict__ rgb_out, float* __restrict__ alpha_out,
               float* __restrict__ depth_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* frags = reinterpret_cast<uint2*>(smem);
  __nv_bfloat16* act0 = reinterpret_cast<__nv_bfloat16*>(smem + kFragBytes);
  pack_frags(weights, frags);
  for (int i = threadIdx.x; i < kActRows * kThreads / 2; i += kThreads)
    reinterpret_cast<uint32_t*>(act0)[i] = 0u;  // the zero row, and finite rows for idle lanes
  __syncthreads();

  const int lane = threadIdx.x & 31, col0 = threadIdx.x & ~31;
  __nv_bfloat16* own = act0 + threadIdx.x;  // this thread's ray's column
  const uint32_t act_s = uint32_t(__cvta_generic_to_shared(act0));
  const int n = *count;
  // [field lo | field hi | march lo | march hi], and the field box's extent
  // as (hi - lo) rounds.
  float f_lo[3], f_hi[3], m_lo[3], m_hi[3], span_f[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    f_lo[d] = box_in[d];
    f_hi[d] = box_in[3 + d];
    m_lo[d] = box_in[6 + d];
    m_hi[d] = box_in[9 + d];
    span_f[d] = __fsub_rn(f_hi[d], f_lo[d]);
  }
  const float inv_s = __fdiv_rn(1.0f, float(S));
  const uint32_t mask = T - 1u;
  constexpr unsigned kAll = 0xffffffffu;

  // A warp takes 32 rays at a time, one a lane; the lanes step through the
  // samples together, so that the MLPs run on the warp's rays at once.
  for (int base = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32; base < n;
       base += gridDim.x * kWarps * 32) {
    const bool valid = base + lane < n;
    int i = 0;
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f}, dn = 1.0f, a0 = 0.0f, a1 = 0.0f;
    if (valid) {
      i = live[base + lane];
      const int p = i / R;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        o[k] = origins[3 * p + k];
        d[k] = dirs[3 * size_t(i) + k];
      }
      dn = dnorm[i];
      a0 = t0s[i];
      a1 = t1s[i];
    }
    {
      uint32_t sh[kSh / 2];
      sh_packed(__fdiv_rn(d[0], dn), __fdiv_rn(d[1], dn), __fdiv_rn(d[2], dn), sh);
#pragma unroll
      for (int j = 0; j < kSh / 2; ++j) {
        own[(kShRow + 2 * j) * kThreads] = __ushort_as_bfloat16(uint16_t(sh[j] & 0xffffu));
        own[(kShRow + 2 * j + 1) * kThreads] = __ushort_as_bfloat16(uint16_t(sh[j] >> 16));
      }
    }
    const float span = __fsub_rn(a1, a0);

    float trans = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f, acc_d = 0.0f;
    float t = __fadd_rn(a0, __fmul_rn(span, __fmul_rn(0.5f, inv_s)));
    bool alive = valid;
    for (int s = 0; s < S; ++s) {
      if (kEarly) {
        alive = alive && !(trans < min_t);
        if (!__any_sync(kAll, alive)) break;
      }
      const float t_next =
          __fadd_rn(a0, __fmul_rn(span, __fmul_rn(float(s + 1) + 0.5f, inv_s)));
      const float delta = s + 1 < S ? __fsub_rn(t_next, t) : 1e2f;
      float pos[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) pos[k] = __fadd_rn(o[k], __fmul_rn(d[k], t));
      const bool in = inside(pos, f_lo, f_hi) && inside(pos, m_lo, m_hi);

      uint32_t a[2][4][4];
      float sigma = 0.0f;
      const bool enc = alive && (in || !kEarly);
      if (__any_sync(kAll, enc)) {
        if (enc) {
          float q[3];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            q[k] = hashenc::hash_clamp01(__fdiv_rn(__fsub_rn(pos[k], f_lo[k]), span_f[k]));
#pragma unroll 4
          for (int l = 0; l < kIn / F; ++l) {
            float f[F];
            hashenc::hash_level<F>(q, table + size_t(l) * T * F, lv.res[l], lv.dense[l] != 0,
                                   mask, f);
#pragma unroll
            for (int j = 0; j < F; ++j) own[(F * l + j) * kThreads] = __float2bfloat16_rn(f[j]);
          }
        }
        __syncwarp();
        load_a<kIn / 16>(a, act_s, col0, lane, Rows());
        __syncwarp();
        mma_layer<kIn / 16, kHid / 8, true, kHid>(frags + kFragW0 * 32, a, act0, col0, lane);
        __syncwarp();
        load_a<kHid / 16>(a, act_s, col0, lane, Rows());
        __syncwarp();
        // Row 0 the log-density, rows 1-15 the geometry features.
        mma_layer<kHid / 16, kDens / 8, false, kDens>(frags + kFragW1 * 32, a, act0, col0, lane);
        __syncwarp();
        if (enc) {
          const float x = fminf(fmaxf(__bfloat162float(own[0]), -15.0f), 15.0f);
          sigma = in ? expf(x) : 0.0f;
        }
      }
      const float alpha = __fsub_rn(1.0f, expf(__fmul_rn(__fmul_rn(-sigma, delta), dn)));
      const float wgt = trans < min_t ? 0.0f : __fmul_rn(alpha, trans);
      const bool col = alive && (wgt != 0.0f || !kEarly);
      if (__any_sync(kAll, col)) {
        load_a<2>(a, act_s, col0, lane, ColourRows());
        __syncwarp();
        mma_layer<2, kHid / 8, true, kHid>(frags + kFragC0 * 32, a, act0, col0, lane);
        __syncwarp();
        load_a<kHid / 16>(a, act_s, col0, lane, Rows());
        __syncwarp();
        mma_layer<kHid / 16, kHid / 8, true, kHid>(frags + kFragC1 * 32, a, act0, col0, lane);
        __syncwarp();
        load_a<kHid / 16>(a, act_s, col0, lane, Rows());
        __syncwarp();
        mma_layer<kHid / 16, 1, false, 3>(frags + kFragC2 * 32, a, act0, col0, lane);
        __syncwarp();
        if (col) {
          const float cr = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__bfloat162float(own[0]))));
          const float cg =
              __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__bfloat162float(own[kThreads]))));
          const float cb =
              __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__bfloat162float(own[2 * kThreads]))));
          acc_r = __fadd_rn(acc_r, __fmul_rn(wgt, cr));
          acc_g = __fadd_rn(acc_g, __fmul_rn(wgt, cg));
          acc_b = __fadd_rn(acc_b, __fmul_rn(wgt, cb));
        }
      }
      if (alive) {
        acc_a = __fadd_rn(acc_a, wgt);
        acc_d = __fadd_rn(acc_d, __fmul_rn(wgt, t));
        trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.0f, alpha), 1e-10f));
      }
      t = t_next;
    }
    if (valid) {
      rgb_out[3 * size_t(i)] = acc_r;
      rgb_out[3 * size_t(i) + 1] = acc_g;
      rgb_out[3 * size_t(i) + 2] = acc_b;
      alpha_out[i] = acc_a;
      depth_out[i] = acc_d;
    }
  }
}

constexpr int kMaxDevices = 64;

template <int F, bool kEarly>
int launch(const void* origins, const void* dirs, const void* dnorm, const void* t0,
           const void* t1, const void* live, const void* count, int R, int n_max, const void* box,
           const void* table, uint32_t T, const Levels& lv, const void* weights, int S,
           float min_t, void* rgb, void* alpha, void* depth, cudaStream_t stream) {
  // Both set once a device; two host threads that both find them unset
  // set the same values.
  static std::atomic<unsigned long long> configured{0};
  static std::atomic<int> grid_cap[kMaxDevices];  // blocks resident on the card at once
  cudaError_t e = allow_smem(hash_march<F, kEarly>, kSmem, &configured);
  if (e != cudaSuccess) return int(e);
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return int(e);
  int cap = dev < kMaxDevices ? grid_cap[dev].load(std::memory_order_relaxed) : 0;
  if (cap == 0) {
    int n_sm = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return int(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hash_march<F, kEarly>, kThreads,
                                                      kSmem);
    if (e != cudaSuccess) return int(e);
    if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
    cap = n_sm * per_sm;
    if (dev < kMaxDevices) grid_cap[dev].store(cap, std::memory_order_relaxed);
  }
  const int grid = max(1, min(cap, (n_max + kThreads - 1) / kThreads));
  hash_march<F, kEarly><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(origins), static_cast<const float*>(dirs),
      static_cast<const float*>(dnorm), static_cast<const float*>(t0),
      static_cast<const float*>(t1), static_cast<const int*>(live),
      static_cast<const int*>(count), R, static_cast<const float*>(box),
      static_cast<const float*>(table), T, lv,
      static_cast<const float*>(weights), S, min_t, static_cast<float*>(rgb),
      static_cast<float*>(alpha), static_cast<float*>(depth));
  return int(cudaGetLastError());
}

}  // namespace

// The packed weights' length in floats, for the wrapper's check.
extern "C" int d2r_hash_march_weights() { return kNW; }

// One clip group's crop march. origins (P, 3), dirs (P R, 3), dnorm, t0, t1
// (P R) f32; live (P R) and count (1) int32 from the device compaction (the
// first count entries of live are the live rays' flat indices); box (12) =
// [field lo | field hi | march lo | march hi] f32 on the device; table (L,
// 2^log2_t, F) f32, L F = 32 with F 2 or 4, res / dense its levels (host
// arrays of L); weights
// (d2r_hash_march_weights()) f32; rgb (P R, 3), alpha, depth (P R) f32,
// which the caller zeroes (rays not live stay zero).
extern "C" int d2r_hash_march(const void* origins, const void* dirs, const void* dnorm,
                              const void* t0, const void* t1, const void* live, const void* count,
                              int R, int n_max, const void* box, const void* table, int L, int F,
                              int log2_t, const int* res, const int* dense, const void* weights,
                              int S, float min_t, int early, void* rgb, void* alpha, void* depth,
                              void* stream) {
  if ((F != 2 && F != 4) || L * F != kIn || log2_t < 0 || log2_t > 30 || S < 1 || R < 1 ||
      n_max < 0)
    return int(cudaErrorInvalidValue);
  Levels lv = {};
  for (int l = 0; l < L; ++l) {
    if (res[l] < 1) return int(cudaErrorInvalidValue);
    lv.res[l] = res[l];
    lv.dense[l] = dense[l];
  }
  if (n_max == 0) return int(cudaSuccess);
  const uint32_t T = 1u << log2_t;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* go = F == 2 ? (early ? launch<2, true> : launch<2, false>)
                    : (early ? launch<4, true> : launch<4, false>);
  return go(origins, dirs, dnorm, t0, t1, live, count, R, n_max, box, table, T, lv, weights, S,
            min_t, rgb, alpha, depth, s);
}
