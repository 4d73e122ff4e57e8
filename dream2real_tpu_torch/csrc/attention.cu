// CLIP attention kernels: K2 (LN1 + qkv projection + attention), K3
// (attention on a projection-layout qkv), K4 (causal head-split attention of
// the text tower), K9 (bidirectional head-split attention) and the variants
// of the attention bench (X1-X4).
//
// Replaces, in dream2real_tpu/ops/attention.py:
//   K2 mha_ln_qkv         (Pallas body _attn_kernel4)
//   K3 mha_qkv            (Pallas body _attn_kernel3)
//   K4 mha(causal=True)   (Pallas body _attn_kernel)
//   K9 mha(causal=False)  (Pallas body _attn_kernel2): attn_kernel in mode
//      maxsub through head-split strides, q scaled by D^-0.5 as it is loaded
// and, in experiments/bench_attention.py:
//   X1 _call: _kernel_unrolled / _kernel_pipelined are K9's function (mode
//      maxsub), _kernel_nomax is mode nomax, and the floor probes
//      _kernel_exponly / _kernel_softmaxonly / _kernel_matmulonly are the
//      probe modes below
//   X2 _mha_v8_projlayout: K3's launch in modes maxsub (v8, v10) and clamp
//      (v9, v11)
//   X4 _block_fused: K2's kernels with the attention in mode clamp
//   X3 _block_fused_o: X4, then gemm_bf16 with the bias + residual epilogue
//      (the out-projection the TPU body holds)
//
// K2 on Hopper is two hand-written parts: gemm_bf16<LN> below (LN1 folded into
// the A-tile load of a tiled bf16 GEMM, row statistics from ln_stats), which
// writes the (B, T, 3W) bf16 qkv, then the K3 attention kernel on it. The
// TPU kernel kept Wqkv (6 MB) resident in VMEM; a Hopper block has 227 KB,
// so the GEMM tiles it instead.
//
// Bound on the H100: tensor-core operations. K2 at the scoring shape (32
// images x 577 tokens, W 1024, 16 heads of 64): 2*T*W*3W + 4*H*T^2*hd =
// 4.99 GFLOP per image, 0.16 ms per 32-image launch at 989 TFLOP/s dense
// bf16; K3 alone 43.6 GFLOP, 0.044 ms. K4 (12 heads x 77 tokens) is bound by
// launch latency.
//
// Design: the attention kernel runs one block per (query tile of 64, head,
// image); each of 4 warps owns 16 query rows. It reads q/k/v straight from
// the caller's layout through strides (the projection layout (B, T, 3W) for
// K2/K3, the head-split (B, H, T, D) layout for K4), stages 64-key tiles of
// K and V in shared memory and runs QK^T and PV with WMMA bf16 fragments and
// f32 accumulators. Softmax modes:
//   0 clamp   p = bf16(exp(min(s, 70) - 70)); l += p; o += p v; out = o / l.
//             No running max and no rescaling: the TPU's full-row math up to
//             summation order.
//   1 maxsub  a first pass over the keys takes the exact row max m, then
//             p = bf16(exp(s - m)); out = o / l.
//   2 exact   (K4) passes for the row max and the f32 row sum, then
//             p = bf16(exp(s - m) / l); out = o. Masked keys (padding,
//             causal) get weight 0, the same as the reference's -1e9 bias
//             or -0.7*f32max mask.
//   3 nomax   p = bf16(exp(s)); l += p; out = o / l. No max and no clamp, as
//             the bench's _kernel_nomax: a logit above 88 overflows.
// Floor probes of the bench (their outputs are fabricated; their use is
// their time). Each keeps the K and V tile loads, as the TPU probes keep
// their DMA, and leaves out what its TPU body leaves out:
//   4 exp only      no products, no reductions: every score of a row is
//                   f32(q[row, 0]) written to the score buffer, then the exp
//                   pass p = bf16(exp(s)); out = p[:, :64].
//   5 softmax only  no products: the same fabricated scores through the max
//                   pass, p = bf16(exp(s - m)), l += p; out = p[:, :64] / l.
//   6 matmul only   QK^T and PV with the softmax replaced by a cast:
//                   p = bf16(s); out = o.
// The probes visit key tile 0 last, so that the weight buffer then holds
// the first 64 columns of p.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

// ---------------------------------------------------------------- LN1 stats

// One warp per row: mean and 1/sqrt(var + eps) of x (M x K) in f32, two-pass
// like the reference (var = mean((x - mu)^2)).
__global__ void ln_stats(const bf16* __restrict__ x, int M, int K, float eps,
                         float* __restrict__ mu_out, float* __restrict__ rstd_out) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + size_t(row) * K;
  float sum = 0.0f;
  for (int k = lane; k < K; k += 32) sum += __bfloat162float(xr[k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float mu = sum / float(K);
  float sq = 0.0f;
  for (int k = lane; k < K; k += 32) {
    const float dv = __bfloat162float(xr[k]) - mu;
    sq += dv * dv;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = 1.0f / sqrtf(sq / float(K) + eps);
  }
}

// ------------------------------------- bf16 GEMM (LN1 prologue / residual)

constexpr int kGBM = 128, kGBN = 128, kGBK = 32;
constexpr int kGThreads = 256;  // 8 warps: 4 along M x 2 along N, 32 x 64 each
constexpr int kGALd = kGBK + 8;
constexpr int kGBLd = kGBN + 8;

// kLN (K2's qkv projection): out (M x N) = bf16( bf16(LN(x)) @ W + bias ),
// LN(x) = ((x - mu) * rstd) * g + beta rounded to bf16 as the A tile is
// loaded. Without kLN the A tile is x as it is.
// kResid (X3's out-projection): out = bf16( f32(resid) + (x @ W + bias) ),
// the product and the bias summed in f32 first, one rounding at the end.
// Needs K % 32 == 0, N % 128 == 0.
template <bool kLN, bool kResid>
__global__ void __launch_bounds__(kGThreads)
    gemm_bf16(const bf16* __restrict__ x, const float* __restrict__ mu,
              const float* __restrict__ rstd, const float* __restrict__ g,
              const float* __restrict__ beta, const bf16* __restrict__ W,
              const float* __restrict__ bias, const bf16* __restrict__ resid, int M, int K,
              int N, bf16* __restrict__ out) {
  __shared__ __align__(128) bf16 sA[kGBM * kGALd];
  __shared__ __align__(128) bf16 sB[kGBK * kGBLd];
  __shared__ __align__(128) float scratch[8 * 256];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * kGBM, n0 = blockIdx.x * kGBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kGBK) {
    // A tile: 128 rows x 32 cols, 8 bf16 per vector, normalised on the way in.
    for (int i = threadIdx.x; i < kGBM * (kGBK / 8); i += kGThreads) {
      const int r = i / (kGBK / 8), c = (i % (kGBK / 8)) * 8;
      const int m = m0 + r;
      __align__(16) bf16 v[8];
      if (m < M) {
        *reinterpret_cast<uint4*>(v) =
            *reinterpret_cast<const uint4*>(x + size_t(m) * K + k0 + c);
        if (kLN) {
          const float mu_m = mu[m], r_m = rstd[m];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float xv = __bfloat162float(v[e]);
            v[e] = __float2bfloat16_rn((xv - mu_m) * r_m * g[k0 + c + e] + beta[k0 + c + e]);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(0.0f);
      }
      *reinterpret_cast<uint4*>(sA + r * kGALd + c) = *reinterpret_cast<uint4*>(v);
    }
    // B tile: 32 rows x 128 cols of W (K x N row-major).
    for (int i = threadIdx.x; i < kGBK * (kGBN / 8); i += kGThreads) {
      const int r = i / (kGBN / 8), c = (i % (kGBN / 8)) * 8;
      *reinterpret_cast<uint4*>(sB + r * kGBLd + c) =
          *reinterpret_cast<const uint4*>(W + size_t(k0 + r) * N + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sA + (wm * 32 + i * 16) * kGALd + kk, kGALd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sB + kk * kGBLd + wn * 64 + j * 16, kGBLd);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* scr = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 32 + i * 16 + (e >> 4);
        const int n = n0 + wn * 64 + j * 16 + (e & 15);
        if (m < M) {
          const float y = scr[e] + bias[n];
          out[size_t(m) * N + n] = __float2bfloat16_rn(
              kResid ? __bfloat162float(resid[size_t(m) * N + n]) + y : y);
        }
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------- attention

constexpr int kHd = 64;     // head dim (CLIP ViT-L/14 and its text tower)
constexpr int kQT = 64;     // query rows per block
constexpr int kKT = 64;     // keys per tile
constexpr int kAWarps = 4;  // 16 query rows each
constexpr int kAThreads = kAWarps * 32;
constexpr int kLd = kHd + 8;  // bf16 tile row stride
constexpr int kSLd = kKT + 4;  // f32 score row stride

constexpr size_t kQBytes = size_t(kQT) * kLd * 2;
constexpr size_t kKBytes = size_t(kKT) * kLd * 2;
constexpr size_t kSBytes = size_t(kAWarps) * 16 * kSLd * 4;
constexpr size_t kPBytes = size_t(kAWarps) * 16 * kLd * 2;
constexpr size_t kAttnSmem = kQBytes + 2 * kKBytes + kSBytes + kPBytes;

struct Strides {
  long b, h, t;  // element strides of q/k/v (dim contiguous)
  long ob, oh, ot;  // element strides of out
};

// Rows [t0, t0 + 64) of one head into a (64 x kLd) tile, zero past T, each
// element multiplied by `scale` and rounded to bf16 (scale 1 copies).
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, long st,
                                          int t0, int T, float scale) {
  for (int i = threadIdx.x; i < 64 * (kHd / 8); i += kAThreads) {
    const int r = i / (kHd / 8), c = (i % (kHd / 8)) * 8;
    __align__(16) bf16 v[8];
    if (t0 + r < T) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src + (t0 + r) * st + c);
      if (scale != 1.0f) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(__bfloat162float(v[e]) * scale);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(0.0f);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = *reinterpret_cast<uint4*>(v);
  }
}

// S (16 x 64 keys) of this warp's query rows against the key tile in sK,
// stored to the warp's f32 score buffer.
__device__ __forceinline__ void scores(const bf16* sQ, const bf16* sK, float* sS, int warp) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kKT / 16];
#pragma unroll
  for (int n = 0; n < kKT / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kHd; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, sQ + (warp * 16) * kLd + kk, kLd);
#pragma unroll
    for (int n = 0; n < kKT / 16; ++n) {
      // K^T as a column-major B operand: element (d, key) at sK[key * kLd + d].
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, sK + (n * 16) * kLd + kk, kLd);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kKT / 16; ++n)
    wmma::store_matrix_sync(sS + n * 16, acc[n], kSLd, wmma::mem_row_major);
  __syncwarp();
}

// The bench's floor probes write these scores in place of QK^T: every key
// column of a query row gets f32(q[row, 0]). Lane L writes columns L and
// L + 32 of all 16 rows, and reads back a row segment another lane wrote.
__device__ __forceinline__ void fabricated_scores(const bf16* sQ, float* sS, int warp,
                                                  int lane) {
  for (int e = lane; e < 16 * kKT; e += 32) {
    const int rr = e / kKT, cc = e % kKT;
    sS[rr * kSLd + cc] = __bfloat162float(sQ[(warp * 16 + rr) * kLd]);
  }
  __syncwarp();
}

template <int MODE>
__global__ void __launch_bounds__(kAThreads)
    attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int T, Strides st,
                float scale, int causal) {
  constexpr bool kProducts = MODE != 4 && MODE != 5;  // QK^T and PV
  constexpr bool kRowMax = MODE == 1 || MODE == 2 || MODE == 5;
  constexpr bool kRowSum = MODE == 0 || MODE == 1 || MODE == 3 || MODE == 5;  // l += p
  constexpr bool kProbe = MODE >= 4;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = reinterpret_cast<bf16*>(smem_raw + kQBytes);
  bf16* sV = reinterpret_cast<bf16*>(smem_raw + kQBytes + kKBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sS = reinterpret_cast<float*>(smem_raw + kQBytes + 2 * kKBytes) + warp * 16 * kSLd;
  bf16* sP = reinterpret_cast<bf16*>(smem_raw + kQBytes + 2 * kKBytes + kSBytes) +
             warp * 16 * kLd;

  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const long in_off = b * st.b + h * st.h;
  load_tile(sQ, q + in_off, st.t, q0, T, scale);

  // Lane pair (2r, 2r + 1) owns query row r of the warp, 32 key columns each.
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const int qrow = q0 + warp * 16 + r;
  int n_kt = (T + kKT - 1) / kKT;
  if (causal) n_kt = min(n_kt, int(blockIdx.x) + 1);  // later keys are all masked

  float m = -INFINITY, l = 0.0f;
  if (kRowMax) {  // exact row max
    for (int kt = 0; kt < n_kt; ++kt) {
      __syncthreads();
      load_tile(sK, k + in_off, st.t, kt * kKT, T, 1.0f);
      __syncthreads();
      if (kProducts) scores(sQ, sK, sS, warp);
      else fabricated_scores(sQ, sS, warp, lane);
      for (int c = c0; c < c0 + 32; ++c) {
        const int key = kt * kKT + c;
        if (key < T && (!causal || key <= qrow)) m = fmaxf(m, sS[r * kSLd + c]);
      }
      __syncwarp();
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  }
  if (MODE == 2) {  // f32 row sum of exp(s - m)
    for (int kt = 0; kt < n_kt; ++kt) {
      __syncthreads();
      load_tile(sK, k + in_off, st.t, kt * kKT, T, 1.0f);
      __syncthreads();
      scores(sQ, sK, sS, warp);
      for (int c = c0; c < c0 + 32; ++c) {
        const int key = kt * kKT + c;
        if (key < T && (!causal || key <= qrow)) l += expf(sS[r * kSLd + c] - m);
      }
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[kHd / 16];
#pragma unroll
  for (int n = 0; n < kHd / 16; ++n) wmma::fill_fragment(oacc[n], 0.0f);
  for (int it = 0; it < n_kt; ++it) {
    const int kt = kProbe ? (it + 1) % n_kt : it;  // the probes end on key tile 0
    __syncthreads();
    load_tile(sK, k + in_off, st.t, kt * kKT, T, 1.0f);
    load_tile(sV, v + in_off, st.t, kt * kKT, T, 1.0f);
    __syncthreads();
    if (kProducts) scores(sQ, sK, sS, warp);
    else fabricated_scores(sQ, sS, warp, lane);
    for (int c = c0; c < c0 + 32; ++c) {
      const int key = kt * kKT + c;
      const float s = sS[r * kSLd + c];
      float p = 0.0f;
      if (key < T && (!causal || key <= qrow)) {
        if (MODE == 0) {
          p = expf(fminf(s, 70.0f) - 70.0f);
        } else if (MODE == 1 || MODE == 5) {
          p = expf(s - m);
        } else if (MODE == 2) {
          p = expf(s - m) / l;
        } else if (MODE == 3 || MODE == 4) {
          p = expf(s);
        } else {
          p = s;
        }
        p = __bfloat162float(__float2bfloat16_rn(p));
      }
      if (kRowSum) l += p;
      sP[r * kLd + c] = __float2bfloat16_rn(p);
    }
    __syncwarp();
    if (kProducts) {
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sP + kk, kLd);
#pragma unroll
        for (int n = 0; n < kHd / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(bv, sV + kk * kLd + n * 16, kLd);
          wmma::mma_sync(oacc[n], a, bv, oacc[n]);
        }
      }
    }
  }
  if (kRowSum) l += __shfl_xor_sync(0xffffffffu, l, 1);

  if (kProducts) {
#pragma unroll
    for (int n = 0; n < kHd / 16; ++n)
      wmma::store_matrix_sync(sS + n * 16, oacc[n], kSLd, wmma::mem_row_major);
    __syncwarp();
  }
  if (qrow < T) {
    bf16* orow = out + b * st.ob + h * st.oh + long(qrow) * st.ot;
    for (int c = c0; c < c0 + 32; ++c) {
      // The probes without products give the first 64 columns of p.
      const float ov = kProducts ? sS[r * kSLd + c] : __bfloat162float(sP[r * kLd + c]);
      orow[c] = __float2bfloat16_rn(kRowSum ? ov / l : ov);
    }
  }
}

template <int MODE>
int launch_attn(const void* q, const void* k, const void* v, void* out, int B, int H, int T,
                const Strides& st, float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kAttnSmem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((T + kQT - 1) / kQT, H, B);
  attn_kernel<MODE><<<grid, kAThreads, kAttnSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), T, st, scale, causal);
  return int(cudaGetLastError());
}

}  // namespace

// Attention over heads of 64 addressed by element strides. mode 0 clamp,
// 1 maxsub, 2 exact softmax, 3 nomax, 4 / 5 / 6 the exp-only, softmax-only
// and matmul-only probes (see the note at the top).
extern "C" int d2r_attention(const void* q, const void* k, const void* v, void* out, int B,
                             int H, int T, long sb, long sh, long st, long osb, long osh,
                             long ost, float scale, int causal, int mode, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return 0;
  const Strides s{sb, sh, st, osb, osh, ost};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_attn<0>(q, k, v, out, B, H, T, s, scale, causal, cs);
    case 1: return launch_attn<1>(q, k, v, out, B, H, T, s, scale, causal, cs);
    case 2: return launch_attn<2>(q, k, v, out, B, H, T, s, scale, causal, cs);
    case 3: return launch_attn<3>(q, k, v, out, B, H, T, s, scale, causal, cs);
    case 4: return launch_attn<4>(q, k, v, out, B, H, T, s, scale, causal, cs);
    case 5: return launch_attn<5>(q, k, v, out, B, H, T, s, scale, causal, cs);
    case 6: return launch_attn<6>(q, k, v, out, B, H, T, s, scale, causal, cs);
    default: return int(cudaErrorInvalidValue);
  }
}

// qkv (M x N) = bf16(bf16(LN(x)) @ W + bias) for x (M x K); mu/rstd are
// (M,) f32 scratch the caller allocates.
extern "C" int d2r_ln_qkv(const void* x, const void* g, const void* beta, const void* w,
                          const void* bias, int M, int K, int N, float eps, void* mu,
                          void* rstd, void* qkv, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  ln_stats<<<(M + 7) / 8, 256, 0, cs>>>(static_cast<const bf16*>(x), M, K, eps,
                                        static_cast<float*>(mu), static_cast<float*>(rstd));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  dim3 grid(N / kGBN, (M + kGBM - 1) / kGBM);
  gemm_bf16<true, false><<<grid, kGThreads, 0, cs>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(mu),
      static_cast<const float*>(rstd), static_cast<const float*>(g),
      static_cast<const float*>(beta), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), nullptr, M, K, N, static_cast<bf16*>(qkv));
  return int(cudaGetLastError());
}

// out (M x N) = bf16(f32(resid) + (a @ W + bias)) for a (M x K) bf16, W
// (K x N) bf16, bias (N,) f32, resid (M x N) bf16: the out-projection, bias
// and residual of the bench's v13 body. K % 32 == 0 and N % 128 == 0.
extern "C" int d2r_gemm_bias_residual(const void* a, const void* w, const void* bias,
                                      const void* resid, int M, int K, int N, void* out,
                                      void* stream) {
  if (M <= 0) return 0;
  if (K % kGBK || N % kGBN) return int(cudaErrorInvalidValue);
  dim3 grid(N / kGBN, (M + kGBM - 1) / kGBM);
  gemm_bf16<false, true><<<grid, kGThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), nullptr, nullptr, nullptr, nullptr,
      static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const bf16*>(resid), M, K, N, static_cast<bf16*>(out));
  return int(cudaGetLastError());
}
