// CLIP attention kernels: K2 (LN1 + qkv projection + attention), K3
// (attention on a projection-layout qkv), K4 (causal head-split attention of
// the text tower), K9 (bidirectional head-split attention) and the variants
// of the attention bench (X1-X4).
//
// Replaces, in dream2real_tpu/ops/attention.py:
//   K2 mha_ln_qkv         (Pallas body _attn_kernel4)
//   K3 mha_qkv            (Pallas body _attn_kernel3)
//   K4 mha(causal=True)   (Pallas body _attn_kernel)
//   K9 mha(causal=False)  (Pallas body _attn_kernel2): attn_fwd in mode
//      maxsub through head-split strides, q scaled by D^-0.5 as it is loaded
// and, in experiments/bench_attention.py:
//   X1 _call: _kernel_unrolled / _kernel_pipelined are K9's function (mode
//      maxsub), _kernel_nomax is mode nomax, and the floor probes
//      _kernel_exponly / _kernel_softmaxonly / _kernel_matmulonly are the
//      probe modes below
//   X2 _mha_v8_projlayout: K3's launch in modes maxsub (v8, v10) and clamp
//      (v9, v11)
//   X4 _block_fused: K2's kernels with the attention in mode clamp
//   X3 _block_fused_o: X4, then gemm_tma with the bias + residual epilogue
//      (the out-projection the TPU body holds)
//
// Three pieces of device code, the first two designed for Hopper:
//
// attn_fwd<MODE> (K2's second half, K3, K9, X1, X2). Bound at the scoring
// shape (32 images x 16 heads x 577 tokens x 64): 151 MB at 3.35 TB/s is
// 0.045 ms, and the 43.6 GFLOP take 0.044 ms at 989 TFLOP/s, so neither the
// loads nor the softmax may stall the tensor cores. A block is two
// warpgroups of 64 query rows each (128 rows share every K / V tile). Q, K
// and V come through TMA: tensor maps over the caller's strides (built by the
// launch function), boxes of 128 rows of one head that land 128-byte swizzled
// as wgmma reads them, rows past T zero-filled. K and V tiles of 128 keys
// fill a ring of 3 stages guarded by full / empty mbarriers; one thread of
// the block asks for a tile as soon as every warp has left the stage, so the
// next tiles are in flight while this one is multiplied, no thread spends
// instructions on the copies, and the two warpgroups meet at no barrier. S = Q K^T is one wgmma m64n128k16 chain per warpgroup with Q
// and K from shared memory (a K row of 64 bf16 is one swizzle atom, K-major)
// and the scores in registers. The softmax runs on those registers: a row
// lives in the four lanes of a quad, the weights are rounded to bf16 and
// packed in place (the accumulator layout of 16 columns is the A-fragment
// layout), the row sum is taken over the rounded weights, and O += P V reads
// P from registers and V from shared memory as the MN-major B operand. No
// score or weight touches shared memory. q is not scaled on the way in: the
// scale 64^-0.5 is a power of two, so scaling the f32 scores is the same
// arithmetic as the reference's bf16(q * scale). exp is ex2.approx on s * log2(e),
// with the clamp softmax's subnormal weights kept (see ex2_biased). A last
// key tile of at most 80 keys (T = 577 leaves 65) runs 80 columns wide. The
// kernel takes 128 registers, so two blocks share an SM and one's loads and
// waits hide under the other's work (the shared memory is sized to the byte
// for that). The output goes through the block's Q tile to 16-byte stores.
// q, k, v are addressed by element strides: the projection layout (B, T, 3W)
// and the head-split layout (B, H, T, D).
//   0 clamp   p = bf16(exp(min(s, 70) - 70)); l += p; o += p v; out = o / l.
//             No running max and no rescaling.
//   1 maxsub  a first pass over the key tiles (K only) takes the exact row
//             max m, then p = bf16(exp(s - m)); out = o / l: every rounding
//             where the plain version has it.
//   3 nomax   p = bf16(exp(s)); l += p; out = o / l. No max and no clamp, as
//             the bench's _kernel_nomax: a logit above 88 overflows.
// Keys at or past T get weight exactly 0 in every mode; query rows at or
// past T are not stored.
// Floor probes of the bench (their outputs are fabricated; their use is
// their time). Each keeps the K and V tile loads and leaves out what its TPU
// body leaves out:
//   4 exp only      no products, no reductions: every score of a row is
//                   f32(q[row, 0]), then p = bf16(exp(s)); out = p[:, :64].
//   5 softmax only  no products: the same scores through the max pass,
//                   p = bf16(exp(s - m)), l += p; out = p[:, :64] / l.
//   6 matmul only   QK^T and PV with the softmax replaced by a cast:
//                   p = bf16(s); out = o.
// The fabricated scores are built in registers as bits(q[row, 0]) |
// ((w + i) & mask), where w is a word this thread reads from the K tile just
// loaded and mask is a kernel argument that is 0 at run time: the compiler
// cannot prove the scores equal across columns or tiles, so the exp pass
// stays in the tile loop, once per score. The probes visit key tile 0 last,
// so that the weight registers end as the first columns of p.
//
// gemm_tma<EPI, BN> (K2's qkv projection, X3's out-projection, and every
// biased layer of both CLIP towers: qkv on the split path, the
// out-projection, fc1 and fc2): out = epilogue(a @ W + bias [, resid]) for a
// (M x K), W (K x N) row-major. Bound by the tensor cores: the qkv product at
// the scoring shape is 116 GFLOP, 0.117 ms. A persistent grid, one block an
// SM, walks the 128 x BN output tiles (N's innermost, so the blocks at work
// at once share W and a few rows of a in L2). Warp 8 issues every TMA load
// (64-deep A and W tiles, 128-byte swizzled, rows past M zero-filled) into a
// ring guarded by full / empty mbarriers, so the refills never wait for the
// slowest consumer warp. Two consumer warpgroups (setmaxnreg 216; the
// producer's warpgroup gives its registers up) each run wgmma m64n256k16
// (m64n128k16 at BN 128) on 64 rows of the tile, A K-major and W as the
// MN-major B operand, one group in flight, and arrive on the empty barriers
// as they leave a stage. Their epilogue works on the f32 accumulator
// registers: the bias in f32, then one of four tails that round at the
// reference's places (GemmEpi below: bias; bias + residual rounded once;
// bias, bf16, QuickGELU; bias, bf16, residual), into a staging tile laid out
// as the output's tensor map cuts it; the residual is already there, loaded
// by TMA while the tile's products ran. Warps 9-11 then finish QuickGELU on
// half the staging tile (the consumers take the other half in registers:
// next to the tensor cores at work the epilogue warps run at about a third
// of the consumers' rate, and alone they fall behind a tile's products) and
// store it with TMA, while the consumers run the next tile's products: only
// the consumers' own epilogue (1,100 of a qkv tile's 21,000 cycles; 5,500
// with fc1's half of QuickGELU) leaves the tensor cores idle. BN
// is 256 (3 stages and one staging tile in the 227 KB), or 128 (5 stages,
// two staging tiles) where N is not a multiple of 256 or 128-wide tiles
// leave less of the last wave idle (N = 1024 at 18,464 rows: 8.79 waves of
// 128 against 4.39 of 256). QuickGELU's quotient comes from the
// special-function unit and is held to the IEEE division's bf16 rounding
// (quick_gelu). The tile width moves no bit of the output: every element
// sums the same 64-deep K steps of k16 products in the same order. cuBLAS
// cannot take an f32 bias into its accumulator (addmm rounds the bias to
// bf16 first), which is why the tower runs on this GEMM.
//
// ln_rows (every LayerNorm of both towers): xn = bf16(LN(x)), one warp a
// row, written once where the reference rounds. Before a GEMM (K2's LN1,
// LN1 of the last vision block and of the text tower, LN2 before fc1) it is
// the GEMM's prologue, a launch of its own that the GEMM then reads like any
// A (d2r_ln_gemm); ln_pre, ln_post and ln_final run it alone (d2r_ln_rows).
// One pass reads the bf16 rows and writes them back: 75.6 MB at the scoring
// shape (32 x 577 rows of 1024), 0.0226 ms at 3.35 TB/s.
//
// attn_exact (K4: 3 captions x 12 heads x 77 tokens, bound by launch
// latency: 0.4 us of bytes). One launch, 64 query rows of one head a block,
// four warps of 16 rows on mma.sync m16n8k16 from ldmatrix'd shared tiles;
// Q, K and V rows (only the keys the block may weigh) land through cp.async,
// every copy in flight at once.
// For T <= 128 (CLIP's 77-token context) every key fits one tile: S = Q K^T
// is computed once into registers (16 rows x 128 keys a warp), and the
// exact softmax runs there: the row max and the f32 sum of exp(s - m) over
// the four lanes of a quad, then p = bf16(exp(s - m) / l), the reference's
// rounding place (exp as ex2.approx, 1 / l once a row: an expf and an IEEE
// division a weight make the kernel 1.7 times slower, as
// tools/attention_causal_ab.py measures), packed in place into the A
// fragments of P V (the m16n8
// accumulator layout of two 8-key tiles is the m16n8k16 A layout), so no
// score or weight touches shared memory. Longer T (tests only) keeps the
// exact three passes over key tiles of 128 (row max, row sum, output), S
// recomputed in registers each time. Masked keys (padding, causal) get
// weight 0, the same as the reference's -1e9 bias or -0.7*f32max mask.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

struct Strides {
  long b, h, t;  // element strides of q/k/v (dim contiguous)
  long ob, oh, ot;  // element strides of out
};

constexpr int kHd = 64;  // head dim (CLIP ViT-L/14 and its text tower)

// ------------------------------------------------------------- PTX helpers

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d (64 x 128 f32, this warpgroup's accumulator) = or += A (64 x 16, shared)
// * B (16 x 128, shared). TNSP_B 0: B is K-major (rows = N); 1: MN-major.
template <int TNSP_B>
__device__ __forceinline__ void wgmma_64x128x16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : D2R_F16(d, 0), D2R_F16(d, 16), D2R_F16(d, 32), D2R_F16(d, 48)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TNSP_B));
}

// The same with 80 columns (K-major B), for a last key tile of at most 80
// keys: d[0..39] = or += A * B.
__device__ __forceinline__ void wgmma_64x80x16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n"
      "}\n"
      : D2R_F16(d, 0), D2R_F16(d, 16), D2R_F4(d, 32), D2R_F4(d, 36)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// 2^x for x <= 0 with the subnormal results kept: without .ftz the
// instruction expands to a range test and two extra multiplies per value, so
// the exponent is raised by 24 inside the fast form, whose result is then
// never subnormal above 2^-150, and the multiply by 2^-24 rounds into the
// subnormal range as f32 arithmetic does.
__device__ __forceinline__ float ex2_biased(float x_plus_24) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x_plus_24));
  return y * 5.9604644775390625e-08f;
}

// ---------------------------------------------------- LayerNorm row pass

// One warp per row: xn = bf16(((x - mu) * rstd) * g + beta) with mu and
// rstd = rsqrt(var + eps) in f32, two-pass like the reference
// (var = mean((x - mu)^2)). Each product and sum is rounded on its own, as
// the plain version's separate tensor operations round them: a fused
// multiply-add would move a bf16 rounding of xn now and then. K % 8 == 0.
__global__ void ln_rows(const bf16* __restrict__ x, const float* __restrict__ g,
                        const float* __restrict__ beta, int M, int K, float eps,
                        bf16* __restrict__ xn) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + size_t(row) * K);
  const int chunks = K >> 3;
  float sum = 0.0f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 u = xr[c];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += bf16_lo(w[e]) + bf16_hi(w[e]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float mu = sum / float(K);
  float sq = 0.0f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 u = xr[c];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d0 = bf16_lo(w[e]) - mu, d1 = bf16_hi(w[e]) - mu;
      sq += d0 * d0 + d1 * d1;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  const float rstd = rsqrtf(sq / float(K) + eps);
  uint4* outr = reinterpret_cast<uint4*>(xn + size_t(row) * K);
  for (int c = lane; c < chunks; c += 32) {
    const uint4 u = xr[c];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    const float4 g0 = *reinterpret_cast<const float4*>(g + c * 8);
    const float4 g1 = *reinterpret_cast<const float4*>(g + c * 8 + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(beta + c * 8);
    const float4 b1 = *reinterpret_cast<const float4*>(beta + c * 8 + 4);
    const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint32_t r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[e] = pack_bf16(
          __fadd_rn(__fmul_rn(__fmul_rn(bf16_lo(w[e]) - mu, rstd), gg[2 * e]), bb[2 * e]),
          __fadd_rn(__fmul_rn(__fmul_rn(bf16_hi(w[e]) - mu, rstd), gg[2 * e + 1]), bb[2 * e + 1]));
    outr[c] = make_uint4(r[0], r[1], r[2], r[3]);
  }
}

// ------------------------------------------------- bf16 GEMM (TMA + wgmma)

constexpr int kGM = 128, kGK = 64;  // tile rows; K depth of a ring stage
constexpr int kGThreads = 384;      // warpgroups 0-1 consumers, warpgroup 2 producer + epilogue
constexpr int kGEpiThreads = 96;    // warps 9-11
constexpr int kGMaxSmem = 232448;   // the most dynamic shared memory a block may have

// The shared-memory plan of a 128 x BN tile: a ring of stages (the A tile,
// then W's BN / 64 chunks of 64 x 64), one or two staging tiles (BN / 64
// boxes of 128 rows x 64 columns, laid out as the output's tensor map cuts
// it) and the barriers. The ring takes what the rest leaves: 3 stages at
// BN 256, 5 at BN 128.
template <int BN>
struct GemmPlan {
  static constexpr int kA = kGM * kGK * 2;     // 16 KB
  static constexpr int kStage = kA + kGK * BN * 2;
  static constexpr int kStaging = kGM * BN * 2;
  static constexpr int kBufs = BN == 128 ? 2 : 1;  // staging tiles
  static constexpr int kStages = (kGMaxSmem - kBufs * kStaging - 1024) / kStage;
  static constexpr int kSmem =
      kStages * kStage + kBufs * kStaging + 8 * (2 * kStages + 2 * kBufs);
  static_assert(kStages >= 3, "the ring needs three stages");
};

// One box of the tensor map -> shared memory; completion counts on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c_inner, int c_outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c_inner), "r"(c_outer)
      : "memory");
}

// One box of shared memory -> the tensor map's box at (c_inner, c_outer);
// rows past the map's edge are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c_inner,
                                             int c_outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c_inner), "r"(c_outer)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until at most kPending of the committed stores are still reading their
// shared memory.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}
// Until every committed store is done.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One box of a 4-d tensor map -> shared memory; completion counts on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// d (64 x 256 f32, this warpgroup's accumulator) = or += A (64 x 16, shared,
// K-major) * B (16 x 256, shared, MN-major).
__device__ __forceinline__ void wgmma_64x256x16_ss(float (&d)[128], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : D2R_F16(d, 0), D2R_F16(d, 16), D2R_F16(d, 32), D2R_F16(d, 48), D2R_F16(d, 64),
        D2R_F16(d, 80), D2R_F16(d, 96), D2R_F16(d, 112)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The epilogues of gemm_tma, on the f32 accumulator y = a @ W + bias (the
// product and the bias summed in f32, as jnp.dot(..., preferred_element_type
// = f32) + b):
//   0 bias             bf16(y): K2's qkv projection
//   1 bias_resid       bf16(f32(resid) + y), one rounding: the bench's v13
//                      out-projection (X3)
//   2 bias_gelu        h = bf16(y), then bf16(h * bf16(sigmoid(1.702 h))), the
//                      sigmoid in f32: CLIP's fc1 and QuickGELU
//   3 bias_then_resid  bf16(f32(resid) + f32(bf16(y))): CLIP's out-projection
//                      and fc2 with the residual add after the layer's own
//                      rounding, as the reference's x + (a @ W + b).astype(bf16)
enum GemmEpi { kEpiBias = 0, kEpiBiasResid = 1, kEpiBiasGelu = 2, kEpiBiasThenResid = 3 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// The same for x that is not NaN, in integer arithmetic (the conversion
// issues at a quarter of the rate, through the unit the exponentials use).
__device__ __forceinline__ float bf16_round_int(float x) {
  const uint32_t b = __float_as_uint(x);
  return __uint_as_float((b + 0x7FFFu + ((b >> 16) & 1u)) & 0xFFFF0000u);
}

// What the consumers store for y (and the residual r), before its bf16
// rounding: all of epilogues 0, 1 and 3, and bias_gelu's h.
template <int kEpi>
__device__ __forceinline__ float epilogue(float y, float r) {
  if (kEpi == kEpiBiasResid) return r + y;
  if (kEpi == kEpiBiasThenResid) return r + bf16_round(y);
  return y;
}

// QuickGELU of bias_gelu's 2 kWords bf16 values h in w, in place:
// bf16(h * bf16(s)), s = 1 / (1 + expf(-1.702 h)) as the IEEE division
// rounds it (the product is exact in f32). The division branches to its
// slow path a value, which leaves a warp one value's chain at a time; here
// the reciprocal is rcp.approx refined by one Newton step, which lies
// within one f32 ulp of the correctly rounded quotient, so both round to
// the same bf16 unless its low 16 bits lie next to a bf16 rounding boundary
// (0x8000 +- 1) or y reaches 2^126 (a subnormal or zero quotient, or y
// infinite or NaN). The values of a call take the division together where
// any one does (under one call of 16 values in a thousand); the others'
// chains run side by side.
template <int kWords>
__device__ __forceinline__ void quick_gelu(uint32_t (&w)[kWords]) {
  constexpr int kN = 2 * kWords;
  float h[kN], s[kN];
  bool exact = false;
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    h[e] = (e & 1) ? bf16_hi(w[e >> 1]) : bf16_lo(w[e >> 1]);
    const float y = 1.0f + expf(-1.702f * h[e]);
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(y));
    s[e] = fmaf(r, fmaf(-y, r, 1.0f), r);
    exact |= ((__float_as_uint(s[e]) & 0xFFFFu) - 0x7FFFu < 3u) | !(y < 0x1p126f);
  }
  if (exact) {
#pragma unroll
    for (int e = 0; e < kN; ++e) s[e] = 1.0f / (1.0f + expf(-1.702f * h[e]));
  }
#pragma unroll
  for (int e = 0; e < kWords; ++e)
    w[e] = pack_bf16(h[2 * e] * bf16_round_int(s[2 * e]),
                     h[2 * e + 1] * bf16_round_int(s[2 * e + 1]));
}

// bias_gelu's QuickGELU of a tile's first kGeluOwn 8-column chunks is the
// consumers' (in registers, as they stage the tile), the rest the epilogue
// warps'. Half and half was the fastest split of fc1 (18,464 x 1,024 ->
// 4,096) on the H100: 14 or 20 of its 32 chunks ran 3-10% slower.
template <int BN>
constexpr int kGeluOwn = BN / 16;

// The tile width for an (M x N) output on `sms` SMs: 256 columns, unless N is
// not a multiple of 256 or 128-column tiles leave so much less of the last
// wave idle that it pays for their lower rate (a 128-wide tile takes 0.55 of
// a 256-wide one's time). At 18,464 rows N = 1024 gives 580 tiles of 256
// (4.39 waves on 132 SMs, 5 to wait for) or 1,160 of 128 (8.79, 9 to wait
// for); few rows give few tiles, and the narrow ones fill more SMs.
int gemm_width(int M, int N, int sms) {
  if (N % 256) return 128;
  const long m_tiles = (M + kGM - 1) / kGM;
  const long w256 = (m_tiles * (N / 256) + sms - 1) / sms;
  const long w128 = (m_tiles * (N / 128) + sms - 1) / sms;
  return 55 * w128 < 100 * w256 ? 128 : 256;
}

// out (M x N) = epilogue kEpi of a @ W + bias for a (M x K), W (K x N)
// row-major; resid (M x N) for the residual epilogues. map_a: a in boxes of
// 64 (K) x 128 rows; map_w: W in boxes of 64 (N) x 64 (K); map_o and map_r:
// out and resid in boxes of 64 (N) x 128 rows; all 128-byte swizzled.
// K % 64 == 0, N % BN == 0. A persistent grid: block b takes the 128 x BN
// output tiles b, b + gridDim.x, ..., N's tiles innermost (see the note at
// the top for the roles).
template <int kEpi, int BN>
__global__ void __launch_bounds__(kGThreads, 1)
    gemm_tma(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
             const __grid_constant__ CUtensorMap map_o, const __grid_constant__ CUtensorMap map_r,
             const float* __restrict__ bias, int M, int K, int N) {
  using P = GemmPlan<BN>;
  constexpr bool kResid = kEpi == kEpiBiasResid || kEpi == kEpiBiasThenResid;
  constexpr int kS = P::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023u) __trap();
  constexpr int kB = P::kBufs;
  const uint32_t stg = base + kS * P::kStage;
  // full[kS], empty[kS], then each staging tile's two: ready (free, and for
  // the residual epilogues holding the residual) and done (the consumers'
  // values in it). Tile ti takes staging tile ti % kB.
  const uint32_t full = stg + kB * P::kStaging, empty = full + 8 * kS, ready = empty + 8 * kS,
                 done = ready + 8 * kB;
  unsigned char* const gstg = smem_raw + kS * P::kStage;
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = tid >> 5, lane = tid & 31;
  const int n_tiles = N / BN, tiles = (M + kGM - 1) / kGM * n_tiles, nk = K / kGK;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx arrival
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    for (int b = 0; b < kB; ++b) {
      mbar_init(ready + 8 * b, 1);
      mbar_init(done + 8 * b, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_proxy();
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    if (warp == 8) {
      // The producer: every stage of every tile, as soon as the consumers
      // have left it.
      if (lane == 0) {
        int it = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          const int m0 = t / n_tiles * kGM, n0 = t % n_tiles * BN;
          for (int kb = 0; kb < nk; ++kb, ++it) {
            const int s = it % kS;
            mbar_wait(empty + 8 * s, ((it / kS) & 1) ^ 1);
            const uint32_t bar = full + 8 * s, sA = base + s * P::kStage;
            mbar_expect_tx(bar, P::kStage);
            tma_load_2d(sA, &map_a, bar, kb * kGK, m0);
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load_2d(sA + P::kA + c * 8192, &map_w, bar, n0 + 64 * c, kb * kGK);
          }
        }
      }
    } else {
      // The epilogue warps: hand a staging tile to the consumers (with the
      // residual in it), finish bias_gelu's QuickGELU in place, and store it.
      const int et = tid - (kGThreads - kGEpiThreads);
      int ti = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++ti) {
        const int m0 = t / n_tiles * kGM, n0 = t % n_tiles * BN, b = ti % kB;
        const uint32_t sb = stg + b * P::kStaging;
        unsigned char* const gsb = gstg + b * P::kStaging;
        if (et == 0) {
          bulk_wait_read<kB - 1>();  // staging tile b's last store has read it
          if (kResid) {
            mbar_expect_tx(ready + 8 * b, P::kStaging);
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load_2d(sb + c * 16384, &map_r, ready + 8 * b, n0 + 64 * c, m0);
          } else {
            mbar_arrive(ready + 8 * b);
          }
        }
        mbar_wait(done + 8 * b, (ti / kB) & 1);
        if (kEpi == kEpiBiasGelu) {
          // The 8-column chunks right of the consumers' share, row by row,
          // two a step for sixteen chains in flight. A chunk's place in its
          // box is swizzled by the row.
          constexpr int kRow = BN / 8 - kGeluOwn<BN>, kItems = kGM * kRow;
          auto chunk = [&](int k) {
            const int r = k / kRow, cc = kGeluOwn<BN> + k % kRow;
            return reinterpret_cast<uint4*>(gsb + (cc >> 3) * 16384 + sw128_off(r, cc & 7));
          };
          for (int k = et; k < kItems; k += 2 * kGEpiThreads) {
            const bool two = k + kGEpiThreads < kItems;
            uint4* c0 = chunk(k);
            uint4* c1 = chunk(two ? k + kGEpiThreads : k);
            const uint4 u0 = *c0, u1 = *c1;
            uint32_t w[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
            quick_gelu(w);
            *c0 = make_uint4(w[0], w[1], w[2], w[3]);
            if (two) *c1 = make_uint4(w[4], w[5], w[6], w[7]);
          }
          fence_async_proxy();  // the store reads what the generic proxy wrote
        }
        named_barrier(1, kGEpiThreads);
        if (et == 0) {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c) tma_store_2d(&map_o, sb + c * 16384, n0 + 64 * c, m0);
          bulk_commit();
        }
      }
      if (et == 0) bulk_wait_all();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
    // The consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile.
    const int quad = lane & 3;
    const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // this thread's first row
    float acc[BN / 2];
    int it = 0, ti = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++ti) {
      const int n0 = t % n_tiles * BN;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % kS;
        mbar_wait(full + 8 * s, (it / kS) & 1);
        const uint32_t sA = base + s * P::kStage;
        const uint64_t dA = sw128_desc(sA + wg * 8192, 16, 1024);
        const uint64_t dB = sw128_desc(sA + P::kA, 8192, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kGK / 16; ++kk) {
          if constexpr (BN == 256)
            wgmma_64x256x16_ss(acc, dA + 2 * kk, dB + (2048 >> 4) * kk, kb > 0 || kk > 0);
          else
            wgmma_64x128x16_ss<1>(acc, dA + 2 * kk, dB + (2048 >> 4) * kk, kb > 0 || kk > 0);
        }
        wgmma_commit();
        // One group stays in flight; the one before has left its stage.
        wgmma_wait<1>();
        if (kb > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kS));
        __syncwarp();
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kS));
      __syncwarp();

      // The tile's values into the staging tile, where the epilogue warps
      // take them: bias in f32, the epilogue's tail, one bf16 rounding, and
      // bias_gelu's QuickGELU on the first kGeluOwn chunks of columns. Eight
      // values a step: columns j and j + 1 of rows r0 and r0 + 8.
      const int b = ti % kB;
      unsigned char* const gsb = gstg + b * P::kStaging;
      mbar_wait(ready + 8 * b, (ti / kB) & 1);
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        uint32_t* cell[4];
        float y[8];
        uint32_t w[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {  // c: column j + (c >> 1), row r0 + 8 (c & 1)
          const int jj = j + (c >> 1), r = r0 + 8 * (c & 1);
          const float2 bj = *reinterpret_cast<const float2*>(bias + n0 + 8 * jj + 2 * quad);
          cell[c] = reinterpret_cast<uint32_t*>(gsb + (jj >> 3) * 16384 + sw128_off(r, jj & 7) +
                                                quad * 4);
          y[2 * c] = acc[4 * jj + 2 * (c & 1)] + bj.x;
          y[2 * c + 1] = acc[4 * jj + 2 * (c & 1) + 1] + bj.y;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t rv = kResid ? *cell[c] : 0u;
          w[c] = pack_bf16(epilogue<kEpi>(y[2 * c], bf16_lo(rv)),
                           epilogue<kEpi>(y[2 * c + 1], bf16_hi(rv)));
        }
        if (kEpi == kEpiBiasGelu && j < kGeluOwn<BN>) quick_gelu(w);
#pragma unroll
        for (int c = 0; c < 4; ++c) *cell[c] = w[c];
      }
      fence_async_proxy();  // the store reads what the generic proxy wrote
      __syncwarp();
      if (lane == 0) mbar_arrive(done + 8 * b);
    }
  }
}

// ------------------------------------------------ attention (wgmma, TMA ring)

constexpr int kBQ = 128;  // query rows a block: two warpgroups of 64
constexpr int kBK = 128;  // keys a tile
constexpr int kFThreads = 256;
constexpr int kTileBytes = kBK * kHd * 2;    // 16 KB: a K or V tile, and the Q tile
constexpr int kStageBytes = 2 * kTileBytes;  // K then V
constexpr int kStages = 3;
// The Q tile, the ring and its full / empty barriers. No slack to align by
// hand: with it two blocks would miss an SM's shared memory by 64 bytes.
constexpr int kAttnSmem = kTileBytes + kStages * kStageBytes + 64;

// q, k, v come through tensor maps over (64 of the head, T, H or the packed
// heads, B) with the caller's strides, so one thread asks for a whole tile
// and rows past T arrive as zeros. t_first says which of T and H has the
// smaller stride, the order the maps list them in. scale is a power of two
// (64^-0.5), so scaling the scores is the same arithmetic as scaling q and
// rounding it to bf16, and q is used as it lies in memory.
template <int MODE>
__global__ void __launch_bounds__(kFThreads, 1)
    attn_fwd(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out, int T, long ob,
             long oh, long ot, float scale, int t_first, uint32_t probe_mask) {
  constexpr bool kProducts = MODE != 4 && MODE != 5;  // QK^T and PV
  constexpr bool kRowMax = MODE == 1 || MODE == 5;
  constexpr bool kRowSum = MODE == 0 || MODE == 1 || MODE == 3 || MODE == 5;  // l += p
  constexpr bool kProbe = MODE >= 4;
  constexpr float kLog2e = 1.4426950408889634f;

  // The 128-byte swizzle repeats every 1024 bytes, from which the tiles must
  // start.
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  unsigned char* gbase = smem_raw;
  if (base & 1023u) __trap();
  const uint32_t sQ = base, sRing = base + kTileBytes;
  const uint32_t bars = sRing + kStages * kStageBytes;  // full[kStages], empty[kStages]

  // The warpgroup index through a shuffle, so that the compiler knows it
  // uniform across the warp: on a path it takes for divergent it serialises
  // every wgmma.
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int lane = tid & 31, quad = lane & 3;
  const int rloc = ((tid >> 5) & 3) * 16 + (lane >> 2);  // this thread's first row in its warpgroup
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int n_kt = (T + kBK - 1) / kBK;
  const int n_jobs = kRowMax ? 2 * n_kt : n_kt;
  // A warpgroup whose rows all lie past T has nothing to do.
  const bool active = q0 + wg * 64 < T;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);  // full: the requesting thread's expect_tx arrival
      // empty: one arrival per warp that reads the stage
      mbar_init(bars + 8 * (kStages + st), q0 + 64 < T ? 8 : 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_proxy();
  }
  __syncthreads();
  if (!active) return;

  // Job j of the ring: the max pass (K only) over every key tile, then the
  // main pass (K and V). The probes' main pass ends on key tile 0.
  auto job_tile = [&](int j, bool& main_pass) {
    main_pass = !kRowMax || j >= n_kt;
    int kt = (kRowMax && j >= n_kt) ? j - n_kt : j;
    if (kProbe && main_pass) kt = (kt + 1) % n_kt;
    return kt;
  };
  // Thread 0 asks for job j's tiles (and with job 0 the Q tile).
  auto request = [&](int j) {
    bool main_pass;
    const int kt = job_tile(j, main_pass);
    const uint32_t full = bars + 8 * (j % kStages), sK = sRing + (j % kStages) * kStageBytes;
    const int c1 = t_first ? kt * kBK : h, c2 = t_first ? h : kt * kBK;
    mbar_expect_tx(full, (1 + int(main_pass) + int(j == 0)) * kTileBytes);
    if (j == 0) tma_load_4d(sQ, &map_q, full, 0, t_first ? q0 : h, t_first ? h : q0, b);
    tma_load_4d(sK, &map_k, full, 0, c1, c2, b);
    if (main_pass) tma_load_4d(sK + kTileBytes, &map_v, full, 0, c1, c2, b);
  };
  if (tid == 0)
    for (int j = 0; j < kStages && j < n_jobs; ++j) request(j);

  const uint32_t sQw = sQ + wg * (64 * 128);  // this warpgroup's 64 rows
  const uint64_t dQ = sw128_desc(sQw, 16, 1024);
  float s[64], o[32];
  uint32_t pk[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  uint32_t f0 = 0u, f1 = 0u;  // bits of the probes' fabricated scores, rows rloc and rloc + 8
  // Scores are q k^T unscaled where the products run; the probes' fabricated
  // scores are scaled as they are made.
  const float sl = kProducts ? scale * kLog2e : kLog2e, cap = kProducts ? 70.0f / scale : 70.0f;

  for (int j = 0; j < n_jobs; ++j) {
    // Once every reading warp is done with job j - 1, its stage takes job
    // j + kStages - 1; the warpgroups meet nowhere else.
    if (tid == 0 && j >= 1 && j + kStages - 1 < n_jobs) {
      mbar_wait(bars + 8 * (kStages + (j - 1) % kStages), ((j - 1) / kStages) & 1);
      request(j + kStages - 1);
    }
    // Thread 0's lanes wait for it: the warp-wide instructions below (wgmma,
    // shuffles, named barriers) need the whole warp, and the probes without
    // products have none that would gather it.
    __syncwarp();
    mbar_wait(bars + 8 * (j % kStages), (j / kStages) & 1);  // job j has landed
    bool main_pass;
    const int kt = job_tile(j, main_pass);
    const uint32_t sK = sRing + (j % kStages) * kStageBytes, sV = sK + kTileBytes;
    const bool ragged = kt * kBK + kBK > T;
    const int col0 = kt * kBK + 2 * quad;  // this thread's first key column of the tile

    // One key tile over its first 16 NS keys: all 128, or 80 where the last
    // tile holds no more (T = 577 leaves 65), which spares the products and
    // the softmax of the columns that are masked anyway.
    auto tile = [&](auto slabs) {
      constexpr int NS = decltype(slabs)::value;
      if (kProducts) {
        const uint64_t dK = sw128_desc(sK, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk) {
          if (NS == 8) wgmma_64x128x16_ss<0>(s, dQ + 2 * kk, dK + 2 * kk, kk > 0);
          else wgmma_64x80x16_ss(s, dQ + 2 * kk, dK + 2 * kk, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
      } else {
        if (j == 0) {
          const int r0 = wg * 64 + rloc, r1 = r0 + 8;
          f0 = __float_as_uint(scale * __uint_as_float(uint32_t(*reinterpret_cast<const uint16_t*>(
                                           gbase + sw128_off(r0, 0))) << 16));
          f1 = __float_as_uint(scale * __uint_as_float(uint32_t(*reinterpret_cast<const uint16_t*>(
                                           gbase + sw128_off(r1, 0))) << 16));
        }
        const uint32_t w = *reinterpret_cast<const uint32_t*>(gbase + (sK - base) + tid * 4);
#pragma unroll
        for (int i = 0; i < 8 * NS; ++i)
          s[i] = __uint_as_float(((i & 2) ? f1 : f0) | ((w + i) & probe_mask));
      }

      if (kRowMax && !main_pass) {
#pragma unroll
        for (int i = 0; i < 8 * NS; ++i) {
          const int col = col0 + 8 * (i >> 2) + (i & 1);
          const float sv = (ragged && col >= T) ? -INFINITY : s[i];
          if (i & 2) m1 = fmaxf(m1, sv);
          else m0 = fmaxf(m0, sv);
        }
        return;
      }

      // Weights, rounded to bf16 and packed in place: pair jj holds columns
      // 8 (jj / 2) + 2 quad + {0, 1} of row rloc (jj even) or rloc + 8 (odd),
      // which is register jj of the A fragments of P.
#pragma unroll
      for (int jj = 0; jj < 4 * NS; ++jj) {
        const float mrow = (jj & 1) ? m1 : m0;
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sv = s[2 * jj + e];
          if (MODE == 0) p[e] = ex2_biased(fmaf(fminf(sv, cap), sl, 24.0f - 70.0f * kLog2e));
          else if (MODE == 1 || MODE == 5) p[e] = ex2_biased(fmaf(sv - mrow, sl, 24.0f));
          else if (MODE == 3 || MODE == 4) p[e] = ex2(sv * sl);
          else p[e] = sv * scale;
        }
        pk[jj] = pack_bf16(p[0], p[1]);
      }
      if (ragged) {  // keys at or past T weigh exactly 0
#pragma unroll
        for (int jj = 0; jj < 4 * NS; ++jj) {
          const int col = col0 + 8 * (jj >> 1);
          if (col + 1 >= T) pk[jj] = col >= T ? 0u : pk[jj] & 0xFFFFu;
        }
      }
      if (kRowSum) {
#pragma unroll
        for (int jj = 0; jj < 4 * NS; jj += 2) {
          l0 += bf16_lo(pk[jj]) + bf16_hi(pk[jj]);
          l1 += bf16_lo(pk[jj + 1]) + bf16_hi(pk[jj + 1]);
        }
      }
      if (kProducts) {
        const uint64_t dV = sw128_desc(sV, kTileBytes, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NS; ++kk)
          wgmma_64x64x16_rs(o, pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2], pk[4 * kk + 3],
                            dV + (2048 >> 4) * kk);
        wgmma_commit();
        wgmma_wait<0>();
      }
    };
    if (T - kt * kBK <= 80) tile(std::integral_constant<int, 5>{});
    else tile(std::integral_constant<int, 8>{});
    if (kRowMax && j == n_kt - 1) {  // the max pass is over: the row's four lanes
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    }
    __syncwarp();  // every lane has read what it needs of the stage
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + j % kStages));  // this warp is done with it
  }
  __syncwarp();
  if (kRowSum) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  }

  // Output through this warpgroup's rows of the Q tile (its wgmma reads of
  // them are done), then 16-byte stores. The probes without products give
  // the first 64 columns of p.
  named_barrier(1 + wg, 128);
#pragma unroll
  for (int jo = 0; jo < 8; ++jo)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float y0, y1;
      if (kProducts) {
        y0 = o[4 * jo + 2 * hh];
        y1 = o[4 * jo + 2 * hh + 1];
      } else {
        y0 = bf16_lo(pk[2 * jo + hh]);
        y1 = bf16_hi(pk[2 * jo + hh]);
      }
      if (kRowSum) {
        const float l = hh ? l1 : l0;
        y0 /= l;
        y1 /= l;
      }
      const int r = rloc + 8 * hh;
      *reinterpret_cast<uint32_t*>(gbase + wg * (64 * 128) + sw128_off(r, jo) + quad * 4) =
          pack_bf16(y0, y1);
    }
  named_barrier(1 + wg, 128);
  const int t = tid & 127;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i * 16 + (t >> 3), c = t & 7, row = q0 + wg * 64 + r;
    if (row < T)
      *reinterpret_cast<uint4*>(out + b * ob + h * oh + long(row) * ot + c * 8) =
          *reinterpret_cast<const uint4*>(gbase + wg * (64 * 128) + sw128_off(r, c));
  }
}

template <int MODE>
int launch_attn(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* out,
                int B, int H, int T, const Strides& st, float scale, int grid_x,
                cudaStream_t stream) {
  static std::atomic<unsigned long long> configured{0};  // per instantiation
  cudaError_t err = allow_smem(attn_fwd<MODE>, kAttnSmem, &configured);
  if (err != cudaSuccess) return int(err);
  attn_fwd<MODE><<<dim3(grid_x, H, B), kFThreads, kAttnSmem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), T, st.ob, st.oh, st.ot, scale, int(st.t <= st.h), 0u);
  return int(cudaGetLastError());
}

// --------------------------------- K4: exact softmax in registers (mma.sync)

constexpr int kQT = 64;       // query rows a block: 4 warps of 16
constexpr int kXKeys = 128;   // keys a tile: all of them for T <= 128
constexpr int kAThreads = 128;
constexpr int kLd = kHd + 8;  // bf16 row stride of the shared tiles (144 bytes)
constexpr int kExactSmem = (kQT + 2 * kXKeys) * kLd * 2;  // Q, K and V tiles

// Rows [t0, t0 + n) of one head into an (n x kLd) tile at shared address
// dst, zero past T: 16-byte cp.async copies, all in flight at once (a rows'
// loop of loads and stores would wait out one memory latency a row).
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* __restrict__ src, long st,
                                          int t0, int n, int T) {
  for (int i = threadIdx.x; i < n * (kHd / 8); i += kAThreads) {
    const int r = i / (kHd / 8), c = (i % (kHd / 8)) * 8;
    const bool in = t0 + r < T;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst + (r * kLd + c) * 2),
                 "l"(in ? src + (t0 + r) * st + c : src), "r"(in ? 16 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d (16 x 8 f32) += a (16 x 16 bf16) * b (16 x 8 bf16), the warp's fragments.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// S = Q K^T of this warp's 16 query rows against the first `keys` keys of
// the tile in sK (a multiple of 16 at most 128, rounded up; the rest of s is
// left 0): s[n][e] is row g + 8 (e >> 1), key 8 n + 2 t + (e & 1) of the tile
// (g = lane / 4, t = lane % 4, the mma accumulator layout).
__device__ __forceinline__ void exact_scores(uint32_t sQ, uint32_t sK, int warp, int lane,
                                             int keys, float (&s)[16][4]) {
#pragma unroll
  for (int n = 0; n < 16; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(sQ + ((16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 16 * kk +
                  8 * (lane >> 4)) * 2, a);
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      if (16 * np >= keys) break;
      uint32_t b[4];  // K rows as the col-major B of two 8-key column tiles
      ldsm_x4(sK + ((16 * np + (lane & 7) + 8 * (lane >> 4)) * kLd + 16 * kk +
                    8 * ((lane >> 3) & 1)) * 2, b);
      mma16816(s[2 * np], a, b[0], b[1]);
      mma16816(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// o (16 x 64) += P (16 x keys, bf16 pairs: p[n][0] row g, p[n][1] row g + 8
// of column tile n) V (the tile in sV).
__device__ __forceinline__ void exact_pv(uint32_t sV, int lane, int keys, const uint32_t (&p)[16][2],
                                         float (&o)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (16 * kk >= keys) break;
    const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1]};
#pragma unroll
    for (int dp = 0; dp < kHd / 16; ++dp) {
      uint32_t b[4];  // V rows (key-major) transposed into the B of two 8-wide d tiles
      ldsm_x4_t(sV + ((16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 16 * dp +
                      8 * (lane >> 4)) * 2, b);
      mma16816(o[2 * dp], a, b[0], b[1]);
      mma16816(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// 64 query rows of one (batch, head) a block, 4 warps of 16. T <= 128: one
// pass; longer T: passes for the row max and the row sum, then the output.
__global__ void __launch_bounds__(kAThreads)
    attn_exact(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ out, int T, Strides st, float scale, int causal) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];  // one declaration, one alignment
  // The Q, K and V tiles, kLd bf16 a row.
  const uint32_t sQ = smem_u32(smem_raw), sK = sQ + kQT * kLd * 2, sV = sK + kXKeys * kLd * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const long in_off = b * st.b + h * st.h;
  const int qw = q0 + 16 * warp;  // this warp's first query row
  // Keys any row of the block / of this warp may weigh (later ones are masked).
  const int t_blk = causal ? min(T, q0 + kQT) : T;
  const int t_warp = causal ? min(T, qw + 16) : T;
  const int n_kt = (t_blk + kXKeys - 1) / kXKeys;

  float s[16][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  uint32_t p[16][2];
  // Element (n, e) of tile kt: masked keys (padding, causal) get weight 0.
  auto valid = [&](int kt, int n, int e) {
    const int key = kt * kXKeys + 8 * n + 2 * t + (e & 1), row = qw + g + 8 * (e >> 1);
    return key < T && (!causal || key <= row);
  };
  auto tile_keys = [&](int kt) { return min(kXKeys, t_warp - kt * kXKeys); };
  // exp(s - m) in place, as ex2.approx.ftz of (s - m) log2(e) (expf is
  // slower; a weight below 2^-126 of the row's largest moves no output),
  // over the column tiles P V reads (the 16-key groups that hold the warp's
  // keys); with sum, l += it in f32.
  auto exps = [&](int kt, bool sum) {
    constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      if (16 * (n >> 1) >= tile_keys(kt)) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = valid(kt, n, e) ? ex2_ftz((s[n][e] - m[e >> 1]) * kLog2e) : 0.0f;
        l[e >> 1] += sum ? s[n][e] : 0.0f;
      }
    }
  };
  auto quad = [&](float (&x)[2], bool is_max) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, x[i], off);
        x[i] = is_max ? fmaxf(x[i], y) : x[i] + y;
      }
  };
  // Key rows of tile kt the block reads: its keys, to a multiple of 16.
  auto kv_rows = [&](int kt) { return (min(kXKeys, t_blk - kt * kXKeys) + 15) & ~15; };

  // Three passes over the key tiles: 0 the exact row max, 1 the f32 row sum
  // of exp(s - m), 2 p = bf16(exp(s - m) / l) (the reference's rounding
  // place) and O += P V. With one tile (T <= 128) the tile lands and S is
  // computed once, in pass 0; passes 1 and 2 work on its registers. Each
  // piece of the body appears once in the code.
  const bool one = n_kt == 1;
  copy_rows(sQ, q + in_off, st.t, q0, kQT, T);
  for (int pass = 0; pass < 3; ++pass) {
    for (int kt = 0; kt < n_kt; ++kt) {
      if (pass == 0 || !one) {
        __syncthreads();  // every warp is done with the last tile
        copy_rows(sK, k + in_off, st.t, kt * kXKeys, kv_rows(kt), T);
        if (pass == 2 || one) copy_rows(sV, v + in_off, st.t, kt * kXKeys, kv_rows(kt), T);
        copies_landed();
        exact_scores(sQ, sK, warp, lane, tile_keys(kt), s);
        // The scale is a power of two: scaling the f32 scores is the same
        // arithmetic as the reference's bf16(q * scale).
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= scale;
      }
      if (pass == 0) {
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          if (16 * (n >> 1) >= tile_keys(kt)) break;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (valid(kt, n, e)) m[e >> 1] = fmaxf(m[e >> 1], s[n][e]);
        }
      } else if (pass == 1 || !one) {
        exps(kt, pass == 1);
      }
      if (pass == 2) {
        // One IEEE division a row, then products (a division a weight is
        // slower).
        const float inv0 = 1.0f / l[0], inv1 = 1.0f / l[1];
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          if (16 * (n >> 1) >= tile_keys(kt)) break;  // P V reads no further
          p[n][0] = pack_bf16(s[n][0] * inv0, s[n][1] * inv0);
          p[n][1] = pack_bf16(s[n][2] * inv1, s[n][3] * inv1);
        }
        exact_pv(sV, lane, tile_keys(kt), p, o);
      }
    }
    if (pass == 0) quad(m, true);
    if (pass == 1) quad(l, false);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = qw + g + 8 * e;
    if (row >= T) continue;
    bf16* orow = out + b * st.ob + h * st.oh + long(row) * st.ot;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) = pack_bf16(o[n][2 * e], o[n][2 * e + 1]);
  }
}

// ------------------------------------------------------------ tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; the library links only the
// runtime, so the entry point is fetched through it.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major (rows x cols) bf16 matrix cut into 128-byte-swizzled boxes of
// box_rows x 64 columns; boxes past the edge are zero-filled.
bool make_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
              uint32_t box_rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// One head's rows of q, k or v as a 4-d map: 64 of the head (contiguous), then
// T and the heads in the order of their strides, then the batch; boxes of 128
// rows of one head, 128-byte swizzled, zero-filled past T. Strides in
// elements, multiples of 8.
bool make_head_map(CUtensorMap* map, const void* ptr, int B, int H, int T, const Strides& st) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const bool t_first = st.t <= st.h;
  const cuuint64_t dims[4] = {kHd, cuuint64_t(t_first ? T : H), cuuint64_t(t_first ? H : T),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(t_first ? st.t : st.h) * 2,
                                 cuuint64_t(t_first ? st.h : st.t) * 2, cuuint64_t(st.b) * 2};
  const cuuint32_t box[4] = {kHd, cuuint32_t(t_first ? 128 : 1), cuuint32_t(t_first ? 1 : 128), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int kEpi, int BN>
int launch_gemm_tiles(const CUtensorMap& ma, const CUtensorMap& mw, const CUtensorMap& mo,
                      const CUtensorMap& mr, const float* bias, int M, int K, int N, int sms,
                      cudaStream_t stream) {
  static std::atomic<unsigned long long> configured{0};  // per instantiation
  cudaError_t err = allow_smem(gemm_tma<kEpi, BN>, GemmPlan<BN>::kSmem, &configured);
  if (err != cudaSuccess) return int(err);
  const long tiles = long((M + kGM - 1) / kGM) * (N / BN);
  gemm_tma<kEpi, BN><<<int(tiles < sms ? tiles : sms), kGThreads, GemmPlan<BN>::kSmem, stream>>>(
      ma, mw, mo, mr, bias, M, K, N);
  return int(cudaGetLastError());
}

template <int kEpi>
int launch_gemm(const void* a, const void* w, const void* bias, const void* resid, int M, int K,
                int N, void* out, cudaStream_t stream) {
  if (K % kGK || N % 128) return int(cudaErrorInvalidValue);
  CUtensorMap map_a, map_w, map_o, map_r;
  if (!make_map(&map_a, a, M, K, kGM) || !make_map(&map_w, w, K, N, kGK) ||
      !make_map(&map_o, out, M, N, kGM) || (resid && !make_map(&map_r, resid, M, N, kGM)))
    return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const float* bp = static_cast<const float*>(bias);
  const CUtensorMap& mr = resid ? map_r : map_o;  // unread without a residual
  if (gemm_width(M, N, sms) == 256)
    return launch_gemm_tiles<kEpi, 256>(map_a, map_w, map_o, mr, bp, M, K, N, sms, stream);
  return launch_gemm_tiles<kEpi, 128>(map_a, map_w, map_o, mr, bp, M, K, N, sms, stream);
}

// out (M x N) = epilogue `epi` (GemmEpi) of a @ W + bias; resid for the
// residual epilogues, null otherwise.
int launch_gemm_epi(const void* a, const void* w, const void* bias, const void* resid, int M,
                    int K, int N, int epi, void* out, cudaStream_t cs) {
  const bool wants_resid = epi == kEpiBiasResid || epi == kEpiBiasThenResid;
  if (bias == nullptr || wants_resid != (resid != nullptr)) return int(cudaErrorInvalidValue);
  switch (epi) {
    case kEpiBias: return launch_gemm<kEpiBias>(a, w, bias, resid, M, K, N, out, cs);
    case kEpiBiasResid: return launch_gemm<kEpiBiasResid>(a, w, bias, resid, M, K, N, out, cs);
    case kEpiBiasGelu: return launch_gemm<kEpiBiasGelu>(a, w, bias, resid, M, K, N, out, cs);
    case kEpiBiasThenResid:
      return launch_gemm<kEpiBiasThenResid>(a, w, bias, resid, M, K, N, out, cs);
    default: return int(cudaErrorInvalidValue);
  }
}

// xn (M x K) = bf16(LN(x)): eight rows (warps) a block. The rows are read
// 16 bytes at a time and g, beta 32, so K % 8 == 0 and every pointer
// 16-byte aligned.
int launch_ln_rows(const void* x, const void* g, const void* beta, int M, int K, float eps,
                   void* xn, cudaStream_t cs) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(beta) | reinterpret_cast<uintptr_t>(xn);
  if (K <= 0 || K % 8 || (any & 15)) return int(cudaErrorInvalidValue);
  ln_rows<<<(M + 7) / 8, 256, 0, cs>>>(static_cast<const bf16*>(x), static_cast<const float*>(g),
                                       static_cast<const float*>(beta), M, K, eps,
                                       static_cast<bf16*>(xn));
  return int(cudaGetLastError());
}

}  // namespace

// Attention over heads of 64 addressed by element strides. mode 0 clamp,
// 1 maxsub, 2 exact softmax, 3 nomax, 4 / 5 / 6 the exp-only, softmax-only
// and matmul-only probes (see the note at the top). grid_x, stages and smem
// are the launch geometry ops/attention.py::launch_geometry computes: query
// tiles, ring stages (unused by mode 2) and dynamic shared memory in bytes.
extern "C" int d2r_attention(const void* q, const void* k, const void* v, void* out, int B,
                             int H, int T, long sb, long sh, long st, long osb, long osh,
                             long ost, float scale, int causal, int mode, int grid_x, int stages,
                             int smem, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return 0;
  const Strides s{sb, sh, st, osb, osh, ost};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (mode == 2) {
    int exponent = 0;
    if (grid_x * kQT < T || smem != kExactSmem || frexpf(scale, &exponent) != 0.5f)
      return int(cudaErrorInvalidValue);  // the kernel scales scores, exact for powers of two
    static std::atomic<unsigned long long> configured{0};
    cudaError_t err = allow_smem(attn_exact, smem, &configured);
    if (err != cudaSuccess) return int(err);
    attn_exact<<<dim3(grid_x, H, B), kAThreads, smem, cs>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), T, s, scale, causal);
    return int(cudaGetLastError());
  }
  int exponent = 0;
  if (causal || grid_x * kBQ < T || stages != kStages || smem != kAttnSmem ||
      frexpf(scale, &exponent) != 0.5f)  // the kernel scales scores, exact for powers of two
    return int(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!make_head_map(&mq, q, B, H, T, s) || !make_head_map(&mk, k, B, H, T, s) ||
      !make_head_map(&mv, v, B, H, T, s))
    return int(cudaErrorInvalidValue);
  switch (mode) {
    case 0: return launch_attn<0>(mq, mk, mv, out, B, H, T, s, scale, grid_x, cs);
    case 1: return launch_attn<1>(mq, mk, mv, out, B, H, T, s, scale, grid_x, cs);
    case 3: return launch_attn<3>(mq, mk, mv, out, B, H, T, s, scale, grid_x, cs);
    case 4: return launch_attn<4>(mq, mk, mv, out, B, H, T, s, scale, grid_x, cs);
    case 5: return launch_attn<5>(mq, mk, mv, out, B, H, T, s, scale, grid_x, cs);
    case 6: return launch_attn<6>(mq, mk, mv, out, B, H, T, s, scale, grid_x, cs);
    default: return int(cudaErrorInvalidValue);
  }
}

// xn (M x K) = bf16(LN(x)) for x (M x K) bf16, g and beta (K,) f32.
// K % 8 == 0.
extern "C" int d2r_ln_rows(const void* x, const void* g, const void* beta, int M, int K,
                           float eps, void* xn, void* stream) {
  if (M <= 0) return 0;
  return launch_ln_rows(x, g, beta, M, K, eps, xn, static_cast<cudaStream_t>(stream));
}

// out (M x N) = epilogue `epi` (GemmEpi) of bf16(LN(x)) @ W + bias for x
// (M x K), as d2r_gemm takes them: the row pass writes the normalised rows
// to xn, (M x K) bf16 scratch the caller allocates, and the GEMM reads them
// like any A. K % 64 == 0 and N % 128 == 0.
extern "C" int d2r_ln_gemm(const void* x, const void* g, const void* beta, const void* w,
                           const void* bias, const void* resid, int M, int K, int N, float eps,
                           int epi, void* xn, void* out, void* stream) {
  if (M <= 0) return 0;
  if (K % kGK || N % 128) return int(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int err = launch_ln_rows(x, g, beta, M, K, eps, xn, cs);
  if (err != int(cudaSuccess)) return err;
  return launch_gemm_epi(xn, w, bias, resid, M, K, N, epi, out, cs);
}

// out (M x N) = epilogue `epi` (GemmEpi) of a @ W + bias for a (M x K) bf16,
// W (K x N) bf16, bias (N,) f32, and resid (M x N) bf16 for the residual
// epilogues (null otherwise). K % 64 == 0 and N % 128 == 0.
extern "C" int d2r_gemm(const void* a, const void* w, const void* bias, const void* resid, int M,
                        int K, int N, int epi, void* out, void* stream) {
  if (M <= 0) return 0;
  return launch_gemm_epi(a, w, bias, resid, M, K, N, epi, out, static_cast<cudaStream_t>(stream));
}
