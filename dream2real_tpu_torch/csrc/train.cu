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
// K6 and K7 (train_rows, dw_gemm, reduce_grads; Hopper): rows are (ray,
// sample) pairs. A tile of 128 rows holds whole rays (128 / S of them, or
// one ray's next 128 samples when S > 128, walked in steps by one block);
// its two warpgroups own 64 rows each, and every layer of every sample in
// the tile is one wgmma product per warpgroup (m64n128k16 or m64n64k16),
// with the activations in registers from one layer to the next: the f32
// accumulator, bias and relu, rounded to bf16, is the next product's A
// fragments. The weights stream through a ring of six 16 KB stages in
// shared memory, filled by cp.async.bulk from an image the wrapper builds
// (every K-tile of every layer in program order, zero-padded to 64-column
// chunks and 128-byte swizzled as wgmma reads them) behind full / empty
// mbarriers: thread 0 refills a stage once every warp has left it, so the
// loads of the next tiles run under the products. Only the per-ray
// composite is sequential: one thread a ray scans its rows after the
// products (forward: trans, weights, accumulators; backward: the prefix
// P_s, U = G_total - P_s and dsigma). K6's forward and K7's recompute are
// the same code on the same tiles, so K7 recomputes K6's outputs bit for
// bit, which the closed form U = G_total - P_s needs.
// K7 writes the bf16 activations and deltas of every row (the exact inputs
// of the weight gradients) to a scratch in 64-row x 64-column swizzled
// chunks, and the f32 column sums of each tile's deltas (the bias
// gradients) to a per-tile row. The rays are taken in chunks of one tile an
// SM; after each chunk's row pass, dw_gemm forms every dW = act^T delta of
// the chunk as wgmma products whose reduction runs over the rows (split
// over `parts` fixed row ranges, both operands MN-major from the scratch)
// and adds them to its part's f32 sum; reduce_grads sums the parts and the
// bias rows in a fixed order. No atomics: the gradients are the same from
// run to run, and the ray-gradient chain (a runtime flag) never touches
// them. Rays past the end and rows past a ray's samples have zero
// cotangents and zero deltas, so they add exactly zero to every gradient.
//
// K5 and K8 (density_rows; Hopper): the same rows and tiles as K6, on the
// same engine, with the density trunk alone: the first 32 jobs of K6's
// weight image (w0 .. w4), h4's sigma column, and one thread a ray scanning
// its rows for the coarse weights (K6's scan without colour, so K6's alpha
// is the in-order sum of K8's weights bit for bit). One block an SM strides
// over the tiles, so the ring runs on from tile to tile. K8 writes the
// weights; K5 keeps them in shared memory, where a thread a ray builds the
// ray's CDF and another its draws' Exp(1) prefix sums (each a sequential f32
// sum), and every thread of the block then takes draws, each finding its
// bin by a binary search over the ray's CDF.
// Weight layout: dream2real_tpu_torch/nerf/train_kernel.py (W_LAYOUT,
// B_LAYOUT, G_LAYOUT, WGMMA_JOBS, SCRATCH_CHUNKS).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "rows.cuh"

namespace {

constexpr float kPi = 3.14159265358979323846f;

// Packed f32 biases (B_LAYOUT).
constexpr int kB0 = 0, kB1 = 256, kB2 = 512, kB3 = 768, kB4 = 1024;
// f32 gradients (G_LAYOUT): the forward matrices, then the biases.
constexpr int kGW0 = 0, kGW1 = 16384, kGW2 = 81920, kGW3 = 147456, kGW4 = 229376,
              kGCW0 = 233472, kGCW1 = 235520, kGCW2 = 239616, kGB0 = 240640;
constexpr int kGSize = 241680;
constexpr int kBiasCols = kGSize - kGB0;  // b0 b1 b2 b3 (256 each), b4 (16)

__device__ __forceinline__ float pick3(const float* v, int c) {
  return c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Encoding angle idx of a row at position t: A + B t with A = a3 f_j, B = b3
// f_j (freq-major, like posenc).
__device__ __forceinline__ float angle(const float* a3, const float* b3, int idx, float t) {
  const int j = idx / 3, c = idx - 3 * j;
  const float freq = ldexpf(kPi, j);
  return fmaf(__fmul_rn(pick3(b3, c), freq), t, __fmul_rn(pick3(a3, c), freq));
}

// ================================================== K6, K7 (wgmma, bulk ring)

constexpr int kChunkBytes = 8192;    // 64 rows x 64 bf16 columns, 128-byte swizzled
constexpr int kBlockChunks = 40;     // scratch chunks of one warpgroup's 64 rows
// Scratch chunks of a 64-row block (SCRATCH_CHUNKS in train_kernel.py):
// activations, then deltas. cin = [h4 16 | SH 16 | pad]; dc2 and dh4 are 16
// wide, their chunks' other columns never reach a kept gradient.
constexpr int kCEnc = 0, kCH0 = 1, kCH1 = 5, kCH2 = 9, kCH3 = 13, kCCin = 17, kCC0 = 18,
              kCC1 = 19, kCDc2 = 20, kCDc1 = 21, kCDc0 = 22, kCDh4 = 23, kCDh3 = 24, kCDh2 = 28,
              kCDh1 = 32, kCDh0 = 36;
// Offsets of the bias gradients in a bias row (G_LAYOUT's b0 .. b4).
constexpr int kBb0 = 0, kBb1 = 256, kBb2 = 512, kBb3 = 768, kBb4 = 1024;

// The weight jobs (WGMMA_JOBS in train_kernel.py), in the order the products
// take them: each a K-tile of one layer, kr rows x 128 or 64 columns.
//   0-1 w0 (2 halves of 128 columns)  2-9 w1  10-17 w2  18-27 w3 (5 K-tiles
//   a half)  28-31 w4 (4 K-tiles, 64 wide)  32 cw0  33 cw1  34 cw2 | 35 cw2t
//   36 cw1t  37 cw0t  38-39 w4t  40-43 w3t's encoding columns (ray
//   gradients only)  44-51 w3t's h2 columns  52-59 w2t  60-67 w1t  68-71 w0t
//   (ray gradients only).
constexpr int kNumJobs = 72, kFwdJobs = 35;

__host__ __device__ constexpr int job_bytes(int j) {
  return j < 28 ? 16384 : j < 32 ? 8192 : j == 32 ? 4096 : j < 35 ? 8192 : j == 35 ? 2048
         : j < 38 ? 8192 : j < 40 ? 4096 : j < 44 ? 8192 : j < 68 ? 16384 : 8192;
}
__host__ __device__ constexpr bool job_ray(int j) { return (j >= 40 && j < 44) || j >= 68; }
__host__ __device__ constexpr int image_bytes(int n) { return n == 0 ? 0 : image_bytes(n - 1) + job_bytes(n - 1); }
static_assert(image_bytes(kNumJobs) == 997376, "WGMMA_JOBS");

// A ray of a tile, in shared memory. Slot rpt is the dummy that rows past
// the tile's rays read.
struct RaySlot {
  float o[3], d[3], a3[3], b3[3], scale[3], dn;
  float sh[16];                        // SH basis of the unit direction (f32)
  float dc[3], da, dd, g_total;        // K7: cotangents and G_total
  long g;
  int valid;
};

// Shared memory of train_rows (bytes): the ring, its barriers, the job
// tables, the ray slots, the per-row composite values, the per-warp bias
// sums, the ray-gradient stash and (K7) each warpgroup's staging buffer of
// scratch chunks.
constexpr int kSmRing = 0;
constexpr int kSmBars = kSmRing + kRingStages * kStageBytes;
constexpr int kSmJobs = kSmBars + 128;
constexpr int kSmSlots = kSmJobs + 2 * kNumJobs * 4;
constexpr int kSmRows = kSmSlots + (kTileRows + 1) * int(sizeof(RaySlot));
constexpr int kRowVals = 11;         // sigma, rgb 3, w, dx_sigma, dpos 3, t (2 steps)
constexpr int kSmBsum = kSmRows + kTileRows * kRowVals * 4;
constexpr int kSmStash = kSmBsum + 8 * kBiasCols * 4;
constexpr int kSmStage = (kSmStash + 32 * kRowThreads * 4 + 1023) / 1024 * 1024;
constexpr int kStageChunks = 2;  // a warpgroup's staging buffer: two scratch chunks
constexpr int kRowSmem = kSmStage + 2 * kStageChunks * kChunkBytes;
static_assert(kRowSmem <= 232448, "train_rows shared memory");

// Shared -> global bulk copy, in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until this thread's bulk copies have read their shared memory
// (kRead) or completed.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if (kRead) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Bits 64 H + i of m: element i of half H of a 256-wide activation is > 0.
template <int H>
__device__ __forceinline__ void mask_bits(const uint32_t (&f)[64], uint32_t (&m)[4]) {
  m[2 * H] = m[2 * H + 1] = 0u;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t bits = uint32_t(bf16_lo(f[32 * H + j]) > 0.0f) |
                          (uint32_t(bf16_hi(f[32 * H + j]) > 0.0f) << 1);
    m[2 * H + (j >> 4)] |= bits << ((2 * j) & 31);
  }
}

// Column sums of this warp's 16 rows for accumulator columns 8 j + 2q + e,
// j < NJ, into dst[8 j + 2q + e]: the thread's two rows, then the eight row
// groups of the warp, in a fixed order.
template <int NJ, int N>
__device__ __forceinline__ void colsum(const float (&acc)[N], float* dst, const Lane& l) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = acc[4 * j + e] + acc[4 * j + 2 + e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (l.rr == 0) dst[8 * j + 2 * l.q + e] = v;
    }
}

// Half H of a 256-wide delta: acc masked by the activation's bits, its f32
// column sums into the warp's bias row `bsum` (at the layer's offset), its
// bf16 rounding into out[32 H ..].
template <int H>
__device__ __forceinline__ void delta_half(float (&acc)[64], const uint32_t (&m)[4], float* bsum,
                                           uint32_t (&out)[64], const Lane& l) {
#pragma unroll
  for (int i = 0; i < 64; ++i)
    if (!((m[(64 * H + i) >> 5] >> ((64 * H + i) & 31)) & 1u)) acc[i] = 0.0f;
  colsum<16>(acc, bsum + 128 * H, l);
#pragma unroll
  for (int j = 0; j < 32; ++j) out[32 * H + j] = pack_bf16(acc[2 * j], acc[2 * j + 1]);
}

// The same for a 64-wide delta masked by the activation's own fragments f
// (no bias).
__device__ __forceinline__ void delta_64(float (&acc)[32], const uint32_t (&f)[16],
                                         uint32_t (&out)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
    out[j] = pack_bf16(bf16_lo(f[j]) > 0.0f ? acc[2 * j] : 0.0f,
                       bf16_hi(f[j]) > 0.0f ? acc[2 * j + 1] : 0.0f);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Fragment registers f[R0 .. R0 + NREG) as k-slices S0, S0 + 1, ... (S0 % 4
// == 0) of the matrix whose first scratch chunk is `chunk` in this
// warpgroup's 64-row block `blk` (four 16-column slices a 64-column chunk),
// two chunks at a time: written into the staging buffer as the chunks hold
// them (4 bytes a register, no bank conflicts through the swizzle), then
// one bulk copy to the scratch by the warpgroup's first thread. The buffer
// is reused once that thread's previous copy has read it.
template <int NREG, int R0, int S0, int NA>
__device__ __forceinline__ void put(uint32_t stg, unsigned char* blk, int chunk,
                                    const uint32_t (&f)[NA], const Lane& l) {
  constexpr int kRound = NREG < 32 ? NREG : 32;
  constexpr int kChunks = kRound < 16 ? 1 : kRound / 16;
  const bool leader = (l.tid & 127) == 0;
  // Row rloc's word of column pair 2q; the swizzle XORs the 16-byte unit
  // with the row's low bits (rr, rows rloc and rloc + 8 alike).
  const uint32_t row0 = stg + l.rloc * 128 + 4 * l.q, rr16 = uint32_t(l.rr) << 4;
#pragma unroll
  for (int r0 = 0; r0 < NREG; r0 += kRound) {
    const int s0 = S0 + r0 / 4;
    if (leader) bulk_wait<true>();
    named_barrier(1 + l.wg, 128);
#pragma unroll
    for (int j = 0; j < kRound; ++j) {
      const int s = s0 + (j >> 2), e = j & 3;
      const uint32_t unit = 2 * (s & 3) + (e >> 1);
      st_shared(row0 + ((s >> 2) - (s0 >> 2)) * kChunkBytes + 1024 * (e & 1) + ((unit << 4) ^ rr16),
                f[R0 + r0 + j]);
    }
    fence_async_proxy();
    named_barrier(1 + l.wg, 128);
    if (leader)
      bulk_store(blk + size_t(chunk + (s0 >> 2)) * kChunkBytes, stg, kChunks * kChunkBytes);
  }
}

// Encoding column c of a row at position t: [p2 3 | sin 30 | cos 30 | 0].
__device__ __forceinline__ float enc_value(const RaySlot& s, float t, int c) {
  if (c < 3) return fmaf(pick3(s.b3, c), t, pick3(s.a3, c));
  if (c < 33) return sinf(angle(s.a3, s.b3, c - 3, t));
  if (c < 63) return cosf(angle(s.a3, s.b3, c - 33, t));
  return 0.0f;
}

struct RowArgs {
  const float *origins, *dirs, *ts, *box, *B;
  const unsigned char* img;
  int n_rays, S, rpt, spt, steps, group0;
  float min_trans;
  float *out_rgb, *out_alpha, *out_depth;                   // K6
  const float *dC, *dA, *dD, *C, *A, *D;                    // K7
  int ray_grads, first_chunk;
  unsigned char* scratch;
  float *bias_rows, *d_origins, *d_dirs;
};

// K6 (kBwd false) and K7's row pass (kBwd true) over one group of rays: rpt
// rays of S samples in `steps` tiles of spt samples a ray (rpt * spt <= 128;
// row r of a tile is sample r % spt of ray r / spt).
template <bool kBwd>
__global__ void __launch_bounds__(kRowThreads, 1) train_rows(const RowArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023u) __trap();
  const Lane l = lane_of();
  int* job_off = reinterpret_cast<int*>(smem_raw + kSmJobs);
  int* job_len = job_off + kNumJobs;
  RaySlot* slots = reinterpret_cast<RaySlot*>(smem_raw + kSmSlots);
  float* rv = reinterpret_cast<float*>(smem_raw + kSmRows);  // [value][row]
  float* sig = rv;
  float* rgb = rv + kTileRows;       // 3 x 128
  float* wrow = rv + 4 * kTileRows;
  float* dxs = rv + 5 * kTileRows;
  float* dpos = rv + 6 * kTileRows;  // 3 x 128
  // The rows' sample positions, by step parity: the scan of one step may
  // still read them while a warp that is done with it writes the next's.
  float* trows = rv + 9 * kTileRows;  // 2 x 128
  float* bsum = reinterpret_cast<float*>(smem_raw + kSmBsum) + l.warp * kBiasCols;
  float* stash = reinterpret_cast<float*>(smem_raw + kSmStash);
  const uint32_t stg = base + kSmStage + l.wg * kStageChunks * kChunkBytes;  // staging
  const int rpt = a.rpt, spt = a.spt, S = a.S;
  const long group = long(a.group0) + blockIdx.x;

  Ring ring;
  ring.base = base + kSmRing;
  ring.bars = base + kSmBars;
  ring.off = job_off;
  ring.bytes = job_len;
  ring.img = a.img;
  ring.n = ring.rel = 0;
  if (l.tid == 0) {
    // The program's jobs: the forward's, then (K7) the backward's, without
    // the ray-gradient chain's unless it runs.
    int n = 0, off = 0;
    for (int j = 0; j < (kBwd ? kNumJobs : kFwdJobs); ++j) {
      if (!(job_ray(j) && !a.ray_grads)) {
        job_off[n] = off;
        job_len[n] = job_bytes(j);
        ++n;
      }
      off += job_bytes(j);
    }
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(ring.bars + 8 * s, 1);                  // full: the expect_tx arrival
      mbar_init(ring.bars + 8 * (kRingStages + s), 8);  // empty: one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_proxy();
  }
  // The ray slots: rays past the end (and slot rpt) march at t = 0 along +z
  // with zero cotangents.
  for (int r = l.tid; r <= rpt; r += kRowThreads) {
    RaySlot& s = slots[r];
    const long g = group * rpt + r;
    const bool ok = r < rpt && g < a.n_rays;
    s.g = ok ? g : 0;
    s.valid = ok;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s.o[c] = ok ? a.origins[g * 3 + c] : 0.0f;
      s.d[c] = ok ? a.dirs[g * 3 + c] : (c == 2 ? 1.0f : 0.0f);
      const float lo = a.box[c], hi = a.box[3 + c];
      s.scale[c] = 2.0f / (hi - lo);
      s.a3[c] = fmaf(s.o[c], s.scale[c], -2.0f * lo / (hi - lo) - 1.0f);
      s.b3[c] = __fmul_rn(s.d[c], s.scale[c]);
    }
    s.dn = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(s.d[0], s.d[0]), __fmul_rn(s.d[1], s.d[1])),
                           __fmul_rn(s.d[2], s.d[2])));
    // model.sh_encode_deg4 of the unit direction.
    const float x = s.d[0] / s.dn, y = s.d[1] / s.dn, z = s.d[2] / s.dn;
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
    s.sh[0] = 0.28209479177387814f;
    s.sh[1] = -0.48860251190291987f * y;
    s.sh[2] = 0.48860251190291987f * z;
    s.sh[3] = -0.48860251190291987f * x;
    s.sh[4] = 1.0925484305920792f * xy;
    s.sh[5] = -1.0925484305920792f * yz;
    s.sh[6] = 0.94617469575755997f * zz - 0.31539156525251999f;
    s.sh[7] = -1.0925484305920792f * xz;
    s.sh[8] = 0.54627421529603959f * (xx - yy);
    s.sh[9] = 0.59004358992664352f * y * (-3.0f * xx + yy);
    s.sh[10] = 2.8906114426405538f * xy * z;
    s.sh[11] = 0.45704579946446572f * y * (1.0f - 5.0f * zz);
    s.sh[12] = 0.3731763325901154f * z * (5.0f * zz - 3.0f);
    s.sh[13] = 0.45704579946446572f * x * (1.0f - 5.0f * zz);
    s.sh[14] = 1.4453057213202769f * z * (xx - yy);
    s.sh[15] = 0.59004358992664352f * x * (-xx + 3.0f * yy);
    float dc[3] = {0.0f, 0.0f, 0.0f}, da = 0.0f, dd = 0.0f, g_total = 0.0f;
    if (kBwd && ok) {
#pragma unroll
      for (int c = 0; c < 3; ++c) dc[c] = a.dC[g * 3 + c];
      da = a.dA[g];
      dd = a.dD[g];
      const float* Cr = a.C + g * 3;
      g_total = ((dc[0] * Cr[0] + dc[1] * Cr[1]) + dc[2] * Cr[2]) + da * a.A[g] + dd * a.D[g];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) s.dc[c] = dc[c];
    s.da = da;
    s.dd = dd;
    s.g_total = g_total;
  }
  __syncthreads();
  ring.per_step = 0;
  for (int j = 0; j < (kBwd ? kNumJobs : kFwdJobs); ++j)
    ring.per_step += (job_ray(j) && !a.ray_grads) ? 0 : 1;
  ring.total = a.steps * ring.per_step;
  if (l.tid == 0)
    for (int j = 0; j < kRingStages && j < ring.total; ++j) ring_request(ring, j);

  // The scanning thread of ray tid (tid < rpt): its composite state.
  float trans = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f, acc_d = 0.0f;
  float P = 0.0f, g_o[3] = {0.0f, 0.0f, 0.0f}, g_d[3] = {0.0f, 0.0f, 0.0f};

  for (int step = 0; step < a.steps; ++step) {
    // This thread's two rows.
    const RaySlot* rs[2];
    float t[2];
    bool valid[2];
    int row[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      row[e] = l.wg * 64 + l.rloc + 8 * e;
      const int lr = row[e] / spt, s = step * spt + row[e] - lr * spt;
      const int sl = lr < rpt ? lr : rpt;
      rs[e] = &slots[sl];
      valid[e] = rs[e]->valid && s < S;
      t[e] = valid[e] ? a.ts[rs[e]->g * S + s] : 0.0f;
    }
    float* trow = trows + (step & 1) * kTileRows;
    if (l.q == 0) {
      trow[row[0]] = t[0];
      trow[row[1]] = t[1];
    }
    unsigned char* blk = nullptr;
    if (kBwd)
      blk = a.scratch + (size_t(blockIdx.x * a.steps + step) * 2 + l.wg) * kBlockChunks * kChunkBytes;

    // ------------------------------------------------------------ forward
    uint32_t enc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int e = j & 1, c = 16 * (j >> 2) + 8 * ((j >> 1) & 1) + 2 * l.q;
      enc[j] = pack_bf16(enc_value(*rs[e], t[e], c), enc_value(*rs[e], t[e], c + 1));
    }
    if (kBwd) put<16, 0, 0>(stg, blk, kCEnc, enc, l);
    uint32_t m0[4], m1[4], m2[4], m3[4];  // K7: the masks of h0 .. h3
    uint32_t hA[64], hB[64];
    float acc[64];
    // h0 = relu(enc @ w0 + b0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      zero(acc);
      job128<4, 0>(ring, acc, enc);
      if (h == 0) bias_relu<0>(acc, a.B + kB0, hA, l);
      else bias_relu<1>(acc, a.B + kB0, hA, l);
    }
    if (kBwd) {
      put<64, 0, 0>(stg, blk, kCH0, hA, l);
      mask_bits<0>(hA, m0);
      mask_bits<1>(hA, m0);
    }
    // h1 = relu(h0 @ w1 + b1), h2 = relu(h1 @ w2 + b2)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      zero(acc);
      k256_128<false>(ring, acc, enc, hA);
      if (h == 0) bias_relu<0>(acc, a.B + kB1, hB, l);
      else bias_relu<1>(acc, a.B + kB1, hB, l);
    }
    if (kBwd) {
      put<64, 0, 0>(stg, blk, kCH1, hB, l);
      mask_bits<0>(hB, m1);
      mask_bits<1>(hB, m1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      zero(acc);
      k256_128<false>(ring, acc, enc, hB);
      if (h == 0) bias_relu<0>(acc, a.B + kB2, hA, l);
      else bias_relu<1>(acc, a.B + kB2, hA, l);
    }
    if (kBwd) {
      put<64, 0, 0>(stg, blk, kCH2, hA, l);
      mask_bits<0>(hA, m2);
      mask_bits<1>(hA, m2);
    }
    // h3 = relu([enc | h2] @ w3 + b3)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      zero(acc);
      k256_128<true>(ring, acc, enc, hA);
      if (h == 0) bias_relu<0>(acc, a.B + kB3, hB, l);
      else bias_relu<1>(acc, a.B + kB3, hB, l);
    }
    if (kBwd) {
      put<64, 0, 0>(stg, blk, kCH3, hB, l);
      mask_bits<0>(hB, m3);
      mask_bits<1>(hB, m3);
    }
    // h4 = bf16(h3 @ w4 + b4) (16 of the job's 64 columns); cin = [h4 | SH]
    float a32[32];
    zero(a32);
    k256_64(ring, a32, hB);
    uint32_t cin[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(a.B + kB4 + 8 * (j >> 1) + 2 * l.q);
      cin[j] = pack_bf16(a32[2 * j] + b.x, a32[2 * j + 1] + b.y);
      const int e = j & 1, c = 8 * (j >> 1) + 2 * l.q;
      cin[4 + j] = pack_bf16(rs[e]->sh[c], rs[e]->sh[c + 1]);
    }
    if (kBwd) put<8, 0, 0>(stg, blk, kCCin, cin, l);
    if (l.q == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const RaySlot& s = *rs[e];
        bool inside = true;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float pc = fmaf(s.d[c], t[e], s.o[c]);
          inside = inside && pc >= a.box[c] && pc <= a.box[3 + c];
        }
        const float sigma = expf(fminf(fmaxf(bf16_lo(cin[e]), -15.0f), 15.0f));
        sig[row[e]] = inside ? sigma : 0.0f;
        if (kBwd) wrow[row[e]] = dxs[row[e]] = 0.0f;
      }
    }
    // c0 = relu(cin @ cw0), c1 = relu(c0 @ cw1), rgb = sigmoid(c1 @ cw2)
    uint32_t c0[16], c1[16];
    zero(a32);
    job64<2, 0>(ring, a32, cin);
#pragma unroll
    for (int j = 0; j < 16; ++j) c0[j] = pack_bf16(fmaxf(a32[2 * j], 0.0f), fmaxf(a32[2 * j + 1], 0.0f));
    zero(a32);
    job64<4, 0>(ring, a32, c0);
#pragma unroll
    for (int j = 0; j < 16; ++j) c1[j] = pack_bf16(fmaxf(a32[2 * j], 0.0f), fmaxf(a32[2 * j + 1], 0.0f));
    zero(a32);
    job64<4, 0>(ring, a32, c1);
    if (kBwd) {
      put<16, 0, 0>(stg, blk, kCC0, c0, l);
      put<16, 0, 0>(stg, blk, kCC1, c1, l);
    }
    if (l.q < 2) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        rgb[2 * l.q * kTileRows + row[e]] = sigmoid(a32[2 * e]);
        if (l.q == 0) rgb[kTileRows + row[e]] = sigmoid(a32[2 * e + 1]);
      }
    }
    __syncthreads();

    // ---------------------------------------------- the composite, a ray a thread
    if (l.tid < rpt) {
      const RaySlot& s = slots[l.tid];
      const int n_s = min(spt, S - step * spt);
      for (int i = 0; i < n_s; ++i) {
        const int r = l.tid * spt + i, si = step * spt + i;
        const float ti = trow[r];
        // The next sample's position: the next row's, or the next step's
        // first (a long ray's last row of this step).
        const float tn = i + 1 < n_s ? trow[r + 1] : (s.valid && si + 1 < S ? a.ts[s.g * S + si + 1] : 0.0f);
        const float dl = si == S - 1 ? 1e2f : tn - ti;
        const float sigma = sig[r];
        const float al = 1.0f - expf(-sigma * dl * s.dn);
        const float cr = rgb[r], cg = rgb[kTileRows + r], cb = rgb[2 * kTileRows + r];
        if (!kBwd) {
          const float w = (trans < a.min_trans) ? 0.0f : al * trans;
          acc_r += w * cr;
          acc_g += w * cg;
          acc_b += w * cb;
          acc_a += w;
          acc_d += w * ti;
        } else {
          // dL/dsigma_s = dl dn [m T g (1 - a) - U (1 - a) / max(1 - a, 1e-10)],
          // U = G_total - P_s; trunc_exp's gradient is y dx.
          const float m = trans >= a.min_trans ? 1.0f : 0.0f;
          const float w = m * al * trans;
          const float g = ((s.dc[0] * cr + s.dc[1] * cg) + s.dc[2] * cb) + s.da + s.dd * ti;
          P = P + w * g;
          const float U = s.g_total - P;
          const float one_m_a = 1.0f - al;
          const float ratio = one_m_a / fmaxf(one_m_a, 1e-10f);
          const float dsigma = dl * s.dn * (m * trans * g * one_m_a - U * ratio);
          wrow[r] = s.valid ? w : 0.0f;
          dxs[r] = s.valid ? dsigma * sigma : 0.0f;
        }
        // Written exactly as the reference: (1 - a) + 1e-10, never reassociated.
        trans = trans * (1.0f - al + 1e-10f);
      }
    }
    if (!kBwd) continue;
    __syncthreads();

    // ----------------------------------------------------------- backward
    // dc2 = bf16(w dC rgb (1 - rgb)) in the 3 of its 16 columns that exist.
    uint32_t d16[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = j & 1, c = 8 * (j >> 1) + 2 * l.q;
      float v[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ck = c + k;
        v[k] = 0.0f;
        if (ck < 3) {
          const float cv = rgb[ck * kTileRows + row[e]];
          v[k] = wrow[row[e]] * rs[e]->dc[ck] * cv * (1.0f - cv);
        }
      }
      d16[j] = pack_bf16(v[0], v[1]);
    }
    put<4, 0, 0>(stg, blk, kCDc2, d16, l);
    uint32_t dc1[16], dc0[16];
    zero(a32);
    job64<1, 0>(ring, a32, d16);
    delta_64(a32, c1, dc1);
    put<16, 0, 0>(stg, blk, kCDc1, dc1, l);
    zero(a32);
    job64<4, 0>(ring, a32, dc1);
    delta_64(a32, c0, dc0);
    put<16, 0, 0>(stg, blk, kCDc0, dc0, l);
    // dh4 = [dx_sigma | dcin 1..15]: its f32 column sums are db4, its bf16
    // rounding feeds the trunk.
    zero(a32);
    job64<4, 0>(ring, a32, dc0);
    if (l.q == 0) {
      a32[0] = dxs[row[0]];
      a32[2] = dxs[row[1]];
    }
    colsum<2>(a32, bsum + kBb4, l);
#pragma unroll
    for (int j = 0; j < 4; ++j) d16[j] = pack_bf16(a32[2 * j], a32[2 * j + 1]);
    put<4, 0, 0>(stg, blk, kCDh4, d16, l);
    // dh3 = mask(h3) (dh4 @ w4t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      zero(acc);
      job128<1, 0>(ring, acc, d16);
      if (h == 0) delta_half<0>(acc, m3, bsum + kBb3, hA, l);
      else delta_half<1>(acc, m3, bsum + kBb3, hA, l);
    }
    put<64, 0, 0>(stg, blk, kCDh3, hA, l);
    if (a.ray_grads) {  // dL/denc, first part: dh3 @ w3t's encoding columns
      zero(a32);
      k256_64(ring, a32, hA);
#pragma unroll
      for (int i = 0; i < 32; ++i) stash[i * kRowThreads + l.tid] = a32[i];
    }
    // dh2 = mask(h2) (dh3 @ w3t's h2 columns), dh1, dh0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      zero(acc);
      k256_128<false>(ring, acc, enc, hA);
      if (h == 0) delta_half<0>(acc, m2, bsum + kBb2, hB, l);
      else delta_half<1>(acc, m2, bsum + kBb2, hB, l);
    }
    put<64, 0, 0>(stg, blk, kCDh2, hB, l);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      zero(acc);
      k256_128<false>(ring, acc, enc, hB);
      if (h == 0) delta_half<0>(acc, m1, bsum + kBb1, hA, l);
      else delta_half<1>(acc, m1, bsum + kBb1, hA, l);
    }
    put<64, 0, 0>(stg, blk, kCDh1, hA, l);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      zero(acc);
      k256_128<false>(ring, acc, enc, hA);
      if (h == 0) delta_half<0>(acc, m0, bsum + kBb0, hB, l);
      else delta_half<1>(acc, m0, bsum + kBb0, hB, l);
    }
    put<64, 0, 0>(stg, blk, kCDh0, hB, l);

    if (a.ray_grads) {
      // dL/denc += dh0 @ w0t, then through the encoding (its bf16 cast taken
      // as the identity) to the position: dp2 = denc[p2] + sum_j f_j
      // (denc[sin] cos - denc[cos] sin), dpos = dp2 scale.
#pragma unroll
      for (int i = 0; i < 32; ++i) a32[i] = stash[i * kRowThreads + l.tid];
      k256_64(ring, a32, hB);
      float dp[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int e = (i >> 1) & 1, c = 8 * (i >> 2) + 2 * l.q + (i & 1);
        float v = 0.0f;
        int ax = 0;
        if (c < 3) {
          v = a32[i];
          ax = c;
        } else if (c < 63) {
          const int idx = c < 33 ? c - 3 : c - 33;
          const float ang = angle(rs[e]->a3, rs[e]->b3, idx, t[e]);
          const float freq = ldexpf(kPi, idx / 3);
          v = c < 33 ? freq * (a32[i] * cosf(ang)) : freq * -(a32[i] * sinf(ang));
          ax = idx - 3 * (idx / 3);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) dp[e][k] += ax == k ? v : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float v = dp[e][k];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (l.q == 0) dpos[k * kTileRows + row[e]] = valid[e] ? v * rs[e]->scale[k] : 0.0f;
        }
    }
    __syncthreads();
    // The tile's bias sums: the 8 warps' rows in order, added to this tile's
    // row of the chunk sums.
    float* brow = a.bias_rows + size_t(blockIdx.x * a.steps + step) * kBiasCols;
    const float* bs0 = reinterpret_cast<const float*>(smem_raw + kSmBsum);
    for (int c = l.tid; c < kBiasCols; c += kRowThreads) {
      float v = bs0[c];
#pragma unroll
      for (int w = 1; w < 8; ++w) v += bs0[w * kBiasCols + c];
      brow[c] = a.first_chunk ? v : brow[c] + v;
    }
    if (a.ray_grads && l.tid < rpt) {
      const int n_s = min(spt, S - step * spt);
      for (int i = 0; i < n_s; ++i) {
        const int r = l.tid * spt + i;
        const float ti = trow[r];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = dpos[c * kTileRows + r];
          g_o[c] = g_o[c] + v;
          g_d[c] = g_d[c] + v * ti;
        }
      }
    }
  }

  if (kBwd && (l.tid & 127) == 0) bulk_wait<false>();  // the scratch is written
  if (l.tid < rpt && slots[l.tid].valid) {
    const long g = slots[l.tid].g;
    if (!kBwd) {
      a.out_rgb[g * 3 + 0] = acc_r;
      a.out_rgb[g * 3 + 1] = acc_g;
      a.out_rgb[g * 3 + 2] = acc_b;
      a.out_alpha[g] = acc_a;
      a.out_depth[g] = acc_d;
    } else if (a.ray_grads) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a.d_origins[g * 3 + c] = g_o[c];
        a.d_dirs[g * 3 + c] = g_d[c];
      }
    }
  }
}

// ---------------------------------------------- K7's weight gradients

// d (64 x 128 f32) += A (64 x 16) * B (16 x 128), both from shared memory
// and MN-major (A^T and B stored with M and N contiguous).
__device__ __forceinline__ void wgmma_64x128x16_ss_tt(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : D2R_F16(d, 0), D2R_F16(d, 16), D2R_F16(d, 32), D2R_F16(d, 48)
      : "l"(da), "l"(db));
}
// One output tile of the weight gradients: dW[rows, :] = act^T delta over a
// chunk's rows, act = scratch chunks a0 (and a1: 128 rows), delta = nb
// chunks from b0 (64 nb columns). The result goes to G_LAYOUT offset g_off
// (row stride ldn), m_real rows and n_real columns of it kept. The 256-wide
// tiles come first, so that they start first.
struct DwTile {
  int a0, a1, b0, nb, g_off, ldn, m_real, n_real;
};
constexpr int kDwTiles = 13;
__constant__ DwTile kDwTile[kDwTiles] = {
    {kCEnc, -1, kCDh0, 4, kGW0, 256, 64, 256},
    {kCH0, kCH0 + 1, kCDh1, 4, kGW1, 256, 128, 256},
    {kCH0 + 2, kCH0 + 3, kCDh1, 4, kGW1 + 128 * 256, 256, 128, 256},
    {kCH1, kCH1 + 1, kCDh2, 4, kGW2, 256, 128, 256},
    {kCH1 + 2, kCH1 + 3, kCDh2, 4, kGW2 + 128 * 256, 256, 128, 256},
    {kCEnc, kCH2, kCDh3, 4, kGW3, 256, 128, 256},  // w3's rows are [enc 64 | h2 256]
    {kCH2 + 1, kCH2 + 2, kCDh3, 4, kGW3 + 128 * 256, 256, 128, 256},
    {kCH2 + 3, -1, kCDh3, 4, kGW3 + 256 * 256, 256, 64, 256},
    {kCH3, kCH3 + 1, kCDh4, 1, kGW4, 16, 128, 16},
    {kCH3 + 2, kCH3 + 3, kCDh4, 1, kGW4 + 128 * 16, 16, 128, 16},
    {kCCin, -1, kCDc0, 1, kGCW0, 64, 32, 64},
    {kCC0, -1, kCDc1, 1, kGCW1, 64, 64, 64},
    {kCC1, -1, kCDc2, 1, kGCW2, 16, 64, 16},
};
constexpr int kDwStages = 4;
constexpr int kDwStage = 6 * kChunkBytes;  // two A chunks, four B chunks
constexpr int kDwSmem = kDwStages * kDwStage + 16 * kDwStages;

// Accumulator columns col0.. of a weight-gradient tile into its G_LAYOUT
// rows (written by the first chunk, added by the others).
template <int N>
__device__ __forceinline__ void dw_store(const float (&acc)[N], float* out, const DwTile& tile,
                                         int col0, int first, const Lane& l) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const int m = l.wg * 64 + l.rloc + 8 * ((i >> 1) & 1);
    const int c = col0 + 8 * (i >> 2) + 2 * l.q;
    if (m < tile.m_real && c < tile.n_real) {
      float2* dst = reinterpret_cast<float2*>(out + size_t(m) * tile.ldn + c);
      float2 v = make_float2(acc[i], acc[i + 1]);
      if (!first) {
        const float2 old = *dst;
        v.x = old.x + v.x;
        v.y = old.y + v.y;
      }
      *dst = v;
    }
  }
}

// Block (part x, tile y): the tile over the part's 64-row blocks
// [x nrb / parts, (x + 1) nrb / parts) of the chunk, written (first chunk)
// or added to part x's f32 sums. Two warpgroups, one per 64 rows of the
// tile; A and B stages of one 64-row block in a ring of 4, thread 0 refills
// a stage once every warp has left it, one wgmma group in flight.
__global__ void __launch_bounds__(256, 1)
    dw_gemm(const unsigned char* __restrict__ scratch, int nrb, int parts,
            float* __restrict__ part, int first) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023u) __trap();
  const uint32_t bars = base + kDwStages * kDwStage;  // full[4], empty[4]
  const DwTile tile = kDwTile[blockIdx.y];
  const int p = blockIdx.x;
  const int rb0 = int(long(p) * nrb / parts), n = int(long(p + 1) * nrb / parts) - rb0;
  const int na = tile.a1 < 0 ? 1 : 2;
  const Lane l = lane_of();

  if (l.tid == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kDwStages + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_proxy();
  }
  __syncthreads();
  auto chunk = [&](int k, int c) {
    return scratch + (size_t(rb0 + k) * kBlockChunks + c) * kChunkBytes;
  };
  auto request = [&](int k) {
    const int s = k % kDwStages;
    const uint32_t full = bars + 8 * s, st = base + s * kDwStage;
    mbar_expect_tx(full, (na + tile.nb) * kChunkBytes);
    bulk_load(st, chunk(k, tile.a0), kChunkBytes, full);
    if (na == 2) bulk_load(st + kChunkBytes, chunk(k, tile.a1), kChunkBytes, full);
    bulk_load(st + 2 * kChunkBytes, chunk(k, tile.b0), tile.nb * kChunkBytes, full);
  };
  if (l.tid == 0)
    for (int k = 0; k < kDwStages && k < n; ++k) request(k);

  // Every warpgroup runs the full 64 x 256 product on every stage, with no
  // branch around a wgmma (ptxas would serialise them): a warpgroup past the
  // tile's rows, and the columns past its delta's, multiply whatever the
  // stage holds there and are never stored.
  float acc0[64], acc1[64];
  zero(acc0);
  zero(acc1);
  for (int k = 0; k < n; ++k) {
    const int s = k % kDwStages;
    mbar_wait(bars + 8 * s, (k / kDwStages) & 1);
    const uint32_t st = base + s * kDwStage;
    const uint64_t dA = sw128_desc(st + l.wg * kChunkBytes, kChunkBytes, 1024);
    const uint64_t dB = sw128_desc(st + 2 * kChunkBytes, kChunkBytes, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_64x128x16_ss_tt(acc0, dA + 128 * kk, dB + 128 * kk);
      wgmma_64x128x16_ss_tt(acc1, dA + 128 * kk, dB + 128 * kk + ((2 * kChunkBytes) >> 4));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group before has finished with its stage
    if (k > 0) {
      const int prev = k - 1;
      __syncwarp();
      if ((l.tid & 31) == 0) mbar_arrive(bars + 8 * (kDwStages + prev % kDwStages));
      if (l.tid == 0 && prev + kDwStages < n) {
        mbar_wait(bars + 8 * (kDwStages + prev % kDwStages), (prev / kDwStages) & 1);
        request(prev + kDwStages);
      }
      __syncwarp();
    }
  }
  wgmma_wait<0>();
  if (l.wg >= na) return;
  float* out = part + size_t(p) * kGSize + tile.g_off;
  dw_store(acc0, out, tile, 0, first, l);
  if (tile.nb == 4) dw_store(acc1, out, tile, 128, first, l);
}

// grads = the parts' weight sums in part order, and the bias rows' sums in
// row order.
__global__ void reduce_grads(const float* __restrict__ part, int parts,
                             const float* __restrict__ bias_rows, int n_bias_rows,
                             float* __restrict__ grads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kGSize) return;
  float s = 0.0f;
  if (i < kGB0) {
    s = part[i];
    for (int p = 1; p < parts; ++p) s += part[size_t(p) * kGSize + i];
  } else {
    for (int r = 0; r < n_bias_rows; ++r) s += bias_rows[size_t(r) * kBiasCols + i - kGB0];
  }
  grads[i] = s;
}

// ============================================== K5, K8 (density_rows, Hopper)

constexpr int kTrunkJobs = 32;  // WGMMA_JOBS 0-31: w0 .. w4, the density trunk
static_assert(image_bytes(kTrunkJobs) == 491520, "the trunk's jobs");
constexpr int kUFloats = 8192;  // K5's window: Exp(1) numbers, then their prefix sums
// Shared memory of density_rows (bytes): the ring, its barriers, the job
// table, the ray slots, the rows' sigma, weights and positions, K5's CDF
// rows, its per-ray floor, total and Exp(1) sum, and its window.
constexpr int kDsBars = kRingStages * kStageBytes;
constexpr int kDsJobs = kDsBars + 128;
constexpr int kDsSlots = kDsJobs + 2 * kTrunkJobs * 4;
constexpr int kDsRows = kDsSlots + (kTileRows + 1) * int(sizeof(RaySlot));
constexpr int kDsRay = kDsRows + 4 * kTileRows * 4;
constexpr int kDsWin = kDsRay + 3 * 64 * 4;
constexpr int kDensitySmem = kDsWin + kUFloats * 4;
static_assert(kDensitySmem <= 232448, "density_rows shared memory");

struct DensityArgs {
  const float *origins, *dirs, *ts, *box, *B, *exps;
  const unsigned char* img;
  int n_rays, S, rpt, spt, steps, n_draw;
  float min_trans, mix_ratio;
  float* out;
};

// Ray g into a slot: its origin, direction, encoding constants and |d|, as
// train_rows computes them; a ray past the end sits at 0 along +z.
__device__ __forceinline__ void density_slot(RaySlot& s, const DensityArgs& a, long g, bool ok) {
  s.g = ok ? g : 0;
  s.valid = ok;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.o[c] = ok ? a.origins[g * 3 + c] : 0.0f;
    s.d[c] = ok ? a.dirs[g * 3 + c] : (c == 2 ? 1.0f : 0.0f);
    const float lo = a.box[c], hi = a.box[3 + c];
    s.scale[c] = 2.0f / (hi - lo);
    s.a3[c] = fmaf(s.o[c], s.scale[c], -2.0f * lo / (hi - lo) - 1.0f);
    s.b3[c] = __fmul_rn(s.d[c], s.scale[c]);
  }
  s.dn = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(s.d[0], s.d[0]), __fmul_rn(s.d[1], s.d[1])),
                         __fmul_rn(s.d[2], s.d[2])));
}

// K8 (kSample false) and K5 (kSample true) on K6's rows: tile k holds rays
// k rpt .. (k + 1) rpt - 1, row r of a step is sample step * spt + r % spt
// of ray r / spt, and block b takes tiles b, b + gridDim.x, ... The trunk,
// sigma and the scan are K6's, step for step, so K6's alpha is the in-order
// f32 sum of K8's weights bit for bit.
template <bool kSample>
__global__ void __launch_bounds__(kRowThreads, 1) density_rows(const DensityArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023u) __trap();
  const Lane l = lane_of();
  int* job_off = reinterpret_cast<int*>(smem_raw + kDsJobs);
  int* job_len = job_off + kTrunkJobs;
  RaySlot* slots = reinterpret_cast<RaySlot*>(smem_raw + kDsSlots);
  float* sig = reinterpret_cast<float*>(smem_raw + kDsRows);
  float* wrow = sig + kTileRows;
  float* trow = sig + 2 * kTileRows;
  float* cdf = sig + 3 * kTileRows;  // K5: ray r's CDF at r * nc
  float* rayv = reinterpret_cast<float*>(smem_raw + kDsRay);  // K5: 3 x 64 per-ray values
  float* win = reinterpret_cast<float*>(smem_raw + kDsWin);
  const int rpt = a.rpt, spt = a.spt, S = a.S;
  const int n_tiles = (a.n_rays + rpt - 1) / rpt;
  if (int(blockIdx.x) >= n_tiles) return;  // block-uniform, before any copy is asked for

  Ring ring;
  ring.base = base;
  ring.bars = base + kDsBars;
  ring.off = job_off;
  ring.bytes = job_len;
  ring.img = a.img;
  ring.per_step = kTrunkJobs;
  // The block's tiles are known, so every job asked for is taken: nothing
  // is left in flight at the end.
  ring.total = ((n_tiles - 1 - int(blockIdx.x)) / int(gridDim.x) + 1) * a.steps * kTrunkJobs;
  ring.n = ring.rel = 0;
  if (l.tid == 0) {
    for (int j = 0, off = 0; j < kTrunkJobs; off += job_bytes(j), ++j) {
      job_off[j] = off;
      job_len[j] = job_bytes(j);
    }
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(ring.bars + 8 * s, 1);                  // full: the expect_tx arrival
      mbar_init(ring.bars + 8 * (kRingStages + s), 8);  // empty: one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_proxy();
    for (int j = 0; j < kRingStages && j < ring.total; ++j) ring_request(ring, j);
  }

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long g0 = long(tile) * rpt;
    for (int r = l.tid; r <= rpt; r += kRowThreads)
      density_slot(slots[r], a, g0 + r, r < rpt && g0 + r < a.n_rays);
    __syncthreads();
    float trans = 1.0f;  // ray tid's transmittance (tid < rpt)
    for (int step = 0; step < a.steps; ++step) {
      // This thread's two rows.
      const RaySlot* rs[2];
      float t[2];
      int row[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        row[e] = l.wg * 64 + l.rloc + 8 * e;
        const int lr = row[e] / spt, s = step * spt + row[e] - lr * spt;
        rs[e] = &slots[lr < rpt ? lr : rpt];
        t[e] = rs[e]->valid && s < S ? a.ts[rs[e]->g * S + s] : 0.0f;
      }
      if (l.q == 0) {
        trow[row[0]] = t[0];
        trow[row[1]] = t[1];
      }
      uint32_t enc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int e = j & 1, c = 16 * (j >> 2) + 8 * ((j >> 1) & 1) + 2 * l.q;
        enc[j] = pack_bf16(enc_value(*rs[e], t[e], c), enc_value(*rs[e], t[e], c + 1));
      }
      uint32_t hA[64], hB[64];
      float acc[64];
      // h0 = relu(enc @ w0 + b0), h1, h2, h3 = relu([enc | h2] @ w3 + b3)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        zero(acc);
        job128<4, 0>(ring, acc, enc);
        if (h == 0) bias_relu<0>(acc, a.B + kB0, hA, l);
        else bias_relu<1>(acc, a.B + kB0, hA, l);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        zero(acc);
        k256_128<false>(ring, acc, enc, hA);
        if (h == 0) bias_relu<0>(acc, a.B + kB1, hB, l);
        else bias_relu<1>(acc, a.B + kB1, hB, l);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        zero(acc);
        k256_128<false>(ring, acc, enc, hB);
        if (h == 0) bias_relu<0>(acc, a.B + kB2, hA, l);
        else bias_relu<1>(acc, a.B + kB2, hA, l);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        zero(acc);
        k256_128<true>(ring, acc, enc, hA);
        if (h == 0) bias_relu<0>(acc, a.B + kB3, hB, l);
        else bias_relu<1>(acc, a.B + kB3, hB, l);
      }
      // h4 = h3 @ w4 + b4; sigma = trunc_exp of its column 0 rounded to bf16
      // (accumulator elements 0 and 2: rows rloc and rloc + 8), zero outside
      // the box.
      float a32[32];
      zero(a32);
      k256_64(ring, a32, hB);
      if (l.q == 0) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const RaySlot& s = *rs[e];
          bool inside = true;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float pc = fmaf(s.d[c], t[e], s.o[c]);
            inside = inside && pc >= a.box[c] && pc <= a.box[3 + c];
          }
          const float h4 = bf16_lo(pack_bf16(a32[2 * e] + a.B[kB4], 0.0f));
          sig[row[e]] = inside ? expf(fminf(fmaxf(h4, -15.0f), 15.0f)) : 0.0f;
        }
      }
      __syncthreads();

      // The composite, one thread a ray over its rows of the step: the
      // weights into wrow.
      if (l.tid < rpt) {
        const RaySlot& s = slots[l.tid];
        const int n_s = min(spt, S - step * spt);
        for (int i = 0; i < n_s; ++i) {
          const int r = l.tid * spt + i, si = step * spt + i;
          const float ti = trow[r];
          const float tn = i + 1 < n_s ? trow[r + 1] : (s.valid && si + 1 < S ? a.ts[s.g * S + si + 1] : 0.0f);
          const float dl = si == S - 1 ? 1e2f : tn - ti;
          const float al = 1.0f - expf(-sig[r] * dl * s.dn);
          wrow[r] = (trans < a.min_trans) ? 0.0f : al * trans;
          // Written exactly as the reference: (1 - a) + 1e-10, never reassociated.
          trans = trans * (1.0f - al + 1e-10f);
        }
      }
      if (!kSample) {
        // K8: the step's weights; a tile's rows are one contiguous run of out.
        // (K5 goes on to its window while warp 0 scans.)
        __syncthreads();
        for (int r = l.tid; r < kTileRows; r += kRowThreads) {
          const int lr = r / spt, s = step * spt + r - lr * spt;
          if (lr < rpt && g0 + lr < a.n_rays && s < S) a.out[(g0 + lr) * S + s] = wrow[r];
        }
      }
    }

    if (kSample) {
      // K5 (one step: spt == nc). Two chains a ray run side by side: ray
      // r's thread of warp 0 builds its CDF, the defensive mixture w +
      // mix_ratio mean(w) + 1e-8 over its sum, summed in order; ray r's
      // thread of the second warpgroup sums its Exp(1) numbers, e_0 + ... +
      // e_n_draw, then their prefixes e_0 + ... + e_i in place, through
      // windows of wd numbers a ray (one unless n_draw is large) that the
      // block loads coalesced. The divisions, which need no order, are
      // spread over the block.
      const int nc = S, nv = a.n_rays - g0 < rpt ? int(a.n_rays - g0) : rpt;
      const int E = a.n_draw + 1, wd = min(E, kUFloats / rpt);
      const int er = l.tid - kRowThreads / 2;  // this thread's ray of the Exp(1) chain
      const bool one = wd == E;
      const float* ex = a.exps + g0 * E;
      auto load = [&](int w0, int nw) {
        for (int j = l.tid; j < nv * nw; j += kRowThreads) {
          const int r = j / nw, i = j - r * nw;
          win[r * wd + i] = ex[long(r) * E + w0 + i];
        }
      };
      float s_total = 0.0f, prefix = 0.0f;
      for (int w0 = 0; w0 < E; w0 += wd) {
        const int nw = min(wd, E - w0);
        if (w0 > 0) __syncthreads();  // the window before is summed
        load(w0, nw);
        __syncthreads();
        if (w0 == 0 && l.tid < nv) {
          const float* w = wrow + l.tid * nc;
          float wsum = 0.0f, total = 0.0f;
#pragma unroll 4
          for (int k = 0; k < nc; ++k) wsum = __fadd_rn(wsum, w[k]);
          const float floor_w = __fmul_rn(a.mix_ratio, wsum / float(nc));
#pragma unroll 4
          for (int k = 0; k < nc; ++k)
            total = __fadd_rn(total, __fadd_rn(__fadd_rn(w[k], floor_w), 1e-8f));
          rayv[l.tid] = floor_w;
          rayv[64 + l.tid] = total;
        }
        if (er >= 0 && er < nv) {
#pragma unroll 4
          for (int i = 0; i < nw; ++i) s_total = __fadd_rn(s_total, win[er * wd + i]);
        }
      }
      if (er >= 0 && er < nv) rayv[128 + er] = s_total;
      __syncthreads();
      // Each row's probability (w + floor + 1e-8) / total, then ray tid's
      // running sum: its CDF.
      for (int r = l.tid; r < nv * nc; r += kRowThreads) {
        const int lr = r / nc;
        cdf[r] = __fadd_rn(__fadd_rn(wrow[r], rayv[lr]), 1e-8f) / rayv[64 + lr];
      }
      __syncthreads();
      if (l.tid < nv) {
        float* c = cdf + l.tid * nc;
        float run = 0.0f;
#pragma unroll 4
        for (int k = 0; k < nc; ++k) c[k] = run = __fadd_rn(run, c[k]);
      }
      for (int w0 = 0; w0 < a.n_draw; w0 += wd) {
        const int nd = min(wd, a.n_draw - w0);
        if (!one) {
          __syncthreads();  // the window before is used up
          load(w0, nd);
          __syncthreads();
        }
        if (er >= 0 && er < nv) {
          float* e = win + er * wd;
#pragma unroll 4
          for (int i = 0; i < nd; ++i) e[i] = prefix = __fadd_rn(prefix, e[i]);
        }
        __syncthreads();
        // Every thread takes draws, u = prefix / s_total. The bin is the
        // first k with u < cdf[k], the last if there is none: the CDF never
        // decreases, so a binary search finds the bin a forward scan would.
        for (int j = l.tid; j < nv * nd; j += kRowThreads) {
          const int r = j / nd, i = j - r * nd;
          const float u = win[r * wd + i] / rayv[128 + r];
          const float* c = cdf + r * nc;
          const float* tr = trow + r * nc;
          int k = 0, k_hi = nc - 1;
          while (k < k_hi) {
            const int mid = (k + k_hi) >> 1;
            if (u < c[mid]) k_hi = mid;
            else k = mid + 1;
          }
          const float cdf_lo = k == 0 ? 0.0f : c[k - 1], cdf_hi = c[k];
          const float lo = k == 0 ? tr[0] : 0.5f * (tr[k] + tr[k - 1]);
          const float hi = k == nc - 1 ? tr[nc - 1] : 0.5f * (tr[k + 1] + tr[k]);
          const float span = cdf_hi - cdf_lo;
          const float denom = span < 1e-8f ? 1.0f : span;
          a.out[(g0 + r) * a.n_draw + w0 + i] = lo + __fmul_rn((u - cdf_lo) / denom, hi - lo);
        }
      }
    }
    __syncthreads();  // the slots, rows and window are free for the next tile
  }
}

// The row geometry train_kernel.py::train_geometry computes, checked.
bool rows_ok(int n_rays, int S, int rpt, int spt, int steps) {
  return n_rays > 0 && S > 0 && rpt > 0 && spt > 0 && rpt * spt <= kTileRows &&
         steps == (S + spt - 1) / spt && (steps == 1 ? (spt == S && rpt == kTileRows / S)
                                                     : (rpt == 1 && spt == kTileRows));
}

template <bool kBwd>
int launch_rows(const RowArgs& a, int groups, cudaStream_t st) {
  static std::atomic<unsigned long long> configured{0};
  cudaError_t err = allow_smem(train_rows<kBwd>, kRowSmem, &configured);
  if (err != cudaSuccess) return int(err);
  train_rows<kBwd><<<groups, kRowThreads, kRowSmem, st>>>(a);
  return int(cudaGetLastError());
}

int launch_dw(const unsigned char* scratch, int nrb, int parts, float* part, int first,
              cudaStream_t st) {
  static std::atomic<unsigned long long> configured{0};
  cudaError_t err = allow_smem(dw_gemm, kDwSmem, &configured);
  if (err != cudaSuccess) return int(err);
  dw_gemm<<<dim3(parts, kDwTiles), 256, kDwSmem, st>>>(scratch, nrb, parts, part, first);
  return int(cudaGetLastError());
}


template <bool kSample>
int launch_density(const DensityArgs& a, int grid, cudaStream_t st) {
  static std::atomic<unsigned long long> configured{0};
  cudaError_t err = allow_smem(density_rows<kSample>, kDensitySmem, &configured);
  if (err != cudaSuccess) return int(err);
  density_rows<kSample><<<grid, kRowThreads, kDensitySmem, st>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// Bytes of the weight image the wrapper builds (train_kernel.py::wgmma_image).
extern "C" int d2r_train_image_bytes() { return image_bytes(kNumJobs); }

// K6. rpt, spt, steps: the row geometry of train_geometry (one block a group
// of rpt rays).
extern "C" int d2r_train_fwd(const void* origins, const void* dirs, const void* ts, int n_rays,
                             int S, const void* box, const void* img, const void* b,
                             float min_trans, int rpt, int spt, int steps, void* rgb,
                             void* alpha, void* depth, void* stream) {
  if (n_rays <= 0) return 0;
  if (!rows_ok(n_rays, S, rpt, spt, steps)) return int(cudaErrorInvalidValue);
  RowArgs a = {};
  a.origins = static_cast<const float*>(origins);
  a.dirs = static_cast<const float*>(dirs);
  a.ts = static_cast<const float*>(ts);
  a.box = static_cast<const float*>(box);
  a.B = static_cast<const float*>(b);
  a.img = static_cast<const unsigned char*>(img);
  a.n_rays = n_rays;
  a.S = S;
  a.rpt = rpt;
  a.spt = spt;
  a.steps = steps;
  a.min_trans = min_trans;
  a.out_rgb = static_cast<float*>(rgb);
  a.out_alpha = static_cast<float*>(alpha);
  a.out_depth = static_cast<float*>(depth);
  return launch_rows<false>(a, (n_rays + rpt - 1) / rpt, static_cast<cudaStream_t>(stream));
}

// K7. The row geometry as for K6, and chunk_groups groups a chunk; scratch
// holds chunk_groups * steps * 2 64-row blocks, bias_rows chunk_groups *
// steps rows of kBiasCols, part `parts` x kGSize floats. Each chunk's row
// pass, then its weight-gradient products; the final sums last.
extern "C" int d2r_train_bwd(const void* origins, const void* dirs, const void* ts, int n_rays,
                             int S, const void* box, const void* img, const void* b,
                             float min_trans, const void* dC, const void* dA, const void* dD,
                             const void* C, const void* A, const void* D, int ray_grads,
                             int rpt, int spt, int steps, int chunk_groups, int parts,
                             void* scratch, void* bias_rows, void* part, void* grads,
                             void* d_origins, void* d_dirs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rays <= 0) return int(cudaMemsetAsync(grads, 0, sizeof(float) * kGSize, st));
  if (!rows_ok(n_rays, S, rpt, spt, steps) || chunk_groups <= 0 || parts <= 0)
    return int(cudaErrorInvalidValue);
  RowArgs a = {};
  a.origins = static_cast<const float*>(origins);
  a.dirs = static_cast<const float*>(dirs);
  a.ts = static_cast<const float*>(ts);
  a.box = static_cast<const float*>(box);
  a.B = static_cast<const float*>(b);
  a.img = static_cast<const unsigned char*>(img);
  a.n_rays = n_rays;
  a.S = S;
  a.rpt = rpt;
  a.spt = spt;
  a.steps = steps;
  a.min_trans = min_trans;
  a.dC = static_cast<const float*>(dC);
  a.dA = static_cast<const float*>(dA);
  a.dD = static_cast<const float*>(dD);
  a.C = static_cast<const float*>(C);
  a.A = static_cast<const float*>(A);
  a.D = static_cast<const float*>(D);
  a.ray_grads = ray_grads;
  a.scratch = static_cast<unsigned char*>(scratch);
  a.bias_rows = static_cast<float*>(bias_rows);
  a.d_origins = static_cast<float*>(d_origins);
  a.d_dirs = static_cast<float*>(d_dirs);
  const int groups = (n_rays + rpt - 1) / rpt;
  float* pp = static_cast<float*>(part);
  for (int g0 = 0; g0 < groups; g0 += chunk_groups) {
    const int ng = groups - g0 < chunk_groups ? groups - g0 : chunk_groups;
    a.group0 = g0;
    a.first_chunk = g0 == 0;
    if (int err = launch_rows<true>(a, ng, st)) return err;
    if (int err = launch_dw(a.scratch, ng * steps * 2, parts, pp, g0 == 0, st)) return err;
  }
  const int n_bias_rows = (groups < chunk_groups ? groups : chunk_groups) * steps;
  reduce_grads<<<(kGSize + 255) / 256, 256, 0, st>>>(pp, parts, a.bias_rows, n_bias_rows,
                                                    static_cast<float*>(grads));
  return int(cudaGetLastError());
}

// K8 on the weight image img (only its first 32 jobs are read). rpt, spt,
// steps: the row geometry of train_geometry; grid blocks (one an SM at most)
// stride over the tiles.
extern "C" int d2r_density_weights(const void* origins, const void* dirs, const void* ts,
                                   int n_rays, int S, const void* box, const void* img,
                                   const void* b, float min_trans, int rpt, int spt, int steps,
                                   int grid, void* out, void* stream) {
  if (n_rays <= 0) return 0;
  if (!rows_ok(n_rays, S, rpt, spt, steps) || grid <= 0) return int(cudaErrorInvalidValue);
  DensityArgs a = {};
  a.origins = static_cast<const float*>(origins);
  a.dirs = static_cast<const float*>(dirs);
  a.ts = static_cast<const float*>(ts);
  a.box = static_cast<const float*>(box);
  a.B = static_cast<const float*>(b);
  a.img = static_cast<const unsigned char*>(img);
  a.n_rays = n_rays;
  a.S = S;
  a.rpt = rpt;
  a.spt = spt;
  a.steps = steps;
  a.min_trans = min_trans;
  a.out = static_cast<float*>(out);
  return launch_density<false>(a, grid, static_cast<cudaStream_t>(stream));
}

// K5: nc from 2 to 64 coarse samples a ray (one step of rows), n_draw draws a
// ray from exps (n_rays x (n_draw + 1)); the geometry and grid as for K8.
extern "C" int d2r_density_sample(const void* origins, const void* dirs, const void* ts_c,
                                  const void* exps, int n_rays, int nc, int n_draw,
                                  const void* box, const void* img, const void* b,
                                  float min_trans, float mix_ratio, int rpt, int spt, int steps,
                                  int grid, void* out, void* stream) {
  if (n_rays <= 0) return 0;
  if (nc < 2 || nc > 64 || n_draw < 0 || !rows_ok(n_rays, nc, rpt, spt, steps) || grid <= 0)
    return int(cudaErrorInvalidValue);
  DensityArgs a = {};
  a.origins = static_cast<const float*>(origins);
  a.dirs = static_cast<const float*>(dirs);
  a.ts = static_cast<const float*>(ts_c);
  a.box = static_cast<const float*>(box);
  a.B = static_cast<const float*>(b);
  a.exps = static_cast<const float*>(exps);
  a.img = static_cast<const unsigned char*>(img);
  a.n_rays = n_rays;
  a.S = nc;
  a.rpt = rpt;
  a.spt = spt;
  a.steps = steps;
  a.n_draw = n_draw;
  a.min_trans = min_trans;
  a.mix_ratio = mix_ratio;
  a.out = static_cast<float*>(out);
  return launch_density<true>(a, grid, static_cast<cudaStream_t>(stream));
}
