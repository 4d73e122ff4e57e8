// Fused ray-march kernel (K1) for the imagine-and-score crop renderer.
//
// Replaces: dream2real_tpu/nerf/march_kernel.py::march_rays_fused, the Pallas
// body _march_kernel / _march_block. Computes what _march_block computes, for
// flat rays, each with its own origin (the caller batches the rays of a whole
// clip group), each ray's box range t0..t1 cut into S uniform samples; per
// sample the deg-10 frequency encoding (affine angles in t), the 5x256 trunk
// with the skip at layer 3, the folded sigma + geo-colour head, the SH colour
// term, the 64-64-3 colour MLP, sigma masked to the field box intersected
// with the march box, and the front-to-back composite (last delta 1e2). bf16
// matmul inputs with f32 accumulation and bias, bf16 rounding between layers,
// f32 exp / sigmoid / composite, at the same points as the reference.
//
// Bound on the H100: tensor-core operations. 252,416 MACs a sample at the
// widths the function needs (256,256 in the kernel's padded tiles, the head
// 128 wide), against 28 bytes of ray in and 20 out: a clip group on a random
// field needs about 2.85M samples, 1.45 ms at 989 TFLOP/s dense bf16.
//
// Design: the row engine of K6 (rows.cuh). Rows are (ray, sample) pairs: a
// tile of 128 rows holds rpt rays x spt samples (march_kernel.py::
// march_geometry; 32 rays x 4 samples at S = 20), and a tile walks its rays'
// S samples in steps of spt. Each of the two warpgroups owns 64 rows; every
// layer of every row is one wgmma product per warpgroup, m64n128k16 (64 for
// the colour layers) with A from registers: the f32 accumulator, biased,
// relu'd and rounded to bf16 in place, is the next product's A fragments, so
// activations never touch shared memory, and the 256-wide layers run as two
// 128-column halves. The head is [h3 | SH] @ wm, the sigma row and the colour
// layer's geo columns folded into one 272 x 128 matrix (80 columns used); the
// SH term enters it as a 16-row K-tile, computed once a ray. The weights come
// through a ring of six 16 KB stages filled by cp.async.bulk from an image
// that pack_params builds once a field (every K-tile of every layer, swizzled
// as wgmma reads it, 35 jobs and 544,768 bytes a step). One thread a ray then
// runs the composite over the step's rows, front to back, its transmittance
// and sums carried from step to step in registers; the last delta is 1e2 and
// trans * (1 - a + 1e-10) is written as the reference writes it.
//
// The weights from L2: every step of every tile reads the 0.53 MB image once.
// A clip group on phase 2's random field is 150,248 live rays x 20 samples =
// 23.5k tiles of 128 rows, 12.8 GB from L2, 2.3-2.6 ms at 5-5.5 TB/s: above
// the 1.45 ms tensor bound, so the tile rate cannot pass about 10k tiles a
// millisecond. A block of 256 rows would halve it, but the engine keeps three
// 64-row activation sets in registers (255 a thread, one block an SM), so a
// block cannot hold more rows; a 2-CTA cluster sharing the ring through TMA
// multicast would halve it too, at the cost of running both tiles to the
// later one's early exit. The engine's tile rate on this card is under half
// of what L2 allows (K6: 4096 tiles in 1.225 ms; K1 here: 23.5k tile-steps in
// 5.4 ms, 2.4 TB/s of weight reads, measured on an H100), so the ring stays
// per block.
//
// No host sync: the caller compacts the live rays (t1 > t0) on the device
// into `live` and writes their number to `count`; the grid is one block an
// SM, and each block takes tiles of the compacted rays from a counter until
// the tiles of `count` rays are done (a clip group with no live ray launches
// and writes nothing: its outputs stay the zeros the wrapper allocated).
// Outputs scatter back through `live`. Exact early exit: a tile stops
// walking steps once every one of its rays has transmittance below
// min_trans, where every later sample's weight is exactly 0, so the results
// are bit-identical with early_exit 0. Rays that miss the box are never
// marched (the all-miss skip of the reference, per ray). The sample position,
// encoding angles and world position are single-rounding fused multiply-adds,
// as the reference's compiled kernel computes them (the plain version
// emulates them in f64); every other product and sum rounds separately.
// Weight layout: dream2real_tpu_torch/nerf/march_kernel.py (W_LAYOUT,
// B_LAYOUT, MARCH_JOBS).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"
#include "rows.cuh"

namespace {

constexpr float kPi = 3.14159265358979323846f;

// The weight jobs of a step (MARCH_JOBS in march_kernel.py), in the order
// the products take them: 0-1 w0 (two halves of 128 columns), 2-9 w1, 10-17
// w2, 18-27 w3 (5 K-tiles a half, the encoding's first), 28-31 wm over h3
// and 32 wm over SH (16 rows; 128 columns: geo colour 64 | sigma | zeros),
// 33 cw1, 34 cw2 (64 columns, 3 used).
constexpr int kJobs = 35;
__host__ __device__ constexpr int job_bytes(int j) { return j < 32 ? 16384 : j == 32 ? 4096 : 8192; }
__host__ __device__ constexpr int image_bytes(int n) {
  return n == 0 ? 0 : image_bytes(n - 1) + job_bytes(n - 1);
}
static_assert(image_bytes(kJobs) == 544768, "MARCH_JOBS");

// Packed f32 biases (B_LAYOUT): b0 .. b3, then bm = [geo colour 64 | sigma | pad].
constexpr int kB0 = 0, kB1 = 256, kB2 = 512, kB3 = 768, kBM = 1024;

// A ray of a tile, in shared memory. g < 0: no ray (past the count, or slot
// rpt, which the rows past the tile's rays read).
struct Slot {
  float o[3], d[3], a3[3], b3[3];
  float sh[16];  // SH basis of the unit direction (f32)
  float t0, dt, dn;
  int g;
};
static_assert(sizeof(Slot) == 128, "Slot");

// Shared memory (bytes): the ring, its barriers, the job table, the tile
// indices, the ray slots, and the rows' sigma and rgb.
constexpr int kSmBars = kRingStages * kStageBytes;
constexpr int kSmJobs = kSmBars + 128;
constexpr int kSmTile = kSmJobs + 2 * kJobs * 4;
constexpr int kSmSlots = kSmTile + 16;
constexpr int kSmRows = kSmSlots + (kTileRows + 1) * int(sizeof(Slot));
constexpr int kMarchSmem = kSmRows + 4 * kTileRows * 4;
static_assert(kMarchSmem <= 232448, "march_rows shared memory");

__device__ __forceinline__ float pick3(const float* v, int c) {
  return c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Encoding column c of a row at position t: [p2 3 | sin 30 | cos 30 | 0],
// angle idx = A + B t with A = a3 f_j, B = b3 f_j (freq-major, like posenc).
__device__ __forceinline__ float enc_value(const Slot& s, float t, int c) {
  if (c < 3) return fmaf(pick3(s.b3, c), t, pick3(s.a3, c));
  if (c >= 63) return 0.0f;
  const int idx = c < 33 ? c - 3 : c - 33, j = idx / 3, k = idx - 3 * j;
  const float freq = ldexpf(kPi, j);
  const float ang = fmaf(__fmul_rn(pick3(s.b3, k), freq), t, __fmul_rn(pick3(s.a3, k), freq));
  return c < 33 ? sinf(ang) : cosf(ang);
}

struct MarchArgs {
  const float *origins, *dirs, *t0s, *t1s, *box, *B;
  const int *live, *count;
  int* next;  // the tile counter, zero at launch
  const unsigned char* img;
  int rays_per_pose, S, rpt, spt, steps, early_exit;
  float min_trans;
  float *out_rgb, *out_alpha, *out_depth;
};

__device__ void load_slot(Slot& s, const MarchArgs& a, int i, bool ok) {
  const int g = ok ? a.live[i] : 0;
  const int pose = g / a.rays_per_pose;
  float t0 = 0.0f, t1 = 0.0f;
  if (ok) {
    t0 = a.t0s[g];
    t1 = a.t1s[g];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.o[c] = ok ? a.origins[pose * 3 + c] : 0.0f;
    s.d[c] = ok ? a.dirs[size_t(g) * 3 + c] : (c == 2 ? 1.0f : 0.0f);
    const float lo = a.box[c], hi = a.box[3 + c];
    const float scale = 2.0f / (hi - lo);
    s.a3[c] = fmaf(s.o[c], scale, -2.0f * lo / (hi - lo) - 1.0f);
    s.b3[c] = __fmul_rn(s.d[c], scale);
  }
  s.t0 = t0;
  s.dt = (t1 - t0) / float(a.S);
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
  s.g = ok ? g : -1;
}

// One block an SM; it takes tiles of rpt compacted rays from the counter
// until the tiles of *count rays are done. Tile k holds rays k rpt ..; row r
// of a step is sample step * spt + r % spt of ray r / spt.
__global__ void __launch_bounds__(kRowThreads, 1) march_rows(const MarchArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023u) __trap();
  const Lane l = lane_of();
  int* job_off = reinterpret_cast<int*>(smem_raw + kSmJobs);
  int* job_len = job_off + kJobs;
  volatile int* tile_of = reinterpret_cast<volatile int*>(smem_raw + kSmTile);
  Slot* slots = reinterpret_cast<Slot*>(smem_raw + kSmSlots);
  float* sig = reinterpret_cast<float*>(smem_raw + kSmRows);
  float* rgb = sig + kTileRows;  // 3 x 128
  const int rpt = a.rpt, spt = a.spt, S = a.S;
  const int n_tiles = (*a.count + rpt - 1) / rpt;

  if (l.tid == 0) tile_of[0] = atomicAdd(a.next, 1);
  __syncthreads();
  int tile = tile_of[0];
  if (tile >= n_tiles) return;  // block-uniform, before any copy is asked for

  Ring ring;
  ring.base = base;
  ring.bars = base + kSmBars;
  ring.off = job_off;
  ring.bytes = job_len;
  ring.img = a.img;
  ring.per_step = kJobs;
  ring.total = INT_MAX;  // the jobs repeat step after step; the tail is drained at the end
  ring.n = ring.rel = 0;
  if (l.tid == 0) {
    for (int j = 0, off = 0; j < kJobs; off += job_bytes(j), ++j) {
      job_off[j] = off;
      job_len[j] = job_bytes(j);
    }
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(ring.bars + 8 * s, 1);                  // full: the expect_tx arrival
      mbar_init(ring.bars + 8 * (kRingStages + s), 8);  // empty: one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_proxy();
    for (int j = 0; j < kRingStages; ++j) ring_request(ring, j);
  }
  float lo_i[3], hi_i[3];  // the field box intersected with the march box
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo_i[c] = fmaxf(a.box[c], a.box[6 + c]);
    hi_i[c] = fminf(a.box[3 + c], a.box[9 + c]);
  }
  const float bsig = a.B[kBM + 64];

  for (int it = 0; tile < n_tiles; ++it) {
    if (l.tid == 0) tile_of[(it + 1) & 1] = atomicAdd(a.next, 1);
    for (int r = l.tid; r <= rpt; r += kRowThreads) {
      const int i = tile * rpt + r;
      load_slot(slots[r], a, i, r < rpt && i < *a.count);
    }
    // The scanning thread of ray tid (tid < rpt): its composite state.
    float trans = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f, acc_d = 0.0f;
    for (int step = 0; step < a.steps; ++step) {
      // A barrier (the slots are written; the last scan is done with the
      // rows) and the exact early exit: once no ray of the tile has
      // transmittance left, every later weight is zero.
      const bool alive = l.tid < rpt && slots[l.tid].g >= 0 && trans >= a.min_trans;
      if (!__syncthreads_or(alive) && a.early_exit) break;
      // This thread's two rows.
      const Slot* rs[2];
      float t[2];
      int row[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        row[e] = l.wg * 64 + l.rloc + 8 * e;
        const int lr = row[e] / spt, s = step * spt + row[e] - lr * spt;
        rs[e] = &slots[lr < rpt ? lr : rpt];
        t[e] = fmaf(float(s) + 0.5f, rs[e]->dt, rs[e]->t0);
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
      // The head: [h3 | SH] @ wm + bm -> c0 = bf16(relu(geo colour)), sigma.
      uint32_t shf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = j & 1, c = 8 * (j >> 1) + 2 * l.q;
        shf[j] = pack_bf16(rs[e]->sh[c], rs[e]->sh[c + 1]);
      }
      zero(acc);
      k256_128<false>(ring, acc, enc, hB);
      job128<1, 0>(ring, acc, shf);
      uint32_t c0[16], c1[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(a.B + kBM + 8 * (j >> 1) + 2 * l.q);
        c0[j] = pack_bf16(fmaxf(acc[2 * j] + b.x, 0.0f), fmaxf(acc[2 * j + 1] + b.y, 0.0f));
      }
      if (l.q == 0) {  // column 64: elements 32 (row rloc) and 34 (row rloc + 8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const Slot& s = *rs[e];
          bool inside = true;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float pc = fmaf(s.d[c], t[e], s.o[c]);
            inside = inside && pc >= lo_i[c] && pc <= hi_i[c];
          }
          const float sigma = expf(fminf(fmaxf(acc[32 + 2 * e] + bsig, -15.0f), 15.0f));
          sig[row[e]] = inside ? sigma : 0.0f;
        }
      }
      // c1 = relu(c0 @ cw1), rgb = sigmoid(c1 @ cw2)
      float a32[32];
      zero(a32);
      job64<4, 0>(ring, a32, c0);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        c1[j] = pack_bf16(fmaxf(a32[2 * j], 0.0f), fmaxf(a32[2 * j + 1], 0.0f));
      zero(a32);
      job64<4, 0>(ring, a32, c1);
      if (l.q < 2) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          rgb[2 * l.q * kTileRows + row[e]] = sigmoid(a32[2 * e]);
          if (l.q == 0) rgb[kTileRows + row[e]] = sigmoid(a32[2 * e + 1]);
        }
      }
      __syncthreads();

      // The composite, one thread a ray, over this step's samples.
      if (l.tid < rpt) {
        const Slot& s = slots[l.tid];
        const int n_s = min(spt, S - step * spt);
        for (int i = 0; i < n_s; ++i) {
          const int r = l.tid * spt + i, si = step * spt + i;
          const float ts = fmaf(float(si) + 0.5f, s.dt, s.t0);
          const float delta = si == S - 1 ? 1e2f : s.dt;
          const float al = 1.0f - expf(-sig[r] * delta * s.dn);
          const float w = (trans < a.min_trans) ? 0.0f : al * trans;
          acc_r += w * rgb[r];
          acc_g += w * rgb[kTileRows + r];
          acc_b += w * rgb[2 * kTileRows + r];
          acc_a += w;
          acc_d += w * ts;
          // Written exactly as the reference: (1 - a) + 1e-10, never reassociated.
          trans = trans * (1.0f - al + 1e-10f);
        }
      }
    }
    if (l.tid < rpt && slots[l.tid].g >= 0) {
      const size_t g = slots[l.tid].g;
      a.out_rgb[g * 3 + 0] = acc_r;
      a.out_rgb[g * 3 + 1] = acc_g;
      a.out_rgb[g * 3 + 2] = acc_b;
      a.out_alpha[g] = acc_a;
      a.out_depth[g] = acc_d;
    }
    __syncthreads();  // the slots and the next tile's index
    tile = tile_of[(it + 1) & 1];
  }
  // The ring asked for the next kRingStages - 1 jobs ahead of the last one
  // taken: let them land before the block's shared memory is given up.
  if (l.tid == 0)
    for (int j = ring.n; j < ring.n + kRingStages - 1; ++j)
      mbar_wait(ring.bars + 8 * (j % kRingStages), (j / kRingStages) & 1);
}

}  // namespace

// Bytes of the weight image the wrapper builds (march_kernel.py::pack_params).
extern "C" int d2r_march_image_bytes() { return image_bytes(kJobs); }

// Dynamic shared memory of march_rows (march_kernel.py::march_geometry).
extern "C" int d2r_march_smem_bytes() { return kMarchSmem; }

// K1 over the compacted live rays: live[0 .. *count) are flat ray indices g
// into dirs / t0 / t1 (ray g belongs to pose g / rays_per_pose of origins);
// next is an int the caller zeroes; rpt, spt, steps and grid are
// march_geometry's. Results go to rgb / alpha / depth at g.
extern "C" int d2r_march(const void* origins, const void* dirs, const void* t0, const void* t1,
                         const void* live, const void* count, void* next, int rays_per_pose,
                         const void* box, const void* img, const void* b, int n_samples,
                         float min_trans, int early_exit, int rpt, int spt, int steps, int grid,
                         int smem, void* rgb, void* alpha, void* depth, void* stream) {
  if (rays_per_pose <= 0 || n_samples <= 0 || rpt <= 0 || spt <= 0 || rpt * spt > kTileRows ||
      spt > n_samples || steps != (n_samples + spt - 1) / spt || grid <= 0 || smem != kMarchSmem)
    return int(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> configured{0};
  cudaError_t err = allow_smem(march_rows, smem, &configured);
  if (err != cudaSuccess) return int(err);
  MarchArgs a = {};
  a.origins = static_cast<const float*>(origins);
  a.dirs = static_cast<const float*>(dirs);
  a.t0s = static_cast<const float*>(t0);
  a.t1s = static_cast<const float*>(t1);
  a.box = static_cast<const float*>(box);
  a.B = static_cast<const float*>(b);
  a.live = static_cast<const int*>(live);
  a.count = static_cast<const int*>(count);
  a.next = static_cast<int*>(next);
  a.img = static_cast<const unsigned char*>(img);
  a.rays_per_pose = rays_per_pose;
  a.S = n_samples;
  a.rpt = rpt;
  a.spt = spt;
  a.steps = steps;
  a.early_exit = early_exit;
  a.min_trans = min_trans;
  a.out_rgb = static_cast<float*>(rgb);
  a.out_alpha = static_cast<float*>(alpha);
  a.out_depth = static_cast<float*>(depth);
  march_rows<<<grid, kRowThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
