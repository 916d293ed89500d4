// SLIC assignment step: per pixel, the nearest box-constrained center.
//
// Replaces the Pallas kernel camouflage_multimodal_tpu/ops/pallas_slic.py
// (_assign_kernel, launched by pallas_slic_assign). Same function: for each
// pixel, argmin over ALL K centers of the 5-D SLIC distance, counting only
// centers with |py - floor(cy)| <= step and |px - floor(cx)| <= step; ties
// go to the lowest center id; a pixel no box covers keeps `prev`.
//
// Numerics: the TPU kernel expands the distance as |c|^2 - 2 p.c on the MXU,
// which cancels badly in float32 at Lab and pixel magnitudes. This kernel
// computes direct squared differences in the term order of the JAX main
// path's windowed assign (ops/slic.py:316-319):
//   d = ratio * ((py-cy)^2 + (px-cx)^2);  d += (L-cL)^2;  d += (a-ca)^2;
//   d += (b-cb)^2
// with explicit _rn intrinsics so nvcc cannot contract them into FMAs: the
// result is bit-equal to the plain PyTorch version (slic_assign_plain).
//
// Bound on this card: the required work is small (bytes: 20 B of features
// plus 4 B of prev read and 4 B written per pixel; operations: ~16 flops for
// each pixel-center pair inside the box, about 4 per pixel), so the byte
// bound is what a design can approach; what it must avoid is issuing a box
// test per pixel for each of the K centers (K = 529 at 256^2 / 500
// segments), which bound the first design. Design: a block of 256 threads
// owns a 2-D tile of pixels (tile_w x 256/tile_w; 16 x 16 on the main
// path), one thread per pixel, grid (tiles, batch).
//   1. The block takes the bounding box of its pixels' (y, x) features (a
//      warp min/max and one barrier), so the pruning is right for whatever
//      positions the features hold; the width argument only shapes the tile.
//   2. It scans the image's K centers cooperatively in chunks of 1,024
//      (every thread looks at the floored position of up to four, their
//      loads in flight together) and keeps those that lie within the box
//      grown by step on every side: a superset of every center that any
//      pixel of the tile has in its own box, at any center drift. Kept
//      centers are compacted into shared memory IN ASCENDING ID ORDER (warp
//      ballot + prefix count over the warps' totals, no atomics): the first
//      design's 7 values and the id, 32 B a center. The list holds one
//      chunk, so it has a fixed capacity of min(K, 1,024) centers (32 KB at
//      most) whatever K is: all 1,024 of a chunk may be kept (centers may
//      collapse into one tile). At step 11 a 16 x 16 tile lists about 11 of
//      529 (16 at most on seed and converged centers); K <= 1,024 is one
//      chunk.
//   3. Each thread runs the first design's loop, unchanged in arithmetic,
//      over the chunk's list: the per-pixel box test, then the distance,
//      `d < best` strict. Its best distance and id stay in registers from
//      one chunk to the next. Because chunks come in ascending id order and
//      each list is in ascending id order, the lowest id still wins a tie,
//      across chunk boundaries too.
// A list sized for all K could not launch above K = 7,264 (227 KB a
// block), e.g. 416^2 at 12,000 segments (K = 10,816); per-block shared
// memory no longer grows with K.
// 32 registers a thread and the 16.9 KB list of K = 529 keep 8 blocks on an
// SM, so the 1,024 blocks of a batch of four 256^2 images are one wave; the
// 32 KB list of K > 1,024 leaves room for 6. Pixels of a ragged edge (image
// sides that are no multiple of the tile) are masked.
// Loads: features are an array of 20-byte structures; a tile row is one
// contiguous run (16 px x 20 B = 320 B), which a warp reads as five strided
// scalar loads over the same 128-byte lines: the lines come from device
// memory once and the four later loads hit L1, so a staged 16-byte load
// would save instruction slots only. Staging was tried where it looked most
// promising, on the centers (a coalesced copy of all K x 20 B into shared
// memory, started with the pixel loads, the scan and the loop reading the
// copy): it took 14.5 us a launch against 11.4 us for this version (four
// 256^2 images, NVIDIA H100 80GB HBM3 at 700 W), since
// each block then moves 10.6 KB instead of the 4.2 KB of positions, so the
// pixel loads were left as they are.

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;   // centers a thread looks at in one pass of the scan
constexpr int kChunk = kThreads * kRounds;   // centers of one pass: the list's capacity

__global__ void __launch_bounds__(kThreads, 2048 / kThreads)   // 32 registers: 8 blocks an SM
slic_assign_kernel(const float* __restrict__ pix, const float* __restrict__ centers,
                   const int* __restrict__ prev, int* __restrict__ out, int height, int width,
                   int tile_w, int tiles_x, int k_count, float ratio, int step) {
  extern __shared__ float smem[];
  const int cap = min(k_count, kChunk);
  float* c_l = smem;
  float* c_a = c_l + cap;
  float* c_b = c_a + cap;
  float* c_y = c_b + cap;
  float* c_x = c_y + cap;
  int* c_fy = reinterpret_cast<int*>(c_x + cap);
  int* c_fx = c_fy + cap;
  int* c_id = c_fx + cap;
  __shared__ int s_box[4][kWarps];
  __shared__ int s_count[kRounds][kWarps];

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile_h = kThreads / tile_w;
  const int y = (blockIdx.x / tiles_x) * tile_h + threadIdx.x / tile_w;
  const int x = (blockIdx.x % tiles_x) * tile_w + threadIdx.x % tile_w;
  const bool active = y < height && x < width;
  const size_t gp = static_cast<size_t>(b) * height * width + static_cast<size_t>(y) * width + x;

  float pl = 0.f, pa = 0.f, pb = 0.f, py = 0.f, px = 0.f;
  int iy = 0, ix = 0;
  if (active) {
    const float* f = pix + gp * 5;
    pl = f[0], pa = f[1], pb = f[2], py = f[3], px = f[4];
    iy = static_cast<int>(py), ix = static_cast<int>(px);
  }

  // 1. Bounding box of the tile's pixel positions.
  const int y_lo = __reduce_min_sync(0xffffffffu, active ? iy : INT_MAX);
  const int y_hi = __reduce_max_sync(0xffffffffu, active ? iy : INT_MIN);
  const int x_lo = __reduce_min_sync(0xffffffffu, active ? ix : INT_MAX);
  const int x_hi = __reduce_max_sync(0xffffffffu, active ? ix : INT_MIN);
  if (lane == 0) {
    s_box[0][warp] = y_lo, s_box[1][warp] = y_hi, s_box[2][warp] = x_lo, s_box[3][warp] = x_hi;
  }
  __syncthreads();
  int box_y0 = INT_MAX, box_y1 = INT_MIN, box_x0 = INT_MAX, box_x1 = INT_MIN;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    box_y0 = min(box_y0, s_box[0][w]), box_y1 = max(box_y1, s_box[1][w]);
    box_x0 = min(box_x0, s_box[2][w]), box_x1 = max(box_x1, s_box[3][w]);
  }
  // A block always holds an active pixel, so the box is real and these stay
  // far from the ends of int.
  box_y0 -= step, box_y1 += step, box_x0 -= step, box_x1 += step;

  const float* cb = centers + static_cast<size_t>(b) * k_count * 5;
  float best = INFINITY;
  int label = -1;
  for (int k0 = 0; k0 < k_count; k0 += kChunk) {
    // 2. The chunk's candidate centers, compacted in ascending id order.
    //    Thread tid looks at center k0 + tid + 256 r in round r. The rounds'
    //    position loads are independent and in flight together; a kept
    //    center is read again (from L1) when it is written to the list, so
    //    that no round's values are held in registers across the barrier.
    //    The previous chunk's list and counts are free again here: every
    //    thread passed the barrier after the compaction before reading the
    //    list, and reaches the barrier below only after its assignment loop.
    unsigned kept[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int k = k0 + r * kThreads + threadIdx.x;
      bool keep = false;
      if (k < k_count) {
        const int fy = __float2int_rd(cb[static_cast<size_t>(k) * 5 + 3]);   // floor, saturating
        const int fx = __float2int_rd(cb[static_cast<size_t>(k) * 5 + 4]);
        keep = fy >= box_y0 && fy <= box_y1 && fx >= box_x0 && fx <= box_x1;
      }
      kept[r] = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_count[r][warp] = __popc(kept[r]);
    }
    __syncthreads();
    int listed = 0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      int before = listed;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) before += s_count[r][w];
        listed += s_count[r][w];
      }
      if ((kept[r] >> lane) & 1u) {
        const int k = k0 + r * kThreads + threadIdx.x;
        const float* c = cb + static_cast<size_t>(k) * 5;
        const int at = before + __popc(kept[r] & ((1u << lane) - 1u));
        c_l[at] = c[0], c_a[at] = c[1], c_b[at] = c[2], c_y[at] = c[3], c_x[at] = c[4];
        c_fy[at] = __float2int_rd(c[3]), c_fx[at] = __float2int_rd(c[4]), c_id[at] = k;
      }
    }
    __syncthreads();   // the list is complete

    // 3. The assignment over the chunk's list.
    if (!active) continue;
    for (int i = 0; i < listed; ++i) {
      if (abs(iy - c_fy[i]) > step || abs(ix - c_fx[i]) > step) continue;
      const float ey = __fsub_rn(py, c_y[i]);
      const float ex = __fsub_rn(px, c_x[i]);
      float d = __fmul_rn(ratio, __fadd_rn(__fmul_rn(ey, ey), __fmul_rn(ex, ex)));
      const float el = __fsub_rn(pl, c_l[i]);
      d = __fadd_rn(d, __fmul_rn(el, el));
      const float ea = __fsub_rn(pa, c_a[i]);
      d = __fadd_rn(d, __fmul_rn(ea, ea));
      const float eb = __fsub_rn(pb, c_b[i]);
      d = __fadd_rn(d, __fmul_rn(eb, eb));
      if (d < best) {  // strict, and ids ascend along the lists: the lowest id wins a tie
        best = d;
        label = c_id[i];
      }
    }
  }
  if (active) out[gp] = label >= 0 ? label : prev[gp];
}

}  // namespace

CMT_DEFINE_ERROR_STRING

// pix (B, H*W, 5) float32 (L, a, b, y, x), pixel p of an image at row
// p / width, column p % width; centers (B, K, 5) float32; prev, out (B, H*W)
// int32. All contiguous, on the current device. tile_w divides 256: a block
// owns tile_w x (256 / tile_w) pixels.
CMT_EXPORT int slic_assign(const float* pix, const float* centers,
                           const int* prev, int* out, int batch, int height,
                           int width, int tile_w, int k_count, float ratio,
                           int step, void* stream) {
  if (tile_w <= 0 || kThreads % tile_w) return static_cast<int>(cudaErrorInvalidValue);
  const int tile_h = kThreads / tile_w;
  const int tiles_x = (width + tile_w - 1) / tile_w;
  const int tiles_y = (height + tile_h - 1) / tile_h;
  // One chunk's list: 8 words a center, at most 32 KB whatever K is.
  const size_t smem = static_cast<size_t>(min(k_count, kChunk)) * 8 * sizeof(float);
  int rc = cmt_set_smem(slic_assign_kernel, smem);
  if (rc != 0) return rc;
  dim3 grid(tiles_x * tiles_y, batch);
  slic_assign_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pix, centers, prev, out, height, width, tile_w, tiles_x, k_count, ratio, step);
  CMT_CHECK_LAUNCH();
  return 0;
}
