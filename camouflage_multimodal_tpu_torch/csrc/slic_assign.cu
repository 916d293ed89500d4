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
// each pixel-center pair inside the box, a handful per pixel), but the
// all-K sweep issues K box tests per pixel, so the kernel is bound by
// instruction issue of that loop (K = 529 at 256^2 / 500 segments). Design:
// one thread per pixel, grid (pixel blocks, batch); the image's K centers
// (5 floats plus the floored (cy, cx) as ints, 28 B each, 15 KB at K = 529)
// are staged once per block in shared memory, and every thread of a warp
// reads the same center at the same time (a broadcast, no bank conflicts).
// The box test runs first and skips the distance for the ~99% of centers
// outside the box. Pruning centers per pixel tile is left for later work.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void slic_assign_kernel(const float* __restrict__ pix,
                                   const float* __restrict__ centers,
                                   const int* __restrict__ prev,
                                   int* __restrict__ out, int hw, int k_count,
                                   float ratio, int step) {
  extern __shared__ float smem[];
  float* c_l = smem;
  float* c_a = c_l + k_count;
  float* c_b = c_a + k_count;
  float* c_y = c_b + k_count;
  float* c_x = c_y + k_count;
  int* c_fy = reinterpret_cast<int*>(c_x + k_count);
  int* c_fx = c_fy + k_count;

  const int b = blockIdx.y;
  const float* cb = centers + static_cast<size_t>(b) * k_count * 5;
  for (int k = threadIdx.x; k < k_count; k += blockDim.x) {
    const float* c = cb + static_cast<size_t>(k) * 5;
    c_l[k] = c[0];
    c_a[k] = c[1];
    c_b[k] = c[2];
    c_y[k] = c[3];
    c_x[k] = c[4];
    c_fy[k] = static_cast<int>(floorf(c[3]));
    c_fx[k] = static_cast<int>(floorf(c[4]));
  }
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const size_t gp = static_cast<size_t>(b) * hw + p;
  const float* f = pix + gp * 5;
  const float pl = f[0], pa = f[1], pb = f[2], py = f[3], px = f[4];
  const int iy = static_cast<int>(py), ix = static_cast<int>(px);

  float best = INFINITY;
  int label = -1;
  for (int k = 0; k < k_count; ++k) {
    if (abs(iy - c_fy[k]) > step || abs(ix - c_fx[k]) > step) continue;
    const float ey = __fsub_rn(py, c_y[k]);
    const float ex = __fsub_rn(px, c_x[k]);
    float d = __fmul_rn(ratio, __fadd_rn(__fmul_rn(ey, ey), __fmul_rn(ex, ex)));
    const float el = __fsub_rn(pl, c_l[k]);
    d = __fadd_rn(d, __fmul_rn(el, el));
    const float ea = __fsub_rn(pa, c_a[k]);
    d = __fadd_rn(d, __fmul_rn(ea, ea));
    const float eb = __fsub_rn(pb, c_b[k]);
    d = __fadd_rn(d, __fmul_rn(eb, eb));
    if (d < best) {  // strict: the lowest id wins a tie
      best = d;
      label = k;
    }
  }
  out[gp] = label >= 0 ? label : prev[gp];
}

}  // namespace

CMT_DEFINE_ERROR_STRING

// pix (B, HW, 5) float32 (L, a, b, y, x); centers (B, K, 5) float32;
// prev, out (B, HW) int32. All contiguous, on the current device.
CMT_EXPORT int slic_assign(const float* pix, const float* centers,
                           const int* prev, int* out, int batch, int hw,
                           int k_count, float ratio, int step, void* stream) {
  const size_t smem = static_cast<size_t>(k_count) * 7 * sizeof(float);
  int rc = cmt_set_smem(slic_assign_kernel, smem);
  if (rc != 0) return rc;
  dim3 grid((hw + kThreads - 1) / kThreads, batch);
  slic_assign_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      pix, centers, prev, out, hw, k_count, ratio, step);
  CMT_CHECK_LAUNCH();
  return 0;
}
