// Fused multi-head cross-attention forward with head-averaged probabilities.
//
// Replaces the Pallas kernel camouflage_multimodal_tpu/ops/pallas_attention.py
// (_mha_kernel, launched by pallas_multihead_attention). Same function:
//   Q = q Wq + bq, K = k Wk + bk, V = v Wv + bv           (W applied as x @ W)
//   per head h: P_h = softmax(scale * Q_h K_h^T, masked keys at -1e30)
//   out = concat_h(P_h V_h) Wo + bo,   probs = mean_h P_h
// in float32 on the CUDA cores (no TF32, no tensor cores yet).
//
// Bound on this card: at the main path's shapes (E = 256, 8 heads of 32;
// rg2kg Nq = 640, Nk = 13 and kg2rg Nq = 13, Nk = 640) the four E x E
// projections are ~95% of the ~0.18 GFLOP per image and direction, and the
// few MB of operands fit in L2: the kernel is bound by float32 operations.
// Design: three launches from one wrapper call, all on the caller's stream.
//   1. proj_kernel, blockIdx.z in {Q, K, V}: a 64x64-tiled float32 GEMM
//      with 16-deep shared-memory stages, 4x4 outputs per thread, bias fused.
//   2. attn_kernel: one block per (query row, batch row), one warp per
//      head. Lane j owns keys j, j+32, ...: it computes their logits
//      against the scaled query row staged in shared memory, the warp
//      reduces max and sum by shuffles and keeps its head's probabilities
//      in a shared-memory row; P V runs lane-per-output-dim over the head's
//      (at most 32) dims. After one barrier the block averages the heads'
//      rows in head order (no atomics). Works for any Nk (13 or 640) in one
//      pass: E + heads * Nk floats of shared memory. A warp per head, not
//      per query, keeps kg2rg (only B * 13 query rows) at 8 warps a row.
//   3. proj_kernel on the head-concatenated context with Wo, bo.
// Masking sets a masked logit to -1e30 (not -inf) exactly as the plain
// version does, so a row whose keys are all masked gets uniform weights.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kProjThreads = 256;

struct ProjBatch {
  const float* x[3];
  const float* w[3];
  const float* bias[3];
  float* y[3];
  int rows[3];
};

// y (rows, n) = x (rows, depth) @ w (depth, n) + bias (n); row-major.
__global__ void proj_kernel(ProjBatch args, int depth, int n) {
  const int z = blockIdx.z;
  const int rows = args.rows[z];
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  if (row0 >= rows) return;
  const float* __restrict__ x = args.x[z];
  const float* __restrict__ w = args.w[z];

  __shared__ float xs[kDepth][kTile + 4];
  __shared__ float ws[kDepth][kTile];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < depth; k0 += kDepth) {
    for (int i = threadIdx.x; i < kTile * kDepth; i += kProjThreads) {
      const int r = i / kDepth, kk = i % kDepth;
      const int gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < rows && gk < depth) ? x[static_cast<size_t>(gr) * depth + gk] : 0.f;
    }
    for (int i = threadIdx.x; i < kDepth * kTile; i += kProjThreads) {
      const int kk = i / kTile, c = i % kTile;
      const int gk = k0 + kk, gc = col0 + c;
      ws[kk][c] = (gk < depth && gc < n) ? w[static_cast<size_t>(gk) * n + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float xr[4], wr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xr[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wr[j] = ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xr[i] * wr[j];
    }
    __syncthreads();
  }

  const float* __restrict__ bias = args.bias[z];
  float* __restrict__ y = args.y[z];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < n) y[static_cast<size_t>(r) * n + c] = acc[i][j] + bias[c];
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// qp (B, Nq, E), kp/vp (B, Nk, E) projected; mask (B, Nk) bytes, 1 = valid.
// ctx (B, Nq, E) head-concatenated P V; probs (B, Nq, Nk) head mean of P.
// One block per (query, batch row), one warp per head (blockDim = 32 heads).
__global__ void attn_kernel(const float* __restrict__ qp,
                            const float* __restrict__ kp,
                            const float* __restrict__ vp,
                            const unsigned char* __restrict__ mask,
                            float* __restrict__ ctx, float* __restrict__ probs,
                            int nq, int nk, int e, int heads, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;       // (E,) the scaled query row
  float* p = smem + e;    // (heads, Nk) each head's probabilities
  const int h = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x;
  const int b = blockIdx.y;
  const size_t qrow = static_cast<size_t>(b) * nq + q;
  for (int i = threadIdx.x; i < e; i += blockDim.x) qs[i] = qp[qrow * e + i] * scale;
  __syncthreads();

  const int hd = e / heads;
  const unsigned char* mb = mask + static_cast<size_t>(b) * nk;
  const float* kb = kp + static_cast<size_t>(b) * nk * e + h * hd;
  const float* vb = vp + static_cast<size_t>(b) * nk * e + h * hd;
  const float* qh = qs + h * hd;
  float* ph = p + static_cast<size_t>(h) * nk;

  float m = -INFINITY;
  for (int j = lane; j < nk; j += 32) {
    float s = -1e30f;
    if (mb[j]) {
      const float* kr = kb + static_cast<size_t>(j) * e;
      s = 0.f;
      for (int d = 0; d < hd; ++d) s += qh[d] * kr[d];
    }
    ph[j] = s;
    m = fmaxf(m, s);
  }
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < nk; j += 32) {
    const float ex = expf(ph[j] - m);
    ph[j] = ex;
    sum += ex;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < nk; j += 32) ph[j] = ph[j] / sum;
  __syncwarp();
  for (int d = lane; d < hd; d += 32) {
    float o = 0.f;
    for (int j = 0; j < nk; ++j) o += ph[j] * vb[static_cast<size_t>(j) * e + d];
    ctx[qrow * e + h * hd + d] = o;
  }

  // Head mean of the probabilities, summed in head order, no atomics.
  __syncthreads();
  for (int j = threadIdx.x; j < nk; j += blockDim.x) {
    float acc = 0.f;
    for (int g = 0; g < heads; ++g) acc += p[static_cast<size_t>(g) * nk + j];
    probs[qrow * nk + j] = acc / static_cast<float>(heads);
  }
}

}  // namespace

CMT_DEFINE_ERROR_STRING

// q (B, Nq, E), k/v (B, Nk, E), mask (B, Nk) bool; w* (E, E) applied as
// x @ w, b* (E,). Scratch qp (B, Nq, E), kp/vp (B, Nk, E), ctx (B, Nq, E);
// outputs out (B, Nq, E), probs (B, Nq, Nk). All float32 except the mask.
CMT_EXPORT int fused_mha(const float* q, const float* k, const float* v,
                         const unsigned char* mask, const float* wq,
                         const float* bq, const float* wk, const float* bk,
                         const float* wv, const float* bv, const float* wo,
                         const float* bo, float* qp, float* kp, float* vp,
                         float* ctx, float* out, float* probs, int batch,
                         int nq, int nk, int e, int heads, float scale,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rq = batch * nq, rk = batch * nk;
  const int max_rows = rq > rk ? rq : rk;

  ProjBatch qkv{{q, k, v}, {wq, wk, wv}, {bq, bk, bv}, {qp, kp, vp}, {rq, rk, rk}};
  dim3 grid_qkv((e + kTile - 1) / kTile, (max_rows + kTile - 1) / kTile, 3);
  proj_kernel<<<grid_qkv, kProjThreads, 0, stream>>>(qkv, e, e);
  CMT_CHECK_LAUNCH();

  const size_t smem = (static_cast<size_t>(e) + static_cast<size_t>(heads) * nk) * sizeof(float);
  int rc = cmt_set_smem(attn_kernel, smem);
  if (rc != 0) return rc;
  dim3 grid_attn(nq, batch);
  attn_kernel<<<grid_attn, heads * 32, smem, stream>>>(
      qp, kp, vp, mask, ctx, probs, nq, nk, e, heads, scale);
  CMT_CHECK_LAUNCH();

  ProjBatch o{{ctx, nullptr, nullptr}, {wo, nullptr, nullptr},
              {bo, nullptr, nullptr}, {out, nullptr, nullptr}, {rq, 0, 0}};
  dim3 grid_o((e + kTile - 1) / kTile, (rq + kTile - 1) / kTile, 1);
  proj_kernel<<<grid_o, kProjThreads, 0, stream>>>(o, e, e);
  CMT_CHECK_LAUNCH();
  return 0;
}
