// Backward of the fused multi-head cross-attention (fused_mha.cu).
//
// Replaces the custom VJP of the Pallas kernel,
// camouflage_multimodal_tpu/ops/pallas_attention.py
// (pallas_multihead_attention_trainable / _pallas_mha_bwd), which recomputes
// the attention through the plain JAX version and differentiates that. Same
// function: with Qp = q Wq + bq, Kp, Vp, ctx saved by the forward,
// s = 1/sqrt(hd) and cotangents d_out (B, Nq, E), d_probs (B, Nq, Nk):
//   d_bo = sum d_out,  d_Wo = ctx^T d_out,  d_ctx = d_out Wo^T
//   per head h: P_h = softmax(s Qp_h Kp_h^T, masked keys at -1e30)  (recomputed)
//     dP_h = d_ctx_h Vp_h^T + d_probs / H,   dVp_h = P_h^T d_ctx_h
//     dS_h = P_h * (dP_h - rowsum(dP_h * P_h)), 0 at masked keys
//     dQp_h = s dS_h Kp_h,   dKp_h = s dS_h^T Qp_h
//   d_Wq = q^T dQp, d_bq = sum dQp, d_q = dQp Wq^T; the same for k and v.
// All float32 on the CUDA cores (no TF32, no tensor cores yet).
//
// Bound on this card: at the training shapes (B = 4, E = 256, 8 heads of
// 32; rg2kg Nq = 576, Nk = 13 and kg2rg Nq = 13, Nk = 576) the eight
// E x E products per direction are ~95% of the ~2.5 GFLOP, and the few MB
// of operands fit in L2: the kernel is bound by float32 operations.
// Design: seven launches from one wrapper call, all on the caller's
// stream, every sum in a fixed order (no floating-point atomics), so two
// runs on the same inputs are bit-equal.
//   1. gemm_kernel (x W^T form): d_ctx = d_out Wo^T.
//   2. attn_bwd_query_kernel: one block per (query row, batch row), one warp
//      per head, as the forward. Recomputes the head's probabilities in
//      shared memory with the forward's own arithmetic, takes dP, the row
//      sum and dS, writes P_h and dS_h to scratch (B, H, Nq, Nk) for the
//      per-key pass, and reduces dQp over the keys, lane per output dim.
//   3. attn_bwd_key_kernel: dKp and dVp reduce over the queries, so this
//      pass takes one block per (key, batch row): warp (head, split) walks
//      every splits-th query, lane per output dim; the splits' partial sums
//      meet in shared memory and are added in split order. rg2kg has 13
//      keys and 576 queries, kg2rg the reverse: neither pass ever
//      parallelises over the short axis alone.
//   4. gemm_kernel (x W^T form), three products in one launch: d_q, d_k, d_v.
//   5. gemm_kernel (x^T dy form), four products in one launch, each split
//      over the rows into `weight_splits` partial E x E sums in scratch
//      (16 tiles of 64 x 64 per product would leave most SMs idle);
//   6. sum_splits_kernel adds the partials in split order: d_Wq, d_Wk,
//      d_Wv, d_Wo.
//   7. colsum_kernel: d_bq, d_bk, d_bv, d_bo.
// A masked logit gets no gradient: dS is set to 0 at masked keys, which
// P = 0 does for a partly masked row but not for a row whose keys are all
// masked (uniform P, as in the forward and the plain version).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kGemmThreads = 256;
constexpr int kMaxBatch = 4;

// Up to four products y = A B of one launch. A(r, k) = a[r * a_rs + k * a_ks],
// B(k, c) = b[k * b_ks + c * b_cs]; y (m, n) row-major. The reduction runs
// over `depth`, split into `splits` contiguous chunks: chunk s of product z
// is written to y[z] + s * m * n.
struct GemmBatch {
  const float* a[kMaxBatch];
  const float* b[kMaxBatch];
  float* y[kMaxBatch];
  int m[kMaxBatch];
  int depth[kMaxBatch];
};

__global__ void gemm_kernel(GemmBatch args, int n, int splits, int a_rs,
                            int a_ks, int b_ks, int b_cs) {
  const int z = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int m = args.m[z];
  const int depth = args.depth[z];
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  if (row0 >= m) return;
  const float* __restrict__ a = args.a[z];
  const float* __restrict__ b = args.b[z];
  int chunk = (depth + splits - 1) / splits;
  chunk = (chunk + kDepth - 1) / kDepth * kDepth;
  const int k_begin = split * chunk;
  const int k_end = min(depth, k_begin + chunk);

  __shared__ float as[kDepth][kTile + 4];
  __shared__ float bs[kDepth][kTile];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int k0 = k_begin; k0 < k_end; k0 += kDepth) {
    // Neighbouring threads read neighbouring addresses along whichever
    // index is contiguous in memory.
    for (int i = threadIdx.x; i < kTile * kDepth; i += kGemmThreads) {
      const int r = (a_ks == 1) ? i / kDepth : i % kTile;
      const int kk = (a_ks == 1) ? i % kDepth : i / kTile;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k_end)
                      ? a[static_cast<size_t>(gr) * a_rs + static_cast<size_t>(gk) * a_ks]
                      : 0.f;
    }
    for (int i = threadIdx.x; i < kDepth * kTile; i += kGemmThreads) {
      const int kk = (b_cs == 1) ? i / kTile : i % kDepth;
      const int c = (b_cs == 1) ? i % kTile : i / kDepth;
      const int gk = k0 + kk, gc = col0 + c;
      bs[kk][c] = (gk < k_end && gc < n)
                      ? b[static_cast<size_t>(gk) * b_ks + static_cast<size_t>(gc) * b_cs]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float ar[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * br[j];
    }
    __syncthreads();
  }

  float* __restrict__ y = args.y[z] + static_cast<size_t>(split) * m * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < n) y[static_cast<size_t>(r) * n + c] = acc[i][j];
    }
  }
}

struct SumBatch {
  const float* part[kMaxBatch];   // (splits, count)
  float* y[kMaxBatch];            // (count,)
};

// y[i] = sum over the splits, in split order, of part[s][i].
__global__ void sum_splits_kernel(SumBatch args, int count, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const float* __restrict__ part = args.part[blockIdx.y];
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[static_cast<size_t>(s) * count + i];
  args.y[blockIdx.y][i] = acc;
}

struct ColBatch {
  const float* x[kMaxBatch];   // (rows, n)
  float* y[kMaxBatch];         // (n,)
  int rows[kMaxBatch];
};

// y[c] = sum over the rows of x[r][c]: blockDim (32, 32), thread row ty sums
// rows ty, ty + 32, ...; the 32 partial sums are added in ty order.
__global__ void __launch_bounds__(1024) colsum_kernel(ColBatch args, int n) {
  __shared__ float part[32][33];
  const int z = blockIdx.y;
  const int rows = args.rows[z];
  const float* __restrict__ x = args.x[z];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (c < n)
    for (int r = threadIdx.y; r < rows; r += 32) acc += x[static_cast<size_t>(r) * n + c];
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
    float total = 0.f;
    for (int i = 0; i < 32; ++i) total += part[i][threadIdx.x];
    args.y[z][c] = total;
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

// qp, d_ctx (B, Nq, E); kp, vp (B, Nk, E); mask (B, Nk) bytes, 1 = valid;
// d_probs (B, Nq, Nk) or null. Writes p_heads, ds_heads (B, H, Nq, Nk) and
// d_qp (B, Nq, E). One block per (query, batch row), one warp per head.
__global__ void attn_bwd_query_kernel(const float* __restrict__ qp,
                                      const float* __restrict__ kp,
                                      const float* __restrict__ vp,
                                      const unsigned char* __restrict__ mask,
                                      const float* __restrict__ d_ctx,
                                      const float* __restrict__ d_probs,
                                      float* __restrict__ p_heads,
                                      float* __restrict__ ds_heads,
                                      float* __restrict__ d_qp,
                                      int nq, int nk, int e, int heads, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                                     // (E,) the scaled query row
  float* gs = smem + e;                                 // (E,) its d_ctx row
  float* p = smem + 2 * e;                              // (heads, Nk) probabilities
  float* ds = p + static_cast<size_t>(heads) * nk;      // (heads, Nk) dP, then dS
  const int h = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x;
  const int b = blockIdx.y;
  const size_t qrow = static_cast<size_t>(b) * nq + q;
  for (int i = threadIdx.x; i < e; i += blockDim.x) {
    qs[i] = qp[qrow * e + i] * scale;
    gs[i] = d_ctx[qrow * e + i];
  }
  __syncthreads();

  const int hd = e / heads;
  const unsigned char* mb = mask + static_cast<size_t>(b) * nk;
  const float* kb = kp + static_cast<size_t>(b) * nk * e + h * hd;
  const float* vb = vp + static_cast<size_t>(b) * nk * e + h * hd;
  const float* qh = qs + h * hd;
  const float* gh = gs + h * hd;
  float* ph = p + static_cast<size_t>(h) * nk;
  float* dsh = ds + static_cast<size_t>(h) * nk;

  // The head's probabilities, with the forward's arithmetic.
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

  // dP = d_ctx_h Vp_h^T + d_probs / H and the row sum of dP * P.
  const float* dpr = d_probs ? d_probs + qrow * nk : nullptr;
  const float inv_heads = 1.f / static_cast<float>(heads);
  float dot = 0.f;
  for (int j = lane; j < nk; j += 32) {
    const float pj = ph[j] / sum;
    ph[j] = pj;
    const float* vr = vb + static_cast<size_t>(j) * e;
    float dp = 0.f;
    for (int d = 0; d < hd; ++d) dp += gh[d] * vr[d];
    if (dpr) dp += dpr[j] * inv_heads;
    dsh[j] = dp;
    dot += dp * pj;
  }
  dot = warp_sum(dot);

  const size_t base = ((static_cast<size_t>(b) * heads + h) * nq + q) * nk;
  for (int j = lane; j < nk; j += 32) {
    const float pj = ph[j];
    const float g = mb[j] ? pj * (dsh[j] - dot) : 0.f;
    dsh[j] = g;
    p_heads[base + j] = pj;
    ds_heads[base + j] = g;
  }
  __syncwarp();
  for (int d = lane; d < hd; d += 32) {
    float acc = 0.f;
    for (int j = 0; j < nk; ++j) acc += dsh[j] * kb[static_cast<size_t>(j) * e + d];
    d_qp[qrow * e + h * hd + d] = acc * scale;
  }
}

// d_kp[b, j, h, :] = scale * sum_q ds_heads[b, h, q, j] * qp[b, q, h, :]
// d_vp[b, j, h, :] =         sum_q p_heads[b, h, q, j] * d_ctx[b, q, h, :]
// One block per (key, batch row); warp (split, head) sums queries split,
// split + splits, ...; lane per output dim (head dims <= 32).
__global__ void __launch_bounds__(1024) attn_bwd_key_kernel(const float* __restrict__ qp,
                                    const float* __restrict__ d_ctx,
                                    const float* __restrict__ p_heads,
                                    const float* __restrict__ ds_heads,
                                    float* __restrict__ d_kp,
                                    float* __restrict__ d_vp,
                                    int nq, int nk, int e, int heads,
                                    int splits, float scale) {
  extern __shared__ float part[];   // (splits, heads, 2, 32)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = warp % heads;
  const int split = warp / heads;
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int hd = e / heads;

  float dk = 0.f, dv = 0.f;
  if (lane < hd) {
    const size_t base = (static_cast<size_t>(b) * heads + h) * nq * nk + j;
    for (int q = split; q < nq; q += splits) {
      const float pj = p_heads[base + static_cast<size_t>(q) * nk];
      const float dsj = ds_heads[base + static_cast<size_t>(q) * nk];
      const size_t row = (static_cast<size_t>(b) * nq + q) * e + h * hd + lane;
      dv += pj * d_ctx[row];
      dk += dsj * qp[row];
    }
  }
  float* mine = part + (static_cast<size_t>(split) * heads + h) * 64;
  mine[lane] = dk;
  mine[32 + lane] = dv;
  __syncthreads();
  if (split == 0 && lane < hd) {
    float dk_sum = 0.f, dv_sum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* theirs = part + (static_cast<size_t>(s) * heads + h) * 64;
      dk_sum += theirs[lane];
      dv_sum += theirs[32 + lane];
    }
    const size_t out = (static_cast<size_t>(b) * nk + j) * e + h * hd + lane;
    d_kp[out] = dk_sum * scale;
    d_vp[out] = dv_sum;
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

CMT_DEFINE_ERROR_STRING

// Inputs: q (B, Nq, E), k/v (B, Nk, E), mask (B, Nk) bool, w* (E, E) applied
// as x @ w; qp, kp, vp, ctx as the forward wrote them; d_out (B, Nq, E);
// d_probs (B, Nq, Nk) or null. Scratch: d_ctx, d_qp (B, Nq, E); d_kp, d_vp
// (B, Nk, E); p_heads, ds_heads (B, H, Nq, Nk); w_partial (4, weight_splits,
// E, E). Outputs: d_q, d_k, d_v and the eight parameter gradients. All
// float32 except the mask. heads * key_splits <= 32.
CMT_EXPORT int fused_mha_bwd(
    const float* q, const float* k, const float* v, const unsigned char* mask,
    const float* wq, const float* wk, const float* wv, const float* wo,
    const float* qp, const float* kp, const float* vp, const float* ctx,
    const float* d_out, const float* d_probs,
    float* d_ctx, float* d_qp, float* d_kp, float* d_vp, float* p_heads,
    float* ds_heads, float* w_partial,
    float* d_q, float* d_k, float* d_v, float* d_wq, float* d_bq, float* d_wk,
    float* d_bk, float* d_wv, float* d_bv, float* d_wo, float* d_bo,
    int batch, int nq, int nk, int e, int heads, int key_splits,
    int weight_splits, float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rq = batch * nq, rk = batch * nk;
  const int max_rows = rq > rk ? rq : rk;
  const int e_tiles = ceil_div(e, kTile);

  // 1. d_ctx = d_out Wo^T: A = d_out (rq, E), B(k, c) = wo[c * E + k].
  GemmBatch g_ctx{{d_out}, {wo}, {d_ctx}, {rq}, {e}};
  gemm_kernel<<<dim3(e_tiles, ceil_div(rq, kTile), 1), kGemmThreads, 0, stream>>>(
      g_ctx, e, 1, e, 1, 1, e);
  CMT_CHECK_LAUNCH();

  // 2. Per query row: P, dS, d_qp.
  const size_t smem_q = 2 * (static_cast<size_t>(e) + static_cast<size_t>(heads) * nk) * sizeof(float);
  int rc = cmt_set_smem(attn_bwd_query_kernel, smem_q);
  if (rc != 0) return rc;
  attn_bwd_query_kernel<<<dim3(nq, batch), heads * 32, smem_q, stream>>>(
      qp, kp, vp, mask, d_ctx, d_probs, p_heads, ds_heads, d_qp, nq, nk, e,
      heads, scale);
  CMT_CHECK_LAUNCH();

  // 3. Per key: d_kp, d_vp.
  const size_t smem_k = static_cast<size_t>(key_splits) * heads * 64 * sizeof(float);
  attn_bwd_key_kernel<<<dim3(nk, batch), key_splits * heads * 32, smem_k, stream>>>(
      qp, d_ctx, p_heads, ds_heads, d_kp, d_vp, nq, nk, e, heads, key_splits, scale);
  CMT_CHECK_LAUNCH();

  // 4. d_q = d_qp Wq^T, d_k = d_kp Wk^T, d_v = d_vp Wv^T.
  GemmBatch g_in{{d_qp, d_kp, d_vp}, {wq, wk, wv}, {d_q, d_k, d_v},
                 {rq, rk, rk}, {e, e, e}};
  gemm_kernel<<<dim3(e_tiles, ceil_div(max_rows, kTile), 3), kGemmThreads, 0, stream>>>(
      g_in, e, 1, e, 1, 1, e);
  CMT_CHECK_LAUNCH();

  // 5. Partial x^T dy sums: A(i, r) = x[r * E + i], B(r, c) = dy[r * E + c].
  const size_t ee = static_cast<size_t>(e) * e;
  float* part[4];
  for (int i = 0; i < 4; ++i) part[i] = w_partial + i * weight_splits * ee;
  GemmBatch g_w{{q, k, v, ctx}, {d_qp, d_kp, d_vp, d_out},
                {part[0], part[1], part[2], part[3]}, {e, e, e, e},
                {rq, rk, rk, rq}};
  gemm_kernel<<<dim3(e_tiles, e_tiles, 4 * weight_splits), kGemmThreads, 0, stream>>>(
      g_w, e, weight_splits, 1, e, e, 1);
  CMT_CHECK_LAUNCH();

  // 6. The weight gradients: partials added in split order.
  SumBatch sums{{part[0], part[1], part[2], part[3]}, {d_wq, d_wk, d_wv, d_wo}};
  sum_splits_kernel<<<dim3(ceil_div(static_cast<int>(ee), 256), 4), 256, 0, stream>>>(
      sums, static_cast<int>(ee), weight_splits);
  CMT_CHECK_LAUNCH();

  // 7. The bias gradients.
  ColBatch cols{{d_qp, d_kp, d_vp, d_out}, {d_bq, d_bk, d_bv, d_bo}, {rq, rk, rk, rq}};
  colsum_kernel<<<dim3(ceil_div(e, 32), 4), dim3(32, 32), 0, stream>>>(cols, e);
  CMT_CHECK_LAUNCH();
  return 0;
}
