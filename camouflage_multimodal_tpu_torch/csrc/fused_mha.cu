// Fused multi-head cross-attention forward with head-averaged probabilities.
//
// Replaces the Pallas kernel camouflage_multimodal_tpu/ops/pallas_attention.py
// (_mha_kernel, launched by pallas_multihead_attention). Same function:
//   Q = q Wq + bq, K = k Wk + bk, V = v Wv + bv           (W applied as x @ W)
//   per head h: P_h = softmax(scale * Q_h K_h^T, masked keys at -1e30)
//   out = concat_h(P_h V_h) Wo + bo,   probs = mean_h P_h
// at float32 accuracy. The weights may be rectangular: Wq, Wk, Wv
// (E_in, E_loc) and Wo (E_loc, E_out) with E_loc = heads * hd, which is how
// a rank of the tensor-parallel fusion holds its share of the heads
// (parallel/sharding.py): then bo may be null (the caller adds it once
// after summing the ranks' outputs) and probs is the sum over this call's
// heads divided by total_heads, the heads of all ranks together. With
// square weights and total_heads == heads this is the function above. Q,
// K, V and the head-concatenated context are written out as well: the
// backward kernel (fused_mha_bwd.cu) reads them.
//
// Bound on this card: at the main path's shapes (E = 256, 8 heads of 32;
// rg2kg Nq = 640, Nk = 13 and kg2rg Nq = 13, Nk = 640, batch 4) the four
// E x E projections are ~95% of the ~0.18 GFLOP per image and direction and
// the few MB of operands sit in L2, so the work is bound by operations; at
// that size the chain of dependent launches and the number of blocks each
// one gives the 132 SMs decide the time. Design, all on the caller's stream:
//   1. proj_kernel: Q, K and V projections in one launch over a flat index
//      of 32 x BN output tiles (only tiles that have rows exist), each tile
//      a 3xTF32 tensor-core GEMM fed by cp.async (gemm_3xtf32.cuh), bias
//      fused. BN is 64, or 32 when 64 would leave SMs without a tile (the
//      52-row operands of kg2rg).
//   2. the attention pass, one of two kernels chosen by the number of keys:
//      - attn_short_kernel (Nk <= 32, rg2kg): a block stages the projected
//        keys and values of one batch row in shared memory once (16-byte
//        loads) and serves 8 query rows, one per warp. The 13 keys x 8 heads
//        of a row are 104 (key, head) pairs: a lane takes a pair and walks
//        its 32-long dot product, so the 32 lanes are busy whatever Nk is
//        (key rows are padded to hd + 1 floats per head, which puts the 32
//        pairs of a round on 32 different banks). The logits of all heads
//        sit in a per-warp shared row; a lane per head takes max, exp, sum
//        and quotient over its keys; P V runs with a lane per head
//        dimension, and a lane per key sums the head mean in head order. No
//        shuffle, no block barrier after the staging, no atomics.
//      - attn_chunk_kernel + attn_combine_kernel (Nk > 32, kg2rg): the keys
//        are split into chunks of 64; a block owns (chunk, 16 query rows,
//        batch row, head), stages that head's slice of the chunk's keys and
//        values (16-byte loads, key rows padded to 33 floats against bank
//        conflicts) and writes the chunk's unnormalised exponentials, its
//        running max and sum, and its partial P V. 13 query rows x 640 keys
//        x batch 4 give 320 blocks instead of 52. The combine kernel (a
//        block per query row) rescales the chunks in chunk order, normalises,
//        writes the context and sums the head mean in head order. It also
//        writes each (head, query row)'s softmax max and sum: with them the
//        backward kernel's key chunks work alone.
//   3. proj_kernel on the context with Wo, bo.
// Masking sets a masked logit to -1e30 (not -inf) exactly as the plain
// version does, so a row whose keys are all masked gets uniform weights; in
// the chunked pass a fully masked chunk rescales to exp(-1e30 - max) = 0
// beside a live one and to 1 when every chunk is masked.

#include <math.h>

#include "common.cuh"
#include "gemm_3xtf32.cuh"

namespace {

constexpr int kSMs = 132;           // of an H100: below this many 64-wide tiles, take 32-wide ones
constexpr int kShortKeys = 32;      // attn_short_kernel: one key per lane
constexpr int kShortRows = 8;       // query rows of one attn_short_kernel block: one per warp
constexpr int kShortThreads = 256;
constexpr int kChunk = 64;          // keys of one attn_chunk_kernel block
constexpr int kChunkRows = 16;      // query rows of one attn_chunk_kernel block
constexpr int kChunkThreads = 128;
constexpr int kCombineThreads = 256;
constexpr int kMaxHeadDim = 32;

struct ProjBatch {
  const float* x[3];
  const float* w[3];
  const float* bias[3];
  float* y[3];
  int rows[3];
  int count;
};

// y[z] (rows[z], n) = x[z] (rows[z], depth) @ w[z] (depth, n) + bias[z] for
// z < count; blockIdx.x is a flat index over the operands' output tiles.
template <int BN>
__global__ void __launch_bounds__(gemm3::kThreads) proj_kernel(ProjBatch args, int depth, int n) {
  __shared__ __align__(16) gemm3::Smem<BN> smem;
  const int tiles_n = (n + BN - 1) / BN;
  int t = blockIdx.x;
  int z = 0;
  for (; z < args.count - 1; ++z) {
    const int tz = ((args.rows[z] + gemm3::kBM - 1) / gemm3::kBM) * tiles_n;
    if (t < tz) break;
    t -= tz;
  }
  gemm3::tile<BN>(smem, args.x[z], args.w[z], args.bias[z], args.y[z], args.rows[z], depth, n,
                  (t / tiles_n) * gemm3::kBM, (t % tiles_n) * BN);
}

int proj_tiles(const ProjBatch& args, int n, int bn) {
  int total = 0;
  for (int z = 0; z < args.count; ++z)
    total += ((args.rows[z] + gemm3::kBM - 1) / gemm3::kBM) * ((n + bn - 1) / bn);
  return total;
}

int launch_proj(const ProjBatch& args, int depth, int n, cudaStream_t stream) {
  if (proj_tiles(args, n, 64) >= kSMs) {
    proj_kernel<64><<<proj_tiles(args, n, 64), gemm3::kThreads, 0, stream>>>(args, depth, n);
  } else {
    proj_kernel<32><<<proj_tiles(args, n, 32), gemm3::kThreads, 0, stream>>>(args, depth, n);
  }
  CMT_CHECK_LAUNCH();
  return 0;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Floats of attn_short_kernel's shared memory: values (Nk, E), keys
// (Nk, heads, hd + 1), and per warp a scaled query row (heads, hd + 1) and
// the logits / probabilities (Nk, heads).
size_t short_smem_floats(int nk, int e, int heads) {
  const size_t padded = static_cast<size_t>(heads) * (e / heads + 1);
  return static_cast<size_t>(nk) * e + nk * padded +
         (kShortThreads / 32) * (padded + static_cast<size_t>(nk) * heads);
}

// Nk <= 32. qp (B, Nq, E), kp/vp (B, Nk, E) projected; mask (B, Nk) bytes,
// 1 = valid. ctx (B, Nq, E) head-concatenated P V; probs (B, Nq, Nk) head
// mean of P. Grid (query-row groups, batch rows); a warp per query row.
__global__ void __launch_bounds__(kShortThreads)
attn_short_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                  const float* __restrict__ vp, const unsigned char* __restrict__ mask,
                  float* __restrict__ ctx, float* __restrict__ probs, int nq, int nk, int e,
                  int heads, int total_heads, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int hd = e / heads, hp = hd + 1;   // hp odd: (key, head) rows fall on 32 banks
  const int padded = heads * hp, pairs = nk * heads;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* vs = smem;                        // (Nk, E)
  float* ks = vs + nk * e;                 // (Nk, heads, hp)
  float* qw = ks + nk * padded + warp * (padded + pairs);   // (heads, hp), this warp's
  float* sw = qw + padded;                 // (Nk, heads) logits, then probabilities

  const float4* kg = reinterpret_cast<const float4*>(kp + static_cast<size_t>(b) * nk * e);
  const float4* vg = reinterpret_cast<const float4*>(vp + static_cast<size_t>(b) * nk * e);
  for (int i = threadIdx.x; i < nk * e / 4; i += kShortThreads) {
    reinterpret_cast<float4*>(vs)[i] = vg[i];
    const float4 kv = kg[i];
    const int j = (i * 4) / e, col = (i * 4) % e;    // hd % 4 == 0: one head per float4
    float* dst = ks + j * padded + (col / hd) * hp + col % hd;
    dst[0] = kv.x, dst[1] = kv.y, dst[2] = kv.z, dst[3] = kv.w;
  }
  __syncthreads();

  const bool valid = lane < nk && mask[static_cast<size_t>(b) * nk + lane] != 0;
  const unsigned valid_keys = __ballot_sync(0xffffffffu, valid);
  const int q_end = min(nq, (blockIdx.x + 1) * kShortRows);
  for (int q = blockIdx.x * kShortRows + warp; q < q_end; q += kShortThreads / 32) {
    const size_t qrow = static_cast<size_t>(b) * nq + q;
    for (int i = lane; i < e; i += 32) qw[(i / hd) * hp + i % hd] = qp[qrow * e + i] * scale;
    __syncwarp();
    // Logits: a lane per (key, head) pair, pair = key * heads + head.
    for (int pair = lane; pair < pairs; pair += 32) {
      const float* kr = ks + pair * hp;
      const float* qh = qw + (pair % heads) * hp;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += qh[d] * kr[d];
      sw[pair] = ((valid_keys >> (pair / heads)) & 1u) ? s : -1e30f;
    }
    __syncwarp();
    // Softmax over the keys: a lane per head.
    for (int h = lane; h < heads; h += 32) {
      float m = -INFINITY, sum = 0.f;
      for (int j = 0; j < nk; ++j) m = fmaxf(m, sw[j * heads + h]);
      for (int j = 0; j < nk; ++j) {
        const float ex = expf(sw[j * heads + h] - m);
        sw[j * heads + h] = ex;
        sum += ex;
      }
      for (int j = 0; j < nk; ++j) sw[j * heads + h] /= sum;
    }
    __syncwarp();
    // P V: a lane per head dimension, heads in turn.
    if (lane < hd) {
      for (int h = 0; h < heads; ++h) {
        float o = 0.f;
        for (int j = 0; j < nk; ++j) o += sw[j * heads + h] * vs[j * e + h * hd + lane];
        ctx[qrow * e + h * hd + lane] = o;
      }
    }
    // Head mean of the probabilities, summed in head order: a lane per key.
    if (lane < nk) {
      float mean = 0.f;
      for (int h = 0; h < heads; ++h) mean += sw[lane * heads + h];
      probs[qrow * nk + lane] = mean / static_cast<float>(total_heads);
    }
    __syncwarp();   // before the next row overwrites qw and sw
  }
}

// One chunk of 64 keys of one (batch row, head) against 16 query rows.
// ebuf (B, H, Nq, Nk): exp(logit - chunk max); cmax, csum (B, H, Nq, C): the
// chunk's max and sum of those; cout (B, H, Nq, C, hd): its sum of
// ebuf * V. Grid (chunks, query-row groups, B * H).
__global__ void __launch_bounds__(kChunkThreads)
attn_chunk_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                  const float* __restrict__ vp, const unsigned char* __restrict__ mask,
                  float* __restrict__ ebuf, float* __restrict__ cmax, float* __restrict__ csum,
                  float* __restrict__ cout, int nq, int nk, int e, int heads, float scale) {
  __shared__ float ks[kChunk][kMaxHeadDim + 1];
  __shared__ __align__(16) float vs[kChunk][kMaxHeadDim];
  __shared__ float qs[kChunkRows][kMaxHeadDim];
  __shared__ float ss[kChunkRows][kChunk];
  const int chunk = blockIdx.x, chunks = gridDim.x;
  const int q0 = blockIdx.y * kChunkRows;
  const int b = blockIdx.z / heads, h = blockIdx.z % heads;
  const int hd = e / heads;
  const int j0 = chunk * kChunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Stage the head's slice of the chunk: hd / 4 float4 per key row.
  const int per = hd / 4;
  for (int i = threadIdx.x; i < kChunk * (kMaxHeadDim / 4); i += kChunkThreads) {
    const int j = i / (kMaxHeadDim / 4), c = i % (kMaxHeadDim / 4);
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (j0 + j < nk && c < per) {
      const size_t at = (static_cast<size_t>(b) * nk + j0 + j) * e + h * hd + c * 4;
      kv = *reinterpret_cast<const float4*>(kp + at);
      vv = *reinterpret_cast<const float4*>(vp + at);
    }
    ks[j][c * 4 + 0] = kv.x, ks[j][c * 4 + 1] = kv.y, ks[j][c * 4 + 2] = kv.z, ks[j][c * 4 + 3] = kv.w;
    *reinterpret_cast<float4*>(&vs[j][c * 4]) = vv;
  }
  for (int i = threadIdx.x; i < kChunkRows * kMaxHeadDim; i += kChunkThreads) {
    const int r = i / kMaxHeadDim, d = i % kMaxHeadDim;
    qs[r][d] = (q0 + r < nq && d < hd)
                   ? qp[(static_cast<size_t>(b) * nq + q0 + r) * e + h * hd + d] * scale : 0.f;
  }
  __syncthreads();

  // Logits: thread = (key, half of the query rows).
  {
    const int j = threadIdx.x % kChunk;
    const int r0 = (threadIdx.x / kChunk) * (kChunkRows / 2);
    float s[kChunkRows / 2] = {};
    for (int d = 0; d < hd; ++d) {
      const float kv = ks[j][d];
#pragma unroll
      for (int i = 0; i < kChunkRows / 2; ++i) s[i] += qs[r0 + i][d] * kv;
    }
    const bool exists = j0 + j < nk;
    const bool live = exists && mask[static_cast<size_t>(b) * nk + j0 + j] != 0;
#pragma unroll
    for (int i = 0; i < kChunkRows / 2; ++i)
      ss[r0 + i][j] = live ? s[i] : (exists ? -1e30f : -INFINITY);
  }
  __syncthreads();

  // Per query row: chunk max, exponentials, their sum and their product with V.
  const size_t bh = static_cast<size_t>(b) * heads + h;
  for (int r = warp; r < kChunkRows && q0 + r < nq; r += kChunkThreads / 32) {
    const float s0 = ss[r][lane], s1 = ss[r][lane + 32];
    const float m = warp_max(fmaxf(s0, s1));   // finite: a chunk has a key
    const float e0 = expf(s0 - m), e1 = expf(s1 - m);
    const float sum = warp_sum(e0 + e1);
    ss[r][lane] = e0;
    ss[r][lane + 32] = e1;
    const size_t row = bh * nq + q0 + r;
    if (j0 + lane < nk) ebuf[row * nk + j0 + lane] = e0;
    if (j0 + lane + 32 < nk) ebuf[row * nk + j0 + lane + 32] = e1;
    __syncwarp();
    float o = 0.f;
    for (int j = 0; j < kChunk; ++j) o += ss[r][j] * vs[j][lane];
    const size_t part = row * chunks + chunk;
    if (lane < hd) cout[part * hd + lane] = o;
    if (lane == 0) {
      cmax[part] = m;
      csum[part] = sum;
    }
  }
}

// Joins the chunks of one query row: grid (Nq, B). factor[h][c] =
// exp(cmax - row max) / row sum rescales chunk c of head h. stats
// (B, H, Nq, 2) receives the row max and the row sum.
__global__ void __launch_bounds__(kCombineThreads)
attn_combine_kernel(const float* __restrict__ ebuf, const float* __restrict__ cmax,
                    const float* __restrict__ csum, const float* __restrict__ cout,
                    float* __restrict__ ctx, float* __restrict__ probs,
                    float* __restrict__ stats, int nq, int nk, int e, int heads,
                    int total_heads, int chunks) {
  extern __shared__ float factor[];   // (heads, chunks)
  const int q = blockIdx.x, b = blockIdx.y;
  const int hd = e / heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int h = warp; h < heads; h += kCombineThreads / 32) {
    const size_t part = ((static_cast<size_t>(b) * heads + h) * nq + q) * chunks;
    float m = -INFINITY;
    for (int c = lane; c < chunks; c += 32) m = fmaxf(m, cmax[part + c]);
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < chunks; c += 32) sum += csum[part + c] * expf(cmax[part + c] - m);
    sum = warp_sum(sum);
    for (int c = lane; c < chunks; c += 32) factor[h * chunks + c] = expf(cmax[part + c] - m) / sum;
    if (lane == 0) {
      stats[part / chunks * 2] = m;
      stats[part / chunks * 2 + 1] = sum;
    }
  }
  __syncthreads();

  const size_t qrow = static_cast<size_t>(b) * nq + q;
  for (int i = threadIdx.x; i < e; i += kCombineThreads) {
    const int h = i / hd, d = i % hd;
    const size_t part = ((static_cast<size_t>(b) * heads + h) * nq + q) * chunks;
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) acc += cout[(part + c) * hd + d] * factor[h * chunks + c];
    ctx[qrow * e + i] = acc;
  }
  // Head mean of the probabilities, summed in head order.
  for (int j = threadIdx.x; j < nk; j += kCombineThreads) {
    const int c = j / kChunk;
    float acc = 0.f;
    for (int h = 0; h < heads; ++h)
      acc += ebuf[((static_cast<size_t>(b) * heads + h) * nq + q) * nk + j] * factor[h * chunks + c];
    probs[qrow * nk + j] = acc / static_cast<float>(total_heads);
  }
}

}  // namespace

CMT_DEFINE_ERROR_STRING

// q (B, Nq, E_in), k/v (B, Nk, E_in), mask (B, Nk) bool; wq, wk, wv
// (E_in, E) and wo (E, E_out) applied as x @ w, bq, bk, bv (E,), bo (E_out,)
// or null (no out-projection bias). Written on the way and kept for the
// backward: qp (B, Nq, E), kp/vp (B, Nk, E), ctx (B, Nq, E). Outputs out
// (B, Nq, E_out), probs (B, Nq, Nk): the sum over the heads of P divided by
// total_heads. All float32 except the mask, all 16-byte aligned; E_in, E
// and E_out multiples of 4, (E / heads) % 4 == 0, E / heads <= 32.
// key_chunks == 0 takes the short-key pass (Nk <= 32; attn_scratch unused);
// otherwise it must be ceil(Nk / 64), attn_scratch holds
// B * heads * Nq * (Nk + key_chunks * (2 + E / heads)) floats and stats
// (B, heads, Nq, 2) receives each row's softmax max and sum (kept for the
// backward like qp, kp, vp and ctx).
CMT_EXPORT int fused_mha(const float* q, const float* k, const float* v,
                         const unsigned char* mask, const float* wq,
                         const float* bq, const float* wk, const float* bk,
                         const float* wv, const float* bv, const float* wo,
                         const float* bo, float* qp, float* kp, float* vp,
                         float* ctx, float* out, float* probs,
                         float* attn_scratch, float* stats, int batch, int nq,
                         int nk, int e_in, int e, int e_out,
                         int heads, int total_heads, int key_chunks, float scale,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rq = batch * nq, rk = batch * nk;
  const int hd = e / heads;
  if (e % 4 || e_in % 4 || e_out % 4 || hd % 4 || hd > kMaxHeadDim || hd * heads != e ||
      total_heads < heads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (key_chunks == 0 ? nk > kShortKeys : key_chunks != (nk + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);

  ProjBatch qkv{{q, k, v}, {wq, wk, wv}, {bq, bk, bv}, {qp, kp, vp}, {rq, rk, rk}, 3};
  int rc = launch_proj(qkv, e_in, e, stream);
  if (rc != 0) return rc;

  if (key_chunks == 0) {
    const size_t smem = short_smem_floats(nk, e, heads) * sizeof(float);
    rc = cmt_set_smem(attn_short_kernel, smem);
    if (rc != 0) return rc;
    dim3 grid((nq + kShortRows - 1) / kShortRows, batch);
    attn_short_kernel<<<grid, kShortThreads, smem, stream>>>(qp, kp, vp, mask, ctx, probs, nq,
                                                            nk, e, heads, total_heads, scale);
    CMT_CHECK_LAUNCH();
  } else {
    const size_t rows = static_cast<size_t>(batch) * heads * nq;
    float* ebuf = attn_scratch;
    float* cmax = ebuf + rows * nk;
    float* csum = cmax + rows * key_chunks;
    float* cout = csum + rows * key_chunks;
    dim3 grid(key_chunks, (nq + kChunkRows - 1) / kChunkRows, batch * heads);
    attn_chunk_kernel<<<grid, kChunkThreads, 0, stream>>>(qp, kp, vp, mask, ebuf, cmax, csum,
                                                         cout, nq, nk, e, heads, scale);
    CMT_CHECK_LAUNCH();
    const size_t smem = static_cast<size_t>(heads) * key_chunks * sizeof(float);
    rc = cmt_set_smem(attn_combine_kernel, smem);
    if (rc != 0) return rc;
    attn_combine_kernel<<<dim3(nq, batch), kCombineThreads, smem, stream>>>(
        ebuf, cmax, csum, cout, ctx, probs, stats, nq, nk, e, heads, total_heads, key_chunks);
    CMT_CHECK_LAUNCH();
  }

  ProjBatch o{{ctx, nullptr, nullptr}, {wo, nullptr, nullptr}, {bo, nullptr, nullptr},
              {out, nullptr, nullptr}, {rq, 0, 0}, 1};
  return launch_proj(o, e, e_out, stream);
}
