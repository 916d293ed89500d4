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
// As in the forward the weights may be a rank's share of the heads: Wq, Wk,
// Wv (E_in, E_loc), Wo (E_loc, E_out), and d_probs then joins dP divided by
// total_heads, the heads of all ranks together. d_q, d_k and d_v are this
// rank's partials; the caller sums them over the ranks
// (parallel/sharding.py).
//
// Bound on this card: at the training shapes (B = 4, E = 256, 8 heads of
// 32; rg2kg Nq = 576, Nk = 13 and kg2rg Nq = 13, Nk = 576) the eight
// E x E products per direction are ~95% of the ~2.5 GFLOP, and the few MB
// of operands fit in L2: the kernel is bound by float32 operations, and at
// this size by how many blocks each launch gives the 132 SMs and by the
// chain of dependent launches. Design, five launches from one wrapper call
// (six on the long-key side when d_probs is given), all on the caller's
// stream, every sum in a fixed order (no floating-point atomics), so two
// runs on the same inputs are bit-equal:
//   1. gemm_kernel: one flat grid over the 32 x BN tiles of d_ctx = d_out
//      Wo^T and of the row-chunk partials of d_Wo = ctx^T d_out, each tile
//      a 3xTF32 tensor-core GEMM (gemm_3xtf32.cuh, forms kNT and kTN: no
//      operand is transposed in memory). Weight gradients sum over B * N
//      rows: the rows are cut into chunks of 256, a tile sums one chunk, the
//      chunks' partials are added in chunk order in launch 5. The first row
//      tile of each (chunk, column tile) also sums the chunk's columns of
//      d_out as it streams them through shared memory: d_bo's partials.
//   2. the attention pass, one of two kernels chosen as in the forward:
//      - attn_bwd_short_kernel (Nk <= 32, rg2kg): a block stages the
//        projected keys and values of one batch row in shared memory once
//        and serves 16 query rows, one per warp. A lane takes a (key, head)
//        pair and walks the 32-long dot products of the logit and of dP
//        (rows padded to hd + 1 floats per head: 32 banks); a lane per head
//        takes softmax, row sum and dS over its keys; a lane per head
//        dimension takes dQp. P and dS of the 16 rows stay in shared
//        memory, and the block then reduces dKp and dVp over its rows, a
//        thread per output column; the blocks' partials are added in block
//        order in launch 3. P and dS never reach device memory.
//      - attn_bwd_chunk_kernel (Nk > 32, kg2rg): the keys are split into
//        chunks of 64 and a block owns (chunk, batch row, head), 288 blocks
//        at the training shape instead of 52. A chunk works alone because
//        the forward saved each row's softmax max and sum, and because
//          rowsum(dP * P) = d_ctx_h . ctx_h + (1/H) sum_j d_probs_j P_hj,
//        whose first term needs only the saved context. The second term
//        exists only when d_probs is given: then a first launch of the same
//        kernel (kPre) writes each chunk's share of it. The block walks the
//        query rows in groups of 16, keeps dKp and dVp of its 64 keys in
//        registers across the groups (written once, no partials) and writes
//        its chunk's partial of dQp.
//   3. sum_parts_kernel joins the attention partials in order: dKp, dVp over
//      the blocks (short) or dQp over the key chunks (long).
//   4. gemm_kernel again, one flat grid: d_q = dQp Wq^T, d_k, d_v (kNT) and
//      the row-chunk partials of d_Wq, d_Wk, d_Wv with those of the three
//      bias gradients (kTN).
//   5. sum_parts_kernel adds the row chunks of the four weight and the four
//      bias gradients in chunk order (a gradient with a single chunk was
//      written in place by its tile).
// A masked logit gets no gradient: dS is set to 0 at masked keys, which
// P = 0 does for a partly masked row but not for a row whose keys are all
// masked (uniform P, as in the forward and the plain version).

#include <math.h>

#include "common.cuh"
#include "gemm_3xtf32.cuh"

namespace {

constexpr int kSMs = 132;           // of an H100: below this many 64-wide tiles, take 32-wide ones
constexpr int kRowChunk = 256;      // rows of one partial of a weight gradient
constexpr int kMaxProducts = 6;
constexpr int kMaxSums = 8;
constexpr int kSumThreads = 256;
constexpr int kShortKeys = 32;      // attn_bwd_short_kernel: one key per ballot bit
constexpr int kRows = 16;           // query rows of one group, in both attention kernels
constexpr int kShortThreads = 512;   // 16 warps: one query row of a group each
constexpr int kMaxShortBlocks = 64; // per batch row: bounds the partials of dKp, dVp
constexpr int kChunk = 64;          // keys of one attn_bwd_chunk_kernel block
constexpr int kChunkThreads = 128;
constexpr int kMaxHeadDim = 32;

inline __host__ __device__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Up to six products of one launch. kNT: y (rows, n) = a (rows, inner) @
// b^T, b (n, inner). kTN: chunk s of y (inner, n) = a^T b over the rows
// [s * kRowChunk, ...) of a (rows, inner) and b (rows, n), written to
// y + s * inner * n, and the column sums of those rows of b to
// colsum + s * n.
struct GemmBatch {
  const float* a[kMaxProducts];
  const float* b[kMaxProducts];
  float* y[kMaxProducts];
  float* colsum[kMaxProducts];
  int rows[kMaxProducts];
  int inner[kMaxProducts];
  int n[kMaxProducts];
  int form[kMaxProducts];
  int count;
};

inline __host__ __device__ int product_tiles(const GemmBatch& args, int z, int bn) {
  const int tiles_n = ceil_div(args.n[z], bn);
  if (args.form[z] == gemm3::kNT) return ceil_div(args.rows[z], gemm3::kBM) * tiles_n;
  return ceil_div(args.inner[z], gemm3::kBM) * tiles_n * ceil_div(args.rows[z], kRowChunk);
}

// blockIdx.x is a flat index over the products' tiles: product after product,
// and within a kTN product chunk after chunk.
template <int BN>
__global__ void __launch_bounds__(gemm3::kThreads) gemm_kernel(GemmBatch args) {
  __shared__ __align__(16) gemm3::Smem<BN> smem;
  int t = blockIdx.x;
  int z = 0;
  for (; z < args.count - 1; ++z) {
    const int tz = product_tiles(args, z, BN);
    if (t < tz) break;
    t -= tz;
  }
  const int rows = args.rows[z], inner = args.inner[z], n = args.n[z];
  const int tiles_n = ceil_div(n, BN);
  if (args.form[z] == gemm3::kNT) {
    gemm3::tile_form<BN, gemm3::kNT>(smem, args.a[z], args.b[z], nullptr, args.y[z], rows, n,
                                     (t / tiles_n) * gemm3::kBM, (t % tiles_n) * BN, 0, inner,
                                     nullptr);
  } else {
    const int per_chunk = ceil_div(inner, gemm3::kBM) * tiles_n;
    const int chunk = t / per_chunk;
    t %= per_chunk;
    const int row0 = (t / tiles_n) * gemm3::kBM;
    const int k_begin = chunk * kRowChunk;
    const int k_end = min(rows, k_begin + kRowChunk);
    gemm3::tile_form<BN, gemm3::kTN>(
        smem, args.a[z], args.b[z], nullptr,
        args.y[z] + static_cast<size_t>(chunk) * inner * n, inner, n, row0, (t % tiles_n) * BN,
        k_begin, k_end,
        row0 == 0 && args.colsum[z] ? args.colsum[z] + static_cast<size_t>(chunk) * n : nullptr);
  }
}

int launch_gemm(const GemmBatch& args, cudaStream_t stream) {
  int tiles64 = 0, tiles32 = 0;
  for (int z = 0; z < args.count; ++z) {
    tiles64 += product_tiles(args, z, 64);
    tiles32 += product_tiles(args, z, 32);
  }
  if (tiles64 >= kSMs) {
    gemm_kernel<64><<<tiles64, gemm3::kThreads, 0, stream>>>(args);
  } else {
    gemm_kernel<32><<<tiles32, gemm3::kThreads, 0, stream>>>(args);
  }
  CMT_CHECK_LAUNCH();
  return 0;
}

// y[z][i] = sum over s < splits[z], in that order, of part[z][s * count + i];
// count4[z] = count / 4 (every count here is a multiple of 4 floats).
struct SumBatch {
  const float* part[kMaxSums];
  float* y[kMaxSums];
  int count4[kMaxSums];
  int splits[kMaxSums];
  int entries;
};

// blockIdx.x is a flat index over the entries' groups of kSumThreads float4.
__global__ void __launch_bounds__(kSumThreads) sum_parts_kernel(SumBatch args) {
  int blk = blockIdx.x;
  int z = 0;
  for (; z < args.entries - 1; ++z) {
    const int bz = ceil_div(args.count4[z], kSumThreads);
    if (blk < bz) break;
    blk -= bz;
  }
  const int i = blk * kSumThreads + threadIdx.x;
  const int count4 = args.count4[z];
  if (i >= count4) return;
  const float4* __restrict__ part = reinterpret_cast<const float4*>(args.part[z]);
  float4 acc = part[i];
  for (int s = 1; s < args.splits[z]; ++s) {
    const float4 v = part[static_cast<size_t>(s) * count4 + i];
    acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
  }
  reinterpret_cast<float4*>(args.y[z])[i] = acc;
}

int launch_sums(SumBatch& sums, cudaStream_t stream) {
  int blocks = 0;
  for (int z = 0; z < sums.entries; ++z) blocks += ceil_div(sums.count4[z], kSumThreads);
  if (blocks == 0) return 0;
  sum_parts_kernel<<<blocks, kSumThreads, 0, stream>>>(sums);
  CMT_CHECK_LAUNCH();
  return 0;
}

void add_sum(SumBatch& sums, const float* part, float* y, size_t count, int splits) {
  if (splits <= 1) return;   // written in place
  const int z = sums.entries++;
  sums.part[z] = part;
  sums.y[z] = y;
  sums.count4[z] = static_cast<int>(count / 4);
  sums.splits[z] = splits;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Floats of attn_bwd_short_kernel's shared memory: keys and values (Nk,
// heads, hd + 1) each, and per query row of the group the scaled query and
// its d_ctx row (heads, hd + 1) and P and dS (Nk, heads).
size_t short_smem_floats(int nk, int e, int heads) {
  const size_t padded = static_cast<size_t>(heads) * (e / heads + 1);
  return 2 * nk * padded + kRows * (2 * padded + 2 * static_cast<size_t>(nk) * heads);
}

// Nk <= 32. qp, d_ctx (B, Nq, E); kp, vp (B, Nk, E); mask (B, Nk) bytes,
// 1 = valid; d_probs (B, Nq, Nk) or null. Writes d_qp (B, Nq, E) and the
// block's partial sums of d_kp, d_vp over its query rows to slab blockIdx.x
// of kp_part, vp_part (gridDim.x, B, Nk, E). Grid (blocks, batch rows); block
// x takes the groups of 16 query rows x, x + gridDim.x, ...
__global__ void __launch_bounds__(kShortThreads)
attn_bwd_short_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                      const float* __restrict__ vp, const unsigned char* __restrict__ mask,
                      const float* __restrict__ d_ctx, const float* __restrict__ d_probs,
                      float* __restrict__ d_qp, float* __restrict__ kp_part,
                      float* __restrict__ vp_part, int batch, int nq, int nk, int e, int heads,
                      int total_heads, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int hd = e / heads, hp = hd + 1;   // hp odd: (key, head) rows fall on 32 banks
  const int padded = heads * hp, pairs = nk * heads;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ks = smem;                        // (Nk, heads, hp)
  float* vs = ks + nk * padded;            // (Nk, heads, hp)
  float* qs = vs + nk * padded;            // (kRows, heads, hp) scaled queries
  float* gs = qs + kRows * padded;         // (kRows, heads, hp) d_ctx rows
  float* ps = gs + kRows * padded;         // (kRows, Nk, heads) logits, then P
  float* ds = ps + kRows * pairs;          // (kRows, Nk, heads) dP, then dS

  const float4* kg = reinterpret_cast<const float4*>(kp + static_cast<size_t>(b) * nk * e);
  const float4* vg = reinterpret_cast<const float4*>(vp + static_cast<size_t>(b) * nk * e);
  for (int i = threadIdx.x; i < nk * e / 4; i += kShortThreads) {
    const float4 kv = kg[i], vv = vg[i];
    const int j = (i * 4) / e, col = (i * 4) % e;    // hd % 4 == 0: one head per float4
    const int at = j * padded + (col / hd) * hp + col % hd;
    ks[at] = kv.x, ks[at + 1] = kv.y, ks[at + 2] = kv.z, ks[at + 3] = kv.w;
    vs[at] = vv.x, vs[at + 1] = vv.y, vs[at + 2] = vv.z, vs[at + 3] = vv.w;
  }
  __syncthreads();

  const bool valid = lane < nk && mask[static_cast<size_t>(b) * nk + lane] != 0;
  const unsigned valid_keys = __ballot_sync(0xffffffffu, valid);
  const float inv_heads = 1.f / static_cast<float>(total_heads);
  const size_t slab = (static_cast<size_t>(blockIdx.x) * batch + b) * nk * e;
  bool first = true;
  for (int q0 = blockIdx.x * kRows; q0 < nq; q0 += gridDim.x * kRows) {
    const int rows_here = min(kRows, nq - q0);
    for (int r = warp; r < rows_here; r += kShortThreads / 32) {
      const size_t qrow = static_cast<size_t>(b) * nq + q0 + r;
      float* qw = qs + r * padded;
      float* gw = gs + r * padded;
      float* pw = ps + r * pairs;
      float* dw = ds + r * pairs;
      for (int i = lane; i < e; i += 32) {
        qw[(i / hd) * hp + i % hd] = qp[qrow * e + i] * scale;
        gw[(i / hd) * hp + i % hd] = d_ctx[qrow * e + i];
      }
      __syncwarp();
      // Logits and dP: a lane per (key, head) pair, pair = key * heads + head.
      const float* dpr = d_probs ? d_probs + qrow * nk : nullptr;
      for (int pair = lane; pair < pairs; pair += 32) {
        const float* kr = ks + pair * hp;
        const float* vr = vs + pair * hp;
        const float* qh = qw + (pair % heads) * hp;
        const float* gh = gw + (pair % heads) * hp;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < hd; ++d) {
          s += qh[d] * kr[d];
          dp += gh[d] * vr[d];
        }
        if (dpr) dp += dpr[pair / heads] * inv_heads;
        pw[pair] = ((valid_keys >> (pair / heads)) & 1u) ? s : -1e30f;
        dw[pair] = dp;
      }
      __syncwarp();
      // Softmax with the forward's arithmetic, the row sum and dS: a lane per head.
      for (int h = lane; h < heads; h += 32) {
        float m = -INFINITY, sum = 0.f, dot = 0.f;
        for (int j = 0; j < nk; ++j) m = fmaxf(m, pw[j * heads + h]);
        for (int j = 0; j < nk; ++j) {
          const float ex = expf(pw[j * heads + h] - m);
          pw[j * heads + h] = ex;
          sum += ex;
        }
        for (int j = 0; j < nk; ++j) {
          const float p = pw[j * heads + h] / sum;
          pw[j * heads + h] = p;
          dot += dw[j * heads + h] * p;
        }
        for (int j = 0; j < nk; ++j)
          dw[j * heads + h] = ((valid_keys >> j) & 1u) ? pw[j * heads + h] * (dw[j * heads + h] - dot)
                                                      : 0.f;
      }
      __syncwarp();
      // dQp = scale * dS Kp: a lane per head dimension, heads in turn.
      if (lane < hd) {
        for (int h = 0; h < heads; ++h) {
          float o = 0.f;
          for (int j = 0; j < nk; ++j) o += dw[j * heads + h] * ks[j * padded + h * hp + lane];
          d_qp[qrow * e + h * hd + lane] = o * scale;
        }
      }
    }
    __syncthreads();
    // dKp = dS^T (scale Qp), dVp = P^T d_ctx over the group's rows, in row
    // order: a thread per (key, column).
    for (int idx = threadIdx.x; idx < nk * e; idx += kShortThreads) {
      const int j = idx / e, col = idx % e;
      const int h = col / hd, at = h * hp + col % hd;
      float dk = 0.f, dv = 0.f;
      for (int r = 0; r < rows_here; ++r) {
        dk += ds[r * pairs + j * heads + h] * qs[r * padded + at];
        dv += ps[r * pairs + j * heads + h] * gs[r * padded + at];
      }
      if (first) {
        kp_part[slab + idx] = dk;
        vp_part[slab + idx] = dv;
      } else {   // the same thread added the earlier groups: order is fixed
        kp_part[slab + idx] += dk;
        vp_part[slab + idx] += dv;
      }
    }
    first = false;
    __syncthreads();   // before the next group overwrites the rows
  }
}

// One chunk of 64 keys of one (batch row, head) against every query row, in
// groups of 16. stats (B, H, Nq, 2): the forward's softmax max and sum of
// each row. kPre (launched only when d_probs is given): writes the chunk's
// sum of d_probs * P per row to dpp (B, H, Nq, chunks). Otherwise: reads
// ctx and, when d_probs is given, dpp; writes the chunk's partial of d_qp to
// slab blockIdx.x of qp_part (chunks, B, Nq, E) and the chunk's rows of
// d_kp, d_vp (B, Nk, E). Grid (chunks, B * H).
template <bool kPre>
__global__ void __launch_bounds__(kChunkThreads)
attn_bwd_chunk_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                      const float* __restrict__ vp, const unsigned char* __restrict__ mask,
                      const float* __restrict__ ctx, const float* __restrict__ stats,
                      const float* __restrict__ d_ctx, const float* __restrict__ d_probs,
                      float* __restrict__ dpp, float* __restrict__ qp_part,
                      float* __restrict__ d_kp, float* __restrict__ d_vp, int batch, int nq,
                      int nk, int e, int heads, int total_heads, float scale) {
  __shared__ float ks[kChunk][kMaxHeadDim + 1];
  __shared__ float vs[kChunk][kMaxHeadDim + 1];
  __shared__ float qs[kRows][kMaxHeadDim];
  __shared__ float gs[kRows][kMaxHeadDim];
  __shared__ float ss[kRows][kChunk];    // P
  __shared__ float dss[kRows][kChunk];   // dS
  __shared__ float row_max[kRows], row_sum[kRows], row_dot[kRows];
  const int chunk = blockIdx.x, chunks = gridDim.x;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int hd = e / heads;
  const int j0 = chunk * kChunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t bh = static_cast<size_t>(b) * heads + h;
  const float inv_heads = 1.f / static_cast<float>(total_heads);

  // Stage the head's slice of the chunk: hd / 4 float4 per key row.
  const int per = hd / 4;
  for (int i = threadIdx.x; i < kChunk * (kMaxHeadDim / 4); i += kChunkThreads) {
    const int j = i / (kMaxHeadDim / 4), c = i % (kMaxHeadDim / 4);
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (j0 + j < nk && c < per) {
      const size_t at = (static_cast<size_t>(b) * nk + j0 + j) * e + h * hd + c * 4;
      kv = *reinterpret_cast<const float4*>(kp + at);
      if (!kPre) vv = *reinterpret_cast<const float4*>(vp + at);
    }
    ks[j][c * 4 + 0] = kv.x, ks[j][c * 4 + 1] = kv.y, ks[j][c * 4 + 2] = kv.z, ks[j][c * 4 + 3] = kv.w;
    vs[j][c * 4 + 0] = vv.x, vs[j][c * 4 + 1] = vv.y, vs[j][c * 4 + 2] = vv.z, vs[j][c * 4 + 3] = vv.w;
  }
  // This thread's key in the logit step, and the keys whose dKp, dVp it owns.
  const int jl = threadIdx.x % kChunk;
  const int r0 = (threadIdx.x / kChunk) * (kRows / 2);
  const bool exists = j0 + jl < nk;
  const bool live = exists && mask[static_cast<size_t>(b) * nk + j0 + jl] != 0;
  constexpr int kOwn = kChunk / (kChunkThreads / 32);   // 16 keys per warp
  float dk[kOwn] = {}, dv[kOwn] = {};

  for (int q0 = 0; q0 < nq; q0 += kRows) {
    for (int i = threadIdx.x; i < kRows * kMaxHeadDim; i += kChunkThreads) {
      const int r = i / kMaxHeadDim, d = i % kMaxHeadDim;
      const bool in = q0 + r < nq && d < hd;
      const size_t at = (static_cast<size_t>(b) * nq + q0 + r) * e + h * hd + d;
      qs[r][d] = in ? qp[at] * scale : 0.f;
      if (!kPre) gs[r][d] = in ? d_ctx[at] : 0.f;
    }
    if (threadIdx.x < kRows && q0 + threadIdx.x < nq) {
      const size_t row = bh * nq + q0 + threadIdx.x;
      row_max[threadIdx.x] = stats[row * 2];
      row_sum[threadIdx.x] = stats[row * 2 + 1];
    }
    __syncthreads();

    if (!kPre) {
      // rowsum(dP * P) = d_ctx_h . ctx_h (+ the chunks' d_probs shares / H).
      for (int r = warp; r < kRows && q0 + r < nq; r += kChunkThreads / 32) {
        const size_t qrow = static_cast<size_t>(b) * nq + q0 + r;
        float dot = lane < hd ? gs[r][lane] * ctx[qrow * e + h * hd + lane] : 0.f;
        dot = warp_sum(dot);
        if (d_probs) {
          float share = 0.f;
          for (int c = 0; c < chunks; ++c) share += dpp[(bh * nq + q0 + r) * chunks + c];
          dot += share * inv_heads;
        }
        if (lane == 0) row_dot[r] = dot;
      }
    }
    // Logits and dP: thread = (key, half of the group's rows).
    float s[kRows / 2] = {}, dp[kRows / 2] = {};
    for (int d = 0; d < hd; ++d) {
      const float kv = ks[jl][d], vv = vs[jl][d];
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) {
        s[i] += qs[r0 + i][d] * kv;
        if (!kPre) dp[i] += gs[r0 + i][d] * vv;
      }
    }
    __syncthreads();   // row_dot is there
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {
      const int r = r0 + i;
      float p = 0.f, g = 0.f;
      if (q0 + r < nq && exists) {
        p = expf((live ? s[i] : -1e30f) - row_max[r]) / row_sum[r];
        if (!kPre) {
          float dpv = dp[i];
          if (d_probs)
            dpv += d_probs[(static_cast<size_t>(b) * nq + q0 + r) * nk + j0 + jl] * inv_heads;
          g = live ? p * (dpv - row_dot[r]) : 0.f;
        }
      }
      ss[r][jl] = p;
      dss[r][jl] = g;
    }
    __syncthreads();

    if (kPre) {
      // The chunk's sum of d_probs * P per row: a warp per row.
      for (int r = warp; r < kRows && q0 + r < nq; r += kChunkThreads / 32) {
        const float* dpr = d_probs + (static_cast<size_t>(b) * nq + q0 + r) * nk + j0;
        float v = 0.f;
        if (j0 + lane < nk) v += ss[r][lane] * dpr[lane];
        if (j0 + lane + 32 < nk) v += ss[r][lane + 32] * dpr[lane + 32];
        v = warp_sum(v);
        if (lane == 0) dpp[(bh * nq + q0 + r) * chunks + chunk] = v;
      }
    } else {
      // The chunk's partial of dQp = scale * dS Kp: a warp per row, a lane
      // per head dimension.
      for (int r = warp; r < kRows && q0 + r < nq; r += kChunkThreads / 32) {
        float o = 0.f;
        for (int j = 0; j < kChunk; ++j) o += dss[r][j] * ks[j][lane];
        if (lane < hd)
          qp_part[(static_cast<size_t>(chunk) * batch * nq + static_cast<size_t>(b) * nq + q0 + r) * e +
                  h * hd + lane] = o * scale;
      }
      // dKp += dS^T (scale Qp), dVp += P^T d_ctx over the group's rows: a
      // lane per head dimension, 16 keys per warp, kept in registers.
#pragma unroll
      for (int i = 0; i < kOwn; ++i) {
        const int j = warp * kOwn + i;
        for (int r = 0; r < kRows; ++r) {
          dk[i] += dss[r][j] * qs[r][lane];
          dv[i] += ss[r][j] * gs[r][lane];
        }
      }
    }
    __syncthreads();   // before the next group overwrites the rows
  }
  if (!kPre && lane < hd) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int j = j0 + warp * kOwn + i;
      if (j >= nk) continue;
      const size_t at = (static_cast<size_t>(b) * nk + j) * e + h * hd + lane;
      d_kp[at] = dk[i];
      d_vp[at] = dv[i];
    }
  }
}

}  // namespace

CMT_DEFINE_ERROR_STRING

// One product of gemm_kernel alone, for tests and measurements. form 1
// (kNT): y (rows, e) = a (rows, e) @ b^T, b (e, e). form 2 (kTN): for each
// chunk s of 256 rows of a, b (rows, e): y[s] (e, e) = a^T b over the chunk
// and colsum[s] (e,) the column sums of b over it.
CMT_EXPORT int fused_mha_bwd_gemm(const float* a, const float* b, float* y, float* colsum,
                                  int rows, int e, int form, void* stream_ptr) {
  if (e % 4 || (form != gemm3::kNT && form != gemm3::kTN))
    return static_cast<int>(cudaErrorInvalidValue);
  GemmBatch g{{a}, {b}, {y}, {colsum}, {rows}, {e}, {e}, {form}, 1};
  return launch_gemm(g, static_cast<cudaStream_t>(stream_ptr));
}

// Inputs: q (B, Nq, E_in), k/v (B, Nk, E_in), mask (B, Nk) bool, wq, wk,
// wv (E_in, E) and wo (E, E_out) applied as x @ w; qp, kp, vp, ctx and
// (key_chunks > 0) stats (B, heads, Nq, 2) as the forward wrote them; d_out
// (B, Nq, E_out); d_probs (B, Nq, Nk) or null, which joins dP divided by
// total_heads. Outputs: d_q, d_k, d_v (B, N, E_in) and the eight parameter
// gradients, shaped as the parameters. All float32 except the mask, all
// 16-byte aligned; E_in, E and E_out multiples of 4, (E / heads) % 4 == 0,
// E / heads <= 32. key_chunks as the forward's: 0 takes the short-key pass
// (Nk <= 32), otherwise it must be ceil(Nk / 64).
// scratch holds at least, in floats, with n_q = B Nq E, n_k = B Nk E,
// s_q = ceil(B Nq / 256), s_k = ceil(B Nk / 256), G = min(ceil(Nq / 16), 64):
//   2 n_q + 2 n_k                          d_ctx, d_qp, d_kp, d_vp
//   + (s_q + 2 s_k) (E_in E + E)           row-chunk partials of d_Wq, d_Wk,
//                                          d_Wv and their biases
//   + s_q (E E_out + E_out)                and of d_Wo and d_bo
//   + (key_chunks == 0 and G > 1 ? 2 G n_k : 0)      block partials of d_kp, d_vp
//   + (key_chunks > 1 ? key_chunks n_q : 0)          chunk partials of d_qp
//   + (key_chunks > 0 ? B heads Nq key_chunks : 0)   chunk shares of d_probs * P
// (ops/attention.py::_bwd_scratch_floats states the same sum).
CMT_EXPORT int fused_mha_bwd(
    const float* q, const float* k, const float* v, const unsigned char* mask,
    const float* wq, const float* wk, const float* wv, const float* wo,
    const float* qp, const float* kp, const float* vp, const float* ctx,
    const float* stats, const float* d_out, const float* d_probs,
    float* scratch, long long scratch_floats,
    float* d_q, float* d_k, float* d_v, float* d_wq, float* d_bq, float* d_wk,
    float* d_bk, float* d_wv, float* d_bv, float* d_wo, float* d_bo,
    int batch, int nq, int nk, int e_in, int e, int e_out, int heads, int total_heads,
    int key_chunks, float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rq = batch * nq, rk = batch * nk;
  const int hd = e / heads;
  if (e % 4 || e_in % 4 || e_out % 4 || hd % 4 || hd > kMaxHeadDim || hd * heads != e ||
      total_heads < heads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (key_chunks == 0 ? nk > kShortKeys : key_chunks != ceil_div(nk, kChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (key_chunks > 0 && stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);

  const size_t n_q = static_cast<size_t>(rq) * e, n_k = static_cast<size_t>(rk) * e;
  const int sq = ceil_div(rq, kRowChunk), sk = ceil_div(rk, kRowChunk);
  const int short_blocks = min(ceil_div(nq, kRows), kMaxShortBlocks);
  // Sizes of the four weight and bias gradients: wq, wk, wv, wo.
  const size_t w_size[4] = {static_cast<size_t>(e_in) * e, static_cast<size_t>(e_in) * e,
                            static_cast<size_t>(e_in) * e, static_cast<size_t>(e) * e_out};
  const size_t b_size[4] = {static_cast<size_t>(e), static_cast<size_t>(e),
                            static_cast<size_t>(e), static_cast<size_t>(e_out)};
  const int splits[4] = {sq, sk, sk, sq};
  size_t w_floats = 0, b_floats = 0;
  for (int i = 0; i < 4; ++i) {
    w_floats += splits[i] * w_size[i];
    b_floats += splits[i] * b_size[i];
  }
  float* d_ctx = scratch;
  float* d_qp = d_ctx + n_q;
  float* d_kp = d_qp + n_q;
  float* d_vp = d_kp + n_k;
  float* w_part = d_vp + n_k;                                   // wq, wk, wv, wo
  float* b_part = w_part + w_floats;
  float* attn_part = b_part + b_floats;
  size_t need = static_cast<size_t>(attn_part - scratch);
  if (key_chunks == 0) {
    if (short_blocks > 1) need += 2 * short_blocks * n_k;
  } else {
    if (key_chunks > 1) need += key_chunks * n_q;
    need += static_cast<size_t>(batch) * heads * nq * key_chunks;
  }
  if (static_cast<long long>(need) > scratch_floats) return static_cast<int>(cudaErrorInvalidValue);

  // Row-chunk partials; a gradient with one chunk is written in place.
  float* const d_w[4] = {d_wq, d_wk, d_wv, d_wo};
  float* const d_b[4] = {d_bq, d_bk, d_bv, d_bo};
  float* w_to[4];
  float* b_to[4];
  {
    float* wp = w_part;
    float* bp = b_part;
    for (int i = 0; i < 4; ++i) {
      w_to[i] = splits[i] == 1 ? d_w[i] : wp;
      b_to[i] = splits[i] == 1 ? d_b[i] : bp;
      wp += splits[i] * w_size[i];
      bp += splits[i] * b_size[i];
    }
  }

  // 1. d_ctx = d_out Wo^T; partials of d_Wo = ctx^T d_out and d_bo.
  GemmBatch g1{{d_out, ctx}, {wo, d_out}, {d_ctx, w_to[3]}, {nullptr, b_to[3]}, {rq, rq},
               {e_out, e}, {e, e_out}, {gemm3::kNT, gemm3::kTN}, 2};
  int rc = launch_gemm(g1, stream);
  if (rc != 0) return rc;

  // 2. and 3. The attention pass and the join of its partials.
  SumBatch join{};
  if (key_chunks == 0) {
    float* kp_part = short_blocks == 1 ? d_kp : attn_part;
    float* vp_part = short_blocks == 1 ? d_vp : attn_part + short_blocks * n_k;
    const size_t smem = short_smem_floats(nk, e, heads) * sizeof(float);
    rc = cmt_set_smem(attn_bwd_short_kernel, smem);
    if (rc != 0) return rc;
    attn_bwd_short_kernel<<<dim3(short_blocks, batch), kShortThreads, smem, stream>>>(
        qp, kp, vp, mask, d_ctx, d_probs, d_qp, kp_part, vp_part, batch, nq, nk, e, heads,
        total_heads, scale);
    CMT_CHECK_LAUNCH();
    add_sum(join, kp_part, d_kp, n_k, short_blocks);
    add_sum(join, vp_part, d_vp, n_k, short_blocks);
  } else {
    float* qp_part = key_chunks == 1 ? d_qp : attn_part;
    float* dpp = attn_part + (key_chunks == 1 ? 0 : key_chunks * n_q);
    const dim3 grid(key_chunks, batch * heads);
    if (d_probs != nullptr) {
      attn_bwd_chunk_kernel<true><<<grid, kChunkThreads, 0, stream>>>(
          qp, kp, vp, mask, ctx, stats, d_ctx, d_probs, dpp, qp_part, d_kp, d_vp, batch, nq, nk,
          e, heads, total_heads, scale);
      CMT_CHECK_LAUNCH();
    }
    attn_bwd_chunk_kernel<false><<<grid, kChunkThreads, 0, stream>>>(
        qp, kp, vp, mask, ctx, stats, d_ctx, d_probs, dpp, qp_part, d_kp, d_vp, batch, nq, nk, e,
        heads, total_heads, scale);
    CMT_CHECK_LAUNCH();
    add_sum(join, qp_part, d_qp, n_q, key_chunks);
  }
  rc = launch_sums(join, stream);
  if (rc != 0) return rc;

  // 4. d_q = d_qp Wq^T, d_k = d_kp Wk^T, d_v = d_vp Wv^T; partials of
  // d_Wq = q^T d_qp, d_Wk, d_Wv and of the three bias gradients.
  GemmBatch g2{{d_qp, d_kp, d_vp, q, k, v},
               {wq, wk, wv, d_qp, d_kp, d_vp},
               {d_q, d_k, d_v, w_to[0], w_to[1], w_to[2]},
               {nullptr, nullptr, nullptr, b_to[0], b_to[1], b_to[2]},
               {rq, rk, rk, rq, rk, rk},
               {e, e, e, e_in, e_in, e_in},
               {e_in, e_in, e_in, e, e, e},
               {gemm3::kNT, gemm3::kNT, gemm3::kNT, gemm3::kTN, gemm3::kTN, gemm3::kTN},
               6};
  rc = launch_gemm(g2, stream);
  if (rc != 0) return rc;

  // 5. The weight and bias gradients: row chunks added in chunk order.
  SumBatch sums{};
  for (int i = 0; i < 4; ++i) {
    add_sum(sums, w_to[i], d_w[i], w_size[i], splits[i]);
    add_sum(sums, b_to[i], d_b[i], b_size[i], splits[i]);
  }
  return launch_sums(sums, stream);
}
