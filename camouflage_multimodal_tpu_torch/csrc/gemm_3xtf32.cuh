// One output tile of a float32 matrix product on the tensor cores at float32
// accuracy ("3xTF32"), for the attention kernels of this directory, in the
// three forms the forward and the backward need, none of which copies or
// transposes an operand in device memory (all matrices row-major float32):
//   kNN  y (rows, n) = x (rows, depth) @ w (depth, n) + bias   (projections)
//   kNT  y (rows, n) = dy (rows, depth) @ w^T, w (n, depth)    (input gradients)
//   kTN  y (m, n) = x^T dy over the rows [k_begin, k_end) of x (.., m) and
//        dy (.., n); optionally also the column sums of those rows of dy
//        (weight and bias gradients, one row chunk of the sum at a time)
// These are the matrix products that the Pallas kernel
// camouflage_multimodal_tpu/ops/pallas_attention.py (_mha_kernel) and its
// custom VJP leave to the TPU's matrix unit: fused_mha.cu takes its four
// projections from here, fused_mha_bwd.cu its eight gradient products.
//
// TF32 keeps 10 mantissa bits, about three decimal digits, and the models
// here are float32 throughout, so each operand is split into a TF32 head and
// a TF32 tail, a = a_hi + a_lo with a_hi = tf32(a) and a_lo = tf32(a - a_hi),
// and every product is taken as three mma.sync.m16n8k8 TF32 instructions:
//   tail += a_lo * b_hi;  tail += a_hi * b_lo;  acc += (0 + a_hi * b_hi).
// The dropped a_lo * b_lo term is below 2^-22 relative. The tensor core
// truncates when it adds into its accumulator, which over the 32 depth
// steps of a 256-deep product would cost a few units in the sixth digit, so
// the leading term of each depth step is taken into a zeroed accumulator
// and added to the running sum by an ordinary round-to-nearest float32 add;
// the two small terms (2^-11 of the result) stay in a tensor-core
// accumulator of their own and join at the end. (With all three terms in
// one tensor-core accumulator the attention output was off by 1.3e-5 to
// 2.8e-5 from the float32 reference on an NVIDIA H100 and the backward's wo
// gradient left its 1e-4 bar; this way the output is off by 2.9e-6 at most,
// as the CUDA-core version was.) Sums run in a fixed order, so a repeat is
// bit-equal.
//
// A block of 128 threads (2 x 2 warps) owns a 32 x BN tile (BN = 64 or 32),
// each warp 16 rows x BN/2 columns. Operand tiles of depth 32 reach shared
// memory by 16-byte cp.async copies (zero-filled outside the matrices and
// outside the row chunk) through a ring of three stages. An operand is
// staged the way it lies in memory, so the copies stay 16 bytes wide along
// its contiguous index, and the mma fragments are read from shared memory
// in whichever orientation the form needs (mma.sync wants A row-major and B
// column-major: kNT's w is exactly that, kTN's x is read transposed). Row
// strides keep a warp's fragment loads on 32 different banks: 36 floats for
// a tile staged depth-contiguous (x of kNN / kNT, w of kNT: bank 4 g + tig),
// BN + 8 and 40 for one staged depth-major (w of kNN / kTN, x of kTN: bank
// 8 tig + g).
// Requires depth % 4 == 0, m % 4 == 0, n % 4 == 0 and 16-byte aligned
// operands.
//
// What bounds it at the attention shapes (2,560 x 256 x 256, 336 tiles; H100
// 80GB HBM3, 700 W): with the loads alone the kernel takes 9 us (every row
// tile reads its 64 columns of w again, 32 MB from L2 in all), with the
// arithmetic alone 11 us (splitting takes more instruction slots than the mma:
// a warp splits 12 values for 12 mma), together 16 us; the mma
// instructions themselves are 4 us of that. The backward's flat grids of
// kNT and kTN tiles run at the same rate (2.47 GFLOP in 0.104 ms, 24
// TFLOP/s, same card). Wider warp tiles (fewer splits and fewer bytes per
// mma) are the next step.
#pragma once

#include <cuda_runtime.h>

namespace gemm3 {

constexpr int kBM = 32;        // rows of a block's tile
constexpr int kBK = 32;        // depth of one stage
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kXStride = kBK + 4;   // row stride of a tile staged depth-contiguous
constexpr int kTStride = kBM + 8;   // row stride of kTN's x tile, staged depth-major

enum Form { kNN = 0, kNT = 1, kTN = 2 };

template <int BN>
struct Smem {
  static constexpr int kWStride = BN + 8;
  // x: kBM rows of kXStride (kNN, kNT) or kBK rows of kTStride (kTN);
  // w: kBK rows of kWStride (kNN, kTN) or BN rows of kXStride (kNT).
  float x[kStages][kBK * kTStride];
  float w[kStages][kBK * kWStride];
};
static_assert(kBK * kTStride >= kBM * kXStride, "x stage holds either layout");
static_assert(kBK * Smem<64>::kWStride >= 64 * kXStride && kBK * Smem<32>::kWStride >= 32 * kXStride,
              "w stage holds either layout");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// TF32 head and tail of a finite float32 value. The head is rounded to
// nearest (ties away from zero) with two integer instructions: cvt.rna.tf32
// computes the same but runs at a quarter of their rate, and at twelve
// conversions per three mma it bound the first version of this GEMM. The
// tail v - head is exact in float32; the tensor core reads its upper 19 bits.
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage the operands' depth steps [k0, k0 + kBK), cut at k_end. `lda` is the
// row length of a (depth for kNN / kNT, m for kTN), `ldb` that of b (n for
// kNN / kTN, depth for kNT).
template <int BN, int FORM>
__device__ __forceinline__ void load_stage(Smem<BN>& s, int stage, const float* __restrict__ a,
                                           const float* __restrict__ b, int rows, int lda,
                                           int ldb, int n, int row0, int col0, int k0,
                                           int k_end) {
  constexpr int kWStride = Smem<BN>::kWStride;
  if constexpr (FORM == kTN) {
    for (int i = threadIdx.x; i < kBK * kBM / 4; i += kThreads) {
      const int kk = i / (kBM / 4), c = (i % (kBM / 4)) * 4;
      const int gk = k0 + kk, gr = row0 + c;
      const bool valid = gk < k_end && gr < rows;
      cp_async16(&s.x[stage][kk * kTStride + c],
                 valid ? a + static_cast<size_t>(gk) * lda + gr : a, valid);
    }
  } else {
    for (int i = threadIdx.x; i < kBM * kBK / 4; i += kThreads) {
      const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
      const int gr = row0 + r, gk = k0 + c;
      const bool valid = gr < rows && gk < k_end;
      cp_async16(&s.x[stage][r * kXStride + c],
                 valid ? a + static_cast<size_t>(gr) * lda + gk : a, valid);
    }
  }
  if constexpr (FORM == kNT) {
    for (int i = threadIdx.x; i < BN * kBK / 4; i += kThreads) {
      const int cc = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
      const int gc = col0 + cc, gk = k0 + c;
      const bool valid = gc < n && gk < k_end;
      cp_async16(&s.w[stage][cc * kXStride + c],
                 valid ? b + static_cast<size_t>(gc) * ldb + gk : b, valid);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * BN / 4; i += kThreads) {
      const int kk = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const int gk = k0 + kk, gc = col0 + c;
      const bool valid = gk < k_end && gc < n;
      cp_async16(&s.w[stage][kk * kWStride + c],
                 valid ? b + static_cast<size_t>(gk) * ldb + gc : b, valid);
    }
  }
}

// The tile of y (rows, n) at (row0, col0), summed over the depth steps
// [k_begin, k_end). kNN / kNT: a (rows, depth), depth = k_end, k_begin = 0,
// b (depth, n) or (n, depth). kTN: a (.., rows), b (.., n), and when `colsum`
// is not null the column sums of b's rows [k_begin, k_end), in row order, are
// written to colsum[col0 ...] as well (give it to the tiles of one row0
// only). Every thread of the block must call it.
template <int BN, int FORM>
__device__ void tile_form(Smem<BN>& s, const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ bias, float* __restrict__ y, int rows, int n,
                     int row0, int col0, int k_begin, int k_end, float* __restrict__ colsum) {
  constexpr int kWStride = Smem<BN>::kWStride;
  constexpr int kNT_ = BN / 16;   // 8-column mma tiles of one warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wrow = (warp / 2) * 16, wcol = (warp % 2) * (BN / 2);
  const int lda = FORM == kTN ? rows : k_end;
  const int ldb = FORM == kNT ? k_end : n;
  float acc[kNT_][4] = {}, tail[kNT_][4] = {};
  float col_acc = 0.f;

  const int steps = (k_end - k_begin + kBK - 1) / kBK;
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps)
      load_stage<BN, FORM>(s, st, a, b, rows, lda, ldb, n, row0, col0, k_begin + st * kBK, k_end);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage kt has landed; stage kt - 1 is free again
    const int next = kt + kStages - 1;
    if (next < steps)
      load_stage<BN, FORM>(s, next % kStages, a, b, rows, lda, ldb, n, row0, col0,
                           k_begin + next * kBK, k_end);
    cp_async_commit();

    const float* xs = s.x[kt % kStages];
    const float* ws = s.w[kt % kStages];
    if constexpr (FORM == kTN) {
      if (colsum != nullptr && threadIdx.x < BN) {
#pragma unroll 8
        for (int kk = 0; kk < kBK; ++kk) col_acc += ws[kk * kWStride + threadIdx.x];
      }
    }
#pragma unroll
    for (int k8 = 0; k8 < kBK; k8 += 8) {
      unsigned a_hi[4], a_lo[4];
      if constexpr (FORM == kTN) {
        split_tf32(xs[(k8 + tig) * kTStride + wrow + g], a_hi[0], a_lo[0]);
        split_tf32(xs[(k8 + tig) * kTStride + wrow + g + 8], a_hi[1], a_lo[1]);
        split_tf32(xs[(k8 + tig + 4) * kTStride + wrow + g], a_hi[2], a_lo[2]);
        split_tf32(xs[(k8 + tig + 4) * kTStride + wrow + g + 8], a_hi[3], a_lo[3]);
      } else {
        split_tf32(xs[(wrow + g) * kXStride + k8 + tig], a_hi[0], a_lo[0]);
        split_tf32(xs[(wrow + g + 8) * kXStride + k8 + tig], a_hi[1], a_lo[1]);
        split_tf32(xs[(wrow + g) * kXStride + k8 + tig + 4], a_hi[2], a_lo[2]);
        split_tf32(xs[(wrow + g + 8) * kXStride + k8 + tig + 4], a_hi[3], a_lo[3]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT_; ++nt) {
        unsigned b_hi[2], b_lo[2];
        const int c = wcol + nt * 8 + g;
        if constexpr (FORM == kNT) {
          split_tf32(ws[c * kXStride + k8 + tig], b_hi[0], b_lo[0]);
          split_tf32(ws[c * kXStride + k8 + tig + 4], b_hi[1], b_lo[1]);
        } else {
          split_tf32(ws[(k8 + tig) * kWStride + c], b_hi[0], b_lo[0]);
          split_tf32(ws[(k8 + tig + 4) * kWStride + c], b_hi[1], b_lo[1]);
        }
        mma_tf32(tail[nt], a_lo, b_hi);
        mma_tf32(tail[nt], a_hi, b_lo);
        float head[4] = {};
        mma_tf32(head, a_hi, b_hi);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] += head[i];
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (FORM == kTN) {
    if (colsum != nullptr && threadIdx.x < BN && col0 + threadIdx.x < n)
      colsum[col0 + threadIdx.x] = col_acc;
  }
#pragma unroll
  for (int nt = 0; nt < kNT_; ++nt) {
    const int c = col0 + wcol + nt * 8 + 2 * tig;   // even; n % 4 == 0, so c + 1 < n too
    if (c >= n) continue;
    const float b0 = bias ? bias[c] : 0.f, b1 = bias ? bias[c + 1] : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + wrow + g + half * 8;
      if (r >= rows) continue;
      *reinterpret_cast<float2*>(y + static_cast<size_t>(r) * n + c) =
          make_float2(acc[nt][2 * half] + tail[nt][2 * half] + b0,
                      acc[nt][2 * half + 1] + tail[nt][2 * half + 1] + b1);
    }
  }
}

// y = x @ w + bias: the tile of y (rows, n) at (row0, col0).
template <int BN>
__device__ __forceinline__ void tile(Smem<BN>& s, const float* __restrict__ x,
                                     const float* __restrict__ w, const float* __restrict__ bias,
                                     float* __restrict__ y, int rows, int depth, int n, int row0,
                                     int col0) {
  tile_form<BN, kNN>(s, x, w, bias, y, rows, n, row0, col0, 0, depth, nullptr);
}

}  // namespace gemm3
