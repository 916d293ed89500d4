// Canny's double-threshold hysteresis, run to its fixed point in one launch.
//
// Replaces no Pallas kernel. The JAX package runs this fixed point as a
// lax.while_loop inside one compiled program (camouflage_multimodal_tpu/
// ops/canny.py, _hysteresis); run eagerly in PyTorch the same loop is a
// masked 3 x 3 dilation a step, some 25 small launches each, with a host
// test every few steps (ops/canny.py, _hysteresis, the plain version). Same
// function: the pixels of `low` that are 8-connected, through pixels of
// `low`, to a pixel of `high & low`; nothing wraps around the image's
// borders. That set is the least fixed point of "grow within low", the same
// whatever order the growth takes, so the result is bit-equal to the plain
// version's.
//
// Bound on this card: the bytes are the two bool masks read once and the
// result written once, 3 B a pixel (16 x 352^2: 5.9 MB, 1.8 us at
// 3.35 TB/s); there are no floating-point operations. What bounds the
// kernel is its number of rounds: the growth is a chain of dependent steps
// as long as the longest path through `low`, and each round is a pass of a
// block over its image's rows. Design:
//   - One block of 1,024 threads per image (leading dimensions flattened).
//     The block packs `low` and the current set into bit rows, 32 pixels a
//     word (pixel x of a row is bit x % 32 of word x / 32): 352^2 takes
//     2 x 15.5 KB of shared memory. An image whose two packed masks exceed
//     the block's shared memory keeps them in a scratch buffer in device
//     memory instead (the caller allocates it and passes it; null means
//     shared memory): one algorithm, its state placed elsewhere.
//   - Each of the 32 warps owns a band of consecutive rows; a lane takes a
//     word of a row. A row's update ORs in the 8-neighbour dilation of the
//     rows above and below, masked by `low`, then fills every run of `low`
//     that holds a seed, across the whole row at once: (m + s) carries a
//     seed's bit to the top of its run, so (((m + s) ^ m) | s) & m is the
//     run above each lowest seed, with the carry chained from word to word
//     by a carry-lookahead over the warp's ballots; the same on the words
//     bit-reversed, in reversed order, fills the runs downward. A horizontal
//     run of any length costs one row update, not one round a pixel.
//   - A round sweeps each band top-down, then bottom-up, so a path that
//     runs down or up a band crosses it in one round; a band reads its
//     neighbours' edge rows as they stand. Every value any thread can read
//     lies between the start state and the fixed point (bits are only ever
//     added, and only reachable ones), so a race costs at most a round. The
//     block stops after a round in which no row grew (__syncthreads_or):
//     then every row was updated from final neighbours and found nothing to
//     add, which is the fixed point. No host round trip, no fixed trip count.
//   - The rounds each image took are written to `rounds` (for tests and
//     measurements; the main path does not read them).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The bits of mask word m reachable from seeds s (s within m) by moving
// toward higher bit positions inside runs of m, for one word a lane, the
// words chained by carries in lane order (reversed: lane 31 first).
// `carry` is the carry into the first word on entry and out of the last on
// exit, the same in every lane.
__device__ __forceinline__ uint32_t run_fill(uint32_t m, uint32_t s, int lane, bool reversed,
                                             unsigned& carry) {
  const uint32_t sum = m + s;
  unsigned gen = __ballot_sync(kFull, sum < m);         // the word's add overflows
  unsigned prop = __ballot_sync(kFull, sum == kFull);   // a carry in would pass through
  if (reversed) gen = __brev(gen), prop = __brev(prop);
  const int pos = reversed ? 31 - lane : lane;
  // gen and prop are disjoint, so adding (gen | prop) and gen bit by bit
  // generates where gen is set and propagates where prop is: the carries
  // into the words are the carries of that add.
  const unsigned long long a = gen | prop, b = gen;
  const unsigned long long total = a + b + carry;
  carry = static_cast<unsigned>(total >> 32);
  const uint32_t carry_in = static_cast<uint32_t>(((total ^ a ^ b) >> pos) & 1u);
  return (((sum + carry_in) ^ m) | s) & m;
}

__device__ __forceinline__ uint32_t neighbours(const volatile uint32_t* up,
                                               const volatile uint32_t* down, int j) {
  return (up ? up[j] : 0u) | (down ? down[j] : 0u);
}

// One warp updates row y: seeds from the 8 neighbours in rows y - 1 and
// y + 1, then every run of low holding a seed filled whole. Returns, per
// lane, whether its words grew.
__device__ bool update_row(const uint32_t* low, volatile uint32_t* cur, int y, int height,
                           int words, int lane) {
  const uint32_t* mask = low + static_cast<size_t>(y) * words;
  volatile uint32_t* row = cur + static_cast<size_t>(y) * words;
  const volatile uint32_t* up = y > 0 ? row - words : nullptr;
  const volatile uint32_t* down = y + 1 < height ? row + words : nullptr;
  bool grew = false;
  unsigned carry = 0;
  for (int j0 = 0; j0 < words; j0 += 32) {          // upward fill, segments of 32 words in order
    const int j = j0 + lane;
    uint32_t m = 0, s = 0;
    if (j < words) {
      m = mask[j];
      const uint32_t old = row[j];
      const uint32_t n = neighbours(up, down, j);
      const uint32_t left = j > 0 ? neighbours(up, down, j - 1) : 0u;
      const uint32_t right = j + 1 < words ? neighbours(up, down, j + 1) : 0u;
      s = (old | n | (n << 1) | (left >> 31) | (n >> 1) | (right << 31)) & m;
      grew |= s != old;
    }
    const uint32_t f = run_fill(m, s, lane, false, carry);
    if (j < words) {
      grew |= f != s;
      row[j] = f;
    }
  }
  carry = 0;
  for (int j0 = (words - 1) / 32 * 32; j0 >= 0; j0 -= 32) {   // downward, segments reversed
    const int j = j0 + lane;
    uint32_t m = 0, s = 0;
    if (j < words) m = __brev(mask[j]), s = __brev(row[j]);
    const uint32_t f = run_fill(m, s, lane, true, carry);
    if (j < words) {
      grew |= f != s;
      row[j] = __brev(f);
    }
  }
  return grew;
}

__global__ void __launch_bounds__(kThreads, 1)
canny_hysteresis_kernel(const uint8_t* __restrict__ low_in, const uint8_t* __restrict__ high_in,
                        uint8_t* __restrict__ out, int* __restrict__ rounds_out,
                        uint32_t* scratch, int height, int width, int words) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int plane_words = height * words;
  uint32_t* low = scratch ? scratch + static_cast<size_t>(b) * 2 * plane_words : smem;
  uint32_t* cur = low + plane_words;
  const size_t plane = static_cast<size_t>(height) * width;
  const uint8_t* lo = low_in + plane * b;
  const uint8_t* hi = high_in + plane * b;

  // Pack: a warp turns 32 consecutive pixels of a row into a word by ballot.
  for (int i = warp; i < plane_words; i += kWarps) {
    const int y = i / words, x = (i % words) * 32 + lane;
    const size_t p = static_cast<size_t>(y) * width + x;
    const bool l = x < width && lo[p];
    const bool h = l && hi[p];
    const unsigned lw = __ballot_sync(kFull, l), hw = __ballot_sync(kFull, h);
    if (lane == 0) low[i] = lw, cur[i] = hw;
  }
  __syncthreads();

  const int r0 = static_cast<int>(static_cast<long long>(warp) * height / kWarps);
  const int r1 = static_cast<int>(static_cast<long long>(warp + 1) * height / kWarps);
  int rounds = 0;
  bool grew;
  do {
    grew = false;
    for (int y = r0; y < r1; ++y) grew |= update_row(low, cur, y, height, words, lane);
    for (int y = r1 - 2; y >= r0; --y) grew |= update_row(low, cur, y, height, words, lane);
    ++rounds;
  } while (__syncthreads_or(grew));

  uint8_t* o = out + plane * b;
  for (int i = warp; i < plane_words; i += kWarps) {
    const int y = i / words, x = (i % words) * 32 + lane;
    if (x < width) o[static_cast<size_t>(y) * width + x] = (cur[i] >> lane) & 1u;
  }
  if (threadIdx.x == 0) rounds_out[b] = rounds;
}

}  // namespace

CMT_DEFINE_ERROR_STRING

// low, high, out (batch, height, width) bool (one byte a pixel, 0 or 1),
// contiguous; rounds (batch,) int32; scratch null (both packed masks in
// shared memory: 8 * height * ceil(width / 32) bytes a block) or
// batch * 2 * height * ceil(width / 32) words of device memory. All on the
// current device; batch, height and width at least 1.
CMT_EXPORT int canny_hysteresis(const uint8_t* low, const uint8_t* high, uint8_t* out,
                                int* rounds, uint32_t* scratch, int batch, int height,
                                int width, void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (width + 31) / 32;
  const size_t smem = scratch ? 0 : static_cast<size_t>(height) * words * 2 * sizeof(uint32_t);
  int rc = cmt_set_smem(canny_hysteresis_kernel, smem);
  if (rc != 0) return rc;
  canny_hysteresis_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      low, high, out, rounds, scratch, height, width, words);
  CMT_CHECK_LAUNCH();
  return 0;
}
