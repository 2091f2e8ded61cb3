// Batched exact linear assignment: B square float32 cost matrices with
// n <= 31 -> (B, n) int32 col[i], the column assigned to row i, minimising
// the total cost. Jonker-Volgenant shortest augmenting path, the algorithm
// of `diffusiondrive_tpu/ops/hungarian.py:linear_sum_assignment`.
//
// Replaces the TPU kernel `diffusiondrive_tpu/ops/hungarian.py:_lap_kernel`
// (reached through `_lsa_pallas`, pallas_call at :222), which laid 8 problems
// over the sublanes of an (8, 128) tile and turned every gather into a
// one-hot reduction, a Mosaic artifact.
//
// What bounds it on an H100 SXM: neither bytes nor operations. At B=64,
// n=30 it reads 230 KB and writes 7.7 KB (well under a microsecond at
// 3.35 TB/s) and does a few hundred thousand comparisons. Each problem is a
// chain of dependent steps (n rows, each a search of up to n+1 steps, then
// up to n+1 augment hops), and all B problems run side by side, one warp
// each, so the time is the longest chain times the latency of one step.
//
// Design ("warp_redux"): the step's chain is kept short; ~100 ns a step
// (NVIDIA H100 80GB HBM3, 700 W; a 5-round __shfl_xor_sync butterfly argmin
// with the row index, its potential and the break test by shuffles took
// ~200; PERF.md):
//
// - The argmin is one __reduce_min_sync (redux.sync) over an
//   order-preserving 32-bit key of each free column's value, then the
//   lowest lane holding the minimum by __ballot_sync and __ffs: the lower
//   index wins ties, as jnp.argmin. -0.0 is keyed as +0.0, since the two
//   compare equal as floats; the sentinel 1e18 keys above every smaller
//   value, as it compares.
// - The cost rows are kept permuted by the matching: row j of `cm` is the
//   cost row of the row matched to column j (row 0: the row being
//   inserted), so the step's row load is addressed by the argmin's column
//   itself, with no shuffle for the row index; an augmentation moves the
//   rows along its path with the matching.
// - u is kept per column too (lane j holds u of the row matched to column
//   j), so the next step's u comes from lane j1 in the same round as the
//   argmin's value, and not after the row index.
// - "Is j1 free" ANDs the argmin's ballot (its lowest bit) with a
//   warp-uniform bitmask of the free columns, taken once a row (the
//   matching changes only when the row is augmented). With the step bound
//   folded into the same predicate, a step ends in one branch, which waits
//   neither for a shuffle nor for __ffs (a `for` loop with a `break` took
//   two, the second after a reload of n from the constant bank: 1.2x).
// - The key of each column's new minv is the smaller of the keys of cur and
//   of the old minv, so the reduction does not wait for minv's update.
//
// Each lane reads and writes only its own column of `cm`, so no barrier is
// needed. Augmenting walks `way` back to the virtual column, one shuffle a
// hop, and copies p, u and the cost row along the path.
//
// Exactness: the float arithmetic is subtractions and comparisons in the
// JAX order (cur = c[i0][j] - u[i0] - v[j]; u + delta; v - delta;
// minv - delta; rows 1..n in order), on the same values (u is moved, not
// recomputed; delta is the winning lane's own value), with no multiply to
// contract, so the kernel gives the plain version's assignment bit for
// bit, ties included.
//
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;       // problems per block
constexpr int W = 32;          // lanes = padded columns
constexpr float INF = 1e18f;   // the JAX package's sentinel, rounded to float32

// Unsigned key with the order of the floats (no NaN); -0.0 keys as +0.0.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.0f));  // -0 + +0 = +0
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

constexpr unsigned KINF = 0x80000000u | 0x5d5e0b6bu;  // order_key(INF): 1e18f is 0x5d5e0b6b

__global__ void __launch_bounds__(WARPS * W)
lap_kernel(const float* __restrict__ cost, int* __restrict__ col, int B, int n) {
  // cm[warp][j * W + lane]: cost of (row matched to column j, column lane);
  // row 0 holds the row being inserted; column 0 and columns > n are zero
  __shared__ float cms[WARPS][W * W];
  const int warp = threadIdx.x / W;
  const int lane = threadIdx.x % W;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // whole warps leave together: no collective is left short
  float* cm = cms[warp];
  const float* cb = cost + (size_t)b * n * n;
  const unsigned all = 0xffffffffu;
  const bool real = lane >= 1 && lane <= n;  // a real column (lane 0 virtual, > n padding)
#pragma unroll 4
  for (int r = 0; r < W; ++r) cm[r * W + lane] = 0.0f;
  float row = real ? __ldg(cb + lane - 1) : 0.0f;  // cost row 1, column `lane`

  float v = 0.0f;   // v of column `lane`
  float uc = 0.0f;  // u of the row matched to column `lane`
  int p = 0;        // row (1-indexed) matched to column `lane`, 0 if free

  for (int i = 1; i <= n; ++i) {
    if (lane == 0) {
      p = i;
      uc = 0.0f;  // u[i]: row i has not been in a tree yet
    }
    cm[lane] = row;
    if (i < n) row = real ? __ldg(cb + (size_t)i * n + lane - 1) : 0.0f;  // next row, ahead
    const unsigned free_cols = __ballot_sync(all, p == 0);
    float minv = INF;
    unsigned kminv = KINF;  // order_key(minv), kept beside it
    unsigned tree = 1;  // warp-uniform mask of the columns in the tree ("used"): j0 = 0
    int way = 0, j0 = 0;
    float u0 = 0.0f;  // u of the row matched to j0 (u[i] = 0 at the first step)
    int step = 0;
    bool more;
    do {  // at most n+1 columns join the tree
      const bool used = (tree >> lane) & 1u;
      const float cur = cm[j0 * W + lane] - u0 - v;
      // the key of min(cur, minv) is the smaller key: the argmin need not wait for minv
      const unsigned key = (used || !real) ? KINF : min(order_key(cur), kminv);
      if (cur < minv && !used) {
        minv = cur;
        way = j0;
      }
      const unsigned kmin = __reduce_min_sync(all, key);
      const unsigned hits = __ballot_sync(all, key == kmin);
      const unsigned bit = hits & (0u - hits);  // the lowest lane holding the minimum: j1
      const int j1 = __ffs(hits) - 1;
      const float delta = __shfl_sync(all, (used || !real) ? INF : minv, j1);
      // u of j1's row after this step: j1 is outside the tree (it changes
      // only when every free column is at the sentinel and a tree column wins)
      const float uj1 = __shfl_sync(all, uc, j1);
      u0 = (tree & bit) ? uj1 + delta : uj1;
      if (used) {
        uc = uc + delta;
        v = v - delta;
      } else {
        minv = minv - delta;
        kminv = order_key(minv);
      }
      j0 = j1;
      tree |= bit;
      // j1 free: augment from it (the test reads the ballot, not j1, so the
      // step's one branch does not wait for __ffs)
      more = !(free_cols & bit) & (++step <= n);
    } while (more);
    // augment along `way` back to the virtual column: at most n+1 hops;
    // column j0 takes the row (and its u and cost row) of column way[j0]
    int hop = 0;
    do {
      const int j1 = __shfl_sync(all, way, j0);
      const int pj1 = __shfl_sync(all, p, j1);
      const float uj1 = __shfl_sync(all, uc, j1);
      cm[j0 * W + lane] = cm[j1 * W + lane];
      if (lane == j0) {
        p = pj1;
        uc = uj1;
      }
      j0 = j1;
      more = (j1 != 0) & (++hop <= n);
    } while (more);
  }
  // p[j] = row matched to column j (both 1-indexed) -> col[row - 1] = j - 1
  // (p is in 1..n for every real column; the guard keeps a NaN cost from
  // writing out of bounds)
  if (real && p >= 1 && p <= n) col[(size_t)b * n + p - 1] = lane - 1;
}

}  // namespace

// cost: (B, n, n) float32, col: (B, n) int32, both contiguous on the device;
// 1 <= n <= 31. Returns a cudaError_t (0 on a good launch).
extern "C" int ddt_lap(const void* cost, void* col, int B, int n, void* stream) {
  if (B <= 0 || n < 1 || n > W - 1) return (int)cudaErrorInvalidValue;
  const int blocks = (B + WARPS - 1) / WARPS;
  lap_kernel<<<blocks, WARPS * W, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<int*>(col), B, n);
  return (int)cudaGetLastError();
}
