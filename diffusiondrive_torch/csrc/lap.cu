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
// chain of n(n+1) dependent steps at most (n rows, each up to n+1 columns
// joining the alternating tree), and every step is a shared-memory load and
// a 5-round warp argmin, so the floor is latency: ~n(n+1) x (shuffle
// rounds + load) cycles for one problem, the same for all B in parallel.
//
// Design: one warp solves one problem. Lane j holds column j (lane 0 the
// virtual column 0), so 32 lanes hold the n+1 <= 32 columns; v, minv, used,
// way and p live in registers, one entry per lane. u and the used-row mask
// live in registers too, lane r holding row r. The problem's 32x32 padded
// cost (row 0 and column 0 zero) sits in shared memory, 4 KB per warp, so
// the row i0 is one conflict-free shared load per lane. p[j0], u[i0] and
// way[j0] are __shfl_sync reads; the argmin is a __shfl_xor_sync butterfly
// over (value, index) that prefers the lower index on equal values, as
// jnp.argmin does. All control flow is warp-uniform (j0, i0, delta come out
// of shuffles), and a warp leaves the search loop when it reaches a free
// column, where the JAX version runs fixed, masked trips: same results.
//
// Exactness: the float arithmetic is subtractions and comparisons in the
// JAX order (cur = c[i0][j] - u[i0] - v[j]; u + delta; v - delta;
// minv - delta), with no multiply to contract, so the kernel gives the
// plain version's assignment bit for bit, ties included.
//
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;       // problems per block
constexpr int W = 32;          // lanes = padded columns and rows
constexpr float INF = 1e18f;   // the JAX package's sentinel, rounded to float32

__global__ void __launch_bounds__(WARPS * W)
lap_kernel(const float* __restrict__ cost, int* __restrict__ col, int B, int n) {
  __shared__ float cs[WARPS][W * W];  // [row][column], row 0 and column 0 zero
  const int warp = threadIdx.x / W;
  const int lane = threadIdx.x % W;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // whole warps leave together: no shuffle is left short
  float* c = cs[warp];
  const float* cb = cost + (size_t)b * n * n;
  for (int r = 0; r < W; ++r) {
    c[r * W + lane] = (r >= 1 && r <= n && lane >= 1 && lane <= n) ? cb[(r - 1) * n + lane - 1] : 0.0f;
  }
  __syncwarp();

  const unsigned all = 0xffffffffu;
  const bool real = lane >= 1 && lane <= n;  // a real column (lane 0 virtual, > n padding)
  float u = 0.0f, v = 0.0f;                  // u: row `lane`; v: column `lane`
  int p = 0;                                 // row (1-indexed) matched to column `lane`

  for (int i = 1; i <= n; ++i) {
    if (lane == 0) p = i;
    float minv = INF;
    bool used = false, urow = false;
    int way = 0, j0 = 0;
    for (int step = 0; step <= n; ++step) {  // at most n+1 columns join the tree
      used = used || lane == j0;
      const int i0 = __shfl_sync(all, p, j0);
      urow = urow || lane == i0;
      const float ui0 = __shfl_sync(all, u, i0);
      const float cur = c[i0 * W + lane] - ui0 - v;
      if (cur < minv && !used) {
        minv = cur;
        way = j0;
      }
      // warp argmin over the free real columns; the lower index wins ties
      float best = (used || !real) ? INF : minv;
      int arg = lane;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(all, best, off);
        const int oa = __shfl_xor_sync(all, arg, off);
        if (ob < best || (ob == best && oa < arg)) {
          best = ob;
          arg = oa;
        }
      }
      const float delta = best;
      const int j1 = arg;
      if (urow) u = u + delta;
      if (used) v = v - delta;
      else minv = minv - delta;
      j0 = j1;
      if (__shfl_sync(all, p, j1) == 0) break;  // j1 is free: augment from it
    }
    // augment along `way` back to the virtual column: at most n+1 hops
    for (int hop = 0; hop <= n; ++hop) {
      const int j1 = __shfl_sync(all, way, j0);
      const int pj1 = __shfl_sync(all, p, j1);
      if (lane == j0) p = pj1;
      j0 = j1;
      if (j1 == 0) break;
    }
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
