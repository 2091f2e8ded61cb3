// Lidar BEV splat: a 2D count histogram of per-point bin pairs for B clouds
// in one launch. (B, N) int32 ix, iy -> (B, bins, bins) float32 counts; a
// point counts iff 0 <= ix < bins and 0 <= iy < bins (the caller marks a
// skipped point with -1).
//
// Replaces the TPU kernel `diffusiondrive_tpu/ops/lidar_splat.py:_splat_kernel`
// (reached through `histogram2d_pallas`, pallas_call at :84), which built
// one-hot matrices and summed their outer product on the MXU, one cloud at a
// time under vmap.
//
// What bounds it on an H100 SXM: bytes. It must read 8 B per point and write
// 4 B per bin: at B=16, N=131072, bins=256 that is 16.8 MB + 4.2 MB, ~6.3 us
// at 3.35 TB/s. It does no arithmetic worth counting.
//
// Design ("segments"): the B clouds' points, taken as one sequence of B*N,
// are cut into equal segments of at most 65535 points, enough of them to
// give every SM a block at B=1 as at B=16 (the wrapper's plan,
// `splat_plan`). A block holds a whole band of the histogram in shared
// memory as 16-bit counts, two to a 32-bit word (256x256 bins: 128 KB, one
// band; bins above 340 take more bands), so each index is read once per
// band. A segment of at most 65535 points cannot carry a count out of its
// 16-bit half. Where a segment crosses into the next cloud, the block
// flushes and starts again.
//
// Merging is exact: `ddt_lidar_splat` queues a memset of `out` on the
// stream, then each block atomically adds its non-zero counts into `out` as
// floats, lane l of a warp cell base + l, so a warp's atomics fall on 32
// consecutive floats (lanes on 8-cell strides took 1.5x as long on a
// uniform cloud). Every partial sum is an integer <= N < 2^24 (the
// wrapper's gate), so the sums are exact in any order and two calls give
// the same bits. A piece of at most NT * UNROLL points (B=1: ~1000 points a
// block) is scanned in one pass with its bins kept in registers, and zeroes
// and flushes only the words its bins touch, not the whole 128 KB.
//
// Each point adds 1 to its 16-bit half with one shared atomic. Warp
// aggregation of equal bins, measured on the agent path's clouds (hot bins
// next to the ego, consecutive points in one bin) and on a uniform cloud,
// did not pay (PERF.md): run-length groups (__shfl_up_sync + __ballot_sync)
// took 1-4% longer, __match_any_sync groups 1.3-1.4x as long.
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;     // threads per block
constexpr int UNROLL = 4;    // points per lane in flight: a warp takes 128 at a time

// Add one point of bin `key` (-1: none) to the band's 16-bit counts.
__device__ __forceinline__ void add_point(unsigned* hist, int key) {
  if (key >= 0) atomicAdd(hist + (key >> 1), 1u << ((key & 1) * 16));
}

// The band-local bins of points base + 32k + lane (k < UNROLL) of one cloud;
// -1 for a point at or past `end`, skipped, or outside the band.
__device__ __forceinline__ void load_keys(int (&key)[UNROLL], const int* __restrict__ xb,
                                          const int* __restrict__ yb, int base, int end, int lane,
                                          int row0, int rows, int bins) {
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const int i = base + k * 32 + lane;
    key[k] = -1;
    if (i < end) {
      const int r = __ldg(xb + i) - row0;
      const int c = __ldg(yb + i);
      if (r >= 0 && r < rows && c >= 0 && c < bins) key[k] = r * bins + c;
    }
  }
}

__global__ void __launch_bounds__(NT)
splat_kernel(const int* __restrict__ ix, const int* __restrict__ iy, float* __restrict__ out,
             int N, int bins, int band_rows, int segment, long long total) {
  extern __shared__ uint4 hist4[];  // this band's counts, 8 16-bit cells a uint4
  unsigned* hist = reinterpret_cast<unsigned*>(hist4);
  const int row0 = blockIdx.y * band_rows;
  const int rows = min(band_rows, bins - row0);
  const int cells = rows * bins;
  const int chunks = (cells + 7) / 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long pos = (long long)blockIdx.x * segment;
  const long long stop = min(pos + segment, total);

  while (pos < stop) {  // one piece of the segment a cloud
    const int b = (int)(pos / N);
    const int begin = (int)(pos - (long long)b * N);
    const int end = (int)(min(stop, (long long)(b + 1) * N) - (long long)b * N);
    const int* xb = ix + (size_t)b * N;
    const int* yb = iy + (size_t)b * N;
    float* ob = out + ((size_t)b * bins + row0) * bins;
    int key[UNROLL];
    if (end - begin <= NT * UNROLL) {
      // one pass: the keys stay in registers, and only their words are
      // zeroed and flushed (the first lane to clear a count adds it)
      load_keys(key, xb, yb, begin + warp * 32 * UNROLL, end, lane, row0, rows, bins);
#pragma unroll
      for (int k = 0; k < UNROLL; ++k)
        if (key[k] >= 0) hist[key[k] >> 1] = 0u;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) add_point(hist, key[k]);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        if (key[k] < 0) continue;
        const int shift = (key[k] & 1) * 16;
        const unsigned count = (atomicAnd(hist + (key[k] >> 1), ~(0xffffu << shift)) >> shift) & 0xffffu;
        if (count) atomicAdd(ob + key[k], (float)count);
      }
    } else {
      for (int i = threadIdx.x; i < chunks; i += NT) hist4[i] = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();
      // each warp takes 128 consecutive points a pass; lanes past `end` carry the key -1
      for (int base = begin + warp * 32 * UNROLL; base < end; base += NT * UNROLL) {
        load_keys(key, xb, yb, base, end, lane, row0, rows, bins);
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) add_point(hist, key[k]);
      }
      __syncthreads();
      // lane l adds cell base + l: a warp's atomics fall on 32 consecutive floats
      const unsigned short* counts = reinterpret_cast<const unsigned short*>(hist);
      for (int cell = threadIdx.x; cell < cells; cell += NT) {
        const unsigned count = counts[cell];
        if (count) atomicAdd(ob + cell, (float)count);
      }
    }
    __syncthreads();  // the next piece zeroes `hist` again
    pos = (long long)b * N + end;
  }
}

}  // namespace

// ix, iy: (B, N) int32, out: (B, bins, bins) float32, all contiguous on the
// device. The plan (`ops/lidar_splat.py:splat_plan`): `bands` bands of
// `band_rows` rows, the B*N points cut into segments of `segment` <= 65535
// points (one block per segment and band), `smem` bytes of shared memory a
// block (16 * ceil(band_rows * bins / 8), at most 227 KB). Zeroes `out`,
// then launches. Returns a cudaError_t (0 on a good launch).
extern "C" int ddt_lidar_splat(const void* ix, const void* iy, void* out, int B, int N,
                               int bins, int bands, int band_rows, int segment, int smem,
                               void* stream) {
  if (B <= 0 || N < 0 || bins <= 0 || bands <= 0 || band_rows <= 0 || segment < 0 ||
      segment > 65535 || (long long)bands * band_rows < bins ||
      smem < 16 * ((band_rows * bins + 7) / 8))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)B * bins * bins, s);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(splat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long total = (long long)B * N;
  const long long segments = segment ? (total + segment - 1) / segment : 1;
  const dim3 grid((unsigned)segments, bands);
  splat_kernel<<<grid, NT, smem, s>>>(static_cast<const int*>(ix), static_cast<const int*>(iy),
                                      static_cast<float*>(out), N, bins, band_rows, segment, total);
  return (int)cudaGetLastError();
}
