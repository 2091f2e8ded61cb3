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
// Design: a full 256x256 int32 histogram (256 KB) does not fit in one
// block's shared memory, so block (band, b) owns a band of `band_rows` rows
// of cloud b's histogram in shared memory as int32, scans all N points of
// that cloud and keeps those whose ix falls in its band. Every output cell is
// then written once, by one block: no global atomics, no zeroing pass, and
// the counts are exact integers, so the result does not depend on the order
// of the atomics. The price: each cloud's indices are read once per band
// (8 bands at 256 bins); the bands of one cloud run at about the same time,
// so the repeated reads can come from the L2.
// Real lidar is densest next to the ego and consecutive points of a scan
// fall into the same bin, so a warp's lanes often hit one shared address;
// __match_any_sync groups the lanes with equal keys and one leader per group
// adds the group's size, so a hot bin costs one atomic per warp, not 32.
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 512;  // threads per block

__global__ void __launch_bounds__(NT)
splat_kernel(const int* __restrict__ ix, const int* __restrict__ iy, float* __restrict__ out,
             int N, int bins, int band_rows) {
  extern __shared__ int hist[];  // [rows][bins] of this block's band
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * band_rows;
  const int rows = min(band_rows, bins - row0);
  const int cells = rows * bins;
  for (int i = threadIdx.x; i < cells; i += NT) hist[i] = 0;
  __syncthreads();

  const int* xb = ix + (size_t)b * N;
  const int* yb = iy + (size_t)b * N;
  const int lane = threadIdx.x & 31;
  // The loop bound is the same for every lane of a warp, so all 32 lanes
  // reach each __match_any_sync; lanes past N carry the key -1.
  for (int base = threadIdx.x & ~31; base < N; base += NT) {
    const int i = base + lane;
    int key = -1;
    if (i < N) {
      const int r = __ldg(xb + i) - row0;
      const int c = __ldg(yb + i);
      if (r >= 0 && r < rows && c >= 0 && c < bins) key = r * bins + c;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[key], __popc(peers));
  }
  __syncthreads();

  // counts are integers <= N < 2^24: the float conversion is exact
  float* ob = out + ((size_t)b * bins + row0) * bins;
  for (int i = threadIdx.x; i < cells; i += NT) ob[i] = (float)hist[i];
}

}  // namespace

// ix, iy: (B, N) int32, out: (B, bins, bins) float32, all contiguous on the
// device. band_rows * bins * 4 bytes of shared memory per block (at most
// 227 KB; the wrapper checks). Returns a cudaError_t (0 on a good launch).
extern "C" int ddt_lidar_splat(const void* ix, const void* iy, void* out, int B, int N,
                               int bins, int band_rows, void* stream) {
  if (B <= 0 || bins <= 0 || band_rows <= 0 || N < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)band_rows * bins;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(splat_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((bins + band_rows - 1) / band_rows, B);
  splat_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ix), static_cast<const int*>(iy), static_cast<float*>(out), N, bins,
      band_rows);
  return (int)cudaGetLastError();
}
