// Fused 3x3/s1/pad1 conv 64 -> 64 channels -> per-channel f32 affine (the
// folded eval BatchNorm) -> optional residual add -> optional ReLU, NHWC.
//
// Replaces the TPU kernel `diffusiondrive_tpu/ops/conv_fused.py:_kernel`
// (reached through `_fused_conv3x3_pallas`, pallas_call at :126): the
// layer-1 convs of both ResNet branches, 12 launches per planner forward;
// on the train path (`conv3x3_train`) the forward with an identity affine
// and the input gradient with flipped, transposed weights, 24 a step.
//
// What bounds it on an H100 SXM: an implicit GEMM with M = pixels, N = 64,
// K = 9 taps x 64 channels = 576. At the main-path image shape (B=16,
// 64x256x64, bf16, with residual) it does 19.3 GFLOP (19.5 us at 989
// TFLOP/s) and moves ~101 MB (30 us at 3.35 TB/s): ~192 flop/B against the
// ~295 the card needs before compute binds, so memory sets the bound. In
// float32 at float32 accuracy (three TF32 products a product, below) the
// same call is 58 GFLOP of TF32 products (117 us at 494.7 TFLOP/s) against
// 201 MB (60 us): operations set the bound.
// What the JAX kernel keeps, both kernels keep: an f32 sum over the 9 taps
// x 64 channels, the affine, residual and ReLU in f32, one rounding to the
// output dtype at the end, nothing intermediate in device memory. The
// TPU's packing of two output pixels into one 128-lane row is an MXU
// artefact and is not ported.
//
// Two kernels, chosen by dtype alone, both on the tensor cores (mma.sync,
// f32 accumulators), both a persistent grid of one 8-warp block per SM
// walking over 16x16-pixel output tiles, each warp owning 2 output rows x
// 16 pixels x 64 channels (64 f32 accumulators a thread). The im2col
// matrix is never built: for tap (ky, kx) the 16 rows of an A fragment are
// 16 consecutive output pixels shifted by (ky, kx) in the halo, so an
// ldmatrix row address is the shifted pixel plus the k-chunk. Pixel rows
// of 128 bytes are stored as 8 16-byte chunks, chunk c of row r at
// c ^ (r & 7) (`swz`), which any 8 consecutive rows spread over all 32
// banks, under any tap shift. The epilogue applies the affine, adds the
// residual, applies ReLU and rounds once, straight from the C fragments.
// No atomics: every call gives the same bits.
// - bf16: `conv3x3_mma_kernel`, m16n8k16. It stages the 576x64 weight
//   (73.7 KB) in shared memory once and double-buffers 18x18-pixel halos
//   (each pixel's 64 channels 128 bytes) by cp.async, zero-filled past the
//   image: the next tile's halo lands while the current one is computed. B
//   fragments come from the HWIO weight rows (output channel contiguous)
//   by ldmatrix.trans. A k-step of 16 is 6 ldmatrix.x4 for 16 mma.
// - float32: `conv3x3_tf32x3_kernel`, m16n8k8 TF32 in three products a
//   product (3xTF32, `ddt::mma_tf32x3`): one TF32 product keeps 11
//   significant bits of each operand and breaks float32's 1e-4 limit
//   against the plain version over K = 576 terms; each operand is split
//   into big (TF32, to nearest) and small = x - big (`ddt::split_tf32`) and
//   the product taken as small.big + big.small + big.big, about 21 bits.
//   Shared memory is what bf16's layout does not meet here: the float32
//   weight is 147,456 bytes and an 18x18-pixel halo of 64 channels 82,944,
//   so the weight and two halos (313 KB) pass the 227 KB a block may use.
//   The weight stays resident and the halo is double-buffered by channel
//   half instead: a stage is one tile's 18x18 pixels x 32 channels (128
//   bytes a pixel, 41,472 a buffer: 230,400 bytes in all), and a tile is
//   two stages into the same accumulators. While one half is computed the
//   other buffer takes the next stage (this tile's second half, or the
//   next tile's first), so each load overlaps a half tile's products, as
//   bf16's whole halos do. The weight is stored k-contiguous, [tap][half]
//   [output channel][32 input channels] (transposed from HWIO once per
//   block), in the same swizzled 128-byte rows: ldmatrix.trans cannot
//   transpose 32-bit elements, but ldmatrix (b16) of an 8x8 b16 matrix
//   gives lane i row i/4, float i%4, which is the A fragment's a0 (a1, a2,
//   a3 from the other three matrices) for a pixel-major halo and the B
//   fragment's b0 (b1) for a k-contiguous weight row. A k-step of 8 is 6
//   ldmatrix.x4 for 48 mma. The split: each warp splits its two A
//   fragments once a k-step (8 values a thread, reused over the 8 n8 tiles)
//   and each B fragment once as it is read (16 values a thread, reused over
//   the 2 m16 tiles); the weight's split is paid by each of the 8 warps at
//   each tile, 72 ALU instructions a k-step against 48 mma (a split weight
//   held in shared memory would need twice its 147 KB). Taps are unrolled
//   a row (3) at a time: whole, the 36 k-steps of a half spill.
// Both launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int CH = 64;  // input = output channels

// ---- bf16 on the tensor cores ----

using bf16 = __nv_bfloat16;
using ddt::cp_async16;
using ddt::cp_async_commit;
using ddt::cp_async_wait;
using ddt::ldsm_x4;
using ddt::ldsm_x4_trans;
using ddt::mma_bf16;
using ddt::smem_u32;

constexpr int MWARPS = 8;
constexpr int MNT = 32 * MWARPS;             // threads
constexpr int MT = 2;                        // output rows per warp, an m16 tile of 16 pixels each
constexpr int MTH = MWARPS * MT, MTW = 16;   // output tile
constexpr int MHH = MTH + 2, MHW = MTW + 2;  // its halo
constexpr int ROW = CH * 2;                  // bytes of a pixel or a weight row: 8 chunks of 16
constexpr int W_BYTES = 9 * CH * ROW;
constexpr int HALO_BYTES = MHH * MHW * ROW;
constexpr int MMA_SMEM = W_BYTES + 2 * HALO_BYTES;  // weights + two halo buffers
static_assert(MMA_SMEM <= 232448, "shared memory of one block");

// Byte offset of 16-byte chunk c of row r in a [rows][8 chunks] array whose
// chunks are XOR-swizzled by the row: the 8 rows of an ldmatrix 8x8 hit
// distinct banks.
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * ROW + ((c ^ (r & 7)) << 4); }

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_y) {
  const int per_image = tiles_x * tiles_y, b = t / per_image, r = t - b * per_image;
  const int ty = r / tiles_x;
  return Tile{b, ty * MTH, (r - ty * tiles_x) * MTW};
}

// The (MHH, MHW) input halo of tile `t` into `dst`, 128 bytes a pixel from
// channel C0 on (bf16: all 64; float32: one half of them), by 16-byte
// cp.async; pixels outside the image are zero-filled (the conv's padding
// and the ragged edges).
template <typename T, int C0>
__device__ __forceinline__ void load_halo(uint32_t dst, const T* __restrict__ x, Tile t, int H, int W) {
  constexpr int V = 16 / sizeof(T);  // elements a chunk
  for (int i = threadIdx.x; i < MHH * MHW * 8; i += MNT) {
    const int p = i >> 3, c = i & 7;
    const int hy = p / MHW, gy = t.y0 - 1 + hy, gx = t.x0 - 1 + (p - hy * MHW);
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async16(dst + swz(p, c), in ? x + (((size_t)t.b * H + gy) * W + gx) * CH + C0 + c * V : x,
               in ? 16 : 0);
  }
}

template <bool RES, bool RELU>
__global__ void __launch_bounds__(MNT, 1)
conv3x3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const bf16* __restrict__ res, bf16* __restrict__ out, int B, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem_conv[];
  const uint32_t ws = smem_u32(smem_conv), halo = ws + W_BYTES;
  const int tiles_x = (W + MTW - 1) / MTW, tiles_y = (H + MTH - 1) / MTH;
  const int ntiles = B * tiles_x * tiles_y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the weight, [tap * 64 + ci][co], once per block; then the first halo
  for (int i = threadIdx.x; i < 9 * CH * 8; i += MNT) cp_async16(ws + swz(i >> 3, i & 7), w + i * 8, 16);
  int tile = blockIdx.x;
  load_halo<bf16, 0>(halo, x, tile_at(tile, tiles_x, tiles_y), H, W);
  cp_async_commit();

  // this lane's ldmatrix row in a 16x16 fragment (A: pixel; B: k row) and
  // its 16-byte chunk half; its C fragment row and column pair
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = lane >> 4;
  const int g = lane >> 2, cq = 2 * (lane & 3);

  for (int buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < ntiles) load_halo<bf16, 0>(halo + (buf ^ 1) * HALO_BYTES, x, tile_at(next, tiles_x, tiles_y), H, W);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's halo (and the weight) have landed
    __syncthreads();

    const uint32_t hb = halo + buf * HALO_BYTES;
    float acc[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      int p[MT];  // the halo pixel of this lane's A row, shifted by the tap
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) p[mt] = (warp * MT + mt + ky) * MHW + lr + kx;
#pragma unroll
      for (int kc = 0; kc < CH / 16; ++kc) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], hb + swz(p[mt], 2 * kc + lc));
        const int kr = tap * CH + kc * 16 + lr;
#pragma unroll
        for (int np = 0; np < 4; ++np) {  // output channels 16 np .. 16 np + 15
          uint32_t b[4];
          ldsm_x4_trans(b, ws + swz(kr, 2 * np + lc));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer: the next iteration refills it

    const Tile t = tile_at(tile, tiles_x, tiles_y);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + cq;
      const float2 sc = *reinterpret_cast<const float2*>(scale + c);
      const float2 bi = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int gy = t.y0 + warp * MT + mt;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gx = t.x0 + g + 8 * half;
          if (gy >= H || gx >= W) continue;
          const size_t o = (((size_t)t.b * H + gy) * W + gx) * CH + c;
          float v0 = fmaf(acc[mt][nt][2 * half], sc.x, bi.x);
          float v1 = fmaf(acc[mt][nt][2 * half + 1], sc.y, bi.y);
          if (RES) {
            const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + o));
            v0 += r.x;
            v1 += r.y;
          }
          if (RELU) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// ---- float32 on the tensor cores, 3xTF32 ----

using ddt::mma_tf32x3;
using ddt::split_tf32x4;

constexpr int HALF = CH / 2;                   // input channels a stage: 32 floats, a 128-byte row
constexpr int F_HALO_BYTES = MHH * MHW * ROW;  // one stage: 18 x 18 pixels x 32 channels
constexpr int F_W_BYTES = 9 * 2 * CH * ROW;    // [tap][half][64 out][32 in] floats
constexpr int F_SMEM = F_W_BYTES + 2 * F_HALO_BYTES;  // weight + two stage buffers
static_assert(F_SMEM <= 232448, "shared memory of one block");

template <bool RES, bool RELU>
__global__ void __launch_bounds__(MNT, 1)
conv3x3_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      const float* __restrict__ res, float* __restrict__ out, int B, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem_f32[];
  const uint32_t ws = smem_u32(smem_f32), halo = ws + F_W_BYTES;
  const int tiles_x = (W + MTW - 1) / MTW, tiles_y = (H + MTH - 1) / MTH;
  const int ntiles = B * tiles_x * tiles_y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the first stage (first tile, channels 0..31) into buffer 0; meanwhile the
  // weight, transposed once per block from HWIO to k-contiguous rows: row
  // (tap * 2 + half) * 64 + co holds w[tap][32 half .. 32 half + 31][co]
  int tile = blockIdx.x;
  load_halo<float, 0>(halo, x, tile_at(tile, tiles_x, tiles_y), H, W);
  cp_async_commit();
  for (int i = threadIdx.x; i < 9 * CH * (CH / 4); i += MNT) {
    const int co = i & (CH - 1), q = i / CH, tap = q >> 4, ck = q & 15;  // ck: 4 input channels
    const float* src = w + ((size_t)tap * CH + 4 * ck) * CH + co;
    *reinterpret_cast<float4*>(smem_f32 + swz((tap * 2 + (ck >> 3)) * CH + co, ck & 7)) =
        make_float4(src[0], src[CH], src[2 * CH], src[3 * CH]);
  }

  // this lane's ldmatrix row and 16-byte chunk half: A (pixel; matrices
  // rows 0-7, 8-15 of k 0-3, then of k 4-7) and B (output channel; matrices
  // n 0-7 k 0-3, n 0-7 k 4-7, n 8-15 k 0-3, n 8-15 k 4-7); its C fragment
  // row and column pair
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = lane >> 4;
  const int br = (lane & 7) + (lane >> 4) * 8, bc = (lane >> 3) & 1;
  const int g = lane >> 2, cq = 2 * (lane & 3);

  for (; tile < ntiles; tile += gridDim.x) {
    const Tile t = tile_at(tile, tiles_x, tiles_y);
    const int next = tile + gridDim.x;
    float acc[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      // the other buffer takes the next stage: this tile's channels 32..63,
      // or the next tile's 0..31
      if (half == 0) {
        load_halo<float, HALF>(halo + F_HALO_BYTES, x, t, H, W);
      } else if (next < ntiles) {
        load_halo<float, 0>(halo, x, tile_at(next, tiles_x, tiles_y), H, W);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this stage (and the weight) have landed
      __syncthreads();

      const uint32_t hb = halo + half * F_HALO_BYTES;
#pragma unroll 3  // a tap row: whole, the 9 taps spill (255 registers)
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap - 3 * ky;
        const uint32_t wb = ws + (tap * 2 + half) * CH * ROW;
        int p[MT];  // the halo pixel of this lane's A row, shifted by the tap
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) p[mt] = (warp * MT + mt + ky) * MHW + lr + kx;
#pragma unroll
        for (int ks = 0; ks < HALF / 8; ++ks) {
          uint32_t ab[MT][4], as[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t r[4];
            ldsm_x4(r, hb + swz(p[mt], 2 * ks + lc));
            split_tf32x4(r, ab[mt], as[mt]);
          }
#pragma unroll
          for (int np = 0; np < 4; ++np) {  // output channels 16 np .. 16 np + 15
            uint32_t r[4], bb[4], bs[4];    // b0, b1 of n8 tile 2 np, then of 2 np + 1
            ldsm_x4(r, wb + swz(16 * np + br, 2 * ks + bc));
            split_tf32x4(r, bb, bs);
            const uint32_t bb0[2] = {bb[0], bb[1]}, bs0[2] = {bs[0], bs[1]};
            const uint32_t bb1[2] = {bb[2], bb[3]}, bs1[2] = {bs[2], bs[3]};
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_tf32x3(acc[mt][2 * np], ab[mt], as[mt], bb0, bs0);
              mma_tf32x3(acc[mt][2 * np + 1], ab[mt], as[mt], bb1, bs1);
            }
          }
        }
      }
      __syncthreads();  // every warp is done with this buffer: the next stage refills it
    }

#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + cq;
      const float2 sc = *reinterpret_cast<const float2*>(scale + c);
      const float2 bi = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int gy = t.y0 + warp * MT + mt;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int gx = t.x0 + g + 8 * hf;
          if (gy >= H || gx >= W) continue;
          const size_t o = (((size_t)t.b * H + gy) * W + gx) * CH + c;
          float v0 = fmaf(acc[mt][nt][2 * hf], sc.x, bi.x);
          float v1 = fmaf(acc[mt][nt][2 * hf + 1], sc.y, bi.y);
          if (RES) {
            const float2 r = *reinterpret_cast<const float2*>(res + o);
            v0 += r.x;
            v1 += r.y;
          }
          if (RELU) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
        }
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

// The dtype's kernel and its dynamic shared memory.
template <typename T, bool RES, bool RELU>
auto kernel_of() {
  if constexpr (std::is_same_v<T, bf16>) {
    return conv3x3_mma_kernel<RES, RELU>;
  } else {
    return conv3x3_tf32x3_kernel<RES, RELU>;
  }
}

template <typename T>
constexpr int smem_of() { return std::is_same_v<T, bf16> ? MMA_SMEM : F_SMEM; }

// The shared-memory limit is set, and the SM count read, once per device
// and kernel: no driver call on the launches after. The grid is one block
// per SM, or one per tile where there are fewer tiles.
template <typename T, bool RES, bool RELU>
cudaError_t launch(const void* x, const void* w, const void* scale, const void* bias,
                   const void* res, void* out, int B, int H, int W, cudaStream_t stream) {
  static std::atomic<int> sms[MAX_DEVICES];
  const auto kernel = kernel_of<T, RES, RELU>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n = dev < MAX_DEVICES ? sms[dev].load() : 0;
  if (n == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_of<T>());
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) sms[dev].store(n);
  }
  const long long tiles = (long long)B * ((H + MTH - 1) / MTH) * ((W + MTW - 1) / MTW);
  kernel<<<(int)std::min<long long>(tiles, n), MNT, smem_of<T>(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const T*>(res), static_cast<T*>(out), B, H, W);
  return cudaGetLastError();
}

template <bool RES, bool RELU>
cudaError_t run(bool is_bf16, const void* x, const void* w, const void* scale, const void* bias,
                const void* res, void* out, int B, int H, int W, cudaStream_t s) {
  return is_bf16 ? launch<bf16, RES, RELU>(x, w, scale, bias, res, out, B, H, W, s)
                 : launch<float, RES, RELU>(x, w, scale, bias, res, out, B, H, W, s);
}

}  // namespace

// x, res, out: (B,H,W,64) NHWC, 16-byte aligned; w: (3,3,64,64) HWIO in x's
// dtype; scale/bias: (64,) f32; res may be null. bf16 runs
// `conv3x3_mma_kernel`, float32 `conv3x3_tf32x3_kernel`. Returns a cudaError_t.
extern "C" int ddt_conv3x3_fused(const void* x, const void* w, const void* scale,
                                 const void* bias, const void* res, void* out, int B, int H,
                                 int W, int is_bf16, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  if (res != nullptr) {
    return relu ? (int)run<true, true>(bf, x, w, scale, bias, res, out, B, H, W, s)
                : (int)run<true, false>(bf, x, w, scale, bias, res, out, B, H, W, s);
  }
  return relu ? (int)run<false, true>(bf, x, w, scale, bias, res, out, B, H, W, s)
              : (int)run<false, false>(bf, x, w, scale, bias, res, out, B, H, W, s);
}
