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
// ~295 the card needs before compute binds, so memory sets the bound.
// What the JAX kernel keeps, both kernels keep: an f32 sum over the 9 taps
// x 64 channels, the affine, residual and ReLU in f32, one rounding to the
// output dtype at the end, nothing intermediate in device memory. The
// TPU's packing of two output pixels into one 128-lane row is an MXU
// artefact and is not ported.
//
// Two kernels, chosen by dtype alone:
// - bf16: `conv3x3_mma_kernel`, on the tensor cores (mma.sync m16n8k16,
//   f32 accumulators). A persistent grid, one block of 8 warps per SM,
//   stages the 576x64 weight (73.7 KB) in shared memory once and walks over
//   16x16-pixel output tiles; the next tile's 18x18-pixel halo comes in by
//   cp.async (zero-filled past the image) while the current one is
//   computed. The im2col matrix is never built: for tap (ky, kx) the 16 rows
//   of an A fragment are 16 consecutive output pixels shifted by (ky, kx)
//   in the halo, each pixel's 64 channels 128 contiguous bytes, so an
//   ldmatrix row address is the shifted pixel plus the k-chunk. B fragments
//   come from the HWIO weight rows (output channel contiguous) by
//   ldmatrix.trans. A warp owns 2 output rows x 16 pixels x 64 channels
//   (64 f32 accumulators a thread): a k-step of 16 is 6 ldmatrix.x4 for 16
//   mma. Pixels and weight rows are 128 bytes, so the 8 rows of an
//   ldmatrix 8x8 would share four banks; the 16-byte chunk c of row r is
//   stored at c ^ (r & 7), which any 8 consecutive rows spread over all 32
//   banks, under any tap shift. The epilogue applies the affine, adds the
//   residual (bf16x2, widened), applies ReLU and rounds to bf16 once,
//   straight from the C fragments. No atomics: every call gives the same
//   bits.
// - float32: `conv3x3_kernel`, f32 FMAs on the CUDA cores (TF32 products
//   would break float32's 1e-4 limit against the plain version). One block
//   owns an 8x16 pixel tile and all 64 output channels; it stages the
//   10x18x64 input halo and the 576x64 weights in shared memory, and each
//   thread accumulates 8 pixels x 4 channels.
// Both launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using ddt::load4;
using ddt::store4;
using ddt::to_f;

// ---- float32 on the CUDA cores ----

constexpr int CH = 64;           // input = output channels
constexpr int TH = 8, TW = 16;   // output tile
constexpr int HH = TH + 2, HW = TW + 2;
constexpr int NT = 256;          // 16 channel groups x 16 pixel groups

template <typename T>
constexpr size_t smem_bytes() { return sizeof(T) * (size_t)(9 * CH * CH + HH * HW * CH); }

template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               const T* __restrict__ res, T* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);   // [3][3][64 in][64 out]
  T* halo = ws + 9 * CH * CH;               // [HH][HW][64]

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;

  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte copy
  const uint4* w16 = reinterpret_cast<const uint4*>(w);
  uint4* ws16 = reinterpret_cast<uint4*>(ws);
  for (int i = tid; i < 9 * CH * CH / VEC; i += NT) ws16[i] = w16[i];

  const T* xb = x + (size_t)b * H * W * CH;
  constexpr int VPP = CH / VEC;             // 16-byte copies per pixel
  uint4* halo16 = reinterpret_cast<uint4*>(halo);
  for (int i = tid; i < HH * HW * VPP; i += NT) {
    const int v = i % VPP, pix = i / VPP;
    const int gy = y0 - 1 + pix / HW, gx = x0 - 1 + pix % HW;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      val = reinterpret_cast<const uint4*>(xb + ((size_t)gy * W + gx) * CH)[v];
    halo16[i] = val;
  }
  __syncthreads();

  const int cg = tid & 15, pg = tid >> 4;
  const int py = pg >> 1, px0 = (pg & 1) * 8;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const T* wrow = ws + (ky * 3 + kx) * CH * CH + 4 * cg;
      const T* hrow = halo + ((py + ky) * HW + px0 + kx) * CH;
#pragma unroll 4
      for (int ci = 0; ci < CH; ++ci) {
        const float4 wv = load4(wrow + ci * CH);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = to_f(hrow[j * CH + ci]);
          acc[j][0] = fmaf(v, wv.x, acc[j][0]);
          acc[j][1] = fmaf(v, wv.y, acc[j][1]);
          acc[j][2] = fmaf(v, wv.z, acc[j][2]);
          acc[j][3] = fmaf(v, wv.w, acc[j][3]);
        }
      }
    }
  }

  const int gy = y0 + py;
  if (gy >= H) return;
  float sc[4], bi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    sc[q] = scale[4 * cg + q];
    bi[q] = bias[4 * cg + q];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int gx = x0 + px0 + j;
    if (gx >= W) continue;
    const size_t o = (((size_t)b * H + gy) * W + gx) * CH + 4 * cg;
    float4 r = make_float4(fmaf(acc[j][0], sc[0], bi[0]), fmaf(acc[j][1], sc[1], bi[1]),
                           fmaf(acc[j][2], sc[2], bi[2]), fmaf(acc[j][3], sc[3], bi[3]));
    if (RES) {
      const float4 rv = load4(res + o);
      r.x += rv.x; r.y += rv.y; r.z += rv.z; r.w += rv.w;
    }
    if (RELU) {
      r.x = fmaxf(r.x, 0.f); r.y = fmaxf(r.y, 0.f);
      r.z = fmaxf(r.z, 0.f); r.w = fmaxf(r.w, 0.f);
    }
    store4(out + o, r);
  }
}

template <typename T, bool RES, bool RELU>
cudaError_t launch(const void* x, const void* w, const void* scale, const void* bias,
                   const void* res, void* out, int B, int H, int W, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<T, RES, RELU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  conv3x3_kernel<T, RES, RELU><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const T*>(res), static_cast<T*>(out), H, W);
  return cudaGetLastError();
}

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

// The (MHH, MHW) input halo of tile `t` into `dst`, by 16-byte cp.async;
// pixels outside the image are zero-filled (the conv's padding and the
// ragged edges).
__device__ __forceinline__ void load_halo(uint32_t dst, const bf16* __restrict__ x, Tile t, int H,
                                          int W) {
  for (int i = threadIdx.x; i < MHH * MHW * 8; i += MNT) {
    const int p = i >> 3, c = i & 7;
    const int hy = p / MHW, gy = t.y0 - 1 + hy, gx = t.x0 - 1 + (p - hy * MHW);
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async16(dst + swz(p, c), in ? x + (((size_t)t.b * H + gy) * W + gx) * CH + c * 8 : x,
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
  load_halo(halo, x, tile_at(tile, tiles_x, tiles_y), H, W);
  cp_async_commit();

  // this lane's ldmatrix row in a 16x16 fragment (A: pixel; B: k row) and
  // its 16-byte chunk half; its C fragment row and column pair
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = lane >> 4;
  const int g = lane >> 2, cq = 2 * (lane & 3);

  for (int buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < ntiles) load_halo(halo + (buf ^ 1) * HALO_BYTES, x, tile_at(next, tiles_x, tiles_y), H, W);
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

constexpr int MAX_DEVICES = 64;

// The shared-memory limit is set, and the SM count read, once per device:
// no driver call on the launches after. The grid is one block per SM, or
// one per tile where there are fewer tiles.
template <bool RES, bool RELU>
cudaError_t launch_mma(const void* x, const void* w, const void* scale, const void* bias,
                       const void* res, void* out, int B, int H, int W, cudaStream_t stream) {
  static std::atomic<int> sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n = dev < MAX_DEVICES ? sms[dev].load() : 0;
  if (n == 0) {
    err = cudaFuncSetAttribute(conv3x3_mma_kernel<RES, RELU>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) sms[dev].store(n);
  }
  const long long tiles = (long long)B * ((H + MTH - 1) / MTH) * ((W + MTW - 1) / MTW);
  conv3x3_mma_kernel<RES, RELU><<<(int)std::min<long long>(tiles, n), MNT, MMA_SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const bf16*>(res), static_cast<bf16*>(out), B, H, W);
  return cudaGetLastError();
}

template <bool RES, bool RELU>
cudaError_t run(bool is_bf16, const void* x, const void* w, const void* scale, const void* bias,
                const void* res, void* out, int B, int H, int W, cudaStream_t s) {
  return is_bf16 ? launch_mma<RES, RELU>(x, w, scale, bias, res, out, B, H, W, s)
                 : launch<float, RES, RELU>(x, w, scale, bias, res, out, B, H, W, s);
}

}  // namespace

// x, res, out: (B,H,W,64) NHWC, 16-byte aligned; w: (3,3,64,64) HWIO in x's
// dtype; scale/bias: (64,) f32; res may be null. bf16 runs on the tensor
// cores, float32 on the CUDA cores. Returns a cudaError_t.
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
