// Fused 3x3/s1/pad1 conv 64 -> 64 channels -> per-channel f32 affine (the
// folded eval BatchNorm) -> optional residual add -> optional ReLU, NHWC.
//
// Replaces the TPU kernel `diffusiondrive_tpu/ops/conv_fused.py:_kernel`
// (reached through `_fused_conv3x3_pallas`, pallas_call at :126): the
// layer-1 convs of both ResNet branches, 12 launches per planner forward.
//
// What bounds it on an H100 SXM: an implicit GEMM with M = pixels, N = 64,
// K = 576. At the main-path image shape (B=16, 64x256x64, bf16, with
// residual) it does 19.3 GFLOP (19.5 us at 989 TFLOP/s) and moves ~101 MB
// (30 us at 3.35 TB/s): ~192 flop/B against the ~295 the card needs before
// compute binds, so memory sets the bound. This first version runs the GEMM
// on the CUDA cores in f32 FMA (67 TFLOP/s peak), which keeps it well above
// that bound; mma/wgmma on the tensor cores is later work.
//
// Design: the TPU kernel packed two output pixels into one 128-lane row to
// fill the MXU; that packing is a TPU artefact and is not ported. Here one
// block owns an 8x16 pixel tile and all 64 output channels. It stages the
// 10x18x64 input halo and the 576x64 weights in shared memory in the input
// dtype, so each input byte is read from device memory about once
// (the halo adds 40%, served by L2). Each thread accumulates 8 pixels x 4
// channels in f32 registers; the epilogue applies the affine, adds the
// residual, applies ReLU and writes the output once: no intermediate touches
// device memory. Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using ddt::load4;
using ddt::store4;
using ddt::to_f;

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

template <typename T>
cudaError_t launch_t(const void* x, const void* w, const void* scale, const void* bias,
                     const void* res, void* out, int B, int H, int W, int relu,
                     cudaStream_t s) {
  if (res != nullptr) {
    return relu ? launch<T, true, true>(x, w, scale, bias, res, out, B, H, W, s)
                : launch<T, true, false>(x, w, scale, bias, res, out, B, H, W, s);
  }
  return relu ? launch<T, false, true>(x, w, scale, bias, res, out, B, H, W, s)
              : launch<T, false, false>(x, w, scale, bias, res, out, B, H, W, s);
}

}  // namespace

// x, res, out: (B,H,W,64) NHWC, 16-byte aligned; w: (3,3,64,64) HWIO in x's
// dtype; scale/bias: (64,) f32; res may be null. Returns a cudaError_t.
extern "C" int ddt_conv3x3_fused(const void* x, const void* w, const void* scale,
                                 const void* bias, const void* res, void* out, int B, int H,
                                 int W, int is_bf16, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch_t<__nv_bfloat16>(x, w, scale, bias, res, out, B, H, W, relu, s);
  return (int)launch_t<float>(x, w, scale, bias, res, out, B, H, W, relu, s);
}
