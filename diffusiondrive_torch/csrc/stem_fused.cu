// Fused ResNet stem: conv7x7/s2/pad3 (C -> 64) -> per-channel f32 affine
// (the folded eval BatchNorm) -> ReLU -> maxpool3x3/s2/pad1, NHWC in and out.
//
// Replaces the TPU kernel `diffusiondrive_tpu/ops/stem_fused.py:_stem_kernel`
// (reached through `_stem_pallas`, pallas_call at :153).
//
// What bounds it on an H100 SXM: at the main-path shape (B=16, 256x1024x3
// camera, bf16) the work is ~19.7 GFLOP of conv (20 us at 989 TFLOP/s) and
// ~59 MB of traffic (18 us at 3.35 TB/s), so the tensor-core rate bounds it.
// This first version runs on the CUDA cores in f32 FMA (67 TFLOP/s peak), so
// it cannot come near that bound; a wgmma implicit GEMM (K = 49*C) is later
// work.
//
// Design: the TPU kernel carried conv rows from one sequential grid step to
// the next in VMEM. Hopper blocks run in no order, so each block owns an
// 8x8 tile of pooled outputs x 64 channels and recomputes its halo: it needs
// the 17x17 conv outputs under the pool windows, which read a 39x39xC input
// patch. Patch and weights (7*7*C*64) sit in shared memory as f32; each
// thread accumulates 4 conv positions x 4 channels in registers, applies the
// affine and ReLU, and writes the conv tile to shared memory, from which the
// pool reads. Conv positions outside the image are written as 0: after ReLU
// every real value is >= 0, so a zero pad gives the same max as -inf.
// Nothing but the input, the weights and the pooled output touches device
// memory. Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using ddt::from_f;
using ddt::to_f;

constexpr int F = 64;            // output channels
constexpr int TP = 8;            // pooled tile edge
constexpr int TC = 2 * TP + 1;   // conv tile edge: 17
constexpr int TI = 2 * TC + 5;   // input patch edge: 39
constexpr int NPOS = TC * TC;    // 289 conv positions per tile
constexpr int NT = 256;          // threads: 16 channel groups x 16 position groups

template <int C>
__host__ __device__ constexpr int patch_floats() { return ((TI * TI * C + 3) / 4) * 4; }

template <int C>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(49 * C * F + patch_floats<C>() + NPOS * F);
}

template <typename T, int C>
__global__ void __launch_bounds__(NT)
stem_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias,
            T* __restrict__ out, int H, int W, int Hc, int Wc, int Hp, int Wp) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                          // [7][7][C][64]
  float* patch = ws + 49 * C * F;            // [TI][TI][C]
  float* ctile = patch + patch_floats<C>();  // [TC*TC][64]

  const int b = blockIdx.z;
  const int pr0 = blockIdx.y * TP, pc0 = blockIdx.x * TP;
  const int cr0 = 2 * pr0 - 1, cc0 = 2 * pc0 - 1;  // first conv row / col
  const int ir0 = 2 * cr0 - 3, ic0 = 2 * cc0 - 3;  // first input row / col
  const int tid = threadIdx.x;

  for (int i = tid; i < 49 * C * F; i += NT) ws[i] = to_f(w[i]);
  const T* xb = x + (size_t)b * H * W * C;
  for (int i = tid; i < TI * TI * C; i += NT) {
    const int c = i % C, pix = i / C;
    const int ir = ir0 + pix / TI, ic = ic0 + pix % TI;
    float v = 0.f;
    if (ir >= 0 && ir < H && ic >= 0 && ic < W) v = to_f(xb[((size_t)ir * W + ic) * C + c]);
    patch[i] = v;
  }
  __syncthreads();

  const int cg = tid & 15, pg = tid >> 4;
  float sc[4], bi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    sc[q] = scale[4 * cg + q];
    bi[q] = bias[4 * cg + q];
  }
  const float4* ws4 = reinterpret_cast<const float4*>(ws);

  // position p = pg + 16*k, k = 0..18, in chunks of 4
  for (int k0 = 0; k0 < (NPOS + 15) / 16; k0 += 4) {
    int off[4];
    bool valid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = pg + 16 * (k0 + j);
      valid[j] = p < NPOS;
      const int pp = valid[j] ? p : 0;
      off[j] = (2 * (pp / TC) * TI + 2 * (pp % TC)) * C;
    }
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

    for (int ky = 0; ky < 7; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 7; ++kx) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float4 wv = ws4[((ky * 7 + kx) * C + c) * (F / 4) + cg];
          const int po = (ky * TI + kx) * C + c;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v = patch[off[j] + po];
            acc[j][0] = fmaf(v, wv.x, acc[j][0]);
            acc[j][1] = fmaf(v, wv.y, acc[j][1]);
            acc[j][2] = fmaf(v, wv.z, acc[j][2]);
            acc[j][3] = fmaf(v, wv.w, acc[j][3]);
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!valid[j]) continue;
      const int p = pg + 16 * (k0 + j);
      const int gr = cr0 + p / TC, gc = cc0 + p % TC;
      const bool inside = gr >= 0 && gr < Hc && gc >= 0 && gc < Wc;
      float4 r;
      r.x = inside ? fmaxf(fmaf(acc[j][0], sc[0], bi[0]), 0.f) : 0.f;
      r.y = inside ? fmaxf(fmaf(acc[j][1], sc[1], bi[1]), 0.f) : 0.f;
      r.z = inside ? fmaxf(fmaf(acc[j][2], sc[2], bi[2]), 0.f) : 0.f;
      r.w = inside ? fmaxf(fmaf(acc[j][3], sc[3], bi[3]), 0.f) : 0.f;
      reinterpret_cast<float4*>(ctile)[p * (F / 4) + cg] = r;
    }
  }
  __syncthreads();

  T* ob = out + (size_t)b * Hp * Wp * F;
  for (int i = tid; i < TP * TP * F; i += NT) {
    const int ch = i % F, q = i / F;
    const int pr = q / TP, pc = q % TP;
    const int gpr = pr0 + pr, gpc = pc0 + pc;
    if (gpr >= Hp || gpc >= Wp) continue;
    float m = 0.f;  // every conv value is >= 0 after ReLU
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = fmaxf(m, ctile[((2 * pr + dy) * TC + 2 * pc + dx) * F + ch]);
    ob[((size_t)gpr * Wp + gpc) * F + ch] = from_f<T>(m);
  }
}

template <typename T, int C>
cudaError_t launch(const void* x, const void* w, const void* scale, const void* bias,
                   void* out, int B, int H, int W, cudaStream_t stream) {
  const int Hc = H / 2, Wc = W / 2, Hp = Hc / 2, Wp = Wc / 2;
  const size_t smem = smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(stem_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Wp + TP - 1) / TP, (Hp + TP - 1) / TP, B);
  stem_kernel<T, C><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), H, W, Hc, Wc, Hp, Wp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_c(const void* x, const void* w, const void* scale, const void* bias,
                     void* out, int B, int H, int W, int C, cudaStream_t stream) {
  switch (C) {
    case 1: return launch<T, 1>(x, w, scale, bias, out, B, H, W, stream);
    case 2: return launch<T, 2>(x, w, scale, bias, out, B, H, W, stream);
    case 3: return launch<T, 3>(x, w, scale, bias, out, B, H, W, stream);
    case 4: return launch<T, 4>(x, w, scale, bias, out, B, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (B,H,W,C) NHWC, w: (7,7,C,64) HWIO in x's dtype, scale/bias: (64,) f32,
// out: (B,H/4,W/4,64) NHWC. Requires 1 <= C <= 4 and H, W multiples of 4
// (the wrapper checks). Returns a cudaError_t (0 on a good launch).
extern "C" int ddt_stem_fused(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int B, int H, int W, int C,
                              int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch_c<__nv_bfloat16>(x, w, scale, bias, out, B, H, W, C, s);
  return (int)launch_c<float>(x, w, scale, bias, out, B, H, W, C, s);
}
