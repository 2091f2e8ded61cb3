// Fused ResNet stem: conv7x7/s2/pad3 (C -> 64) -> per-channel f32 affine
// (the folded eval BatchNorm) -> ReLU -> maxpool3x3/s2/pad1, NHWC in and out.
//
// Replaces the TPU kernel `diffusiondrive_tpu/ops/stem_fused.py:_stem_kernel`
// (reached through `_stem_pallas`, pallas_call at :153).
//
// What bounds it on an H100 SXM: at the main-path shape (B=16, 256x1024x3
// camera, bf16) the conv does ~19.7 GFLOP of real products (20 us at 989
// TFLOP/s) and the call moves ~59 MB (18 us at 3.35 TB/s): the two bounds
// are close. What the JAX kernel keeps, both kernels keep: an f32 sum, the
// affine and ReLU in f32, one rounding to the output dtype, the pool from
// on-chip memory, nothing intermediate in device memory. The TPU's planar
// lane layout and its lane-shifted triples are MXU artefacts and are not
// ported.
//
// Two kernels, chosen by dtype alone:
// - bf16: `stem_mma_kernel<C>`, on the tensor cores (mma.sync m16n8k16, f32
//   accumulators), for every C = 1..4. A 2x2 space-to-depth (s2d) of the
//   input turns the 7x7/s2 conv into a 4x4/s1 conv over (H/2, W/2, 4C): conv
//   output y reads s2d rows y-2 .. y+1, and s2d channel pr*2C + pc*C + c of
//   s2d row i is input row 2i+pr, column 2j+pc, channel c; tap (dr, dc) of
//   the 4x4 conv is the 7x7 tap (2dr+pr-1, 2dc+pc-1), zero where that falls
//   outside (dr or dc = 0 with parity 0). Each s2d pixel is padded to 16
//   channels, so each of the 16 taps is one k-step of 16 (K = 256 against
//   49*C real products: 1.74x for the camera, 5.2x for the lidar).
//   A persistent grid, one block of 12 warps per SM, builds that 256x64
//   weight from the HWIO weight in shared memory once (zero rows included)
//   and walks over tiles of 8x16 pooled outputs. A tile needs 17x33 conv
//   positions (its pool windows) and a 20x36-pixel s2d halo, which the
//   input's rows give directly (two input rows make one s2d row: the 2C
//   values of two neighbouring pixels are contiguous), by cp.async
//   (zero-filled past the image), double-buffered: the next tile's halo
//   lands while this one is computed. M is the tile's 561 conv positions,
//   flattened (36 m16 tiles, 3 a warp): ldmatrix takes one row address per
//   lane, so a fragment's rows may cross a conv row, and tap (dr, dc) is
//   the same ldmatrix at a constant shifted address. An s2d pixel takes 48
//   bytes of shared memory (32 used): any 8 consecutive pixels then fall
//   on distinct banks with no swizzle, so the tap shift stays a constant
//   offset. B fragments come from the weight rows by ldmatrix.trans (rows
//   XOR-swizzled as in `conv3x3_fused.cu`). The epilogue applies the affine
//   and ReLU to the f32 C fragments and rounds to bf16 once, where JAX's
//   `conv_ref` rounds, into a conv tile in shared memory by stmatrix
//   (positions outside the image are 0: after ReLU every value is >= 0, so
//   a zero pad gives the same max as -inf). The 3x3/s2 pool of that conv
//   tile (16-byte NHWC stores) runs in the next tile's iteration, after each
//   warp's products, so one warp's pool overlaps the others' mma. No
//   atomics: every call gives the same bits.
// - float32: `stem_kernel`, f32 FMAs on the CUDA cores (TF32 products would
//   break float32's 1e-4 limit against the plain version). Each block owns
//   an 8x8 tile of pooled outputs and recomputes its halo: the 17x17 conv
//   outputs under the pool windows, from a 39x39xC input patch. Patch and
//   weights (7*7*C*64) sit in shared memory as f32; each thread accumulates
//   4 conv positions x 4 channels, applies the affine and ReLU, and writes
//   the conv tile to shared memory, from which the pool reads.
// Both launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using ddt::from_f;
using ddt::to_f;

// ---- float32 on the CUDA cores ----

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

// ---- bf16 on the tensor cores ----

using bf16 = __nv_bfloat16;
using ddt::cp_async16;
using ddt::cp_async4;
using ddt::cp_async8;
using ddt::cp_async_commit;
using ddt::cp_async_wait;
using ddt::ldsm_x4;
using ddt::ldsm_x4_trans;
using ddt::mma_bf16;
using ddt::pack_bf16;
using ddt::smem_u32;
using ddt::stsm_x4;

constexpr int PT = 8, QT = 16;                     // pooled tile: rows, columns
constexpr int CTR = 2 * PT + 1, CTW = 2 * QT + 1;  // its conv positions: 17 x 33
constexpr int CPOS = CTR * CTW;                    // 561
constexpr int SR = CTR + 3, SWD = CTW + 3;         // its s2d halo: 20 x 36 pixels
constexpr int PIX = 48;                            // shared bytes of an s2d pixel (16 bf16 used)
constexpr int MWARPS = 12, MT = 3;                 // warps; m16 tiles a warp
constexpr int MNT = 32 * MWARPS;
constexpr int KROWS = 16 * 16;                     // 16 taps x 16 s2d channels
constexpr int ROW = F * 2;                         // bytes of a weight row or a conv position
constexpr int W_BYTES = KROWS * ROW;               // 32 KB
constexpr int HALO_BYTES = SR * SWD * PIX;
constexpr int CT_BYTES = MWARPS * MT * 16 * ROW;        // a row for every m16 tile row
constexpr int MMA_SMEM = W_BYTES + 2 * HALO_BYTES + CT_BYTES;  // weight, two halos, conv tile
static_assert(MWARPS * MT * 16 >= CPOS && (MWARPS * MT - 1) * 16 < CPOS, "m16 tiles cover the conv tile");
static_assert(MMA_SMEM <= 232448, "shared memory of one block");

// Byte offset of 16-byte chunk c of row r in a [rows][8 chunks] array whose
// chunks are XOR-swizzled by the row: the 8 rows of an ldmatrix 8x8, or the
// 8 positions of an epilogue store, hit distinct banks.
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * ROW + ((c ^ (r & 7)) << 4); }

struct Tile {
  int b, py0, px0;  // image, first pooled row and column
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_y) {
  const int per_image = tiles_x * tiles_y, b = t / per_image, r = t - b * per_image;
  const int ty = r / tiles_x;
  return Tile{b, ty * PT, (r - ty * tiles_x) * QT};
}

// The (SR, SWD) s2d halo of tile `t` into `dst`, straight from the NHWC
// input: input row 4*py0 - 6 + hr is half hr & 1 of s2d row hr >> 1, and the
// 2C values of input columns (2j, 2j+1) are words [0, C) of that half of s2d
// pixel j. By cp.async of 4C bytes where alignment allows (C = 2, 4), else 4;
// pixels outside the image are zero-filled. Words 2C..7 of a pixel are never
// written (zeroed once per block).
template <int C>
__device__ __forceinline__ void load_halo(uint32_t dst, const bf16* __restrict__ x, Tile t, int H, int W) {
  constexpr int V = C == 4 ? 4 : (C == 2 ? 2 : 1);  // 32-bit words a copy
  constexpr int NV = C / V;                         // copies per half pixel
  constexpr int PER_ROW = SWD * NV;
  const int gy0 = 4 * t.py0 - 6, gx0 = 4 * t.px0 - 6;
#pragma unroll 1  // unrolled, the copies' index math is hoisted out of the tile loop and spills
  for (int i = threadIdx.x; i < 2 * SR * PER_ROW; i += MNT) {
    const int hr = i / PER_ROW, k = i - hr * PER_ROW, sc = k / NV, j = k - sc * NV;
    const int gy = gy0 + hr, gx = gx0 + 2 * sc;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const uint32_t d = dst + ((hr >> 1) * SWD + sc) * PIX + ((hr & 1) * C + j * V) * 4;
    const bf16* src = in ? x + (((size_t)t.b * H + gy) * W + gx) * C + 2 * V * j : x;
    if constexpr (V == 4) {
      cp_async16(d, src, in ? 16 : 0);
    } else if constexpr (V == 2) {
      cp_async8(d, src, in ? 8 : 0);
    } else {
      cp_async4(d, src, in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The 3x3/s2 max-pool of tile `t` from its conv tile, NHWC: one pooled
// position x 8 channels (16 bytes) an item.
__device__ __forceinline__ void pool_tile(const unsigned char* ctile, bf16* __restrict__ out, Tile t,
                                          int Hp, int Wp) {
  bf16* ob = out + (size_t)t.b * Hp * Wp * F;
  for (int i = threadIdx.x; i < PT * QT * 8; i += MNT) {
    const int chunk = i & 7, q = i >> 3, pr = q / QT, pc = q - pr * QT;
    const int gpr = t.py0 + pr, gpc = t.px0 + pc;
    if (gpr >= Hp || gpc >= Wp) continue;
    uint4 mx = make_uint4(0u, 0u, 0u, 0u);  // every conv value is >= 0 after ReLU
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int m = (2 * pr + dy) * CTW + 2 * pc + dx;
        const uint4 v = *reinterpret_cast<const uint4*>(ctile + swz(m, chunk));
        mx = make_uint4(bf16x2_max(mx.x, v.x), bf16x2_max(mx.y, v.y), bf16x2_max(mx.z, v.z),
                        bf16x2_max(mx.w, v.w));
      }
    }
    *reinterpret_cast<uint4*>(ob + ((size_t)gpr * Wp + gpc) * F + chunk * 8) = mx;
  }
}

template <int C>
__global__ void __launch_bounds__(MNT, 1)
stem_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ scale, const float* __restrict__ bias,
                bf16* __restrict__ out, int B, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem_stem[];
  const uint32_t ws = smem_u32(smem_stem), halo = ws + W_BYTES;
  unsigned char* ctile = smem_stem + W_BYTES + 2 * HALO_BYTES;  // [576][8 chunks], swizzled
  const int Hc = H / 2, Wc = W / 2, Hp = Hc / 2, Wp = Wc / 2;
  const int tiles_x = (Wp + QT - 1) / QT, tiles_y = (Hp + PT - 1) / PT;
  const int ntiles = B * tiles_x * tiles_y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // s2d channels 4C..15 of every pixel of both halo buffers: zero, once
  if constexpr (C < 4) {
    constexpr int PADW = 8 - 2 * C;
    for (int i = tid; i < 2 * SR * SWD * PADW; i += MNT) {
      const int p = i / PADW;
      reinterpret_cast<uint32_t*>(smem_stem + W_BYTES + p * PIX)[2 * C + i - p * PADW] = 0u;
    }
  }
  // the s2d weight [tap * 16 + ch][co] from the HWIO weight, once per block:
  // tap (dr, dc), channel ch = pr*2C + pc*C + c is w[2dr+pr-1][2dc+pc-1][c]
  // (a 128-byte row), zero-filled where that tap is outside or ch >= 4C
  for (int i = tid; i < KROWS * 8; i += MNT) {
    const int kr = i >> 3, chunk = i & 7, tap = kr >> 4, ch = kr & 15;
    const int pr = ch / (2 * C), pc = (ch % (2 * C)) / C, c = ch % C;
    const int ky = 2 * (tap >> 2) + pr - 1, kx = 2 * (tap & 3) + pc - 1;
    const bool ok = ch < 4 * C && ky >= 0 && kx >= 0;
    cp_async16(ws + swz(kr, chunk), ok ? w + ((ky * 7 + kx) * C + c) * F + chunk * 8 : w, ok ? 16 : 0);
  }
  int tile = blockIdx.x;
  load_halo<C>(halo, x, tile_at(tile, tiles_x, tiles_y), H, W);
  cp_async_commit();

  // this lane's ldmatrix row in a 16x16 fragment (A: conv position; B: k
  // row) and its 16-byte chunk half; its C fragment row and column pair
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = lane >> 4;
  const int g = lane >> 2, cq = 2 * (lane & 3);
  uint32_t arow[MT];  // byte offset in a halo of this lane's A row at tap (0, 0), per m16 tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = min((warp * MT + mt) * 16 + lr, CPOS - 1);  // rows past the tile: any valid pixel
    const int r = m / CTW;
    arow[mt] = (r * SWD + m - r * CTW) * PIX + lc * 16;
  }

  const uint32_t ct = smem_u32(ctile);
  Tile prev{-1, 0, 0};  // the tile whose conv tile waits in shared memory for its pool
  for (int buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < ntiles) load_halo<C>(halo + (buf ^ 1) * HALO_BYTES, x, tile_at(next, tiles_x, tiles_y), H, W);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's halo (and the weight) have landed
    __syncthreads();     // ... for every thread; the last tile's conv tile is whole

    const uint32_t hb = halo + buf * HALO_BYTES;
    float acc[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

#pragma unroll
    for (int tap = 0; tap < 16; ++tap) {
      const uint32_t shift = ((tap >> 2) * SWD + (tap & 3)) * PIX;  // s2d pixel (dr, dc) further on
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], hb + arow[mt] + shift);
      const int kr = tap * 16 + lr;
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

    // the last tile's pool, while other warps finish their products
    if (prev.b >= 0) pool_tile(ctile, out, prev, Hp, Wp);
    __syncthreads();  // the conv tile is free; every warp is done with this halo buffer

    // affine, ReLU, one rounding to bf16: the conv tile, 0 outside the image,
    // by stmatrix (an 8x8 matrix is 8 positions x 8 channels of a C fragment)
    const Tile t = tile_at(tile, tiles_x, tiles_y);
    const int cr0 = 2 * t.py0 - 1, cc0 = 2 * t.px0 - 1;
    bool inside[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (warp * MT + mt) * 16 + g + 8 * half;
        const int r = m / CTW, gr = cr0 + r, gc = cc0 + m - r * CTW;
        inside[mt][half] = m < CPOS && gr >= 0 && gr < Hc && gc >= 0 && gc < Wc;
      }
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // output channels 16 np .. 16 np + 15
      float2 sc[2], bi[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[j] = *reinterpret_cast<const float2*>(scale + (2 * np + j) * 8 + cq);
        bi[j] = *reinterpret_cast<const float2*>(bias + (2 * np + j) * 8 + cq);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t r[4];  // matrix 2j + half: n tile 2np + j, rows g + 8 half
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float* a = acc[mt][2 * np + j] + 2 * half;
            const bool in = inside[mt][half];
            r[2 * j + half] = pack_bf16(in ? fmaxf(fmaf(a[0], sc[j].x, bi[j].x), 0.f) : 0.f,
                                        in ? fmaxf(fmaf(a[1], sc[j].y, bi[j].y), 0.f) : 0.f);
          }
        }
        stsm_x4(ct + swz((warp * MT + mt) * 16 + lr, 2 * np + lc), r[0], r[1], r[2], r[3]);
      }
    }
    prev = t;
  }
  __syncthreads();  // the last conv tile is whole
  if (prev.b >= 0) pool_tile(ctile, out, prev, Hp, Wp);
}

constexpr int MAX_DEVICES = 64;

// The shared-memory limit is set, and the SM count read, once per device:
// no driver call on the launches after. The grid is one block per SM, or
// one per tile where there are fewer tiles.
template <int C>
cudaError_t launch_mma(const void* x, const void* w, const void* scale, const void* bias, void* out,
                       int B, int H, int W, cudaStream_t stream) {
  static std::atomic<int> sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n = dev < MAX_DEVICES ? sms[dev].load() : 0;
  if (n == 0) {
    err = cudaFuncSetAttribute(stem_mma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) sms[dev].store(n);
  }
  const long long tiles = (long long)B * ((H / 4 + PT - 1) / PT) * ((W / 4 + QT - 1) / QT);
  stem_mma_kernel<C><<<(int)std::min<long long>(tiles, n), MNT, MMA_SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<bf16*>(out), B, H, W);
  return cudaGetLastError();
}

cudaError_t launch_mma_c(const void* x, const void* w, const void* scale, const void* bias,
                         void* out, int B, int H, int W, int C, cudaStream_t stream) {
  switch (C) {
    case 1: return launch_mma<1>(x, w, scale, bias, out, B, H, W, stream);
    case 2: return launch_mma<2>(x, w, scale, bias, out, B, H, W, stream);
    case 3: return launch_mma<3>(x, w, scale, bias, out, B, H, W, stream);
    case 4: return launch_mma<4>(x, w, scale, bias, out, B, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (B,H,W,C) NHWC, w: (7,7,C,64) HWIO in x's dtype, scale/bias: (64,) f32,
// out: (B,H/4,W/4,64) NHWC. Requires 1 <= C <= 4, H, W multiples of 4, and
// for bf16 x and w 16-byte aligned (the wrapper checks). bf16 runs on the
// tensor cores, float32 on the CUDA cores. Returns a cudaError_t (0 on a
// good launch).
extern "C" int ddt_stem_fused(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int B, int H, int W, int C,
                              int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch_mma_c(x, w, scale, bias, out, B, H, W, C, s);
  return (int)launch_c<float>(x, w, scale, bias, out, B, H, W, C, s);
}
