// Fused ResNet stem: conv7x7/s2/pad3 (C -> 64) -> per-channel f32 affine
// (the folded eval BatchNorm) -> ReLU -> maxpool3x3/s2/pad1, NHWC in and out.
//
// Replaces the TPU kernel `diffusiondrive_tpu/ops/stem_fused.py:_stem_kernel`
// (reached through `_stem_pallas`, pallas_call at :153).
//
// What bounds it on an H100 SXM: at the main-path shape (B=16, 256x1024x3
// camera, bf16) the conv does ~19.7 GFLOP of real products (20 us at 989
// TFLOP/s) and the call moves ~59 MB (18 us at 3.35 TB/s): the two bounds
// are close. In float32 at float32 accuracy (three TF32 products a
// product, below) the same call is 59 GFLOP of TF32 products (120 us at
// 494.7 TFLOP/s) against 118 MB (35 us): operations set the bound. What the
// JAX kernel keeps, both kernels keep: an f32 sum, the affine and ReLU in
// f32, one rounding to the output dtype, the pool from on-chip memory,
// nothing intermediate in device memory. The TPU's planar lane layout and
// its lane-shifted triples are MXU artefacts and are not ported.
//
// Two kernels, chosen by dtype alone, both on the tensor cores (mma.sync,
// f32 accumulators) for every C = 1..4, both in the same form: a 2x2
// space-to-depth (s2d) of the input turns the 7x7/s2 conv into a 4x4/s1
// conv over (H/2, W/2, 4C): conv output y reads s2d rows y-2 .. y+1, and
// s2d channel pr*2C + pc*C + c of s2d row i is input row 2i+pr, column
// 2j+pc, channel c; tap (dr, dc) of the 4x4 conv is the 7x7 tap (2dr+pr-1,
// 2dc+pc-1), zero where that falls outside (dr or dc = 0 with parity 0).
// Both are a persistent grid, one block per SM, that builds the s2d weight
// [tap * channels + ch][co] from the HWIO weight in shared memory once
// (zero rows included) and walks over tiles of pooled outputs. A tile of
// PT x QT pooled outputs needs (2PT+1) x (2QT+1) conv positions (its pool
// windows) and a (2PT+4) x (2QT+4)-pixel s2d halo, which the input's rows
// give directly (two input rows make one s2d row: the 2C values of two
// neighbouring pixels are contiguous), by cp.async (zero-filled past the
// image), double-buffered: the next tile's halo lands while this one is
// computed. M is the tile's conv positions, flattened: ldmatrix takes one
// row address per lane, so a fragment's rows may cross a conv row, and tap
// (dr, dc) is the same ldmatrix at a constant shifted address. The
// epilogue applies the affine and ReLU to the f32 C fragments, 0 outside
// the image (after ReLU every value is >= 0, so a zero pad gives the same
// max as -inf), into a conv tile in shared memory; the 3x3/s2 pool of that
// conv tile (16-byte NHWC stores) runs in the next tile's iteration, after
// each warp's products, so one warp's pool overlaps the others' mma. No
// atomics: every call gives the same bits.
// - bf16: `stem_mma_kernel<C>`, m16n8k16, 12 warps, 8x16 pooled tiles
//   (561 conv positions, 36 m16 tiles, 3 a warp; a 20x36-pixel halo). Each
//   s2d pixel is padded to 16 channels, so each of the 16 taps is one
//   k-step of 16 (K = 256 against 49*C real products: 1.74x for the
//   camera, 5.2x for the lidar). An s2d pixel takes 48 bytes of shared
//   memory (32 used): any 8 consecutive pixels then fall on distinct banks
//   with no swizzle, so the tap shift stays a constant offset. B fragments
//   come from the weight rows by ldmatrix.trans (rows XOR-swizzled as in
//   `conv3x3_fused.cu`). The conv tile is bf16, rounded once where JAX's
//   `conv_ref` rounds, written by stmatrix.
// - float32: `stem_tf32x3_kernel<C>`, m16n8k8 TF32 in three products a
//   product (3xTF32, `ddt::mma_tf32x3`): one TF32 product keeps 11
//   significant bits of each operand and breaks float32's 1e-4 limit
//   against the plain version; each operand is split into big (TF32, to
//   nearest) and small = x - big (`ddt::split_tf32`) and the product taken
//   as small.big + big.small + big.big, about 21 bits. Shared memory is
//   what bf16's tile does not meet here: its 17x33 conv tile alone is 143.6
//   KB in float32. The float32 tile is 8x7 pooled outputs, 17x15 = 255
//   conv positions: 16 m16 tiles, 2 for each of 8 warps (64 accumulators a
//   thread), one row to spare; the conv tile 64 KB, the weight 16 KB x C,
//   two 20x18-pixel halos of 16, 48, 48, 80 bytes a pixel for C = 1..4
//   (4C floats used, the pitch an odd number of 16-byte chunks, so any 8
//   consecutive pixels fall on distinct banks): 188,672 bytes at C = 4. K is
//   not padded: 16 taps x 4C channels = 64C, 8C k-steps of 8. An ldmatrix
//   8x8 b16 matrix is 8 rows of 4 floats (lane i: row i/4, float i%4, the
//   A fragment's a0 layout), so the two column halves of a k-step's A
//   fragment are two groups of 4 channels with row addresses of their own:
//   group 2ks + h is 4 channels of one tap of the s2d pixel, wherever the
//   groups fall (C = 3: 12 channels a pixel, three groups a tap): K is
//   1.31x the 49C real products, against bf16's 256 (4x fewer products
//   than that for the lidar, C = 1, and 1.33x fewer for the camera). The weight is stored as 8C
//   blocks, one a k-step, of [64 output channels][8 k] (32-byte rows, the
//   two 16-byte halves swapped on rows 4-7 of each 8), so ldmatrix gives
//   B fragments too (ldmatrix.trans cannot transpose 32-bit elements). The
//   split: each warp splits its two A fragments once a k-step (8 values a
//   thread, reused over the 8 n8 tiles) and each B fragment once as it is
//   read (16 values, reused over the 2 m16 tiles); the weight's split is
//   paid by each of the 8 warps at each tile (a split weight in shared
//   memory would double it). The conv tile is float32, 256-byte rows whose
//   16-byte chunks are XOR-swizzled by 2 (m & 3), so the epilogue's
//   float2 stores of 8 rows take the 2 wavefronts their 256 bytes need.
//   All 8C k-steps are unrolled (156-179 registers, no spills; a loop over
//   dr was a few percent slower).
// Both launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int F = 64;  // output channels

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

// ---- float32 on the tensor cores, 3xTF32 ----

using ddt::mma_tf32x3;
using ddt::split_tf32x4;

constexpr int FPT = 8, FQT = 7;                        // pooled tile: rows, columns
constexpr int FCTR = 2 * FPT + 1, FCTW = 2 * FQT + 1;  // its conv positions: 17 x 15
constexpr int FCPOS = FCTR * FCTW;                     // 255
constexpr int FSR = FCTR + 3, FSW = FCTW + 3;          // its s2d halo: 20 x 18 pixels
constexpr int FWARPS = 8, FMT = 2;                     // warps; m16 tiles a warp
constexpr int FNT = 32 * FWARPS;
constexpr int FROW = F * 4;                            // bytes of a conv position: 16 chunks
constexpr int FKS_BYTES = F * 32;                      // a k-step's weight block: [64][8] floats
constexpr int F_CT_BYTES = FWARPS * FMT * 16 * FROW;   // a row for every m16 tile row
static_assert(FWARPS * FMT * 16 >= FCPOS && (FWARPS * FMT - 1) * 16 < FCPOS, "m16 tiles cover the conv tile");

// bytes of an s2d pixel in shared memory: its 4C floats, rounded up to an
// odd number of 16-byte chunks
template <int C>
__host__ __device__ constexpr int fpix() { return 16 * (C % 2 ? C : C + 1); }
template <int C>
__host__ __device__ constexpr int f_halo_bytes() { return FSR * FSW * fpix<C>(); }
template <int C>
__host__ __device__ constexpr int f_smem() { return 8 * C * FKS_BYTES + 2 * f_halo_bytes<C>() + F_CT_BYTES; }  // weight, two halos, conv tile
static_assert(f_smem<4>() <= 232448, "shared memory of one block");

// Byte offset of 16-byte half h of output channel co's row in weight block
// ks: the halves swap on rows 4-7 of every 8, so the 8 rows of an ldmatrix
// 8x8 hit distinct banks.
__device__ __forceinline__ uint32_t wswz(int ks, int co, int h) {
  return ks * FKS_BYTES + co * 32 + ((h ^ ((co >> 2) & 1)) << 4);
}

// Byte offset of 16-byte chunk c (4 channels) of conv position m in the conv tile.
__device__ __forceinline__ uint32_t cswz(int m, int c) { return m * FROW + ((c ^ ((m & 3) << 1)) << 4); }

__device__ __forceinline__ Tile ftile_at(int t, int tiles_x, int tiles_y) {
  const int per_image = tiles_x * tiles_y, b = t / per_image, r = t - b * per_image;
  const int ty = r / tiles_x;
  return Tile{b, ty * FPT, (r - ty * tiles_x) * FQT};
}

// The (FSR, FSW) s2d halo of tile `t` into `dst`, straight from the NHWC
// input, as `load_halo`: input row 4*py0 - 6 + hr is half hr & 1 of s2d row
// hr >> 1, floats [2C (hr & 1), 2C (hr & 1) + 2C) of each s2d pixel, by
// cp.async of 16 bytes (C = 2, 4) or 8 (C = 1, 3, where 16 would be
// misaligned); pixels outside the image are zero-filled.
template <int C>
__device__ __forceinline__ void load_halo_f32(uint32_t dst, const float* __restrict__ x, Tile t, int H, int W) {
  constexpr int V = C % 2 ? 2 : 4;  // floats a copy
  constexpr int NV = 2 * C / V;     // copies per half pixel
  constexpr int PER_ROW = FSW * NV;
  const int gy0 = 4 * t.py0 - 6, gx0 = 4 * t.px0 - 6;
#pragma unroll 1
  for (int i = threadIdx.x; i < 2 * FSR * PER_ROW; i += FNT) {
    const int hr = i / PER_ROW, k = i - hr * PER_ROW, sc = k / NV, j = k - sc * NV;
    const int gy = gy0 + hr, gx = gx0 + 2 * sc;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const uint32_t d = dst + ((hr >> 1) * FSW + sc) * fpix<C>() + ((hr & 1) * 2 * C + j * V) * 4;
    const float* src = in ? x + (((size_t)t.b * H + gy) * W + gx) * C + V * j : x;
    if constexpr (V == 4) {
      cp_async16(d, src, in ? 16 : 0);
    } else {
      cp_async8(d, src, in ? 8 : 0);
    }
  }
}

// The 3x3/s2 max-pool of tile `t` from its float32 conv tile, NHWC: one
// pooled position x 4 channels (16 bytes) an item.
__device__ __forceinline__ void pool_tile_f32(const unsigned char* ctile, float* __restrict__ out, Tile t, int Hp,
                                              int Wp) {
  float* ob = out + (size_t)t.b * Hp * Wp * F;
  for (int i = threadIdx.x; i < FPT * FQT * 16; i += FNT) {
    const int chunk = i & 15, q = i >> 4, pr = q / FQT, pc = q - pr * FQT;
    const int gpr = t.py0 + pr, gpc = t.px0 + pc;
    if (gpr >= Hp || gpc >= Wp) continue;
    float4 mx = make_float4(0.f, 0.f, 0.f, 0.f);  // every conv value is >= 0 after ReLU
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4 v = *reinterpret_cast<const float4*>(ctile + cswz((2 * pr + dy) * FCTW + 2 * pc + dx, chunk));
        mx = make_float4(fmaxf(mx.x, v.x), fmaxf(mx.y, v.y), fmaxf(mx.z, v.z), fmaxf(mx.w, v.w));
      }
    }
    *reinterpret_cast<float4*>(ob + ((size_t)gpr * Wp + gpc) * F + chunk * 4) = mx;
  }
}

template <int C>
__global__ void __launch_bounds__(FNT, 1)
stem_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   float* __restrict__ out, int B, int H, int W) {
  constexpr int PIXB = fpix<C>(), HB = f_halo_bytes<C>(), KS = 2 * C;  // KS: k-steps of a tap row dr
  extern __shared__ __align__(128) unsigned char smem_stem_f32[];
  const uint32_t ws = smem_u32(smem_stem_f32), halo = ws + 8 * C * FKS_BYTES;
  unsigned char* ctile = smem_stem_f32 + 8 * C * FKS_BYTES + 2 * HB;  // [256][16 chunks], swizzled
  const int Hc = H / 2, Wc = W / 2, Hp = Hc / 2, Wp = Wc / 2;
  const int tiles_x = (Wp + FQT - 1) / FQT, tiles_y = (Hp + FPT - 1) / FPT;
  const int ntiles = B * tiles_x * tiles_y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int tile = blockIdx.x;
  load_halo_f32<C>(halo, x, ftile_at(tile, tiles_x, tiles_y), H, W);
  cp_async_commit();
  // the s2d weight, once per block: k row tap * 4C + ch, with tap (dr, dc)
  // and ch = pr*2C + pc*C + c, is w[2dr+pr-1][2dc+pc-1][c] (zero where that
  // tap is outside); four k rows of one output channel a store
  for (int i = tid; i < 16 * C * F; i += FNT) {
    const int co = i & (F - 1), q = i / F;  // k rows 4q .. 4q + 3
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * q + j, tap = k / (4 * C), ch = k - tap * 4 * C;
      const int pr = ch / (2 * C), pc = (ch - pr * 2 * C) / C, c = ch % C;
      const int ky = 2 * (tap >> 2) + pr - 1, kx = 2 * (tap & 3) + pc - 1;
      v[j] = ky >= 0 && kx >= 0 ? w[((ky * 7 + kx) * C + c) * F + co] : 0.f;
    }
    *reinterpret_cast<float4*>(smem_stem_f32 + wswz(q >> 1, co, q & 1)) = make_float4(v[0], v[1], v[2], v[3]);
  }

  // this lane's ldmatrix row and 16-byte chunk half: A (conv position;
  // matrices rows 0-7, 8-15 of the k-step's first group of 4 channels, then
  // of its second) and B (output channel; matrices n 0-7 k 0-3, n 0-7 k 4-7,
  // n 8-15 k 0-3, n 8-15 k 4-7); its C fragment row and column pair
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = lane >> 4;
  const int br = (lane & 7) + (lane >> 4) * 8, bc = (lane >> 3) & 1;
  const int g = lane >> 2, cq = 2 * (lane & 3);
  uint32_t arow[FMT];  // byte offset in a halo of this lane's A row at tap (0, 0), per m16 tile
#pragma unroll
  for (int mt = 0; mt < FMT; ++mt) {
    const int m = min((warp * FMT + mt) * 16 + lr, FCPOS - 1);  // the row past the tile: any valid pixel
    const int r = m / FCTW;
    arow[mt] = (r * FSW + m - r * FCTW) * PIXB;
  }

  Tile prev{-1, 0, 0};  // the tile whose conv tile waits in shared memory for its pool
  for (int buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < ntiles) load_halo_f32<C>(halo + (buf ^ 1) * HB, x, ftile_at(next, tiles_x, tiles_y), H, W);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's halo (and the weight) have landed
    __syncthreads();     // ... for every thread; the last tile's conv tile is whole

    const uint32_t hb = halo + buf * HB;
    float acc[FMT][8][4];
#pragma unroll
    for (int mt = 0; mt < FMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

#pragma unroll
    for (int dr = 0; dr < 4; ++dr) {
      const uint32_t hrow = hb + dr * FSW * PIXB, wrow = ws + dr * KS * FKS_BYTES;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        // group 2 ks + lc of this tap row: tap dc = group / C, channels 4 (group % C) ..
        const int gl = 2 * ks + lc;
        const uint32_t off = (gl / C) * PIXB + (gl % C) * 16;
        uint32_t ab[FMT][4], as[FMT][4];
#pragma unroll
        for (int mt = 0; mt < FMT; ++mt) {
          uint32_t r[4];
          ldsm_x4(r, hrow + arow[mt] + off);
          split_tf32x4(r, ab[mt], as[mt]);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {  // output channels 16 np .. 16 np + 15
          uint32_t r[4], bb[4], bs[4];    // b0, b1 of n8 tile 2 np, then of 2 np + 1
          ldsm_x4(r, wrow + wswz(ks, 16 * np + br, bc));
          split_tf32x4(r, bb, bs);
          const uint32_t bb0[2] = {bb[0], bb[1]}, bs0[2] = {bs[0], bs[1]};
          const uint32_t bb1[2] = {bb[2], bb[3]}, bs1[2] = {bs[2], bs[3]};
#pragma unroll
          for (int mt = 0; mt < FMT; ++mt) {
            mma_tf32x3(acc[mt][2 * np], ab[mt], as[mt], bb0, bs0);
            mma_tf32x3(acc[mt][2 * np + 1], ab[mt], as[mt], bb1, bs1);
          }
        }
      }
    }

    // the last tile's pool, while other warps finish their products
    if (prev.b >= 0) pool_tile_f32(ctile, out, prev, Hp, Wp);
    __syncthreads();  // the conv tile is free; every warp is done with this halo buffer

    // affine and ReLU in f32, 0 outside the image: the conv tile
    const Tile t = ftile_at(tile, tiles_x, tiles_y);
    const int cr0 = 2 * t.py0 - 1, cc0 = 2 * t.px0 - 1;
    bool inside[FMT][2];
#pragma unroll
    for (int mt = 0; mt < FMT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = (warp * FMT + mt) * 16 + g + 8 * hf;
        const int r = m / FCTW, gr = cr0 + r, gc = cc0 + m - r * FCTW;
        inside[mt][hf] = m < FCPOS && gr >= 0 && gr < Hc && gc >= 0 && gc < Wc;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + cq;
      const float2 sc = *reinterpret_cast<const float2*>(scale + c);
      const float2 bi = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
      for (int mt = 0; mt < FMT; ++mt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int m = (warp * FMT + mt) * 16 + g + 8 * hf;
          const float* a = acc[mt][nt] + 2 * hf;
          const bool in = inside[mt][hf];
          *reinterpret_cast<float2*>(ctile + cswz(m, c >> 2) + (c & 3) * 4) =
              make_float2(in ? fmaxf(fmaf(a[0], sc.x, bi.x), 0.f) : 0.f, in ? fmaxf(fmaf(a[1], sc.y, bi.y), 0.f) : 0.f);
        }
      }
    }
    prev = t;
  }
  __syncthreads();  // the last conv tile is whole
  if (prev.b >= 0) pool_tile_f32(ctile, out, prev, Hp, Wp);
}

constexpr int MAX_DEVICES = 64;

// The dtype's kernel for C.
template <typename T, int C>
auto kernel_of() {
  if constexpr (std::is_same_v<T, bf16>) {
    return stem_mma_kernel<C>;
  } else {
    return stem_tf32x3_kernel<C>;
  }
}

// The shared-memory limit is set, and the SM count read, once per device
// and kernel: no driver call on the launches after. The grid is one block
// per SM, or one per tile where there are fewer tiles.
template <typename T, int C>
cudaError_t launch(const void* x, const void* w, const void* scale, const void* bias, void* out, int B, int H,
                   int W, cudaStream_t stream) {
  constexpr bool BF = std::is_same_v<T, bf16>;
  constexpr int smem = BF ? MMA_SMEM : f_smem<C>(), threads = BF ? MNT : FNT;
  constexpr int ph = BF ? PT : FPT, pw = BF ? QT : FQT;  // pooled tile
  static std::atomic<int> sms[MAX_DEVICES];
  const auto kernel = kernel_of<T, C>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n = dev < MAX_DEVICES ? sms[dev].load() : 0;
  if (n == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) sms[dev].store(n);
  }
  const long long tiles = (long long)B * ((H / 4 + ph - 1) / ph) * ((W / 4 + pw - 1) / pw);
  kernel<<<(int)std::min<long long>(tiles, n), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), B, H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_c(const void* x, const void* w, const void* scale, const void* bias, void* out, int B, int H,
                     int W, int C, cudaStream_t stream) {
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
// out: (B,H/4,W/4,64) NHWC. Requires 1 <= C <= 4, H, W multiples of 4, and
// x and w 16-byte aligned (the wrapper checks). bf16 runs
// `stem_mma_kernel<C>`, float32 `stem_tf32x3_kernel<C>`. Returns a
// cudaError_t (0 on a good launch).
extern "C" int ddt_stem_fused(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int B, int H, int W, int C,
                              int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? (int)launch_c<bf16>(x, w, scale, bias, out, B, H, W, C, s)
                 : (int)launch_c<float>(x, w, scale, bias, out, B, H, W, C, s);
}
