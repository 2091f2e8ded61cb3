// Fused self-attention of the GPT fusion blocks, forward and backward:
// softmax(q k^T / sqrt(D)) in f32 -> optional uint8 keep mask (kept
// probabilities times 1/(1-p)) -> rounded to the input dtype -> . v.
//
// Replaces the TPU kernels `diffusiondrive_tpu/ops/attention_fused.py:
// _fwd_kernel` (:78, pallas_call in `_fwd_pallas` :140) and `_bwd_kernel`
// (:92, pallas_call in `_bwd_pallas` :160): 8 forwards and 8 backwards per
// train step with `fused_attention_mode="on"` (4 fusion stages x 2 blocks,
// B x 4 heads, T = 320 tokens, D = 16, 32, 64, 128); the ResNet-50 agent's
// stage 3 adds D = 256 (2 forwards and 2 backwards a step).
//
// What bounds it on an H100 SXM: at B=64, H=4, T=320, D=128 in bf16 the
// forward does 4*B*H*T^2*D = 13.4 GFLOP (13.6 us at 989 TFLOP/s) and moves
// q, k, v, o = 84 MB plus a 26 MB mask (33 us at 3.35 TB/s): memory sets
// the bound (about 120 flop/B against the ~295 the card needs before
// compute binds); at D=16 the mask is 3/4 of the bytes. The backward does
// 2.5x the forward's flops over 1.75x its bytes, also memory-bound; D=256
// doubles both. float32 at float32 accuracy costs three TF32 products a
// product (below): operations bind it, 3 x 13.4 GFLOP over 495 TFLOP/s (81
// us) against 194 MB (58 us) for that forward.
//
// Every kernel is mma.sync on the tensor cores. A block owns one (batch,
// head) and 64 query rows (forward, backward launch 1) or 64 keys (launch
// 2), 16 a warp, with D zero-padded to DP = 16, 32, 64, 128 or 256; the
// other operand streams through shared memory in tiles by cp.async, double
// buffered (one exception: the float32 forward at DP = 256). Operands are
// read through (batch, head, token) strides with a contiguous last
// dimension, so q, k, v and dO come straight from the (B, T, H, D) Linear
// outputs. Every kernel launches on the caller's stream and allocates
// nothing.
//
// bf16 forward:
// - D <= 128 (every fusion stage): `attn_fwd_mma_kernel`. q.k^T and p.v are
//   mma.sync.m16n8k16 bf16 products with f32 accumulation; the warp's Q rows
//   are held as A fragments. K (pass 1) and K, V and the mask (pass 2)
//   stream in 64-key tiles and reach the products by ldmatrix (.trans for
//   V). Pass 1 keeps each row's running max and sum in f32 (quad
//   shuffles); pass 2 recomputes the scores bit for bit and forms the
//   normalised, masked, bf16-rounded p straight from the accumulators (the
//   C layout of two n8 tiles is the A layout of one k16 step). Each score
//   is exponentiated in both passes, so exp is one FMA and the SFU's ex2
//   (expf's eight instructions a score set the time at small D). Two passes,
//   not an online rescale of the output: the JAX kernel rounds the
//   normalised p, and the recomputed q.k^T costs flops where bytes bind
//   (K and V of one head, <= 80 KB each at T = 320, come back from L2).
// - 128 < D <= 256 (ResNet-50's stage 3): `attn_fwd_mma_wide_kernel`, the
//   same two passes at DP = 256. Registers set the limit there (255 a
//   thread, no spills): the 16 x 256 f32 output accumulator alone is 128 a
//   thread, so the Q fragments (64 more) are read from shared memory at each
//   k16 step instead of being held, and the key tiles shrink to 32 (16 score
//   registers; Q, two K and two V tiles take 99 KB, 105 KB with the mask
//   tiles, so two blocks share an SM).
//
// Backward designs, each two launches with the per-row statistics in a
// (3, B*H*T) f32 scratch between them; dq is owned by query tiles, dk and
// dv by key tiles, so no atomics and the same bits in every run:
// - bf16 with D <= 128: `attn_bwd_dq_mma_kernel` then
//   `attn_bwd_dkdv_mma_kernel`, the forward's tensor-core machinery
//   (ldmatrix, mma.sync, C fragments repacked as A fragments, cp.async
//   tiles). JAX's rounding points hold: p and dp = dO V^T in f32,
//   delta = sum_j dp p with the unmasked p, pd and ds rounded to bf16 before
//   their products (never FlashAttention's delta = rowsum(dO * O): the
//   output is not kept, and its rounding would move ds). Launch 1 (64 query
//   rows a block): pass 1 over K, V and mask tiles keeps each row's max,
//   sum and dp-weighted sum online; pass 2 recomputes s and dp and
//   accumulates dq = ds K. Launch 2 (64 keys a block): over query tiles,
//   s^T = K Q^T and dp^T = V dO^T with the keys as rows, so pd^T and ds^T
//   leave the C fragments as the A fragments of dv += pd^T dO and
//   dk += ds^T Q; p^T from launch 1's statistics and the same exp. Ten tile
//   products a score, against the forward's three; merging launch 1's
//   passes would hold p and dp for the block in shared memory (160 KB at
//   T = 320, too much at T = 512).
// - bf16 with 128 < D <= 256: `attn_bwd_dq_mma_wide_kernel` then
//   `attn_bwd_dkdv_mma_wide_kernel`, the same two launches at DP = 256.
//   Launch 1 reads the Q and dO fragments from shared memory per product
//   and streams 32-key tiles, as the wide forward (dq is 128 accumulators a
//   thread). Launch 2 cannot hold dk and dv at full width (256 accumulators
//   a thread), so its grid also splits D in halves: each block recomputes
//   s^T and dp^T over all 256 columns and accumulates 128 columns of dk and
//   dv, the DP = 128 kernel's register partition. Of the ways to split D
//   (two warps per 16 keys, each owning a half; a half per block; pd^T and
//   ds^T staged in shared memory so that the output products' warp layout
//   is free) this one keeps the DP = 128 kernel's loaders, 128 threads and
//   accumulator layout as they are; its price, s^T and dp^T computed twice,
//   is tensor-core flops where bytes bind.
//
// float32, every D (`attn_fwd_tf32x3_kernel`, then `attn_bwd_dq_tf32x3_kernel`
// and `attn_bwd_dkdv_tf32x3_kernel`, each templated on DP = 16 ... 256):
// - Products in three TF32 parts (3xTF32, CUTLASS's OpMultiplyAddFastF32).
//   One TF32 product (mma.m16n8k8.tf32) keeps 11 significant bits of each
//   operand: a relative error of 2^-11 a term, so a score over D = 256
//   terms, and the output after it, land near 1e-4 of their magnitude, the
//   float32 limit against the plain version. Each operand is split instead
//   (`ddt::split_tf32`): big = x rounded to TF32, to nearest with ties away
//   from zero (cvt.rna's value), and small = x - big, exact in f32, which
//   the mma truncates to TF32; the product is big.big + big.small +
//   small.big in f32 (`ddt::mma_tf32x3`). x = big + small to 2^-22 |x| and
//   the left-out small.small is below 2^-22 of the term, so each term keeps
//   about 21 bits: errors against the plain version of 3e-6 to 2.5e-5 at
//   D = 16 ... 256. The split is 3 instructions an element; with cvt.rna for
//   both parts (4 instructions each, NaN checks included) the kernels ran
//   1.2-1.4x slower, and rounding small instead of truncating it 1.04-1.1x.
// - Fragments of 32-bit operands: the m16n8k8 C layout (row g, columns 2t,
//   2t + 1) is not the A layout (columns t, t + 4), and ldmatrix moves only
//   16-bit elements. The reduction index of p.v (and ds.K, pd^T.dO,
//   ds^T.Q) is the key (query) index, so it is permuted within each k8
//   step: k = t is key 2t, k = t + 4 key 2t + 1. The C fragment of a score
//   tile is then the A fragment of the next product as it stands, and V's
//   B fragment reads rows 2t and 2t + 1. Every operand is read by 32-bit
//   shared loads from rows padded to DP + 4 floats: the fragments of q.k^T
//   (g x LD + t) and the B fragments of p.v (2t x LD + g) hit 32 distinct
//   banks. Each A fragment is split once a k8 step and reused across the
//   n8 tiles; B fragments are split as they are read.
// - Forward: one pass with an online softmax and the output rescaled at
//   each key tile (FlashAttention's), where bf16 takes two passes. In
//   float32 "rounded to q's dtype" is the identity, so the normalised p is
//   never needed on its own; one pass computes q.k^T once instead of twice
//   (a third of the forward's tensor work) and the rescale, 4 x DP / 8
//   multiplies a thread a tile, is cheap beside it. The output is divided by
//   the row sum at the end.
// - Backward: the bf16 kernels' two launches, statistics and JAX formula,
//   with the 3xTF32 products and the key permutation above. At DP = 256
//   a block has two groups of 4 warps (`tf32_bwd_groups`): warps w and
//   w + 4 share 16 rows (launch 1) or keys (launch 2), each reduces half of
//   DP for s and dp, adds the other's partial fragments through shared
//   memory, and accumulates its half of dq, or of dk and dv (128
//   accumulators a thread for both). That computes s^T and dp^T once where
//   the bf16 wide kernel splits D over the grid and computes them twice, and
//   puts 8 warps on an SM, where 4 waited on the mma latency (D = 256
//   backward 5.40 -> 2.90 ms).
// - Tiles (`tf32_fwd_keys`, `tf32_bwd_tile`): keys of the forward 64 at
//   DP <= 64, 32 at DP = 128, 16 single-buffered at DP = 256; keys of launch
//   1 and queries of launch 2 64 / 32 / 16 at DP <= 32 / 64 / >= 128.
//   float32 tiles are twice bf16's bytes, so these keep two blocks an SM at
//   DP <= 128 and for the DP = 256 forward (Q and one 16-key K, V tile:
//   101 KB; double-buffered 32-key tiles, 200 KB and one block, ran 1.25x
//   slower); the DP = 256 backward launches take 218 KB with their 8 warps.
//   At DP = 256 the k8 loop of the score products unrolls by 4 only:
//   unrolled whole, the kernels outgrew the instruction cache (the forward
//   ran 1.5x and the backward 1.8x slower).
// - Rows that are not 16-byte aligned (D % 4 != 0, odd strides) are copied
//   by 4-byte cp.async (`mma_flags`).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"

namespace {

template <typename U>
struct View {
  U* p;
  long long sb, sh, st;  // element strides of batch, head, token; the last dim is contiguous
  __device__ __forceinline__ U* row(int b, int h, int t) const {
    return p + b * sb + h * sh + t * st;
  }
};

template <typename T>
struct Args {
  View<const T> q, k, v, dout;
  View<T> o, dq, dk, dv;
  const unsigned char* mask;  // (B, H, T, T) keep mask or null
  float* stats;               // (3, B*H*T): row max, row sum (mma: max log2 e, 1 / sum), sum_j dp*p
  int B, H, Tn, D;  // Tn: tokens
  float scale, inv_keep;
};

// ---- bf16 forward on the tensor cores ----

using bf16 = __nv_bfloat16;

constexpr int MQ = 64;        // query rows per block: 4 warps x 16
constexpr int MK = 64;        // keys per streamed tile
constexpr int MNT = 128;      // threads
constexpr int NS = 2;         // tile buffers: one in use, one in flight (3 and 4 ran no faster at
                              // T = 320, and slower at D = 128 with fewer blocks per SM)
constexpr int MASK_LD = 80;   // mask row stride in shared memory (bytes): conflict-free u16 reads
constexpr int VEC_QKV = 1;    // flags: q, k, v rows by 16-byte cp.async
constexpr int VEC_MASK = 2;   //        mask rows by 8-byte cp.async
constexpr int VEC_OUT = 4;    //        output column pairs as bf16x2

using ddt::cp_async16;
using ddt::cp_async4;
using ddt::cp_async8;
using ddt::cp_async_commit;
using ddt::cp_async_wait;
using ddt::ldsm_x4;
using ddt::ldsm_x4_trans;
using ddt::mma_bf16;
using ddt::mma_tf32x3;
using ddt::pack_bf16;
using ddt::smem_u32;
using ddt::split_tf32;

// Rows [r0, r0 + ROWS) of one head's (T, D) matrix into a [ROWS][DP + EPC]
// tile (EPC: elements per 16 bytes; bf16 rows DP + 8, float32 DP + 4);
// rows past T and columns past D become zero. With VEC_QKV by 16-byte
// cp.async (D % EPC == 0, 16-byte aligned rows), else element by element:
// bf16 by loads and stores, float32 by 4-byte cp.async.
template <int DP, int ROWS = MK, int NT = MNT, typename T>
__device__ __forceinline__ void load_rows(T* dst, const View<const T>& m, int b, int h, int r0, int T_, int D,
                                          bool vec) {
  constexpr int EPC = 16 / sizeof(T), LD = DP + EPC, CPR = DP / EPC, N = ROWS * CPR;
  if (vec) {
#pragma unroll
    for (int it = 0; it < (N + NT - 1) / NT; ++it) {
      const int e = threadIdx.x + it * NT, r = e / CPR, c = (e - r * CPR) * EPC;
      if (N % NT != 0 && e >= N) break;
      const bool ok = r0 + r < T_ && c < D;
      cp_async16(smem_u32(dst + r * LD + c), ok ? m.row(b, h, r0 + r) + c : m.p, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += NT) {
      const int r = e / DP, c = e - r * DP;
      const bool ok = r0 + r < T_ && c < D;
      if constexpr (sizeof(T) == 4) {
        cp_async4(smem_u32(dst + r * LD + c), ok ? m.row(b, h, r0 + r) + c : m.p, ok ? 4 : 0);
      } else {
        dst[r * LD + c] = ok ? m.row(b, h, r0 + r)[c] : __float2bfloat16(0.f);
      }
    }
  }
}

// The (ROWS query rows) x (KEYS keys) block of the keep mask at (i0, j0) of
// head row `bh` into [ROWS][LDM] bytes; outside T x T zero.
template <int LDM = MASK_LD, int KEYS = MK, int ROWS = MQ, int NT = MNT>
__device__ __forceinline__ void load_mask(unsigned char* dst, const unsigned char* mask, int bh,
                                          int i0, int j0, int T_, bool vec) {
  constexpr int N = ROWS * (KEYS / 8);  // 8-byte chunks
  const size_t base = (size_t)bh * T_ * T_;
  if (vec) {
#pragma unroll
    for (int it = 0; it < (N + NT - 1) / NT; ++it) {
      const int e = threadIdx.x + it * NT, r = e / (KEYS / 8), c = (e - r * (KEYS / 8)) * 8;
      if (N % NT != 0 && e >= N) break;
      const bool ok = i0 + r < T_ && j0 + c < T_;  // T % 8 == 0: a chunk is whole or out
      cp_async8(smem_u32(dst + r * LDM + c), ok ? mask + base + (size_t)(i0 + r) * T_ + j0 + c : mask,
                ok ? 8 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * KEYS; e += NT) {
      const int r = e / KEYS, c = e - r * KEYS;
      dst[r * LDM + c] = i0 + r < T_ && j0 + c < T_ ? mask[base + (size_t)(i0 + r) * T_ + j0 + c] : 0;
    }
  }
}

// s (q k^T in the mma C layout for NB keys from j0) times scale; keys past T
// get -inf.
template <int NB>
__device__ __forceinline__ void finish_scores(float (&s)[NB / 8][4], int j0, int T_, float scale) {
#pragma unroll
  for (int n = 0; n < NB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale);
  if (j0 + NB > T_) {  // the last tile: keys past T (whole n8 tiles, T % 8 == 0) get -inf
    const float ninf = -__int_as_float(0x7f800000);
#pragma unroll
    for (int n = 0; n < NB / 8; ++n)
      if (j0 + n * 8 >= T_) s[n][0] = s[n][1] = s[n][2] = s[n][3] = ninf;
  }
}

// s = (q k^T) * scale for the warp's 16 rows and the tile's 64 keys, in
// the mma C layout: s[n][0..1] row g, s[n][2..3] row g + 8, columns
// 8n + 2(lane % 4) + {0, 1}; keys past T get -inf.
template <int DP>
__device__ __forceinline__ void tile_scores(float (&s)[MK / 8][4], const uint32_t (&qf)[DP / 16][4],
                                            const bf16* kt, int j0, int T_, float scale) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4: keys +0..7 / d +0..7, keys +0..7 / d +8..15, keys +8..15 / ...
  const int kr = (lane & 7) + ((lane >> 4) << 3), kc = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int n = 0; n < MK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int np = 0; np < MK / 16; ++np) {
      uint32_t kb[4];
      ldsm_x4(kb, smem_u32(kt + (np * 16 + kr) * LD + kk * 16 + kc));
      mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
      mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
    }
  finish_scores<MK>(s, j0, T_, scale);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr float LOG2E = 1.4426950408889634f;

// exp(s - m), given ml = m * log2(e): one FMA and the SFU's ex2, against
// about eight instructions for expf (relative error ~1e-6 for |s| < 100,
// far below the 2^-9 of p's bf16 rounding).
__device__ __forceinline__ float exp_shifted(float s, float ml) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaf(s, LOG2E, -ml)));
  return y;
}

template <int DP>
__global__ void __launch_bounds__(MNT) attn_fwd_mma_kernel(Args<bf16> a, int flags) {
  constexpr int LD = DP + 8;  // +16 bytes a row: the 8 rows of an ldmatrix hit 8 bank groups
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // [MQ][LD]
  bf16* ks = qs + MQ * LD;                       // [NS][MK][LD]
  bf16* vs = ks + NS * MK * LD;                  // [NS][MK][LD]
  unsigned char* ms = reinterpret_cast<unsigned char*>(vs + NS * MK * LD);  // [NS][MQ][MASK_LD]
  const int T_ = a.Tn, D = a.D;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H, i0 = blockIdx.y * MQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, qd = lane & 3;
  const int nkt = (T_ + MK - 1) / MK, stages = 2 * nkt;
  const bool vec = flags & VEC_QKV;

  // Stage t < nkt: K tile t (pass 1); stage nkt + t: K, V and mask tile t
  // (pass 2). NS buffers: stage t + NS - 1 is in flight while t is used.
  auto issue = [&](int t) {
    if (t < stages) {
      const int buf = t % NS, j0 = (t < nkt ? t : t - nkt) * MK;
      load_rows<DP>(ks + buf * MK * LD, a.k, b, h, j0, T_, D, vec);
      if (t >= nkt) {
        load_rows<DP>(vs + buf * MK * LD, a.v, b, h, j0, T_, D, vec);
        if (a.mask) load_mask(ms + buf * MQ * MASK_LD, a.mask, bh, i0, j0, T_, flags & VEC_MASK);
      }
    }
    cp_async_commit();
  };
  auto arrive = [&](int t) {  // prefetch stage t + NS - 1, then wait for stage t
    issue(t + NS - 1);
    cp_async_wait<NS - 1>();
    __syncthreads();
  };

  load_rows<DP>(qs, a.q, b, h, i0, T_, D, vec);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) issue(t);
  cp_async_wait<NS - 1>();
  __syncthreads();
  uint32_t qf[DP / 16][4];  // the warp's 16 Q rows as A fragments
  {
    // ldmatrix.x4: rows +0..7 / d +0..7, rows +8..15 / d +0..7, rows +0..7 / d +8..15, ...
    const int qr = warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3), qc = (lane >> 4) << 3;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) ldsm_x4(qf[kk], smem_u32(qs + qr * LD + kk * 16 + qc));
  }
  float mx[2], l[2] = {0.f, 0.f};
  mx[0] = mx[1] = -__int_as_float(0x7f800000);

  // Pass 1: each row's max and sum of exp(s - max), online over the tiles.
  for (int t = 0; t < nkt; ++t) {
    arrive(t);
    float s[MK / 8][4];
    tile_scores<DP>(s, qf, ks + (t % NS) * MK * LD, t * MK, T_, a.scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = s[0][2 * r];
#pragma unroll
      for (int n = 0; n < MK / 8; ++n) m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      m = fmaxf(mx[r], quad_max(m));
      const float ml = m * LOG2E;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < MK / 8; ++n)
        sum += exp_shifted(s[n][2 * r], ml) + exp_shifted(s[n][2 * r + 1], ml);
      l[r] = l[r] * exp_shifted(mx[r], ml) + sum;  // the first tile: exp(-inf) = 0
      mx[r] = m;
    }
    __syncthreads();
  }
  float inv_l[2], mxl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv_l[r] = 1.f / quad_sum(l[r]);
    mxl[r] = mx[r] * LOG2E;
  }

  // Pass 2: p = exp(s - max) / sum, the mask, rounded to bf16, times V.
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // ldmatrix.x4.trans of V: keys +0..7 / d +0..7, keys +8..15 / d +0..7, keys +0..7 / d +8..15, ...
  const int vr = (lane & 7) + (((lane >> 3) & 1) << 3), vc = (lane >> 4) << 3;
  for (int t = nkt; t < stages; ++t) {
    arrive(t);
    const int buf = t % NS;
    float s[MK / 8][4];
    tile_scores<DP>(s, qf, ks + buf * MK * LD, (t - nkt) * MK, T_, a.scale);
    const unsigned char* mrow = ms + buf * MQ * MASK_LD + (warp * 16 + g) * MASK_LD + 2 * qd;
#pragma unroll
    for (int n = 0; n < MK / 8; ++n) {
      uint32_t keep[2] = {0xffffu, 0xffffu};  // rows g, g + 8: columns 2qd, 2qd + 1 as bytes
      if (a.mask) {
        keep[0] = *reinterpret_cast<const uint16_t*>(mrow + n * 8);
        keep[1] = *reinterpret_cast<const uint16_t*>(mrow + 8 * MASK_LD + n * 8);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = __fmul_rn(exp_shifted(s[n][e], mxl[e >> 1]), inv_l[e >> 1]);
        if (a.mask) p = (keep[e >> 1] >> (8 * (e & 1))) & 0xffu ? __fmul_rn(p, a.inv_keep) : 0.f;
        s[n][e] = p;
      }
    }
    const bf16* vt = vs + buf * MK * LD;
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      // the C layout of n8 tiles 2kk, 2kk + 1 is the A layout of k16 step kk
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, smem_u32(vt + (kk * 16 + vr) * LD + dp * 16 + vc));
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + warp * 16 + g + 8 * r;
    if (i >= T_) continue;
    bf16* orow = a.o.row(b, h, i);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * qd;
      if (c >= D) continue;
      if (flags & VEC_OUT) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(o[n][2 * r], o[n][2 * r + 1]);
      } else {
        orow[c] = __float2bfloat16(o[n][2 * r]);
        if (c + 1 < D) orow[c + 1] = __float2bfloat16(o[n][2 * r + 1]);
      }
    }
  }
}

// ---- bf16 backward on the tensor cores ----

// Mask row stride of the backward (bytes): two blocks of either launch fit
// an SM at DP = 128, and the row-pair reads of launch 1 and the column
// reads of launch 2 both hit distinct banks across a warp.
constexpr int MASK_LDB = 72;

// acc = A B^T in the mma C layout (16 x NB) for the warp's 16 rows of `a`
// and rows [0, NB) of `bt`, both [rows][DP + 8] bf16 tiles in shared
// memory. The A fragments are read from shared memory at each k16 step,
// which keeps them out of the registers the accumulators need.
template <int DP, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB / 8][4], const bf16* a, const bf16* bt) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31;
  // A (as the forward's Q fragments): rows +0..7 / d +0..7, rows +8..15 / d +0..7, rows +0..7 / d +8..15, ...
  const int ar = (lane & 7) + (((lane >> 3) & 1) << 3), ac = (lane >> 4) << 3;
  // B (as the forward's K tile): rows +0..7 / d +0..7, rows +0..7 / d +8..15, rows +8..15 / d +0..7, ...
  const int br = (lane & 7) + ((lane >> 4) << 3), bc = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int n = 0; n < NB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, smem_u32(a + ar * LD + kk * 16 + ac));
#pragma unroll
    for (int np = 0; np < NB / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, smem_u32(bt + (np * 16 + br) * LD + kk * 16 + bc));
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x DP) += P M: P as KS k16 steps of A fragments, M the rows
// [0, 16 KS) and columns [0, DP) of a [rows][LD] tile, read by ldmatrix.trans.
template <int DP, int KS, int LD = DP + 8>
__device__ __forceinline__ void mma_pm(float (&acc)[DP / 8][4], const uint32_t (&pa)[KS][4], const bf16* mt) {
  const int lane = threadIdx.x & 31;
  const int vr = (lane & 7) + (((lane >> 3) & 1) << 3), vc = (lane >> 4) << 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, smem_u32(mt + (kk * 16 + vr) * LD + dp * 16 + vc));
      mma_bf16(acc[2 * dp], pa[kk], vb[0], vb[1]);
      mma_bf16(acc[2 * dp + 1], pa[kk], vb[2], vb[3]);
    }
}

// C fragments of NC n8 tiles, rounded to bf16, as the A fragments of NC / 2
// k16 steps (the C layout of n8 tiles 2kk, 2kk + 1 is the A layout of step kk).
template <int NC>
__device__ __forceinline__ void c_to_a(uint32_t (&pa)[NC / 2][4], const float (&c)[NC][4]) {
#pragma unroll
  for (int kk = 0; kk < NC / 2; ++kk) {
    pa[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    pa[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    pa[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// x = keep ? x / (1 - p) : 0 on a 16 x NB C-layout tile whose rows are the
// mask tile's rows (LDM bytes apart); `mrow` points at the thread's row g,
// column 2 (lane % 4).
// As x times a selected factor: the same values for finite x (a dropped
// entry becomes a signed zero), and no branch (the conditional product
// compiled to divergent branches and made the masked backward 1.2-1.6x
// the unmasked one).
template <int NB = MK, int LDM = MASK_LDB>
__device__ __forceinline__ void apply_mask(float (&x)[NB / 8][4], const unsigned char* mrow, float inv_keep) {
#pragma unroll
  for (int n = 0; n < NB / 8; ++n) {
    const uint32_t keep[2] = {*reinterpret_cast<const uint16_t*>(mrow + n * 8),
                              *reinterpret_cast<const uint16_t*>(mrow + 8 * LDM + n * 8)};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[n][e] = __fmul_rn(x[n][e], (keep[e >> 1] >> (8 * (e & 1))) & 0xffu ? inv_keep : 0.f);
  }
}

// The warp's 16 rows of a 16 x DP accumulator to rows r0 + (0..15) of `out`
// (rows past T and columns past D skipped); column pairs (bf16x2, float2)
// with VEC_OUT.
template <int DP, typename T>
__device__ __forceinline__ void store_acc(const View<T>& out, const float (&acc)[DP / 8][4], int b, int h,
                                          int r0, int T_, int D, bool vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    if (i >= T_) continue;
    T* orow = out.row(b, h, i);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * qd;
      if (c >= D) continue;
      const float x = acc[n][2 * r], y = acc[n][2 * r + 1];
      if constexpr (std::is_same<T, float>::value) {
        if (vec) {
          *reinterpret_cast<float2*>(orow + c) = make_float2(x, y);
        } else {
          orow[c] = x;
          if (c + 1 < D) orow[c + 1] = y;
        }
      } else if (vec) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(x, y);
      } else {
        orow[c] = __float2bfloat16(x);
        if (c + 1 < D) orow[c + 1] = __float2bfloat16(y);
      }
    }
  }
}

// Launch 1 of the bf16 backward, per 64 query rows (16 a warp): pass 1 over
// K, V and mask tiles keeps each row's running max, sum of exp(s - max) and
// sum of dp exp(s - max) (the last rescaled with the sum, so delta =
// sum_j dp p comes out of the same pass); pass 2 recomputes s and dp, forms
// ds = (p (dp - delta)) scale rounded to bf16 in the C fragments and
// accumulates dq = ds K. Writes (max log2 e, 1 / sum, delta) per row to
// `stats` for launch 2.
template <int DP>
__global__ void __launch_bounds__(MNT) attn_bwd_dq_mma_kernel(Args<bf16> a, int flags) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // [MQ][LD]
  bf16* dos = qs + MQ * LD;                      // [MQ][LD]
  bf16* ks = dos + MQ * LD;                      // [NS][MK][LD]
  bf16* vs = ks + NS * MK * LD;                  // [NS][MK][LD]
  unsigned char* ms = reinterpret_cast<unsigned char*>(vs + NS * MK * LD);  // [NS][MQ][MASK_LDB]
  const int T_ = a.Tn, D = a.D;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H, i0 = blockIdx.y * MQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, qd = lane & 3;
  const int nkt = (T_ + MK - 1) / MK, stages = 2 * nkt;
  const bool vec = flags & VEC_QKV;

  // Stage t: K, V and mask tile t % nkt (pass 1 for t < nkt, then pass 2).
  auto issue = [&](int t) {
    if (t < stages) {
      const int buf = t % NS, j0 = (t % nkt) * MK;
      load_rows<DP>(ks + buf * MK * LD, a.k, b, h, j0, T_, D, vec);
      load_rows<DP>(vs + buf * MK * LD, a.v, b, h, j0, T_, D, vec);
      if (a.mask) load_mask<MASK_LDB>(ms + buf * MQ * MASK_LDB, a.mask, bh, i0, j0, T_, flags & VEC_MASK);
    }
    cp_async_commit();
  };
  auto arrive = [&](int t) {
    issue(t + NS - 1);
    cp_async_wait<NS - 1>();
    __syncthreads();
  };

  load_rows<DP>(qs, a.q, b, h, i0, T_, D, vec);
  load_rows<DP>(dos, a.dout, b, h, i0, T_, D, vec);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) issue(t);
  cp_async_wait<NS - 1>();
  __syncthreads();
  uint32_t qf[DP / 16][4];  // the warp's 16 Q rows as A fragments (dO's are read per product)
  {
    const int qr = warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3), qc = (lane >> 4) << 3;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) ldsm_x4(qf[kk], smem_u32(qs + qr * LD + kk * 16 + qc));
  }
  const bf16* dor = dos + warp * 16 * LD;
  const int mrow = (warp * 16 + g) * MASK_LDB + 2 * qd;
  float mx[2], l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  mx[0] = mx[1] = -__int_as_float(0x7f800000);

  // Pass 1: online max, sum and dp-weighted sum of exp(s - max).
  for (int t = 0; t < nkt; ++t) {
    arrive(t);
    const int buf = t % NS;
    float s[MK / 8][4], dp[MK / 8][4];
    tile_scores<DP>(s, qf, ks + buf * MK * LD, t * MK, T_, a.scale);
    mma_abt<DP, MK>(dp, dor, vs + buf * MK * LD);
    if (a.mask) apply_mask(dp, ms + buf * MQ * MASK_LDB + mrow, a.inv_keep);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = s[0][2 * r];
#pragma unroll
      for (int n = 0; n < MK / 8; ++n) m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      m = fmaxf(mx[r], quad_max(m));
      const float ml = m * LOG2E;
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int n = 0; n < MK / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = exp_shifted(s[n][2 * r + c], ml);
          sum += e;
          dsum = fmaf(dp[n][2 * r + c], e, dsum);
        }
      const float corr = exp_shifted(mx[r], ml);  // the first tile: exp(-inf) = 0
      l[r] = l[r] * corr + sum;
      dl[r] = dl[r] * corr + dsum;
      mx[r] = m;
    }
    __syncthreads();
  }
  float mxl[2], inv_l[2], delta[2];
  const size_t N = (size_t)a.B * a.H * T_;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    inv_l[r] = 1.f / lsum;
    mxl[r] = mx[r] * LOG2E;
    delta[r] = quad_sum(dl[r]) / lsum;
    const int i = i0 + warp * 16 + g + 8 * r;
    if (qd == 0 && i < T_) {
      const size_t row = (size_t)bh * T_ + i;
      a.stats[row] = mxl[r];
      a.stats[N + row] = inv_l[r];
      a.stats[2 * N + row] = delta[r];
    }
  }

  // Pass 2: ds in the C fragments, rounded to bf16 as A fragments, times K.
  float dq[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  for (int t = nkt; t < stages; ++t) {
    arrive(t);
    const int buf = t % NS;
    float s[MK / 8][4], dp[MK / 8][4];
    tile_scores<DP>(s, qf, ks + buf * MK * LD, (t - nkt) * MK, T_, a.scale);
    mma_abt<DP, MK>(dp, dor, vs + buf * MK * LD);
    if (a.mask) apply_mask(dp, ms + buf * MQ * MASK_LDB + mrow, a.inv_keep);
#pragma unroll
    for (int n = 0; n < MK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = __fmul_rn(exp_shifted(s[n][e], mxl[r]), inv_l[r]);
        s[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][e], delta[r])), a.scale);
      }
    uint32_t da[MK / 16][4];
    c_to_a(da, s);
    mma_pm<DP, MK / 16>(dq, da, ks + buf * MK * LD);
    __syncthreads();
  }
  store_acc<DP>(a.dq, dq, b, h, i0 + warp * 16, T_, D, flags & VEC_OUT);
}

// The per-query statistics (max log2 e, 1 / sum, delta) of rows
// [row0, row0 + ROWS) into dst[3][ROWS] by 16-byte cp.async; rows at or past
// `n_rows` become zero, so padded queries get p = 0 and ds = 0.
template <int ROWS = MQ>
__device__ __forceinline__ void load_stats(float* dst, const float* stats, size_t N, size_t row0, int n_rows) {
  constexpr int CH = ROWS / 4;  // 16-byte chunks per statistic
  const int e = threadIdx.x;
  if (e < 3 * CH) {
    const int k = e / CH, c = (e - k * CH) * 4;
    const bool ok = c < n_rows;  // T % 8 == 0: a chunk is whole or out
    cp_async16(smem_u32(dst + k * ROWS + c), ok ? stats + k * N + row0 + c : stats, ok ? 16 : 0);
  }
}

// Launch 2 of the bf16 backward, per 64 keys (16 a warp), over every query
// tile: s^T = K Q^T and dp^T = V dO^T with K and V as A fragments, p^T from
// launch 1's statistics (columns are queries), then dv += pd^T dO and
// dk += ds^T Q from the C fragments packed to bf16. At DP = 128 a query
// tile goes in two chunks of 32, one after the other, so the dk and dv
// accumulators (128 f32 a thread) leave room for the scores without
// spilling (246 registers; 64-query chunks, or two 32-query chunks
// unrolled together, spill at the 255 cap).
template <int DP>
__global__ void __launch_bounds__(MNT) attn_bwd_dkdv_mma_kernel(Args<bf16> a, int flags) {
  constexpr int LD = DP + 8, QC = DP >= 128 ? 32 : MQ;  // QC: queries per chunk
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* ks = reinterpret_cast<bf16*>(smem_mma);  // [MK][LD]
  bf16* vs = ks + MK * LD;                       // [MK][LD]
  bf16* qs = vs + MK * LD;                       // [NS][MQ][LD]
  bf16* dos = qs + NS * MQ * LD;                 // [NS][MQ][LD]
  float* sts = reinterpret_cast<float*>(dos + NS * MQ * LD);                 // [NS][3][MQ]
  unsigned char* ms = reinterpret_cast<unsigned char*>(sts + NS * 3 * MQ);  // [NS][MQ][MASK_LDB]
  const int T_ = a.Tn, D = a.D;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H, j0 = blockIdx.y * MK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, qd = lane & 3;
  const int nqt = (T_ + MQ - 1) / MQ;
  const size_t N = (size_t)a.B * a.H * T_;
  const bool vec = flags & VEC_QKV;

  // Stage t: Q, dO, statistics and mask of query tile t.
  auto issue = [&](int t) {
    if (t < nqt) {
      const int buf = t % NS, i0 = t * MQ;
      load_rows<DP>(qs + buf * MQ * LD, a.q, b, h, i0, T_, D, vec);
      load_rows<DP>(dos + buf * MQ * LD, a.dout, b, h, i0, T_, D, vec);
      load_stats(sts + buf * 3 * MQ, a.stats, N, (size_t)bh * T_ + i0, T_ - i0);
      if (a.mask) load_mask<MASK_LDB>(ms + buf * MQ * MASK_LDB, a.mask, bh, i0, j0, T_, flags & VEC_MASK);
    }
    cp_async_commit();
  };
  auto arrive = [&](int t) {
    issue(t + NS - 1);
    cp_async_wait<NS - 1>();
    __syncthreads();
  };

  load_rows<DP>(ks, a.k, b, h, j0, T_, D, vec);
  load_rows<DP>(vs, a.v, b, h, j0, T_, D, vec);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) issue(t);
  cp_async_wait<NS - 1>();
  __syncthreads();
  const bf16* kr = ks + warp * 16 * LD;
  const bf16* vr = vs + warp * 16 * LD;
  const int mcol = warp * 16 + g;  // the thread's key column in the mask tile (and + 8)
  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int t = 0; t < nqt; ++t) {
    arrive(t);
    const int buf = t % NS;
    const bf16* qt = qs + buf * MQ * LD;
    const bf16* dot = dos + buf * MQ * LD;
    const float* st = sts + buf * 3 * MQ;
    const unsigned char* mt = ms + buf * MQ * MASK_LDB;
#pragma unroll 1  // unrolled, the two chunks at DP = 128 overlap and spill (255 registers)
    for (int c0 = 0; c0 < MQ; c0 += QC) {
      float s[QC / 8][4], dp[QC / 8][4];  // rows: keys g, g + 8; columns: queries
      mma_abt<DP, QC>(s, kr, qt + c0 * LD);
      mma_abt<DP, QC>(dp, vr, dot + c0 * LD);
#pragma unroll
      for (int n = 0; n < QC / 8; ++n) {
        const int c = c0 + n * 8 + 2 * qd;  // the query of e = 0, 2; c + 1 for e = 1, 3
        const float2 ml = *reinterpret_cast<const float2*>(st + c);
        const float2 il = *reinterpret_cast<const float2*>(st + MQ + c);
        const float2 de = *reinterpret_cast<const float2*>(st + 2 * MQ + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e & 1;
          const float p = __fmul_rn(exp_shifted(__fmul_rn(s[n][e], a.scale), hi ? ml.y : ml.x), hi ? il.y : il.x);
          float pd = p, d = dp[n][e];
          if (a.mask) {
            const float km = mt[(c + hi) * MASK_LDB + mcol + 8 * (e >> 1)] ? a.inv_keep : 0.f;  // as `apply_mask`
            pd = __fmul_rn(p, km);
            d = __fmul_rn(d, km);
          }
          s[n][e] = pd;
          dp[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(d, hi ? de.y : de.x)), a.scale);
        }
      }
      uint32_t pa[QC / 16][4], sa[QC / 16][4];
      c_to_a(pa, s);
      c_to_a(sa, dp);
      mma_pm<DP, QC / 16>(dv, pa, dot + c0 * LD);
      mma_pm<DP, QC / 16>(dk, sa, qt + c0 * LD);
    }
    __syncthreads();
  }
  const bool vout = flags & VEC_OUT;
  store_acc<DP>(a.dk, dk, b, h, j0 + warp * 16, T_, D, vout);
  store_acc<DP>(a.dv, dv, b, h, j0 + warp * 16, T_, D, vout);
}

// ---- bf16 with 128 < D <= 256 on the tensor cores ----

// D zero-padded to DW; see the file header for the register partition.
constexpr int DW = 256;       // padded head width
constexpr int MKW = 32;       // keys per streamed tile (forward, backward launch 1)
constexpr int MASK_LDW = 48;  // mask row stride of a 64 x 32 tile (bytes): conflict-free u16 row-pair reads
constexpr int DH = DW / 2;    // dk and dv columns per block (backward launch 2)

// s = (q k^T) * scale for the warp's 16 rows `qw` and the NB keys of `kt`
// (both [rows][DW + 8] tiles) in the mma C layout; keys past T get -inf.
template <int NB>
__device__ __forceinline__ void wide_scores(float (&s)[NB / 8][4], const bf16* qw, const bf16* kt, int j0, int T_,
                                            float scale) {
  mma_abt<DW, NB>(s, qw, kt);
  finish_scores<NB>(s, j0, T_, scale);
}

// The forward at 128 < D <= 256: `attn_fwd_mma_kernel`'s two passes over
// 32-key tiles, the warp's 16 Q rows read from shared memory per product.
__global__ void __launch_bounds__(MNT) attn_fwd_mma_wide_kernel(Args<bf16> a, int flags) {
  constexpr int LD = DW + 8;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // [MQ][LD]
  bf16* ks = qs + MQ * LD;                       // [NS][MKW][LD]
  bf16* vs = ks + NS * MKW * LD;                 // [NS][MKW][LD]
  unsigned char* ms = reinterpret_cast<unsigned char*>(vs + NS * MKW * LD);  // [NS][MQ][MASK_LDW]
  const int T_ = a.Tn, D = a.D;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H, i0 = blockIdx.y * MQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, qd = lane & 3;
  const int nkt = (T_ + MKW - 1) / MKW, stages = 2 * nkt;
  const bool vec = flags & VEC_QKV;

  // Stage t < nkt: K tile t (pass 1); stage nkt + t: K, V and mask tile t (pass 2).
  auto issue = [&](int t) {
    if (t < stages) {
      const int buf = t % NS, j0 = (t < nkt ? t : t - nkt) * MKW;
      load_rows<DW, MKW>(ks + buf * MKW * LD, a.k, b, h, j0, T_, D, vec);
      if (t >= nkt) {
        load_rows<DW, MKW>(vs + buf * MKW * LD, a.v, b, h, j0, T_, D, vec);
        if (a.mask) load_mask<MASK_LDW, MKW>(ms + buf * MQ * MASK_LDW, a.mask, bh, i0, j0, T_, flags & VEC_MASK);
      }
    }
    cp_async_commit();
  };
  auto arrive = [&](int t) {  // prefetch stage t + NS - 1, then wait for stage t (and Q)
    issue(t + NS - 1);
    cp_async_wait<NS - 1>();
    __syncthreads();
  };

  load_rows<DW>(qs, a.q, b, h, i0, T_, D, vec);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) issue(t);
  const bf16* qw = qs + warp * 16 * LD;
  float mx[2], l[2] = {0.f, 0.f};
  mx[0] = mx[1] = -__int_as_float(0x7f800000);

  // Pass 1: each row's max and sum of exp(s - max), online over the tiles.
  for (int t = 0; t < nkt; ++t) {
    arrive(t);
    float s[MKW / 8][4];
    wide_scores<MKW>(s, qw, ks + (t % NS) * MKW * LD, t * MKW, T_, a.scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = s[0][2 * r];
#pragma unroll
      for (int n = 0; n < MKW / 8; ++n) m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      m = fmaxf(mx[r], quad_max(m));
      const float ml = m * LOG2E;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < MKW / 8; ++n) sum += exp_shifted(s[n][2 * r], ml) + exp_shifted(s[n][2 * r + 1], ml);
      l[r] = l[r] * exp_shifted(mx[r], ml) + sum;  // the first tile: exp(-inf) = 0
      mx[r] = m;
    }
    __syncthreads();
  }
  float inv_l[2], mxl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv_l[r] = 1.f / quad_sum(l[r]);
    mxl[r] = mx[r] * LOG2E;
  }

  // Pass 2: p = exp(s - max) / sum, the mask, rounded to bf16, times V.
  float o[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const int mrow = (warp * 16 + g) * MASK_LDW + 2 * qd;
  for (int t = nkt; t < stages; ++t) {
    arrive(t);
    const int buf = t % NS;
    float s[MKW / 8][4];
    wide_scores<MKW>(s, qw, ks + buf * MKW * LD, (t - nkt) * MKW, T_, a.scale);
#pragma unroll
    for (int n = 0; n < MKW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(exp_shifted(s[n][e], mxl[e >> 1]), inv_l[e >> 1]);
    if (a.mask) apply_mask<MKW, MASK_LDW>(s, ms + buf * MQ * MASK_LDW + mrow, a.inv_keep);
    uint32_t pa[MKW / 16][4];
    c_to_a(pa, s);
    mma_pm<DW, MKW / 16>(o, pa, vs + buf * MKW * LD);
    __syncthreads();
  }
  store_acc<DW>(a.o, o, b, h, i0 + warp * 16, T_, D, flags & VEC_OUT);
}

// Launch 1 of the backward at 128 < D <= 256: `attn_bwd_dq_mma_kernel`
// over 32-key tiles, the warp's Q and dO rows read from shared memory per
// product (one block an SM: Q, dO and two K and V tiles take 132 KB).
__global__ void __launch_bounds__(MNT) attn_bwd_dq_mma_wide_kernel(Args<bf16> a, int flags) {
  constexpr int LD = DW + 8;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // [MQ][LD]
  bf16* dos = qs + MQ * LD;                      // [MQ][LD]
  bf16* ks = dos + MQ * LD;                      // [NS][MKW][LD]
  bf16* vs = ks + NS * MKW * LD;                 // [NS][MKW][LD]
  unsigned char* ms = reinterpret_cast<unsigned char*>(vs + NS * MKW * LD);  // [NS][MQ][MASK_LDW]
  const int T_ = a.Tn, D = a.D;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H, i0 = blockIdx.y * MQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, qd = lane & 3;
  const int nkt = (T_ + MKW - 1) / MKW, stages = 2 * nkt;
  const bool vec = flags & VEC_QKV;

  // Stage t: K, V and mask tile t % nkt (pass 1 for t < nkt, then pass 2).
  auto issue = [&](int t) {
    if (t < stages) {
      const int buf = t % NS, j0 = (t % nkt) * MKW;
      load_rows<DW, MKW>(ks + buf * MKW * LD, a.k, b, h, j0, T_, D, vec);
      load_rows<DW, MKW>(vs + buf * MKW * LD, a.v, b, h, j0, T_, D, vec);
      if (a.mask) load_mask<MASK_LDW, MKW>(ms + buf * MQ * MASK_LDW, a.mask, bh, i0, j0, T_, flags & VEC_MASK);
    }
    cp_async_commit();
  };
  auto arrive = [&](int t) {
    issue(t + NS - 1);
    cp_async_wait<NS - 1>();
    __syncthreads();
  };

  load_rows<DW>(qs, a.q, b, h, i0, T_, D, vec);
  load_rows<DW>(dos, a.dout, b, h, i0, T_, D, vec);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) issue(t);
  const bf16* qw = qs + warp * 16 * LD;
  const bf16* dow = dos + warp * 16 * LD;
  const int mrow = (warp * 16 + g) * MASK_LDW + 2 * qd;
  float mx[2], l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  mx[0] = mx[1] = -__int_as_float(0x7f800000);

  // Pass 1: online max, sum and dp-weighted sum of exp(s - max).
  for (int t = 0; t < nkt; ++t) {
    arrive(t);
    const int buf = t % NS;
    float s[MKW / 8][4], dp[MKW / 8][4];
    wide_scores<MKW>(s, qw, ks + buf * MKW * LD, t * MKW, T_, a.scale);
    mma_abt<DW, MKW>(dp, dow, vs + buf * MKW * LD);
    if (a.mask) apply_mask<MKW, MASK_LDW>(dp, ms + buf * MQ * MASK_LDW + mrow, a.inv_keep);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = s[0][2 * r];
#pragma unroll
      for (int n = 0; n < MKW / 8; ++n) m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      m = fmaxf(mx[r], quad_max(m));
      const float ml = m * LOG2E;
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int n = 0; n < MKW / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = exp_shifted(s[n][2 * r + c], ml);
          sum += e;
          dsum = fmaf(dp[n][2 * r + c], e, dsum);
        }
      const float corr = exp_shifted(mx[r], ml);  // the first tile: exp(-inf) = 0
      l[r] = l[r] * corr + sum;
      dl[r] = dl[r] * corr + dsum;
      mx[r] = m;
    }
    __syncthreads();
  }
  float mxl[2], inv_l[2], delta[2];
  const size_t N = (size_t)a.B * a.H * T_;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    inv_l[r] = 1.f / lsum;
    mxl[r] = mx[r] * LOG2E;
    delta[r] = quad_sum(dl[r]) / lsum;
    const int i = i0 + warp * 16 + g + 8 * r;
    if (qd == 0 && i < T_) {
      const size_t row = (size_t)bh * T_ + i;
      a.stats[row] = mxl[r];
      a.stats[N + row] = inv_l[r];
      a.stats[2 * N + row] = delta[r];
    }
  }

  // Pass 2: ds in the C fragments, rounded to bf16 as A fragments, times K.
  float dq[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  for (int t = nkt; t < stages; ++t) {
    arrive(t);
    const int buf = t % NS;
    float s[MKW / 8][4], dp[MKW / 8][4];
    wide_scores<MKW>(s, qw, ks + buf * MKW * LD, (t - nkt) * MKW, T_, a.scale);
    mma_abt<DW, MKW>(dp, dow, vs + buf * MKW * LD);
    if (a.mask) apply_mask<MKW, MASK_LDW>(dp, ms + buf * MQ * MASK_LDW + mrow, a.inv_keep);
#pragma unroll
    for (int n = 0; n < MKW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = __fmul_rn(exp_shifted(s[n][e], mxl[r]), inv_l[r]);
        s[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][e], delta[r])), a.scale);
      }
    uint32_t da[MKW / 16][4];
    c_to_a(da, s);
    mma_pm<DW, MKW / 16>(dq, da, ks + buf * MKW * LD);
    __syncthreads();
  }
  store_acc<DW>(a.dq, dq, b, h, i0 + warp * 16, T_, D, flags & VEC_OUT);
}

// Launch 2 of the backward at 128 < D <= 256: `attn_bwd_dkdv_mma_kernel`
// on a grid that also splits D in halves (blockIdx.z). Each block
// recomputes s^T and dp^T over the full padded width and accumulates its
// 128 columns of dk and dv: the DP = 128 kernel's 128 accumulators a thread
// (why this split: the file header).
__global__ void __launch_bounds__(MNT) attn_bwd_dkdv_mma_wide_kernel(Args<bf16> a, int flags) {
  constexpr int LD = DW + 8, QC = 32;  // QC: queries per chunk
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* ks = reinterpret_cast<bf16*>(smem_mma);  // [MK][LD]
  bf16* vs = ks + MK * LD;                       // [MK][LD]
  bf16* qs = vs + MK * LD;                       // [NS][MQ][LD]
  bf16* dos = qs + NS * MQ * LD;                 // [NS][MQ][LD]
  float* sts = reinterpret_cast<float*>(dos + NS * MQ * LD);                 // [NS][3][MQ]
  unsigned char* ms = reinterpret_cast<unsigned char*>(sts + NS * 3 * MQ);  // [NS][MQ][MASK_LDB]
  const int T_ = a.Tn, D = a.D;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H, j0 = blockIdx.y * MK, d0 = blockIdx.z * DH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, qd = lane & 3;
  const int nqt = (T_ + MQ - 1) / MQ;
  const size_t N = (size_t)a.B * a.H * T_;
  const bool vec = flags & VEC_QKV;

  // Stage t: Q, dO, statistics and mask of query tile t.
  auto issue = [&](int t) {
    if (t < nqt) {
      const int buf = t % NS, i0 = t * MQ;
      load_rows<DW>(qs + buf * MQ * LD, a.q, b, h, i0, T_, D, vec);
      load_rows<DW>(dos + buf * MQ * LD, a.dout, b, h, i0, T_, D, vec);
      load_stats(sts + buf * 3 * MQ, a.stats, N, (size_t)bh * T_ + i0, T_ - i0);
      if (a.mask) load_mask<MASK_LDB>(ms + buf * MQ * MASK_LDB, a.mask, bh, i0, j0, T_, flags & VEC_MASK);
    }
    cp_async_commit();
  };
  auto arrive = [&](int t) {
    issue(t + NS - 1);
    cp_async_wait<NS - 1>();
    __syncthreads();
  };

  load_rows<DW>(ks, a.k, b, h, j0, T_, D, vec);
  load_rows<DW>(vs, a.v, b, h, j0, T_, D, vec);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) issue(t);
  const bf16* kr = ks + warp * 16 * LD;
  const bf16* vr = vs + warp * 16 * LD;
  const int mcol = warp * 16 + g;  // the thread's key column in the mask tile (and + 8)
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int t = 0; t < nqt; ++t) {
    arrive(t);
    const int buf = t % NS;
    const bf16* qt = qs + buf * MQ * LD;
    const bf16* dot = dos + buf * MQ * LD;
    const float* st = sts + buf * 3 * MQ;
    const unsigned char* mt = ms + buf * MQ * MASK_LDB;
#pragma unroll 1
    for (int c0 = 0; c0 < MQ; c0 += QC) {
      float s[QC / 8][4], dp[QC / 8][4];  // rows: keys g, g + 8; columns: queries
      mma_abt<DW, QC>(s, kr, qt + c0 * LD);
      mma_abt<DW, QC>(dp, vr, dot + c0 * LD);
#pragma unroll
      for (int n = 0; n < QC / 8; ++n) {
        const int c = c0 + n * 8 + 2 * qd;  // the query of e = 0, 2; c + 1 for e = 1, 3
        const float2 ml = *reinterpret_cast<const float2*>(st + c);
        const float2 il = *reinterpret_cast<const float2*>(st + MQ + c);
        const float2 de = *reinterpret_cast<const float2*>(st + 2 * MQ + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e & 1;
          const float p = __fmul_rn(exp_shifted(__fmul_rn(s[n][e], a.scale), hi ? ml.y : ml.x), hi ? il.y : il.x);
          float pd = p, d = dp[n][e];
          if (a.mask) {
            const float km = mt[(c + hi) * MASK_LDB + mcol + 8 * (e >> 1)] ? a.inv_keep : 0.f;  // as `apply_mask`
            pd = __fmul_rn(p, km);
            d = __fmul_rn(d, km);
          }
          s[n][e] = pd;
          dp[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(d, hi ? de.y : de.x)), a.scale);
        }
      }
      uint32_t pa[QC / 16][4], sa[QC / 16][4];
      c_to_a(pa, s);
      c_to_a(sa, dp);
      mma_pm<DH, QC / 16, LD>(dv, pa, dot + c0 * LD + d0);
      mma_pm<DH, QC / 16, LD>(dk, sa, qt + c0 * LD + d0);
    }
    __syncthreads();
  }
  View<bf16> dko = a.dk, dvo = a.dv;  // the block's columns [d0, d0 + DH)
  dko.p += d0;
  dvo.p += d0;
  const bool vout = flags & VEC_OUT;
  store_acc<DH>(dko, dk, b, h, j0 + warp * 16, T_, D - d0, vout);
  store_acc<DH>(dvo, dv, b, h, j0 + warp * 16, T_, D - d0, vout);
}

// ---- float32 on the tensor cores: 3xTF32 ----

// Tiles of the float32 kernels (the file header): keys a streamed tile of
// the forward; keys a tile of backward launch 1 and queries of launch 2.
__host__ __device__ constexpr int tf32_fwd_keys(int dp) { return dp <= 64 ? 64 : dp == 128 ? 32 : 16; }
__host__ __device__ constexpr int tf32_fwd_bufs(int dp) { return dp > 128 ? 1 : NS; }  // K, V and mask tile buffers
__host__ __device__ constexpr int tf32_bwd_tile(int dp) { return dp <= 32 ? 64 : dp == 64 ? 32 : 16; }
// Warp groups of the backward: at DP = 256 two, each reducing and owning half of DP.
__host__ __device__ constexpr int tf32_bwd_groups(int dp) { return dp > 128 ? 2 : 1; }
// Mask row stride (bytes) of a 64-query tile of `keys` keys: the row-pair
// u16 reads of `apply_mask` hit distinct banks across a warp.
__host__ __device__ constexpr int tf32_mask_ld(int keys) {
  return keys == 64 ? MASK_LD : keys == 32 ? MASK_LDW : 16;
}

// acc = A B^T (16 x NB, mma C layout) for the warp's 16 rows of `a` and rows
// [0, NB) of `bt`, both [rows][LD] f32 tiles in shared memory, over DP
// columns in 3xTF32: each k8 step splits its A fragment once and each B
// fragment as it is read. At DP > 128 the k8 loop unrolls by 4 only (the
// instruction cache: the file header).
template <int DP, int NB, int LD = DP + 4>
__device__ __forceinline__ void abt_tf32x3(float (&acc)[NB / 8][4], const float* a, const float* bt) {
  constexpr int UNROLL = DP > 128 ? 4 : DP / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* ar = a + g * LD + t;
  const float* br = bt + g * LD + t;
#pragma unroll
  for (int n = 0; n < NB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll(UNROLL)
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(ar[kk * 8], ab[0], as[0]);               // row g, column t
    split_tf32(ar[8 * LD + kk * 8], ab[1], as[1]);      // row g + 8, column t
    split_tf32(ar[kk * 8 + 4], ab[2], as[2]);           // row g, column t + 4
    split_tf32(ar[8 * LD + kk * 8 + 4], ab[3], as[3]);  // row g + 8, column t + 4
#pragma unroll
    for (int n = 0; n < NB / 8; ++n) {
      uint32_t bb[2], bs[2];
      split_tf32(br[n * 8 * LD + kk * 8], bb[0], bs[0]);      // B row 8n + g, column t
      split_tf32(br[n * 8 * LD + kk * 8 + 4], bb[1], bs[1]);  // column t + 4
      mma_tf32x3(acc[n], ab, as, bb, bs);
    }
  }
}

// acc (16 x DN) += P M in 3xTF32: P as KS k8 steps of C fragments (n8 tile kk
// of a score tile: rows g, g + 8, keys 8kk + 2t, 8kk + 2t + 1), M the rows
// [0, 8 KS) and columns [0, DN) of a [rows][LD] f32 tile. The reduction
// index is permuted within each step (k = t is key 2t, k = t + 4 key
// 2t + 1), so the A fragment is {c0, c2, c1, c3} and M's B fragment reads
// rows 2t and 2t + 1.
template <int DN, int KS, int LD>
__device__ __forceinline__ void pm_tf32x3(float (&acc)[DN / 8][4], const float (&p)[KS][4], const float* m) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* mr = m + 2 * t * LD + g;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(p[kk][0], ab[0], as[0]);  // row g, key 2t
    split_tf32(p[kk][2], ab[1], as[1]);  // row g + 8, key 2t
    split_tf32(p[kk][1], ab[2], as[2]);  // row g, key 2t + 1
    split_tf32(p[kk][3], ab[3], as[3]);  // row g + 8, key 2t + 1
    const float* mk = mr + kk * 8 * LD;
#pragma unroll
    for (int n = 0; n < DN / 8; ++n) {
      uint32_t bb[2], bs[2];
      split_tf32(mk[n * 8], bb[0], bs[0]);       // M row 8kk + 2t, column 8n + g
      split_tf32(mk[LD + n * 8], bb[1], bs[1]);  // row 8kk + 2t + 1
      mma_tf32x3(acc[n], ab, as, bb, bs);
    }
  }
}

// With two warp groups (warps w and w + 4 share 16 rows, each having reduced
// half of DP into s and dp): each adds the other's partial C fragments,
// passed through `xs` (2 x NB / 2 floats a thread); the sum commutes, so the
// two hold the same bits. The caller's next __syncthreads frees `xs`.
template <int NB>
__device__ __forceinline__ void add_partner_half(float (&s)[NB / 8][4], float (&dp)[NB / 8][4], float* xs) {
  constexpr int F = NB / 2;  // floats of s (and of dp) a thread
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* mine = xs + warp * 2 * F * 32 + lane;
  const float* theirs = xs + (warp ^ 4) * 2 * F * 32 + lane;
#pragma unroll
  for (int n = 0; n < NB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mine[(n * 4 + e) * 32] = s[n][e];
      mine[(F + n * 4 + e) * 32] = dp[n][e];
    }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] += theirs[(n * 4 + e) * 32];
      dp[n][e] += theirs[(F + n * 4 + e) * 32];
    }
}

// The float32 forward, one pass over KB-key tiles of K, V and the mask:
// each row's running max m and sum l of exp(s - m), the output rescaled by
// exp(m_old - m_new) at each tile and divided by l at the end.
template <int DP>
__global__ void __launch_bounds__(MNT) attn_fwd_tf32x3_kernel(Args<float> a, int flags) {
  constexpr int LD = DP + 4, KB = tf32_fwd_keys(DP), LDM = tf32_mask_ld(KB), NBUF = tf32_fwd_bufs(DP);
  extern __shared__ __align__(16) unsigned char smem_mma[];
  float* qs = reinterpret_cast<float*>(smem_mma);  // [MQ][LD]
  float* ks = qs + MQ * LD;                        // [NBUF][KB][LD]
  float* vs = ks + NBUF * KB * LD;                 // [NBUF][KB][LD]
  unsigned char* ms = reinterpret_cast<unsigned char*>(vs + NBUF * KB * LD);  // [NBUF][MQ][LDM]
  const int T_ = a.Tn, D = a.D;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H, i0 = blockIdx.y * MQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, qd = lane & 3;
  const int nkt = (T_ + KB - 1) / KB;
  const bool vec = flags & VEC_QKV;

  // Stage t: K, V and mask tile t.
  auto issue = [&](int t) {
    if (t < nkt) {
      const int buf = t % NBUF, j0 = t * KB;
      load_rows<DP, KB>(ks + buf * KB * LD, a.k, b, h, j0, T_, D, vec);
      load_rows<DP, KB>(vs + buf * KB * LD, a.v, b, h, j0, T_, D, vec);
      if (a.mask) load_mask<LDM, KB>(ms + buf * MQ * LDM, a.mask, bh, i0, j0, T_, flags & VEC_MASK);
    }
    cp_async_commit();
  };
  auto arrive = [&](int t) {  // prefetch stage t + NBUF - 1, then wait for stage t (and Q)
    issue(t + NBUF - 1);
    cp_async_wait<NBUF - 1>();
    __syncthreads();
  };

  load_rows<DP, MQ>(qs, a.q, b, h, i0, T_, D, vec);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NBUF - 1; ++t) issue(t);
  const float* qw = qs + warp * 16 * LD;
  const int mrow = (warp * 16 + g) * LDM + 2 * qd;
  float mx[2], l[2] = {0.f, 0.f}, o[DP / 8][4];
  mx[0] = mx[1] = -__int_as_float(0x7f800000);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int t = 0; t < nkt; ++t) {
    arrive(t);
    const int buf = t % NBUF;
    float s[KB / 8][4];
    abt_tf32x3<DP, KB>(s, qw, ks + buf * KB * LD);
    finish_scores<KB>(s, t * KB, T_, a.scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = s[0][2 * r];
#pragma unroll
      for (int n = 0; n < KB / 8; ++n) m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      m = fmaxf(mx[r], quad_max(m));
      const float ml = m * LOG2E, corr = exp_shifted(mx[r], ml);  // the first tile: exp(-inf) = 0
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < KB / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = exp_shifted(s[n][2 * r + c], ml);
          s[n][2 * r + c] = e;
          sum += e;
        }
      l[r] = l[r] * corr + sum;
      mx[r] = m;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }
    if (a.mask) apply_mask<KB, LDM>(s, ms + buf * MQ * LDM + mrow, a.inv_keep);
    pm_tf32x3<DP, KB / 8, LD>(o, s, vs + buf * KB * LD);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv_l = 1.f / quad_sum(l[r]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[n][2 * r] *= inv_l;
      o[n][2 * r + 1] *= inv_l;
    }
  }
  store_acc<DP>(a.o, o, b, h, i0 + warp * 16, T_, D, flags & VEC_OUT);
}

// Launch 1 of the float32 backward: `attn_bwd_dq_mma_kernel`'s two passes
// over KB-key tiles in 3xTF32, the warp's Q and dO rows read from shared
// memory per product. With G = 2 warp groups (DP = 256) warps w and w + 4
// share 16 query rows: each reduces half of DP for s and dp, adds the
// other's partials, and accumulates its half of dq.
template <int DP>
__global__ void __launch_bounds__(MNT * tf32_bwd_groups(DP)) attn_bwd_dq_tf32x3_kernel(Args<float> a, int flags) {
  constexpr int G = tf32_bwd_groups(DP), NT = MNT * G, DG = DP / G;  // DG: the group's columns
  constexpr int LD = DP + 4, KB = tf32_bwd_tile(DP), LDM = tf32_mask_ld(KB);
  extern __shared__ __align__(16) unsigned char smem_mma[];
  float* qs = reinterpret_cast<float*>(smem_mma);  // [MQ][LD]
  float* dos = qs + MQ * LD;                       // [MQ][LD]
  float* ks = dos + MQ * LD;                       // [NS][KB][LD]
  float* vs = ks + NS * KB * LD;                   // [NS][KB][LD]
  float* xs = vs + NS * KB * LD;                   // G = 2: [8 warps][KB][32] partial s and dp
  unsigned char* ms = reinterpret_cast<unsigned char*>(xs + (G > 1 ? 8 * KB * 32 : 0));  // [NS][MQ][LDM]
  const int T_ = a.Tn, D = a.D;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H, i0 = blockIdx.y * MQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, qd = lane & 3;
  const int wr = warp % 4, c0 = warp / 4 * DG;  // the warp's 16 rows, its group's first column
  const int nkt = (T_ + KB - 1) / KB, stages = 2 * nkt;
  const bool vec = flags & VEC_QKV;

  // Stage t: K, V and mask tile t % nkt (pass 1 for t < nkt, then pass 2).
  auto issue = [&](int t) {
    if (t < stages) {
      const int buf = t % NS, j0 = (t % nkt) * KB;
      load_rows<DP, KB, NT>(ks + buf * KB * LD, a.k, b, h, j0, T_, D, vec);
      load_rows<DP, KB, NT>(vs + buf * KB * LD, a.v, b, h, j0, T_, D, vec);
      if (a.mask) load_mask<LDM, KB, MQ, NT>(ms + buf * MQ * LDM, a.mask, bh, i0, j0, T_, flags & VEC_MASK);
    }
    cp_async_commit();
  };
  auto arrive = [&](int t) {
    issue(t + NS - 1);
    cp_async_wait<NS - 1>();
    __syncthreads();
  };
  // s and dp of the warp's rows against key tile `buf` (keys from j0): the
  // score scaled, keys past T at -inf, dp masked.
  auto scores = [&](float (&s)[KB / 8][4], float (&dp)[KB / 8][4], int buf, int j0) {
    abt_tf32x3<DG, KB, LD>(s, qs + wr * 16 * LD + c0, ks + buf * KB * LD + c0);
    abt_tf32x3<DG, KB, LD>(dp, dos + wr * 16 * LD + c0, vs + buf * KB * LD + c0);
    if constexpr (G > 1) add_partner_half<KB>(s, dp, xs);
    finish_scores<KB>(s, j0, T_, a.scale);
    if (a.mask) apply_mask<KB, LDM>(dp, ms + buf * MQ * LDM + (wr * 16 + g) * LDM + 2 * qd, a.inv_keep);
  };

  load_rows<DP, MQ, NT>(qs, a.q, b, h, i0, T_, D, vec);
  load_rows<DP, MQ, NT>(dos, a.dout, b, h, i0, T_, D, vec);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) issue(t);
  float mx[2], l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  mx[0] = mx[1] = -__int_as_float(0x7f800000);

  // Pass 1: online max, sum and dp-weighted sum of exp(s - max).
  for (int t = 0; t < nkt; ++t) {
    arrive(t);
    float s[KB / 8][4], dp[KB / 8][4];
    scores(s, dp, t % NS, t * KB);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = s[0][2 * r];
#pragma unroll
      for (int n = 0; n < KB / 8; ++n) m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      m = fmaxf(mx[r], quad_max(m));
      const float ml = m * LOG2E;
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int n = 0; n < KB / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = exp_shifted(s[n][2 * r + c], ml);
          sum += e;
          dsum = fmaf(dp[n][2 * r + c], e, dsum);
        }
      const float corr = exp_shifted(mx[r], ml);  // the first tile: exp(-inf) = 0
      l[r] = l[r] * corr + sum;
      dl[r] = dl[r] * corr + dsum;
      mx[r] = m;
    }
    __syncthreads();
  }
  float mxl[2], inv_l[2], delta[2];
  const size_t N = (size_t)a.B * a.H * T_;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    inv_l[r] = 1.f / lsum;
    mxl[r] = mx[r] * LOG2E;
    delta[r] = quad_sum(dl[r]) / lsum;
    const int i = i0 + wr * 16 + g + 8 * r;
    if (qd == 0 && c0 == 0 && i < T_) {
      const size_t row = (size_t)bh * T_ + i;
      a.stats[row] = mxl[r];
      a.stats[N + row] = inv_l[r];
      a.stats[2 * N + row] = delta[r];
    }
  }

  // Pass 2: ds = p (dp - delta) scale in the C fragments, times K.
  float dq[DG / 8][4];
#pragma unroll
  for (int n = 0; n < DG / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  for (int t = nkt; t < stages; ++t) {
    arrive(t);
    const int buf = t % NS;
    float s[KB / 8][4], dp[KB / 8][4];
    scores(s, dp, buf, (t - nkt) * KB);
#pragma unroll
    for (int n = 0; n < KB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = __fmul_rn(exp_shifted(s[n][e], mxl[r]), inv_l[r]);
        s[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][e], delta[r])), a.scale);
      }
    pm_tf32x3<DG, KB / 8, LD>(dq, s, ks + buf * KB * LD + c0);
    __syncthreads();
  }
  View<float> dqo = a.dq;  // the group's columns [c0, c0 + DG)
  dqo.p += c0;
  store_acc<DG>(dqo, dq, b, h, i0 + wr * 16, T_, D - c0, flags & VEC_OUT);
}

// Launch 2 of the float32 backward, per 64 keys (16 a warp), over QB-query
// tiles: `attn_bwd_dkdv_mma_kernel`'s products in 3xTF32, the warp's K and
// V rows read from shared memory per product. With G = 2 warp groups
// (DP = 256) warps w and w + 4 share 16 keys: each reduces half of DP for
// s^T and dp^T, adds the other's partials, and accumulates its half of dk
// and dv (where the bf16 wide kernel splits D over the grid and computes
// s^T and dp^T in both halves).
template <int DP>
__global__ void __launch_bounds__(MNT * tf32_bwd_groups(DP)) attn_bwd_dkdv_tf32x3_kernel(Args<float> a, int flags) {
  constexpr int G = tf32_bwd_groups(DP), NT = MNT * G, DG = DP / G;  // DG: the group's columns
  constexpr int LD = DP + 4, QB = tf32_bwd_tile(DP);
  extern __shared__ __align__(16) unsigned char smem_mma[];
  float* ks = reinterpret_cast<float*>(smem_mma);  // [MK][LD]
  float* vs = ks + MK * LD;                        // [MK][LD]
  float* qs = vs + MK * LD;                        // [NS][QB][LD]
  float* dos = qs + NS * QB * LD;                  // [NS][QB][LD]
  float* sts = dos + NS * QB * LD;                 // [NS][3][QB]
  float* xs = sts + NS * 3 * QB;                   // G = 2: [8 warps][QB][32] partial s^T and dp^T
  unsigned char* ms = reinterpret_cast<unsigned char*>(xs + (G > 1 ? 8 * QB * 32 : 0));  // [NS][QB][MASK_LDB]
  const int T_ = a.Tn, D = a.D;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H, j0 = blockIdx.y * MK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, qd = lane & 3;
  const int wr = warp % 4, c0 = warp / 4 * DG;  // the warp's 16 keys, its group's first column
  const int nqt = (T_ + QB - 1) / QB;
  const size_t N = (size_t)a.B * a.H * T_;
  const bool vec = flags & VEC_QKV;

  // Stage t: Q, dO, statistics and mask of query tile t.
  auto issue = [&](int t) {
    if (t < nqt) {
      const int buf = t % NS, i0 = t * QB;
      load_rows<DP, QB, NT>(qs + buf * QB * LD, a.q, b, h, i0, T_, D, vec);
      load_rows<DP, QB, NT>(dos + buf * QB * LD, a.dout, b, h, i0, T_, D, vec);
      load_stats<QB>(sts + buf * 3 * QB, a.stats, N, (size_t)bh * T_ + i0, T_ - i0);
      if (a.mask)
        load_mask<MASK_LDB, MK, QB, NT>(ms + buf * QB * MASK_LDB, a.mask, bh, i0, j0, T_, flags & VEC_MASK);
    }
    cp_async_commit();
  };
  auto arrive = [&](int t) {
    issue(t + NS - 1);
    cp_async_wait<NS - 1>();
    __syncthreads();
  };

  load_rows<DP, MK, NT>(ks, a.k, b, h, j0, T_, D, vec);
  load_rows<DP, MK, NT>(vs, a.v, b, h, j0, T_, D, vec);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) issue(t);
  const float* kr = ks + wr * 16 * LD;
  const float* vr = vs + wr * 16 * LD;
  const int mcol = wr * 16 + g;  // the thread's key column in the mask tile (and + 8)
  float dk[DG / 8][4], dv[DG / 8][4];
#pragma unroll
  for (int n = 0; n < DG / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int t = 0; t < nqt; ++t) {
    arrive(t);
    const int buf = t % NS;
    const float* qt = qs + buf * QB * LD;
    const float* dot = dos + buf * QB * LD;
    const float* st = sts + buf * 3 * QB;
    const unsigned char* mt = ms + buf * QB * MASK_LDB;
    float s[QB / 8][4], dp[QB / 8][4];  // rows: keys g, g + 8; columns: queries
    abt_tf32x3<DG, QB, LD>(s, kr + c0, qt + c0);
    abt_tf32x3<DG, QB, LD>(dp, vr + c0, dot + c0);
    if constexpr (G > 1) add_partner_half<QB>(s, dp, xs);
#pragma unroll
    for (int n = 0; n < QB / 8; ++n) {
      const int c = n * 8 + 2 * qd;  // the query of e = 0, 2; c + 1 for e = 1, 3
      const float2 ml = *reinterpret_cast<const float2*>(st + c);
      const float2 il = *reinterpret_cast<const float2*>(st + QB + c);
      const float2 de = *reinterpret_cast<const float2*>(st + 2 * QB + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 1;
        const float p = __fmul_rn(exp_shifted(__fmul_rn(s[n][e], a.scale), hi ? ml.y : ml.x), hi ? il.y : il.x);
        float pd = p, d = dp[n][e];
        if (a.mask) {
          const float km = mt[(c + hi) * MASK_LDB + mcol + 8 * (e >> 1)] ? a.inv_keep : 0.f;  // as `apply_mask`
          pd = __fmul_rn(p, km);
          d = __fmul_rn(d, km);
        }
        s[n][e] = pd;
        dp[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(d, hi ? de.y : de.x)), a.scale);
      }
    }
    pm_tf32x3<DG, QB / 8, LD>(dv, s, dot + c0);
    pm_tf32x3<DG, QB / 8, LD>(dk, dp, qt + c0);
    __syncthreads();
  }
  View<float> dko = a.dk, dvo = a.dv;  // the group's columns [c0, c0 + DG)
  dko.p += c0;
  dvo.p += c0;
  const bool vout = flags & VEC_OUT;
  store_acc<DG>(dko, dk, b, h, j0 + wr * 16, T_, D - c0, vout);
  store_acc<DG>(dvo, dv, b, h, j0 + wr * 16, T_, D - c0, vout);
}

bool is_aligned(const void* p, unsigned bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename U>
bool rows_aligned(const View<U>& m, unsigned bytes) {
  const long long e = bytes / sizeof(U);
  return is_aligned(m.p, bytes) && m.sb % e == 0 && m.sh % e == 0 && m.st % e == 0;
}

// The VEC_* flags of a call: q, k, v (and dO) rows by 16 bytes, mask rows by
// 8 (T % 8 == 0: every row 8-byte aligned), outputs by column pairs.
template <typename T>
int mma_flags(const Args<T>& a, bool backward) {
  constexpr unsigned pair = 2 * sizeof(T);
  int flags = 0;
  if (a.D % (16 / sizeof(T)) == 0 && rows_aligned(a.q, 16) && rows_aligned(a.k, 16) && rows_aligned(a.v, 16) &&
      (!backward || rows_aligned(a.dout, 16)))
    flags |= VEC_QKV;
  if (a.mask && is_aligned(a.mask, 8)) flags |= VEC_MASK;
  if (a.D % 2 == 0 && (backward ? rows_aligned(a.dq, pair) && rows_aligned(a.dk, pair) && rows_aligned(a.dv, pair)
                                : rows_aligned(a.o, pair)))
    flags |= VEC_OUT;
  return flags;
}

constexpr int MAX_DEVICES = 64;

// Launches a tensor-core kernel with `smem` bytes of dynamic shared memory.
// Its limit, and the carveout at the most shared memory (two blocks of the
// bf16 kernels on an SM at DP = 128), are set once per device and the
// largest `smem` seen: no driver call on the launches after.
template <auto Kernel, typename T>
cudaError_t launch_mma(dim3 grid, size_t smem, const Args<T>& a, int flags, cudaStream_t s, int threads = MNT) {
  static std::atomic<size_t> smem_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || smem_set[dev].load() < smem) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(Kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) smem_set[dev].store(smem);
  }
  Kernel<<<grid, threads, smem, s>>>(a, flags);
  return cudaGetLastError();
}

template <int DP>
cudaError_t fwd_mma(const Args<bf16>& a, cudaStream_t s) {
  const size_t smem =
      sizeof(bf16) * (size_t)(MQ + 2 * NS * MK) * (DP + 8) + (a.mask ? NS * MQ * MASK_LD : 0);
  return launch_mma<attn_fwd_mma_kernel<DP>>(dim3(a.B * a.H, (a.Tn + MQ - 1) / MQ), smem, a,
                                             mma_flags(a, false), s);
}

template <int DP>
cudaError_t bwd_mma(const Args<bf16>& a, cudaStream_t s) {
  const size_t tiles = sizeof(bf16) * (size_t)(2 * MQ + 2 * NS * MK) * (DP + 8);
  const size_t masks = a.mask ? NS * MQ * MASK_LDB : 0;
  const int flags = mma_flags(a, true);
  const dim3 grid(a.B * a.H, (a.Tn + MQ - 1) / MQ);  // MQ = MK: query tiles, then key tiles
  const cudaError_t err = launch_mma<attn_bwd_dq_mma_kernel<DP>>(grid, tiles + masks, a, flags, s);
  if (err != cudaSuccess) return err;
  return launch_mma<attn_bwd_dkdv_mma_kernel<DP>>(grid, tiles + masks + sizeof(float) * NS * 3 * MQ, a,
                                                  flags, s);
}

template <>
cudaError_t fwd_mma<DW>(const Args<bf16>& a, cudaStream_t s) {
  const size_t smem =
      sizeof(bf16) * (size_t)(MQ + 2 * NS * MKW) * (DW + 8) + (a.mask ? NS * MQ * MASK_LDW : 0);
  return launch_mma<attn_fwd_mma_wide_kernel>(dim3(a.B * a.H, (a.Tn + MQ - 1) / MQ), smem, a,
                                              mma_flags(a, false), s);
}

template <>
cudaError_t bwd_mma<DW>(const Args<bf16>& a, cudaStream_t s) {
  constexpr size_t row = sizeof(bf16) * (DW + 8);
  const int flags = mma_flags(a, true), nt = (a.Tn + MQ - 1) / MQ;  // MQ = MK
  const size_t smem1 = row * (2 * MQ + 2 * NS * MKW) + (a.mask ? NS * MQ * MASK_LDW : 0);
  const cudaError_t err = launch_mma<attn_bwd_dq_mma_wide_kernel>(dim3(a.B * a.H, nt), smem1, a, flags, s);
  if (err != cudaSuccess) return err;
  const size_t smem2 =
      row * (2 * MK + 2 * NS * MQ) + sizeof(float) * NS * 3 * MQ + (a.mask ? NS * MQ * MASK_LDB : 0);
  return launch_mma<attn_bwd_dkdv_mma_wide_kernel>(dim3(a.B * a.H, nt, DW / DH), smem2, a, flags, s);
}

template <int DP>
cudaError_t fwd_tf32(const Args<float>& a, cudaStream_t s) {
  constexpr int KB = tf32_fwd_keys(DP), NBUF = tf32_fwd_bufs(DP);
  const size_t smem =
      sizeof(float) * (size_t)(MQ + 2 * NBUF * KB) * (DP + 4) + (a.mask ? NBUF * MQ * tf32_mask_ld(KB) : 0);
  return launch_mma<attn_fwd_tf32x3_kernel<DP>>(dim3(a.B * a.H, (a.Tn + MQ - 1) / MQ), smem, a,
                                                mma_flags(a, false), s);
}

template <int DP>
cudaError_t bwd_tf32(const Args<float>& a, cudaStream_t s) {
  constexpr int TB = tf32_bwd_tile(DP), G = tf32_bwd_groups(DP);
  constexpr size_t row = sizeof(float) * (DP + 4), xs = G > 1 ? sizeof(float) * 8 * TB * 32 : 0;
  const int flags = mma_flags(a, true), nt = (a.Tn + MQ - 1) / MQ;  // MQ = MK: query tiles, then key tiles
  const dim3 grid(a.B * a.H, nt);
  const size_t smem1 = row * (2 * MQ + 2 * NS * TB) + xs + (a.mask ? NS * MQ * tf32_mask_ld(TB) : 0);
  const cudaError_t err = launch_mma<attn_bwd_dq_tf32x3_kernel<DP>>(grid, smem1, a, flags, s, MNT * G);
  if (err != cudaSuccess) return err;
  const size_t smem2 =
      row * (2 * MK + 2 * NS * TB) + sizeof(float) * NS * 3 * TB + xs + (a.mask ? NS * TB * MASK_LDB : 0);
  return launch_mma<attn_bwd_dkdv_tf32x3_kernel<DP>>(grid, smem2, a, flags, s, MNT * G);
}

// Every forward and backward runs on the tensor cores, DP columns a tile:
// bf16 in bf16 products (DP = 256: the wide kernels), float32 in 3xTF32.
template <int N>
using Int = std::integral_constant<int, N>;

template <typename T>
cudaError_t dispatch(const Args<T>& a, bool backward, cudaStream_t s) {
  const auto mma = [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    if constexpr (std::is_same<T, bf16>::value) {
      return backward ? bwd_mma<DP>(a, s) : fwd_mma<DP>(a, s);
    } else {
      return backward ? bwd_tf32<DP>(a, s) : fwd_tf32<DP>(a, s);
    }
  };
  if (a.D <= 16) return mma(Int<16>());
  if (a.D <= 32) return mma(Int<32>());
  if (a.D <= 64) return mma(Int<64>());
  if (a.D <= 128) return mma(Int<128>());
  if (a.D <= 256) return mma(Int<256>());
  return cudaErrorInvalidValue;  // past the gate (the wrapper raises first)
}

template <typename U>
View<U> view(const void* p, const long long* s) {
  return View<U>{static_cast<U*>(const_cast<void*>(p)), s[0], s[1], s[2]};
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const void* mask, const void* dout,
                void* o, void* dq, void* dk, void* dv, void* stats, const long long* st, int B,
                int H, int T_, int D, float scale, float inv_keep, bool backward, cudaStream_t s) {
  Args<T> a;
  const long long zero[3] = {0, 0, 0};
  a.q = view<const T>(q, st);
  a.k = view<const T>(k, st + 3);
  a.v = view<const T>(v, st + 6);
  // forward strides: q, k, v, o; backward: q, k, v, dO, dq, dk, dv
  a.dout = view<const T>(dout, backward ? st + 9 : zero);
  a.o = view<T>(o, backward ? zero : st + 9);
  a.dq = view<T>(dq, backward ? st + 12 : zero);
  a.dk = view<T>(dk, backward ? st + 15 : zero);
  a.dv = view<T>(dv, backward ? st + 18 : zero);
  a.mask = static_cast<const unsigned char*>(mask);
  a.stats = static_cast<float*>(stats);
  a.B = B; a.H = H; a.Tn = T_; a.D = D;
  a.scale = scale;
  a.inv_keep = inv_keep;
  return dispatch<T>(a, backward, s);
}

}  // namespace

// q, k, v: (B, H, T, D) with element strides st[0..8] (batch, head, token;
// the last dim contiguous); o: strides st[9..11]; mask: contiguous (B, H, T, T)
// uint8 or null. Returns a cudaError_t.
extern "C" int ddt_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                 void* o, const long long* st, int B, int H, int T, int D,
                                 int is_bf16, float scale, float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run<__nv_bfloat16>(q, k, v, mask, nullptr, o, nullptr, nullptr, nullptr, nullptr,
                                   st, B, H, T, D, scale, inv_keep, false, s);
  return (int)run<float>(q, k, v, mask, nullptr, o, nullptr, nullptr, nullptr, nullptr, st, B, H,
                         T, D, scale, inv_keep, false, s);
}

// As above, plus dO (st[9..11]) and the gradients dq, dk, dv (st[12..20]);
// stats: (3, B*H*T) f32 scratch. Two launches on the stream.
extern "C" int ddt_attention_bwd(const void* q, const void* k, const void* v, const void* mask,
                                 const void* dout, void* dq, void* dk, void* dv, void* stats,
                                 const long long* st, int B, int H, int T, int D, int is_bf16,
                                 float scale, float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run<__nv_bfloat16>(q, k, v, mask, dout, nullptr, dq, dk, dv, stats, st, B, H, T,
                                   D, scale, inv_keep, true, s);
  return (int)run<float>(q, k, v, mask, dout, nullptr, dq, dk, dv, stats, st, B, H, T, D, scale,
                         inv_keep, true, s);
}
