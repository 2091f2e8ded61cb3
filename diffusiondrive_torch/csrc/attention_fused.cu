// Fused self-attention of the GPT fusion blocks, forward and backward:
// softmax(q k^T / sqrt(D)) in f32 -> optional uint8 keep mask (kept
// probabilities times 1/(1-p)) -> rounded to the input dtype -> . v.
//
// Replaces the TPU kernels `diffusiondrive_tpu/ops/attention_fused.py:
// _fwd_kernel` (:78, pallas_call in `_fwd_pallas` :140) and `_bwd_kernel`
// (:92, pallas_call in `_bwd_pallas` :160): 8 forwards and 8 backwards per
// train step with `fused_attention_mode="on"` (4 fusion stages x 2 blocks,
// B x 4 heads, T = 320 tokens, D = 16, 32, 64, 128).
//
// What bounds it on an H100 SXM: at B=64, H=4, T=320, D=128 in bf16 the
// forward does 4*B*H*T^2*D = 13.4 GFLOP (13.6 us at 989 TFLOP/s) and moves
// q, k, v, o = 84 MB plus a 26 MB mask (33 us at 3.35 TB/s): memory sets
// the bound (about 120 flop/B against the ~295 the card needs before
// compute binds); at D=16 the mask is 3/4 of the bytes. The backward does
// 2.5x the forward's flops over 1.75x its bytes, also memory-bound.
//
// Two forward kernels:
// - bf16 with D <= 128 (every fusion stage): `attn_fwd_mma_kernel`, on the
//   tensor cores. Multiplying on the CUDA cores in f32 (the kernel below)
//   ran 82x the bound at D=128: q.k^T issued 5 shared loads per 4 FMAs and
//   p.v left lanes idle at D <= 32. Here q.k^T and p.v are
//   mma.sync.m16n8k16 bf16 products with f32 accumulation. A block owns
//   one (batch, head) and 64 query rows, 16 per warp, held as A fragments
//   (D zero-padded to DP = 16, 32, 64 or 128). K (pass 1) and K, V and the
//   mask (pass 2) stream through shared memory in 64-key tiles, double
//   buffered with cp.async, and reach the products by ldmatrix (.trans for
//   V). Pass 1 keeps each row's running max and sum in f32 (quad
//   shuffles); pass 2 recomputes the scores bit for bit and forms the
//   normalised, masked, bf16-rounded p straight from the accumulators (the
//   C layout of two n8 tiles is the A layout of one k16 step). Each score
//   is exponentiated in both passes, so exp is one FMA and the SFU's ex2
//   (expf's eight instructions a score set the time at small D). Two passes,
//   not an online rescale of the output: the JAX kernel rounds the
//   normalised p, and the recomputed q.k^T costs flops where bytes bind
//   (K and V of one head, <= 80 KB each at T = 320, come back from L2).
// - float32, and bf16 with 128 < D <= 256 (no fusion stage): the CUDA-core
//   kernel `attn_fwd_kernel`, f32 FMAs, 16 query rows per block with their
//   scores in shared memory. TF32 products would break float32's 1e-4
//   limit against the plain version.
//
// Two backward designs, each two launches with the per-row statistics in
// a (3, B*H*T) f32 scratch between them; dq is owned by query tiles, dk and
// dv by key tiles, so no atomics and the same bits in every run:
// - bf16 with D <= 128: `attn_bwd_dq_mma_kernel` then
//   `attn_bwd_dkdv_mma_kernel`, the forward's tensor-core machinery
//   (ldmatrix, mma.sync, C fragments repacked as A fragments, cp.async
//   tiles). The CUDA-core backward below ran 146x its bound summed over the
//   fusion stages, slower than its own plain version. JAX's rounding points
//   hold: p and dp = dO V^T in f32, delta = sum_j dp p with the unmasked
//   p, pd and ds rounded to bf16 before their products (never
//   FlashAttention's delta = rowsum(dO * O): the output is not kept, and
//   its rounding would move ds). Launch 1 (64 query rows a block): pass 1
//   over K, V and mask tiles keeps each row's max, sum and dp-weighted sum
//   online; pass 2 recomputes s and dp and accumulates dq = ds K. Launch 2
//   (64 keys a block): over query tiles, s^T = K Q^T and dp^T = V dO^T with
//   the keys as rows, so pd^T and ds^T leave the C fragments as the A
//   fragments of dv += pd^T dO and dk += ds^T Q; p^T from launch 1's
//   statistics and the same exp. Ten tile products a score, against the
//   forward's three; merging launch 1's passes would hold p and dp for the
//   block in shared memory (160 KB at T = 320, too much at T = 512).
// - float32, and bf16 with 128 < D <= 256: the CUDA-core kernels below.
//
// Design of the CUDA-core kernels: the TPU kernel held all heads of a
// batch row with whole (T, T) f32 tiles in VMEM; a (320, 320) f32 score
// matrix is 400 KB, above the 227 KB of shared memory a block may use, so
// here a block owns one (batch, head) and a tile of query rows (forward and
// dq pass) or key rows (dk/dv pass) and streams the other operand through
// shared memory in tiles.
// - forward: 16 query rows per block. Their scores against all T keys stay
//   in shared memory (16 x T f32, <= 32 KB), get the exact two-pass row
//   softmax, the mask and the rounding, and multiply V in 32-row tiles.
// - backward, pass 1 (query tiles): recomputes p, computes dp = dO V^T and
//   the row sums sum_j dp p, writes each row's max, sum and sum_j dp p to a
//   (3, B*H*T) f32 scratch, and computes dq = ds K.
// - backward, pass 2 (16 key rows per block): recomputes p for one 16 x 16
//   block at a time from the saved row statistics, bit for bit as pass 1
//   did (the same ordered FMA chains, every other product and difference
//   rounded on its own, never contracted), and accumulates dk = ds^T Q and
//   dv = p^T dO over all query tiles in registers. No atomics: the results
//   are deterministic.
// Operands are read through (batch, head, token) strides with a contiguous
// last dimension, so q, k, v and dO come straight from the (B, T, H, D)
// Linear outputs; each lane owns columns lane + 32c of D. Every kernel
// launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using ddt::from_f;
using ddt::to_f;

constexpr int QT = 16;         // query rows per block (forward, pass 1)
constexpr int KT = 32;         // key rows per streamed tile (forward, pass 1)
constexpr int NT = 128;        // 4 warps
constexpr int RPW = QT / 4;    // query rows per warp
constexpr int KT2 = 16;        // key rows per block (pass 2)
constexpr int QT2 = 16;        // query rows per streamed tile (pass 2)
constexpr int NT2 = QT2 * KT2; // 8 warps: one (query, key) entry per thread
constexpr int RPW2 = KT2 / 8;  // key rows per warp

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

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [r0, r0 + n) of one head's (T, D) matrix into dst[ROWS][ld] as f32;
// rows n..ROWS-1 become zero.
template <typename T, int ROWS, int THREADS>
__device__ void load_tile(float* dst, int ld, const View<const T>& m, int b, int h, int r0, int n,
                          int D) {
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int r = e / D, d = e - r * D;
    dst[r * ld + d] = r < n ? to_f(m.row(b, h, r0 + r)[d]) : 0.f;
  }
}

// out[i][j] = (sum_d a[i][d] * M[j][d]) * scale for the QT rows of `a` and
// all T rows of M, one KT-row tile of M at a time through `ts`. Lane j of
// warp w computes rows w, w+4, w+8, w+12; the sum runs over d in order.
template <typename T>
__device__ void row_products(float* out, const float* a, float* ts, const View<const T>& m, int b,
                             int h, int T_, int D, int ld, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j0 = 0; j0 < T_; j0 += KT) {
    const int nk = min(KT, T_ - j0);
    __syncthreads();  // the previous tile is consumed, `a` is loaded
    load_tile<T, KT, NT>(ts, ld, m, b, h, j0, nk, D);
    __syncthreads();
    if (lane < nk) {
      float acc[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) acc[r] = 0.f;
      const float* mr = ts + lane * ld;
      for (int d = 0; d < D; ++d) {
        const float x = mr[d];
#pragma unroll
        for (int r = 0; r < RPW; ++r) acc[r] = fmaf(a[(warp + 4 * r) * ld + d], x, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) out[(warp + 4 * r) * T_ + j0 + lane] = __fmul_rn(acc[r], scale);
    }
  }
  __syncthreads();
}

// acc[r][c] = sum_j P[w + 4r][j] * M[j][lane + 32c] over all T rows of M,
// streamed through `ts` in KT-row tiles.
template <typename T, int DC>
__device__ void rows_times(float (&acc)[RPW][DC], const float* P, float* ts, const View<const T>& m,
                           int b, int h, int T_, int D, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  for (int j0 = 0; j0 < T_; j0 += KT) {
    const int nk = min(KT, T_ - j0);
    __syncthreads();
    load_tile<T, KT, NT>(ts, ld, m, b, h, j0, nk, D);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float* mr = ts + j * ld;
      float x[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        x[c] = d < D ? mr[d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pv = P[(warp + 4 * r) * T_ + j0 + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pv, x[c], acc[r][c]);
      }
    }
  }
}

template <typename T, int DC>
__device__ void store_rows(const View<T>& out, float (&acc)[RPW][DC], int b, int h, int i0,
                           int nq, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = warp + 4 * r;
    if (i >= nq) continue;
    T* o = out.row(b, h, i0 + i);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[d] = from_f<T>(acc[r][c]);
    }
  }
}

// Exact two-pass softmax of row i of `s` (in place: e = exp(s - max));
// returns (max, sum) for lane use. Warp-uniform.
__device__ __forceinline__ float2 row_softmax_stats(float* row, int T_) {
  const int lane = threadIdx.x & 31;
  float m = -__int_as_float(0x7f800000);
  for (int j = lane; j < T_; j += 32) m = fmaxf(m, row[j]);
  m = warp_max(m);
  float l = 0.f;
  for (int j = lane; j < T_; j += 32) {
    const float e = expf(__fsub_rn(row[j], m));
    row[j] = e;
    l += e;
  }
  return make_float2(m, warp_sum(l));
}

template <typename T, int DC>
__global__ void __launch_bounds__(NT) attn_fwd_kernel(Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int T_ = a.Tn, D = a.D, ld = D | 1;  // odd row stride: no bank conflicts
  float* qs = smem;                          // [QT][ld]
  float* ss = qs + QT * ld;                  // [QT][T]: scores, then probabilities
  float* ts = ss + QT * T_;                  // [KT][ld]: a K tile, then a V tile
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int i0 = blockIdx.y * QT, nq = min(QT, T_ - i0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_tile<T, QT, NT>(qs, ld, a.q, b, h, i0, nq, D);
  row_products<T>(ss, qs, ts, a.k, b, h, T_, D, ld, a.scale);

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = warp + 4 * r;
    if (i >= nq) continue;
    float* row = ss + i * T_;
    const float l = row_softmax_stats(row, T_).y;
    const unsigned char* keep = a.mask ? a.mask + ((size_t)bh * T_ + i0 + i) * T_ : nullptr;
    for (int j = lane; j < T_; j += 32) {
      float p = row[j] / l;
      if (keep) p = keep[j] ? __fmul_rn(p, a.inv_keep) : 0.f;
      row[j] = round_to<T>(p);
    }
  }

  float acc[RPW][DC];
  rows_times<T, DC>(acc, ss, ts, a.v, b, h, T_, D, ld);
  store_rows<T, DC>(a.o, acc, b, h, i0, nq, D);
}

// Pass 1 of the backward: per query tile, p, dp = dO V^T (masked),
// delta = sum_j dp * p, ds = p * (dp - delta) * scale rounded to T, the
// row statistics to `stats`, and dq = ds K.
template <typename T, int DC>
__global__ void __launch_bounds__(NT) attn_bwd_dq_kernel(Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int T_ = a.Tn, D = a.D, ld = D | 1;
  float* qs = smem;                 // [QT][ld]
  float* dos = qs + QT * ld;        // [QT][ld]
  float* ps = dos + QT * ld;        // [QT][T]: scores, then p
  float* ds = ps + QT * T_;         // [QT][T]: dO V^T, then ds
  float* ts = ds + QT * T_;         // [KT][ld]
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int i0 = blockIdx.y * QT, nq = min(QT, T_ - i0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t N = (size_t)a.B * a.H * T_;

  load_tile<T, QT, NT>(qs, ld, a.q, b, h, i0, nq, D);
  load_tile<T, QT, NT>(dos, ld, a.dout, b, h, i0, nq, D);
  row_products<T>(ps, qs, ts, a.k, b, h, T_, D, ld, a.scale);
  row_products<T>(ds, dos, ts, a.v, b, h, T_, D, ld, 1.f);

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = warp + 4 * r;
    if (i >= nq) continue;
    float* prow = ps + i * T_;
    float* drow = ds + i * T_;
    const float2 ml = row_softmax_stats(prow, T_);
    const size_t row = (size_t)bh * T_ + i0 + i;
    const unsigned char* keep = a.mask ? a.mask + row * T_ : nullptr;
    float delta = 0.f;
    for (int j = lane; j < T_; j += 32) {
      const float p = prow[j] / ml.y;
      float dp = drow[j];
      if (keep) dp = keep[j] ? __fmul_rn(dp, a.inv_keep) : 0.f;
      prow[j] = p;
      drow[j] = dp;
      delta = fmaf(dp, p, delta);
    }
    delta = warp_sum(delta);
    for (int j = lane; j < T_; j += 32)
      drow[j] = round_to<T>(__fmul_rn(__fmul_rn(prow[j], __fsub_rn(drow[j], delta)), a.scale));
    if (lane == 0) {
      a.stats[row] = ml.x;
      a.stats[N + row] = ml.y;
      a.stats[2 * N + row] = delta;
    }
  }

  float acc[RPW][DC];
  rows_times<T, DC>(acc, ds, ts, a.k, b, h, T_, D, ld);
  store_rows<T, DC>(a.dq, acc, b, h, i0, nq, D);
}

// Pass 2 of the backward: per tile of KT2 key rows, over all query tiles,
// dv = (masked p rounded)^T dO and dk = ds^T Q, p recomputed from pass 1's
// row statistics exactly as pass 1 computed it.
template <typename T, int DC>
__global__ void __launch_bounds__(NT2) attn_bwd_dkdv_kernel(Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int T_ = a.Tn, D = a.D, ld = D | 1;
  float* ks = smem;                 // [KT2][ld]
  float* vs = ks + KT2 * ld;        // [KT2][ld]
  float* qs = vs + KT2 * ld;        // [QT2][ld]
  float* dos = qs + QT2 * ld;       // [QT2][ld]
  float* pb = dos + QT2 * ld;       // [QT2][KT2]: masked p, rounded
  float* db = pb + QT2 * KT2;       // [QT2][KT2]: ds, rounded
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int j0 = blockIdx.y * KT2, nk = min(KT2, T_ - j0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ei = tid / KT2, ej = tid - ei * KT2;
  const size_t N = (size_t)a.B * a.H * T_;

  load_tile<T, KT2, NT2>(ks, ld, a.k, b, h, j0, nk, D);
  load_tile<T, KT2, NT2>(vs, ld, a.v, b, h, j0, nk, D);
  float dk[RPW2][DC], dv[RPW2][DC];
#pragma unroll
  for (int r = 0; r < RPW2; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int i0 = 0; i0 < T_; i0 += QT2) {
    const int nq = min(QT2, T_ - i0);
    __syncthreads();  // the previous block is consumed
    load_tile<T, QT2, NT2>(qs, ld, a.q, b, h, i0, nq, D);
    load_tile<T, QT2, NT2>(dos, ld, a.dout, b, h, i0, nq, D);
    __syncthreads();
    float pv = 0.f, sv = 0.f;
    if (ei < nq && ej < nk) {
      const float* qr = qs + ei * ld;
      const float* kr = ks + ej * ld;
      const float* dr = dos + ei * ld;
      const float* vr = vs + ej * ld;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      for (int d = 0; d < D; ++d) dp = fmaf(dr[d], vr[d], dp);
      s = __fmul_rn(s, a.scale);
      const size_t row = (size_t)bh * T_ + i0 + ei;
      const float p = expf(__fsub_rn(s, a.stats[row])) / a.stats[N + row];
      float pd = p;
      if (a.mask) {
        const bool keep = a.mask[row * T_ + j0 + ej] != 0;
        pd = keep ? __fmul_rn(p, a.inv_keep) : 0.f;
        dp = keep ? __fmul_rn(dp, a.inv_keep) : 0.f;
      }
      pv = round_to<T>(pd);
      sv = round_to<T>(__fmul_rn(__fmul_rn(p, __fsub_rn(dp, a.stats[2 * N + row])), a.scale));
    }
    pb[ei * KT2 + ej] = pv;
    db[ei * KT2 + ej] = sv;
    __syncthreads();
    for (int i = 0; i < nq; ++i) {
      float qx[DC], dx[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        qx[c] = d < D ? qs[i * ld + d] : 0.f;
        dx[c] = d < D ? dos[i * ld + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RPW2; ++r) {
        const int j = warp + 8 * r;
        const float pj = pb[i * KT2 + j], sj = db[i * KT2 + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv[r][c] = fmaf(pj, dx[c], dv[r][c]);
          dk[r][c] = fmaf(sj, qx[c], dk[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW2; ++r) {
    const int j = warp + 8 * r;
    if (j >= nk) continue;
    T* dkr = a.dk.row(b, h, j0 + j);
    T* dvr = a.dv.row(b, h, j0 + j);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dkr[d] = from_f<T>(dk[r][c]);
        dvr[d] = from_f<T>(dv[r][c]);
      }
    }
  }
}

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
using ddt::cp_async8;
using ddt::cp_async_commit;
using ddt::cp_async_wait;
using ddt::ldsm_x4;
using ddt::ldsm_x4_trans;
using ddt::mma_bf16;
using ddt::pack_bf16;
using ddt::smem_u32;

// Rows [r0, r0 + 64) of one head's (T, D) matrix into a [64][DP + 8] tile;
// rows past T and columns past D become zero. With VEC_QKV by 16-byte
// cp.async (D % 8 == 0, 16-byte aligned rows), else by element loads.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const View<const bf16>& m, int b, int h, int r0,
                                          int T_, int D, bool vec) {
  constexpr int LD = DP + 8, CPR = DP / 8;
  if (vec) {
#pragma unroll
    for (int it = 0; it < MK * CPR / MNT; ++it) {
      const int e = threadIdx.x + it * MNT, r = e / CPR, c = (e - r * CPR) * 8;
      const bool ok = r0 + r < T_ && c < D;
      cp_async16(smem_u32(dst + r * LD + c), ok ? m.row(b, h, r0 + r) + c : m.p, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < MK * DP; e += MNT) {
      const int r = e / DP, c = e - r * DP;
      dst[r * LD + c] = r0 + r < T_ && c < D ? m.row(b, h, r0 + r)[c] : __float2bfloat16(0.f);
    }
  }
}

// The (64 query rows) x (64 keys) block of the keep mask at (i0, j0) of
// head row `bh` into [64][LDM] bytes; outside T x T zero.
template <int LDM = MASK_LD>
__device__ __forceinline__ void load_mask(unsigned char* dst, const unsigned char* mask, int bh,
                                          int i0, int j0, int T_, bool vec) {
  const size_t base = (size_t)bh * T_ * T_;
  if (vec) {
#pragma unroll
    for (int it = 0; it < MQ * (MK / 8) / MNT; ++it) {
      const int e = threadIdx.x + it * MNT, r = e / (MK / 8), c = (e - r * (MK / 8)) * 8;
      const bool ok = i0 + r < T_ && j0 + c < T_;  // T % 8 == 0: a chunk is whole or out
      cp_async8(smem_u32(dst + r * LDM + c), ok ? mask + base + (size_t)(i0 + r) * T_ + j0 + c : mask,
                ok ? 8 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < MQ * MK; e += MNT) {
      const int r = e / MK, c = e - r * MK;
      dst[r * LDM + c] = i0 + r < T_ && j0 + c < T_ ? mask[base + (size_t)(i0 + r) * T_ + j0 + c] : 0;
    }
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
#pragma unroll
  for (int n = 0; n < MK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale);
  if (j0 + MK > T_) {  // the last tile: keys past T (whole n8 tiles, T % 8 == 0) get -inf
    const float ninf = -__int_as_float(0x7f800000);
#pragma unroll
    for (int n = 0; n < MK / 8; ++n)
      if (j0 + n * 8 >= T_) s[n][0] = s[n][1] = s[n][2] = s[n][3] = ninf;
  }
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
// [0, 16 KS) of a [rows][DP + 8] tile, read by ldmatrix.trans.
template <int DP, int KS>
__device__ __forceinline__ void mma_pm(float (&acc)[DP / 8][4], const uint32_t (&pa)[KS][4], const bf16* mt) {
  constexpr int LD = DP + 8;
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

// x = keep ? x / (1 - p) : 0 on a 16 x 64 C-layout tile whose rows are the
// mask tile's rows; `mrow` points at the thread's row g, column 2 (lane % 4).
// As x times a selected factor: the same values for finite x (a dropped
// entry becomes a signed zero), and no branch (the conditional product
// compiled to divergent branches and made the masked backward 1.2-1.6x
// the unmasked one).
__device__ __forceinline__ void apply_mask(float (&x)[MK / 8][4], const unsigned char* mrow, float inv_keep) {
#pragma unroll
  for (int n = 0; n < MK / 8; ++n) {
    const uint32_t keep[2] = {*reinterpret_cast<const uint16_t*>(mrow + n * 8),
                              *reinterpret_cast<const uint16_t*>(mrow + 8 * MASK_LDB + n * 8)};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[n][e] = __fmul_rn(x[n][e], (keep[e >> 1] >> (8 * (e & 1))) & 0xffu ? inv_keep : 0.f);
  }
}

// The warp's 16 rows of a 16 x DP accumulator to rows r0 + (0..15) of `out`
// (rows past T and columns past D skipped); bf16x2 stores with VEC_OUT.
template <int DP>
__device__ __forceinline__ void store_acc(const View<bf16>& out, const float (&acc)[DP / 8][4], int b, int h,
                                          int r0, int T_, int D, bool vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    if (i >= T_) continue;
    bf16* orow = out.row(b, h, i);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * qd;
      if (c >= D) continue;
      if (vec) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
      } else {
        orow[c] = __float2bfloat16(acc[n][2 * r]);
        if (c + 1 < D) orow[c + 1] = __float2bfloat16(acc[n][2 * r + 1]);
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
// [row0, row0 + MQ) into dst[3][MQ] by 16-byte cp.async; rows at or past
// `n_rows` become zero, so padded queries get p = 0 and ds = 0.
__device__ __forceinline__ void load_stats(float* dst, const float* stats, size_t N, size_t row0, int n_rows) {
  constexpr int CH = MQ / 4;  // 16-byte chunks per statistic
  const int e = threadIdx.x;
  if (e < 3 * CH) {
    const int k = e / CH, c = (e - k * CH) * 4;
    const bool ok = c < n_rows;  // T % 8 == 0: a chunk is whole or out
    cp_async16(smem_u32(dst + k * MQ + c), ok ? stats + k * N + row0 + c : stats, ok ? 16 : 0);
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

bool is_aligned(const void* p, unsigned bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename U>
bool rows_aligned(const View<U>& m, unsigned bytes) {
  const long long e = bytes / sizeof(bf16);
  return is_aligned(m.p, bytes) && m.sb % e == 0 && m.sh % e == 0 && m.st % e == 0;
}

// The VEC_* flags of a call: q, k, v (and dO) rows by 16 bytes, mask rows by
// 8 (T % 8 == 0: every row 8-byte aligned), outputs by bf16 column pairs.
int mma_flags(const Args<bf16>& a, bool backward) {
  int flags = 0;
  if (a.D % 8 == 0 && rows_aligned(a.q, 16) && rows_aligned(a.k, 16) && rows_aligned(a.v, 16) &&
      (!backward || rows_aligned(a.dout, 16)))
    flags |= VEC_QKV;
  if (a.mask && is_aligned(a.mask, 8)) flags |= VEC_MASK;
  if (a.D % 2 == 0 && (backward ? rows_aligned(a.dq, 4) && rows_aligned(a.dk, 4) && rows_aligned(a.dv, 4)
                                : rows_aligned(a.o, 4)))
    flags |= VEC_OUT;
  return flags;
}

constexpr int MAX_DEVICES = 64;

// Launches a tensor-core kernel with `smem` bytes of dynamic shared memory.
// Its limit, and the carveout at the most shared memory (two blocks of any
// of these kernels on an SM at DP = 128), are set once per device and the
// largest `smem` seen: no driver call on the launches after.
template <auto Kernel>
cudaError_t launch_mma(dim3 grid, size_t smem, const Args<bf16>& a, int flags, cudaStream_t s) {
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
  Kernel<<<grid, MNT, smem, s>>>(a, flags);
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

template <typename T, int DC>
cudaError_t fwd(const Args<T>& a, cudaStream_t s) {
  const int ld = a.D | 1;
  const size_t smem = sizeof(float) * (size_t)(QT * ld + QT * a.Tn + KT * ld);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T, DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<T, DC><<<dim3(a.B * a.H, (a.Tn + QT - 1) / QT), NT, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t bwd(const Args<T>& a, cudaStream_t s) {
  const int ld = a.D | 1;
  const size_t smem1 = sizeof(float) * (size_t)(2 * QT * ld + 2 * QT * a.Tn + KT * ld);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<T, DC><<<dim3(a.B * a.H, (a.Tn + QT - 1) / QT), NT, smem1, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem2 = sizeof(float) * (size_t)(2 * KT2 * ld + 2 * QT2 * ld + 2 * QT2 * KT2);
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<T, DC><<<dim3(a.B * a.H, (a.Tn + KT2 - 1) / KT2), NT2, smem2, s>>>(a);
  return cudaGetLastError();
}

// bf16 forwards and backwards with D <= 128 run on the tensor cores, DP
// columns a tile. The rest run on the CUDA cores, with DC chunks of 32
// columns per lane covering D (8 <= D <= 256).
template <int N>
using Int = std::integral_constant<int, N>;

template <typename T>
cudaError_t dispatch(const Args<T>& a, bool backward, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    const auto mma = [&](auto dp) {
      return backward ? bwd_mma<decltype(dp)::value>(a, s) : fwd_mma<decltype(dp)::value>(a, s);
    };
    if (a.D <= 16) return mma(Int<16>());
    if (a.D <= 32) return mma(Int<32>());
    if (a.D <= 64) return mma(Int<64>());
    if (a.D <= 128) return mma(Int<128>());
    return backward ? bwd<T, 8>(a, s) : fwd<T, 8>(a, s);
  } else {
    const auto cores = [&](auto dc) {
      return backward ? bwd<T, decltype(dc)::value>(a, s) : fwd<T, decltype(dc)::value>(a, s);
    };
    if (a.D <= 32) return cores(Int<1>());
    if (a.D <= 64) return cores(Int<2>());
    if (a.D <= 128) return cores(Int<4>());
    return cores(Int<8>());
  }
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
