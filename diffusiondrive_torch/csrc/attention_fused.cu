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
// compute binds); the backward does 2.5x the forward's flops over 1.75x its
// bytes, also memory-bound. This first version multiplies on the CUDA
// cores in f32 FMA (67 TFLOP/s peak), which keeps it far above that bound;
// mma/wgmma on the tensor cores is later work.
//
// Design: the TPU kernel held all heads of a batch row with whole (T, T)
// f32 tiles in VMEM; a (320, 320) f32 score matrix is 400 KB, above the
// 227 KB of shared memory a block may use, so here a block owns one
// (batch, head) and a tile of query rows (forward and dq pass) or key rows
// (dk/dv pass) and streams the other operand through shared memory in tiles.
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
// Linear outputs; each lane owns columns lane + 32c of D. Launches on the
// caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "common.cuh"

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
  float* stats;               // (3, B*H*T): row max, row sum, sum_j dp*p
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

// Columns per lane: DC chunks of 32 cover D (8 <= D <= 256).
template <typename T>
cudaError_t dispatch(const Args<T>& a, bool backward, cudaStream_t s) {
  if (a.D <= 32) return backward ? bwd<T, 1>(a, s) : fwd<T, 1>(a, s);
  if (a.D <= 64) return backward ? bwd<T, 2>(a, s) : fwd<T, 2>(a, s);
  if (a.D <= 128) return backward ? bwd<T, 4>(a, s) : fwd<T, 4>(a, s);
  return backward ? bwd<T, 8>(a, s) : fwd<T, 8>(a, s);
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
