// flash_attention_bwd: dQ, dK and dV of causal (or full) softmax attention
// softmax(Q K^T / sqrt(D)) V for grouped-query attention, from q, k, v, the
// forward's output o, its row log-sum-exp lse and the output's gradient dO.
//
// Replaces what the JAX package gets by autodiff of `chunked_attention`
// (src/repro/models/attention.py:33): the Pallas `flash_attention` kernel
// has no backward. Every layer of LMModel.train_step runs it once per
// microbatch, through kernels/flash_attn.py's FlashAttentionFn.
//
// What bounds it on the H100: operations. At the training shape (B 4, H 12
// over 2 kv heads, S = T = 2048, D 128) the five causal products (S again,
// dP, dV, dK, dQ) are 2.5x the forward's 51.5 GFLOP: 128.8 GFLOP, 0.130 ms
// at the card's 989 TFLOP/s of bf16 tensor-core products. This first
// design is the simple one: every product on the CUDA cores in f32, tiles
// staged in shared memory as f32, like the forward's scalar kernel. Its
// tensor-core form (wgmma, a TMA ring) is later work.
//
// The closed form (kernels/flash_attn.py flash_attention_bwd_plain):
//   P  = exp(S / sqrt(D) - lse), 0 where the mask hides a key
//   Dr = rowsum(dO o O)                      per (b, h, query row), f32
//   dP = dO V^T,  dS = P o (dP - Dr)
//   dV = P^T dO,  dK = dS^T Q / sqrt(D),  dQ = dS K / sqrt(D)
// Three kernels on the caller's stream, no atomics, every sum in one fixed
// order, so two runs give the same bits:
//   * rowdot_kernel: Dr, one warp per row (a shuffle tree);
//   * dkdv_kernel: one block of 256 threads per (batch, kv head, 64-row k
//     tile), the k tiles nearest the start (which the most query rows see)
//     launched first. It loops over the G = H / KH query heads of its kv
//     head and, for each, over the 64-row q tiles that the causal mask lets
//     see its keys, and keeps dK and dV in registers. So the sum of GQA
//     over the G heads happens inside the block: dK and dV are written
//     once, nothing is repeated or added atomically;
//   * dq_kernel: one block per (batch * head, 64-row q tile), the latest
//     (heaviest) q tiles first, over the k tiles up to the diagonal.
// A thread of the 64 x 64 score tile owns 4 rows and 4 columns (rows
// rg + 16 i, columns cg + 16 j), and the same 4 rows times D / 16 columns
// of each accumulator.
//
// Rounding of p: where the forward took the tensor-core kernel (bf16 at
// D 64 and 128) it rounded p to bf16 before the PV product. With
// `round_p` the dV product here uses p rounded to bf16 too, so dV weighs
// dO by the p the forward weighed V by; dS and the other products keep
// the f32 p. The plain version's `round_p` defines the same choice.
//
// Masked scores: p is 0 wherever the forward's mask (-2^30) gave exp 0:
// keys after the query under the causal mask, and the tail rows past S or
// T, which are staged as zeros and never written. dQ, dK and dV are
// contiguous [B, S, H, D] / [B, T, KH, D] in the input's type; q, k and v
// are read through their strides, o and dO are contiguous. Built without
// --fmad=false, like flash_attention.cu: f32 multiply-add chains held to
// 1e-4 of the gradient's max (see kernels/_build.py). Allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kRows = 64;       // rows of a q or k tile
constexpr int kThreads = 256;   // 16 row groups x 16 column groups
constexpr int kPP = kRows + 1;  // pitch of a score tile in shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dst[r][d] (row pitch D + 1) = src[(row0 + r) * row_stride + d] as f32 for
// r < valid, 0 for the tail rows.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           long long row_stride, int row0,
                                           int valid) {
#pragma unroll 4
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float x = 0.f;
    if (r < valid) x = to_f32(src[(long long)(row0 + r) * row_stride + d]);
    dst[r * (D + 1) + d] = x;
  }
}

// row statistics of q tile [q0, q0 + 64) of head bh: lse and Dr, 0 past S
__device__ __forceinline__ void stage_stats(float* ls, float* ds,
                                            const float* lse,
                                            const float* dsum, long long bh,
                                            int S, int q0, int valid) {
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    ls[r] = r < valid ? lse[bh * S + q0 + r] : 0.f;
    ds[r] = r < valid ? dsum[bh * S + q0 + r] : 0.f;
  }
}

// Dr[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d], one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                  float* __restrict__ dsum, long long rows, int S, int H,
                  int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32)
                        + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc += to_f32(o[row * D + d]) * to_f32(dout[row * D + d]);
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;             // b * S + s
    const long long b = bs / S, s = bs % S;
    dsum[(b * H + h) * S + s] = acc;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ dsum, T* __restrict__ dk,
                T* __restrict__ dv, int B, int H, int KH, int S, int Tk,
                long long qsb, long long qss, long long qsh, long long ksb,
                long long kss, long long ksh, long long vsb, long long vss,
                long long vsh, float scale, int causal, int round_p) {
  constexpr int kPitch = D + 1;
  constexpr int kCols = D / 16;         // accumulator columns per thread
  extern __shared__ float smem[];
  float* ks = smem;                     // [kRows][kPitch] each
  float* vs = ks + kRows * kPitch;
  float* qs = vs + kRows * kPitch;
  float* dos = qs + kRows * kPitch;
  float* ps = dos + kRows * kPitch;     // [kRows][kPP]: P^T, then dS^T
  float* dss = ps + kRows * kPP;
  float* ls = dss + kRows * kPP;        // [kRows] lse, then Dr
  float* ds = ls + kRows;

  const int bkh = blockIdx.x % (B * KH);
  const int kt = blockIdx.x / (B * KH);
  const int b = bkh / KH, kh = bkh % KH;
  const int G = H / KH;
  const int k0 = kt * kRows;
  const int k_valid = min(kRows, Tk - k0);
  const int nq = (S + kRows - 1) / kRows;
  const int rg = threadIdx.x / 16;      // key rows rg + 16 i
  const int cg = threadIdx.x % 16;      // query columns cg + 16 j

  stage_tile<T, D>(ks, k + b * ksb + kh * ksh, kss, k0, k_valid);
  stage_tile<T, D>(vs, v + b * vsb + kh * vsh, vss, k0, k_valid);

  float adk[4][kCols], adv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) adk[i][c] = adv[i][c] = 0.f;

  // under the causal mask, q tile qt sees key k0 only if qt >= kt
  const int q_first = causal ? min(kt, nq) : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long bh = (long long)b * H + h;
    for (int qt = q_first; qt < nq; ++qt) {
      const int q0 = qt * kRows;
      const int q_valid = min(kRows, S - q0);
      __syncthreads();                  // the last tile's reads are done
      stage_tile<T, D>(qs, q + b * qsb + h * qsh, qss, q0, q_valid);
      stage_tile<T, D>(dos, dout + ((long long)b * S * H + h) * D,
                       (long long)H * D, q0, q_valid);
      stage_stats(ls, ds, lse, dsum, bh, S, q0, q_valid);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T on the tile: rows keys, columns queries
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float ak[4], av[4], bq[4], bo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ak[i] = ks[(rg + 16 * i) * kPitch + d];
          av[i] = vs[(rg + 16 * i) * kPitch + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bq[j] = qs[(cg + 16 * j) * kPitch + d];
          bo[j] = dos[(cg + 16 * j) * kPitch + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] += ak[i] * bq[j];
            dpt[i][j] += av[i] * bo[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = cg + 16 * j;
          float p = 0.f;
          if (kr < k_valid && qc < q_valid
              && !(causal && k0 + kr > q0 + qc))
            p = expf(st[i][j] * scale - ls[qc]);
          ps[kr * kPP + qc] = round_p ? round_bf16(p) : p;
          dss[kr * kPP + qc] = p * (dpt[i][j] - ds[qc]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's 64 query rows
#pragma unroll 4
      for (int t = 0; t < kRows; ++t) {
        float pr[4], dr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = ps[(rg + 16 * i) * kPP + t];
          dr[i] = dss[(rg + 16 * i) * kPP + t];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float ov = dos[t * kPitch + cg + 16 * c];
          const float qv = qs[t * kPitch + cg + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][c] += pr[i] * ov;
            adk[i][c] += dr[i] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = rg + 16 * i;
    if (kr >= k_valid) continue;
    const long long off = (((long long)b * Tk + k0 + kr) * KH + kh) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      store(dk + off + cg + 16 * c, adk[i][c] * scale);
      store(dv + off + cg + 16 * c, adv[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              T* __restrict__ dq, int H, int KH, int S, int Tk, int BH,
              int nq, long long qsb, long long qss, long long qsh,
              long long ksb, long long kss, long long ksh, long long vsb,
              long long vss, long long vsh, float scale, int causal) {
  constexpr int kPitch = D + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                     // [kRows][kPitch] each
  float* dos = qs + kRows * kPitch;
  float* ks = dos + kRows * kPitch;
  float* vs = ks + kRows * kPitch;
  float* dss = vs + kRows * kPitch;     // [kRows][kPP]: dS
  float* ls = dss + kRows * kPP;
  float* ds = ls + kRows;

  const int bh = blockIdx.x % BH;
  const int qt = nq - 1 - blockIdx.x / BH;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int q0 = qt * kRows;
  const int q_valid = min(kRows, S - q0);
  const int rg = threadIdx.x / 16;      // query rows rg + 16 i
  const int cg = threadIdx.x % 16;      // key columns cg + 16 j

  stage_tile<T, D>(qs, q + b * qsb + h * qsh, qss, q0, q_valid);
  stage_tile<T, D>(dos, dout + ((long long)b * S * H + h) * D,
                   (long long)H * D, q0, q_valid);
  stage_stats(ls, ds, lse, dsum, bh, S, q0, q_valid);

  float adq[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) adq[i][c] = 0.f;

  int n_tiles = (Tk + kRows - 1) / kRows;
  if (causal) n_tiles = min(n_tiles, (q0 + q_valid - 1) / kRows + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kRows;
    const int k_valid = min(kRows, Tk - k0);
    __syncthreads();                    // the last tile's reads are done
    stage_tile<T, D>(ks, k + b * ksb + kh * ksh, kss, k0, k_valid);
    stage_tile<T, D>(vs, v + b * vsb + kh * vsh, vss, k0, k_valid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows queries, columns keys
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float aq[4], ao[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        aq[i] = qs[(rg + 16 * i) * kPitch + d];
        ao[i] = dos[(rg + 16 * i) * kPitch + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = ks[(cg + 16 * j) * kPitch + d];
        bv[j] = vs[(cg + 16 * j) * kPitch + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += aq[i] * bk[j];
          dp[i][j] += ao[i] * bv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = cg + 16 * j;
        float p = 0.f;
        if (qr < q_valid && kc < k_valid && !(causal && k0 + kc > q0 + qr))
          p = expf(s[i][j] * scale - ls[qr]);
        dss[qr * kPP + kc] = p * (dp[i][j] - ds[qr]);
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's 64 keys
#pragma unroll 4
    for (int t = 0; t < kRows; ++t) {
      float dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = dss[(rg + 16 * i) * kPP + t];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kv = ks[t * kPitch + cg + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) adq[i][c] += dr[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = rg + 16 * i;
    if (qr >= q_valid) continue;
    T* out = dq + (((long long)b * S + q0 + qr) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      store(out + cg + 16 * c, adq[i][c] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int B, int H, int KH, int S, int Tk,
           const long long* st, int causal, int round_p,
           cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const long long rows = (long long)B * S * H;
  const int per = kThreads / 32;
  rowdot_kernel<T><<<(unsigned)((rows + per - 1) / per), kThreads, 0,
                     stream>>>(static_cast<const T*>(o), dop, dsum, rows, S,
                               H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const float scale = (float)(1.0 / std::sqrt((double)D));  // as the forward
  const size_t smem = sizeof(float) * (4 * kRows * (D + 1) + 2 * kRows * kPP
                                       + 2 * kRows);
  err = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nk = (Tk + kRows - 1) / kRows;
  dkdv_kernel<T, D><<<nk * B * KH, kThreads, smem, stream>>>(
      qp, kp, vp, dop, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      B, H, KH, S, Tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale, causal, round_p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = sizeof(float) * (4 * kRows * (D + 1) + kRows * kPP
                                         + 2 * kRows);
  err = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + kRows - 1) / kRows;
  dq_kernel<T, D><<<nq * B * H, kThreads, smem_q, stream>>>(
      qp, kp, vp, dop, lse, dsum, static_cast<T*>(dq), H, KH, S, Tk, B * H,
      nq, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, float* dsum,
             void* dq, void* dk, void* dv, int B, int H, int KH, int S,
             int Tk, const long long* st, int causal, int round_p,
             cudaStream_t stream) {
#define FAB_CASE(DD)                                                       \
  case DD:                                                                 \
    return launch<T, DD>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H,    \
                         KH, S, Tk, st, causal, round_p, stream);
  switch (D) {
    FAB_CASE(16)
    FAB_CASE(32)
    FAB_CASE(64)
    FAB_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FAB_CASE
}

}  // namespace

extern "C" {

// q [B, S, H, D], k and v [B, T, KH, D] through their (batch, row, head)
// strides in elements (the last dimension contiguous); o and dout (the
// forward's output and its gradient) contiguous [B, S, H, D]; lse the
// forward's contiguous f32 [B, H, S] row log-sum-exp (natural log); dsum
// f32 [B, H, S] scratch; dq a contiguous [B, S, H, D], dk and dv
// contiguous [B, T, KH, D], written whole. dtype 0: float32, 1: bfloat16.
// D in {16, 32, 64, 128}; H a multiple of KH; S, T >= 1. round_p: the dV
// product takes p rounded to bf16 (as the tensor-core forward rounded
// it). Three launches on `stream`; returns a CUDA error code (0 on
// success).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* dsum, void* dq, void* dk, void* dv, int dtype,
                        int B, int H, int KH, int S, int T, int D,
                        long long qsb, long long qss, long long qsh,
                        long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh,
                        int causal, int round_p, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, dout, l, ds, dq, dk, dv, B, H, KH,
                           S, T, st, causal, round_p, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, dout, l, ds, dq, dk, dv, B,
                                   H, KH, S, T, st, causal, round_p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
