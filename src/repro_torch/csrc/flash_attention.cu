// flash_attention: causal (or full) softmax(Q K^T / sqrt(D)) V with an
// online softmax, every statistic in f32, for grouped-query attention.
//
// Replaces the TPU kernel `flash_attention` (_kernel) in
// src/repro/kernels/flash_attn.py, the Pallas form of the model's chunked
// attention: every layer of LMModel.prefill_step runs it once.
//
// What bounds it on the H100: operations. At the prefill shape (S = T =
// 2048, D = 128) a (64-row q tile, 64-row kv tile) pair does 2 * 64 * 64 *
// 128 multiply-adds from 32 KB of K and V, far above the card's
// operations-per-byte balance; the causal mask halves the pairs.
//
// Design (simple first; wgmma, TMA and warp specialisation come later):
//   * one block of 128 threads per (batch * head, 64-row q tile); the
//     latest (heaviest, under the causal mask) q tiles are launched first;
//   * q head h reads kv head h / (H / KH) itself, so GQA needs no repeated
//     K/V; q, k and v are read through their batch, row and head strides
//     (the model's [B, S, H, D] and [B, T, KH, D] as they are), the last
//     dimension contiguous; o is written as a contiguous [B, S, H, D];
//   * the q tile, then each kv tile in turn (K, then V in the same
//     buffer), is staged in shared memory as f32, rows padded by one word
//     so that neither the row-wise nor the column-wise reads conflict;
//   * a thread owns 4 query rows (r, r + 16, r + 32, r + 48) and 8 key
//     columns (c, c + 8, ..., c + 56) of the 64 x 64 score tile, and the
//     same 4 rows times D / 8 columns of the output accumulator, in
//     registers; the 8 threads that share rows are 8 neighbouring lanes,
//     so the row max and row sum are three xor shuffles;
//   * scores are f32 dot products (bf16 inputs widened, as the TPU kernel
//     does), scaled by 1/sqrt(D), masked with the large finite -2^30 (not
//     -inf: a masked score gives exp(...) == 0, never NaN), and p stays f32
//     for the PV product, as in the TPU kernel;
//   * kv tiles wholly in the future of the q tile are skipped under the
//     causal mask; tail rows (S or T not a multiple of 64) are read as zero
//     and masked, and tail query rows are not written;
//   * one write per output element: acc / max(l, 1e-30), rounded to the
//     input type.
// Built without --fmad=false (see kernels/_build.py): the loops are
// multiply-add chains. Launches on the caller's stream; allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kRows = 64;       // q rows per block = kv rows per tile
constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr float kNeg = -1073741824.0f;   // -2^30, the TPU kernel's NEG

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int H, int KH, int S, int Tk, int BH, int nq,
                           long long qsb, long long qss, long long qsh,
                           long long ksb, long long kss, long long ksh,
                           long long vsb, long long vss, long long vsh,
                           float scale, int causal) {
  constexpr int kPitch = D + 1;
  constexpr int kPP = kRows + 1;        // pitch of the probability tile
  constexpr int kCols = D / 8;          // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                     // [kRows][kPitch]
  float* kvs = qs + kRows * kPitch;     // [kRows][kPitch]: K, then V
  float* ps = kvs + kRows * kPitch;     // [kRows][kPP]

  const int bh = blockIdx.x % BH;
  const int qt = nq - 1 - blockIdx.x / BH;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int q0 = qt * kRows;
  const int q_valid = min(kRows, S - q0);
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + kh * ksh;
  const T* vp = v + b * vsb + kh * vsh;

  const int rg = threadIdx.x >> 3;      // rows rg + 16 i
  const int cg = threadIdx.x & 7;       // columns cg + 8 j

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  stage_tile<T, D>(qs, qp, qss, q0, q_valid);

  int n_tiles = (Tk + kRows - 1) / kRows;
  if (causal) n_tiles = min(n_tiles, (q0 + q_valid - 1) / kRows + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kRows;
    const int k_valid = min(kRows, Tk - k0);
    __syncthreads();                    // last tile's V and P are read
    stage_tile<T, D>(kvs, kp, kss, k0, k_valid);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(rg + 16 * i) * kPitch + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) bk[j] = kvs[(cg + 8 * j) * kPitch + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += a[i] * bk[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        float x = s[i][j] * scale;
        if (kpos >= Tk || (causal && kpos > qpos)) x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(rg + 16 * i) * kPP + cg + 8 * j] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }

    __syncthreads();                    // K is read, P is written
    stage_tile<T, D>(kvs, vp, vss, k0, k_valid);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kRows; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(rg + 16 * i) * kPP + t];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = kvs[t * kPitch + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    if (r >= q_valid) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* op = o + (((long long)b * S + q0 + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(op + cg + 8 * c, acc[i][c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KH, int S, int Tk, const long long* st, int causal,
           cudaStream_t stream) {
  const int nq = (S + kRows - 1) / kRows;
  const int BH = B * H;
  const size_t smem = sizeof(float) * (2 * kRows * (D + 1)
                                       + kRows * (kRows + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_kernel<T, D><<<nq * BH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, S, Tk, BH, nq,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      (float)(1.0 / std::sqrt((double)D)), causal);   // as 1 / math.sqrt(D)
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int H, int KH, int S, int Tk, const long long* st,
             int causal, cudaStream_t stream) {
#define FA_CASE(DD) \
  case DD:          \
    return launch<T, DD>(q, k, v, o, B, H, KH, S, Tk, st, causal, stream);
  switch (D) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

extern "C" {

// q [B, S, H, D], k and v [B, T, KH, D] through their (batch, row, head)
// strides in elements (the last dimension contiguous); o a contiguous
// [B, S, H, D]. dtype 0: float32, 1: bfloat16. D in {16, 32, 64, 128};
// H a multiple of KH; S, T >= 1. Returns a CUDA error code (0 on success).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int dtype, int B, int H, int KH, int S, int T, int D,
                    long long qsb, long long qss, long long qsh,
                    long long ksb, long long kss, long long ksh,
                    long long vsb, long long vss, long long vsh, int causal,
                    void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, B, H, KH, S, T, st, causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KH, S, T, st,
                                   causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
