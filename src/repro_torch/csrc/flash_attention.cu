// flash_attention: causal (or full) softmax(Q K^T / sqrt(D)) V with an
// online softmax, every statistic in f32, for grouped-query attention;
// optionally a sliding window and a tanh soft-cap, as the model's
// chunked_attention (src/repro/models/attention.py:33) computes them for
// gemma2's local and global layers: s = q.k / sqrt(D), then
// s = cap tanh(s / cap), then a key is masked (-2^30) unless kpos <= qpos
// (causal) and qpos - kpos < window.
//
// Replaces the TPU kernel `flash_attention` (_kernel) in
// src/repro/kernels/flash_attn.py, the Pallas form of the model's chunked
// attention (which has neither window nor cap): every layer of
// LMModel.prefill_step runs it once.
//
// What bounds it on the H100: operations. At the prefill shape (B 4, H 12
// over 2 kv heads, S = T = 2048, D = 128) the causal product is 51.5
// GFLOP against 58.7 MB of inputs and output: 0.052 ms at the card's 989
// TFLOP/s of bf16 tensor-core products, 0.018 ms of bytes. Only the
// tensor cores, fed without stalls, come near that bound.
//
// At gemma2's shape (B 2, H 16 over 8 kv heads, S = T = 8192, D = 256) the
// allowed pairs are 33.6M a head (global) or 25.2M (window 4096): 1.10 and
// 0.83 PFLOP, a bound of 1.112 and 0.834 ms; operations bound it there too.
//
// v may be narrower than q and k: MLA (DeepSeek-V3) attends with q/k width
// DQK = 192 (128 + a 64-wide rotary part) over v width DV = 128, scale
// 1/sqrt(192), o [B, S, H, 128]. Both kernels are templated on (DQK, DV);
// every other call is the instantiation DQK = DV, whose code is the one
// width's. At MLA's prefill (B 2, H 128 over 128, S = T = 8192) the causal
// products are 2 B H pairs (DQK + DV) = 5.50 TFLOP: 5.56 ms at 989 TFLOP/s.
//
// Two kernels, chosen by the C entry on dtype and head widths:
//
// bf16 at D in {64, 128, 256}, and at (DQK, DV) = (192, 128): the
// tensor-core kernel (namespace tc).
//   * one block of 384 threads per (batch * head, 128-row q tile), the
//     latest (heaviest, under the causal mask) q tiles launched first:
//     tile by tile across the heads, or at 192 / 128 (MLA: no two heads
//     share K/V) head by head;
//     warpgroup 0 is the producer (one thread issues every copy; the
//     warpgroup gives its registers up with setmaxnreg to 24), warpgroups
//     1 and 2 are consumers of 64 q rows each (240 registers);
//   * copies by TMA through 4-D tensor maps over q [B, S, H, D] and k, v
//     [B, T, KH, D] with the caller's strides (built on the host at each
//     call, cuTensorMapEncodeTiled reached through the runtime's
//     driver-entry-point query, so nothing links libcuda): 128-byte
//     swizzle, a tile as boxes of 64 columns, rows past S or T filled
//     with zeros by the hardware; q head h reads kv head h / (H / KH), so
//     GQA repeats nothing;
//   * a ring of two K/V stages of 128 rows (64 at D = 256, where 128-row
//     tiles would need 320 KB), each with a full barrier for K, one for V
//     and an empty barrier (mbarrier): the producer keeps the next tile in
//     flight while the consumers compute on this one;
//   * S = Q K^T by wgmma m64n128k16 (m64n64k16 at D = 256; bf16 in, f32
//     accumulators), Q and K both read from shared memory through
//     descriptors; the online
//     softmax runs on the accumulator registers (row max and row sum over
//     the four lanes of a quad), with 1/sqrt(D) * log2(e) folded into the
//     scores so that 2^x (ex2.approx.ftz, one special-function instruction)
//     gives exp; the mask (-2^30, not -inf) is applied only on tiles that
//     cross the diagonal or the tail (a loop of its own, so other tiles pay
//     nothing for it), and tiles wholly in the future are skipped;
//   * window and cap (template flag kMod, so that a call with neither
//     runs the code above unchanged): the soft-cap is applied to the f32
//     scores before the mask, tanh as 1 - 2 / (2^(2x log2 e) + 1) with
//     ex2.approx and a true division (accurate to about 2^-22 absolute:
//     tanh.approx's 2^-11 would move a capped logit by ~0.02), and
//     log2(e) multiplied in after it; each q tile starts its K/V loop at
//     the tile that holds its first row's first allowed key
//     (q0 - window + 1), so tiles wholly left of the window are neither
//     loaded nor computed, and the masked loop also runs on tiles that
//     cross the window's left edge. A q tile's work still grows with its
//     index, so the launch order stays heaviest first;
//   * p is rounded to bf16 before the PV product, as the model's
//     chunked_attention rounds it (src/repro/models/attention.py:68);
//     the row sum l is taken from the f32 p. The f32 accumulator fragment
//     of S is, pair by pair, the bf16 A fragment of O += P V, so P goes
//     from registers to wgmma m64n{D}k16 (D up to 256) with no shuffle;
//     V is the B operand read MN-major through the descriptor's transpose
//     bit, so it is never transposed in memory;
//   * epilogue: acc / max(l, 1e-30) in bf16, stored from registers; tail
//     q rows are not written.
//   Shared memory: Q 32 KB + 2 x (K 32 KB + V 32 KB) at D = 128; Q 64 KB
//   + 2 x (K 32 KB + V 32 KB) at D = 256; Q 48 KB + 2 x (K 48 KB + V 32
//   KB) = 208 KB at 192 / 128 (K and V tiles have their own byte counts,
//   three and two boxes of 64 columns); one block per SM. At D = 256 a
//   consumer holds a 64 x 256 f32 O (128 registers a thread) and a 64 x 64
//   S (32); at 192 / 128 the registers of D = 128 (S takes 12 k-steps
//   where D = 128 takes 8).
//   The mbarrier, TMA, descriptor, wgmma and tensor-map helpers live in
//   hopper_tc.cuh, shared with flash_attention_bwd.cu.
//
// f32 (at 192 / 128 too), and bf16 at D in {16, 32}: the scalar kernel
//   (the port's first
//   design; the window and cap added, tanhf for the cap, window tiles
//   skipped as above). One block of 128 threads per (batch * head,
//   64-row q tile); the q tile and each K, then V, tile staged in shared
//   memory as f32; a thread owns 4 query rows and 8 key columns of the
//   64 x 64 score tile and the same rows of the output in registers;
//   scores, p and the output accumulator in f32 on the CUDA cores (67
//   TFLOP/s of f32, and a shared-memory load for every 2.7 multiply-adds),
//   so it is far slower. At D = 256 its tiles take 145 KB of shared
//   memory and a thread holds 4 x 32 output values; at 192 / 128 115 KB
//   (the K/V buffer sized for the wider K) and 4 x 16.
//
// Both: masked scores at the large finite -2^30 (a masked score gives
// exp(...) == 0, never NaN); ragged S and T; o a contiguous [B, S, H, DV].
// Given a non-null lse (training asks for it, serving does not), each also
// writes every query row's log-sum-exp m + log l in natural-log units
// (the tensor-core kernel converts from its log2 units), from which
// flash_attention_bwd.cu recomputes p.
// Built without --fmad=false (see kernels/_build.py). Launches on the
// caller's stream; allocates nothing.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper_tc.cuh"

namespace {

// -- the scalar kernel: f32, and bf16 at D in {16, 32} ---------------------
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

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse,
                           int H, int KH, int S, int Tk, int BH, int nq,
                           long long qsb, long long qss, long long qsh,
                           long long ksb, long long kss, long long ksh,
                           long long vsb, long long vss, long long vsh,
                           float scale, int causal, int window, float cap) {
  constexpr int kPitch = DQK + 1;       // q and K rows
  constexpr int kVPitch = DV + 1;       // V rows
  constexpr int kKV = DQK > DV ? kPitch : kVPitch;
  constexpr int kPP = kRows + 1;        // pitch of the probability tile
  constexpr int kCols = DV / 8;         // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                     // [kRows][kPitch]
  float* kvs = qs + kRows * kPitch;     // [kRows][kPitch]: K, then V
  float* ps = kvs + kRows * kKV;        // [kRows][kPP]

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

  stage_tile<T, DQK>(qs, qp, qss, q0, q_valid);

  int n_tiles = (Tk + kRows - 1) / kRows;
  if (causal) n_tiles = min(n_tiles, (q0 + q_valid - 1) / kRows + 1);
  // under a window, the first tile that holds row q0's first allowed key
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / kRows : 0;

  for (int kt = kt0; kt < n_tiles; ++kt) {
    const int k0 = kt * kRows;
    const int k_valid = min(kRows, Tk - k0);
    __syncthreads();                    // last tile's V and P are read
    stage_tile<T, DQK>(kvs, kp, kss, k0, k_valid);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DQK; ++d) {
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
        if (cap > 0.f) x = tanhf(x / cap) * cap;
        if (kpos >= Tk || (causal && kpos > qpos)
            || (window > 0 && qpos - kpos >= window))
          x = kNeg;
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
    stage_tile<T, DV>(kvs, vp, vss, k0, k_valid);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kRows; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(rg + 16 * i) * kPP + t];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = kvs[t * kVPitch + cg + 8 * c];
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
    T* op = o + (((long long)b * S + q0 + r) * H + h) * DV;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(op + cg + 8 * c, acc[i][c] / den);
    // m and l are the whole row's in every lane of the row group
    if (lse != nullptr && cg == 0)
      lse[(long long)bh * S + q0 + r] = m[i] + logf(den);
  }
}

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KH, int S, int Tk, const long long* st,
           int causal, int window, float cap, cudaStream_t stream) {
  const int nq = (S + kRows - 1) / kRows;
  const int BH = B * H;
  constexpr int kWide = DQK > DV ? DQK : DV;
  const size_t smem = sizeof(float) * (kRows * (DQK + 1) + kRows * (kWide + 1)
                                       + kRows * (kRows + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_kernel<T, DQK, DV><<<nq * BH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, KH, S, Tk, BH,
      nq,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      (float)(1.0 / std::sqrt((double)DQK)), causal,  // as 1 / math.sqrt(D)
      window, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, int Dv, const void* q, const void* k, const void* v,
             void* o, float* lse, int B, int H, int KH, int S, int Tk,
             const long long* st, int causal, int window, float cap,
             cudaStream_t stream) {
  if (Dv != D) {
    // MLA's pair, in f32 (bf16 takes the tensor-core kernel)
    if constexpr (sizeof(T) == sizeof(float)) {
      if (D == 192 && Dv == 128)
        return launch<T, 192, 128>(q, k, v, o, lse, B, H, KH, S, Tk, st,
                                   causal, window, cap, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
#define FA_CASE(DD)                                                        \
  case DD:                                                                 \
    return launch<T, DD, DD>(q, k, v, o, lse, B, H, KH, S, Tk, st, causal, \
                             window, cap, stream);
  switch (D) {
    FA_CASE(16)
    FA_CASE(32)
    default:
      break;
  }
  // bf16 at D 64, 128 and 256 takes the tensor-core kernel (tc::launch)
  if constexpr (sizeof(T) == sizeof(float)) {
    switch (D) {
      FA_CASE(64)
      FA_CASE(128)
      FA_CASE(256)
      default:
        break;
    }
  }
  return (int)cudaErrorInvalidValue;
#undef FA_CASE
}

// -- the tensor-core kernel: bf16, D in {64, 128, 256} and 192 / 128 --------
namespace tc {

constexpr int kBM = 128;        // q rows per block: two consumer slabs of 64
constexpr int kStages = 2;      // K/V ring depth
constexpr int kThreads = 384;   // producer warpgroup + two consumers

template <int DQK, int DV>
struct Layout {
  // kv rows per tile: 128, or 64 at D = 256, where Q and two stages of
  // 128-row K and V tiles would need 320 KB of the SM's 227
  static constexpr int kBN = DQK == 256 ? 64 : 128;
  static constexpr int kQBytes = kBM * DQK * 2;  // Q: DQK / 64 boxes
  static constexpr int kTileK = kBN * DQK * 2;   // K: DQK / 64 boxes
  static constexpr int kTileV = kBN * DV * 2;    // V: DV / 64 boxes
  static constexpr int kStage = kTileK + kTileV;
  static constexpr int kBars = 3 * kStages + 1;
  // + 1024: the swizzle atoms need a 1024-byte aligned start
  static constexpr int kSmem = kQBytes + kStages * kStage + 8 * kBars + 1024;
};

// tanh x = 1 - 2 / (2^(2 x log2 e) + 1): 2^y by ex2.approx (relative error
// about 2^-22; its flush of tiny results gives -1 for x below -44), then a
// true division, so the result is within about 2^-22 of tanh x
__device__ __forceinline__ float tanh_f32(float x) {
  return 1.f - 2.f / (ex2(x * 2.8853900817779268f) + 1.f);
}

// kMod: the call has a window or a soft-cap (win is the window, 2^30 for
// none; cap_on whether scores are capped). Without it the kernel is the
// plain causal (or full) one, and none of the code below costs it a thing.
template <int DQK, int DV, bool kMod>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_tc(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int H, int KH, int S,
                       int Tk, int BH, int nq, float scale_log2,
                       int causal, int win, int cap_on, float scale_cap,
                       float cap_log2) {
  using L = Layout<DQK, DV>;
  constexpr int kBN = L::kBN;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;          // Q, then the ring
  const uint32_t ring = sq + L::kQBytes;              // stage s: K, then V
  const uint32_t bars = ring + kStages * L::kStage;
  // barriers: full K [kStages], full V [kStages], empty [kStages], Q
  const uint32_t q_full = bars + 8 * 3 * kStages;

  // heaviest q tiles first. At DQK = DV every head's tile qt comes before
  // any head's qt - 1 (the G heads of a kv head, adjacent, share its K/V
  // tiles in L2). MLA's instance has one kv head a head, with 5.2 MB of
  // K/V each at 8192: there a head's q tiles are adjacent instead, so the
  // resident blocks share one or two heads' K/V in L2 rather than each
  // streaming its own from HBM (MLA's prefill on an H100 80GB HBM3 at
  // 700 W: 14.6 ms -> 10.0 ms)
  int bh, qt;
  if constexpr (DQK != DV) {
    bh = blockIdx.x / nq;
    qt = nq - 1 - blockIdx.x % nq;
  } else {
    bh = blockIdx.x % BH;
    qt = nq - 1 - blockIdx.x / BH;
  }
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int q0 = qt * kBM;
  int n_tiles = (Tk + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, (min(S, q0 + kBM) - 1) / kBN + 1);
  // under a window, the first tile that holds row q0's first allowed key
  int kt0 = 0;
  if constexpr (kMod) kt0 = max(0, q0 - win + 1) / kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                     // producer's arrive
      mbar_init(bars + 8 * (kStages + s), 1);
      mbar_init(bars + 8 * (2 * kStages + s), 2 * 128);   // every consumer
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: one thread issues every copy ------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < DQK / kBox; ++c)
        tma_load(sq + c * kBM * kRowBytes, &tq, c * kBox, h, q0, b, q_full);
      for (int kt = kt0; kt < n_tiles; ++kt) {
        const int it = kt - kt0;                      // the ring's count
        const int s = it % kStages;
        const uint32_t sk = ring + s * L::kStage, sv = sk + L::kTileK;
        // the stage's previous tile is consumed (passes at once the first
        // time round: the phase before phase 0 counts as complete)
        mbar_wait(bars + 8 * (2 * kStages + s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bars + 8 * s, L::kTileK);
        for (int c = 0; c < DQK / kBox; ++c)
          tma_load(sk + c * kBN * kRowBytes, &tk, c * kBox, kh, kt * kBN, b,
                   bars + 8 * s);
        mbar_expect_tx(bars + 8 * (kStages + s), L::kTileV);
        for (int c = 0; c < DV / kBox; ++c)
          tma_load(sv + c * kBN * kRowBytes, &tv, c * kBox, kh, kt * kBN, b,
                   bars + 8 * (kStages + s));
      }
    }
    return;
  }

  // -- consumers: 64 q rows each ----------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int t = threadIdx.x % 128;
  // accumulator layout of wgmma m64nN: this thread holds rows r and r + 8
  // of the slab, columns 8 j + cq and 8 j + cq + 1 for j < N / 8; element i
  // is (row r + 8 ((i / 2) % 2), column 8 (i / 4) + cq + i % 2)
  const int r = (t / 32) * 16 + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const int row0 = q0 + 64 * cw + r;                  // row1 = row0 + 8
  const int slab0 = q0 + 64 * cw;                     // the slab's first row
  const uint32_t qa = sq + cw * 64 * kRowBytes;       // the slab in a box

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;     // log2 units; per lane

  mbar_wait(q_full, 0);
  for (int kt = kt0; kt < n_tiles; ++kt) {
    const int it = kt - kt0;
    const int s = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const uint32_t sk = ring + s * L::kStage, sv = sk + L::kTileK;
    const int k0 = kt * kBN;

    // S = Q K^T: DQK / 16 steps of k16; step kk reads 32 bytes into box kk / 4
    float sc[kBN / 2];
    mbar_wait(bars + 8 * s, ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<kBN>(sc,
                    desc(qa + (kk / 4) * kBM * kRowBytes + off, 16, 1024),
                    desc(sk + (kk / 4) * kBN * kRowBytes + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax on the accumulators (scores in log2 units)
    float mx0 = kNeg, mx1 = kNeg;
    bool masked = k0 + kBN > Tk || (causal && k0 + kBN - 1 > slab0);
    // the tile reaches left of some slab row's window
    if constexpr (kMod) masked = masked || slab0 + 63 - k0 >= win;
    if constexpr (kMod) {
      if (cap_on) {                 // uniform: the whole call is capped
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i)
          sc[i] = cap_log2 * tanh_f32(sc[i] * scale_cap);
      } else {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) sc[i] *= scale_log2;
      }
    }
    if (masked) {
      // the tile crosses the tail, the diagonal or the window's left edge
      // of this slab: mask
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        float x = kMod ? sc[i] : sc[i] * scale_log2;
        const int kp = k0 + 8 * (i / 4) + cq + (i % 2);
        const int qp = row0 + 8 * ((i / 2) % 2);
        if (kp >= Tk || (causal && kp > qp) || (kMod && qp - kp >= win))
          x = kNeg;
        sc[i] = x;
        if ((i / 2) % 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        if constexpr (!kMod) sc[i] *= scale_log2;
        if ((i / 2) % 2) mx1 = fmaxf(mx1, sc[i]);
        else mx0 = fmaxf(mx0, sc[i]);
      }
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
    uint32_t pa[kBN / 16][4];                           // P as A fragments
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2) {
      const bool hi = (i / 2) % 2;
      const float p0 = ex2(sc[i] - (hi ? mn1 : mn0));
      const float p1 = ex2(sc[i + 1] - (hi ? mn1 : mn0));
      if (hi) rs1 += p0 + p1;
      else rs0 += p0 + p1;
      pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
    }
    l0 = l0 * c0 + rs0;
    l1 = l1 * c1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] *= (i / 2) % 2 ? c1 : c0;

    // O += P V: kBN / 16 steps of k16; step kk reads V rows 16 kk ..
    mbar_wait(bars + 8 * (kStages + s), ph);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs<DV>(acc, pa[kk],
                  desc(sv + kk * 16 * kRowBytes, kBN * kRowBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bars + 8 * (2 * kStages + s));          // stage s is free
  }

  // epilogue: the quad's partial row sums, then acc / l in bf16
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= S) continue;
    const float den = half ? den1 : den0;
    // m and l are in log2 units: lse = (m + log2 l) ln 2, in natural units
    if (lse != nullptr && cq == 0)
      lse[(long long)bh * S + row] =
          ((half ? m1 : m0) + log2f(den)) * 0.6931471805599453f;
    __nv_bfloat16* op = o + (((long long)b * S + row) * H + h) * DV + cq;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] / den, acc[4 * j + 2 * half + 1] / den);
  }
}

template <int DQK, int DV, bool kMod>
int launch_mod(const CUtensorMap& tq, const CUtensorMap& tk,
               const CUtensorMap& tv, void* o, float* lse, int B, int H,
               int KH, int S, int Tk, int causal, int window, float cap,
               cudaStream_t stream) {
  const int nq = (S + kBM - 1) / kBM;
  const int BH = B * H;
  constexpr int kSmem = Layout<DQK, DV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc<DQK, DV, kMod>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const double scale = 1.0 / std::sqrt((double)DQK);  // as the scalar kernel
  const double log2e = 1.4426950408889634;
  // scores s: s scale log2(e) for ex2; capped, cap log2(e) tanh(s scale /
  // cap) (the f32 score's scale and cap folded into one factor)
  flash_attention_tc<DQK, DV, kMod><<<nq * BH, kThreads, kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, H, KH, S, Tk, BH, nq,
      (float)(scale * log2e), causal, window > 0 ? window : 1 << 30,
      cap > 0.f, cap > 0.f ? (float)(scale / cap) : 0.f,
      (float)(cap * log2e));
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KH, int S, int Tk, const long long* st,
           int causal, int window, float cap, cudaStream_t stream) {
  constexpr int kBN = Layout<DQK, DV>::kBN;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, DQK, H, S, B, st[0], st[1], st[2], kBM)
      || !make_map(&tk, k, DQK, KH, Tk, B, st[3], st[4], st[5], kBN)
      || !make_map(&tv, v, DV, KH, Tk, B, st[6], st[7], st[8], kBN))
    return (int)cudaErrorInvalidValue;
  if (window > 0 || cap > 0.f)
    return launch_mod<DQK, DV, true>(tq, tk, tv, o, lse, B, H, KH, S, Tk,
                                     causal, window, cap, stream);
  return launch_mod<DQK, DV, false>(tq, tk, tv, o, lse, B, H, KH, S, Tk,
                                    causal, window, cap, stream);
}

}  // namespace tc

}  // namespace

extern "C" {

// q [B, S, H, D], k [B, T, KH, D] and v [B, T, KH, Dv] through their
// (batch, row, head) strides in elements (the last dimension contiguous);
// o a contiguous [B, S, H, Dv]; lse null, or a contiguous f32 [B, H, S]
// that receives each row's log-sum-exp of its scaled scores (m + log l,
// natural log: the statistic the backward recomputes p from). dtype 0:
// float32, 1: bfloat16. Dv = D in {16, 32, 64, 128, 256}, or (D, Dv) =
// (192, 128); H a multiple of KH; S, T >= 1. window: 0 for none, else a
// key is allowed only when qpos - kpos < window (then S <= T, so that
// every row keeps a key); cap: 0 for none, else the scaled scores s
// become cap tanh(s / cap) before the mask. bf16 at D 64, 128 or 256, or
// at 192 / 128, takes the tensor-core kernel, which needs 16-byte aligned
// bases and strides that are multiples of 8 elements (kernels/
// flash_attn.py makes them so); everything else the scalar kernel.
// Returns a CUDA error code (0 on success).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    void* lse_out, int dtype, int B, int H, int KH, int S,
                    int T, int D, int Dv,
                    long long qsb, long long qss, long long qsh,
                    long long ksb, long long kss, long long ksh,
                    long long vsb, long long vss, long long vsh, int causal,
                    int window, float cap, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (dtype == 1 && D == 192 && Dv == 128)
    return tc::launch<192, 128>(q, k, v, o, lse, B, H, KH, S, T, st, causal,
                                window, cap, s);
  if (dtype == 1 && D == 256 && Dv == D)
    return tc::launch<256, 256>(q, k, v, o, lse, B, H, KH, S, T, st, causal,
                                window, cap, s);
  if (dtype == 1 && D == 128 && Dv == D)
    return tc::launch<128, 128>(q, k, v, o, lse, B, H, KH, S, T, st, causal,
                                window, cap, s);
  if (dtype == 1 && D == 64 && Dv == D)
    return tc::launch<64, 64>(q, k, v, o, lse, B, H, KH, S, T, st, causal,
                              window, cap, s);
  if (dtype == 0)
    return launch_d<float>(D, Dv, q, k, v, o, lse, B, H, KH, S, T, st,
                           causal, window, cap, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, Dv, q, k, v, o, lse, B, H, KH, S, T,
                                   st, causal, window, cap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
