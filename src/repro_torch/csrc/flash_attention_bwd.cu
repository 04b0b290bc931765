// flash_attention_bwd: dQ, dK and dV of causal (or full) softmax attention
// softmax(Q K^T / sqrt(D)) V for grouped-query attention, from q, k, v, the
// forward's output o, its row log-sum-exp lse and the output's gradient dO;
// optionally with the forward's sliding window and tanh soft-cap (gemma2's
// local and global layers). v may be narrower than q and k: MLA
// (DeepSeek-V3) attends with q/k width DQK = 192 over v width DV = 128
// (scale 1/sqrt(192)); dV and o, dO then have width 128, dQ and dK 192.
//
// Replaces what the JAX package gets by autodiff of `chunked_attention`
// (src/repro/models/attention.py:33, with its `window` and `cap`): the
// Pallas `flash_attention` kernel has no backward. Every layer of
// LMModel.train_step runs it once per microbatch, through
// kernels/flash_attn.py's FlashAttentionFn.
//
// What bounds it on the H100: operations. At the training shape (B 4, H 12
// over 2 kv heads, S = T = 2048, D 128) the five causal products (S again,
// dP, dV, dK, dQ) are 2.5x the forward's 51.5 GFLOP: 128.8 GFLOP, 0.130 ms
// at the card's 989 TFLOP/s of bf16 tensor-core products. At gemma2's (B 1,
// H 16 over 8, S = T = 8192, D 256) they are 2.5x the forward's FLOPs over
// the allowed pairs: 1.04 ms for a local layer (window 4096), 1.39 ms for a
// global one. At MLA's (B 1, H 128 over 128, S = T = 8192, DQK 192, DV
// 128) the products are 2 B H pairs (3 DQK + 2 DV) = 7.148 TFLOP: 7.23 ms.
// Only the tensor cores, fed by TMA without stalls, come near.
//
// The closed form (kernels/flash_attn.py flash_attention_bwd_plain):
//   X  = S / sqrt(D); capped, t = tanh(X / cap) and the logit cap t
//   P  = exp(logit - lse), 0 where the mask hides a key (the forward's:
//        kpos <= qpos under the causal mask, qpos - kpos < window)
//   Dr = rowsum(dO o O)                      per (b, h, query row), f32
//   dP = dO V^T,  dS = P o (dP - Dr), capped times 1 - t^2 (the soft-cap's
//        derivative)
//   dV = P^T dO,  dK = dS^T Q / sqrt(D),  dQ = dS K / sqrt(D)
// No atomics anywhere: every sum runs in one fixed order, so two runs give
// the same bits. The C entry dispatches on dtype and head width as the
// forward's does (kernels/flash_attn.py tensor_core_path):
//
// bf16 at D in {64, 128}: the tensor-core kernels (namespace tc), four
//   launches on the caller's stream:
//   * stats_kernel: Dr and lse log2(e) per (b, h, row) into f32 [B H, Sp]
//     (Sp = S rounded up to 128); the pad rows get lse 2^30, so that any
//     score there gives p = 2^(s - 2^30) = 0, and Dr 0;
//   * dkdv_tc: one block of 384 threads per (batch, QUERY head, 128-row k
//     tile), the k tiles nearest the start (which the most queries see)
//     launched first: 768 blocks at the training shape, the heaviest
//     first, so that the 132 SMs stay busy to the end. Warpgroup 0
//     is the producer (one thread issues every copy; setmaxnreg 24): K and
//     V once, then for each 64-row q tile that the causal mask lets see the
//     k tile, Q and dO by TMA (4-D tensor maps with the caller's strides,
//     128-byte swizzle, rows past S or T filled with zeros) and the tile's
//     lse and Dr by 1-D bulk copies, into a ring of two stages with full
//     and empty mbarriers. Warpgroups 1 and 2 own 64 k rows each (240
//     registers): S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16 from
//     shared memory; P^T = 2^(S^T scale log2(e) - lse log2(e)) and
//     dS^T = P^T o (dP^T - Dr) on the accumulator registers (the causal
//     mask only on tiles that cross the diagonal; a slab whose keys all
//     come after the tile's queries skips the tile); then dV += P^T dO and
//     dK += dS^T Q by wgmma m64n{D}k16 with the A operand from registers
//     (the f32 accumulator fragment, packed pair by pair into the bf16 A
//     fragment) and dO, Q read MN-major through the descriptor's transpose
//     bit. The block writes its head's f32 dK and dV partials into a
//     scratch [B, T, H, D] each;
//   * dq_tc: one block per (batch * head, 128-row q tile), the latest
//     (heaviest) q tiles first, Q and dO resident, K and V tiles of 128 rows
//     streamed up to the diagonal through the same kind of ring: S = Q K^T
//     and dP = dO V^T again (seven products where the bound counts five: the
//     alternative, dQ summed across the dK/dV blocks, needs atomics), dS on
//     the registers, dQ += dS K with K read MN-major; dQ * scale in bf16;
//   * reduce_kernel: dK and dV = the sum of each kv head's G = H / KH query
//     heads' partials in ascending head order (dK then times 1 / sqrt(D)),
//     rounded once to bf16.
//   Rounding (flash_attention_bwd_plain with round_p=True defines it): the
//   tensor cores take bf16 operands, so p is rounded to bf16 for the dV
//   product (the p the tensor-core forward weighed V by) and dS to bf16 for
//   the dK and dQ products; S, dP, P, dS and every accumulator are f32, and
//   dP is not rounded before the subtraction.
//   Shared memory at D 128: dkdv_tc K 32 KB + V 32 KB + 2 x (Q 16 KB + dO
//   16 KB + 512 B of statistics); dq_tc Q 32 KB + dO 32 KB + 2 x (K 32 KB +
//   V 32 KB). One block per SM. Scratch: 2 B H Sp + 2 B T H D f32, from
//   the wrapper. Each consumer waits for its S and dP products together:
//   two commit groups, to run the exponentials while dP is in flight, ran
//   slower on the H100 in a side-by-side build (the two consumers already
//   overlap each other's products), as did a third ring stage in dkdv_tc
//   and 64-row K/V tiles in dq_tc.
//
// The window and the soft-cap (template flag kMod on the D 64 and 128
//   tensor-core kernels, as the forward's, so that a call with neither
//   runs the code above unchanged; the D 256 kernels take them always, a
//   call without them as window 2^30 and the uncapped logit). The score's
//   p, the cap's factor and the masks come from one set of helpers (prob,
//   hidden, tile_live, tile_edge) in all four. The cap's tanh is the
//   forward's f32-accurate one (1 - 2 / (2^(2 y log2 e) + 1), ex2.approx
//   and a true division, the same operations, so the logit is the
//   forward's), and its derivative 1 - t^2 is taken as u (2 - u) with
//   u = 1 - t, exact where t nears +-1. The work follows the allowed
//   pairs: a k block visits only the q tiles up to k0 + rows - 1 + window
//   - 1, a q block starts at the k tile of q0 - window + 1 (the forward's
//   kt0); tiles that cross the diagonal or the window's left edge take the
//   masked loop, slabs wholly outside it skip the tile.
//
// bf16 at D 256, and at (DQK, DV) = (192, 128): the 64-row tensor-core
//   kernels, templated on (DQK, DV) (the D 128 layouts would need 256 KB
//   for dK/dV and 384 KB for dQ of the 227 KB at D 256, and 256
//   accumulator registers a thread; at 192 / 128, 96 + 64 + 64 registers
//   for dQ and 240 KB of shared memory):
//   * dkdv_tc_wide: one block per (batch, query head, 64-row k tile), K and V
//     resident (32 KB each), a two-stage ring of 64-row Q and dO tiles (64
//     KB a stage). The two consumers split the accumulators: warpgroup 1
//     holds dV (64 x 256 f32, 128 registers), warpgroup 2 dK. Warpgroup 1
//     computes S^T = K Q^T and P^T, hands G^T = P^T (1 - t^2) (P^T
//     uncapped) to warpgroup 2 as f32 through a double buffer in shared
//     memory (16 KB each, full and free mbarriers), then dV += P^T dO;
//     warpgroup 2 computes dP^T = V dO^T meanwhile, then dS^T = G^T o (dP^T
//     - Dr) and dK += dS^T Q. Four products per tile, two a warpgroup, the
//     bound's count; 226 KB of shared memory;
//   * dq_tc_wide: one block per (batch * head, 64-row q tile), Q and dO
//     resident (32 KB each), a two-stage ring of 64-row K and V tiles (64
//     KB a stage); the two consumers take the k tiles in turn (warpgroup 1
//     the even ones, from stage 0; warpgroup 2 the odd ones, from stage 1),
//     each with its own f32 dQ (128 registers) over all 64 rows; at the end
//     warpgroup 2 hands its sum to warpgroup 1 through its stage's memory,
//     which adds it (one fixed order) and writes dQ * scale in bf16;
//   * stats_kernel and reduce_kernel as above; the scratch is the same
//     formula's (0.27 GB at B 1, T 8192, H 16).
//   At (192, 128) (MLA) the same two kernels with tiles of their own
//   widths: K and Q tiles are three boxes of 64 columns (24 KB), V and dO
//   tiles two (16 KB), each with its own TMA boxes and barrier byte count.
//   dkdv: warpgroup 1 runs S^T = K Q^T over 12 k16 steps and holds dV (64
//   x 128 f32, 64 registers), warpgroup 2 runs dP^T = V dO^T over 8 and
//   holds dK (64 x 192, 96 registers, dK += dS^T Q by m64n192k16); 155 KB
//   of shared memory (a third ring stage, 195 KB, ran slower side by side:
//   dK/dV 14.84 against 14.63 ms at B 1, 128 heads, 8192 on an H100 80GB
//   HBM3 at 700 W, scripts/attn_bwd_ab.py --shape mla). dq: each consumer's dQ is 96 registers beside S and
//   dP (32 each); warpgroup 2 hands it over through 48 KB from stage 1 on
//   (the 40 KB stage and 8 KB past it); 129 KB. With one kv head a head
//   (G = 1) each head's Q and dO (5.2 MB at S 8192) or K and V (5.2 MB)
//   would be streamed from HBM by up to 128 blocks in the tile-by-tile
//   order of D 256 (about 43 GB a kernel, 13 ms at 3.35 TB/s), so this
//   instance launches a head's tiles side by side (head-major, as the
//   forward's MLA instance): the blocks resident at once share one or two
//   heads' tiles in the 50 MB L2. reduce_kernel runs once for dK at 192
//   and once for dV at 128 (at G = 1 a copy to bf16); the scratch is
//   2 B H Sp + B T H (DQK + DV) floats (1.34 GB at B 1, T 8192, H 128).
//
// f32 (at 192 / 128 too), and bf16 at D in {16, 32}: the scalar kernels
//   (the port's first design), every product on the CUDA cores in f32,
//   tiles staged in shared memory as f32, like the forward's scalar
//   kernel; p stays f32. Templated on (D, DV) as the forward's scalar
//   kernel; at 192 / 128 K and Q tiles have rows of 193 floats, V and dO
//   of 129 (194 KB of shared memory for dK/dV, 178 KB for dQ, 64-row
//   tiles), the columns past 128 take S alone, and dV is 8 columns a
//   thread where dK is 12. Three launches:
//   * rowdot_kernel: Dr, one warp per row (a shuffle tree) into f32
//     [B, H, S] scratch;
//   * dkdv_kernel: one block of 256 threads per (batch, kv head, k tile of
//     R rows: 64, or 32 at D 256, whose four f32 tiles of 64 rows would
//     need 263 KB of shared memory), the k tiles nearest the start launched
//     first. It loops over the G = H / KH query heads of its kv head and,
//     for each, over the q tiles that the mask lets see its keys, and keeps
//     dK and dV in registers, so the sum of GQA over the G heads happens
//     inside the block;
//   * dq_kernel: one block per (batch * head, R-row q tile), the latest
//     (heaviest) q tiles first, over the k tiles the mask allows.
//   A thread of the R x R score tile owns R / 16 rows and columns (rows
//   rg + 16 i, columns cg + 16 j), and the same rows times D / 16 columns
//   of each accumulator. The cap by tanhf, as the forward's scalar kernel.
//
// Masked scores: p is 0 wherever the forward's mask (-2^30) gave exp 0:
// keys after the query under the causal mask, keys window or more places
// back, and the tail rows past S or T, which are read as zeros and never
// written. dQ, dK and dV are contiguous [B, S, H, D], [B, T, KH, D] and
// [B, T, KH, DV] in the input's type; q, k and v are read through their
// strides, o and dO are contiguous. Built without --fmad=false, like flash_attention.cu: f32
// multiply-add chains held to 1e-4 of the gradient's max (see
// kernels/_build.py). Allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "hopper_tc.cuh"

namespace {

// -- the scalar kernels: f32, and bf16 at D in {16, 32} ----------------------

constexpr int kThreads = 256;   // 16 row groups x 16 column groups

// rows of a scalar q or k tile: 64, or 32 at D 256
template <int D>
constexpr int kRowsOf = D == 256 ? 32 : 64;

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
template <typename T, int D, int R>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           long long row_stride, int row0,
                                           int valid) {
#pragma unroll 4
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float x = 0.f;
    if (r < valid) x = to_f32(src[(long long)(row0 + r) * row_stride + d]);
    dst[r * (D + 1) + d] = x;
  }
}

// row statistics of q tile [q0, q0 + R) of head bh: lse and Dr, 0 past S
template <int R>
__device__ __forceinline__ void stage_stats(float* ls, float* ds,
                                            const float* lse,
                                            const float* dsum, long long bh,
                                            int S, int q0, int valid) {
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    ls[r] = r < valid ? lse[bh * S + q0 + r] : 0.f;
    ds[r] = r < valid ? dsum[bh * S + q0 + r] : 0.f;
  }
}

// the scaled score x of a (query, key) pair as the forward's scalar kernel
// takes it (capped: cap tanh(x / cap)), and the soft-cap's derivative
__device__ __forceinline__ float logit_of(float x, float cap, float& dcap) {
  if (cap > 0.f) {
    const float t = tanhf(x / cap);
    dcap = 1.f - t * t;
    return t * cap;
  }
  dcap = 1.f;
  return x;
}

// whether the forward's mask lets query qpos see key kpos
__device__ __forceinline__ bool allowed(int qpos, int kpos, int causal,
                                        int window) {
  return !(causal && kpos > qpos) && !(window > 0 && qpos - kpos >= window);
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

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ dsum, T* __restrict__ dk,
                T* __restrict__ dv, int B, int H, int KH, int S, int Tk,
                long long qsb, long long qss, long long qsh, long long ksb,
                long long kss, long long ksh, long long vsb, long long vss,
                long long vsh, float scale, int causal, int window,
                float cap) {
  constexpr int R = kRowsOf<D>;
  constexpr int kI = R / 16;            // rows (and columns) per thread
  constexpr int kPitch = D + 1;         // K and Q rows
  constexpr int kPitchV = DV + 1;       // V and dO rows
  constexpr int kPP = R + 1;            // pitch of a score tile
  constexpr int kCols = D / 16;         // dK columns per thread
  constexpr int kColsV = DV / 16;       // dV columns per thread
  extern __shared__ float smem[];
  float* ks = smem;                     // [R][kPitch]
  float* vs = ks + R * kPitch;          // [R][kPitchV]
  float* qs = vs + R * kPitchV;         // [R][kPitch]
  float* dos = qs + R * kPitch;         // [R][kPitchV]
  float* ps = dos + R * kPitchV;        // [R][kPP]: P^T, then dS^T
  float* dss = ps + R * kPP;
  float* ls = dss + R * kPP;            // [R] lse, then Dr
  float* ds = ls + R;

  const int bkh = blockIdx.x % (B * KH);
  const int kt = blockIdx.x / (B * KH);
  const int b = bkh / KH, kh = bkh % KH;
  const int G = H / KH;
  const int k0 = kt * R;
  const int k_valid = min(R, Tk - k0);
  const int nq = (S + R - 1) / R;
  const int rg = threadIdx.x / 16;      // key rows rg + 16 i
  const int cg = threadIdx.x % 16;      // query columns cg + 16 j

  stage_tile<T, D, R>(ks, k + b * ksb + kh * ksh, kss, k0, k_valid);
  stage_tile<T, DV, R>(vs, v + b * vsb + kh * vsh, vss, k0, k_valid);

  float adk[kI][kCols], adv[kI][kColsV];
#pragma unroll
  for (int i = 0; i < kI; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) adk[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < kColsV; ++c) adv[i][c] = 0.f;
  }

  // under the causal mask, q tile qt sees key k0 only if qt >= kt; under a
  // window, only if its first row is within window - 1 of the block's last
  const int q_first = causal ? min(kt, nq) : 0;
  const int q_end = window > 0 ? min(nq, (k0 + R - 1 + window - 1) / R + 1)
                               : nq;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long bh = (long long)b * H + h;
    for (int qt = q_first; qt < q_end; ++qt) {
      const int q0 = qt * R;
      const int q_valid = min(R, S - q0);
      __syncthreads();                  // the last tile's reads are done
      stage_tile<T, D, R>(qs, q + b * qsb + h * qsh, qss, q0, q_valid);
      stage_tile<T, DV, R>(dos, dout + ((long long)b * S * H + h) * DV,
                           (long long)H * DV, q0, q_valid);
      stage_stats<R>(ls, ds, lse, dsum, bh, S, q0, q_valid);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T on the tile: rows keys, columns queries
      float st[kI][kI], dpt[kI][kI];
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kI; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DV; ++d) {
        float ak[kI], av[kI], bq[kI], bo[kI];
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          ak[i] = ks[(rg + 16 * i) * kPitch + d];
          av[i] = vs[(rg + 16 * i) * kPitchV + d];
        }
#pragma unroll
        for (int j = 0; j < kI; ++j) {
          bq[j] = qs[(cg + 16 * j) * kPitch + d];
          bo[j] = dos[(cg + 16 * j) * kPitchV + d];
        }
#pragma unroll
        for (int i = 0; i < kI; ++i)
#pragma unroll
          for (int j = 0; j < kI; ++j) {
            st[i][j] += ak[i] * bq[j];
            dpt[i][j] += av[i] * bo[j];
          }
      }
      // the columns of q and k past v's width (MLA's): S^T alone
#pragma unroll 4
      for (int d = DV; d < D; ++d) {
        float ak[kI], bq[kI];
#pragma unroll
        for (int i = 0; i < kI; ++i) ak[i] = ks[(rg + 16 * i) * kPitch + d];
#pragma unroll
        for (int j = 0; j < kI; ++j) bq[j] = qs[(cg + 16 * j) * kPitch + d];
#pragma unroll
        for (int i = 0; i < kI; ++i)
#pragma unroll
          for (int j = 0; j < kI; ++j) st[i][j] += ak[i] * bq[j];
      }
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        const int kr = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < kI; ++j) {
          const int qc = cg + 16 * j;
          float p = 0.f, dcap = 1.f;
          if (kr < k_valid && qc < q_valid
              && allowed(q0 + qc, k0 + kr, causal, window))
            p = expf(logit_of(st[i][j] * scale, cap, dcap) - ls[qc]);
          ps[kr * kPP + qc] = p;
          dss[kr * kPP + qc] = p * (dpt[i][j] - ds[qc]) * dcap;
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's R query rows
#pragma unroll 4
      for (int t = 0; t < R; ++t) {
        float pr[kI], dr[kI];
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          pr[i] = ps[(rg + 16 * i) * kPP + t];
          dr[i] = dss[(rg + 16 * i) * kPP + t];
        }
#pragma unroll
        for (int c = 0; c < kColsV; ++c) {
          const float ov = dos[t * kPitchV + cg + 16 * c];
          const float qv = qs[t * kPitch + cg + 16 * c];
#pragma unroll
          for (int i = 0; i < kI; ++i) {
            adv[i][c] += pr[i] * ov;
            adk[i][c] += dr[i] * qv;
          }
        }
#pragma unroll
        for (int c = kColsV; c < kCols; ++c) {
          const float qv = qs[t * kPitch + cg + 16 * c];
#pragma unroll
          for (int i = 0; i < kI; ++i) adk[i][c] += dr[i] * qv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int kr = rg + 16 * i;
    if (kr >= k_valid) continue;
    const long long off = (((long long)b * Tk + k0 + kr) * KH + kh) * D;
    const long long offv = (((long long)b * Tk + k0 + kr) * KH + kh) * DV;
#pragma unroll
    for (int c = 0; c < kColsV; ++c) {
      store(dk + off + cg + 16 * c, adk[i][c] * scale);
      store(dv + offv + cg + 16 * c, adv[i][c]);
    }
#pragma unroll
    for (int c = kColsV; c < kCols; ++c)
      store(dk + off + cg + 16 * c, adk[i][c] * scale);
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              T* __restrict__ dq, int H, int KH, int S, int Tk, int BH,
              int nq, long long qsb, long long qss, long long qsh,
              long long ksb, long long kss, long long ksh, long long vsb,
              long long vss, long long vsh, float scale, int causal,
              int window, float cap) {
  constexpr int R = kRowsOf<D>;
  constexpr int kI = R / 16;
  constexpr int kPitch = D + 1;         // Q and K rows
  constexpr int kPitchV = DV + 1;       // dO and V rows
  constexpr int kPP = R + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                     // [R][kPitch]
  float* dos = qs + R * kPitch;         // [R][kPitchV]
  float* ks = dos + R * kPitchV;        // [R][kPitch]
  float* vs = ks + R * kPitch;          // [R][kPitchV]
  float* dss = vs + R * kPitchV;        // [R][kPP]: dS
  float* ls = dss + R * kPP;
  float* ds = ls + R;

  const int bh = blockIdx.x % BH;
  const int qt = nq - 1 - blockIdx.x / BH;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int q0 = qt * R;
  const int q_valid = min(R, S - q0);
  const int rg = threadIdx.x / 16;      // query rows rg + 16 i
  const int cg = threadIdx.x % 16;      // key columns cg + 16 j

  stage_tile<T, D, R>(qs, q + b * qsb + h * qsh, qss, q0, q_valid);
  stage_tile<T, DV, R>(dos, dout + ((long long)b * S * H + h) * DV,
                       (long long)H * DV, q0, q_valid);
  stage_stats<R>(ls, ds, lse, dsum, bh, S, q0, q_valid);

  float adq[kI][kCols];
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) adq[i][c] = 0.f;

  int n_tiles = (Tk + R - 1) / R;
  if (causal) n_tiles = min(n_tiles, (q0 + q_valid - 1) / R + 1);
  // under a window, the first tile that holds row q0's first allowed key
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / R : 0;
  for (int kt = kt0; kt < n_tiles; ++kt) {
    const int k0 = kt * R;
    const int k_valid = min(R, Tk - k0);
    __syncthreads();                    // the last tile's reads are done
    stage_tile<T, D, R>(ks, k + b * ksb + kh * ksh, kss, k0, k_valid);
    stage_tile<T, DV, R>(vs, v + b * vsb + kh * vsh, vss, k0, k_valid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows queries, columns keys
    float s[kI][kI], dp[kI][kI];
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kI; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DV; ++d) {
      float aq[kI], ao[kI], bk[kI], bv[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        aq[i] = qs[(rg + 16 * i) * kPitch + d];
        ao[i] = dos[(rg + 16 * i) * kPitchV + d];
      }
#pragma unroll
      for (int j = 0; j < kI; ++j) {
        bk[j] = ks[(cg + 16 * j) * kPitch + d];
        bv[j] = vs[(cg + 16 * j) * kPitchV + d];
      }
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kI; ++j) {
          s[i][j] += aq[i] * bk[j];
          dp[i][j] += ao[i] * bv[j];
        }
    }
    // the columns of q and k past v's width (MLA's): S alone
#pragma unroll 4
    for (int d = DV; d < D; ++d) {
      float aq[kI], bk[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i) aq[i] = qs[(rg + 16 * i) * kPitch + d];
#pragma unroll
      for (int j = 0; j < kI; ++j) bk[j] = ks[(cg + 16 * j) * kPitch + d];
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kI; ++j) s[i][j] += aq[i] * bk[j];
    }
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int qr = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < kI; ++j) {
        const int kc = cg + 16 * j;
        float p = 0.f, dcap = 1.f;
        if (qr < q_valid && kc < k_valid
            && allowed(q0 + qr, k0 + kc, causal, window))
          p = expf(logit_of(s[i][j] * scale, cap, dcap) - ls[qr]);
        dss[qr * kPP + kc] = p * (dp[i][j] - ds[qr]) * dcap;
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's R keys
#pragma unroll 4
    for (int t = 0; t < R; ++t) {
      float dr[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i) dr[i] = dss[(rg + 16 * i) * kPP + t];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kv = ks[t * kPitch + cg + 16 * c];
#pragma unroll
        for (int i = 0; i < kI; ++i) adq[i][c] += dr[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int qr = rg + 16 * i;
    if (qr >= q_valid) continue;
    T* out = dq + (((long long)b * S + q0 + qr) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      store(out + cg + 16 * c, adq[i][c] * scale);
  }
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int B, int H, int KH, int S, int Tk,
           const long long* st, int causal, int window, float cap,
           cudaStream_t stream) {
  constexpr int R = kRowsOf<D>;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const long long rows = (long long)B * S * H;
  const int per = kThreads / 32;
  rowdot_kernel<T><<<(unsigned)((rows + per - 1) / per), kThreads, 0,
                     stream>>>(static_cast<const T*>(o), dop, dsum, rows, S,
                               H, DV);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const float scale = (float)(1.0 / std::sqrt((double)D));  // as the forward
  const size_t smem = sizeof(float) * (2 * R * (D + 1) + 2 * R * (DV + 1)
                                       + 2 * R * (R + 1) + 2 * R);
  err = cudaFuncSetAttribute(dkdv_kernel<T, D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nk = (Tk + R - 1) / R;
  dkdv_kernel<T, D, DV><<<nk * B * KH, kThreads, smem, stream>>>(
      qp, kp, vp, dop, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      B, H, KH, S, Tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale, causal, window, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = sizeof(float) * (2 * R * (D + 1) + 2 * R * (DV + 1)
                                         + R * (R + 1) + 2 * R);
  err = cudaFuncSetAttribute(dq_kernel<T, D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + R - 1) / R;
  dq_kernel<T, D, DV><<<nq * B * H, kThreads, smem_q, stream>>>(
      qp, kp, vp, dop, lse, dsum, static_cast<T*>(dq), H, KH, S, Tk, B * H,
      nq, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale, causal, window, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, int Dv, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, float* dsum,
             void* dq, void* dk, void* dv, int B, int H, int KH, int S,
             int Tk, const long long* st, int causal, int window, float cap,
             cudaStream_t stream) {
  if (Dv != D) {
    // MLA's pair, in f32 (bf16 takes the tensor-core kernels)
    if constexpr (sizeof(T) == sizeof(float)) {
      if (D == 192 && Dv == 128)
        return launch<T, 192, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                                   B, H, KH, S, Tk, st, causal, window, cap,
                                   stream);
    }
    return (int)cudaErrorInvalidValue;
  }
#define FAB_CASE(DD)                                                       \
  case DD:                                                                 \
    return launch<T, DD, DD>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B,   \
                             H, KH, S, Tk, st, causal, window, cap,        \
                             stream);
  switch (D) {
    FAB_CASE(16)
    FAB_CASE(32)
    default:
      break;
  }
  // bf16 at D 64, 128 and 256 takes the tensor-core kernels (tc::launch)
  if constexpr (sizeof(T) == sizeof(float)) {
    switch (D) {
      FAB_CASE(64)
      FAB_CASE(128)
      FAB_CASE(256)
      default:
        break;
    }
  }
  return (int)cudaErrorInvalidValue;
#undef FAB_CASE
}

// -- the tensor-core kernels: bf16, D in {64, 128} --------------------------
namespace tc {

constexpr int kThreads = 384;   // producer warpgroup + two consumers
constexpr int kKV = 128;        // dkdv_tc: k rows per block (two slabs)
constexpr int kQT = 64;         // dkdv_tc: q rows per streamed tile
constexpr int kStagesKV = 2;    // dkdv_tc: ring depth
constexpr int kQB = 128;        // dq_tc: q rows per block (two slabs)
constexpr int kKT = 128;        // dq_tc: k rows per streamed tile
constexpr int kStagesQ = 2;     // dq_tc: ring depth
constexpr int kPadRows = 128;   // statistics rows padded to a multiple
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadLse = 1073741824.0f;   // 2^30: p = 0 on the pad rows

// The window and cap of a kMod instantiation: win the window (2^30 for
// none), cap_on whether the call is capped, scale_cap = 1 / (sqrt(D) cap)
// and cap_log2 = cap log2(e), as the forward's.
struct Mod {
  int win, cap_on;
  float scale_cap, cap_log2;
};

// The forward's capped logit in log2 units, cap log2(e) tanh(s scale_cap),
// with the same operations as its tanh_f32 (t = 1 - u, u = 2 / (2^(2 y
// log2 e) + 1)), and the cap's derivative 1 - t^2 = u (2 - u).
__device__ __forceinline__ float capped(float s, const Mod& m, float& dcap) {
  const float u = 2.f / (ex2(s * m.scale_cap * 2.8853900817779268f) + 1.f);
  dcap = u * (2.f - u);
  return m.cap_log2 * (1.f - u);
}

// p = 2^(logit - l2) at a raw score s of Q K^T, and g the cap's derivative
// (1 uncapped); without kMod, or uncapped, the logit is s scale log2(e)
template <bool kMod>
__device__ __forceinline__ float prob(float s, float l2, float scale_log2,
                                      const Mod& m, float& g) {
  if (kMod && m.cap_on) return ex2(capped(s, m, g) - l2);   // uniform
  g = 1.f;
  return ex2(fmaf(s, scale_log2, -l2));
}

// whether the forward's mask hides key kp from query qp (under kMod also
// the window, 2^30 for none)
template <bool kMod>
__device__ __forceinline__ bool hidden(int qp, int kp, int causal,
                                       const Mod& m) {
  return (causal && kp > qp) || (kMod && qp - kp >= m.win);
}

// A tile of queries [q_lo, q_hi] and keys [k_lo, k_hi]: whether the mask
// allows some pair of it (a key at or before a query and, under kMod,
// within the window), and whether it hides some pair (the tile crosses
// the diagonal or the window's left edge, and takes the masked loop).
template <bool kMod>
__device__ __forceinline__ bool tile_live(int q_lo, int q_hi, int k_lo,
                                          int k_hi, int causal,
                                          const Mod& m) {
  return !(causal && k_lo > q_hi) && !(kMod && q_lo - k_hi >= m.win);
}
template <bool kMod>
__device__ __forceinline__ bool tile_edge(int q_lo, int q_hi, int k_lo,
                                          int k_hi, int causal,
                                          const Mod& m) {
  return (causal && k_hi > q_lo) || (kMod && q_hi - k_lo >= m.win);
}

// lse2[bh, s] = lse[bh, s] log2(e) and dr[bh, s] = sum_d dO O at row s of
// head bh, for s < S; pad rows S <= s < Sp get 2^30 and 0. One warp a row.
__global__ void __launch_bounds__(256)
    stats_kernel(const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ lse2,
                 float* __restrict__ dr, long long rows, int H, int S,
                 int Sp, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long bh = row / Sp;
  const int s = (int)(row % Sp);
  if (s >= S) {
    if (lane == 0) {
      lse2[row] = kPadLse;
      dr[row] = 0.f;
    }
    return;
  }
  const long long off = ((bh / H * S + s) * H + bh % H) * D;
  float acc = 0.f;
  for (int d = 2 * lane; d < D; d += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + off + d));
    const float2 g = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dout + off + d));
    acc += a.x * g.x + a.y * g.y;
  }
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    dr[row] = acc;
    lse2[row] = lse[bh * S + s] * kLog2e;
  }
}

template <int D>
struct DkdvLayout {
  static constexpr int kTileKV = kKV * D * 2;   // K or V: D / 64 boxes
  static constexpr int kTileQ = kQT * D * 2;    // Q or dO of a stage
  static constexpr int kStats = kQT * 4;        // lse2 or Dr of a stage
  static constexpr int kBars = 2 * kStagesKV + 1;
  // + 1024: the swizzle atoms need a 1024-byte aligned start
  static constexpr int kSmem = 2 * kTileKV + kStagesKV * 2 * kTileQ
                               + kStagesKV * 2 * kStats + 8 * kBars + 1024;
};

template <int D, bool kMod>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_tc(const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lse2, const float* __restrict__ dr,
            float* __restrict__ dk_part, float* __restrict__ dv_part, int H,
            int KH, int S, int Tk, int Sp, int BH, float scale_log2,
            int causal, Mod mod) {
  using L = DkdvLayout<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023) & ~1023u;          // K, V, then the ring
  const uint32_t sv = sk + L::kTileKV;
  const uint32_t ring = sv + L::kTileKV;              // stage s: Q, then dO
  const uint32_t stats = ring + kStagesKV * 2 * L::kTileQ;  // s: lse2, Dr
  const uint32_t bars = stats + kStagesKV * 2 * L::kStats;
  // barriers: full [kStagesKV], empty [kStagesKV], K and V
  const uint32_t kv_full = bars + 8 * 2 * kStagesKV;
  const float* stats_p =
      reinterpret_cast<const float*>(smem_raw + (stats - raw));

  const int bh = blockIdx.x % BH;
  const int kt = blockIdx.x / BH;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int k0 = kt * kKV;
  const int nq = (S + kQT - 1) / kQT;
  // under the causal mask, q tile qt sees a key of [k0, k0 + kKV) only if
  // qt * kQT + kQT - 1 >= k0
  const int qt_first = causal ? min(k0 / kQT, nq) : 0;
  // under a window, only if its first row is within window - 1 of the last
  // (so never below qt_first)
  const int qt_end =
      kMod ? min(nq, (k0 + kKV - 1 + mod.win - 1) / kQT + 1) : nq;
  const int n_iter = qt_end - qt_first;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesKV; ++s) {
      mbar_init(bars + 8 * s, 1);                     // producer's arrive
      mbar_init(bars + 8 * (kStagesKV + s), 2 * 128);   // every consumer
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: one thread issues every copy ------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kTileKV);
      for (int c = 0; c < D / kBox; ++c) {
        tma_load(sk + c * kKV * kRowBytes, &tk, c * kBox, kh, k0, b, kv_full);
        tma_load(sv + c * kKV * kRowBytes, &tv, c * kBox, kh, k0, b, kv_full);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStagesKV;
        const int q0 = (qt_first + it) * kQT;
        const uint32_t sq = ring + s * 2 * L::kTileQ, sdo = sq + L::kTileQ;
        const uint32_t full = bars + 8 * s;
        // the stage's previous tile is consumed (passes at once the first
        // time round: the phase before phase 0 counts as complete)
        mbar_wait(bars + 8 * (kStagesKV + s), ((it / kStagesKV) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::kTileQ + 2 * L::kStats);
        for (int c = 0; c < D / kBox; ++c) {
          tma_load(sq + c * kQT * kRowBytes, &tq, c * kBox, h, q0, b, full);
          tma_load(sdo + c * kQT * kRowBytes, &tdo, c * kBox, h, q0, b, full);
        }
        const long long st = (long long)bh * Sp + q0;
        bulk_load(stats + s * 2 * L::kStats, lse2 + st, L::kStats, full);
        bulk_load(stats + s * 2 * L::kStats + L::kStats, dr + st, L::kStats,
                  full);
      }
    }
    return;
  }

  // -- consumers: 64 k rows each ----------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int t = threadIdx.x % 128;
  // accumulator rows r and r + 8 of the slab, columns 8 j + cq (+ 1)
  const int r = (t / 32) * 16 + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const int ks0 = k0 + 64 * cw;                       // the slab's first key
  const int krow0 = ks0 + r;                          // krow1 = krow0 + 8
  const uint32_t ka = sk + cw * 64 * kRowBytes;       // the slab in a box
  const uint32_t va = sv + cw * 64 * kRowBytes;

  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStagesKV;
    const int q0 = (qt_first + it) * kQT;
    const uint32_t sq = ring + s * 2 * L::kTileQ, sdo = sq + L::kTileQ;
    mbar_wait(bars + 8 * s, (it / kStagesKV) & 1);
    // under the causal mask a slab whose keys all come after the tile's
    // last query gets p = 0 from the whole tile; under a window, so does
    // one whose keys all lie window or more places before its first query
    if (tile_live<kMod>(q0, q0 + kQT - 1, ks0, ks0 + 63, causal,
                        mod)) {
      // S^T = K Q^T, dP^T = V dO^T: D / 16 steps of k16 each
      float st[kQT / 2], dpt[kQT / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kKV * kRowBytes + (kk % 4) * 32;
        const uint32_t offq = (kk / 4) * kQT * kRowBytes + (kk % 4) * 32;
        wgmma_ss<kQT>(st, desc(ka + off, 16, 1024), desc(sq + offq, 16, 1024),
                      kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kKV * kRowBytes + (kk % 4) * 32;
        const uint32_t offq = (kk / 4) * kQT * kRowBytes + (kk % 4) * 32;
        wgmma_ss<kQT>(dpt, desc(va + off, 16, 1024),
                      desc(sdo + offq, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T on the accumulators: rows keys, columns queries; the
      // columns' statistics from the stage
      const float* ls = stats_p + s * 2 * kQT;
      const float* ds = ls + kQT;
      const bool mask =
          tile_edge<kMod>(q0, q0 + kQT - 1, ks0, ks0 + 63, causal, mod);
      uint32_t pa[kQT / 16][4], da[kQT / 16][4];      // A fragments
#pragma unroll
      for (int i = 0; i < kQT / 2; i += 2) {
        const int col = 8 * (i / 4) + cq;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + col);
        float g0, g1;                         // the cap's derivative
        float p0 = prob<kMod>(st[i], l2.x, scale_log2, mod, g0);
        float p1 = prob<kMod>(st[i + 1], l2.y, scale_log2, mod, g1);
        if (mask) {
          const int kp = krow0 + 8 * ((i / 2) % 2);
          // (without kMod a masked tile is a causal one; this form keeps
          // that instantiation's code as fast as before the flag)
          if (kMod ? hidden<true>(q0 + col, kp, causal, mod)
                   : kp > q0 + col)
            p0 = 0.f;
          if (kMod ? hidden<true>(q0 + col + 1, kp, causal, mod)
                   : kp > q0 + col + 1)
            p1 = 0.f;
        }
        pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
        da[i / 8][(i % 8) / 2] = pack_bf16(p0 * (dpt[i] - d2.x) * g0,
                                           p1 * (dpt[i + 1] - d2.y) * g1);
      }

      // dV += P^T dO, dK += dS^T Q: kQT / 16 steps of k16; step kk reads
      // rows 16 kk .. of the stage's dO and Q
      fence_regs(adv);
      fence_regs(adk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQT / 16; ++kk)
        wgmma_rs<D>(adv, pa[kk],
                    desc(sdo + kk * 16 * kRowBytes, kQT * kRowBytes, 1024));
#pragma unroll
      for (int kk = 0; kk < kQT / 16; ++kk)
        wgmma_rs<D>(adk, da[kk],
                    desc(sq + kk * 16 * kRowBytes, kQT * kRowBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(adv);
      fence_regs(adk);
    }
    mbar_arrive(bars + 8 * (kStagesKV + s));              // stage s is free
  }

  // epilogue: this head's partials, f32, rows past T not written
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = krow0 + 8 * half;
    if (row >= Tk) continue;
    const long long off = (((long long)b * Tk + row) * H + h) * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dk_part + off + 8 * j) =
          make_float2(adk[4 * j + 2 * half], adk[4 * j + 2 * half + 1]);
      *reinterpret_cast<float2*>(dv_part + off + 8 * j) =
          make_float2(adv[4 * j + 2 * half], adv[4 * j + 2 * half + 1]);
    }
  }
}

template <int D>
struct DqLayout {
  static constexpr int kQBytes = kQB * D * 2;   // Q or dO: D / 64 boxes
  static constexpr int kTile = kKT * D * 2;     // K or V of a stage
  static constexpr int kBars = 2 * kStagesQ + 1;
  static constexpr int kSmem = 2 * kQBytes + kStagesQ * 2 * kTile + 8 * kBars
                               + 1024;
};

template <int D, bool kMod>
__global__ void __launch_bounds__(kThreads, 1)
    dq_tc(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const float* __restrict__ lse2, const float* __restrict__ dr,
          __nv_bfloat16* __restrict__ dq, int H, int KH, int S, int Tk,
          int Sp, int BH, int nq, float scale_log2, float scale,
          int causal, Mod mod) {
  using L = DqLayout<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;          // Q, dO, then the ring
  const uint32_t sdo = sq + L::kQBytes;
  const uint32_t ring = sdo + L::kQBytes;             // stage s: K, then V
  const uint32_t bars = ring + kStagesQ * 2 * L::kTile;
  // barriers: full [kStagesQ], empty [kStagesQ], Q and dO
  const uint32_t q_full = bars + 8 * 2 * kStagesQ;

  const int bh = blockIdx.x % BH;
  const int qt = nq - 1 - blockIdx.x / BH;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int q0 = qt * kQB;
  int n_tiles = (Tk + kKT - 1) / kKT;
  if (causal) n_tiles = min(n_tiles, (min(S, q0 + kQB) - 1) / kKT + 1);
  // under a window, the first tile that holds row q0's first allowed key
  int kt0 = 0;
  if constexpr (kMod) kt0 = max(0, q0 - mod.win + 1) / kKT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesQ; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStagesQ + s), 2 * 128);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::kQBytes);
      for (int c = 0; c < D / kBox; ++c) {
        tma_load(sq + c * kQB * kRowBytes, &tq, c * kBox, h, q0, b, q_full);
        tma_load(sdo + c * kQB * kRowBytes, &tdo, c * kBox, h, q0, b, q_full);
      }
      for (int kt = kt0; kt < n_tiles; ++kt) {
        const int it = kt - kt0;                      // the ring's count
        const int s = it % kStagesQ;
        const uint32_t sk = ring + s * 2 * L::kTile, sv = sk + L::kTile;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (kStagesQ + s), ((it / kStagesQ) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::kTile);
        for (int c = 0; c < D / kBox; ++c) {
          tma_load(sk + c * kKT * kRowBytes, &tk, c * kBox, kh, kt * kKT, b,
                   full);
          tma_load(sv + c * kKT * kRowBytes, &tv, c * kBox, kh, kt * kKT, b,
                   full);
        }
      }
    }
    return;
  }

  // -- consumers: 64 q rows each ----------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int t = threadIdx.x % 128;
  const int r = (t / 32) * 16 + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const int qs0 = q0 + 64 * cw;                       // the slab's first row
  const int row0 = qs0 + r;                           // row1 = row0 + 8
  const uint32_t qa = sq + cw * 64 * kRowBytes;       // the slab in a box
  const uint32_t oa = sdo + cw * 64 * kRowBytes;
  // the rows' statistics (Sp is a multiple of kQB: never past the pad)
  const long long st0 = (long long)bh * Sp + row0;
  const float l20 = lse2[st0], l21 = lse2[st0 + 8];
  const float dr0 = dr[st0], dr1 = dr[st0 + 8];

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int kt = kt0; kt < n_tiles; ++kt) {
    const int it = kt - kt0;
    const int s = it % kStagesQ;
    const uint32_t sk = ring + s * 2 * L::kTile, sv = sk + L::kTile;
    const int k0 = kt * kKT;
    mbar_wait(bars + 8 * s, (it / kStagesQ) & 1);
    // a tile wholly after the slab's last query is skipped, and under a
    // window one wholly window or more places before its first
    if (tile_live<kMod>(qs0, qs0 + 63, k0, k0 + kKT - 1, causal,
                        mod)) {
      // S = Q K^T, dP = dO V^T
      float sc[kKT / 2], dp[kKT / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t offa = (kk / 4) * kQB * kRowBytes + (kk % 4) * 32;
        const uint32_t offb = (kk / 4) * kKT * kRowBytes + (kk % 4) * 32;
        wgmma_ss<kKT>(sc, desc(qa + offa, 16, 1024),
                      desc(sk + offb, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t offa = (kk / 4) * kQB * kRowBytes + (kk % 4) * 32;
        const uint32_t offb = (kk / 4) * kKT * kRowBytes + (kk % 4) * 32;
        wgmma_ss<kKT>(dp, desc(oa + offa, 16, 1024),
                      desc(sv + offb, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // dS on the accumulators; the mask only where the tile crosses the
      // tail of T (keys read as zeros there, but p could overflow), the
      // slab's diagonal or its window's left edge
      const bool mask = k0 + kKT > Tk
          || tile_edge<kMod>(qs0, qs0 + 63, k0, k0 + kKT - 1, causal, mod);
      uint32_t da[kKT / 16][4];
#pragma unroll
      for (int i = 0; i < kKT / 2; i += 2) {
        const bool hi = (i / 2) % 2;
        const float l2 = hi ? l21 : l20, d2 = hi ? dr1 : dr0;
        float g0, g1;                         // the cap's derivative
        float p0 = prob<kMod>(sc[i], l2, scale_log2, mod, g0);
        float p1 = prob<kMod>(sc[i + 1], l2, scale_log2, mod, g1);
        if (mask) {
          const int kp = k0 + 8 * (i / 4) + cq;
          const int qp = row0 + 8 * hi;
          if (kp >= Tk || hidden<kMod>(qp, kp, causal, mod)) p0 = 0.f;
          if (kp + 1 >= Tk || hidden<kMod>(qp, kp + 1, causal, mod))
            p1 = 0.f;
        }
        da[i / 8][(i % 8) / 2] = pack_bf16(p0 * (dp[i] - d2) * g0,
                                           p1 * (dp[i + 1] - d2) * g1);
      }

      // dQ += dS K: kKT / 16 steps of k16; step kk reads K rows 16 kk ..
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk)
        wgmma_rs<D>(acc, da[kk],
                    desc(sk + kk * 16 * kRowBytes, kKT * kRowBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(bars + 8 * (kStagesQ + s));              // stage s is free
  }

  // epilogue: dQ / sqrt(D) in bf16; tail rows are not written
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= S) continue;
    __nv_bfloat16* op = dq + (((long long)b * S + row) * H + h) * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
  }
}

// -- the tensor-core kernels at D 256 and at (DQK, DV) = (192, 128) ---------
constexpr int kR256 = 64;       // rows of every tile and block of these

// A q or k tile is DQK / 64 boxes of 64 rows, a v or dO tile DV / 64; a
// stage holds one of each (Q then dO, or K then V).
template <int DQK, int DV>
struct LayoutWide {
  static constexpr int kTileK = kR256 * DQK * 2;  // K or Q
  static constexpr int kTileV = kR256 * DV * 2;   // V or dO
  static constexpr int kStage = kTileK + kTileV;
  static constexpr int kStats = kR256 * 4;        // lse2 or Dr of a stage
  static constexpr int kGBuf = 64 * 64 * 4;       // G^T of a q tile, f32
  // dkdv: K, V, 2 stages of Q and dO, their statistics, two G^T buffers;
  // barriers full [2], empty [2], K and V, G full [2], G free [2]
  static constexpr int kSmemKV = kStage + 2 * kStage + 2 * 2 * kStats
                                 + 2 * kGBuf + 8 * 9 + 1024;
  // dq: Q, dO, 2 stages of K and V; warpgroup 2 hands its f32 dQ (DQK / 2
  // values a thread) to warpgroup 1 from stage 1 on, past its end where
  // the stage is smaller (at 192 / 128); barriers full [2], empty [2], Q
  // and dO
  static constexpr int kXfer = DQK / 2 * 128 * 4;
  static constexpr int kRingQ = kStage + (kXfer > kStage ? kXfer : kStage);
  static constexpr int kSmemQ = kStage + kRingQ + 8 * 5 + 1024;
};
static_assert(LayoutWide<256, 256>::kSmemKV <= 232448,
              "dkdv_tc_wide shared memory");

// The first DV / 2 accumulators of a DQK / 2 array, as a DV-wide product's
template <int DV, int N>
__device__ __forceinline__ float (&head_of(float (&a)[N]))[DV / 2] {
  return *reinterpret_cast<float(*)[DV / 2]>(&a[0]);
}

// In both kernels below, `if constexpr (DQK == DV)` keeps D 256's code as
// it was before the pair (its loads interleaved K with V and Q with dO, one
// loop over the warpgroups' shared product), so that its SASS is unchanged;
// the other branch is the pair's, whose tiles and products differ in width.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_tc_wide(const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse2, const float* __restrict__ dr,
                 float* __restrict__ dk_part, float* __restrict__ dv_part,
                 int H, int KH, int S, int Tk, int Sp, int BH,
                 float scale_log2, int causal, Mod mod) {
  constexpr int R = kR256;
  using L = LayoutWide<DQK, DV>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023) & ~1023u;          // K, V, then the ring
  const uint32_t sv = sk + L::kTileK;
  const uint32_t ring = sv + L::kTileV;               // stage s: Q, then dO
  const uint32_t stats = ring + 2 * L::kStage;        // s: lse2, Dr
  const uint32_t gbuf = stats + 2 * 2 * L::kStats;    // G^T [2]
  const uint32_t bars = gbuf + 2 * L::kGBuf;
  const uint32_t kv_full = bars + 8 * 4;
  const uint32_t g_full = bars + 8 * 5, g_free = bars + 8 * 7;
  const float* stats_p =
      reinterpret_cast<const float*>(smem_raw + (stats - raw));
  float* gbuf_p = reinterpret_cast<float*>(smem_raw + (gbuf - raw));

  // the k tiles nearest the start (which the most queries see) first: tile
  // by tile across the heads, or at DQK != DV (MLA: one kv head a head)
  // head by head, so that the resident blocks share a head's Q and dO in L2
  int bh, kt;
  if constexpr (DQK != DV) {
    const int nk = (Tk + R - 1) / R;
    bh = blockIdx.x / nk;
    kt = blockIdx.x % nk;
  } else {
    bh = blockIdx.x % BH;
    kt = blockIdx.x / BH;
  }
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int k0 = kt * R;
  const int nq = (S + R - 1) / R;
  // the q tiles that see a key of [k0, k0 + R): from the diagonal's under
  // the causal mask, up to the window's reach under a window; each has an
  // allowed pair, so no tile is skipped
  const int qt_first = causal ? min(k0 / R, nq) : 0;
  const int qt_end = min(nq, (k0 + R - 1 + mod.win - 1) / R + 1);
  const int n_iter = max(0, qt_end - qt_first);

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bars + 8 * s, 1);                     // producer's arrive
      mbar_init(bars + 8 * (2 + s), 2 * 128);         // both consumers
      mbar_init(g_full + 8 * s, 128);                 // warpgroup 1
      mbar_init(g_free + 8 * s, 128);                 // warpgroup 2
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, L::kStage);
      if constexpr (DQK == DV) {
        for (int c = 0; c < DQK / kBox; ++c) {
          tma_load(sk + c * R * kRowBytes, &tk, c * kBox, kh, k0, b, kv_full);
          tma_load(sv + c * R * kRowBytes, &tv, c * kBox, kh, k0, b, kv_full);
        }
      } else {
        for (int c = 0; c < DQK / kBox; ++c)
          tma_load(sk + c * R * kRowBytes, &tk, c * kBox, kh, k0, b, kv_full);
        for (int c = 0; c < DV / kBox; ++c)
          tma_load(sv + c * R * kRowBytes, &tv, c * kBox, kh, k0, b, kv_full);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % 2;
        const int q0 = (qt_first + it) * R;
        const uint32_t sq = ring + s * L::kStage, sdo = sq + L::kTileK;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (2 + s), ((it / 2) & 1) ^ 1);
        mbar_expect_tx(full, L::kStage + 2 * L::kStats);
        if constexpr (DQK == DV) {
          for (int c = 0; c < DQK / kBox; ++c) {
            tma_load(sq + c * R * kRowBytes, &tq, c * kBox, h, q0, b, full);
            tma_load(sdo + c * R * kRowBytes, &tdo, c * kBox, h, q0, b, full);
          }
        } else {
          for (int c = 0; c < DQK / kBox; ++c)
            tma_load(sq + c * R * kRowBytes, &tq, c * kBox, h, q0, b, full);
          for (int c = 0; c < DV / kBox; ++c)
            tma_load(sdo + c * R * kRowBytes, &tdo, c * kBox, h, q0, b, full);
        }
        const long long st = (long long)bh * Sp + q0;
        bulk_load(stats + s * 2 * L::kStats, lse2 + st, L::kStats, full);
        bulk_load(stats + s * 2 * L::kStats + L::kStats, dr + st, L::kStats,
                  full);
      }
    }
    return;
  }

  // -- consumers: warpgroup 1 P^T and dV, warpgroup 2 dS^T and dK -----------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int t = threadIdx.x % 128;
  const int r = (t / 32) * 16 + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const int krow0 = k0 + r;                           // krow1 = krow0 + 8

  // dV (its first DV / 2), or dK
  float acc[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % 2;
    const uint32_t ph = (it / 2) & 1;
    const int q0 = (qt_first + it) * R;
    const uint32_t sq = ring + s * L::kStage, sdo = sq + L::kTileK;
    const float* ls = stats_p + s * 2 * R;
    float* gp = gbuf_p + s * 64 * 64;      // G^T [32][128 threads] of tile
    mbar_wait(bars + 8 * s, ph);
    float x[R / 2];                        // S^T, or dP^T
    wgmma_fence();
    if constexpr (DQK == DV) {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t off = (kk / 4) * R * kRowBytes + (kk % 4) * 32;
        wgmma_ss<R>(x, desc((cw ? sv : sk) + off, 16, 1024),
                    desc((cw ? sdo : sq) + off, 16, 1024), kk > 0);
      }
    } else if (cw) {
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint32_t off = (kk / 4) * R * kRowBytes + (kk % 4) * 32;
        wgmma_ss<R>(x, desc(sv + off, 16, 1024), desc(sdo + off, 16, 1024),
                    kk > 0);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t off = (kk / 4) * R * kRowBytes + (kk % 4) * 32;
        wgmma_ss<R>(x, desc(sk + off, 16, 1024), desc(sq + off, 16, 1024),
                    kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(x);
    uint32_t a[R / 16][4];                 // P^T, or dS^T: the A fragments
    if (cw == 0) {
      // P^T = 2^(logit - lse2) on the accumulators, rows keys, columns
      // queries; G^T = P^T (1 - t^2) (P^T uncapped) to warpgroup 2
      const bool mask =
          tile_edge<true>(q0, q0 + R - 1, k0, k0 + R - 1, causal, mod);
      mbar_wait(g_free + 8 * s, ph ^ 1);
#pragma unroll
      for (int i = 0; i < R / 2; i += 2) {
        const int col = 8 * (i / 4) + cq;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        float g0, g1;
        float p0 = prob<true>(x[i], l2.x, scale_log2, mod, g0);
        float p1 = prob<true>(x[i + 1], l2.y, scale_log2, mod, g1);
        if (mask) {
          const int kp = krow0 + 8 * ((i / 2) % 2);
          if (hidden<true>(q0 + col, kp, causal, mod)) p0 = 0.f;
          if (hidden<true>(q0 + col + 1, kp, causal, mod)) p1 = 0.f;
        }
        a[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
        gp[i * 128 + t] = p0 * g0;
        gp[(i + 1) * 128 + t] = p1 * g1;
      }
      mbar_arrive(g_full + 8 * s);
    } else {
      // dS^T = G^T o (dP^T - Dr), from warpgroup 1's G^T
      const float* ds = ls + R;
      mbar_wait(g_full + 8 * s, ph);
#pragma unroll
      for (int i = 0; i < R / 2; i += 2) {
        const int col = 8 * (i / 4) + cq;
        const float2 d2 = *reinterpret_cast<const float2*>(ds + col);
        a[i / 8][(i % 8) / 2] = pack_bf16(gp[i * 128 + t] * (x[i] - d2.x),
                                          gp[(i + 1) * 128 + t]
                                              * (x[i + 1] - d2.y));
      }
      mbar_arrive(g_free + 8 * s);
    }

    // dV += P^T dO, or dK += dS^T Q: R / 16 steps of k16, the stage's dO or
    // Q read MN-major
    if constexpr (DQK == DV) {
      const uint32_t bsrc = cw ? sq : sdo;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk)
        wgmma_rs<DQK>(acc, a[kk],
                      desc(bsrc + kk * 16 * kRowBytes, R * kRowBytes, 1024));
    } else {
      fence_regs(acc);
      wgmma_fence();
      if (cw) {
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk)
          wgmma_rs<DQK>(acc, a[kk],
                        desc(sq + kk * 16 * kRowBytes, R * kRowBytes, 1024));
      } else {
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk)
          wgmma_rs<DV>(head_of<DV>(acc), a[kk],
                       desc(sdo + kk * 16 * kRowBytes, R * kRowBytes, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bars + 8 * (2 + s));                  // stage s is free
  }

  // epilogue: this head's partial, f32, rows past T not written; dK is
  // [B, T, H, DQK], dV [B, T, H, DV]
  if constexpr (DQK == DV) {
    float* part = cw ? dk_part : dv_part;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = krow0 + 8 * half;
      if (row >= Tk) continue;
      const long long off = (((long long)b * Tk + row) * H + h) * DQK + cq;
#pragma unroll
      for (int j = 0; j < DQK / 8; ++j)
        *reinterpret_cast<float2*>(part + off + 8 * j) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  } else if (cw) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = krow0 + 8 * half;
      if (row >= Tk) continue;
      const long long off = (((long long)b * Tk + row) * H + h) * DQK + cq;
#pragma unroll
      for (int j = 0; j < DQK / 8; ++j)
        *reinterpret_cast<float2*>(dk_part + off + 8 * j) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = krow0 + 8 * half;
      if (row >= Tk) continue;
      const long long off = (((long long)b * Tk + row) * H + h) * DV + cq;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<float2*>(dv_part + off + 8 * j) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    dq_tc_wide(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ lse2, const float* __restrict__ dr,
               __nv_bfloat16* __restrict__ dq, int H, int KH, int S, int Tk,
               int Sp, int BH, int nq, float scale_log2, float scale,
               int causal, Mod mod) {
  constexpr int R = kR256;
  using L = LayoutWide<DQK, DV>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;          // Q, dO, then the ring
  const uint32_t sdo = sq + L::kTileK;
  const uint32_t ring = sdo + L::kTileV;              // stage s: K, then V
  const uint32_t bars = ring + L::kRingQ;
  const uint32_t q_full = bars + 8 * 4;

  // the latest (heaviest) q tiles first: tile by tile across the heads, or
  // at DQK != DV head by head (a head's K and V shared in L2)
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
  const int q0 = qt * R;
  int n_tiles = (Tk + R - 1) / R;
  if (causal) n_tiles = min(n_tiles, (min(S, q0 + R) - 1) / R + 1);
  const int kt0 = max(0, q0 - mod.win + 1) / R;
  const int n_iter = max(0, n_tiles - kt0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (2 + s), 128);   // stage s: consumer s alone
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kStage);
      if constexpr (DQK == DV) {
        for (int c = 0; c < DQK / kBox; ++c) {
          tma_load(sq + c * R * kRowBytes, &tq, c * kBox, h, q0, b, q_full);
          tma_load(sdo + c * R * kRowBytes, &tdo, c * kBox, h, q0, b, q_full);
        }
      } else {
        for (int c = 0; c < DQK / kBox; ++c)
          tma_load(sq + c * R * kRowBytes, &tq, c * kBox, h, q0, b, q_full);
        for (int c = 0; c < DV / kBox; ++c)
          tma_load(sdo + c * R * kRowBytes, &tdo, c * kBox, h, q0, b, q_full);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % 2;
        const int k0 = (kt0 + it) * R;
        const uint32_t sk = ring + s * L::kStage, sv = sk + L::kTileK;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (2 + s), ((it / 2) & 1) ^ 1);
        mbar_expect_tx(full, L::kStage);
        if constexpr (DQK == DV) {
          for (int c = 0; c < DQK / kBox; ++c) {
            tma_load(sk + c * R * kRowBytes, &tk, c * kBox, kh, k0, b, full);
            tma_load(sv + c * R * kRowBytes, &tv, c * kBox, kh, k0, b, full);
          }
        } else {
          for (int c = 0; c < DQK / kBox; ++c)
            tma_load(sk + c * R * kRowBytes, &tk, c * kBox, kh, k0, b, full);
          for (int c = 0; c < DV / kBox; ++c)
            tma_load(sv + c * R * kRowBytes, &tv, c * kBox, kh, k0, b, full);
        }
      }
    }
    return;
  }

  // -- consumers: the k tiles in turn, each over all 64 q rows ------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int t = threadIdx.x % 128;
  const int r = (t / 32) * 16 + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const int row0 = q0 + r;                            // row1 = row0 + 8
  const long long st0 = (long long)bh * Sp + row0;    // never past the pad
  const float l20 = lse2[st0], l21 = lse2[st0 + 8];
  const float dr0 = dr[st0], dr1 = dr[st0 + 8];
  const uint32_t sk = ring + cw * L::kStage, sv = sk + L::kTileK;

  float acc[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int it = cw; it < n_iter; it += 2) {
    const int k0 = (kt0 + it) * R;
    mbar_wait(bars + 8 * cw, (it / 2) & 1);
    // S = Q K^T, dP = dO V^T
    float sc[R / 2], dp[R / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const uint32_t off = (kk / 4) * R * kRowBytes + (kk % 4) * 32;
      wgmma_ss<R>(sc, desc(sq + off, 16, 1024), desc(sk + off, 16, 1024),
                  kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      const uint32_t off = (kk / 4) * R * kRowBytes + (kk % 4) * 32;
      wgmma_ss<R>(dp, desc(sdo + off, 16, 1024), desc(sv + off, 16, 1024),
                  kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // dS on the accumulators, masked where the tile crosses the tail of T,
    // the diagonal or the window's left edge
    const bool mask = k0 + R > Tk
        || tile_edge<true>(q0, q0 + R - 1, k0, k0 + R - 1, causal, mod);
    uint32_t da[R / 16][4];
#pragma unroll
    for (int i = 0; i < R / 2; i += 2) {
      const bool hi = (i / 2) % 2;
      const float l2 = hi ? l21 : l20, d2 = hi ? dr1 : dr0;
      float g0, g1;
      float p0 = prob<true>(sc[i], l2, scale_log2, mod, g0);
      float p1 = prob<true>(sc[i + 1], l2, scale_log2, mod, g1);
      if (mask) {
        const int kp = k0 + 8 * (i / 4) + cq;
        const int qp = row0 + 8 * hi;
        if (kp >= Tk || hidden<true>(qp, kp, causal, mod)) p0 = 0.f;
        if (kp + 1 >= Tk || hidden<true>(qp, kp + 1, causal, mod)) p1 = 0.f;
      }
      da[i / 8][(i % 8) / 2] = pack_bf16(p0 * (dp[i] - d2) * g0,
                                         p1 * (dp[i + 1] - d2) * g1);
    }

    // dQ += dS K: R / 16 steps of k16, K read MN-major
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk)
      wgmma_rs<DQK>(acc, da[kk],
                    desc(sk + kk * 16 * kRowBytes, R * kRowBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bars + 8 * (2 + cw));                 // stage cw is free
  }

  // warpgroup 2 hands its sum to warpgroup 1 from stage 1's memory on (no
  // copy lands there any more: its last tile was warpgroup 2's), which adds
  // it and writes dQ / sqrt(D) in bf16; tail rows are not written
  float* xp = reinterpret_cast<float*>(smem_raw + (ring + L::kStage - raw));
  if (cw == 1) {
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) xp[i * 128 + t] = acc[i];
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (cw == 1) return;
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] += xp[i * 128 + t];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= S) continue;
    __nv_bfloat16* op = dq + (((long long)b * S + row) * H + h) * DQK + cq;
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
  }
}

// out[b, t, kh, :] = scale x the sum over g < G, in ascending g, of
// part[b, t, kh G + g, :], rounded once to bf16; blockIdx.y picks dK (with
// 1 / sqrt(D)) or dV (scale 1). Four columns a thread.
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ dk_part,
                  const float* __restrict__ dv_part,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, long long n4, int G,
                  int D, float scale_k) {
  const float* part = blockIdx.y ? dv_part : dk_part;
  __nv_bfloat16* out = blockIdx.y ? dv : dk;
  const float scale = blockIdx.y ? 1.f : scale_k;
  const int d4 = D / 4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / d4;                     // (b T + t) KH + kh
    const int d = (int)(i % d4) * 4;
    const float4* src =
        reinterpret_cast<const float4*>(part + row * G * D + d);
    float4 a = src[0];
    for (int g = 1; g < G; ++g) {
      const float4 x = src[g * d4];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + row * D + d);
    o[0] = __floats2bfloat162_rn(a.x * scale, a.y * scale);
    o[1] = __floats2bfloat162_rn(a.z * scale, a.w * scale);
  }
}

// the scratch of these kernels, in floats: lse2 and Dr [B H Sp], the dK
// partials [B T H D] and the dV partials [B T H Dv]
long long work_floats(int B, int H, int S, int Tk, int D, int Dv) {
  const long long Sp = (S + kPadRows - 1) / kPadRows * kPadRows;
  return 2LL * B * H * Sp + (long long)B * Tk * H * (D + Dv);
}

// The kernels' shared arguments at one call.
struct Call {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* work;
  void *dq, *dk, *dv;
  int B, H, KH, S, Tk;
  const long long* st;
  int causal;
};

template <int DQK, int DV, bool kMod>
int run(const Call& c, const Mod& mod, cudaStream_t stream) {
  constexpr int D = DQK;
  const int B = c.B, H = c.H, KH = c.KH, S = c.S, Tk = c.Tk;
  const long long* st = c.st;
  const int Sp = (S + kPadRows - 1) / kPadRows * kPadRows;
  const int BH = B * H;
  float* lse2 = c.work;
  float* dr = lse2 + (long long)BH * Sp;
  float* dk_part = dr + (long long)BH * Sp;
  float* dv_part = dk_part + (long long)B * Tk * H * DQK;
  const auto* o16 = static_cast<const __nv_bfloat16*>(c.o);
  const auto* do16 = static_cast<const __nv_bfloat16*>(c.dout);

  const long long rows = (long long)BH * Sp;
  stats_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      o16, do16, c.lse, lse2, dr, rows, H, S, Sp, DV);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // dO is contiguous [B, S, H, DV]
  const long long dsb = (long long)S * H * DV, dss = (long long)H * DV;
  // 1 / sqrt(D) as the forward, times log2(e) for ex2
  const double scale = 1.0 / std::sqrt((double)D);
  const float scale_log2 = (float)(scale * 1.4426950408889634);
  // the 64-row kernels at D 256 and at DQK != DV (kWide); rows of each
  // map's box: the k block and q tile of dkdv, then the q block and k tile
  // of dq (all 64 there)
  constexpr bool kWide = D == 256 || DQK != DV;
  constexpr int kKVr = kWide ? kR256 : kKV;
  constexpr int kQTr = kWide ? kR256 : kQT;
  constexpr int kQBr = kWide ? kR256 : kQB;
  constexpr int kKTr = kWide ? kR256 : kKT;
  CUtensorMap tk, tv, tq, tdo;
  if (!make_map(&tk, c.k, DQK, KH, Tk, B, st[3], st[4], st[5], kKVr)
      || !make_map(&tv, c.v, DV, KH, Tk, B, st[6], st[7], st[8], kKVr)
      || !make_map(&tq, c.q, DQK, H, S, B, st[0], st[1], st[2], kQTr)
      || !make_map(&tdo, c.dout, DV, H, S, B, dsb, dss, DV, kQTr))
    return (int)cudaErrorInvalidValue;
  const int nk = (Tk + kKVr - 1) / kKVr;
  if constexpr (kWide) {
    using L = LayoutWide<DQK, DV>;
    err = cudaFuncSetAttribute(dkdv_tc_wide<DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kSmemKV);
    if (err != cudaSuccess) return (int)err;
    dkdv_tc_wide<DQK, DV><<<nk * BH, kThreads, L::kSmemKV, stream>>>(
        tk, tv, tq, tdo, lse2, dr, dk_part, dv_part, H, KH, S, Tk, Sp, BH,
        scale_log2, c.causal, mod);
  } else {
    err = cudaFuncSetAttribute(dkdv_tc<D, kMod>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DkdvLayout<D>::kSmem);
    if (err != cudaSuccess) return (int)err;
    dkdv_tc<D, kMod><<<nk * BH, kThreads, DkdvLayout<D>::kSmem, stream>>>(
        tk, tv, tq, tdo, lse2, dr, dk_part, dv_part, H, KH, S, Tk, Sp, BH,
        scale_log2, c.causal, mod);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap tq2, tdo2, tk2, tv2;
  if (!make_map(&tq2, c.q, DQK, H, S, B, st[0], st[1], st[2], kQBr)
      || !make_map(&tdo2, c.dout, DV, H, S, B, dsb, dss, DV, kQBr)
      || !make_map(&tk2, c.k, DQK, KH, Tk, B, st[3], st[4], st[5], kKTr)
      || !make_map(&tv2, c.v, DV, KH, Tk, B, st[6], st[7], st[8], kKTr))
    return (int)cudaErrorInvalidValue;
  const int nq = (S + kQBr - 1) / kQBr;
  auto* dq16 = static_cast<__nv_bfloat16*>(c.dq);
  if constexpr (kWide) {
    using L = LayoutWide<DQK, DV>;
    err = cudaFuncSetAttribute(dq_tc_wide<DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kSmemQ);
    if (err != cudaSuccess) return (int)err;
    dq_tc_wide<DQK, DV><<<nq * BH, kThreads, L::kSmemQ, stream>>>(
        tq2, tdo2, tk2, tv2, lse2, dr, dq16, H, KH, S, Tk, Sp, BH, nq,
        scale_log2, (float)scale, c.causal, mod);
  } else {
    err = cudaFuncSetAttribute(dq_tc<D, kMod>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DqLayout<D>::kSmem);
    if (err != cudaSuccess) return (int)err;
    dq_tc<D, kMod><<<nq * BH, kThreads, DqLayout<D>::kSmem, stream>>>(
        tq2, tdo2, tk2, tv2, lse2, dr, dq16, H, KH, S, Tk, Sp, BH, nq,
        scale_log2, (float)scale, c.causal, mod);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto* dk16 = static_cast<__nv_bfloat16*>(c.dk);
  auto* dv16 = static_cast<__nv_bfloat16*>(c.dv);
  auto blocks = [](long long n4) {
    return (unsigned)std::min<long long>((n4 + 255) / 256, 4096);
  };
  if constexpr (DQK == DV) {
    const long long n4 = (long long)B * Tk * KH * D / 4;
    reduce_kernel<<<dim3(blocks(n4), 2), 256, 0, stream>>>(
        dk_part, dv_part, dk16, dv16, n4, H / KH, D, (float)scale);
  } else {
    // dK and dV of their own widths: one launch each, as blockIdx.y 0
    const long long n4k = (long long)B * Tk * KH * DQK / 4;
    const long long n4v = (long long)B * Tk * KH * DV / 4;
    reduce_kernel<<<dim3(blocks(n4k), 1), 256, 0, stream>>>(
        dk_part, nullptr, dk16, nullptr, n4k, H / KH, DQK, (float)scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    reduce_kernel<<<dim3(blocks(n4v), 1), 256, 0, stream>>>(
        dv_part, nullptr, dv16, nullptr, n4v, H / KH, DV, 1.f);
  }
  return (int)cudaGetLastError();
}

// the kMod instantiation when the call has a window or a soft-cap, and in
// the 64-row kernels always (they have no other)
template <int DQK, int DV>
int launch(const Call& c, int window, float cap, cudaStream_t stream) {
  const double scale = 1.0 / std::sqrt((double)DQK);
  const Mod mod{window > 0 ? window : 1 << 30, cap > 0.f,
                cap > 0.f ? (float)(scale / cap) : 0.f,
                (float)(cap * 1.4426950408889634)};
  if constexpr (DQK == 256 || DQK != DV) {
    return run<DQK, DV, true>(c, mod, stream);
  } else {
    if (window > 0 || cap > 0.f) return run<DQK, DV, true>(c, mod, stream);
    return run<DQK, DV, false>(c, mod, stream);
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// q [B, S, H, D], k [B, T, KH, D] and v [B, T, KH, Dv] through their
// (batch, row, head) strides in elements (the last dimension contiguous);
// o and dout (the forward's output and its gradient) contiguous
// [B, S, H, Dv]; lse the forward's contiguous f32 [B, H, S] row
// log-sum-exp (natural log); dq a contiguous [B, S, H, D], dk a contiguous
// [B, T, KH, D] and dv a contiguous [B, T, KH, Dv], written whole. dtype
// 0: float32, 1: bfloat16. Dv = D in {16, 32, 64, 128, 256}, or (D, Dv) =
// (192, 128) (MLA's); H a multiple of KH; S, T >= 1. window: 0 for none,
// else the forward's (a key is allowed only when qpos - kpos < window);
// cap: 0 for none, else the forward's soft-cap of the scaled scores. bf16
// at D 64, 128 or 256, or at 192 / 128, takes the tensor-core kernels,
// which need 16-byte aligned bases and strides that are multiples of 8
// elements (kernels/flash_attn.py makes them so); everything else the
// scalar kernels. `work` is f32 scratch of the size that
// flash_attention_bwd_work gives. Returns a CUDA error code (0 on
// success; cudaErrorInvalidValue for a pair of widths no kernel takes).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* work, void* dq, void* dk, void* dv, int dtype,
                        int B, int H, int KH, int S, int T, int D, int Dv,
                        long long qsb, long long qss, long long qsh,
                        long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh,
                        int causal, int window, float cap, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(work);
  const tc::Call c{q, k, v, o, dout, l, w, dq, dk, dv, B, H, KH, S, T, st,
                   causal};
  if (dtype == 1 && D == 192 && Dv == 128)
    return tc::launch<192, 128>(c, window, cap, s);
  if (dtype == 1 && D == 256 && Dv == D)
    return tc::launch<256, 256>(c, window, cap, s);
  if (dtype == 1 && D == 128 && Dv == D)
    return tc::launch<128, 128>(c, window, cap, s);
  if (dtype == 1 && D == 64 && Dv == D)
    return tc::launch<64, 64>(c, window, cap, s);
  if (dtype == 0)
    return launch_d<float>(D, Dv, q, k, v, o, dout, l, w, dq, dk, dv, B, H,
                           KH, S, T, st, causal, window, cap, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, Dv, q, k, v, o, dout, l, w, dq, dk,
                                   dv, B, H, KH, S, T, st, causal, window,
                                   cap, s);
  return (int)cudaErrorInvalidValue;
}

// *floats = the f32 scratch flash_attention_bwd needs for these sizes: the
// tensor-core kernels' padded row statistics and per-query-head dK and dV
// partials (2 B H Sp + B T H (D + Dv), Sp = S rounded up to 128), the
// scalar kernels' Dr (B H S). Returns 0.
int flash_attention_bwd_work(int dtype, int B, int H, int S, int T, int D,
                             int Dv, long long* floats) {
  const bool tc = dtype == 1
      && (Dv == D ? D == 64 || D == 128 || D == 256
                  : D == 192 && Dv == 128);
  *floats = tc ? tc::work_floats(B, H, S, T, D, Dv) : (long long)B * H * S;
  return 0;
}

}  // extern "C"
