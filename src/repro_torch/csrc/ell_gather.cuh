// Shared gather body of the ELL kernels (ell_pull.cu and
// fused_ell_update.cu): the masked row-sum  s = sum_j c[idx[row, j]] *
// mask[row, j]  of one degree bucket's [rows, width] slot table, and the
// by-value descriptor of the buckets that one launch covers. Its hinted
// loads (past L1, with an L2 policy) also serve csr_block_pull.cu and
// linf_delta.cu.
//
// What bounds it on the H100: the random gathers of c (8 B used of every
// 32 B sector they touch) and the stream of idx and mask (8 B per slot,
// read once). The design keeps many gathers in flight and keeps the
// streams from pushing c out of L2:
//   * A bucket's plan (`ell_plan` in kernels/gather_plan.py, the one place
//     that picks it) names a template width W and LANES threads per row.
//     Each lane owns K = W / LANES slots of its row, in chunks of 4 at
//     slots ((q LANES + lane) * 4 .. + 3), so neighbouring lanes read
//     neighbouring 16-byte words (below width 4 one lane owns the row and
//     reads it 4 bytes at a time). It loads every index and mask bit of its
//     share first, one 16-byte load per chunk, then starts all K gathers
//     of c, then sums them in slot order. A template of a width % 4 == 0
//     runs only on a 16-byte aligned table; the host sends any other table
//     to the generic loop.
//   * The generic loop takes any width: LANES lanes (`lanes_for`) step
//     through the row, lane, lane + LANES, ...
//   * idx and mask are read once: ld.global.nc with L1::no_allocate and an
//     L2 evict_first policy. c goes through the read-only path with an L2
//     evict_last policy, which keeps it ahead of the streams. These are
//     per-load hints; no device-wide cache setting is touched.
//   * The lanes of a row fold their partial sums with a fixed xor tree, so
//     the order is the same on every run. Every slot adds c[idx] * mask,
//     padding included, as the TPU kernels do: a NaN in c reaches every
//     row whose table names it.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// Threads per block of every ELL kernel: a block covers kEllBlock / LANES
// rows of one bucket.
constexpr int kEllBlock = 256;

// The instantiated plans, ELL_PLANS(X) calling X(kind, W, LANES, VEC) for
// each: generated from kernels/gather_plan.py into the build's include
// directory (kernels/_build.py), so the host can pick no plan the kernels
// lack. W = 0 is the generic loop over a runtime width.
#include "ell_plans.h"

template <int W, int LANES, bool VEC>
struct EllPlan {
  static constexpr int kWidth = W;
  static constexpr int kLanes = LANES;
  static constexpr bool kVec = VEC;
  static_assert(kEllBlock % LANES == 0 && 32 % LANES == 0, "lanes");
  static_assert(W == 0 || (W % LANES == 0 &&
                           (VEC ? (W / LANES) % 4 == 0 : LANES == 1)),
                "a lane owns whole 16-byte chunks, or the whole row");
  static_assert(W != 0 || !VEC, "the generic loop reads 4 bytes a slot");
};

// The lanes per row of plan `kind`, or 0 if there is no such plan.
inline int ell_plan_lanes(int kind) {
#define ELL_LANES(k, W, L, V) \
  if (kind == k) return L;
  ELL_PLANS(ELL_LANES)
#undef ELL_LANES
  return 0;
}

// Whether plan `kind` exists and runs a table of `width`.
inline bool ell_plan_fits(int kind, int width) {
#define ELL_FITS(k, W, L, V) \
  if (kind == k) return W == 0 || W == width;
  ELL_PLANS(ELL_FITS)
#undef ELL_FITS
  return false;
}

// Calls f(EllPlan<...>{}) for the plan of `kind`: a block-uniform switch.
template <class F>
__device__ __forceinline__ void with_ell_plan(int kind, F&& f) {
  switch (kind) {
#define ELL_CASE(k, W, L, V) \
  case k:                    \
    f(EllPlan<W, L, V>{});   \
    break;
    ELL_PLANS(ELL_CASE)
#undef ELL_CASE
    default:
      break;
  }
}

// ---- loads -----------------------------------------------------------------

struct GatherPolicy {
  uint64_t stream;  // idx and mask: L2 evict_first
  uint64_t c;       // c: L2 evict_last
};

__device__ __forceinline__ GatherPolicy gather_policy() {
  GatherPolicy p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
      : "=l"(p.stream));
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p.c));
  return p;
}

__device__ __forceinline__ int ld_stream(const int* q, uint64_t pol) {
  int v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v) : "l"(q), "l"(pol));
  return v;
}

__device__ __forceinline__ float ld_stream(const float* q, uint64_t pol) {
  float v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v) : "l"(q), "l"(pol));
  return v;
}

__device__ __forceinline__ void ld_stream4(const int* q, uint64_t pol,
                                           int* v) {
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.b32 {%0, %1, %2, %3},"
      " [%4], %5;"
      : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]) : "l"(q), "l"(pol));
}

__device__ __forceinline__ void ld_stream4(const float* q, uint64_t pol,
                                           float* v) {
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 {%0, %1, %2, %3},"
      " [%4], %5;"
      : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "l"(q), "l"(pol));
}

__device__ __forceinline__ double ld_stream(const double* q, uint64_t pol) {
  double v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.f64 %0, [%1], %2;"
      : "=d"(v) : "l"(q), "l"(pol));
  return v;
}

__device__ __forceinline__ double2 ld_stream2(const double* q, uint64_t pol) {
  double2 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v2.f64 {%0, %1}, [%2], %3;"
      : "=d"(v.x), "=d"(v.y) : "l"(q), "l"(pol));
  return v;
}

__device__ __forceinline__ double ld_c(const double* q, uint64_t pol) {
  double v;
  asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;"
      : "=d"(v) : "l"(q), "l"(pol));
  return v;
}

// Loads K index and mask values of one lane's share of a row (ip, mp at the
// row's start): chunks of 4 at ((q LANES + lane) * 4), 16 bytes at a time
// when VEC, else the whole row (LANES == 1) 4 bytes at a time.
template <int LANES, int K, bool VEC>
__device__ __forceinline__ void load_share(const int* ip, const float* mp,
                                           int lane, uint64_t pol, int* id,
                                           float* mk) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const int at = (q * LANES + lane) * 4;
      ld_stream4(ip + at, pol, id + 4 * q);
      ld_stream4(mp + at, pol, mk + 4 * q);
    }
  } else {
#pragma unroll
    for (int e = 0; e < K; ++e) {
      id[e] = ld_stream(ip + e, pol);
      mk[e] = ld_stream(mp + e, pol);
    }
  }
}

// This lane's partial sum of a row: ip / mp point at the row's table row,
// or are null for a row that reads nothing (its partial is then 0).
// `width` is read by the generic plan only.
template <class P>
__device__ __forceinline__ double ell_row_partial(
    const double* __restrict__ c, const int* ip, const float* mp, int width,
    int lane, const GatherPolicy& pol) {
  constexpr int L = P::kLanes;
  double acc = 0.0;
  if (ip == nullptr) return acc;
  if constexpr (P::kWidth == 0) {
#pragma unroll 4
    for (int j = lane; j < width; j += L)
      acc += ld_c(c + ld_stream(ip + j, pol.stream), pol.c) *
             (double)ld_stream(mp + j, pol.stream);
  } else {
    constexpr int K = P::kWidth / L;
    int id[K];
    float mk[K];
    load_share<L, K, P::kVec>(ip, mp, lane, pol.stream, id, mk);
    double cv[K];
#pragma unroll
    for (int e = 0; e < K; ++e) cv[e] = ld_c(c + id[e], pol.c);
#pragma unroll
    for (int e = 0; e < K; ++e) acc += cv[e] * (double)mk[e];
  }
  return acc;
}

// Fold the LANES partials of a row; every lane gets the row's sum. Every
// thread of the warp must call it (rows past the end with s = 0).
template <int LANES>
__device__ __forceinline__ double ell_lanes_sum(double s) {
  if (LANES > 1) {
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off, LANES);
  }
  return s;
}

// ---- the buckets of one launch ------------------------------------------------

constexpr int kMaxBuckets = 8;
// ints per bucket from the host: work lanes, cap, width, plan kind
constexpr int kBucketInts = 4;

struct EllBucket {
  const int* rows;    // [cap] vertex ids, sentinel n; null: identity map
  const int* idx;     // [cap, width]
  const float* mask;  // [cap, width]
  const int* sel;     // [count] active slots, sentinel cap; null: dense
  int count;          // work lanes: cap (dense) or the list's length
  int cap;
  int width;
  int kind;           // ELL_PLANS entry
  int first_block;
};

struct EllBuckets {
  EllBucket b[kMaxBuckets];
  int nb;
};

// Blocks of bucket j of the host tables (kBucketInts ints per bucket): a
// block covers kEllBlock / lanes work lanes.
inline int ell_bucket_blocks(const int* ints, int j) {
  const int* b = ints + kBucketInts * j;
  const int lanes = ell_plan_lanes(b[3]);
  if (b[0] <= 0 || lanes <= 0) return 0;
  const int per = kEllBlock / lanes;
  return (b[0] + per - 1) / per;
}

// Refuses bad plans and counts: cudaErrorInvalidValue, else cudaSuccess.
inline cudaError_t ell_check(int nb, const int* ints) {
  for (int j = 0; j < nb; ++j) {
    const int* b = ints + kBucketInts * j;
    if (b[0] < 0 || !ell_plan_fits(b[3], b[2]))
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// Fills `bks` from bucket j0 on (skipping empty ones) until it holds
// kMaxBuckets; returns the blocks of the chunk and advances j0. ptrs: 4
// per bucket (rows, idx, mask, active list; rows and list may be null).
inline int ell_chunk(int nb, const void* const* ptrs, const int* ints,
                     int* j0, EllBuckets* bks) {
  *bks = EllBuckets{};
  int blocks = 0;
  for (; *j0 < nb && bks->nb < kMaxBuckets; ++*j0) {
    const int j = *j0;
    const int nblk = ell_bucket_blocks(ints, j);
    if (nblk == 0) continue;
    const int* b = ints + kBucketInts * j;
    EllBucket& bk = bks->b[bks->nb++];
    bk.rows = static_cast<const int*>(ptrs[4 * j]);
    bk.idx = static_cast<const int*>(ptrs[4 * j + 1]);
    bk.mask = static_cast<const float*>(ptrs[4 * j + 2]);
    bk.sel = static_cast<const int*>(ptrs[4 * j + 3]);
    bk.count = b[0];
    bk.cap = b[1];
    bk.width = b[2];
    bk.kind = b[3];
    bk.first_block = blocks;
    blocks += nblk;
  }
  return blocks;
}

// This block's bucket, selected with static indices only (no dynamic
// indexing into the parameter struct, which may go through local memory).
__device__ __forceinline__ EllBucket ell_find_bucket(const EllBuckets& bks) {
  EllBucket bk = bks.b[0];
#pragma unroll
  for (int j = 1; j < kMaxBuckets; ++j)
    if (j < bks.nb && (int)blockIdx.x >= bks.b[j].first_block) bk = bks.b[j];
  return bk;
}
