// ell_pull: the pull-only masked gather row-sum of the ELL low side,
//   out[row] = sum_j c[idx[row, j]] * mask[row, j]
//
// Replaces the TPU kernel `ell_pull` (_kernel) in
// src/repro/kernels/ell_pull.py, which `ell_bucket_pull` and
// `pull_sum_kernels` run once per bucket on the staged sweep.
//
// What bounds it on the H100: bytes. Per slot it reads its index and mask
// (8 B) and gathers one f64 of c at random (33.5 MB at |V| = 4M: about
// what the 50 MB L2 holds beside the streams); per row it writes one f64.
// About two flops per slot, far below the FP64 rate.
//
// Design:
//   * Two entries, one kernel body. `ell_pull_buckets` covers every bucket
//     of the staged sweep in one launch: a by-value descriptor of the
//     buckets (ell_gather.cuh, as fused_ell_update uses it), each block
//     finding its bucket by a scan of the first-block offsets, and writes
//     out[rows_b[s]] through each bucket's row map; a slot whose row is the
//     sentinel n writes nothing. `ell_pull` is the JAX kernel's
//     counterpart, one bucket with the identity map (out[s]). Both run the
//     same body, so they agree bit for bit.
//   * The gather is ell_gather.cuh's: a plan per bucket (template width and
//     lanes per row, 16-byte loads, or the generic loop), every index and
//     mask load of a lane's share started before its gathers, all gathers
//     before the sums; idx and mask streamed past L1 with L2 evict_first,
//     c read with L2 evict_last.
//   * Every row of the table is summed (no affected flag on this path);
//     a block masks its ragged end, so any row count is taken as it is. No
//     atomics; launches on the caller's stream; allocates nothing.
#include "ell_gather.cuh"

namespace {

template <class P, bool MAPPED>
__device__ __forceinline__ void pull_row(const EllBucket& bk, int block,
                                         const double* __restrict__ c,
                                         double* __restrict__ out,
                                         long long n,
                                         const GatherPolicy& pol) {
  constexpr int L = P::kLanes;
  const int lane = threadIdx.x % L;
  const long long s = (long long)block * (kEllBlock / L) + threadIdx.x / L;
  const int* ip = nullptr;
  const float* mp = nullptr;
  long long dst = -1;
  if (s < bk.count) {
    const long long v = MAPPED ? (long long)bk.rows[s] : s;
    if (!MAPPED || v < n) {
      ip = bk.idx + s * bk.width;
      mp = bk.mask + s * bk.width;
      dst = v;
    }
  }
  const double t =
      ell_lanes_sum<L>(ell_row_partial<P>(c, ip, mp, bk.width, lane, pol));
  if (dst >= 0 && lane == 0) out[dst] = t;
}

template <bool MAPPED>
__global__ void __launch_bounds__(kEllBlock)
    ell_pull_kernel(const double* __restrict__ c, const EllBuckets bks,
                    double* __restrict__ out, long long n) {
  const EllBucket bk = ell_find_bucket(bks);
  const int block = (int)blockIdx.x - bk.first_block;
  const GatherPolicy pol = gather_policy();
  with_ell_plan(bk.kind, [&](auto plan) {
    pull_row<decltype(plan), MAPPED>(bk, block, c, out, n, pol);
  });
}

template <bool MAPPED>
int launch_pull(const double* c, int nb, const void* const* ptrs,
                const int* ints, double* out, long long n, int* launched,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const cudaError_t bad = ell_check(nb, ints);
  if (bad != cudaSuccess) return (int)bad;
  for (int j0 = 0; j0 < nb;) {
    EllBuckets bks;
    const int blocks = ell_chunk(nb, ptrs, ints, &j0, &bks);
    if (blocks == 0) continue;
    ell_pull_kernel<MAPPED><<<blocks, kEllBlock, 0, st>>>(c, bks, out, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every bucket in one launch (in chunks of kMaxBuckets for longer
// layouts), through the row maps. ptrs: 4 per bucket (rows, idx, mask,
// null); ints: kBucketInts per bucket (cap, cap, width, plan kind). out
// [n] (or longer) gets each live slot's sum at its row id and is written
// nowhere else. *launched gets the number of kernels started. Returns
// cudaGetLastError().
int ell_pull_buckets(const double* c, int nb, const void* const* ptrs,
                     const int* ints, double* out, int n, int* launched,
                     void* stream) {
  return launch_pull<true>(c, nb, ptrs, ints, out, n, launched, stream);
}

// One bucket's [rows, width] table, identity map: out holds `rows` doubles.
// kind: the plan. *launched gets the number of kernels started. Returns
// cudaGetLastError().
int ell_pull(const double* c, const int* idx, const float* mask, double* out,
             int rows, int width, int kind, int* launched, void* stream) {
  const void* ptrs[4] = {nullptr, idx, mask, nullptr};
  const int ints[kBucketInts] = {rows, rows, width, kind};
  return launch_pull<false>(c, 1, ptrs, ints, out, rows, launched, stream);
}

}  // extern "C"
