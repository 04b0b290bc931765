// Shared gather body of the ELL kernels (fused_ell_update.cu and
// ell_pull.cu): the masked row-sum  s = sum_j c[idx[row, j]] * mask[row, j]
// of one degree bucket's [rows, width] slot table.
//
// LANES threads own a row: one thread per row for the narrowest buckets
// (the paper's thread-per-vertex kernel), otherwise a sub-warp of the
// largest power of two up to min(width, 32) (`lanes_for` in
// kernels/ell_pull.py picks it). The lanes of a row read
// neighbouring slots, so the index and mask loads coalesce, and fold their
// partial sums with a fixed xor tree, so the order is the same on every
// run. Every slot adds c[idx] * mask, padding included, as the TPU kernels
// do: a NaN in c reaches every row whose table names it.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

// Rows per block of every ELL kernel: kEllBlock / LANES.
constexpr int kEllBlock = 256;

// This lane's share of one row's sum: slots lane, lane + LANES, ...
template <int LANES>
__device__ __forceinline__ double ell_row_partial(
    const double* __restrict__ c, const int* __restrict__ ip,
    const float* __restrict__ mp, int width, int lane) {
  double s = 0.0;
  for (int j = lane; j < width; j += LANES) s += c[ip[j]] * (double)mp[j];
  return s;
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

// The row this thread works on, and its lane within the row.
template <int LANES>
__device__ __forceinline__ long long ell_row(int* lane) {
  *lane = threadIdx.x % LANES;
  return (long long)blockIdx.x * (kEllBlock / LANES) + threadIdx.x / LANES;
}

// Blocks for `rows` rows at `lanes` lanes per row.
inline int ell_grid(int rows, int lanes) {
  const int per = kEllBlock / lanes;
  return (rows + per - 1) / per;
}

// Calls f(std::integral_constant<int, L>{}) for L == lanes, so a launch
// site instantiates its kernel once per lane count. Lanes other than 1, 2,
// 4, 8, 16 or 32 are refused with cudaErrorInvalidValue.
template <class F>
inline cudaError_t with_lanes(int lanes, F&& f) {
  switch (lanes) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    case 16: f(std::integral_constant<int, 16>{}); break;
    case 32: f(std::integral_constant<int, 32>{}); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}
