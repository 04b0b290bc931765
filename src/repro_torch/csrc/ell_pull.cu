// ell_pull: the pull-only masked gather row-sum over one degree bucket,
//   out[row] = sum_j c[idx[row, j]] * mask[row, j]
//
// Replaces the TPU kernel `ell_pull` (_kernel) in
// src/repro/kernels/ell_pull.py, which `ell_bucket_pull` and
// `pull_sum_kernels` run once per bucket on the staged sweep.
//
// What bounds it on the H100: bytes. Per row it reads its w_b indices and
// mask bits (8 B per slot), gathers w_b entries of c at random (8 B per
// vertex; 32 MB at |V| = 4M, held in the 50 MB L2) and writes one f64.
// About two flops per slot, far below the FP64 rate.
//
// Design: the gather body of fused_ell_update (ell_gather.cuh) without
// its epilogue — LANES threads per row, one per row for widths <= 2, a
// sub-warp of up to 32 lanes otherwise, folded by a fixed xor tree. Every
// row is summed: there is no affected flag on this path. The TPU kernel
// pads the rows to whole tiles of vt; here a block masks its ragged end,
// so any row count is taken as it is. No atomics; launches on the
// caller's stream; allocates nothing.
#include "ell_gather.cuh"

namespace {

template <int LANES>
__global__ void __launch_bounds__(kEllBlock)
    ell_pull_kernel(const double* __restrict__ c, const int* __restrict__ idx,
                    const float* __restrict__ mask, double* __restrict__ out,
                    int rows, int width) {
  int lane;
  const long long row = ell_row<LANES>(&lane);
  double s = 0.0;
  if (row < rows)
    s = ell_row_partial<LANES>(c, idx + row * width, mask + row * width,
                               width, lane);
  s = ell_lanes_sum<LANES>(s);
  if (row < rows && lane == 0) out[row] = s;
}

}  // namespace

extern "C" {

// out holds `rows` doubles. Returns cudaGetLastError().
int ell_pull(const double* c, const int* idx, const float* mask, double* out,
             int rows, int width, int lanes, void* stream) {
  const int grid = ell_grid(rows, lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_lanes(lanes, [&](auto L) {
    ell_pull_kernel<decltype(L)::value><<<grid, kEllBlock, 0, st>>>(
        c, idx, mask, out, rows, width);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
