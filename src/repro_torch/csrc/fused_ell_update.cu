// fused_ell_update: one degree bucket of the ELL low side, pull and
// Alg. 3 epilogue in one pass.
//
// Replaces the TPU kernel `fused_ell_update` (_fused_kernel) in
// src/repro/kernels/ell_bucket_pull.py.
//
// What bounds it on the H100: bytes. Per row it reads its w_b indices and
// mask bits (8 B per slot), gathers w_b ranks c[idx] at random (c is the
// 8 B/vertex contribution vector; at |V| = 4M it is 32 MB and stays in the
// 50 MB L2), and writes three f64 outputs. About two flops per slot, far
// below the FP64 rate.
//
// Design:
//   * LANES threads per row, with the gather body it shares with ell_pull
//     (ell_gather.cuh): LANES = 1 (thread per row, the paper's
//     thread-per-vertex kernel) for the narrowest buckets; otherwise a
//     sub-warp of up to 32 lanes that read neighbouring slots of one row,
//     so the index and mask loads coalesce, and sum with __shfl_xor_sync.
//   * Each row reads its affected flag first. An unaffected row skips its
//     gather and writes r, 0, 0 with |dr| = |r - r| (0, or NaN for a NaN
//     rank) — the same bits the TPU kernel's where(aff, rv, r) gives, and
//     on the card it is DF-P's "process only affected vertices" without
//     any compaction.
//   * Every slot of an affected row, padding included, adds c[idx] * mask,
//     as the TPU kernel does, so a NaN c[0] reaches padded rows alike.
//   * The L-inf |dr| is reduced per block into partials, then a second
//     one-block pass folds them; NaN wins. No atomics anywhere.
//   * Launches on the caller's stream; allocates nothing.
#include "ell_gather.cuh"
#include "epilogue.cuh"

namespace {

template <int LANES>
__global__ void __launch_bounds__(kEllBlock)
    fused_ell_kernel(const double* __restrict__ c, const int* __restrict__ idx,
                     const float* __restrict__ mask,
                     const double* __restrict__ r,
                     const double* __restrict__ deg,
                     const double* __restrict__ aff,
                     double* __restrict__ r_new, double* __restrict__ aff_new,
                     double* __restrict__ dn, double* __restrict__ partials,
                     int rows, int width, EpiParams p) {
  int lane;
  const long long row = ell_row<LANES>(&lane);
  const bool valid = row < rows;

  double rr = 1.0, d = 1.0, a = 0.0, s = 0.0;
  if (valid) {
    a = aff[row];
    rr = r[row];
    d = deg[row];
    if (a > 0.0)
      s = ell_row_partial<LANES>(c, idx + row * width, mask + row * width,
                                 width, lane);
  }
  s = ell_lanes_sum<LANES>(s);
  double dr = 0.0;
  if (valid) {
    const EpiOut o = pr_epilogue(s, rr, d, a, p);
    if (lane == 0) {
      r_new[row] = o.r_new;
      aff_new[row] = o.aff;
      dn[row] = o.dn;
    }
    dr = o.dr;
  }
  dr = block_max<kEllBlock>(dr);
  if (threadIdx.x == 0) partials[blockIdx.x] = dr;
}

}  // namespace

extern "C" {

// Number of blocks (and of max partials) for `rows` rows at `lanes` lanes.
int fused_ell_update_grid(int rows, int lanes) {
  return ell_grid(rows, lanes);
}

// partials must hold fused_ell_update_grid(rows, lanes) + 1 doubles; the
// bucket's max |dr| lands in the last one. Returns cudaGetLastError().
int fused_ell_update(const double* c, const int* idx, const float* mask,
                     const double* r, const double* deg, const double* aff,
                     double* r_new, double* aff_new, double* dn,
                     double* partials, int rows, int width, int lanes,
                     double alpha, double c0, double tau_f, double tau_p,
                     int prune, int closed_form, void* stream) {
  const EpiParams p{alpha, c0, tau_f, tau_p, prune, closed_form};
  const int grid = ell_grid(rows, lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_lanes(lanes, [&](auto L) {
    fused_ell_kernel<decltype(L)::value><<<grid, kEllBlock, 0, st>>>(
        c, idx, mask, r, deg, aff, r_new, aff_new, dn, partials, rows, width,
        p);
  });
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  max_partials_kernel<kFinalBlock><<<1, kFinalBlock, 0, st>>>(
      partials, grid, partials + grid);
  return (int)cudaGetLastError();
}

}  // extern "C"
