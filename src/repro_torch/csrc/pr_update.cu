// pr_update: the Alg. 3 epilogue over pre-reduced sums (the high in-degree
// slots of one sweep).
//
// Replaces the TPU kernel `pr_update` (_kernel) in
// src/repro/kernels/pr_update.py.
//
// What bounds it on the H100: bytes — four f64 inputs and three f64
// outputs per element, a handful of flops each.
//
// Design: one thread per element running the same __device__ epilogue as
// fused_ell_update (epilogue.cuh), so the two kernels cannot drift apart;
// the L-inf |dr| is reduced per block into partials and folded by a second
// one-block pass (NaN wins, no atomics). Launches on the caller's stream;
// allocates nothing.
#include "epilogue.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
    pr_update_kernel(const double* __restrict__ contrib,
                     const double* __restrict__ r,
                     const double* __restrict__ deg,
                     const double* __restrict__ aff,
                     double* __restrict__ r_new, double* __restrict__ aff_new,
                     double* __restrict__ dn, double* __restrict__ partials,
                     int n, EpiParams p) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  double dr = 0.0;
  if (i < n) {
    const EpiOut o = pr_epilogue(contrib[i], r[i], deg[i], aff[i], p);
    r_new[i] = o.r_new;
    aff_new[i] = o.aff;
    dn[i] = o.dn;
    dr = o.dr;
  }
  dr = block_max<kBlock>(dr);
  if (threadIdx.x == 0) partials[blockIdx.x] = dr;
}

}  // namespace

extern "C" {

int pr_update_grid(int n) { return (n + kBlock - 1) / kBlock; }

// partials must hold pr_update_grid(n) + 1 doubles; the max |dr| lands in
// the last one. Returns cudaGetLastError().
int pr_update(const double* contrib, const double* r, const double* deg,
              const double* aff, double* r_new, double* aff_new, double* dn,
              double* partials, int n, double alpha, double c0, double tau_f,
              double tau_p, int prune, int closed_form, void* stream) {
  const EpiParams p{alpha, c0, tau_f, tau_p, prune, closed_form};
  const int grid = pr_update_grid(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pr_update_kernel<<<grid, kBlock, 0, st>>>(contrib, r, deg, aff, r_new,
                                            aff_new, dn, partials, n, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  max_partials_kernel<kFinalBlock><<<1, kFinalBlock, 0, st>>>(
      partials, grid, partials + grid);
  return (int)cudaGetLastError();
}

}  // extern "C"
