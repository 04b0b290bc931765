// linf_delta: the L-inf norm of a rank difference, max_i |a[i] - b[i]|,
// the paper's convergence-detection kernel pair.
//
// Replaces the TPU kernels `linf_delta` (_stage1 and _stage2) in
// src/repro/kernels/linf_delta.py: per-tile partial maxima, then one
// program that reduces the partials.
//
// What bounds it on the H100: bytes — two f64 reads per element, one
// subtraction and one compare each.
//
// Design: the same two stages, both deterministic and atomics-free.
//   stage 1: a grid of at most kFinalBlock blocks walks the vectors with a
//            grid-stride loop (any n >= 1, no padding), and each block
//            writes its maximum into partials[block];
//   stage 2: one block folds the partials (max_partials_kernel).
// Every max lets NaN win (nan_max, epilogue.cuh): CUDA's fmax drops NaN,
// and the health word needs a NaN rank to reach the sweep's L-inf. |x| >= 0,
// so 0 is the identity. Launches on the caller's stream; allocates nothing.
#include "epilogue.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
    linf_partials_kernel(const double* __restrict__ a,
                         const double* __restrict__ b, int n,
                         double* __restrict__ partials) {
  const long long stride = (long long)gridDim.x * kBlock;
  double v = 0.0;
  for (long long i = (long long)blockIdx.x * kBlock + threadIdx.x; i < n;
       i += stride)
    v = nan_max(v, fabs(a[i] - b[i]));
  v = block_max<kBlock>(v);
  if (threadIdx.x == 0) partials[blockIdx.x] = v;
}

}  // namespace

extern "C" {

// Blocks of stage 1 (and partials) for n elements: one per kBlock
// elements, at most kFinalBlock, so stage 2 reads each partial once.
int linf_delta_grid(int n) {
  const int blocks = (n + kBlock - 1) / kBlock;
  return blocks < kFinalBlock ? blocks : kFinalBlock;
}

// partials must hold linf_delta_grid(n) + 1 doubles; the maximum lands in
// the last one. n >= 1. Returns cudaGetLastError().
int linf_delta(const double* a, const double* b, int n, double* partials,
               void* stream) {
  const int grid = linf_delta_grid(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  linf_partials_kernel<<<grid, kBlock, 0, st>>>(a, b, n, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  max_partials_kernel<kFinalBlock><<<1, kFinalBlock, 0, st>>>(
      partials, grid, partials + grid);
  return (int)cudaGetLastError();
}

}  // extern "C"
