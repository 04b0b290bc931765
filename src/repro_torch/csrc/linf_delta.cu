// linf_delta: the L-inf norm of a rank difference, max_i |a[i] - b[i]|,
// the paper's convergence-detection kernel pair.
//
// Replaces the TPU kernels `linf_delta` (_stage1 and _stage2) in
// src/repro/kernels/linf_delta.py: per-tile partial maxima, then one
// program that reduces the partials.
//
// What bounds it on the H100: bytes. Two f64 reads per element, one
// subtraction and one compare each: 67 MB at |V| = 4M, 0.020 ms at the
// byte rate.
//
// Design: the same two stages, both deterministic and atomics-free.
//   stage 1: a grid sized to the card (SMs x resident blocks, from the
//            occupancy query, which the host takes once per device) walks
//            both vectors. Each thread loads kUnroll 16-byte words
//            (double2) of each vector per step, 2 kUnroll loads in flight,
//            neighbouring threads on neighbouring words; the loads go past
//            L1 with an L2 evict_first policy (ell_gather.cuh), since each
//            byte is read once. A view 8 bytes off a 16-byte boundary
//            starts with one scalar element and an odd remainder ends with
//            one; when a and b sit at different offsets from a 16-byte
//            boundary, the kernel reads 8 bytes at a time. Each block
//            writes its maximum into partials[block];
//   stage 2: one block folds the partials (max_partials_kernel): at most
//            the grid, a few hundred.
// Every max lets NaN win (nan_max, epilogue.cuh): CUDA's fmax drops NaN,
// and the health word needs a NaN rank to reach the sweep's L-inf. |x| >= 0,
// so 0 is the identity. Launches on the caller's stream; allocates nothing.
#include <cstdint>

#include "ell_gather.cuh"
#include "epilogue.cuh"

namespace {

constexpr int kBlock = 512;
constexpr int kUnroll = 2;
// elements of each vector a block covers in one step
constexpr int kStep = 2 * kBlock * kUnroll;

// VEC: a and b at the same offset from a 16-byte boundary; `head` (0 or 1)
// elements come before the first 16-byte word.
template <bool VEC>
__global__ void __launch_bounds__(kBlock)
    linf_partials_kernel(const double* __restrict__ a,
                         const double* __restrict__ b, long long n, int head,
                         double* __restrict__ partials) {
  const uint64_t pol = gather_policy().stream;
  double v = 0.0;
  if constexpr (VEC) {
    const long long words = (n - head) / 2;
    const double* a2 = a + head;
    const double* b2 = b + head;
    const long long stride = (long long)gridDim.x * kBlock * kUnroll;
    for (long long j0 = (long long)blockIdx.x * kBlock * kUnroll + threadIdx.x;
         j0 < words; j0 += stride) {
      double2 x[kUnroll], y[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = j0 + (long long)u * kBlock;
        x[u] = y[u] = make_double2(0.0, 0.0);
        if (j < words) {
          x[u] = ld_stream2(a2 + 2 * j, pol);
          y[u] = ld_stream2(b2 + 2 * j, pol);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v = nan_max(v, fabs(x[u].x - y[u].x));
        v = nan_max(v, fabs(x[u].y - y[u].y));
      }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      if (head) v = nan_max(v, fabs(a[0] - b[0]));
      if ((n - head) & 1) v = nan_max(v, fabs(a[n - 1] - b[n - 1]));
    }
  } else {
    constexpr int kLoads = 2 * kUnroll;
    const long long stride = (long long)gridDim.x * kBlock * kLoads;
    for (long long i0 = (long long)blockIdx.x * kBlock * kLoads + threadIdx.x;
         i0 < n; i0 += stride) {
      double x[kLoads], y[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const long long i = i0 + (long long)u * kBlock;
        x[u] = y[u] = 0.0;
        if (i < n) {
          x[u] = ld_stream(a + i, pol);
          y[u] = ld_stream(b + i, pol);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) v = nan_max(v, fabs(x[u] - y[u]));
    }
  }
  v = block_max<kBlock>(v);
  if (threadIdx.x == 0) partials[blockIdx.x] = v;
}

}  // namespace

extern "C" {

// Stage 1's largest grid on `device`: its SMs times the blocks of stage 1
// resident on one SM. The partials hold this + 1 doubles. 0 on an error.
int linf_delta_max_grid(int device) {
  void (*kernel)(const double*, const double*, long long, int, double*) =
      linf_partials_kernel<true>;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock,
                                                    0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// max |a - b| over n >= 1 elements of two 8-byte aligned vectors into
// partials[max_grid] (max_grid from linf_delta_max_grid; the partials hold
// max_grid + 1 doubles). Returns cudaGetLastError().
int linf_delta(const double* a, const double* b, int n, int max_grid,
               double* partials, void* stream) {
  if (n < 1 || max_grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long need = ((long long)n + kStep - 1) / kStep;
  const int grid = need < max_grid ? (int)need : max_grid;
  const uintptr_t off_a = reinterpret_cast<uintptr_t>(a) & 15;
  const uintptr_t off_b = reinterpret_cast<uintptr_t>(b) & 15;
  if (off_a == off_b)
    linf_partials_kernel<true><<<grid, kBlock, 0, st>>>(
        a, b, n, off_a != 0 ? 1 : 0, partials);
  else
    linf_partials_kernel<false><<<grid, kBlock, 0, st>>>(a, b, n, 0,
                                                          partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  max_partials_kernel<kFinalBlock><<<1, kFinalBlock, 0, st>>>(
      partials, grid, nullptr, partials + max_grid);
  return (int)cudaGetLastError();
}

}  // extern "C"
