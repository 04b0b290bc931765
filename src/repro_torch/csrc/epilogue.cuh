// Shared device code of the rank-sweep kernels (fused_ell_update.cu,
// pr_update.cu and linf_delta.cu): the one Alg. 3 epilogue the first two
// run, the operands it reads through a row map or per slot, and the
// NaN-propagating max reductions behind every L-inf partial.
//
// The epilogue is the CUDA spelling of core/rank_step.py: Eq. 1, or the
// closed form Eq. 2 that absorbs the guaranteed self-loop, then
//   affected' = affected && !(|dr| / max(r', r) <= tau_p)   (when prune)
//   delta_N   = |dr| / max(r', r) > tau_f
// Build with --fmad=false: each multiply and add then rounds on its own,
// as the plain PyTorch version's separate elementwise ops do, so the
// epilogue gives the same bits as the plain version on the same sums.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

struct EpiParams {
  double alpha;  // damping
  double c0;     // teleport (1 - alpha) / N
  double tau_f;  // frontier threshold
  double tau_p;  // pruning threshold
  int prune;
  int closed_form;
};

struct EpiOut {
  double r_new, aff, dn, dr;
};

// The epilogue's operands and outputs: per vertex through a row map (Deg
// int, Flag unsigned char holding a bool), or per slot for the identity
// map (Deg and Flag double).
template <class Deg, class Flag>
struct Operands {
  const double* r;
  const Deg* deg;
  const Flag* aff;
  double* r_new;
  Flag* aff_new;
  Flag* dn;
  long long n;  // the row map's sentinel vertex id
};

// max that lets NaN win. fmax drops NaN; the health word needs a NaN rank
// to reach the sweep's L-inf delta, so every reduction here uses this.
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a > b || a != a) ? a : b;
}

// One vertex: pulled sum s, old rank r, out-degree d, affected flag aff
// (0.0 or 1.0). Pad lanes carry r = 1, d = 1, aff = 0 and come out inert
// (r' = r, dr = 0, flags 0).
__device__ __forceinline__ EpiOut pr_epilogue(double s, double r, double d,
                                              double aff,
                                              const EpiParams& p) {
  const bool on = aff > 0.0;
  const double rv = p.closed_form
                        ? (p.c0 + p.alpha * (s - r / d)) / (1.0 - p.alpha / d)
                        : p.c0 + p.alpha * s;
  EpiOut o;
  o.r_new = on ? rv : r;
  o.dr = fabs(o.r_new - r);
  const double rel = o.dr / nan_max(o.r_new, r);
  const bool keep = p.prune ? (on && !(rel <= p.tau_p)) : on;
  o.aff = keep ? 1.0 : 0.0;
  o.dn = (rel > p.tau_f) ? 1.0 : 0.0;
  return o;
}

// Max of v over the block; the result is valid in thread 0. Every thread
// of the block must call it. BLOCK is a multiple of 32, at most 1024.
template <int BLOCK>
__device__ __forceinline__ double block_max(double v) {
  __shared__ double warp_max[BLOCK / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < BLOCK / 32 ? warp_max[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Second pass of a max: one block folds the per-block partials, and
// prior[0] when prior is not null, into out[0]. |dr| >= 0, so 0 is the
// identity.
template <int BLOCK>
__global__ void __launch_bounds__(BLOCK)
    max_partials_kernel(const double* __restrict__ partials, int n,
                        const double* __restrict__ prior,
                        double* __restrict__ out) {
  double v = (prior != nullptr && threadIdx.x == 0) ? prior[0] : 0.0;
  for (int i = threadIdx.x; i < n; i += BLOCK) v = nan_max(v, partials[i]);
  v = block_max<BLOCK>(v);
  if (threadIdx.x == 0) out[0] = v;
}

constexpr int kFinalBlock = 1024;
