// pr_update: the Alg. 3 epilogue over pre-reduced sums, the high in-degree
// side of one fused sweep.
//
// Replaces the TPU kernel `pr_update` (_kernel) in
// src/repro/kernels/pr_update.py, which runs over operands gathered
// beforehand per slot and returns per-slot outputs for the caller to
// scatter.
//
// What bounds it on the H100: launches. Per high slot it reads the slot's
// vertex id (4 B) and sum (8 B) and, at that vertex, r (8 B), out_deg
// (4 B) and affected (1 B), and writes r_new (8 B) and two 1 B flags:
// 2.4 MB a sweep at |V| = 4M (67,405 slots), under a microsecond at the
// byte rate, or about 13 MB of 32 B sectors since the reads at v are
// random. A few flops each.
//
// Design:
//   * The sweep entry (pr_update_sweep) runs through the slot->vertex map.
//     Work lane i is slot s = i, or s = sel[i] over an active list; it
//     reads v = ids[s], sums[s], and r[v] (f64), out_deg[v] (int32) and
//     affected[v] (bool), and writes r_new[v], aff_new[v] and dn[v] (bool)
//     in place. A sentinel (v == n, an unused slot; s == cap, a dead lane
//     of the list) does nothing and adds 0 to the L-inf. So the sweep has
//     no gathered operand, per-slot output or scatter around the kernel.
//   * The per-slot entry (pr_update, the TPU kernel's counterpart) runs
//     the same body with the identity map: f64 operands and outputs per
//     slot, pad lanes (r = 1, deg = 1, aff = 0) inert. The epilogue is
//     epilogue.cuh's, shared with fused_ell_update, so the two maps and
//     the two kernels agree bit for bit.
//   * Each block writes its max |dr| into partials; one block folds them,
//     starting from `prior` when it is given (the low side's max, read on
//     the device), so one fold gives the sweep's L-inf over both halves.
//     NaN wins. No atomics. Launches on the caller's stream; allocates
//     nothing.
#include "epilogue.cuh"

namespace {

constexpr int kBlock = 256;

int grid_for(int count) { return (count + kBlock - 1) / kBlock; }

template <bool MAPPED, class Deg, class Flag>
__global__ void __launch_bounds__(kBlock)
    pr_update_kernel(const double* __restrict__ sums,
                     const int* __restrict__ ids, const int* __restrict__ sel,
                     int count, int cap, const Operands<Deg, Flag> o,
                     const EpiParams p, double* __restrict__ partials) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  double dr = 0.0;
  if (i < count) {
    const long long s = sel != nullptr ? (long long)sel[i] : i;
    if (s < cap) {
      const long long v = MAPPED ? (long long)ids[s] : s;
      if (!MAPPED || v < o.n) {
        const EpiOut e = pr_epilogue(sums[s], o.r[v], (double)o.deg[v],
                                     (double)o.aff[v], p);
        const long long w = MAPPED ? v : i;
        o.r_new[w] = e.r_new;
        o.aff_new[w] = (Flag)e.aff;
        o.dn[w] = (Flag)e.dn;
        dr = e.dr;
      }
    }
  }
  dr = block_max<kBlock>(dr);
  if (threadIdx.x == 0) partials[blockIdx.x] = dr;
}

// The kernel over `count` work lanes (none when count is 0), then the fold
// of its partials, and of prior when not null, into partials[grid].
template <bool MAPPED, class Deg, class Flag>
int launch(const double* sums, const int* ids, const int* sel, int count,
           int cap, const Operands<Deg, Flag>& o, const double* prior,
           double* partials, const EpiParams& p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(count);
  if (grid > 0) {
    pr_update_kernel<MAPPED, Deg, Flag><<<grid, kBlock, 0, st>>>(
        sums, ids, sel, count, cap, o, p, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  max_partials_kernel<kFinalBlock><<<1, kFinalBlock, 0, st>>>(
      partials, grid, prior, partials + grid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of a launch over `count` work lanes: the partials hold this + 1.
int pr_update_grid(int count) { return grid_for(count); }

// The per-slot entry, identity map: n slots, every operand and output f64
// per slot. The max |dr| lands in partials[pr_update_grid(n)]. Returns
// cudaGetLastError().
int pr_update(const double* contrib, const double* r, const double* deg,
              const double* aff, double* r_new, double* aff_new, double* dn,
              double* partials, int n, double alpha, double c0, double tau_f,
              double tau_p, int prune, int closed_form, void* stream) {
  const EpiParams p{alpha, c0, tau_f, tau_p, prune, closed_form};
  const Operands<double, double> o{r, deg, aff, r_new, aff_new, dn, n};
  return launch<false>(contrib, nullptr, nullptr, n, n, o, nullptr, partials,
                       p, stream);
}

// The sweep entry, through the slot->vertex map: sums and ids [cap] (ids
// int32, sentinel n), sel the [count] active list (sentinel cap) or null
// with count = cap; r [n] f64, deg [n] int32, aff [n] bool; r_new (f64),
// aff_new and dn (bool) are written at every live vertex id and nowhere
// else. prior: a device double folded into the max, or null. The max |dr|
// lands in partials[pr_update_grid(count)]. Returns cudaGetLastError().
int pr_update_sweep(const double* sums, const int* ids, const int* sel,
                    int count, int cap, const double* r, const int* deg,
                    const unsigned char* aff, double* r_new,
                    unsigned char* aff_new, unsigned char* dn, int n,
                    const double* prior, double* partials, double alpha,
                    double c0, double tau_f, double tau_p, int prune,
                    int closed_form, void* stream) {
  const EpiParams p{alpha, c0, tau_f, tau_p, prune, closed_form};
  const Operands<int, unsigned char> o{r, deg, aff, r_new, aff_new, dn, n};
  return launch<true>(sums, ids, sel, count, cap, o, prior, partials, p,
                      stream);
}

}  // extern "C"
