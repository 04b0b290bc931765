// fused_ell_update: the ELL low side of one rank sweep (every degree
// bucket's pull and Alg. 3 epilogue) in one launch, then one fold of the
// L-inf partials.
//
// Replaces the TPU kernel `fused_ell_update` (_fused_kernel) in
// src/repro/kernels/ell_bucket_pull.py, which runs one bucket per call on
// operands gathered beforehand at the bucket's row ids.
//
// What bounds it on the H100: bytes. Per slot it reads its index and mask
// (8 B), gathers c[idx] at random (c is the 8 B/vertex contribution
// vector; at |V| = 4M it is 33.5 MB of the 50 MB L2); per row the
// row id (4 B), r (8 B), out_deg (4 B) and affected (1 B) in, r_new (8 B)
// and two 1 B flags out. About two flops per slot, far below the FP64 rate.
//
// Design:
//   * One launch covers every bucket. A descriptor of the buckets (the
//     rows, idx, mask and active-list pointers, the lane count, capacity,
//     width, plan and first block of each; ell_gather.cuh) goes to the
//     kernel by value; each block finds its bucket by a scan of at most
//     kMaxBuckets first-block offsets, and a block-uniform switch runs the
//     instantiation of the gather that the bucket's plan names (`ell_plan`
//     in kernels/gather_plan.py). A layout of more buckets is launched in
//     chunks of kMaxBuckets into the same partials.
//   * Work lane i of bucket b is slot s = i, or s = sel_b[i] over an
//     active list. Through the row map (the sweep entry) it reads vertex
//     v = rows_b[s]: r[v] (f64), out_deg[v] (int32) and affected[v]
//     (bool), and writes r_new[v], aff_new[v] and dn[v] (bool) in place.
//     A sentinel (v == n, an unused slot; s == cap_b, a dead lane of the
//     list) does nothing and adds 0 to the L-inf. With the identity map
//     (the per-bucket entry, rows null) the operands are f64 per slot and
//     the outputs f64 per lane i; a dead lane there computes the inert pad
//     (r = 1, deg = 1, aff = 0), as the TPU kernel's take-with-fill does.
//     Both maps run the same body, so their sums and ranks agree bitwise.
//   * The gather body and xor-fold order it shares with ell_pull
//     (ell_gather.cuh): LANES threads per row, every index and mask load
//     of a lane's share before its gathers, the streams past L1 with L2
//     evict_first, c read with L2 evict_last.
//   * An unaffected row skips its gather and writes r, 0, 0 with
//     |dr| = |r - r| (0, or NaN for a NaN rank): DF-P's "process only
//     affected vertices" without any compaction.
//   * Every slot of an affected row, padding included, adds c[idx] * mask,
//     as the TPU kernel does, so a NaN c[0] reaches padded rows alike.
//   * Each block writes its max |dr| into partials; one block folds them.
//     NaN wins. No atomics. Launches on the caller's stream; allocates
//     nothing.
#include "ell_gather.cuh"
#include "epilogue.cuh"

namespace {

template <class P, bool MAPPED, class Deg, class Flag>
__device__ __forceinline__ double sweep_row(const EllBucket& bk, int block,
                                            const double* __restrict__ c,
                                            const Operands<Deg, Flag>& o,
                                            const EpiParams& p,
                                            const GatherPolicy& pol) {
  constexpr int L = P::kLanes;
  const int lane = threadIdx.x % L;
  const long long i =
      (long long)block * (kEllBlock / L) + threadIdx.x / L;
  const bool work = i < bk.count;
  long long s = 0, v = 0;
  bool live = false;  // a real row: neither sentinel
  if (work) {
    s = bk.sel != nullptr ? (long long)bk.sel[i] : i;
    if (s < bk.cap) {
      v = MAPPED ? (long long)bk.rows[s] : s;
      live = !MAPPED || v < o.n;
    }
  }
  double rr = 1.0, d = 1.0, a = 0.0;
  const int* ip = nullptr;
  const float* mp = nullptr;
  if (live) {
    rr = o.r[v];
    d = (double)o.deg[v];
    a = (double)o.aff[v];
    if (a > 0.0) {
      ip = bk.idx + s * bk.width;
      mp = bk.mask + s * bk.width;
    }
  }
  const double sum =
      ell_lanes_sum<L>(ell_row_partial<P>(c, ip, mp, bk.width, lane, pol));
  double dr = 0.0;
  if (MAPPED ? live : work) {
    const EpiOut e = pr_epilogue(sum, rr, d, a, p);
    if (lane == 0) {
      const long long w = MAPPED ? v : i;
      o.r_new[w] = e.r_new;
      o.aff_new[w] = (Flag)e.aff;
      o.dn[w] = (Flag)e.dn;
    }
    dr = e.dr;
  }
  return dr;
}

template <bool MAPPED, class Deg, class Flag>
__global__ void __launch_bounds__(kEllBlock)
    fused_sweep_kernel(const double* __restrict__ c, const EllBuckets bks,
                       const Operands<Deg, Flag> o, const EpiParams p,
                       double* __restrict__ partials) {
  const EllBucket bk = ell_find_bucket(bks);
  const int block = (int)blockIdx.x - bk.first_block;
  const GatherPolicy pol = gather_policy();
  double dr = 0.0;
  with_ell_plan(bk.kind, [&](auto plan) {
    dr = sweep_row<decltype(plan), MAPPED>(bk, block, c, o, p, pol);
  });
  dr = block_max<kEllBlock>(dr);
  if (threadIdx.x == 0) partials[blockIdx.x] = dr;
}

// Launch every bucket (in chunks of kMaxBuckets, each into its own range
// of partials; *launched counts them), then the fold into partials[grid].
template <bool MAPPED, class Deg, class Flag>
int launch_sweep(const double* c, int nb, const void* const* ptrs,
                 const int* ints, const Operands<Deg, Flag>& o,
                 double* partials, const EpiParams& p, int* launched,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const cudaError_t bad = ell_check(nb, ints);
  if (bad != cudaSuccess) return (int)bad;
  int grid = 0;
  for (int j0 = 0; j0 < nb;) {
    EllBuckets bks;
    const int blocks = ell_chunk(nb, ptrs, ints, &j0, &bks);
    if (blocks == 0) continue;
    fused_sweep_kernel<MAPPED, Deg, Flag><<<blocks, kEllBlock, 0, st>>>(
        c, bks, o, p, partials + grid);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
    grid += blocks;
  }
  max_partials_kernel<kFinalBlock><<<1, kFinalBlock, 0, st>>>(
      partials, grid, nullptr, partials + grid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of a launch over `nb` buckets, described by kBucketInts ints each
// (work lanes, capacity, width, plan kind): the partials hold this + 1.
int fused_ell_grid(int nb, const int* ints) {
  int grid = 0;
  for (int j = 0; j < nb; ++j) grid += ell_bucket_blocks(ints, j);
  return grid;
}

// The sweep entry, through the row maps. ptrs: 4 per bucket (rows, idx,
// mask, active list or null); ints: kBucketInts per bucket (work lanes =
// cap or the list's length, cap, width, plan kind). r [n] f64, deg [n]
// int32, aff [n] bool; r_new [n] f64, aff_new and dn [n] bool are written
// at every live row id. The sweep's max |dr| lands in partials[grid];
// *launched gets the number of sweep kernels started. Returns
// cudaGetLastError().
int fused_ell_sweep(const double* c, int nb, const void* const* ptrs,
                    const int* ints, const double* r, const int* deg,
                    const unsigned char* aff, double* r_new,
                    unsigned char* aff_new, unsigned char* dn, int n,
                    double* partials, double alpha, double c0, double tau_f,
                    double tau_p, int prune, int closed_form, int* launched,
                    void* stream) {
  const EpiParams p{alpha, c0, tau_f, tau_p, prune, closed_form};
  const Operands<int, unsigned char> o{r, deg, aff, r_new, aff_new, dn, n};
  return launch_sweep<true>(c, nb, ptrs, ints, o, partials, p, launched,
                            stream);
}

// The per-bucket entry, identity map: one bucket's [cap, width] table,
// operands per slot (f64; pads r = 1, deg = 1, aff = 0), sel the active
// list or null; ints as one bucket of the sweep's (its work lanes `count`
// = the list's length, or cap). Outputs r_new, aff_new, dn hold `count`
// f64 each. partials as above, for nb = 1.
int fused_ell_update(const double* c, const int* idx, const float* mask,
                     const int* sel, const int* ints, const double* r,
                     const double* deg, const double* aff, double* r_new,
                     double* aff_new, double* dn, double* partials,
                     double alpha, double c0, double tau_f, double tau_p,
                     int prune, int closed_form, int* launched,
                     void* stream) {
  const EpiParams p{alpha, c0, tau_f, tau_p, prune, closed_form};
  const Operands<double, double> o{r, deg, aff, r_new, aff_new, dn, ints[1]};
  const void* ptrs[4] = {nullptr, idx, mask, sel};
  return launch_sweep<false>(c, 1, ptrs, ints, o, partials, p, launched,
                             stream);
}

}  // extern "C"
