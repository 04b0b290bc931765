// csr_block_pull: per-high-slot in-edge sums over the tiled-CSR side,
//   out[s] = sum over tiles t of slot s of sum_j c[tiles[t, j]] * tmask[t, j]
//
// Replaces the TPU kernel `csr_block_pull` (_kernel) in
// src/repro/kernels/csr_block.py.
//
// What bounds it on the H100: bytes — 8 B of index and mask per tile slot
// (450 MB a sweep at |V| = 4M), plus the random gathers of c (33.5 MB,
// about what the 50 MB L2 holds beside that stream).
//
// The TPU kernel reduces by walking its grid in order: out[rowmap[t]] is
// zeroed at t == 0 and read-modified-written at every step. Blocks on the
// H100 run in no order, so that has no counterpart. Two passes instead,
// both deterministic and atomics-free:
//   pass 1: one warp per tile (or per entry of the tile_sel list) writes
//           that tile's sum into tsum[t]; a sentinel entry (t >= t_cap)
//           writes nothing. The gather is ell_gather.cuh's, a row of 32
//           lanes: at the main path's tile of kCsrTile = 256 on 16-byte
//           aligned tables (the template plan, `csr_plan` in
//           kernels/gather_plan.py) each lane loads its 8 indices and 8
//           mask bits as two 16-byte words each (adjacent lanes on
//           adjacent words: 512 contiguous bytes a warp load), then starts
//           its 8 gathers of c, then sums them in slot order; the streams
//           go past L1 with L2 evict_first, c is read with L2 evict_last.
//           Other tiles and tables take the generic loop (lane,
//           lane + 32, ...).
//   pass 2: one warp per high slot sums tsum over the slot's tiles, taken
//           from the slot->tile table that to_device builds once from
//           hi_rowmap (stable argsort + offsets: tiles in ascending order,
//           no assumption that they are contiguous or sorted in the
//           layout). A warp rather than a thread per slot: the largest hub
//           at |V| = 4M owns about 10k tiles, and one thread walking them
//           in series would hold the sweep for milliseconds. Lane l takes
//           the slot's tiles l, l+32, ... and the warp folds with a fixed
//           xor tree, so the order is the same on every run.
// Launches on the caller's stream; allocates nothing (tsum comes from the
// caller, zeroed when tile_sel is used).
#include "ell_gather.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

__device__ __forceinline__ double warp_sum(double s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <class P>
__global__ void __launch_bounds__(kBlock)
    tile_sums_kernel(const double* __restrict__ c,
                     const int* __restrict__ tiles,
                     const float* __restrict__ tmask,
                     const int* __restrict__ tile_sel, int n_sel, int t_cap,
                     int tile, double* __restrict__ tsum) {
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  long long t = t_cap;  // sentinel: nothing to do
  if (w < n_sel) t = tile_sel ? tile_sel[w] : w;
  const bool live = t < t_cap;  // uniform across the warp
  const GatherPolicy pol = gather_policy();
  const double s = warp_sum(ell_row_partial<P>(
      c, live ? tiles + t * tile : nullptr,
      live ? tmask + t * tile : nullptr, tile, lane, pol));
  if (live && lane == 0) tsum[t] = s;
}

__global__ void __launch_bounds__(kBlock)
    slot_sums_kernel(const double* __restrict__ tsum,
                     const int* __restrict__ slot_tiles,
                     const int* __restrict__ slot_off, int n_rows,
                     double* __restrict__ out) {
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  double s = 0.0;
  if (w < n_rows) {
    const int lo = slot_off[w], hi = slot_off[w + 1];
    for (int k = lo + lane; k < hi; k += 32) s += tsum[slot_tiles[k]];
  }
  s = warp_sum(s);
  if (w < n_rows && lane == 0) out[w] = s;
}

int blocks_for_warps(long long warps) {
  return (int)((warps + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

// tile_sel may be null (every tile, n_sel == t_cap). tsum holds t_cap
// doubles. templated: the template plan (tile == kCsrTile, tables 16-byte
// aligned), else the generic loop. Returns cudaGetLastError().
int csr_block_pull(const double* c, const int* tiles, const float* tmask,
                   const int* tile_sel, int n_sel, int t_cap, int tile,
                   int templated, const int* slot_tiles, const int* slot_off,
                   int n_rows, double* tsum, double* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (templated && tile != kCsrTile) return cudaErrorInvalidValue;
  if (n_sel > 0) {
    const int grid = blocks_for_warps(n_sel);
    if (templated)
      tile_sums_kernel<EllPlan<kCsrTile, 32, true>><<<grid, kBlock, 0, st>>>(
          c, tiles, tmask, tile_sel, n_sel, t_cap, tile, tsum);
    else
      tile_sums_kernel<EllPlan<0, 32, false>><<<grid, kBlock, 0, st>>>(
          c, tiles, tmask, tile_sel, n_sel, t_cap, tile, tsum);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  slot_sums_kernel<<<blocks_for_warps(n_rows), kBlock, 0, st>>>(
      tsum, slot_tiles, slot_off, n_rows, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
