// scatter_rows: in-place row scatter for the streaming snapshot,
//   dst[rows[i], :] = new_rows[i, :]   for i < K,
// over every table a batch edits, in one launch: single [R, d] tables and
// (index, mask) pairs of tables that share their row ids (an ELL bucket's
// idx/mask, the tile pool's tiles/tmask).
//
// Replaces the TPU kernel `scatter_rows` (_copy_kernel) and its pair form
// `ell_scatter_rows` in src/repro/kernels/stream_scatter.py, which take
// one table per call.
//
// What bounds it on the H100: bytes — each edited row is read once from
// new_rows and written once into dst (2 * K * d * 4 B), plus the K row ids.
// A batch touches a few thousand rows, so at K * d * 4 of a few hundred KB
// the work is short and one launch per table would be mostly launch
// latency: hence one launch for all of them.
//
// The TPU kernel walks a grid of K programs whose output block index comes
// from the row ids (scalar prefetch) and aliases dst to its output. Here a
// descriptor of the tables (pointers, sizes, word path, lanes per row and
// first block of each) goes to the kernel by value; each block finds its
// table by a scan of at most kMaxTables first-block offsets (more tables
// are launched in chunks of kMaxTables). Within a table a group of L lanes
// owns one edited row, L the power of two >= the row's vector count (at
// most a warp), so a block of 256 threads carries 256 / L rows: 256 rows
// per block at width 4 (one 16-byte vector per row), one row per warp at
// width 128 and up.
// Where d * 4 is a multiple of 16 and every row start of the table is
// 16-byte aligned its lanes copy 16-byte vectors (uint4), otherwise 4-byte
// words; the choice is per table, uniform over a block. The element type
// does not matter to a copy: int32 and float32 tables move as raw 32-bit
// words, so a float's bits (NaN payloads included) arrive unchanged. A row
// id outside [0, R) writes nothing. Duplicate row ids must carry identical
// contents (the JAX package's pad convention); their writes then race
// harmlessly. dst is written in place: no copy of a table, no output
// allocation. Launches on the caller's stream.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxTables = 16;

struct Table {
  void* dst0;
  const void* src0;
  void* dst1;         // null for a single table
  const void* src1;
  const int* rows;    // [k]
  long long n_rows;   // R
  int k;
  int words;          // Words per row
  int vec;            // 1: uint4 words, 0: 32-bit words
  int lanes_log2;
  int first_block;
};

struct Tables {
  Table t[kMaxTables];
  int nt;
};

template <typename Word>
__device__ __forceinline__ void copy_row(Word* dst, const Word* src, int n,
                                         int lane, int lanes) {
  for (int j = lane; j < n; j += lanes) dst[j] = src[j];
}

template <typename Word>
__device__ __forceinline__ void scatter_block(const Table& t, int block) {
  const int lanes = 1 << t.lanes_log2;
  const long long i = (long long)block * (kBlock >> t.lanes_log2) +
                      (threadIdx.x >> t.lanes_log2);
  if (i >= t.k) return;
  const int lane = threadIdx.x & (lanes - 1);
  const long long r = t.rows[i];
  if (r < 0 || r >= t.n_rows) return;
  const long long to = r * t.words, from = i * t.words;
  copy_row(static_cast<Word*>(t.dst0) + to,
           static_cast<const Word*>(t.src0) + from, t.words, lane, lanes);
  if (t.dst1 != nullptr)
    copy_row(static_cast<Word*>(t.dst1) + to,
             static_cast<const Word*>(t.src1) + from, t.words, lane, lanes);
}

__global__ void __launch_bounds__(kBlock)
    scatter_rows_kernel(const Tables ts) {
  // this block's table, selected with static indices only (no dynamic
  // indexing into the parameter struct)
  Table t = ts.t[0];
#pragma unroll
  for (int j = 1; j < kMaxTables; ++j)
    if (j < ts.nt && (int)blockIdx.x >= ts.t[j].first_block) t = ts.t[j];
  const int block = (int)blockIdx.x - t.first_block;
  if (t.vec)
    scatter_block<uint4>(t, block);
  else
    scatter_block<std::uint32_t>(t, block);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// Every table in one launch (in chunks of kMaxTables). ptrs: 5 per table
// (dst0, src0, dst1 or null, src1 or null, rows); ints: 3 per table (R, k,
// d). Each dst is a contiguous [R, d] table of 32-bit words, each src a
// contiguous [k, d] one, rows [k] int32; a pair's two tables share R, k,
// d and rows. Tables with k = 0 or d = 0 are skipped. Returns
// cudaGetLastError().
int scatter_rows_batch(int nt, const void* const* ptrs, const int* ints,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int j0 = 0; j0 < nt;) {
    Tables ts{};
    int blocks = 0;
    for (; j0 < nt && ts.nt < kMaxTables; ++j0) {
      const void* const* p = ptrs + 5 * j0;
      const int R = ints[3 * j0], k = ints[3 * j0 + 1], d = ints[3 * j0 + 2];
      if (k <= 0 || d <= 0) continue;
      Table& t = ts.t[ts.nt++];
      t.dst0 = const_cast<void*>(p[0]);
      t.src0 = p[1];
      t.dst1 = const_cast<void*>(p[2]);
      t.src1 = p[3];
      t.rows = static_cast<const int*>(p[4]);
      t.n_rows = R;
      t.k = k;
      t.vec = d % 4 == 0 && aligned16(p[0]) && aligned16(p[1]) &&
              (p[2] == nullptr || (aligned16(p[2]) && aligned16(p[3])));
      t.words = t.vec ? d / 4 : d;
      t.lanes_log2 = 0;
      while ((1 << t.lanes_log2) < t.words && t.lanes_log2 < 5)
        ++t.lanes_log2;
      t.first_block = blocks;
      const int per_block = kBlock >> t.lanes_log2;
      blocks += (k + per_block - 1) / per_block;
    }
    if (blocks == 0) continue;
    scatter_rows_kernel<<<blocks, kBlock, 0, st>>>(ts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
