// scatter_rows: in-place row scatter for the streaming snapshot,
//   dst[rows[i], :] = new_rows[i, :]   for i < K,
// over one [R, d] table, or over an (index, mask) pair of tables that
// share their row ids (an ELL bucket's idx/mask, the tile pool's
// tiles/tmask) in one launch.
//
// Replaces the TPU kernel `scatter_rows` (_copy_kernel) and its pair form
// `ell_scatter_rows` in src/repro/kernels/stream_scatter.py.
//
// What bounds it on the H100: bytes — each edited row is read once from
// new_rows and written once into dst (2 * K * d * 4 B), plus the K row ids.
// A batch touches a few thousand rows, so at K * d * 4 of a few hundred KB
// a launch is short and mostly launch latency.
//
// The TPU kernel walks a grid of K programs whose output block index comes
// from the row ids (scalar prefetch) and aliases dst to its output. Here a
// group of L lanes owns one edited row, L the power of two >= the row's
// vector count (at most a warp), so a block of 256 threads carries 256 / L
// rows: 256 rows per block at width 4 (one 16-byte vector per row), one
// row per warp at width 128 and up.
// Where d * 4 is a multiple of 16 and every row start is 16-byte aligned
// the lanes copy 16-byte vectors (uint4), otherwise 4-byte words. The
// element type does not matter to a copy: int32 and float32 tables move as
// raw 32-bit words, so a float's bits (NaN payloads included) arrive
// unchanged. A row id outside [0, R) writes nothing. Duplicate row ids must
// carry identical contents (the JAX package's pad convention); their
// writes then race harmlessly. dst is written in place: no copy of the
// table, no output allocation. Launches on the caller's stream.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;

template <typename Word>
__device__ __forceinline__ void copy_row(Word* dst, const Word* src, int n,
                                         int lane, int lanes) {
  for (int j = lane; j < n; j += lanes) dst[j] = src[j];
}

// dst1/src1 are null for a single table.
template <typename Word>
__global__ void __launch_bounds__(kBlock)
    scatter_rows_kernel(Word* dst0, const Word* __restrict__ src0,
                        Word* dst1, const Word* __restrict__ src1,
                        const int* __restrict__ rows, long long n_dst_rows,
                        int k, int words, int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const long long i = (long long)blockIdx.x * (kBlock >> lanes_log2) +
                      (threadIdx.x >> lanes_log2);
  if (i >= k) return;
  const int lane = threadIdx.x & (lanes - 1);
  const long long r = rows[i];
  if (r < 0 || r >= n_dst_rows) return;
  const long long to = r * words, from = i * words;
  copy_row(dst0 + to, src0 + from, words, lane, lanes);
  if (dst1 != nullptr) copy_row(dst1 + to, src1 + from, words, lane, lanes);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <typename Word>
void launch(void* dst0, const void* src0, void* dst1, const void* src1,
            const int* rows, int n_dst_rows, int k, int words,
            cudaStream_t st) {
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < words && lanes_log2 < 5) ++lanes_log2;
  const int rows_per_block = kBlock >> lanes_log2;
  const int grid = (k + rows_per_block - 1) / rows_per_block;
  scatter_rows_kernel<Word><<<grid, kBlock, 0, st>>>(
      static_cast<Word*>(dst0), static_cast<const Word*>(src0),
      static_cast<Word*>(dst1), static_cast<const Word*>(src1), rows,
      n_dst_rows, k, words, lanes_log2);
}

// One or two [R, d] tables of 32-bit words; dst1/src1 null for one.
int scatter(void* dst0, const void* src0, void* dst1, const void* src1,
            const int* rows, int n_dst_rows, int k, int d, void* stream) {
  if (k <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && aligned16(dst0) && aligned16(src0) &&
                   (dst1 == nullptr || (aligned16(dst1) && aligned16(src1)));
  if (vec)
    launch<uint4>(dst0, src0, dst1, src1, rows, n_dst_rows, k, d / 4, st);
  else
    launch<std::uint32_t>(dst0, src0, dst1, src1, rows, n_dst_rows, k, d,
                          st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dst [R, d], rows [k], new_rows [k, d], all contiguous on one device.
// Each returns cudaGetLastError().
int scatter_rows_i32(int* dst, const int* rows, const int* new_rows, int R,
                     int k, int d, void* stream) {
  return scatter(dst, new_rows, nullptr, nullptr, rows, R, k, d, stream);
}

int scatter_rows_f32(float* dst, const int* rows, const float* new_rows,
                     int R, int k, int d, void* stream) {
  return scatter(dst, new_rows, nullptr, nullptr, rows, R, k, d, stream);
}

// The (index, mask) pair of one layout table: both [R, d], one launch.
int ell_scatter_rows(int* idx, float* mask, const int* rows,
                     const int* new_idx, const float* new_mask, int R, int k,
                     int d, void* stream) {
  return scatter(idx, new_idx, mask, new_mask, rows, R, k, d, stream);
}

}  // extern "C"
