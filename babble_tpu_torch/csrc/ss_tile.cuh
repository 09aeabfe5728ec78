// Shared tile loop of the strongly-see kernels K1 (member_ss.cu) and K2
// (strongly_see.cu).
//
// Both count, for one 32x32 output tile, the peers p with
// la[x, p] >= fd[y, p] over row-major int32 [n, P] coordinate matrices. A
// block of 32x32 threads stages the tile's 32 la rows and 32 fd rows in
// shared memory with a row stride of P + 1 words: the 32 threads of a warp
// share one la row (a broadcast word) and read 32 different fd rows at the
// same p, which the odd stride spreads over distinct banks. Rows past the
// matrix edge are filled with a sentinel that never passes the compare
// (la = -1, fd = INT32_MAX), so ragged edges need no padding in memory.

#pragma once

#include <climits>
#include <cstddef>
#include <cstdint>

namespace bt {

constexpr int kTile = 32;

// Dynamic shared memory of one block: two [kTile][P + 1] int32 tiles.
inline size_t ss_tile_smem_bytes(int P) {
  return 2 * static_cast<size_t>(kTile) * (P + 1) * sizeof(int32_t);
}

// Stage rows [r0, r0 + kTile) of `src` ([n, P], row-major) into `dst`
// ([kTile][P + 1]). Rows at or past n, and columns p whose `keep[p]` is 0
// (when `keep` is not null), hold `fill`. Consecutive threads read
// consecutive words. Every thread of the block must call it.
static __device__ __forceinline__ void stage_rows(
    int32_t* dst, const int32_t* __restrict__ src, int n, int P, int r0,
    int32_t fill, const uint8_t* __restrict__ keep) {
  const int stride = P + 1;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int i = tid; i < kTile * P; i += kTile * kTile) {
    const int r = i / P;
    const int p = i - r * P;
    const int row = r0 + r;
    const bool ok = row < n && (keep == nullptr || keep[p]);
    dst[r * stride + p] = ok ? src[static_cast<size_t>(row) * P + p] : fill;
  }
}

// #{p : la_row[p] >= fd_row[p]}, an int32 count over P staged words.
static __device__ __forceinline__ int32_t count_ge(
    const int32_t* la_row, const int32_t* fd_row, int P) {
  int32_t acc = 0;
  for (int p = 0; p < P; ++p) acc += la_row[p] >= fd_row[p] ? 1 : 0;
  return acc;
}

}  // namespace bt
