// K2: the strongly-see matrix of the all-at-once DAG consensus pipeline.
//
// Replaces the TPU kernel strongly_see_pallas of the JAX package
// (babble_tpu/ops/pallas_kernels.py:118-153, pl.pallas_call at :142, kernel
// body _ss_kernel at :38-48), called from strongly_see_matrix
// (babble_tpu/ops/dag.py:150-173):
//
//     SS[b, x, y] = #{p : la[b, x, p] >= fd[b, y, p]} >= sm
//
// la, fd: int32 [B, E, P] row-major (B = 1 for one window); out: torch.bool
// (one byte) [B, E, E]. Missing coordinates carry the sentinels la = -1 and
// fd = INT32_MAX, which never pass the compare. The result is exact for every
// pair of int32 values, as the Pallas kernel's is.
//
// The block form (bt_strongly_see_block_at) takes la [B, X, P] against fd
// [B, Y, P] and writes out[b, x, col0 + y] of an output whose rows are
// `ldo` bytes long. It is the multi-device path's: a shard's own rows
// against all candidates (sharded_strongly_see, and the row split of the
// sharded batched pipeline, babble_tpu/parallel/pipeline.py:33), and one
// ring step's column block written in place (ring_strongly_see), where the
// JAX package's shard_map kernels run an XLA compare and sum
// (babble_tpu/parallel/collectives.py:36-109). The square form is the
// block form at X = Y = ldo = E and col0 = 0.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s of 32-bit operations
// on the CUDA cores): a block [X, Y] reads 4*B*(X + Y)*P bytes, writes
// B*X*Y and does B*X*Y*P compare-adds, two 32-bit operations each. At the
// pipeline's largest window (E 4096, P 64) that is 18.9 MB, 5.6 us of
// bandwidth, and 2.1 G operations, 32 us at the yardstick: operations
// bound it, and so they do every shard and ring step of that window at 2,
// 4 and 8 shards (8 us at (1024, 4096, 64), 2 us at a (1024, 1024, 64)
// ring step). The yardstick counts the 128 FP32 lanes of an SM at two
// operations a clock; the loop issues two instructions a compare-add and
// its compare (ISETP) runs on the SM's 64 integer lanes, so it does at
// most 64 compare-adds an SM and clock (ss_tile.cuh), about 16.7 T/s at
// 1.98 GHz: twice the yardstick's time. Read on the card (cuobjdump
// -sass), the 128 tile's unrolled loop turn is 520 instructions for 256
// compare-adds: 256 predicated FADD, 249 ISETP, 10 LDS.128 and 4 moves.
// At the bench shape (E 512, P 16), at a ring step of 8 shards and at the
// sharded pipeline's batched shards the work is well under 1 us: the
// launch (about 5 us) bounds them.
//
// The design (the tile loop K1 shares, ss_tile.cuh): 256 threads per
// block over a 32 x 32, 64 x 64, 64 x 128 or 128 x 128 output tile, each
// thread a 1x4, 4x4, 4x8 or 8x8 register tile of float counters; la and fd
// stream through a cp.async ring of 16-peer chunks laid out [p][row]; one
// ISETP and one predicated FADD per compare-add. The epilogue thresholds
// each counter against sm and stores four outputs as one 4-byte word,
// consecutive threads on consecutive words of a row (single bytes where a
// word would not be 4-byte aligned: Y, ldo or col0 not a multiple of 4).
// blockIdx.z = window b. The ragged edges of X, Y and P are masked at
// staging, not padded to the TPU's (8, 128) tiles.
//
// The tile. What a shape costs is its waves: the blocks of its grid over
// the blocks the card holds at once (132 SMs x the tile's blocks an SM: 4,
// 4, 3, 2). The 128 tile does the most compare-adds per instruction, so
// it wins wherever its grid fills most of a wave; below that a smaller
// tile spreads the same work over more SMs, and the 32 tile's short
// blocks win only on outputs too small to fill a fifth of a wave of
// anything larger. bt_strongly_see_block_tile encodes that as a fixed rule
// of (X, Y, B), read off a table of every tile at the collectives' shapes
// at 2, 4 and 8 shards and at the square K2's (chip_smoke.py --k2-tiles;
// PERF.md section 6): the 128 tile where its grid fills 9/10 of a wave (a
// shard of 1024 or 2048 rows of a 4096 window, a 2048 ring step, the
// square window of 4096), 64 x 128 where its grid fills half a wave (a
// 512-row shard, the batch of 8 windows of 512), 64 x 64 where its grid
// fills a fifth (a 1024 ring step, the sharded pipeline's batched
// shards), else the 32 tile ((512, 16)). Its pick was the fastest tile at
// 11 of the table's 13 shapes and within 1.3-3.7% of it at the others. A
// grid of a few persistent blocks an SM walking the tiles was timed too
// and never beat the grid form by more than 0.3%: it is not kept.
//
// The wrapper (babble_tpu_torch/ops/kernels.py) checks device, dtypes,
// shapes and contiguity, and refuses a P over 2^24, where the float counter
// stops being exact.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "ss_tile.cuh"

namespace {

// The tiles of the block form, by the id the C entries take and return.
enum TileId : int {
  kTile32 = 0,
  kTile64 = 1,
  kTile64x128 = 2,
  kTile128 = 3,
  kTileCount = 4,
};

// One BM x BN output tile a block: grid x, y, z = column tile, row tile,
// window b.
template <class T>
__global__ void __launch_bounds__(bt::kThreads, (T::kBlocks))
    strongly_see_kernel(const int32_t* __restrict__ la,
                        const int32_t* __restrict__ fd,
                        uint8_t* __restrict__ out, int X, int Y, int P,
                        int sm, int ldo, int col0, bool words) {
  __shared__ __align__(16) bt::Ring<T, 1> ring;

  const size_t b = blockIdx.z;
  const int x0 = blockIdx.y * T::kBM;
  const int y0 = blockIdx.x * T::kBN;
  float acc[1][T::kTM][T::kTN];
  bt::count_tile<T, 1, false>(ring, la + b * X * P, fd + b * Y * P, nullptr,
                              X, Y, P, 1, 0, x0, y0, acc);

  const int tx = threadIdx.x % T::kThreadsX;
  const int ty = threadIdx.x / T::kThreadsX;
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int x = x0 + T::row(ty, i);
    if (x >= X) continue;
    uint8_t* row = out + (b * X + x) * ldo + col0;
#pragma unroll
    for (int j0 = 0; j0 < T::kTN; j0 += 4) {
      const int y = y0 + T::col(tx, j0);
      if (y >= Y) continue;
      uint32_t packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int count = static_cast<int>(acc[0][i][j0 + j]);
        packed |= static_cast<uint32_t>(count >= sm) << (8 * j);
      }
      if (words) {  // y + 3 < Y, and the word is 4-byte aligned
        *reinterpret_cast<uint32_t*>(row + y) = packed;
      } else {
        for (int j = 0; j < 4 && y + j < Y; ++j) {
          row[y + j] = static_cast<uint8_t>(packed >> (8 * j));
        }
      }
    }
  }
}

template <class T>
int launch(const void* la, const void* fd, void* out, int nb, int X, int Y,
           int P, int sm, int ldo, int col0, bool words, void* stream) {
  const dim3 grid((Y + T::kBN - 1) / T::kBN, (X + T::kBM - 1) / T::kBM, nb);
  strongly_see_kernel<T><<<grid, bt::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(la), static_cast<const int32_t*>(fd),
      static_cast<uint8_t*>(out), X, Y, P, sm, ldo, col0, words);
  return static_cast<int>(cudaGetLastError());
}

// Whether the grid of tile T for B blocks of X rows against Y columns
// fills at least num / den of one wave: the blocks the card holds at once,
// kSMs x T::kBlocks.
template <class T>
bool fills(int X, int Y, int B, int num, int den) {
  const long long tiles = static_cast<long long>((X + T::kBM - 1) / T::kBM) *
                          ((Y + T::kBN - 1) / T::kBN) * B;
  return tiles * den >= static_cast<long long>(num) * bt::kSMs * T::kBlocks;
}

}  // namespace

extern "C" {

// The tile K2 and its block form take for B blocks of X rows against Y
// columns (a TileId): the 128 tile where its grid fills 9/10 of a wave,
// else 64 x 128 where its grid fills half a wave, else 64 x 64 where its
// grid fills a fifth of one, else the 32 tile.
int bt_strongly_see_block_tile(int X, int Y, int B) {
  if (fills<bt::Tile128>(X, Y, B, 9, 10)) return kTile128;
  if (fills<bt::Tile64x128>(X, Y, B, 1, 2)) return kTile64x128;
  if (fills<bt::Tile64>(X, Y, B, 1, 5)) return kTile64;
  return kTile32;
}

// Launch K2's block form on `stream` at tile `tile` (a TileId; -1: the
// one bt_strongly_see_block_tile picks): out[b, x, col0 + y] for la
// [B, X, P] against fd [B, Y, P], rows of out `ldo` bytes apart and
// windows X * ldo apart. Returns the cudaError_t of the launch (0 = ok).
// Pointers are device pointers; nothing is allocated or synchronised
// here.
int bt_strongly_see_block_at(int tile, const void* la, const void* fd,
                             void* out, int B, int X, int Y, int P, int sm,
                             int ldo, int col0, void* stream) {
  if (B <= 0 || X <= 0 || Y <= 0 || P < 0 || col0 < 0 ||
      static_cast<long long>(col0) + Y > ldo || tile < -1 ||
      tile >= kTileCount) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool words = Y % 4 == 0 && ldo % 4 == 0 && col0 % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 4 == 0;
  switch (tile < 0 ? bt_strongly_see_block_tile(X, Y, B) : tile) {
    case kTile32:
      return launch<bt::Tile32>(la, fd, out, B, X, Y, P, sm, ldo, col0,
                                words, stream);
    case kTile64:
      return launch<bt::Tile64>(la, fd, out, B, X, Y, P, sm, ldo, col0,
                                words, stream);
    case kTile64x128:
      return launch<bt::Tile64x128>(la, fd, out, B, X, Y, P, sm, ldo, col0,
                                    words, stream);
    default:
      return launch<bt::Tile128>(la, fd, out, B, X, Y, P, sm, ldo, col0,
                                 words, stream);
  }
}

// Launch K2 on `stream`: the square [B, E, E] matrix, the block form at
// X = Y = ldo = E and col0 = 0.
int bt_strongly_see(const void* la, const void* fd, void* out, int B, int E,
                    int P, int sm, void* stream) {
  if (B <= 0 || E <= 0 || P < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bt_strongly_see_block_at(-1, la, fd, out, B, E, E, P, sm, E, 0,
                                  stream);
}

}  // extern "C"
