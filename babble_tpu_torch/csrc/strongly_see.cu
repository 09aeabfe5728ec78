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
// The block form (bt_strongly_see_block) takes la [B, X, P] against fd
// [B, Y, P] and writes out[b, x, col0 + y] of an output whose rows are
// `ldo` bytes long. It is the multi-device path's: a shard's own rows
// against all candidates (sharded_strongly_see, and the row split of the
// sharded batched pipeline), and one ring step's column block written in
// place (ring_strongly_see), where the JAX package's shard_map kernels run
// an XLA compare and sum (babble_tpu/parallel/collectives.py:36-109).
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s of 32-bit operations
// on the CUDA cores): it reads 8*B*E*P bytes, writes B*E^2 bytes and does
// B*E^2*P compare-adds, two 32-bit operations each. At the pipeline's
// largest window (E 4096, P 64) that is 18.9 MB, 5.6 us of bandwidth, and
// 2.1 G operations, 32 us of issue: operations bound it. That yardstick
// takes the 128 FP32 lanes of an SM at two operations per lane and clock;
// an SM has 64 integer lanes, and the loop's compare (ISETP) runs there, so
// the loop issues at most 64 compare-adds per SM and clock, about 16 T/s at
// 1.9 GHz: 65-75 us at (4096, 64), twice the yardstick.
// At the bench shape (E 512, P 16) the work is about 0.1 us: the launch
// bounds it. A block [X, Y] reads 4*B*(X + Y)*P bytes, writes B*X*Y and
// does B*X*Y*P compare-adds.
//
// The design (the tile loop K1 shares, ss_tile.cuh): 256 threads per
// block, each holding a 1x4 (32 tile) or 8x8 (128 tile) register tile of
// float counters; la and fd stream through a cp.async ring of 16-peer
// chunks laid out [p][row]; one ISETP and one predicated FADD per
// compare-add. The epilogue thresholds each counter against sm and stores
// four outputs as one 4-byte word, consecutive threads on consecutive words
// of a row (single bytes where a word would not be 4-byte aligned: Y, ldo
// or col0 not a multiple of 4). The 128 tile is taken where it still gives
// two blocks per SM (E over 2048 for one window), the 32 tile below, so
// that (512, 16) and the batch of 8 spread over the SMs. blockIdx.z =
// window b. The ragged edges of X, Y and P are masked at staging, not
// padded to the TPU's (8, 128) tiles.
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

template <int B>
__global__ void __launch_bounds__(bt::kThreads, (bt::kBlocksPerSM<B, 1>))
    strongly_see_kernel(const int32_t* __restrict__ la,
                        const int32_t* __restrict__ fd,
                        uint8_t* __restrict__ out, int X, int Y, int P,
                        int sm, int ldo, int col0, bool words) {
  using T = bt::Tile<B>;
  __shared__ __align__(16) bt::Ring<B, 1> ring;

  const size_t b = blockIdx.z;
  const int x0 = blockIdx.y * B;
  const int y0 = blockIdx.x * B;
  float acc[1][T::kTM][T::kTN];
  bt::count_tile<B, 1, false>(ring, la + b * X * P, fd + b * Y * P, nullptr,
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

template <int B>
int launch(const void* la, const void* fd, void* out, int nb, int X, int Y,
           int P, int sm, int ldo, int col0, bool words, void* stream) {
  const dim3 grid((Y + B - 1) / B, (X + B - 1) / B, nb);
  strongly_see_kernel<B><<<grid, bt::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(la), static_cast<const int32_t*>(fd),
      static_cast<uint8_t*>(out), X, Y, P, sm, ldo, col0, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Side of the output tile K2 takes for B windows of E events: 32 or 128.
int bt_strongly_see_tile(int E, int B) { return bt::tile_side(E, E, B); }

// Side of the output tile K2's block form takes for B blocks of X rows
// against Y columns: 32 or 128.
int bt_strongly_see_block_tile(int X, int Y, int B) {
  return bt::tile_side(X, Y, B);
}

// Launch K2's block form on `stream`: out[b, x, col0 + y] for la [B, X, P]
// against fd [B, Y, P], rows of out `ldo` bytes apart and windows X * ldo
// apart. Returns the cudaError_t of the launch (0 = ok). Pointers are
// device pointers; nothing is allocated or synchronised here.
int bt_strongly_see_block(const void* la, const void* fd, void* out, int B,
                          int X, int Y, int P, int sm, int ldo, int col0,
                          void* stream) {
  if (B <= 0 || X <= 0 || Y <= 0 || P < 0 || col0 < 0 ||
      static_cast<long long>(col0) + Y > ldo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool words = Y % 4 == 0 && ldo % 4 == 0 && col0 % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 4 == 0;
  return bt_strongly_see_block_tile(X, Y, B) == 128
             ? launch<128>(la, fd, out, B, X, Y, P, sm, ldo, col0, words,
                           stream)
             : launch<32>(la, fd, out, B, X, Y, P, sm, ldo, col0, words,
                          stream);
}

// Launch K2 on `stream`: the square [B, E, E] matrix, the block form at
// X = Y = ldo = E and col0 = 0.
int bt_strongly_see(const void* la, const void* fd, void* out, int B, int E,
                    int P, int sm, void* stream) {
  if (B <= 0 || E <= 0 || P < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bt_strongly_see_block(la, fd, out, B, E, E, P, sm, E, 0, stream);
}

}  // extern "C"
