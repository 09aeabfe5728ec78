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
// bounds it.
//
// The design (the tile loop K1 shares, ss_tile.cuh): 256 threads per
// block, each holding a 1x4 (32 tile) or 8x8 (128 tile) register tile of
// float counters; la and fd stream through a cp.async ring of 16-peer
// chunks laid out [p][row]; one ISETP and one predicated FADD per
// compare-add. The epilogue thresholds each counter against sm and stores
// four outputs as one 4-byte word, consecutive threads on consecutive words
// of a row (single bytes where E is not a multiple of 4). The 128 tile is
// taken where it still gives two blocks per SM (E over 2048 for one
// window), the 32 tile below, so that (512, 16) and the batch of 8 spread
// over the SMs. blockIdx.z = window b. The ragged edges of E and P are masked at
// staging, not padded to the TPU's (8, 128) tiles.
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
                        uint8_t* __restrict__ out, int E, int P, int sm) {
  using T = bt::Tile<B>;
  __shared__ __align__(16) bt::Ring<B, 1> ring;

  const size_t b = blockIdx.z;
  const int x0 = blockIdx.y * B;
  const int y0 = blockIdx.x * B;
  const size_t plane = static_cast<size_t>(E) * P;
  float acc[1][T::kTM][T::kTN];
  bt::count_tile<B, 1, false>(ring, la + b * plane, fd + b * plane, nullptr,
                              E, P, 1, 0, x0, y0, acc);

  const int tx = threadIdx.x % T::kThreadsX;
  const int ty = threadIdx.x / T::kThreadsX;
  const bool words = E % 4 == 0;
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int x = x0 + T::row(ty, i);
    if (x >= E) continue;
    uint8_t* row = out + (b * E + x) * E;
#pragma unroll
    for (int j0 = 0; j0 < T::kTN; j0 += 4) {
      const int y = y0 + T::col(tx, j0);
      if (y >= E) continue;
      uint32_t packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int count = static_cast<int>(acc[0][i][j0 + j]);
        packed |= static_cast<uint32_t>(count >= sm) << (8 * j);
      }
      if (words) {  // y + 3 < E, and the word is 4-byte aligned
        *reinterpret_cast<uint32_t*>(row + y) = packed;
      } else {
        for (int j = 0; j < 4 && y + j < E; ++j) {
          row[y + j] = static_cast<uint8_t>(packed >> (8 * j));
        }
      }
    }
  }
}

template <int B>
int launch(const void* la, const void* fd, void* out, int nb, int E, int P,
           int sm, void* stream) {
  const dim3 grid((E + B - 1) / B, (E + B - 1) / B, nb);
  strongly_see_kernel<B><<<grid, bt::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(la), static_cast<const int32_t*>(fd),
      static_cast<uint8_t*>(out), E, P, sm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Side of the output tile K2 takes for B windows of E events: 32 or 128.
int bt_strongly_see_tile(int E, int B) { return bt::tile_side(E, B); }

// Launch K2 on `stream`; returns the cudaError_t of the launch (0 = ok).
// Pointers are device pointers; nothing is allocated or synchronised here.
int bt_strongly_see(const void* la, const void* fd, void* out, int B, int E,
                    int P, int sm, void* stream) {
  if (B <= 0 || E <= 0 || P < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bt_strongly_see_tile(E, B) == 128
             ? launch<128>(la, fd, out, B, E, P, sm, stream)
             : launch<32>(la, fd, out, B, E, P, sm, stream);
}

}  // extern "C"
