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
// fd = INT32_MAX, which never pass the compare, so they drop out of the
// count by themselves.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s of 32-bit operations
// on the CUDA cores): it reads 8*B*E*P bytes, writes B*E^2 bytes and does
// B*E^2*P compare-adds, two 32-bit operations each. At the pipeline's
// largest window (E 4096, P 64) that is 18.9 MB, 5.6 us of bandwidth, and
// 2.1 G operations, 32 us of issue: operations bound it. At the bench shape
// (E 512, P 16) it is 0.33 MB and 8.4 M operations, about 0.1 us: the
// launch bounds it. The design is the simple, correct one; speed work
// (wgmma on 0/1 operands, TMA, a persistent grid) is left for later:
//
// - one block per 32x32 (x, y) output tile, blockIdx.z = window b;
// - the block stages its 32 la rows and 32 fd rows in shared memory with a
//   row stride of P + 1 words (the tile loop K1 uses, ss_tile.cuh), so a
//   warp's 32 fd reads at one p hit distinct banks;
// - each thread counts over p in an int32 accumulator and stores
//   count >= sm as one byte; threadIdx.x runs along y, so a warp's 32 byte
//   stores are contiguous;
// - the ragged edges of E are masked here, not padded to the TPU's
//   (8, 128) tiles, and the operands keep their [E, P] layout (the Pallas
//   wrapper transposes them to [P, E] for the TPU's lanes).
//
// The wrapper (babble_tpu_torch/ops/kernels.py) checks device, dtypes,
// shapes and contiguity, and refuses a P whose two tiles exceed the 227 KB
// of shared memory a block can use.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "ss_tile.cuh"

namespace {

using bt::kTile;

__global__ void strongly_see_kernel(const int32_t* __restrict__ la,
                                    const int32_t* __restrict__ fd,
                                    uint8_t* __restrict__ out, int E, int P,
                                    int sm) {
  extern __shared__ int32_t smem[];
  const int stride = P + 1;
  int32_t* la_s = smem;                   // [kTile][P + 1]
  int32_t* fd_s = smem + kTile * stride;  // [kTile][P + 1]

  const size_t b = blockIdx.z;
  const int x0 = blockIdx.y * kTile;
  const int y0 = blockIdx.x * kTile;
  const size_t plane = static_cast<size_t>(E) * P;

  bt::stage_rows(la_s, la + b * plane, E, P, x0, -1, nullptr);
  bt::stage_rows(fd_s, fd + b * plane, E, P, y0, INT_MAX, nullptr);
  __syncthreads();

  const int x = x0 + threadIdx.y;
  const int y = y0 + threadIdx.x;
  if (x >= E || y >= E) return;
  const int32_t count = bt::count_ge(la_s + threadIdx.y * stride,
                                     fd_s + threadIdx.x * stride, P);
  out[(b * E + x) * E + y] = count >= sm ? 1 : 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for a peer axis of P.
size_t bt_strongly_see_smem_bytes(int P) { return bt::ss_tile_smem_bytes(P); }

// Launch K2 on `stream`; returns the cudaError_t of the launch (0 = ok).
// Pointers are device pointers; nothing is allocated or synchronised here.
int bt_strongly_see(const void* la, const void* fd, void* out, int B, int E,
                    int P, int sm, void* stream) {
  if (B <= 0 || E <= 0 || P < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = bt_strongly_see_smem_bytes(P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        strongly_see_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((E + kTile - 1) / kTile, (E + kTile - 1) / kTile, B);
  const dim3 block(kTile, kTile);
  strongly_see_kernel<<<grid, block, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(la), static_cast<const int32_t*>(fd),
      static_cast<uint8_t*>(out), E, P, sm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
