// K1: per-peer-set strongly-see counts for the live voting sweep.
//
// Replaces the TPU kernel member_ss_counts_pallas of the JAX package
// (babble_tpu/ops/pallas_kernels.py:69-115, kernel body _member_ss_kernel
// at :54-66), called from the fused sweep's fame stage
// (babble_tpu/ops/voting.py:183-192):
//
//     counts[s, v, w] = sum_p member[s, p] * (la[v, p] >= fd[w, p])
//
// la, fd: int32 [W, P] row-major; member: torch.bool (one byte) [S, P];
// out: int32 [S, W, W]. Missing coordinates carry the sentinels la = -1 and
// fd = INT32_MAX. Last-ancestor indexes never reach INT32_MAX, so loading
// INT32_MAX into fd for a non-member peer gives the same count as multiplying
// the compare by member[s, p] — the Pallas wrapper folds membership the same
// way.
//
// What bounds it on an H100 SXM (3.35 TB/s, 132 SMs): it reads 8*W*P + S*P
// bytes, writes 4*S*W^2 bytes and does S*W^2*P compare-adds. At the live
// shapes (W a power of two from 16 to 512, P a multiple of 8 up to 64, S of 1
// or 2) that is at most about 2 MB and 34 M integer operations, a few
// microseconds of bandwidth or issue: the launch itself bounds it. So the
// design is the simple, correct one, and speed work (wgmma on 0/1 operands,
// TMA) is left for later:
//
// - one block per 32x32 (v, w) output tile, blockIdx.z = s;
// - the block stages its 32 la rows and its 32 membership-masked fd rows in
//   shared memory, with a row stride of P + 1 words so that the 32 threads of
//   a warp, which read 32 different fd rows at the same p, hit distinct banks
//   (the la row is one broadcast word per warp); the tile loop is shared
//   with K2 (ss_tile.cuh);
// - each thread loops over p with an int32 accumulator and stores one count;
//   threadIdx.x runs along w, so a warp's stores are coalesced;
// - the ragged edges of W are masked here, not padded to the TPU's (8, 128)
//   tiles.
//
// The wrapper (babble_tpu_torch/ops/kernels.py) checks device, dtypes, shapes
// and contiguity, and refuses a P whose two tiles exceed the 227 KB of shared
// memory a block can use.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "ss_tile.cuh"

namespace {

using bt::kTile;

__global__ void member_ss_kernel(const int32_t* __restrict__ la,
                                 const int32_t* __restrict__ fd,
                                 const uint8_t* __restrict__ member,
                                 int32_t* __restrict__ out, int W, int P) {
  extern __shared__ int32_t smem[];
  const int stride = P + 1;
  int32_t* la_s = smem;                   // [kTile][P + 1]
  int32_t* fd_s = smem + kTile * stride;  // [kTile][P + 1]

  const int s = blockIdx.z;
  const int v0 = blockIdx.y * kTile;
  const int w0 = blockIdx.x * kTile;

  // Membership folds into the fd tile: a non-member peer's column holds
  // INT_MAX, which no last-ancestor index reaches.
  bt::stage_rows(la_s, la, W, P, v0, -1, nullptr);
  bt::stage_rows(fd_s, fd, W, P, w0, INT_MAX,
                 member + static_cast<size_t>(s) * P);
  __syncthreads();

  const int v = v0 + threadIdx.y;
  const int w = w0 + threadIdx.x;
  if (v >= W || w >= W) return;
  out[(static_cast<size_t>(s) * W + v) * W + w] = bt::count_ge(
      la_s + threadIdx.y * stride, fd_s + threadIdx.x * stride, P);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for a peer axis of P.
size_t bt_member_ss_smem_bytes(int P) { return bt::ss_tile_smem_bytes(P); }

// Launch K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// Pointers are device pointers; nothing is allocated or synchronised here.
int bt_member_ss_counts(const void* la, const void* fd, const void* member,
                        void* out, int W, int P, int S, void* stream) {
  if (W <= 0 || P < 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bt_member_ss_smem_bytes(P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        member_ss_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + kTile - 1) / kTile, (W + kTile - 1) / kTile, S);
  const dim3 block(kTile, kTile);
  member_ss_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(la), static_cast<const int32_t*>(fd),
      static_cast<const uint8_t*>(member), static_cast<int32_t*>(out), W, P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
