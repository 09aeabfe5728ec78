// K1: per-peer-set strongly-see counts for the live voting sweep.
//
// Replaces the TPU kernel member_ss_counts_pallas of the JAX package
// (babble_tpu/ops/pallas_kernels.py:69-115, kernel body _member_ss_kernel
// at :54-66), called from the fused sweep's fame stage
// (babble_tpu/ops/voting.py:183-192):
//
//     counts[b, s, v, w] = sum_p member[b, s, p] * (la[b, v, p] >= fd[b, w, p])
//
// la, fd: int32 [B, W, P] row-major; member: torch.bool (one byte)
// [B, S, P]; out: int32 [B, S, W, W]; B = 1 for one window. The batch axis
// is the sweep batcher's (babble_tpu_torch/hashgraph/sweep_batcher.py): the
// JAX package vmaps the fused sweep over co-located validators' windows
// (babble_tpu/ops/voting.py:319-323), and vmap of a pallas_call adds a grid
// axis; here the windows share one launch. Missing coordinates carry the sentinels la = -1 and
// fd = INT32_MAX. The kernel computes the product by member, exactly, for
// every pair of int32 values. The Pallas wrapper folds membership into fd
// as INT32_MAX instead (pallas_kernels.py:100-102); the two agree wherever
// la stays below INT32_MAX, which last-ancestor indexes always do. That is
// K1's stated domain.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s of 32-bit
// operations): per window it reads 8*W*P + S*P bytes, writes 4*S*W^2 bytes
// and does S*W^2*P compare-adds. At the live shapes (W a power of two from 16 to
// 1024, P a multiple of 8 up to 64, S of 1 or 2) that is at most 4 us of
// work, and at the common ones (W 128-256) well under 1 us: the launch
// bounds it there, and the design must not add to it.
//
// The design (the tile loop K2 shares, ss_tile.cuh): 256 threads per
// block, each holding a 1x4 (32 tile) or 8x8 (128 tile) register tile of
// float counters per slot; la and fd stream through a cp.async ring of
// 16-peer chunks laid out [p][row], fd staged once and unmasked,
// beside the membership rows of the block's slots as 0/1 weights. One
// compare (ISETP) per (v, w, p) feeds a predicated add (FADD) of each
// slot's weight, so S = 2 costs one compare, not two: a block takes one
// slot when S = 1 and two otherwise (one for an odd S, so that a block's
// slots never span two windows; live windows have S a power of two). The
// batch is addressed through the inputs' own layout: la and fd are read as
// [B*W, P] row blocks, window b's tiles starting at row b*W, and slots are
// numbered across the batch (blockIdx.z * NS is the first of the block's
// B*S slots, window b's being b*S to b*S + S - 1), so the kernel's
// pointers stay kernel parameters and no per-window pointer takes
// registers. Tile rows past a window's W read the next window's rows (or
// the masked sentinels past B*W); their counts are never stored. The 128
// tile is taken where it still gives two blocks per SM over the whole grid
// (W over 2048 for one window), the 32 tile below, so that the live
// buckets spread over the SMs. The epilogue
// stores four counts as one 16-byte word, consecutive threads on
// consecutive words of a row (single words where W is not a multiple of
// 4). The ragged edges of W and P are masked at staging, not padded to the
// TPU's (8, 128) tiles.
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

template <int B, int NS>
__global__ void __launch_bounds__(bt::kThreads, (bt::kBlocksPerSM<B, NS>))
    member_ss_kernel(const int32_t* __restrict__ la,
                     const int32_t* __restrict__ fd,
                     const uint8_t* __restrict__ member,
                     int32_t* __restrict__ out, int W, int P, int rows,
                     int slots, int groups) {
  using T = bt::Tile<B>;
  __shared__ __align__(16) bt::Ring<B, NS> ring;

  const int s0 = blockIdx.z * NS;  // of the batch's `slots`
  const int r0 = (blockIdx.z / groups) * W;  // the window's first row
  const int v0 = blockIdx.y * B;
  const int w0 = blockIdx.x * B;
  float acc[NS][T::kTM][T::kTN];
  bt::count_tile<B, NS, true>(ring, la, fd, member, rows, P, slots, s0,
                              r0 + v0, r0 + w0, acc);

  const int tx = threadIdx.x % T::kThreadsX;
  const int ty = threadIdx.x / T::kThreadsX;
  const bool words = W % 4 == 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    int32_t* plane = out + static_cast<size_t>(s0 + s) * W * W;
#pragma unroll
    for (int i = 0; i < T::kTM; ++i) {
      const int v = v0 + T::row(ty, i);
      if (v >= W) continue;
      int32_t* row = plane + static_cast<size_t>(v) * W;
#pragma unroll
      for (int j0 = 0; j0 < T::kTN; j0 += 4) {
        const int w = w0 + T::col(tx, j0);
        if (w >= W) continue;
        const int4 c = make_int4(static_cast<int>(acc[s][i][j0]),
                                 static_cast<int>(acc[s][i][j0 + 1]),
                                 static_cast<int>(acc[s][i][j0 + 2]),
                                 static_cast<int>(acc[s][i][j0 + 3]));
        if (words) {  // w + 3 < W, and the word is 16-byte aligned
          *reinterpret_cast<int4*>(row + w) = c;
        } else {
          const int cs[4] = {c.x, c.y, c.z, c.w};
          for (int j = 0; j < 4 && w + j < W; ++j) row[w + j] = cs[j];
        }
      }
    }
  }
}

template <int B, int NS>
int launch(const void* la, const void* fd, const void* member, void* out,
           int nb, int W, int P, int S, void* stream) {
  const int groups = S / NS;
  const dim3 grid((W + B - 1) / B, (W + B - 1) / B, nb * groups);
  member_ss_kernel<B, NS><<<grid, bt::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(la), static_cast<const int32_t*>(fd),
      static_cast<const uint8_t*>(member), static_cast<int32_t*>(out), W, P,
      nb * W, nb * S, groups);
  return static_cast<int>(cudaGetLastError());
}

// Slots per block: two where S is even, else one.
int slots_per_block(int S) { return S % 2 == 0 ? 2 : 1; }

}  // namespace

extern "C" {

// Side of the output tile K1 takes for B windows of W voters and S slots:
// 32 or 128.
int bt_member_ss_tile(int B, int W, int S) {
  return bt::tile_side(W, B * (S / slots_per_block(S)));
}

// Launch K1 over B windows on `stream`; returns the cudaError_t of the
// launch (0 = ok). Pointers are device pointers; nothing is allocated or
// synchronised here.
int bt_member_ss_counts(const void* la, const void* fd, const void* member,
                        void* out, int B, int W, int P, int S,
                        void* stream) {
  if (B <= 0 || W <= 0 || P < 0 || S <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ns = slots_per_block(S);
  if (static_cast<long long>(B) * (S / ns) > 65535 ||
      static_cast<long long>(B) * W > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const bool large = bt_member_ss_tile(B, W, S) == 128;
  if (ns == 1) {
    return large ? launch<128, 1>(la, fd, member, out, B, W, P, S, stream)
                 : launch<32, 1>(la, fd, member, out, B, W, P, S, stream);
  }
  return large ? launch<128, 2>(la, fd, member, out, B, W, P, S, stream)
               : launch<32, 2>(la, fd, member, out, B, W, P, S, stream);
}

}  // extern "C"
