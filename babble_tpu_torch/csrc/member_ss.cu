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
// fd = INT32_MAX. The kernel computes the product by member, exactly, for
// every pair of int32 values. The Pallas wrapper folds membership into fd
// as INT32_MAX instead (pallas_kernels.py:100-102); the two agree wherever
// la stays below INT32_MAX, which last-ancestor indexes always do. That is
// K1's stated domain.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s of 32-bit
// operations): it reads 8*W*P + S*P bytes, writes 4*S*W^2 bytes and does
// S*W^2*P compare-adds. At the live shapes (W a power of two from 16 to
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
// slot when S = 1 and two otherwise (blockIdx.z = slot pair). The 128 tile
// is taken where it still gives two blocks per SM (W over 2048), the 32
// tile below, so that the live buckets spread over the SMs. The epilogue
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
                     int32_t* __restrict__ out, int W, int P, int S) {
  using T = bt::Tile<B>;
  __shared__ __align__(16) bt::Ring<B, NS> ring;

  const int s0 = blockIdx.z * NS;
  const int v0 = blockIdx.y * B;
  const int w0 = blockIdx.x * B;
  float acc[NS][T::kTM][T::kTN];
  bt::count_tile<B, NS, true>(ring, la, fd, member, W, P, S, s0, v0, w0,
                              acc);

  const int tx = threadIdx.x % T::kThreadsX;
  const int ty = threadIdx.x / T::kThreadsX;
  const bool words = W % 4 == 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s0 + s >= S) break;
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
           int W, int P, int S, int groups, void* stream) {
  const dim3 grid((W + B - 1) / B, (W + B - 1) / B, groups);
  member_ss_kernel<B, NS><<<grid, bt::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(la), static_cast<const int32_t*>(fd),
      static_cast<const uint8_t*>(member), static_cast<int32_t*>(out), W, P,
      S);
  return static_cast<int>(cudaGetLastError());
}

// Slots per block: one for S = 1, else two.
int slots_per_block(int S) { return S == 1 ? 1 : 2; }

}  // namespace

extern "C" {

// Side of the output tile K1 takes for W voters and S slots: 32 or 128.
int bt_member_ss_tile(int W, int S) {
  const int ns = slots_per_block(S);
  return bt::tile_side(W, (S + ns - 1) / ns);
}

// Launch K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// Pointers are device pointers; nothing is allocated or synchronised here.
int bt_member_ss_counts(const void* la, const void* fd, const void* member,
                        void* out, int W, int P, int S, void* stream) {
  if (W <= 0 || P < 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool large = bt_member_ss_tile(W, S) == 128;
  if (S == 1) {
    return large ? launch<128, 1>(la, fd, member, out, W, P, S, 1, stream)
                 : launch<32, 1>(la, fd, member, out, W, P, S, 1, stream);
  }
  const int groups = (S + 1) / 2;
  return large ? launch<128, 2>(la, fd, member, out, W, P, S, groups, stream)
               : launch<32, 2>(la, fd, member, out, W, P, S, groups, stream);
}

}  // extern "C"
