// Shared tile loop of the strongly-see kernels K1 (member_ss.cu) and K2
// (strongly_see.cu), for Hopper (sm_90a).
//
// Both count, for every (x, y) of an output tile, the peers p with
// la[x, p] >= fd[y, p] over row-major int32 [n, P] coordinate matrices. What
// the loop does, and why:
//
// - Register tiles. A block of 256 threads covers a B x B output tile, each
//   thread a TM x TN tile of counters: B = 128 with 8 x 8 per thread for
//   large outputs, B = 32 with 1 x 4 per thread for small ones (Tile<B>).
//   For one p a thread reads its TM la words and TN fd words with 4- or
//   16-byte shared loads and does TM * TN compare-adds: a staged word feeds
//   several compare-adds, so shared-memory loads do not set the pace.
// - P-major staging. The peer axis streams through a ring of kChunk-peer
//   chunks in shared memory laid out [p][row], transposed from the [n, P] layout
//   during the copy; each [p] row is padded to B + 4 words. A thread's four
//   columns (or rows) at one p are one aligned 16-byte load, and the column
//   groups of a warp fall on distinct banks.
// - Copy and compute overlap. Every word is copied by a 4-byte cp.async
//   (which may scatter into the transposed layout), so later chunks load
//   while the current one is compared (Tile<B> sets the stages). Shared
//   memory does not grow with P.
// - An exact compare-accumulate. setp.ge.s32 (ISETP, on the integer pipe)
//   and an add of the peer's weight predicated on it (FADD, on the FMA
//   pipe): two instructions per compare-add, on two pipes. The compare is
//   the signed 32-bit one, exact for every pair of int32 values; the float
//   counter is exact while it stays at or below 2^24, which the wrappers'
//   limit on P keeps (ops/kernels.py).
// - Sentinels. Rows past n are staged as la = -1 and fd = INT32_MAX, and so
//   are peers past P; la = -1 never reaches fd = INT32_MAX, so a padded peer
//   never counts and the ragged edges need no padding in memory.
//
// K1 passes its slots' membership as weights (1 or 0 per slot and peer),
// staged beside each chunk: one compare per (v, w, p) feeds the counter of
// every slot. K2 adds the constant 1.

#pragma once

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace bt {

constexpr int kThreads = 256;
// Peers per chunk of the ring. A longer chunk would compare padding at
// P = 16, where the 16-validator paths run.
constexpr int kChunk = 16;
constexpr int kSMs = 132;  // streaming multiprocessors of an H100 SXM

// A B x B output tile over 256 threads, TM x TN counters each, and a ring of
// kStages chunks, compared kUnroll peers to a loop turn.
// Thread (ty, tx) = (t / kThreadsX, t % kThreadsX) owns rows row(ty, i),
// i < TM, and columns col(tx, j), j < TN: runs of four at stride
// B / (TN / 4) (and likewise for rows when TM >= 4).
template <int B, int TM, int TN, int Stages, int Unroll>
struct TileShape {
  static constexpr int kB = B;
  static constexpr int kTM = TM;
  static constexpr int kTN = TN;
  static constexpr int kStages = Stages;
  static constexpr int kUnroll = Unroll;
  static constexpr int kThreadsX = B / TN;
  static constexpr int kStride = B + 4;  // words per staged [p] row
  static_assert((B / TM) * (B / TN) == kThreads, "256 threads a block");
  static_assert(TN % 4 == 0 && (TM < 4 || TM % 4 == 0), "runs of four");
  static_assert(B % (kThreads / kChunk) == 0, "whole staging passes");

  static __device__ __forceinline__ int row(int ty, int i) {
    if constexpr (TM < 4) {
      return ty * TM + i;
    } else {
      return (i / 4) * (B / (TM / 4)) + ty * 4 + i % 4;
    }
  }
  static __device__ __forceinline__ int col(int tx, int j) {
    return (j / 4) * (B / (TN / 4)) + tx * 4 + j % 4;
  }
};

// The 128 tile: 8 x 8 counters a thread, whose chunk takes long enough to
// compare that two stages hide the next load. The 32 tile: 1 x 4 counters
// a thread, its chunk fully unrolled so that loop overhead weighs less
// against so few counters, and four stages, so that a 64-peer axis is in
// flight at once.
template <int B>
struct Tile;
template <>
struct Tile<32> : TileShape<32, 1, 4, 4, 16> {};
template <>
struct Tile<128> : TileShape<128, 8, 8, 2, 4> {};

// Blocks per SM each instantiation is compiled for: a thread of the 128
// tile holds 64 counters per slot.
template <int B, int NS>
constexpr int kBlocksPerSM = B == 32 ? 4 : (NS == 1 ? 2 : 1);

// The ring of one block: la and fd chunks, and NS weight rows.
template <int B, int NS>
struct Ring {
  int32_t la[Tile<B>::kStages][kChunk][Tile<B>::kStride];
  int32_t fd[Tile<B>::kStages][kChunk][Tile<B>::kStride];
  float weight[Tile<B>::kStages][NS][kChunk];
};

// The tile side for an [n, n] output in `groups` grid layers: the 128 tile
// where it still gives two blocks per SM, else the 32 tile, so that small
// outputs spread over the SMs.
inline int tile_side(int n, int groups) {
  const long long t = (n + 127) / 128;
  return t * t * groups >= 2 * kSMs ? 128 : 32;
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + B) and peers [p0, p0 + kChunk) of `src` ([n, P],
// row-major) into `dst` ([kChunk][kStride]), transposed. Words outside the
// matrix hold `fill`. Thread t copies peer t % kChunk of rows t / kChunk +
// 16 k, so consecutive threads read consecutive peers of a row. A chunk
// inside the matrix on both axes (every chunk of a block whose rows and
// peers are all there; uniform across the block) skips the bounds checks.
template <int B>
__device__ __forceinline__ void stage_chunk(
    int32_t (*dst)[Tile<B>::kStride], const int32_t* __restrict__ src,
    int n, int P, int r0, int p0, int32_t fill) {
  constexpr int kRowStep = kThreads / kChunk;
  const int p = threadIdx.x % kChunk;
  const int r = threadIdx.x / kChunk;
  const int col = p0 + p;
  const size_t step = static_cast<size_t>(kRowStep) * P;
  if (r0 + B <= n && p0 + kChunk <= P) {
    const int32_t* from = src + static_cast<size_t>(r0 + r) * P + col;
#pragma unroll
    for (int k = 0; k < B / kRowStep; ++k) {
      cp_async4(&dst[p][r + k * kRowStep], from + k * step);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < B / kRowStep; ++k) {
    const int row = r0 + r + k * kRowStep;
    if (row < n && col < P) {
      cp_async4(&dst[p][r + k * kRowStep],
                src + static_cast<size_t>(row) * P + col);
    } else {
      dst[p][r + k * kRowStep] = fill;
    }
  }
}

// acc += 1 where a >= b.
__device__ __forceinline__ void ge_add(float& acc, int32_t a, int32_t b) {
  asm("{\n\t.reg .pred q;\n\tsetp.ge.s32 q, %1, %2;\n\t"
      "@q add.f32 %0, %0, 0f3F800000;\n\t}"
      : "+f"(acc)
      : "r"(a), "r"(b));
}

// acc += w where a >= b.
__device__ __forceinline__ void ge_add(float& acc, int32_t a, int32_t b,
                                       float w) {
  asm("{\n\t.reg .pred q;\n\tsetp.ge.s32 q, %1, %2;\n\t"
      "@q add.f32 %0, %0, %3;\n\t}"
      : "+f"(acc)
      : "r"(a), "r"(b), "f"(w));
}

// acc0 += w0 and acc1 += w1 where a >= b: one compare for two slots.
__device__ __forceinline__ void ge_add(float& acc0, float& acc1, int32_t a,
                                       int32_t b, float w0, float w1) {
  asm("{\n\t.reg .pred q;\n\tsetp.ge.s32 q, %2, %3;\n\t"
      "@q add.f32 %0, %0, %4;\n\t@q add.f32 %1, %1, %5;\n\t}"
      : "+f"(acc0), "+f"(acc1)
      : "r"(a), "r"(b), "f"(w0), "f"(w1));
}

// The counters of this thread's TM x TN tile of the block tile at rows x0
// and columns y0: acc[s][i][j] = sum_p w[s, p] * (la[x0 + row(i), p] >=
// fd[y0 + col(j), p]), with w = 1 when `kWeighted` is false (K2), else
// w[s, p] = member[s0 + s, p] (K1; 0 for slots at or past S). Every thread
// of the block must call it.
template <int B, int NS, bool kWeighted>
__device__ __forceinline__ void count_tile(
    Ring<B, NS>& ring, const int32_t* __restrict__ la,
    const int32_t* __restrict__ fd, const uint8_t* __restrict__ member,
    int n, int P, int S, int s0, int x0, int y0,
    float (&acc)[NS][Tile<B>::kTM][Tile<B>::kTN]) {
  using T = Tile<B>;
  static_assert(NS == 1 || (kWeighted && NS == 2), "one or two slots");
  const int tx = threadIdx.x % T::kThreadsX;
  const int ty = threadIdx.x / T::kThreadsX;
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < T::kTM; ++i)
#pragma unroll
      for (int j = 0; j < T::kTN; ++j) acc[s][i][j] = 0.f;

  // Thread t < NS * kChunk carries the weight of slot s0 + t / kChunk at
  // peer t % kChunk of a chunk.
  const bool carries = kWeighted && threadIdx.x < NS * kChunk;
  const int ws = threadIdx.x / kChunk;
  const int wp = threadIdx.x % kChunk;
  auto weight = [&](int c) {
    const int s = s0 + ws;
    const int p = c * kChunk + wp;
    return carries && s < S && p < P &&
                   member[static_cast<size_t>(s) * P + p]
               ? 1.f
               : 0.f;
  };
  auto stage = [&](int c) {
    const int buf = c % T::kStages;
    stage_chunk<B>(ring.la[buf], la, n, P, x0, c * kChunk, -1);
    stage_chunk<B>(ring.fd[buf], fd, n, P, y0, c * kChunk, INT_MAX);
  };

  const int chunks = (P + kChunk - 1) / kChunk;
  if (chunks == 0) return;
  // The first chunks' weights are loaded before any copy is issued, so
  // that their loads overlap one another and the copies.
  float w_first[T::kStages - 1];
#pragma unroll
  for (int c = 0; c < T::kStages - 1; ++c) {
    w_first[c] = c < chunks ? weight(c) : 0.f;
  }
  // One commit group per chunk index, empty past the last chunk, so that
  // waiting for all but the newest kStages - 2 groups waits for chunk c.
#pragma unroll
  for (int c = 0; c < T::kStages - 1; ++c) {
    if (c < chunks) stage(c);
    cp_async_commit();
  }
  if (carries) {
#pragma unroll
    for (int c = 0; c < T::kStages - 1; ++c) {
      ring.weight[c][ws][wp] = w_first[c];
    }
  }
  for (int c = 0; c < chunks; ++c) {
    const int buf = c % T::kStages;
    const int next = c + T::kStages - 1;
    cp_async_wait<T::kStages - 2>();
    // Chunk c is visible to every thread, and every thread is done with
    // chunk c - 1, whose buffer chunk `next` takes.
    __syncthreads();
    float w_next = 0.f;
    if (next < chunks) {
      stage(next);
      if (carries) w_next = weight(next);  // stored after the compare
    }
    cp_async_commit();

#pragma unroll (T::kUnroll)
    for (int p = 0; p < kChunk; ++p) {
      const int32_t* la_p = ring.la[buf][p];
      const int32_t* fd_p = ring.fd[buf][p];
      int32_t a[T::kTM];
      int32_t b[T::kTN];
      if constexpr (T::kTM < 4) {
#pragma unroll
        for (int i = 0; i < T::kTM; ++i) a[i] = la_p[T::row(ty, i)];
      } else {
#pragma unroll
        for (int i = 0; i < T::kTM; i += 4) {
          const int4 v = *reinterpret_cast<const int4*>(la_p + T::row(ty, i));
          a[i] = v.x;
          a[i + 1] = v.y;
          a[i + 2] = v.z;
          a[i + 3] = v.w;
        }
      }
#pragma unroll
      for (int j = 0; j < T::kTN; j += 4) {
        const int4 v = *reinterpret_cast<const int4*>(fd_p + T::col(tx, j));
        b[j] = v.x;
        b[j + 1] = v.y;
        b[j + 2] = v.z;
        b[j + 3] = v.w;
      }
      float w[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        w[s] = kWeighted ? ring.weight[buf][s][p] : 1.f;
      }
#pragma unroll
      for (int i = 0; i < T::kTM; ++i) {
#pragma unroll
        for (int j = 0; j < T::kTN; ++j) {
          if constexpr (!kWeighted) {
            ge_add(acc[0][i][j], a[i], b[j]);
          } else if constexpr (NS == 1) {
            ge_add(acc[0][i][j], a[i], b[j], w[0]);
          } else {
            ge_add(acc[0][i][j], acc[1][i][j], a[i], b[j], w[0], w[1]);
          }
        }
      }
    }

    if (next < chunks && carries) {
      ring.weight[next % T::kStages][ws][wp] = w_next;
    }
  }
}

}  // namespace bt
