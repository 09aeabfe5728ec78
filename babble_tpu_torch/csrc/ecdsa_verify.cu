// K3: batched secp256k1 ECDSA verification, the Shamir ladder.
//
// Replaces the JAX package's device program _shamir_kernel
// (babble_tpu/ops/verify.py:127-169; its point operations _double :55 and
// _add_mixed :74, its field layer babble_tpu/ops/limbs.py). XLA runs it on
// the TPU; it has no Pallas form. Per signature b:
//
//     out[b] = x(u1 G + u2 Q) = r (mod n), checked projectively as
//              Z != 0 and (X == r Z^2 or (rn_ok and X == rn Z^2))
//
// u1, u2, r, rn: int32 [B, 16] little-endian 16-bit limbs in [0, 2^16);
// table_x, table_y: int32 [B, 4, 16] (entry 1 = G, 2 = Q, 3 = G + Q,
// entry 0 unused); table_inf: torch.bool [B, 4]; rn_ok: torch.bool [B];
// out: torch.bool [B]. The host (babble_tpu_torch/ops/verify.py
// _prepare) computes u1, u2, the table and r + n and ANDs its own
// range-and-curve verdict into out.
//
// The TPU form holds 16-bit limbs in uint32 lanes because the TPU has no
// 64-bit multiply (babble_tpu/ops/limbs.py:3-8). Here one thread keeps a
// field element in eight 32-bit registers and multiplies 32 x 32 -> 64 bits
// (schoolbook, 64 partial products), folds the 512-bit product twice with
// 2^256 = 2^32 + 977 (mod p) and subtracts p once, so every value leaves
// canonical. Add and subtract compute exactly the JAX package's values:
// s = a + b, then s - p (mod 2^256) where s reaches 2^256 or p; a - b as
// a + ((p - b) mod 2^256). The point operations are the JAX package's
// (dbl-2009-l doubling, the mixed addition), and the degenerate cases keep
// its order of priority: P2 infinite -> P1; P1 infinite -> P2 lifted;
// P1 == -P2 -> infinity (Z = Z1 H = 0); P1 == P2 -> the doubling of P1;
// else the general addition. Table entry 0 and entries marked infinite are
// infinite. The JAX program computes every case and selects; here a
// thread branches to the one it needs, which gives the same values.
//
// What bounds it on an H100 SXM: integer multiplies. A signature takes 256
// doublings (2M + 5S: 7 field multiplications) and, for each table entry
// that is not infinite (3 in 4 steps on random scalars), a mixed addition
// (8M + 3S: 11), about 3,900 field multiplications, each 64 32 x 32-bit
// products, 128 multiply instructions counting low and high words: about
// 5e5 a signature. The card's 32-bit integer multiply rate is 64 a clock
// per SM for compute capability 9.0 (CUDA C Programming Guide, arithmetic
// throughput table), times 132 SMs, times the SM clock. The bytes (about
// 700 a signature) weigh nothing beside that. At small B the operation
// bound is not what sets the time: one thread runs a dependent chain of
// about 3,900 field multiplications, so a launch takes that chain's
// latency however few signatures it holds.
//
// The design of this first form: one thread per signature, 128 threads a
// block. A thread packs its table into shared memory (laid out
// [word][thread], so a warp reads 32 banks) and keeps its point and
// temporaries in registers; u1 and u2 are read from global memory one
// 16-bit limb at a time. Nothing is shared between threads, so there is
// no barrier. The doubling is written once: a step that finds P1 == P2
// loops back to it. The ptxas report (kernels.ptxas_report) gives its
// registers and spills; a form with several threads a signature, or a
// wider window, is later work.
//
// bt_field_ops, a test entry on the same device functions, applies mul,
// sqr, add or sub mod p elementwise to [B, 16] limb arrays, so that the
// card can hold the field layer against Python integers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWords = 8;

// p = 2^256 - 2^32 - 977, little-endian 32-bit words
__device__ __forceinline__ uint32_t p_word(int i) {
  return i == 0 ? 0xFFFFFC2Fu : (i == 1 ? 0xFFFFFFFEu : 0xFFFFFFFFu);
}

struct Fe {
  uint32_t w[kWords];
};

__device__ __forceinline__ void fe_load(Fe& a, const int32_t* limbs) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    a.w[i] = static_cast<uint32_t>(limbs[2 * i]) |
             (static_cast<uint32_t>(limbs[2 * i + 1]) << 16);
  }
}

__device__ __forceinline__ void fe_store(int32_t* limbs, const Fe& a) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    limbs[2 * i] = static_cast<int32_t>(a.w[i] & 0xFFFFu);
    limbs[2 * i + 1] = static_cast<int32_t>(a.w[i] >> 16);
  }
}

__device__ __forceinline__ void fe_zero(Fe& a) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) a.w[i] = 0;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) acc |= a.w[i];
  return acc == 0;
}

__device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) acc |= a.w[i] ^ b.w[i];
  return acc == 0;
}

// d = (s + C) mod 2^256 with C = 2^32 + 977, which is (s - p) mod 2^256;
// returns the carry out of 2^256, which for s < 2^256 is s >= p.
__device__ __forceinline__ uint32_t fe_plus_c(Fe& d, const Fe& s) {
  uint64_t v = static_cast<uint64_t>(s.w[0]) + 977u;
  d.w[0] = static_cast<uint32_t>(v);
  v = static_cast<uint64_t>(s.w[1]) + 1u + (v >> 32);
  d.w[1] = static_cast<uint32_t>(v);
#pragma unroll
  for (int i = 2; i < kWords; ++i) {
    v = static_cast<uint64_t>(s.w[i]) + (v >> 32);
    d.w[i] = static_cast<uint32_t>(v);
  }
  return static_cast<uint32_t>(v >> 32);
}

// r = a + b, reduced as the JAX package's add_mod_p: s - p (mod 2^256)
// where s = a + b reaches 2^256 or p, else s. r may alias a or b.
__device__ __forceinline__ void fe_add(Fe& r, const Fe& a, const Fe& b) {
  Fe s, d;
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    v = static_cast<uint64_t>(a.w[i]) + b.w[i] + (v >> 32);
    s.w[i] = static_cast<uint32_t>(v);
  }
  const uint32_t top = static_cast<uint32_t>(v >> 32);
  const uint32_t ge = fe_plus_c(d, s) | top;
#pragma unroll
  for (int i = 0; i < kWords; ++i) r.w[i] = ge ? d.w[i] : s.w[i];
}

// r = a - b as the JAX package's sub_mod_p: a + ((p - b) mod 2^256).
__device__ __forceinline__ void fe_sub(Fe& r, const Fe& a, const Fe& b) {
  Fe pb;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint64_t v = static_cast<uint64_t>(p_word(i)) - b.w[i] - borrow;
    pb.w[i] = static_cast<uint32_t>(v);
    borrow = static_cast<uint32_t>(v >> 32) & 1u;
  }
  fe_add(r, a, pb);
}

// r = t mod p, canonical, for the 512-bit product t (16 words).
__device__ __forceinline__ void fe_reduce(Fe& r, const uint32_t* t) {
  // fold 1: lo + hi * 977 + hi * 2^32; each column below 2^43
  Fe z;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t v = static_cast<uint64_t>(t[kWords + i]) * 977u + t[i] + c;
    if (i > 0) v += t[kWords + i - 1];
    z.w[i] = static_cast<uint32_t>(v);
    c = v >> 32;
  }
  // the weight-2^256 word, below 2^33: fold 2 adds top * 977 + top * 2^32
  const uint64_t top = c + t[2 * kWords - 1];
  uint64_t v = static_cast<uint64_t>(z.w[0]) + top * 977u;
  z.w[0] = static_cast<uint32_t>(v);
  v = static_cast<uint64_t>(z.w[1]) + top + (v >> 32);
  z.w[1] = static_cast<uint32_t>(v);
#pragma unroll
  for (int i = 2; i < kWords; ++i) {
    v = static_cast<uint64_t>(z.w[i]) + (v >> 32);
    z.w[i] = static_cast<uint32_t>(v);
  }
  // a carry out here leaves z below 2^67: adding C once more cannot carry
  const uint32_t c2 = static_cast<uint32_t>(v >> 32);
  v = static_cast<uint64_t>(z.w[0]) + 977u * c2;
  z.w[0] = static_cast<uint32_t>(v);
  v = static_cast<uint64_t>(z.w[1]) + c2 + (v >> 32);
  z.w[1] = static_cast<uint32_t>(v);
#pragma unroll
  for (int i = 2; i < kWords; ++i) {
    v = static_cast<uint64_t>(z.w[i]) + (v >> 32);
    z.w[i] = static_cast<uint32_t>(v);
  }
  // z < 2^256 < 2p: subtract p once where z >= p
  Fe d;
  const uint32_t ge = fe_plus_c(d, z);
#pragma unroll
  for (int i = 0; i < kWords; ++i) r.w[i] = ge ? d.w[i] : z.w[i];
}

// r = a * b mod p. r may alias a or b.
__device__ __forceinline__ void fe_mul(Fe& r, const Fe& a, const Fe& b) {
  uint32_t t[2 * kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      // (2^32 - 1)^2 + 2 (2^32 - 1) = 2^64 - 1: no overflow
      const uint64_t v =
          static_cast<uint64_t>(a.w[i]) * b.w[j] + t[i + j] + c;
      t[i + j] = static_cast<uint32_t>(v);
      c = v >> 32;
    }
    t[i + kWords] = static_cast<uint32_t>(c);
  }
  fe_reduce(r, t);
}

__device__ __forceinline__ void fe_sqr(Fe& r, const Fe& a) { fe_mul(r, a, a); }

// (X, Y, Z) = 2 (X, Y, Z), dbl-2009-l for a = 0 (JAX _double); infinity
// (Z = 0) stays infinity.
__device__ __forceinline__ void pt_double(Fe& X, Fe& Y, Fe& Z) {
  Fe A, B, C, D, E, t;
  fe_sqr(A, X);
  fe_sqr(B, Y);
  fe_sqr(C, B);
  fe_add(t, X, B);
  fe_sqr(t, t);
  fe_sub(D, t, A);
  fe_sub(D, D, C);
  fe_add(D, D, D);  // 2 ((X + B)^2 - A - C)
  fe_add(E, A, A);
  fe_add(E, E, A);  // 3 A
  fe_mul(Z, Y, Z);
  fe_add(Z, Z, Z);  // Z3 = 2 Y Z, before Y is overwritten
  fe_sqr(X, E);     // F = E^2
  fe_add(t, D, D);
  fe_sub(X, X, t);  // X3 = F - 2 D
  fe_add(C, C, C);
  fe_add(C, C, C);
  fe_add(C, C, C);  // 8 C
  fe_sub(t, D, X);
  fe_mul(Y, E, t);
  fe_sub(Y, Y, C);  // Y3 = E (D - X3) - 8 C
}

// (X1, Y1, Z1) += (x2, y2, 1) for P1 finite, P2 finite (JAX _add_mixed's
// remaining cases). Returns true, leaving P1 as it was, when P1 == P2: the
// caller then doubles P1. P1 == -P2 gives Z = Z1 H = 0, infinity.
__device__ __forceinline__ bool pt_add_finite(Fe& X1, Fe& Y1, Fe& Z1,
                                              const Fe& x2, const Fe& y2) {
  Fe Z1Z1, H, R, t;
  fe_sqr(Z1Z1, Z1);
  fe_mul(H, x2, Z1Z1);  // U2
  fe_sub(H, H, X1);     // H = U2 - X1
  fe_mul(t, Z1, Z1Z1);
  fe_mul(R, y2, t);     // S2
  fe_sub(R, R, Y1);     // R = S2 - Y1
  if (fe_is_zero(H) && fe_is_zero(R)) return true;
  Fe HH, HHH;
  fe_sqr(HH, H);
  fe_mul(HHH, H, HH);
  fe_mul(Z1, Z1, H);    // Z3 = Z1 H
  fe_mul(t, X1, HH);    // U1HH
  fe_sqr(X1, R);
  fe_sub(X1, X1, HHH);
  fe_add(HH, t, t);     // HH now holds 2 U1HH
  fe_sub(X1, X1, HH);   // X3 = R^2 - HHH - 2 U1HH
  fe_sub(t, t, X1);     // U1HH - X3
  fe_mul(HH, Y1, HHH);  // Y1 HHH
  fe_mul(Y1, R, t);
  fe_sub(Y1, Y1, HH);   // Y3 = R (U1HH - X3) - Y1 HHH
  return false;
}

// The final check of JAX _shamir_kernel (verify.py:164-169).
__device__ __forceinline__ bool projective_check(const Fe& X, const Fe& Z,
                                                 const int32_t* r,
                                                 const int32_t* rn,
                                                 bool rn_ok) {
  if (fe_is_zero(Z)) return false;
  Fe Z2, v, t;
  fe_sqr(Z2, Z);
  fe_load(v, r);
  fe_mul(t, v, Z2);
  const bool ok_r = fe_eq(X, t);
  fe_load(v, rn);
  fe_mul(t, v, Z2);
  return ok_r || (rn_ok && fe_eq(X, t));
}

__global__ void __launch_bounds__(kThreads)
    ecdsa_shamir_kernel(const int32_t* __restrict__ u1,
                        const int32_t* __restrict__ u2,
                        const int32_t* __restrict__ table_x,
                        const int32_t* __restrict__ table_y,
                        const uint8_t* __restrict__ table_inf,
                        const int32_t* __restrict__ r,
                        const int32_t* __restrict__ rn,
                        const uint8_t* __restrict__ rn_ok,
                        uint8_t* __restrict__ out, int B) {
  // entries 1..3 of the thread's table: [(entry - 1) * 2 + coord][word]
  __shared__ uint32_t tab[3 * 2 * kWords][kThreads];
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kThreads + tid;
  if (b >= B) return;

  const size_t row = static_cast<size_t>(b) * 4 * 16;
  uint32_t inf = 0;  // bit e: entry e infinite
#pragma unroll
  for (int e = 0; e < 4; ++e) inf |= (table_inf[b * 4 + e] ? 1u : 0u) << e;
  for (int e = 1; e < 4; ++e) {
    Fe x, y;
    fe_load(x, table_x + row + e * 16);
    fe_load(y, table_y + row + e * 16);
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      tab[((e - 1) * 2) * kWords + i][tid] = x.w[i];
      tab[((e - 1) * 2 + 1) * kWords + i][tid] = y.w[i];
    }
  }

  const int32_t* s1 = u1 + static_cast<size_t>(b) * 16;
  const int32_t* s2 = u2 + static_cast<size_t>(b) * 16;
  Fe X, Y, Z;
  fe_zero(X);
  fe_zero(Y);
  fe_zero(Z);  // infinity
  uint32_t limb1 = 0, limb2 = 0;
#pragma unroll 1
  for (int bit = 255; bit >= 0; --bit) {
    const int sh = bit & 15;
    if (sh == 15) {
      limb1 = static_cast<uint32_t>(s1[bit >> 4]);
      limb2 = static_cast<uint32_t>(s2[bit >> 4]);
    }
    const uint32_t sel = ((limb1 >> sh) & 1u) | (((limb2 >> sh) & 1u) << 1);
    const bool inf2 = sel == 0 || ((inf >> sel) & 1u);
    // double, then add the table entry; P1 == P2 loops back to double
    // again (the doubling is written once)
    bool again = true;
#pragma unroll 1
    for (int pass = 0; again; ++pass) {
      pt_double(X, Y, Z);
      again = false;
      if (pass > 0 || inf2) break;
      Fe x2, y2;
      const int base = (static_cast<int>(sel) - 1) * 2 * kWords;
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        x2.w[i] = tab[base + i][tid];
        y2.w[i] = tab[base + kWords + i][tid];
      }
      if (fe_is_zero(Z)) {  // P1 infinite: P2 lifted
        X = x2;
        Y = y2;
        fe_zero(Z);
        Z.w[0] = 1;
      } else {
        again = pt_add_finite(X, Y, Z, x2, y2);
      }
    }
  }
  out[b] = projective_check(X, Z, r + static_cast<size_t>(b) * 16,
                            rn + static_cast<size_t>(b) * 16, rn_ok[b] != 0)
               ? 1
               : 0;
}

// op: 0 mul, 1 sqr (of a), 2 add, 3 sub
__global__ void __launch_bounds__(kThreads)
    field_ops_kernel(int op, const int32_t* __restrict__ a,
                     const int32_t* __restrict__ b, int32_t* __restrict__ out,
                     int B) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  Fe x, y, z;
  fe_load(x, a + static_cast<size_t>(i) * 16);
  fe_load(y, b + static_cast<size_t>(i) * 16);
  switch (op) {
    case 0: fe_mul(z, x, y); break;
    case 1: fe_sqr(z, x); break;
    case 2: fe_add(z, x, y); break;
    default: fe_sub(z, x, y); break;
  }
  fe_store(out + static_cast<size_t>(i) * 16, z);
}

int blocks(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Launch K3 over B signatures on `stream`; returns the cudaError_t of the
// launch (0 = ok). Pointers are device pointers; nothing is allocated or
// synchronised here.
int bt_ecdsa_shamir(const void* u1, const void* u2, const void* table_x,
                    const void* table_y, const void* table_inf, const void* r,
                    const void* rn, const void* rn_ok, void* out, int B,
                    void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ecdsa_shamir_kernel<<<blocks(B), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(u1), static_cast<const int32_t*>(u2),
      static_cast<const int32_t*>(table_x),
      static_cast<const int32_t*>(table_y),
      static_cast<const uint8_t*>(table_inf), static_cast<const int32_t*>(r),
      static_cast<const int32_t*>(rn), static_cast<const uint8_t*>(rn_ok),
      static_cast<uint8_t*>(out), B);
  return static_cast<int>(cudaGetLastError());
}

// Apply field operation `op` (0 mul, 1 sqr, 2 add, 3 sub) to B pairs of
// [16] limb rows on `stream`; returns the launch's cudaError_t.
int bt_field_ops(int op, const void* a, const void* b, void* out, int B,
                 void* stream) {
  if (B <= 0 || op < 0 || op > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  field_ops_kernel<<<blocks(B), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
