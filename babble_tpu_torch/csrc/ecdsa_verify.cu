// K3: batched secp256k1 ECDSA verification, the Shamir ladder, G lanes a
// signature.
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
// What bounds it on an H100 SXM. A signature is a dependent chain of 256
// doublings (2M + 5S) and, for each finite table entry (3 in 4 steps), a
// mixed addition (8M + 3S): about 3,900 field multiplications. A full one
// is 64 32 x 32-bit products, 128 multiply instructions (low and high
// words); a one-lane square forms 36 (72 instructions), so a signature
// needs about 4e5 multiply instructions at G = 1 and 5e5 at G = 4. At small
// B the chain's latency sets the time: one thread a signature waits on
// every carry of every product in turn. At large B the card's 32-bit
// integer multiplies (64 a clock per SM, times 132 SMs) do, and with them
// every other integer instruction, which issues at the same rate: the
// bytes (about 700 a signature) weigh nothing beside them.
//
// The design. A group of G lanes of a warp (G = 1 or 4) works on one
// signature; lane k holds the W = 8 / G little-endian 32-bit words k W ..
// k W + W - 1 of every field element, and reads its own limbs of the
// inputs, so neighbouring lanes read neighbouring words. A multiplication
// gathers b over the group (shuffles), forms the lane's rows a_k x b with
// mad.lo.cc / madc.hi.cc chains, sums the rows' W-word pieces into each
// lane's low and high chunk (shuffles), folds the high half with 2^256 =
// 2^32 + 977 (mod p), passes the excess words up one lane in two rounds
// (the top lane's folds again) and settles the last one-bit carries across
// the group with two ballots, as the addition of two G-bit numbers
// (generate and propagate bits) rather than G serial hops; then p is
// subtracted once where the value reaches p, so every value leaves
// canonical. With one lane there is nothing to gather or settle: the fold
// is one asm block of three chains, and a square forms its 28 cross
// products once, doubles them and adds the diagonal (36 products, not 64).
// Add and subtract compute exactly the JAX package's values: s = a + b,
// then s - p (mod 2^256) where s reaches 2^256 or p (a group-wide carry
// out, exact for non-canonical operands); a - b as a + ((p - b) mod
// 2^256). babble_tpu_torch/ops/lanes.py models this schedule in Python
// integers, step for step, for the CPU tests. Every carry chain is PTX
// (add.cc / addc, mad.lo.cc / madc.hi.cc), each inside one asm block, since
// the carry flag does not survive between asm statements. The field
// operations take their independent operands together (the doubling's
// X^2 and Y^2, ...): the same values, and on the card up to a tenth less
// time at G = 4, nothing at G = 1, whose carry chains stay serial.
//
// Against the chain's latency, G lanes split each multiplication's
// products and carries G ways; against the instruction rate at large B,
// one lane does less work a signature (no shuffles, ballots or cross-lane
// rounds, and the cheaper square). On the H100 G = 4 is fastest up to
// B = 4096, a quarter of a warp a signature, one warp per SM
// sub-partition at B = 4096, and G = 1 above: at B = 16384, G = 4 fills
// four times the warp slots but issues about four times the instructions,
// and takes twice as long (chip_smoke phase 10 times both at every B).
// G = 2 and G = 8 were built and timed too and lost to G = 4 at every B:
// G = 2 splits the chain too little, G = 8 spends more on shuffles than it
// saves. The C entry point picks G from B (bt_ecdsa_group). Blocks are 128
// threads, or one warp or a few where B G is smaller.
//
// Control flow is uniform across the warp, since a shuffle over lanes
// that diverged is undefined. Groups past B run the last signature again
// and store nothing: there is no early return. The point operations are
// the JAX package's (dbl-2009-l doubling, the mixed addition), every case
// computed and selected in its order of priority: P2 infinite -> P1; P1
// infinite -> P2 lifted; P1 == -P2 -> infinity (Z = Z1 H = 0); P1 == P2
// -> the doubling of P1, computed only when a group of the warp needs it
// (__any_sync); the addition is skipped only when every group of the warp
// has P2 infinite (__all_sync). Table entry 0 and entries marked infinite
// are infinite; the table's words wait in shared memory, [word][thread].
// The ptxas report (kernels.ptxas_report) gives each instance's registers
// and spills: none spills, and none keeps a stack frame.
//
// bt_field_ops, a test entry on the same device functions at a given G,
// applies mul, sqr, add or sub mod p to [B, 16] limb arrays, so that the
// card can hold the cooperative field layer against Python integers.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 128;  // threads a block (fewer for tiny batches)

// -- PTX carry chains inside one lane -----------------------------------------

// x[0..N) += y[0..N); returns the carry out of word N - 1.
template <int N>
__device__ __forceinline__ uint32_t add_n(uint32_t* x, const uint32_t* y);

template <>
__device__ __forceinline__ uint32_t add_n<2>(uint32_t* x, const uint32_t* y) {
  uint32_t c;
  asm volatile(
      "add.cc.u32 %0, %0, %3;\n\t"
      "addc.cc.u32 %1, %1, %4;\n\t"
      "addc.u32 %2, 0, 0;"
      : "+r"(x[0]), "+r"(x[1]), "=r"(c)
      : "r"(y[0]), "r"(y[1]));
  return c;
}

template <>
__device__ __forceinline__ uint32_t add_n<3>(uint32_t* x, const uint32_t* y) {
  uint32_t c;
  asm volatile(
      "add.cc.u32 %0, %0, %4;\n\t"
      "addc.cc.u32 %1, %1, %5;\n\t"
      "addc.cc.u32 %2, %2, %6;\n\t"
      "addc.u32 %3, 0, 0;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "=r"(c)
      : "r"(y[0]), "r"(y[1]), "r"(y[2]));
  return c;
}

template <>
__device__ __forceinline__ uint32_t add_n<4>(uint32_t* x, const uint32_t* y) {
  uint32_t c;
  asm volatile(
      "add.cc.u32 %0, %0, %5;\n\t"
      "addc.cc.u32 %1, %1, %6;\n\t"
      "addc.cc.u32 %2, %2, %7;\n\t"
      "addc.cc.u32 %3, %3, %8;\n\t"
      "addc.u32 %4, 0, 0;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "=r"(c)
      : "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]));
  return c;
}

template <>
__device__ __forceinline__ uint32_t add_n<8>(uint32_t* x, const uint32_t* y) {
  uint32_t c;
  asm volatile(
      "add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, 0, 0;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
        "+r"(x[5]), "+r"(x[6]), "+r"(x[7]), "=r"(c)
      : "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]),
        "r"(y[6]), "r"(y[7]));
  return c;
}

// R[0..10) += a * b[0..8): the low words in one chain, the high words in a
// second; the sum never passes 2^320 where the caller uses it.
__device__ __forceinline__ void mac_row(uint32_t* R, uint32_t a,
                                        const uint32_t* b) {
  asm volatile(
      "mad.lo.cc.u32 %0, %10, %11, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.lo.cc.u32 %3, %10, %14, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %15, %4;\n\t"
      "madc.lo.cc.u32 %5, %10, %16, %5;\n\t"
      "madc.lo.cc.u32 %6, %10, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %10, %18, %7;\n\t"
      "addc.cc.u32 %8, %8, 0;\n\t"
      "addc.u32 %9, %9, 0;\n\t"
      "mad.hi.cc.u32 %1, %10, %11, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.hi.cc.u32 %4, %10, %14, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %15, %5;\n\t"
      "madc.hi.cc.u32 %6, %10, %16, %6;\n\t"
      "madc.hi.cc.u32 %7, %10, %17, %7;\n\t"
      "madc.hi.cc.u32 %8, %10, %18, %8;\n\t"
      "addc.u32 %9, %9, 0;"
      : "+r"(R[0]), "+r"(R[1]), "+r"(R[2]), "+r"(R[3]), "+r"(R[4]),
        "+r"(R[5]), "+r"(R[6]), "+r"(R[7]), "+r"(R[8]), "+r"(R[9])
      : "r"(a), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]),
        "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// R[0..L+2) += a * b[0..L), as mac_row for a shorter b: the cross rows of
// a one-lane squaring.
template <int L>
__device__ __forceinline__ void mac_part(uint32_t* R, uint32_t a,
                                         const uint32_t* b);

template <>
__device__ __forceinline__ void mac_part<1>(uint32_t* R, uint32_t a,
                                            const uint32_t* b) {
  asm volatile(
      "mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.u32 %2, %2, 0;\n\t"
      "mad.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(R[0]), "+r"(R[1]), "+r"(R[2])
      : "r"(a), "r"(b[0]));
}

template <>
__device__ __forceinline__ void mac_part<2>(uint32_t* R, uint32_t a,
                                            const uint32_t* b) {
  asm volatile(
      "mad.lo.cc.u32 %0, %4, %5, %0;\n\t"
      "madc.lo.cc.u32 %1, %4, %6, %1;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.u32 %3, %3, 0;\n\t"
      "mad.hi.cc.u32 %1, %4, %5, %1;\n\t"
      "madc.hi.cc.u32 %2, %4, %6, %2;\n\t"
      "addc.u32 %3, %3, 0;"
      : "+r"(R[0]), "+r"(R[1]), "+r"(R[2]), "+r"(R[3])
      : "r"(a), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mac_part<3>(uint32_t* R, uint32_t a,
                                            const uint32_t* b) {
  asm volatile(
      "mad.lo.cc.u32 %0, %5, %6, %0;\n\t"
      "madc.lo.cc.u32 %1, %5, %7, %1;\n\t"
      "madc.lo.cc.u32 %2, %5, %8, %2;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.u32 %4, %4, 0;\n\t"
      "mad.hi.cc.u32 %1, %5, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %7, %2;\n\t"
      "madc.hi.cc.u32 %3, %5, %8, %3;\n\t"
      "addc.u32 %4, %4, 0;"
      : "+r"(R[0]), "+r"(R[1]), "+r"(R[2]), "+r"(R[3]), "+r"(R[4])
      : "r"(a), "r"(b[0]), "r"(b[1]), "r"(b[2]));
}

template <>
__device__ __forceinline__ void mac_part<4>(uint32_t* R, uint32_t a,
                                            const uint32_t* b) {
  asm volatile(
      "mad.lo.cc.u32 %0, %6, %7, %0;\n\t"
      "madc.lo.cc.u32 %1, %6, %8, %1;\n\t"
      "madc.lo.cc.u32 %2, %6, %9, %2;\n\t"
      "madc.lo.cc.u32 %3, %6, %10, %3;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.u32 %5, %5, 0;\n\t"
      "mad.hi.cc.u32 %1, %6, %7, %1;\n\t"
      "madc.hi.cc.u32 %2, %6, %8, %2;\n\t"
      "madc.hi.cc.u32 %3, %6, %9, %3;\n\t"
      "madc.hi.cc.u32 %4, %6, %10, %4;\n\t"
      "addc.u32 %5, %5, 0;"
      : "+r"(R[0]), "+r"(R[1]), "+r"(R[2]), "+r"(R[3]), "+r"(R[4]),
        "+r"(R[5])
      : "r"(a), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]));
}

template <>
__device__ __forceinline__ void mac_part<5>(uint32_t* R, uint32_t a,
                                            const uint32_t* b) {
  asm volatile(
      "mad.lo.cc.u32 %0, %7, %8, %0;\n\t"
      "madc.lo.cc.u32 %1, %7, %9, %1;\n\t"
      "madc.lo.cc.u32 %2, %7, %10, %2;\n\t"
      "madc.lo.cc.u32 %3, %7, %11, %3;\n\t"
      "madc.lo.cc.u32 %4, %7, %12, %4;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.u32 %6, %6, 0;\n\t"
      "mad.hi.cc.u32 %1, %7, %8, %1;\n\t"
      "madc.hi.cc.u32 %2, %7, %9, %2;\n\t"
      "madc.hi.cc.u32 %3, %7, %10, %3;\n\t"
      "madc.hi.cc.u32 %4, %7, %11, %4;\n\t"
      "madc.hi.cc.u32 %5, %7, %12, %5;\n\t"
      "addc.u32 %6, %6, 0;"
      : "+r"(R[0]), "+r"(R[1]), "+r"(R[2]), "+r"(R[3]), "+r"(R[4]),
        "+r"(R[5]), "+r"(R[6])
      : "r"(a), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]));
}

template <>
__device__ __forceinline__ void mac_part<6>(uint32_t* R, uint32_t a,
                                            const uint32_t* b) {
  asm volatile(
      "mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
      "madc.lo.cc.u32 %1, %8, %10, %1;\n\t"
      "madc.lo.cc.u32 %2, %8, %11, %2;\n\t"
      "madc.lo.cc.u32 %3, %8, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %8, %13, %4;\n\t"
      "madc.lo.cc.u32 %5, %8, %14, %5;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.u32 %7, %7, 0;\n\t"
      "mad.hi.cc.u32 %1, %8, %9, %1;\n\t"
      "madc.hi.cc.u32 %2, %8, %10, %2;\n\t"
      "madc.hi.cc.u32 %3, %8, %11, %3;\n\t"
      "madc.hi.cc.u32 %4, %8, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %8, %13, %5;\n\t"
      "madc.hi.cc.u32 %6, %8, %14, %6;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(R[0]), "+r"(R[1]), "+r"(R[2]), "+r"(R[3]), "+r"(R[4]),
        "+r"(R[5]), "+r"(R[6]), "+r"(R[7])
      : "r"(a), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]),
        "r"(b[5]));
}

template <>
__device__ __forceinline__ void mac_part<7>(uint32_t* R, uint32_t a,
                                            const uint32_t* b) {
  asm volatile(
      "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
      "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
      "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %10, %1;\n\t"
      "madc.hi.cc.u32 %2, %9, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.hi.cc.u32 %4, %9, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %14, %5;\n\t"
      "madc.hi.cc.u32 %6, %9, %15, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %16, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(R[0]), "+r"(R[1]), "+r"(R[2]), "+r"(R[3]), "+r"(R[4]),
        "+r"(R[5]), "+r"(R[6]), "+r"(R[7]), "+r"(R[8])
      : "r"(a), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]),
        "r"(b[5]), "r"(b[6]));
}

// R[0..17) = 2 R[0..17) + the squares a_i^2 at word 2 i: the cross products
// doubled and the diagonal added, in two chains.
__device__ __forceinline__ void double_add_squares(uint32_t* R,
                                                   const uint32_t* a) {
  asm volatile(
      "add.cc.u32 %0, %0, %0;\n\t"
      "addc.cc.u32 %1, %1, %1;\n\t"
      "addc.cc.u32 %2, %2, %2;\n\t"
      "addc.cc.u32 %3, %3, %3;\n\t"
      "addc.cc.u32 %4, %4, %4;\n\t"
      "addc.cc.u32 %5, %5, %5;\n\t"
      "addc.cc.u32 %6, %6, %6;\n\t"
      "addc.cc.u32 %7, %7, %7;\n\t"
      "addc.cc.u32 %8, %8, %8;\n\t"
      "addc.cc.u32 %9, %9, %9;\n\t"
      "addc.cc.u32 %10, %10, %10;\n\t"
      "addc.cc.u32 %11, %11, %11;\n\t"
      "addc.cc.u32 %12, %12, %12;\n\t"
      "addc.cc.u32 %13, %13, %13;\n\t"
      "addc.cc.u32 %14, %14, %14;\n\t"
      "addc.cc.u32 %15, %15, %15;\n\t"
      "addc.u32 %16, %16, %16;\n\t"
      "mad.lo.cc.u32 %0, %17, %17, %0;\n\t"
      "madc.hi.cc.u32 %1, %17, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %18, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %18, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %19, %19, %4;\n\t"
      "madc.hi.cc.u32 %5, %19, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %20, %20, %6;\n\t"
      "madc.hi.cc.u32 %7, %20, %20, %7;\n\t"
      "madc.lo.cc.u32 %8, %21, %21, %8;\n\t"
      "madc.hi.cc.u32 %9, %21, %21, %9;\n\t"
      "madc.lo.cc.u32 %10, %22, %22, %10;\n\t"
      "madc.hi.cc.u32 %11, %22, %22, %11;\n\t"
      "madc.lo.cc.u32 %12, %23, %23, %12;\n\t"
      "madc.hi.cc.u32 %13, %23, %23, %13;\n\t"
      "madc.lo.cc.u32 %14, %24, %24, %14;\n\t"
      "madc.hi.cc.u32 %15, %24, %24, %15;\n\t"
      "addc.u32 %16, %16, 0;"
      : "+r"(R[0]), "+r"(R[1]), "+r"(R[2]), "+r"(R[3]), "+r"(R[4]),
        "+r"(R[5]), "+r"(R[6]), "+r"(R[7]), "+r"(R[8]), "+r"(R[9]),
        "+r"(R[10]), "+r"(R[11]), "+r"(R[12]), "+r"(R[13]), "+r"(R[14]),
        "+r"(R[15]), "+r"(R[16])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]));
}

// R[0..17) += a^2 for R zero on entry: the cross products a_i a_j (i < j)
// row by row, doubled, and the squares on the diagonal.
__device__ __forceinline__ void sqr_rows(uint32_t* R, const uint32_t* a) {
  mac_part<7>(&R[1], a[0], &a[1]);
  mac_part<6>(&R[3], a[1], &a[2]);
  mac_part<5>(&R[5], a[2], &a[3]);
  mac_part<4>(&R[7], a[3], &a[4]);
  mac_part<3>(&R[9], a[4], &a[5]);
  mac_part<2>(&R[11], a[5], &a[6]);
  mac_part<1>(&R[13], a[6], &a[7]);
  double_add_squares(R, a);
}

// Q[0..10) = Q[0..8) + 977 H[0..8) + 2^32 H[0..8), where Q[0..8) holds L on
// entry: a one-lane group's first fold of a 512-bit product L + 2^256 H, in
// three chains.
__device__ __forceinline__ void fold_977(uint32_t* Q, const uint32_t* H) {
  asm volatile(
      "mad.lo.cc.u32 %0, %10, 977, %0;\n\t"
      "madc.lo.cc.u32 %1, %11, 977, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, 977, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, 977, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, 977, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, 977, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, 977, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, 977, %7;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %10, 977, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, 977, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, 977, %3;\n\t"
      "madc.hi.cc.u32 %4, %13, 977, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, 977, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, 977, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, 977, %7;\n\t"
      "madc.hi.u32 %8, %17, 977, %8;\n\t"
      "add.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.cc.u32 %8, %8, %17;\n\t"
      "addc.u32 %9, 0, 0;"
      : "+r"(Q[0]), "+r"(Q[1]), "+r"(Q[2]), "+r"(Q[3]), "+r"(Q[4]),
        "+r"(Q[5]), "+r"(Q[6]), "+r"(Q[7]), "+r"(Q[8]), "+r"(Q[9])
      : "r"(H[0]), "r"(H[1]), "r"(H[2]), "r"(H[3]), "r"(H[4]), "r"(H[5]),
        "r"(H[6]), "r"(H[7]));
}

// -- end of the PTX carry chains ----------------------------------------------

// A field element's words on one lane of a group of G = 8 / W.
template <int W>
struct Fe {
  uint32_t w[W];
};

// The lane's index in its group, and the group's bits of a warp ballot.
template <int G>
__device__ __forceinline__ int lane_k() {
  return static_cast<int>(threadIdx.x) & (G - 1);
}

template <int G>
__device__ __forceinline__ uint32_t group_bits(uint32_t m) {
  return (m >> ((threadIdx.x & 31) & ~(G - 1))) & ((1u << G) - 1);
}

// __shfl_sync at width G: the value of the group's lane src.
template <int G>
__device__ __forceinline__ uint32_t shfl(uint32_t v, int src) {
  if constexpr (G == 1) {
    return v;
  } else {
    return __shfl_sync(kFull, v, src & (G - 1), G);
  }
}

// Whether no lane of the group has `nonzero` set.
template <int G>
__device__ __forceinline__ bool group_none(bool nonzero) {
  if constexpr (G == 1) {
    return !nonzero;
  } else {
    return group_bits<G>(__ballot_sync(kFull, nonzero)) == 0;
  }
}

// Word j of C = 2^256 - p = 2^32 + 977, and of p + 1.
__device__ __forceinline__ uint32_t c_word(int j) {
  return j == 0 ? 977u : (j == 1 ? 1u : 0u);
}

__device__ __forceinline__ uint32_t p1_word(int j) {
  return j == 0 ? 0xFFFFFC30u : (j == 1 ? 0xFFFFFFFEu : 0xFFFFFFFFu);
}

template <int G>
__device__ __forceinline__ void fe_load(Fe<8 / G>& a, const int32_t* limbs) {
  constexpr int W = 8 / G;
  const int j0 = lane_k<G>() * W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    a.w[i] = static_cast<uint32_t>(limbs[2 * (j0 + i)]) |
             (static_cast<uint32_t>(limbs[2 * (j0 + i) + 1]) << 16);
  }
}

template <int G>
__device__ __forceinline__ void fe_store(int32_t* limbs, const Fe<8 / G>& a) {
  constexpr int W = 8 / G;
  const int j0 = lane_k<G>() * W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    limbs[2 * (j0 + i)] = static_cast<int32_t>(a.w[i] & 0xFFFFu);
    limbs[2 * (j0 + i) + 1] = static_cast<int32_t>(a.w[i] >> 16);
  }
}

template <int W>
__device__ __forceinline__ void fe_set(Fe<W>& a, uint32_t word0) {
#pragma unroll
  for (int i = 0; i < W; ++i) a.w[i] = i == 0 ? word0 : 0u;
}

template <int W>
__device__ __forceinline__ void fe_select(Fe<W>& r, bool c, const Fe<W>& x,
                                          const Fe<W>& y) {
#pragma unroll
  for (int i = 0; i < W; ++i) r.w[i] = c ? x.w[i] : y.w[i];
}

template <int G>
__device__ __forceinline__ bool fe_is_zero(const Fe<8 / G>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8 / G; ++i) acc |= a.w[i];
  return group_none<G>(acc != 0);
}

template <int G>
__device__ __forceinline__ bool fe_eq(const Fe<8 / G>& a, const Fe<8 / G>& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8 / G; ++i) acc |= a.w[i] ^ b.w[i];
  return group_none<G>(acc != 0);
}

// Settle the carries between the group's lanes: lane k's value is x plus
// g (0 or 1; where 1, x is not all ones) times 2^(32 W). With generate and
// propagate bits gg and pp of the G lanes, the carry into each lane is the
// carry of the G-bit addition (gg | pp) + gg. Returns the carry out of the
// group's top lane.
template <int G>
__device__ __forceinline__ uint32_t resolve(uint32_t* x, uint32_t g) {
  constexpr int W = 8 / G;
  if constexpr (G == 1) {
    return g;  // no lane below or above
  } else {
    uint32_t all = x[0];
#pragma unroll
    for (int i = 1; i < W; ++i) all &= x[i];
    const uint32_t gg = group_bits<G>(__ballot_sync(kFull, g != 0));
    const uint32_t pp =
        group_bits<G>(__ballot_sync(kFull, all == 0xFFFFFFFFu));
    const uint32_t a = gg | pp;
    const uint32_t carries = (a + gg) ^ a ^ gg;
    uint32_t cin[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      cin[i] = i == 0 ? (carries >> lane_k<G>()) & 1u : 0u;
    }
    add_n<W>(x, cin);
    return (carries >> G) & 1u;
  }
}

// The field operations below take N independent operands at once (r[n] =
// a[n] op b[n]) and run each phase for all N before the next: the chains
// and the shuffle and ballot latencies of independent operations overlap.
// Every input is read before any output is written, so r[n] may alias any
// input.

// r[n] = s[n] - p (mod 2^256), which is s[n] + C, where the carry top[n]
// out of s[n]'s 2^256 or that of s[n] + C is set, else s[n]: the JAX
// package's reduction.
template <int G, int N>
__device__ __forceinline__ void reduce_once_n(Fe<8 / G>* const* r,
                                              const Fe<8 / G>* s,
                                              const uint32_t* top) {
  constexpr int W = 8 / G;
  uint32_t c[W];
#pragma unroll
  for (int i = 0; i < W; ++i) c[i] = c_word(lane_k<G>() * W + i);
  Fe<W> d[N];
  uint32_t g[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    d[n] = s[n];
    g[n] = add_n<W>(d[n].w, c);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) g[n] = resolve<G>(d[n].w, g[n]) | top[n];
#pragma unroll
  for (int n = 0; n < N; ++n) fe_select(*r[n], g[n] != 0, d[n], s[n]);
}

// r[n] = a[n] + b[n] as the JAX package's add_mod_p, or, where bit n of SUB
// is set, a[n] - b[n] as its sub_mod_p: a + ((p - b) mod 2^256), with
// p - b = ~b + (p + 1) (mod 2^256).
template <int G, unsigned SUB, int N>
__device__ __forceinline__ void fe_addsub_n(Fe<8 / G>* const* r,
                                            const Fe<8 / G>* const* a,
                                            const Fe<8 / G>* const* b) {
  constexpr int W = 8 / G;
  Fe<W> s[N], pb[N];
  uint32_t g[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    s[n] = *a[n];
    if ((SUB >> n) & 1u) {
      uint32_t pw[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        pb[n].w[i] = ~b[n]->w[i];
        pw[i] = p1_word(lane_k<G>() * W + i);
      }
      g[n] = add_n<W>(pb[n].w, pw);
    } else {
      pb[n] = *b[n];
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if ((SUB >> n) & 1u) resolve<G>(pb[n].w, g[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) g[n] = add_n<W>(s[n].w, pb[n].w);
#pragma unroll
  for (int n = 0; n < N; ++n) g[n] = resolve<G>(s[n].w, g[n]);
  reduce_once_n<G, N>(r, s, g);
}

// The rest of a one-lane multiplication: the 512-bit rows R folded to 10
// words, their top two (below 2^34) folded again into a value below 2^256
// plus a carry (which leaves it below 2^67), then p subtracted once.
template <int N>
__device__ __forceinline__ void mul_tail_1(Fe<8>* const* r,
                                           uint32_t (*R)[17]) {
  Fe<8> y[N];
  uint32_t g[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    uint32_t Q[10] = {R[n][0], R[n][1], R[n][2], R[n][3], R[n][4],
                      R[n][5], R[n][6], R[n][7], 0u, 0u};
    fold_977(Q, R[n] + 8);
    // F = (Q8 + 2^32 Q9) (2^32 + 977), 3 words
    uint32_t f[8] = {Q[8] * 977u, __umulhi(Q[8], 977u) + Q[9] * 977u, Q[9],
                     0u, 0u, 0u, 0u, 0u};
    const uint32_t q8[2] = {Q[8], 0u};
    add_n<2>(&f[1], q8);
#pragma unroll
    for (int i = 0; i < 8; ++i) y[n].w[i] = Q[i];
    g[n] = add_n<8>(y[n].w, f);
  }
  reduce_once_n<1, N>(r, y, g);
}

// The rest of a G-lane multiplication from the lanes' rows R, for G = 4
// (two words a lane).
template <int G, int N>
__device__ __forceinline__ void mul_tail(Fe<8 / G>* const* r,
                                         uint32_t (*R)[8 / G + 9]) {
  constexpr int W = 8 / G;
  static_assert(W == 2, "the excess and carry rounds are written for G = 4");
  const int k = lane_k<G>();
  // column sums: piece d of R_k (words d W ..) lies at chunk k + d; lane k
  // keeps chunk k (low, L) and chunk k + G (high, H)
  uint32_t L[N][W + 1], H[N][W + 1];
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      L[n][i] = R[n][i];
      H[n][i] = R[n][8 + i];
    }
    L[n][W] = H[n][W] = 0;
  }
#pragma unroll
  for (int d = 1; d < G; ++d) {
    const bool low = k >= d;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      uint32_t vl[W + 1], vh[W + 1];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const uint32_t v = shfl<G>(R[n][d * W + i], k - d);
        vl[i] = low ? v : 0u;
        vh[i] = low ? 0u : v;
      }
      vl[W] = vh[W] = 0;
      add_n<W + 1>(L[n], vl);
      add_n<W + 1>(H[n], vh);
    }
  }
  // fold 1: Q = L + 977 H + 2^32 H, below 2^(32 W + 36); its words W and
  // W + 1 are the excess, at word (k + 1) W
  uint32_t Q[N][W + 2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    uint32_t t[W + 2];
#pragma unroll
    for (int i = 0; i <= W; ++i) {
      Q[n][i] = L[n][i];
      t[i] = H[n][i] * 977u;
    }
    Q[n][W + 1] = t[W + 1] = 0;
    add_n<W + 2>(Q[n], t);
    t[0] = 0;
#pragma unroll
    for (int i = 0; i <= W; ++i) t[i + 1] = __umulhi(H[n][i], 977u);
    add_n<W + 2>(Q[n], t);
#pragma unroll
    for (int i = 0; i <= W; ++i) t[i + 1] = H[n][i];
    add_n<W + 2>(Q[n], t);
  }
  // round 1: each lane adds the excess below it; what passes 2^256 folds
  // again, times C, into the lowest words. Round 2 does the same with the
  // carries (at most 3, or 2^6 on lane 0); then they are single bits.
  Fe<W> y[N];
  uint32_t c[N], g[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int i = 0; i < W; ++i) y[n].w[i] = Q[n][i];
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const uint32_t in0 = shfl<G>(Q[n][W], k - 1);
    const uint32_t in1 = shfl<G>(Q[n][W + 1], k - 1);
    uint32_t add[2] = {k != 0 ? in0 : 0u, k != 0 ? in1 : 0u};
    c[n] = add_n<2>(y[n].w, add);
    // lane 0 received E_{G-1}, at 2^256: F = E_{G-1} C, 3 words, the third
    // a carry
    uint32_t f[3] = {in0 * 977u, __umulhi(in0, 977u) + in1 * 977u, 0u};
    const uint32_t o32[3] = {0u, in0, in1};
    add_n<3>(f, o32);
    add[0] = k == 0 ? f[0] : 0u;
    add[1] = k == 0 ? f[1] : 0u;
    c[n] += add_n<2>(y[n].w, add) + (k == 0 ? f[2] : 0u);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const uint32_t cin = shfl<G>(c[n], k - 1);
    uint32_t add[2] = {k == 0 ? 977u * cin : cin, k == 0 ? cin : 0u};
    g[n] = add_n<2>(y[n].w, add);
  }
  // the one-bit carries, then p subtracted once where the value reaches p
#pragma unroll
  for (int n = 0; n < N; ++n) g[n] = resolve<G>(y[n].w, g[n]);
  reduce_once_n<G, N>(r, y, g);
}

// r[n] = a[n] * b[n] mod p, canonical, for any 256-bit a and b; where bit n
// of SQ is set, a[n] is b[n] (a square).
template <int G, int N, unsigned SQ>
__device__ __forceinline__ void fe_mul_n(Fe<8 / G>* const* r,
                                         const Fe<8 / G>* const* a,
                                         const Fe<8 / G>* const* b) {
  constexpr int W = 8 / G;
  const int k = lane_k<G>();
  // b, gathered over the group
  uint32_t bb[N][8];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
#pragma unroll
      for (int n = 0; n < N; ++n) bb[n][j * W + i] = shfl<G>(b[n]->w[i], j);
    }
  }
  // the lane's rows: R = a_k x b, W + 8 words at word k W (one spare)
  uint32_t R[N][W + 9];
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int i = 0; i < W + 9; ++i) R[n][i] = 0;
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if constexpr (G == 1) {
      if ((SQ >> n) & 1u) {  // a one-lane square: 36 products, not 64
        sqr_rows(R[n], bb[n]);
        continue;
      }
    }
#pragma unroll
    for (int u = 0; u < W; ++u) mac_row(&R[n][u], a[n]->w[u], bb[n]);
  }
  if constexpr (G == 1) {
    mul_tail_1<N>(r, R);
  } else {
    mul_tail<G, N>(r, R);
  }
}

// One, two or three operations at once, by reference.
template <int G>
__device__ __forceinline__ void fe_mul(Fe<8 / G>& r, const Fe<8 / G>& a,
                                       const Fe<8 / G>& b) {
  Fe<8 / G>* const rs[] = {&r};
  const Fe<8 / G>* const as[] = {&a};
  const Fe<8 / G>* const bs[] = {&b};
  fe_mul_n<G, 1, 0u>(rs, as, bs);
}

// Two or three multiplications at once; bit n of SQ: operation n squares.
template <int G, unsigned SQ>
__device__ __forceinline__ void fe_mul2(Fe<8 / G>& r0, const Fe<8 / G>& a0,
                                        const Fe<8 / G>& b0, Fe<8 / G>& r1,
                                        const Fe<8 / G>& a1,
                                        const Fe<8 / G>& b1) {
  Fe<8 / G>* const rs[] = {&r0, &r1};
  const Fe<8 / G>* const as[] = {&a0, &a1};
  const Fe<8 / G>* const bs[] = {&b0, &b1};
  fe_mul_n<G, 2, SQ>(rs, as, bs);
}

template <int G, unsigned SQ>
__device__ __forceinline__ void fe_mul3(
    Fe<8 / G>& r0, const Fe<8 / G>& a0, const Fe<8 / G>& b0, Fe<8 / G>& r1,
    const Fe<8 / G>& a1, const Fe<8 / G>& b1, Fe<8 / G>& r2,
    const Fe<8 / G>& a2, const Fe<8 / G>& b2) {
  Fe<8 / G>* const rs[] = {&r0, &r1, &r2};
  const Fe<8 / G>* const as[] = {&a0, &a1, &a2};
  const Fe<8 / G>* const bs[] = {&b0, &b1, &b2};
  fe_mul_n<G, 3, SQ>(rs, as, bs);
}

template <int G>
__device__ __forceinline__ void fe_sqr(Fe<8 / G>& r, const Fe<8 / G>& a) {
  Fe<8 / G>* const rs[] = {&r};
  const Fe<8 / G>* const as[] = {&a};
  fe_mul_n<G, 1, 1u>(rs, as, as);
}

template <int G>
__device__ __forceinline__ void fe_add(Fe<8 / G>& r, const Fe<8 / G>& a,
                                       const Fe<8 / G>& b) {
  Fe<8 / G>* const rs[] = {&r};
  const Fe<8 / G>* const as[] = {&a};
  const Fe<8 / G>* const bs[] = {&b};
  fe_addsub_n<G, 0u, 1>(rs, as, bs);
}

template <int G>
__device__ __forceinline__ void fe_sub(Fe<8 / G>& r, const Fe<8 / G>& a,
                                       const Fe<8 / G>& b) {
  Fe<8 / G>* const rs[] = {&r};
  const Fe<8 / G>* const as[] = {&a};
  const Fe<8 / G>* const bs[] = {&b};
  fe_addsub_n<G, 1u, 1>(rs, as, bs);
}

// Two adds or subtracts at once (bit n of SUB: operation n subtracts).
template <int G, unsigned SUB>
__device__ __forceinline__ void fe_addsub2(Fe<8 / G>& r0, const Fe<8 / G>& a0,
                                           const Fe<8 / G>& b0, Fe<8 / G>& r1,
                                           const Fe<8 / G>& a1,
                                           const Fe<8 / G>& b1) {
  Fe<8 / G>* const rs[] = {&r0, &r1};
  const Fe<8 / G>* const as[] = {&a0, &a1};
  const Fe<8 / G>* const bs[] = {&b0, &b1};
  fe_addsub_n<G, SUB, 2>(rs, as, bs);
}

template <int G, unsigned SUB>
__device__ __forceinline__ void fe_addsub4(
    Fe<8 / G>& r0, const Fe<8 / G>& a0, const Fe<8 / G>& b0, Fe<8 / G>& r1,
    const Fe<8 / G>& a1, const Fe<8 / G>& b1, Fe<8 / G>& r2,
    const Fe<8 / G>& a2, const Fe<8 / G>& b2, Fe<8 / G>& r3,
    const Fe<8 / G>& a3, const Fe<8 / G>& b3) {
  Fe<8 / G>* const rs[] = {&r0, &r1, &r2, &r3};
  const Fe<8 / G>* const as[] = {&a0, &a1, &a2, &a3};
  const Fe<8 / G>* const bs[] = {&b0, &b1, &b2, &b3};
  fe_addsub_n<G, SUB, 4>(rs, as, bs);
}

// (X, Y, Z) = 2 (X, Y, Z), dbl-2009-l for a = 0 (JAX _double), its
// independent operations taken together; infinity (Z = 0) stays infinity.
template <int G>
__device__ __forceinline__ void pt_double(Fe<8 / G>& X, Fe<8 / G>& Y,
                                          Fe<8 / G>& Z) {
  Fe<8 / G> A, B, C, D, E, F, T, U, V;
  fe_mul2<G, 3u>(A, X, X, B, Y, Y);
  fe_addsub2<G, 0u>(T, X, B, E, A, A);       // T = X + B, E = 2 A
  fe_mul3<G, 3u>(C, B, B, T, T, T, Z, Y, Z);  // C = B^2, T = T^2, Z = Y Z
  fe_addsub4<G, 2u>(E, E, A, D, T, A, U, C, C, Z, Z, Z);  // E = 3 A,
                                             // D = T - A, U = 2 C, Z3 = 2 Y Z
  fe_sqr<G>(F, E);                           // F = E^2
  fe_addsub2<G, 1u>(D, D, C, U, U, U);       // D = T - A - C, U = 4 C
  fe_addsub2<G, 0u>(D, D, D, U, U, U);       // D = 2 (...), U = 8 C
  fe_add<G>(V, D, D);
  fe_sub<G>(X, F, V);                        // X3 = F - 2 D
  fe_sub<G>(V, D, X);
  fe_mul<G>(Y, E, V);
  fe_sub<G>(Y, Y, U);                        // Y3 = E (D - X3) - 8 C
}

// (X, Y, Z) += (x2, y2, 1), JAX _add_mixed: the general addition, then the
// rare cases by select in its order of priority.
template <int G>
__device__ __forceinline__ void pt_add_mixed(Fe<8 / G>& X, Fe<8 / G>& Y,
                                             Fe<8 / G>& Z,
                                             const Fe<8 / G>& x2,
                                             const Fe<8 / G>& y2, bool inf2) {
  constexpr int W = 8 / G;
  const bool inf1 = fe_is_zero<G>(Z);
  Fe<W> Z1Z1, H, R, S, HH, HHH, U1HH, R2, T, X3, Y3, Z3;
  fe_sqr<G>(Z1Z1, Z);
  fe_mul2<G, 0u>(H, x2, Z1Z1, S, Z, Z1Z1);   // U2, Z1^3
  fe_mul<G>(S, y2, S);                       // S2
  fe_addsub2<G, 3u>(H, H, X, R, S, Y);       // H = U2 - X1, R = S2 - Y1
  const bool h_zero = fe_is_zero<G>(H);
  const bool r_zero = fe_is_zero<G>(R);
  const bool same = h_zero && r_zero && !inf1 && !inf2;
  const bool negated = h_zero && !r_zero && !inf1 && !inf2;  // P1 == -P2
  fe_mul3<G, 3u>(HH, H, H, R2, R, R, Z3, Z, H);  // Z3 = Z1 H
  fe_mul2<G, 0u>(HHH, H, HH, U1HH, X, HH);
  fe_addsub2<G, 1u>(X3, R2, HHH, T, U1HH, U1HH);  // R^2 - HHH, 2 U1HH
  fe_sub<G>(X3, X3, T);                      // X3 = R^2 - HHH - 2 U1HH
  fe_sub<G>(T, U1HH, X3);
  fe_mul2<G, 0u>(Y3, R, T, T, Y, HHH);
  fe_sub<G>(Y3, Y3, T);                      // Y3 = R (U1HH - X3) - Y1 HHH
  if (__any_sync(kFull, same)) {  // P1 == P2 in some group of the warp
    Fe<W> dX = X, dY = Y, dZ = Z;
    pt_double<G>(dX, dY, dZ);
    fe_select(X3, same, dX, X3);
    fe_select(Y3, same, dY, Y3);
    fe_select(Z3, same, dZ, Z3);
  }
  // the Z of P2 lifted: 1, or 0 where P2 is infinite, built in registers (a
  // choice between two local Fe by reference takes a run-time address, and
  // ptxas put both on the stack at G = 4: local loads in the ladder)
  Fe<W> zero, lift_z;
  fe_set(zero, 0u);
  fe_set(lift_z, !inf2 && lane_k<G>() == 0 ? 1u : 0u);
  fe_select(Z3, negated, zero, Z3);
  fe_select(X3, inf1, x2, X3);  // P1 infinite: P2 lifted
  fe_select(Y3, inf1, y2, Y3);
  fe_select(Z3, inf1, lift_z, Z3);
  fe_select(X, inf2, X, X3);    // P2 infinite: P1
  fe_select(Y, inf2, Y, Y3);
  fe_select(Z, inf2, Z, Z3);
}

// The final check of JAX _shamir_kernel (verify.py:164-169).
template <int G>
__device__ __forceinline__ bool projective_check(const Fe<8 / G>& X,
                                                 const Fe<8 / G>& Z,
                                                 const int32_t* r,
                                                 const int32_t* rn,
                                                 bool rn_ok) {
  Fe<8 / G> Z2, vr, vn, tr, tn;
  const bool inf = fe_is_zero<G>(Z);
  fe_sqr<G>(Z2, Z);
  fe_load<G>(vr, r);
  fe_load<G>(vn, rn);
  fe_mul2<G, 0u>(tr, vr, Z2, tn, vn, Z2);
  const bool ok_r = fe_eq<G>(X, tr);
  const bool ok_rn = fe_eq<G>(X, tn);
  return !inf && (ok_r || (rn_ok && ok_rn));
}

template <int G>
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
  constexpr int W = 8 / G;
  const int grp = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) / G);
  const int b = grp < B ? grp : B - 1;  // past B: the last one, not stored

  // table entries 1..3 (G, Q, G + Q), this lane's words, in shared memory
  // as [(entry - 1) * 2 + coordinate][word][thread]: a warp reads 32 banks
  __shared__ uint32_t tab[6 * W][kThreads];
  const int tid = static_cast<int>(threadIdx.x);
  const size_t row = static_cast<size_t>(b) * 4 * 16;
  uint32_t inf = 0;  // bit e: entry e infinite
#pragma unroll
  for (int e = 0; e < 4; ++e) inf |= (table_inf[b * 4 + e] ? 1u : 0u) << e;
#pragma unroll
  for (int e = 1; e < 4; ++e) {
    Fe<W> x, y;
    fe_load<G>(x, table_x + row + e * 16);
    fe_load<G>(y, table_y + row + e * 16);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      tab[(e - 1) * 2 * W + i][tid] = x.w[i];
      tab[((e - 1) * 2 + 1) * W + i][tid] = y.w[i];
    }
  }

  const int32_t* s1 = u1 + static_cast<size_t>(b) * 16;
  const int32_t* s2 = u2 + static_cast<size_t>(b) * 16;
  Fe<W> X, Y, Z;
  fe_set(X, 0u);
  fe_set(Y, 0u);
  fe_set(Z, 0u);  // infinity
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
    pt_double<G>(X, Y, Z);
    if (__all_sync(kFull, inf2)) continue;  // no group of the warp adds
    Fe<W> x2, y2;  // entry sel (entry 1 where sel is 0: unused then)
    const int base = (sel == 0 ? 0 : static_cast<int>(sel) - 1) * 2 * W;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      x2.w[i] = tab[base + i][tid];
      y2.w[i] = tab[base + W + i][tid];
    }
    pt_add_mixed<G>(X, Y, Z, x2, y2, inf2);
  }
  const bool ok = projective_check<G>(X, Z, r + static_cast<size_t>(b) * 16,
                                      rn + static_cast<size_t>(b) * 16,
                                      rn_ok[b] != 0);
  if (grp < B && lane_k<G>() == 0) out[b] = ok ? 1 : 0;
}

// op: 0 mul, 1 sqr (of a), 2 add, 3 sub; one group a pair
template <int G>
__global__ void __launch_bounds__(kThreads)
    field_ops_kernel(int op, const int32_t* __restrict__ a,
                     const int32_t* __restrict__ b, int32_t* __restrict__ out,
                     int B) {
  const int grp = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) / G);
  const size_t i = static_cast<size_t>(grp < B ? grp : B - 1);
  Fe<8 / G> x, y, z;
  fe_load<G>(x, a + i * 16);
  fe_load<G>(y, b + i * 16);
  switch (op) {
    case 0: fe_mul<G>(z, x, y); break;
    case 1: fe_sqr<G>(z, x); break;
    case 2: fe_add<G>(z, x, y); break;
    default: fe_sub<G>(z, x, y); break;
  }
  if (grp < B) fe_store<G>(out + i * 16, z);
}

// Threads a block and blocks for B groups of G lanes: 128 threads a block,
// or one or a few warps when B G is smaller.
void launch_shape(int B, int G, int* blocks, int* threads) {
  const long long lanes = static_cast<long long>(B) * G;
  *threads = lanes < kThreads ? static_cast<int>((lanes + 31) / 32 * 32)
                              : kThreads;
  *blocks = static_cast<int>((lanes + *threads - 1) / *threads);
}

bool shape_ok(int B, int G) {
  return B > 0 && (G == 1 || G == 4) &&
         static_cast<long long>(B) * G <= INT_MAX - kThreads;
}

template <int G>
void launch_shamir(const void* u1, const void* u2, const void* table_x,
                   const void* table_y, const void* table_inf, const void* r,
                   const void* rn, const void* rn_ok, void* out, int B,
                   cudaStream_t stream) {
  int blocks, threads;
  launch_shape(B, G, &blocks, &threads);
  ecdsa_shamir_kernel<G><<<blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(u1), static_cast<const int32_t*>(u2),
      static_cast<const int32_t*>(table_x),
      static_cast<const int32_t*>(table_y),
      static_cast<const uint8_t*>(table_inf), static_cast<const int32_t*>(r),
      static_cast<const int32_t*>(rn), static_cast<const uint8_t*>(rn_ok),
      static_cast<uint8_t*>(out), B);
}

template <int G>
void launch_field_ops(int op, const void* a, const void* b, void* out, int B,
                      cudaStream_t stream) {
  int blocks, threads;
  launch_shape(B, G, &blocks, &threads);
  field_ops_kernel<G><<<blocks, threads, 0, stream>>>(
      op, static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), B);
}

}  // namespace

extern "C" {

// The group size K3 takes for a batch of B signatures (see the head of this
// file).
int bt_ecdsa_group(int B) { return B <= 4096 ? 4 : 1; }

// Launch K3 over B signatures at group size G (1 or 4) on `stream`;
// returns the cudaError_t of the launch (0 = ok). Pointers are device
// pointers; nothing is allocated or synchronised here.
int bt_ecdsa_shamir_group(int G, const void* u1, const void* u2,
                          const void* table_x, const void* table_y,
                          const void* table_inf, const void* r, const void* rn,
                          const void* rn_ok, void* out, int B, void* stream) {
  if (!shape_ok(B, G)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = G == 4 ? launch_shamir<4> : launch_shamir<1>;
  launch(u1, u2, table_x, table_y, table_inf, r, rn, rn_ok, out, B, s);
  return static_cast<int>(cudaGetLastError());
}

// Launch K3 over B signatures at the group size bt_ecdsa_group(B).
int bt_ecdsa_shamir(const void* u1, const void* u2, const void* table_x,
                    const void* table_y, const void* table_inf, const void* r,
                    const void* rn, const void* rn_ok, void* out, int B,
                    void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return bt_ecdsa_shamir_group(bt_ecdsa_group(B), u1, u2, table_x, table_y,
                               table_inf, r, rn, rn_ok, out, B, stream);
}

// Apply field operation `op` (0 mul, 1 sqr, 2 add, 3 sub) to B pairs of
// [16] limb rows at group size G on `stream`; returns the launch's
// cudaError_t.
int bt_field_ops(int G, int op, const void* a, const void* b, void* out, int B,
                 void* stream) {
  if (!shape_ok(B, G) || op < 0 || op > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = G == 4 ? launch_field_ops<4> : launch_field_ops<1>;
  launch(op, a, b, out, B, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
