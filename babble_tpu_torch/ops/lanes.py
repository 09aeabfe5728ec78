"""A model in Python integers of K3's cooperative field layer: the schedule
that ``csrc/ecdsa_verify.cu`` runs on a group of G lanes of a warp, step
for step, so that the CPU tests hold its carries and folds against Python
integers where there is no card.

A field element is split over the G lanes of its group (G in GROUPS, the
group sizes the card runs): lane k holds the W = 8 / G little-endian
32-bit words k W .. k W + W - 1. A value of the
model is a list of G lanes, each a list of W words. Warp collectives take
a list with one entry per lane: ``shfl`` (``__shfl_sync`` at width G) and
``ballot`` (``__ballot_sync``, restricted to the group's G bits).

- ``resolve``: lanes that each hold W words and a carry bit out of them
  settle the carries between lanes with two ballots, as the addition of
  two G-bit numbers (generate and propagate bits), not by G serial hops.
- ``fe_add`` / ``fe_sub``: the JAX package's add_mod_p and sub_mod_p,
  exactly, for any 256-bit operands: s = a + b, then s - p (mod 2^256)
  where s reaches 2^256 or p; a - b as a + ((p - b) mod 2^256).
- ``fe_mul``: lane k gathers b (shuffles), forms its rows a_k x b (W x 8
  words), the group sums the rows' W-word pieces into each lane's low and
  high chunk (shuffles; the column sums), folds the high half with
  2^256 = 2^32 + 977 (mod p), passes the excess words up two rounds (the
  top lane's excess folds again), settles the last one-bit carries with
  ``resolve`` and subtracts p once where the value reaches p. A one-lane
  group (G = 1) folds its 16 words in one pass and a second small one, and
  squares with its cross products doubled and the diagonal added.
"""

from __future__ import annotations

from typing import List, Tuple

M32 = 0xFFFFFFFF
P_INT = 2**256 - 2**32 - 977
GROUPS = (1, 4)
# 2^256 - p = 2^32 + 977, and p + 1, as 32-bit words
C_WORDS = (977, 1, 0, 0, 0, 0, 0, 0)
P1_WORDS = (0xFFFFFC30, 0xFFFFFFFE) + (M32,) * 6

Lanes = List[List[int]]


def split(x: int, G: int) -> Lanes:
    """The lanes of ``x`` (0 <= x < 2^256) in a group of G."""
    W = 8 // G
    words = [(x >> (32 * j)) & M32 for j in range(8)]
    return [words[k * W:(k + 1) * W] for k in range(G)]


def join(lanes: Lanes) -> int:
    out = 0
    for j, w in enumerate(w for lane in lanes for w in lane):
        out |= w << (32 * j)
    return out


def _const(words, G: int) -> Lanes:
    W = 8 // G
    return [list(words[k * W:(k + 1) * W]) for k in range(G)]


# -- one lane: a carry chain over its words (add.cc / addc) -------------------


def add_n(x: List[int], y: List[int]) -> Tuple[List[int], int]:
    """x + y over len(x) words: the words and the carry out."""
    out, c = [], 0
    for a, b in zip(x, y):
        s = a + b + c
        out.append(s & M32)
        c = s >> 32
    return out, c


def _pad(v: List[int], n: int, at: int = 0) -> List[int]:
    """``v`` placed at word ``at`` of an n-word zero vector."""
    return [0] * at + list(v) + [0] * (n - at - len(v))


# -- warp collectives, within one group ---------------------------------------


def shfl(vals: List[int], src) -> List[int]:
    """Lane k reads ``vals`` of lane src(k) mod G (__shfl_sync, width G)."""
    G = len(vals)
    return [vals[src(k) % G] for k in range(G)]


def ballot(bits: List[int]) -> int:
    return sum((b & 1) << k for k, b in enumerate(bits))


def resolve(lanes: Lanes, g: List[int]) -> Tuple[Lanes, int]:
    """Settle the carries between lanes: lane k's value is its words plus
    g[k] (0 or 1, and then its words are not all ones) times 2^(32 W).
    Returns the words and the carry out of the group's top lane."""
    G = len(lanes)
    p = [int(all(w == M32 for w in lane)) for lane in lanes]
    if any(gk and pk for gk, pk in zip(g, p)):
        raise AssertionError("a lane both generates and propagates a carry")
    gg, pp = ballot(g), ballot(p)
    a = gg | pp
    carries = (a + gg) ^ a ^ gg  # bit k: carry into lane k; bit G: out
    out = [add_n(lane, _pad([(carries >> k) & 1], len(lane)))[0]
           for k, lane in enumerate(lanes)]
    return out, (carries >> G) & 1


def is_zero(lanes: Lanes) -> bool:
    return ballot([int(any(lane)) for lane in lanes]) == 0


def select(c: bool, x: Lanes, y: Lanes) -> Lanes:
    return [list(a if c else b) for a, b in zip(x, y)]


# -- the field ---------------------------------------------------------------


def add_raw(a: Lanes, b: Lanes) -> Tuple[Lanes, int]:
    """a + b mod 2^256 and the carry out of 2^256."""
    parts = [add_n(x, y) for x, y in zip(a, b)]
    return resolve([s for s, _ in parts], [c for _, c in parts])


def fe_add(a: Lanes, b: Lanes) -> Lanes:
    """s = a + b; s - p (mod 2^256), which is s + C, where s reaches 2^256
    or p (the carry out of s + C), else s."""
    s, top = add_raw(a, b)
    d, ge = add_raw(s, _const(C_WORDS, len(a)))
    return select(bool(top | ge), d, s)


def fe_sub(a: Lanes, b: Lanes) -> Lanes:
    """a + ((p - b) mod 2^256), with p - b = ~b + (p + 1) mod 2^256."""
    nb = [[~w & M32 for w in lane] for lane in b]
    pb, _ = add_raw(nb, _const(P1_WORDS, len(b)))
    return fe_add(a, pb)


def _square_rows(a: List[int]) -> List[int]:
    """One lane's a^2 as 17 words: the cross products a_i a_j (i < j) row by
    row, doubled, then the squares on the diagonal."""
    r = [0] * 17
    for u in range(7):
        row = a[u] * join([a[u + 1:]])
        r = add_n(r, _pad([(row >> (32 * i)) & M32 for i in range(9 - u)],
                          17, 2 * u + 1))[0]
    r = add_n(r, r)[0]
    diag = [(a[i // 2] ** 2 >> (32 * (i % 2))) & M32 for i in range(16)]
    return add_n(r, diag + [0])[0]


def _mul_one_lane(R: List[int]) -> Lanes:
    """The rest of a one-lane multiplication from its 512-bit rows R: one
    fold to 10 words, the top two (below 2^34) folded again into a value
    below 2^256 plus a carry, then p subtracted once."""
    q = R[:8] + [0, 0]
    q = add_n(q, _pad([(h * 977) & M32 for h in R[8:16]], 10))[0]
    q = add_n(q, _pad([(h * 977) >> 32 for h in R[8:16]], 10, 1))[0]
    q = add_n(q, _pad(R[8:16], 10, 1))[0]
    f = (q[8] + (q[9] << 32)) * (2**32 + 977)
    y, g = add_n(q[:8], [(f >> (32 * i)) & M32 for i in range(8)])
    d, ge = add_n(y, list(C_WORDS))
    return [d if g | ge else y]


def fe_mul(a: Lanes, b: Lanes, square: bool = False) -> Lanes:
    """a * b mod p, canonical, for any 256-bit a and b (a square where
    ``square``: then a is b)."""
    G = len(a)
    if G not in GROUPS:
        raise ValueError(f"group size {G} is not one of {GROUPS}")
    W = 8 // G
    ks = range(G)
    # gather b: every lane reads all of it
    bb = [[0] * 8 for _ in ks]
    for j in range(G):
        for i in range(W):
            got = shfl([lane[i] for lane in b], lambda k: j)
            for k in ks:
                bb[k][j * W + i] = got[k]
    # rows: R_k = a_k x b, W + 8 words (one spare) at word k W
    R = []
    for k in ks:
        r = [0] * (W + 9)
        for u in range(W):
            row = a[k][u] * join([bb[k]])
            r = add_n(r, _pad([(row >> (32 * i)) & M32 for i in range(9)],
                              W + 9, u))[0]
        R.append(r)
    if G == 1:
        return _mul_one_lane(_square_rows(a[0]) if square else R[0])
    # column sums: piece d (words d W .. d W + W - 1) of R_k lies at chunk
    # k + d; lane k keeps chunks k (low) and k + G (high)
    L = [_pad(R[k][:W], W + 1) for k in ks]
    H = [_pad(R[k][8:8 + W], W + 1) for k in ks]
    for d in range(1, G):
        v = [shfl([R[k][d * W + i] for k in ks], lambda k: k - d)
             for i in range(W)]
        for k in ks:
            piece = _pad([v[i][k] for i in range(W)], W + 1)
            zero = [0] * (W + 1)
            L[k] = add_n(L[k], piece if k >= d else zero)[0]
            H[k] = add_n(H[k], zero if k >= d else piece)[0]
    # fold 1: Q_k = L_k + 977 H_k + 2^32 H_k, W + 2 words (below 2^(32 W +
    # 36)); its words W and W + 1 are the excess E_k, at word (k + 1) W
    Q = []
    for k in ks:
        q = _pad(L[k], W + 2)
        q = add_n(q, _pad([(h * 977) & M32 for h in H[k]], W + 2))[0]
        q = add_n(q, _pad([(h * 977) >> 32 for h in H[k]], W + 2, 1))[0]
        q = add_n(q, _pad(H[k], W + 2, 1))[0]
        Q.append(q)
    e0 = [q[W] for q in Q]
    e1 = [q[W + 1] for q in Q]
    # round 1: each lane adds the excess below it; what passes 2^256 (the
    # top lanes' excess) folds again, times C, into the lowest words
    y, c = [], []
    in0 = shfl(e0, lambda k: k - 1)
    in1 = shfl(e1, lambda k: k - 1)
    for k in ks:
        s, c1 = add_n(Q[k][:W], [in0[k], in1[k]] if k else [0, 0])
        if k == 0:  # E_{G-1}, at 2^256: fold in C E_{G-1} (3 words, the
            # third a carry)
            f = (in0[k] + (in1[k] << 32)) * (2**32 + 977)
            s, c2 = add_n(s, [f & M32, (f >> 32) & M32])
            c1 += c2 + (f >> 64)
        y.append(s)
        c.append(c1)
    # round 2: the carries (at most 2, or 2^6 on lane 0) go up one lane; the
    # top lane's folds again
    cin = shfl(c, lambda k: k - 1)
    g = []
    for k in ks:
        add = [977 * cin[k], cin[k]] if k == 0 else [cin[k], 0]
        y[k], gk = add_n(y[k], add)
        g.append(gk)
    # one-bit carries, then the conditional subtract of p
    z, top = resolve(y, g)
    d, ge = add_raw(z, _const(C_WORDS, G))
    return select(bool(top | ge), d, z)


def fe_sqr(a: Lanes) -> Lanes:
    return fe_mul(a, a, square=True)


FIELD_OPS = {"mul": fe_mul, "sqr": lambda a, b: fe_sqr(a), "add": fe_add,
             "sub": fe_sub}


def field_op(op: str, x: int, y: int, G: int) -> int:
    """The model's ``op`` (a key of FIELD_OPS) on x and y in a group of G,
    as bt_field_ops computes it on the card."""
    return join(FIELD_OPS[op](split(x, G), split(y, G)))
