"""256-bit arithmetic modulo the secp256k1 field prime on 16-bit limbs: the
plain PyTorch version of the field layer under K3 (``csrc/ecdsa_verify.cu``)
and ``ops/verify.py``.

Ports ``babble_tpu/ops/limbs.py`` and keeps its layout at the public
functions: ``[..., 16]`` little-endian 16-bit limbs, here in int32 tensors
(torch's uint32 has few CPU operations). Inside, limbs are int64 lanes: a
16 x 16-bit product is below 2^32 and a column of 16 of them below 2^36,
and every fold below stays under 2^47, so nothing overflows.

Field: F_p with p = 2^256 - C, C = 2^32 + 977, so 2^256 = C (mod p) and a
fold is a multiply by that small constant. Every result is canonical
(< p), as in the JAX package, because ``is_zero`` and ``eq`` compare limbs;
``add_mod_p`` and ``sub_mod_p`` compute exactly the JAX package's values
for every 256-bit input, canonical or not.

The JAX package carries with ``lax.scan`` one limb at a time. Here a carry
pass moves every limb's excess to the next limb at once and repeats until
no limb has any (one pass per 16 bits of excess, then one per limb of a
run that ripples); the passes stop on the data, so a few small operations
do what a 32-step chain did.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

NLIMB = 16  # 16 limbs x 16 bits = 256 bits
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

# secp256k1: field prime p = 2^256 - C with C = 2^32 + 977, group order n
P_INT = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N_INT = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
C_INT = (1 << 256) - P_INT
_C_LO = 977  # C = _C_LO + 2^32: limb 0 gets 977, limb 2 gets 1

# column of each product a[i] * b[j] (i + j), in row-major [16, 16] order
_COL = (np.arange(NLIMB)[:, None] + np.arange(NLIMB)[None, :]).reshape(-1)
_consts: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _const(name: str, device: torch.device) -> torch.Tensor:
    """An int64 constant of this module on ``device``, made once."""
    key = (name, device)
    t = _consts.get(key)
    if t is None:
        if name == "col":
            t = torch.tensor(_COL, dtype=torch.int64, device=device)
        else:
            value = {"p": P_INT, "c": C_INT}[name]
            t = int_to_limbs(value).to(device=device, dtype=torch.int64)
        _consts[key] = t
    return t


# -- conversions --------------------------------------------------------------


def ints_to_limbs(xs: Iterable[int], n: int = NLIMB) -> torch.Tensor:
    """[B] Python ints -> int32 [B, n] little-endian 16-bit limbs of each
    value modulo 2^(16 n), as the JAX package's masks take them."""
    mod = (1 << (LIMB_BITS * n)) - 1
    raw = b"".join((int(x) & mod).to_bytes(2 * n, "little") for x in xs)
    arr = np.frombuffer(raw, dtype="<u2").astype(np.int32).reshape(-1, n)
    return torch.from_numpy(arr)


def int_to_limbs(x: int, n: int = NLIMB) -> torch.Tensor:
    """int32 [n] little-endian 16-bit limbs of ``x`` modulo 2^(16 n)."""
    return ints_to_limbs([x], n)[0]


def limbs_to_int(limbs) -> int:
    """The integer whose 16-bit limbs (a tensor, array or list, low limb
    first) are ``limbs``."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.tolist()
    out = 0
    for i, v in enumerate(np.asarray(limbs, dtype=np.int64).tolist()):
        out |= int(v) << (LIMB_BITS * i)
    return out


# -- carries ------------------------------------------------------------------


def _carry(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clean 16-bit limbs of the int64 columns ``z`` (any sign) and the carry
    out of the top limb: the value is limbs + carry * 2^(16 n)."""
    top = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
    while True:
        c = z >> LIMB_BITS  # floor: a negative column borrows
        if not bool(c.any()):
            return z, top
        z = z & LIMB_MASK
        z[..., 1:] += c[..., :-1]
        top = top + c[..., -1]


def _fold_carry(z: torch.Tensor) -> torch.Tensor:
    """Clean limbs of a value < 2^256 congruent mod p to the non-negative
    int64 columns ``z`` [..., 16]: the carry out of the top limb folds back
    in as carry * C."""
    while True:
        c = z >> LIMB_BITS
        if not bool(c.any()):
            return z
        z = z & LIMB_MASK
        z[..., 1:] += c[..., :-1]
        top = c[..., -1]
        z[..., 0] += _C_LO * top
        z[..., 2] += top


def _minus_p(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z - p) mod 2^256 for clean limbs z, which is (z + C) mod 2^256, and
    whether that addition carried out of 2^256, which for z < 2^256 is
    z >= p."""
    return _carry(z + _const("c", z.device))


def _canonical(z: torch.Tensor) -> torch.Tensor:
    """z mod p for clean limbs z < 2^256 < 2p: one conditional subtract."""
    d, ge = _minus_p(z)
    return torch.where((ge > 0)[..., None], d, z)


# -- the field, on int64 limbs (the ladder's form) ----------------------------


def _columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook columns of a * b: int64 [..., 32], column k the sum of
    a[i] * b[j] over i + j = k (below 2^36; column 31 is 0)."""
    prod = (a[..., :, None] * b[..., None, :]).reshape(*a.shape[:-1], -1)
    cols = torch.zeros((*a.shape[:-1], 2 * NLIMB), dtype=torch.int64,
                       device=a.device)
    return cols.index_add_(-1, _const("col", a.device), prod)


def _reduce(wide: torch.Tensor) -> torch.Tensor:
    """Canonical residue of the 512-bit value whose columns (each below
    2^40) are ``wide`` [..., 32]: L + H * 2^256 = L + H * 977 + H * 2^32."""
    lo, hi = wide[..., :NLIMB], wide[..., NLIMB:]
    z = lo + _C_LO * hi
    z[..., 2:] += hi[..., :-2]
    # hi[14] and hi[15] shifted by 2^32 land on limbs 16 and 17: fold again
    z[..., 0] += _C_LO * hi[..., -2]
    z[..., 2] += hi[..., -2]
    z[..., 1] += _C_LO * hi[..., -1]
    z[..., 3] += hi[..., -1]
    return _canonical(_fold_carry(z))


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce(_columns(a, b))


def _sqr(a: torch.Tensor) -> torch.Tensor:
    return _mul(a, a)


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """As the JAX package's add_mod_p: s = a + b; s - p (mod 2^256) when s
    reaches 2^256 or p, else s."""
    s, top = _carry(a + b)
    d, ge = _minus_p(s)
    return torch.where(((top > 0) | (ge > 0))[..., None], d, s)


def _sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """As the JAX package's sub_mod_p: a + ((p - b) mod 2^256)."""
    pb, _ = _carry(_const("p", b.device) - b)
    return _add(a, pb)


# -- public functions on int32 limbs, as babble_tpu.ops.limbs -----------------


def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 16] x [..., 16] -> int32 [..., 32] limbs of the full 512-bit
    product."""
    limbs, _ = _carry(_columns(a.long(), b.long()))
    return limbs.int()


def reduce_p(wide: torch.Tensor) -> torch.Tensor:
    """int32 [..., 32] limbs of a 512-bit value -> its canonical residue mod
    p, int32 [..., 16]."""
    return _reduce(wide.long()).int()


def mul_mod_p(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _mul(a.long(), b.long()).int()


def sqr_mod_p(a: torch.Tensor) -> torch.Tensor:
    return mul_mod_p(a, a)


def add_mod_p(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _add(a.long(), b.long()).int()


def sub_mod_p(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for canonical residues."""
    return _sub(a.long(), b.long()).int()


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(-1)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limb-wise select: cond [...] bool, a/b [..., 16]."""
    return torch.where(cond[..., None], a, b)
