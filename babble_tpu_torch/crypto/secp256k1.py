"""Pure-Python secp256k1 ECDSA (reference curve: src/crypto/keys/curve.go:20).

This is the portable reference implementation and the oracle for the batched
card verifier (babble_tpu_torch/ops/verify.py). Affine arithmetic with modular
inversion via pow(x, -1, p) (extended Euclid in CPython, fast enough for the
host path); deterministic nonces per RFC 6979 so signing is reproducible.

Hot-path verification should go through babble_tpu_torch.crypto.keys, which prefers
the native and OpenSSL backends, and the batch verifiers
(babble_tpu_torch.crypto.batch, babble_tpu_torch.ops.verify) for bulk work.
"""

from __future__ import annotations

import hashlib
import hmac
from typing import Optional, Tuple

# Curve parameters: y^2 = x^3 + 7 over F_p.
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
A = 0
B = 7
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

Point = Optional[Tuple[int, int]]  # None is the point at infinity

G: Point = (GX, GY)


def is_on_curve(pt: Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def point_add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def point_mul(k: int, pt: Point) -> Point:
    """Double-and-add scalar multiplication (not constant-time; fine for a
    consensus testbed — the secret-key path uses RFC6979 nonces and short
    lived processes; production signing should use the OpenSSL backend)."""
    k %= N
    result: Point = None
    addend = pt
    while k:
        if k & 1:
            result = point_add(result, addend)
        addend = point_add(addend, addend)
        k >>= 1
    return result


def scalar_base_mult(k: int) -> Point:
    return point_mul(k, G)


def pubkey_from_scalar(d: int) -> Tuple[int, int]:
    pt = scalar_base_mult(d)
    assert pt is not None
    return pt


def _bits2int(data: bytes) -> int:
    """Leftmost min(len*8, 256) bits as integer (RFC 6979 / ECDSA hash truncation)."""
    x = int.from_bytes(data, "big")
    excess = len(data) * 8 - 256
    if excess > 0:
        x >>= excess
    return x


def rfc6979_k(priv: int, msg_hash: bytes) -> int:
    """Deterministic nonce per RFC 6979 with HMAC-SHA256."""
    qlen = 32
    h1 = _bits2int(msg_hash) % N
    x_b = priv.to_bytes(qlen, "big")
    h1_b = h1.to_bytes(qlen, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x_b + h1_b, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x_b + h1_b, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = _bits2int(v)
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(priv: int, msg_hash: bytes) -> Tuple[int, int]:
    """ECDSA sign; returns (r, s). Low-s normalization is NOT applied, matching
    Go's crypto/ecdsa which the reference uses (keys/signature.go:13-18)."""
    e = _bits2int(msg_hash)
    while True:
        k = rfc6979_k(priv, msg_hash)
        pt = scalar_base_mult(k)
        assert pt is not None
        r = pt[0] % N
        if r == 0:
            msg_hash = hashlib.sha256(msg_hash).digest()
            continue
        s = (pow(k, -1, N) * (e + r * priv)) % N
        if s == 0:
            msg_hash = hashlib.sha256(msg_hash).digest()
            continue
        return r, s


def verify(pub: Tuple[int, int], msg_hash: bytes, r: int, s: int) -> bool:
    """ECDSA verify against an affine public key."""
    if not (1 <= r < N and 1 <= s < N):
        return False
    if not is_on_curve(pub):
        return False
    e = _bits2int(msg_hash)
    w = pow(s, -1, N)
    u1 = (e * w) % N
    u2 = (r * w) % N
    pt = point_add(point_mul(u1, G), point_mul(u2, pub))
    if pt is None:
        return False
    return pt[0] % N == r % N


# --- SEC1 encodings -------------------------------------------------------

def marshal_pubkey(pub: Tuple[int, int]) -> bytes:
    """Uncompressed SEC1: 0x04 || X || Y (matches Go elliptic.Marshal, which
    the reference feeds to FNV for validator IDs — keys/public_key.go:32-46)."""
    x, y = pub
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def unmarshal_pubkey(data: bytes) -> Tuple[int, int]:
    if len(data) != 65 or data[0] != 0x04:
        raise ValueError("bad uncompressed secp256k1 public key")
    x = int.from_bytes(data[1:33], "big")
    y = int.from_bytes(data[33:65], "big")
    pt = (x, y)
    if not is_on_curve(pt):
        raise ValueError("public key not on curve")
    return pt
