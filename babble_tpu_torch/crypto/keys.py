"""Key objects and consensus-visible encodings (reference: src/crypto/keys/).

- Signature string format: ``r.Text(36) + "|" + s.Text(36)`` — base-36,
  lowercase, no padding (reference: keys/signature.go:25-38). This format is
  consensus-visible: it rides in events/blocks and its decoded R value is the
  ordering tiebreak (event.go:503-511), so it must be exact.
- Validator ID: 32-bit FNV-1a over the uncompressed public key
  (reference: keys/public_key.go:32-46), collision risk acknowledged there.

Verification prefers the OpenSSL backend (``cryptography``) when importable,
falling back to pure Python. Batched verification lives in
``babble_tpu_torch.crypto.batch`` (the native host verifier) and
``babble_tpu_torch.ops.verify`` (the card's, kernel K3).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Tuple

from babble_tpu_torch.crypto import secp256k1 as curve

_B36_ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyz"
_B36_INDEX = {c: i for i, c in enumerate(_B36_ALPHABET)}

# FNV-1a 32-bit parameters.
_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193

try:  # OpenSSL fast path
    from cryptography.hazmat.primitives.asymmetric import ec as _ec
    from cryptography.hazmat.primitives.asymmetric.utils import (
        decode_dss_signature as _decode_dss,
        encode_dss_signature as _encode_dss,
    )
    from cryptography.hazmat.primitives import hashes as _hashes
    from cryptography.hazmat.primitives.asymmetric.utils import Prehashed as _Prehashed
    from cryptography.exceptions import InvalidSignature as _InvalidSignature
    from functools import lru_cache as _lru_cache

    _HAVE_OPENSSL = True

    @_lru_cache(maxsize=1024)
    def _openssl_pub(x: int, y: int):
        return _ec.EllipticCurvePublicNumbers(x, y, _ec.SECP256K1()).public_key()

    @_lru_cache(maxsize=64)
    def _openssl_priv(d: int):
        pub_x, pub_y = curve.pubkey_from_scalar(d)
        return _ec.EllipticCurvePrivateNumbers(
            d, _ec.EllipticCurvePublicNumbers(pub_x, pub_y, _ec.SECP256K1())
        ).private_key()

except Exception:  # pragma: no cover - cryptography is in the base image
    _HAVE_OPENSSL = False


def _int_to_b36(x: int) -> str:
    if x == 0:
        return "0"
    neg = x < 0
    x = abs(x)
    out = []
    while x:
        x, rem = divmod(x, 36)
        out.append(_B36_ALPHABET[rem])
    if neg:
        out.append("-")
    return "".join(reversed(out))


def _b36_to_int(s: str) -> int:
    s = s.strip().lower()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    if not s:
        raise ValueError("empty base36 string")
    x = 0
    for c in s:
        if c not in _B36_INDEX:
            raise ValueError(f"invalid base36 digit {c!r}")
        x = x * 36 + _B36_INDEX[c]
    return -x if neg else x


def encode_signature(r: int, s: int) -> str:
    """reference: keys/signature.go:25-30."""
    return f"{_int_to_b36(r)}|{_int_to_b36(s)}"


def decode_signature(sig: str) -> Tuple[int, int]:
    """reference: keys/signature.go:33-38."""
    parts = sig.split("|")
    if len(parts) != 2:
        raise ValueError(f"invalid signature (expected 2 values, got {len(parts)})")
    return _b36_to_int(parts[0]), _b36_to_int(parts[1])


def public_key_id(pub_bytes: bytes) -> int:
    """32-bit FNV-1a of the uncompressed pubkey (reference: keys/public_key.go:36)."""
    h = _FNV_OFFSET
    for b in pub_bytes:
        h ^= b
        h = (h * _FNV_PRIME) & 0xFFFFFFFF
    return h


@dataclass(frozen=True)
class PublicKey:
    x: int
    y: int

    def bytes(self) -> bytes:
        return curve.marshal_pubkey((self.x, self.y))

    def hex(self) -> str:
        """Uppercase 0X-prefixed hex, as rendered by the reference
        (keys/public_key.go, fmt %X convention used in peers.json)."""
        return "0X" + self.bytes().hex().upper()

    def id(self) -> int:
        return public_key_id(self.bytes())

    def verify(self, msg_hash: bytes, sig: str) -> bool:
        try:
            r, s = decode_signature(sig)
        except ValueError:
            return False
        return self.verify_rs(msg_hash, r, s)

    def verify_rs(self, msg_hash: bytes, r: int, s: int) -> bool:
        from babble_tpu_torch import native_crypto

        res = native_crypto.verify_one(
            self.x.to_bytes(32, "big") + self.y.to_bytes(32, "big"),
            msg_hash,
            r,
            s,
        )
        if res is not None:
            return res
        if _HAVE_OPENSSL:
            try:
                pub = _openssl_pub(self.x, self.y)
                pub.verify(
                    _encode_dss(r, s), msg_hash, _ec.ECDSA(_Prehashed(_hashes.SHA256()))
                )
                return True
            except _InvalidSignature:
                return False
            except Exception:
                pass  # fall through to pure python on backend errors
        return curve.verify((self.x, self.y), msg_hash, r, s)

    @staticmethod
    def from_bytes(data: bytes) -> "PublicKey":
        x, y = curve.unmarshal_pubkey(data)
        return PublicKey(x, y)

    @staticmethod
    def from_hex(s: str) -> "PublicKey":
        t = s[2:] if s[:2].upper() == "0X" else s
        return PublicKey.from_bytes(bytes.fromhex(t))


from functools import lru_cache as _pk_lru_cache


@_pk_lru_cache(maxsize=1024)
def _pubkey_of_scalar(d: int) -> "PublicKey":
    """One scalar multiplication per key per process — Block.sign and
    friends access .public_key on every signature."""
    from babble_tpu_torch import native_crypto

    try:
        xy = native_crypto.pubkey(d.to_bytes(32, "big"))
    except Exception:
        xy = None
    if xy is None:
        xy = curve.pubkey_from_scalar(d)
    return PublicKey(*xy)


@dataclass(frozen=True)
class PrivateKey:
    d: int

    @property
    def public_key(self) -> PublicKey:
        return _pubkey_of_scalar(self.d)

    def sign(self, msg_hash: bytes) -> str:
        r, s = self.sign_rs(msg_hash)
        return encode_signature(r, s)

    def sign_rs(self, msg_hash: bytes) -> Tuple[int, int]:
        # Signing touches the private key, so constant-time OpenSSL stays
        # preferred; the variable-time native signer is only a fallback
        # (verification is secret-free and uses native first).
        # EXCEPT under deterministic mode (the sim engine): OpenSSL draws
        # a random ECDSA nonce, and the consensus total order breaks
        # Lamport-timestamp ties on the signature's r value — so random
        # nonces would make two same-seed sim runs commit in different
        # orders. The native and pure-Python signers are RFC 6979.
        if _HAVE_OPENSSL and not _DETERMINISTIC_SIGNING:
            try:
                der = _openssl_priv(self.d).sign(
                    msg_hash, _ec.ECDSA(_Prehashed(_hashes.SHA256()))
                )
                return _decode_dss(der)
            except Exception:
                pass  # fall through on backend errors
        from babble_tpu_torch import native_crypto

        try:
            rs = native_crypto.sign(self.d.to_bytes(32, "big"), msg_hash)
        except ValueError:
            rs = None
        if rs is not None:
            return rs
        return curve.sign(self.d, msg_hash)

    def bytes(self) -> bytes:
        return self.d.to_bytes(32, "big")

    def hex(self) -> str:
        return self.bytes().hex()

    @staticmethod
    def from_bytes(data: bytes) -> "PrivateKey":
        d = int.from_bytes(data, "big")
        if not (1 <= d < curve.N):
            raise ValueError("private scalar out of range")
        return PrivateKey(d)

    @staticmethod
    def from_hex(s: str) -> "PrivateKey":
        return PrivateKey.from_bytes(bytes.fromhex(s.strip()))


# Process-wide switch: when True, sign_rs skips the randomized-nonce
# OpenSSL path and uses the RFC 6979 deterministic signers (native C++,
# else pure Python). The sim engine flips this on so signatures — and
# therefore the signature-r consensus tie-break — are pure functions of
# (key, message), which byte-identical replay requires.
_DETERMINISTIC_SIGNING = False


def set_deterministic_signing(on: bool) -> bool:
    """Toggle RFC 6979-only signing; returns the previous setting."""
    global _DETERMINISTIC_SIGNING
    prev = _DETERMINISTIC_SIGNING
    _DETERMINISTIC_SIGNING = bool(on)
    return prev


def generate_key() -> PrivateKey:
    """reference: keys/private_key.go:21 (GenerateECDSAKey)."""
    while True:
        d = secrets.randbelow(curve.N)
        if d >= 1:
            return PrivateKey(d)
