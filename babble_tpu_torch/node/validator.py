"""Validator: wrapper around the node's signing key
(reference: src/node/validator.go:11-50)."""

from __future__ import annotations

from ..crypto.keys import PrivateKey


class Validator:
    def __init__(self, key: PrivateKey, moniker: str = ""):
        self.key = key
        self.moniker = moniker
        # Deriving the public key is a scalar multiplication — do it once.
        self._pub = key.public_key
        self._id = self._pub.id()

    def id(self) -> int:
        """FNV-1a 32-bit id of the public key
        (reference: validator.go:30-33, keys/public_key.go:36)."""
        return self._id

    def public_key_bytes(self) -> bytes:
        return self._pub.bytes()

    def public_key_hex(self) -> str:
        return self._pub.hex()
