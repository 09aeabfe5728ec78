"""Crypto (reference: src/crypto/, src/crypto/keys/).

SHA-256 hashing, canonical serialization, secp256k1 ECDSA keys with the
reference's consensus-visible formats:

- signature encoding is ``r.Text(36) + "|" + s.Text(36)`` (base-36)
  (reference: keys/signature.go:25-38);
- the validator ID is the 32-bit FNV-1a hash of the uncompressed public key
  (reference: keys/public_key.go:32-46).

Signing is deterministic (RFC 6979), so events are reproducible; verification
tries the native library (``babble_tpu_torch.native_crypto``) first, then
OpenSSL via ``cryptography``, then pure Python (always available).
"""

from babble_tpu_torch.crypto.hashing import sha256, simple_hash_from_two_hashes
from babble_tpu_torch.crypto.keys import (
    PrivateKey,
    PublicKey,
    decode_signature,
    encode_signature,
    generate_key,
    public_key_id,
)
from babble_tpu_torch.crypto.keyfile import SimpleKeyfile

__all__ = [
    "PrivateKey",
    "PublicKey",
    "SimpleKeyfile",
    "decode_signature",
    "encode_signature",
    "generate_key",
    "public_key_id",
    "sha256",
    "simple_hash_from_two_hashes",
]
