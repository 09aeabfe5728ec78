"""ctypes loader for the native batch crypto library (native/secp256k1.cc).

The port keeps its own loader so it never imports the JAX package. It
builds the C++ source with g++ on first use and searches in the JAX
package's order:

1. a checkout: the repository's ``native/secp256k1.cc``, built into the
   git-ignored ``build/native/`` (never the shared object committed
   beside the source);
2. an installed package: ``babble_tpu_torch/_native/``, where the wheel
   ships the source and, built where a compiler was found, the library;
3. a user-cache build (``~/.cache/babble_tpu_torch/native/``) when the
   package directory is read-only.

When there is no source or no compiler, every entry point returns None
and ``crypto.keys`` falls through to OpenSSL (``cryptography``) and then
pure Python, in the same order as the JAX package.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
_SO_NAME = "libbabble_crypto.so"

# (source, shared object, user-cache shared object) in search order: the
# checkout, which builds only inside itself, then the installed package
_CANDIDATES = [
    (os.path.join(_REPO_ROOT, "native", "secp256k1.cc"),
     os.path.join(_REPO_ROOT, "build", "native", _SO_NAME), None),
    (os.path.join(_PKG_DIR, "_native", "secp256k1.cc"),
     os.path.join(_PKG_DIR, "_native", _SO_NAME),
     os.path.join(os.path.expanduser("~"), ".cache", "babble_tpu_torch",
                  "native", _SO_NAME)),
]


def _locate(candidates) -> Tuple[str, str, Optional[str]]:
    """The first candidate whose source exists, else the first one (whose
    missing source makes every entry point None)."""
    return next((c for c in candidates if os.path.exists(c[0])),
                candidates[0])


_SRC, _SO, _SO_FALLBACK = _locate(_CANDIDATES)

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _build_at(so_path: str) -> bool:
    # Compile to a temp path and rename into place: os.replace is atomic on
    # POSIX, so concurrent processes never dlopen a half-written library.
    tmp = f"{so_path}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, so_path)
        return True
    except (OSError, subprocess.SubprocessError) as err:
        logger.info("native crypto build unavailable at %s: %s", so_path, err)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _build() -> bool:
    global _SO
    if _build_at(_SO):
        return True
    # a read-only install directory: build into the user cache instead
    if _SO_FALLBACK and _SO != _SO_FALLBACK and _build_at(_SO_FALLBACK):
        _SO = _SO_FALLBACK
        return True
    return False


def _stale(so_path: Optional[str]) -> bool:
    return not so_path or not os.path.exists(so_path) or (
        os.path.exists(_SRC)
        and os.path.getmtime(_SRC) > os.path.getmtime(so_path)
    )


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _SO
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        if _stale(_SO) and not _stale(_SO_FALLBACK):
            # an earlier process already built into the user cache
            _SO = _SO_FALLBACK
        if _stale(_SO) and not _build() and not os.path.exists(_SO):
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as err:
            logger.info("native crypto load failed: %s", err)
            return None
        lib.bt_verify_batch.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_char_p,
        ]
        lib.bt_verify_batch.restype = None
        lib.bt_sign.restype = ctypes.c_int
        lib.bt_sign.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.bt_pubkey.restype = ctypes.c_int
        lib.bt_pubkey.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.bt_sha256_batch.restype = None
        lib.bt_sha256_batch.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_char_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def host_crypto_path() -> str:
    """Which host path ``PublicKey.verify`` takes in this process:
    ``"native"``, ``"openssl"`` or ``"python"`` (tried in that order)."""
    if available():
        return "native"
    from babble_tpu_torch.crypto import keys

    return "openssl" if keys._HAVE_OPENSSL else "python"


def verify_batch(
    pubs: Sequence[bytes], msgs: Sequence[bytes], rs: Sequence[Tuple[int, int]]
) -> Optional[List[bool]]:
    """Verify n signatures in one native call.

    pubs: 64-byte x||y each; msgs: 32-byte hashes; rs: (r, s) ints.
    Returns None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(pubs)
    if not (n == len(msgs) == len(rs)):
        raise ValueError("batch length mismatch")
    if n == 0:
        return []
    # Attacker-controlled signatures can decode to negative or >256-bit
    # ints (base-36 is unbounded); those are invalid, never an exception.
    results = [False] * n
    idx: List[int] = []
    chunks: List[bytes] = []
    for i, (r, s) in enumerate(rs):
        if 0 < r < (1 << 256) and 0 < s < (1 << 256):
            idx.append(i)
            chunks.append(r.to_bytes(32, "big") + s.to_bytes(32, "big"))
    if not idx:
        return results
    pub_buf = b"".join(pubs[i] for i in idx)
    msg_buf = b"".join(msgs[i] for i in idx)
    rs_buf = b"".join(chunks)
    out = ctypes.create_string_buffer(len(idx))
    lib.bt_verify_batch(pub_buf, msg_buf, rs_buf, len(idx), out)
    for i, b in zip(idx, out.raw):
        results[i] = b == 1
    return results


def verify_one(pub64: bytes, msg32: bytes, r: int, s: int) -> Optional[bool]:
    res = verify_batch([pub64], [msg32], [(r, s)])
    return None if res is None else res[0]


def sign(priv32: bytes, msg32: bytes) -> Optional[Tuple[int, int]]:
    """Deterministic RFC 6979 ECDSA sign; (r, s) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(64)
    rc = lib.bt_sign(priv32, msg32, out)
    if rc != 0:
        raise ValueError(f"native sign failed (rc={rc})")
    raw = out.raw
    return int.from_bytes(raw[:32], "big"), int.from_bytes(raw[32:], "big")


def pubkey(priv32: bytes) -> Optional[Tuple[int, int]]:
    lib = _load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(64)
    rc = lib.bt_pubkey(priv32, out)
    if rc != 0:
        raise ValueError(f"native pubkey failed (rc={rc})")
    raw = out.raw
    return int.from_bytes(raw[:32], "big"), int.from_bytes(raw[32:], "big")


def sha256_batch(msgs: Sequence[bytes]) -> Optional[List[bytes]]:
    """SHA-256 of n equal-length messages in one native call: None when the
    library is absent, [] for no messages; ValueError when the lengths
    differ."""
    lib = _load()
    if lib is None:
        return None
    if not msgs:
        return []
    stride = len(msgs[0])
    if any(len(m) != stride for m in msgs):
        raise ValueError("sha256_batch requires equal-length messages")
    out = ctypes.create_string_buffer(32 * len(msgs))
    lib.bt_sha256_batch(b"".join(msgs), stride, len(msgs), out)
    raw = out.raw
    return [raw[32 * i:32 * i + 32] for i in range(len(msgs))]
