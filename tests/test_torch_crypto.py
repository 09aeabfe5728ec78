"""The port's crypto surface against the JAX package's: the names
``babble_tpu_torch.crypto`` exports, and the native batch SHA-256."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

import babble_tpu.crypto as jcrypto
import babble_tpu_torch.crypto as pcrypto
from babble_tpu import native_crypto as jnative
from babble_tpu_torch import native_crypto as pnative


def test_crypto_exports_match_the_jax_package():
    """``babble_tpu_torch.crypto`` exports what ``babble_tpu.crypto`` does,
    ``SimpleKeyfile`` included."""
    assert sorted(pcrypto.__all__) == sorted(jcrypto.__all__)
    for name in pcrypto.__all__:
        assert getattr(pcrypto, name).__name__ == getattr(jcrypto, name).__name__


def test_simple_keyfile_round_trips(tmp_path):
    """The re-exported ``SimpleKeyfile`` writes a key the JAX package's
    reads back, and reads the JAX package's."""
    key = pcrypto.generate_key()
    path = str(tmp_path / "priv_key")
    pcrypto.SimpleKeyfile(path).write_key(key)
    assert jcrypto.SimpleKeyfile(path).read_key().d == key.d
    other = jcrypto.generate_key()
    jcrypto.SimpleKeyfile(path).write_key(other)
    assert pcrypto.SimpleKeyfile(path).read_key().d == other.d


@pytest.mark.parametrize("n,length", [(0, 0), (1, 0), (1, 32), (7, 55),
                                      (64, 64), (33, 200)])
def test_sha256_batch_equals_hashlib_and_the_jax_package(n, length):
    """One native call hashes a batch of equal-length messages exactly as
    hashlib and the JAX package's ``sha256_batch`` do; the empty batch
    gives []."""
    if not pnative.available():
        pytest.skip("the native crypto library did not build here")
    rng = np.random.RandomState(1000 * n + length)
    msgs = [rng.bytes(length) for _ in range(n)]
    got = pnative.sha256_batch(msgs)
    assert got == [hashlib.sha256(m).digest() for m in msgs]
    assert got == jnative.sha256_batch(msgs)


def test_sha256_batch_refuses_unequal_lengths():
    if not pnative.available():
        pytest.skip("the native crypto library did not build here")
    with pytest.raises(ValueError, match="equal-length"):
        pnative.sha256_batch([b"abc", b"abcd"])


def test_sha256_batch_without_the_library_is_none(monkeypatch):
    monkeypatch.setattr(pnative, "_load", lambda: None)
    assert pnative.sha256_batch([b"abc"]) is None
    assert pnative.sha256_batch([]) is None
