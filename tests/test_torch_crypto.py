"""The port's crypto surface against the JAX package's: the names
``babble_tpu_torch.crypto`` exports, the native batch SHA-256, and the
twins of tests/test_native_crypto.py (signer, verifiers, batch verifier
and host prevalidation, each case through both packages)."""

from __future__ import annotations

import hashlib
import importlib
import random

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


# -- twins of tests/test_native_crypto.py -------------------------------------
# Each case runs through both packages (``pkg``) on the same seeded inputs:
# the native C++ library (signer, verifier, batch verifier) against the
# pure-Python oracle, and the host batch prevalidation of Events.

PKGS = ("babble_tpu", "babble_tpu_torch")


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _native(pkg: str):
    nc = _m(pkg, "native_crypto")
    if not nc.available():
        pytest.skip("the native crypto library did not build here")
    return nc


def _pub64(px: int, py: int) -> bytes:
    return px.to_bytes(32, "big") + py.to_bytes(32, "big")


@pytest.mark.parametrize("pkg", PKGS)
def test_sign_verify_pubkey_differential(pkg):
    """The native signer is bit-identical to the oracle (RFC 6979, no low-s
    normalisation), and the native verifier agrees with it; the two
    packages give the same signatures."""
    nc, curve = _native(pkg), _m(pkg, "crypto.secp256k1")
    sha256 = _m(pkg, "crypto.hashing").sha256
    rng = random.Random(1234)
    sigs = []
    for i in range(25):
        d = rng.randrange(1, curve.N)
        priv = d.to_bytes(32, "big")
        msg = sha256(f"diff {i}".encode())
        px, py = curve.pubkey_from_scalar(d)
        assert nc.pubkey(priv) == (px, py)
        r, s = curve.sign(d, msg)
        assert nc.sign(priv, msg) == (r, s)
        sigs.append((r, s))
        pub64 = _pub64(px, py)
        assert nc.verify_one(pub64, msg, r, s) is True
        assert curve.verify((px, py), msg, r, s) is True
        assert nc.verify_one(pub64, sha256(b"other"), r, s) is False
        assert nc.verify_one(pub64, msg, r, (s + 1) % curve.N) is False
    ref = _m(PKGS[0], "crypto.secp256k1")
    rng = random.Random(1234)
    for i, rs in enumerate(sigs):
        d = rng.randrange(1, ref.N)
        assert ref.sign(d, _m(PKGS[0], "crypto.hashing").sha256(
            f"diff {i}".encode())) == rs


@pytest.mark.parametrize("pkg", PKGS)
def test_adversarial_inputs_rejected(pkg):
    """r or s of 0, n or beyond, negative or wider than 256 bits, and a key
    off the curve verify False, never raise."""
    nc, curve = _native(pkg), _m(pkg, "crypto.secp256k1")
    sha256 = _m(pkg, "crypto.hashing").sha256
    d = random.Random(99).randrange(1, curve.N)
    px, py = curve.pubkey_from_scalar(d)
    pub64 = _pub64(px, py)
    msg = sha256(b"adv")
    r, s = curve.sign(d, msg)
    for bad_r, bad_s in ((0, s), (r, 0), (curve.N, s), (r, curve.N + 5),
                         (-1, s), (r, -s), (1 << 300, s), (r, 1 << 256)):
        assert nc.verify_one(pub64, msg, bad_r, bad_s) is False
    off_curve = _pub64(px + 1, py)
    assert nc.verify_one(off_curve, msg, r, s) is False
    assert nc.verify_one(pub64, msg, r, s) is True


@pytest.mark.parametrize("pkg", PKGS)
def test_hostile_signature_string_via_public_api(pkg):
    """A gossiped signature of '-1|1' or a 300-bit r verifies False through
    ``PublicKey.verify``, not an exception."""
    keys, sha256 = _m(pkg, "crypto.keys"), _m(pkg, "crypto.hashing").sha256
    pk = keys.PrivateKey(0xC0FFEE).public_key
    msg = sha256(b"hostile")
    assert pk.verify(msg, "-1|1") is False
    assert pk.verify(msg, f"{1 << 300}|{7}") is False


@pytest.mark.parametrize("pkg", PKGS)
def test_batch_verify_mixed_validity(pkg):
    """One native batch call gives each of 40 signatures its verdict, every
    third one corrupted."""
    nc, curve = _native(pkg), _m(pkg, "crypto.secp256k1")
    sha256 = _m(pkg, "crypto.hashing").sha256
    rng = random.Random(5)
    pubs, msgs, rss, expect = [], [], [], []
    for i in range(40):
        d = rng.randrange(1, curve.N)
        msg = sha256(f"batch {i}".encode())
        r, s = curve.sign(d, msg)
        good = i % 3 != 0
        if not good:
            s = (s + 1) % curve.N or 1
        pubs.append(_pub64(*curve.pubkey_from_scalar(d)))
        msgs.append(msg)
        rss.append((r, s))
        expect.append(good)
    assert nc.verify_batch(pubs, msgs, rss) == expect


@pytest.mark.parametrize("pkg", PKGS)
def test_prevalidate_events_host(pkg):
    """Over real Events: a tampered event fails, the others pass, and the
    insert path's ``verify()`` reads the cached verdicts. The tamper flips
    the low byte of the decoded ``s`` and re-encodes it, so the signature
    always changes (the reference's digit overwrite leaves it unchanged
    when the digit already holds the value it writes)."""
    _native(pkg)
    keys = _m(pkg, "crypto.keys")
    Event = _m(pkg, "hashgraph.event").Event
    prevalidate = _m(pkg, "crypto.batch").prevalidate_events_host
    k = keys.PrivateKey(0x5EED5)
    events = []
    for i in range(6):
        ev = Event.new([f"tx{i}".encode()], [], [], ["", ""],
                       k.public_key.bytes(), i, timestamp=i)
        ev.sign(k)
        events.append(ev)
    bad = events[3]
    r, s = keys.decode_signature(bad.signature)
    tampered = keys.encode_signature(r, s ^ 0xFF)
    assert tampered != bad.signature
    bad.signature = tampered
    assert prevalidate(events) is True
    for i, ev in enumerate(events):
        assert ev.verify() is (i != 3)


@pytest.mark.parametrize("pkg", PKGS)
def test_cross_backend_sign_verify_agreement(pkg):
    """The host backends (native C++, OpenSSL where present, pure Python)
    agree: each one's signature verifies under every other, and a
    corrupted hash or s fails under all."""
    nc, ref = _native(pkg), _m(pkg, "crypto.secp256k1")
    keys = _m(pkg, "crypto.keys")
    key = keys.PrivateKey(random.Random(77).randrange(1, ref.N))
    pub = key.public_key
    pub_bytes = _pub64(pub.x, pub.y)
    for i in range(4):
        h = hashlib.sha256(f"vector {i}".encode()).digest()
        for r, s in (key.sign_rs(h), ref.sign(key.d, h)):
            assert nc.verify_one(pub_bytes, h, r, s) is True
            assert ref.verify((pub.x, pub.y), h, r, s)
            assert pub.verify_rs(h, r, s)
            h2 = hashlib.sha256(h).digest()
            assert nc.verify_one(pub_bytes, h2, r, s) is False
            assert not ref.verify((pub.x, pub.y), h2, r, s)
            assert not pub.verify_rs(h2, r, s)
            s2 = s + 1 if s + 1 < ref.N else s - 1
            assert nc.verify_one(pub_bytes, h, r, s2) is False
            assert not ref.verify((pub.x, pub.y), h, r, s2)
