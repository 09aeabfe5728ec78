"""Twin of tests/test_codec.py for the port's binary wire codec
(``babble_tpu_torch/net/codec.py``): each of the reference's seven cases
runs through both packages, and the two codecs are held to each other on
the wire. With fixed keys and RFC 6979 signing on both packages, the same
seeded messages give the same request and response frames byte for byte,
each package decodes the other's frames to the same canonical JSON, and
the event blob, the frame header and the negotiation probe are equal."""

from __future__ import annotations

import importlib
import random
import struct
import types

import pytest

REF, PORT = "babble_tpu", "babble_tpu_torch"
PKGS = (REF, PORT)


def _mods(pkg: str) -> types.SimpleNamespace:
    names = {"canonical": "crypto.canonical", "keys": "crypto.keys",
             "event": "hashgraph.event",
             "itx": "hashgraph.internal_transaction", "codec": "net.codec",
             "rpc": "net.rpc", "peer": "peers.peer"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()})


class Gen:
    """The reference test's random messages, built from ``pkg``'s classes
    with ``keys``: the same seed gives the same messages in both
    packages."""

    def __init__(self, pkg: str, keys, nonces: bool = False):
        self.m = _mods(pkg)
        self.keys = keys
        self.nonces = nonces  # join nonces drawn from the seed

    def peer(self, i: int):
        return self.m.peer.Peer(
            net_addr=f"127.0.0.1:{9000 + i}",
            pub_key_hex=self.keys[i % len(self.keys)].public_key.hex(),
            moniker=f"p{i}")

    def itx(self, rng):
        itx = self.m.itx.InternalTransaction.join(self.peer(rng.randrange(2)))
        if self.nonces:
            itx.body.nonce = rng.randrange(1, 1 << 63)
        itx.sign(self.keys[0])
        return itx

    def wire_event(self, rng):
        """A randomized wire event covering the field space: binary junk
        transactions (incl. empty), negative indexes, block signatures,
        and occasionally a signed internal transaction."""
        ev = self.m.event
        txs = [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40)))
               for _ in range(rng.randrange(0, 5))]
        sigs = [ev.WireBlockSignature(
            index=rng.randrange(0, 1 << 30),
            signature=f"{rng.randrange(1 << 60)}|{rng.randrange(1 << 60)}")
            for _ in range(rng.randrange(0, 3))]
        itxs = [self.itx(rng)] if rng.random() < 0.3 else []
        return ev.WireEvent(
            body=ev.WireBody(
                transactions=txs, internal_transactions=itxs,
                block_signatures=sigs,
                creator_id=rng.randrange(0, 1 << 32),
                other_parent_creator_id=rng.randrange(0, 1 << 32),
                index=rng.randrange(-1, 1 << 20),
                self_parent_index=rng.randrange(-1, 1 << 20),
                other_parent_index=rng.randrange(-1, 1 << 20),
                timestamp=rng.randrange(0, 1 << 40)),
            signature=f"{rng.randrange(1 << 64)}|{rng.randrange(1 << 64)}")

    @staticmethod
    def trace(rng):
        if rng.random() < 0.5:
            return None
        return {"id": f"{rng.randrange(1 << 32):x}-{rng.randrange(1 << 16)}",
                "origin": rng.randrange(1 << 32), "hop": rng.randrange(8),
                "ts": rng.randrange(1 << 50)}

    @staticmethod
    def known(rng):
        return {rng.randrange(1 << 32): rng.randrange(-1, 1 << 20)
                for _ in range(rng.randrange(0, 8))}

    def request(self, rng):
        rpc, roll = self.m.rpc, rng.randrange(4)
        if roll == 0:
            return rpc.SyncRequest(
                from_id=rng.randrange(1 << 32), known=self.known(rng),
                sync_limit=rng.randrange(0, 5000), trace=self.trace(rng))
        if roll == 1:
            return rpc.EagerSyncRequest(
                from_id=rng.randrange(1 << 32),
                events=[self.wire_event(rng)
                        for _ in range(rng.randrange(0, 4))],
                trace=self.trace(rng))
        if roll == 2:
            return rpc.FastForwardRequest(from_id=rng.randrange(1 << 32),
                                          trace=self.trace(rng))
        return rpc.JoinRequest(internal_transaction=self.itx(rng))

    def response(self, rng, type_byte: int):
        rpc = self.m.rpc
        if type_byte == rpc.SYNC:
            return rpc.SyncResponse(
                from_id=rng.randrange(1 << 32),
                events=[self.wire_event(rng)
                        for _ in range(rng.randrange(0, 4))],
                known=self.known(rng))
        if type_byte == rpc.EAGER_SYNC:
            return rpc.EagerSyncResponse(from_id=rng.randrange(1 << 32),
                                         success=rng.random() < 0.5)
        if type_byte == rpc.FAST_FORWARD:
            return rpc.FastForwardResponse(
                from_id=rng.randrange(1 << 32),
                snapshot=bytes(rng.randrange(256) for _ in range(16)))
        return rpc.JoinResponse(
            from_id=rng.randrange(1 << 32), accepted=rng.random() < 0.5,
            accepted_round=rng.randrange(1 << 20),
            peers=[self.peer(i) for i in range(rng.randrange(0, 3))])

    def canon(self, msg) -> bytes:
        """The JSON-framing encoding of a message: the byte-identity
        yardstick."""
        return self.m.canonical.canonical_dumps(msg.to_dict())


def _gen(pkg: str) -> Gen:
    keys = _mods(pkg).keys
    return Gen(pkg, [keys.generate_key() for _ in range(2)])


@pytest.fixture
def deterministic():
    """RFC 6979 signing on both packages, so that the same key signs the
    same bytes alike in each."""
    prev = {p: _mods(p).keys.set_deterministic_signing(True) for p in PKGS}
    try:
        yield
    finally:
        for p, v in prev.items():
            _mods(p).keys.set_deterministic_signing(v)


def _fixed(pkg: str) -> Gen:
    """Fixed keys and seeded join nonces: with RFC 6979 signing, equal
    messages in both packages."""
    keys = _mods(pkg).keys
    return Gen(pkg, [keys.PrivateKey(d) for d in (0xC0DEC1, 0xC0DEC2)],
               nonces=True)


# -- the reference's seven cases, through each package ----------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_every_request_type_round_trips_byte_identically(pkg):
    """Property: for every RPC request type, binary-encode -> decode ->
    re-encode as canonical JSON equals the original's canonical JSON."""
    g = _gen(pkg)
    codec, rpc = g.m.codec, g.m.rpc
    rng = random.Random(0xC0DEC)
    seen = set()
    for _ in range(120):
        req = g.request(rng)
        seen.add(type(req).__name__)
        type_byte, payload = codec.encode_request(req)
        assert type_byte == rpc.TYPE_OF_REQUEST[type(req)]
        back = codec.decode_request(type_byte, payload)
        assert g.canon(back) == g.canon(req), type(req).__name__
    assert seen == {"SyncRequest", "EagerSyncRequest", "FastForwardRequest",
                    "JoinRequest"}


@pytest.mark.parametrize("pkg", PKGS)
def test_every_response_type_round_trips_byte_identically(pkg):
    g = _gen(pkg)
    codec = g.m.codec
    rng = random.Random(0xFACADE)
    for _ in range(120):
        type_byte = rng.randrange(4)
        resp = g.response(rng, type_byte)
        payload = codec.encode_response(type_byte, resp)
        back = codec.decode_response(type_byte, payload)
        assert g.canon(back) == g.canon(resp), type(resp).__name__


@pytest.mark.parametrize("pkg", PKGS)
def test_event_blob_memoized_once_per_event(pkg):
    """One event pushed to many peers costs ONE encode: the blob memo on
    the shared WireEvent serves every later send."""
    g = _gen(pkg)
    codec = g.m.codec
    we = g.wire_event(random.Random(7))
    base_encoded = codec.CODEC_STATS.events_encoded
    base_hits = codec.CODEC_STATS.event_cache_hits
    blob = codec.encode_wire_event(we)
    for _ in range(15):
        assert codec.encode_wire_event(we) is blob
    assert codec.CODEC_STATS.events_encoded == base_encoded + 1
    assert codec.CODEC_STATS.event_cache_hits == base_hits + 15
    assert g.canon(codec.decode_wire_event(blob)) == g.canon(we)


@pytest.mark.parametrize("pkg", PKGS)
def test_truncated_event_blob_raises(pkg):
    g = _gen(pkg)
    blob = g.m.codec.encode_wire_event(g.wire_event(random.Random(8)))
    with pytest.raises((ValueError, IndexError, Exception)):
        g.m.codec.decode_wire_event(blob[: len(blob) // 2])


@pytest.mark.parametrize("pkg", PKGS)
def test_hostile_element_count_rejected(pkg):
    """A frame claiming 2^30 events must fail fast on the count guard, not
    allocate."""
    m = _mods(pkg)
    payload = struct.pack(">q", 1) + struct.pack(">I", 1 << 30)
    with pytest.raises(ValueError):
        m.codec.decode_request(m.rpc.EAGER_SYNC, payload)


@pytest.mark.parametrize("pkg", PKGS)
def test_frame_header_round_trip_and_size_guard(pkg):
    codec = _mods(pkg).codec
    frame = codec.pack_frame(2, codec.FLAG_ERROR, 0xDEADBEEF, b"oops")
    kind, flags, req_id, length = codec.unpack_header(frame)
    assert (kind, flags, req_id, length) == (2, codec.FLAG_ERROR, 0xDEADBEEF,
                                             4)
    assert frame[codec.FRAME_HEADER.size:] == b"oops"
    with pytest.raises(ValueError):
        codec.pack_frame(0, 0, 1, b"x" * (codec.MAX_FRAME + 1))


@pytest.mark.parametrize("pkg", PKGS)
def test_hello_is_a_well_formed_legacy_frame(pkg):
    """The negotiation probe must parse as a legacy frame (type 0xBB,
    length 4), so that an old JSON server answers it instead of dropping
    the connection."""
    codec = _mods(pkg).codec
    assert codec.HELLO[0] == 0xBB
    (length,) = struct.unpack(">I", codec.HELLO[1:5])
    assert length == len(codec.HELLO) - 5 == 4
    assert codec.HELLO[5:8] == b"BLG"
    assert codec.HELLO[8] == codec.CODEC_VERSION


# -- the two codecs on the wire ---------------------------------------------


def test_request_frames_byte_identical_across_packages(deterministic):
    """The same seeded requests encode to the same (type, payload) in both
    packages, and each package decodes the other's payload to the same
    canonical JSON."""
    ref, port = _fixed(REF), _fixed(PORT)
    rng_ref, rng_port = random.Random(0xC0DEC), random.Random(0xC0DEC)
    for _ in range(120):
        a, b = ref.request(rng_ref), port.request(rng_port)
        assert ref.canon(a) == port.canon(b)
        wire_a = ref.m.codec.encode_request(a)
        wire_b = port.m.codec.encode_request(b)
        assert wire_a == wire_b, type(a).__name__
        assert (port.canon(port.m.codec.decode_request(*wire_a))
                == ref.canon(ref.m.codec.decode_request(*wire_b))
                == ref.canon(a))


def test_response_frames_byte_identical_across_packages(deterministic):
    ref, port = _fixed(REF), _fixed(PORT)
    rng_ref, rng_port = random.Random(0xFACADE), random.Random(0xFACADE)
    for _ in range(120):
        type_byte = rng_ref.randrange(4)
        assert rng_port.randrange(4) == type_byte
        a = ref.response(rng_ref, type_byte)
        b = port.response(rng_port, type_byte)
        wire_a = ref.m.codec.encode_response(type_byte, a)
        wire_b = port.m.codec.encode_response(type_byte, b)
        assert wire_a == wire_b, type(a).__name__
        assert (port.canon(port.m.codec.decode_response(type_byte, wire_a))
                == ref.canon(ref.m.codec.decode_response(type_byte, wire_b))
                == ref.canon(a))


def test_event_blobs_and_framing_equal_across_packages(deterministic):
    """Event blobs, frame headers and the negotiation probe are the same
    bytes in both packages."""
    ref, port = _fixed(REF), _fixed(PORT)
    rng_ref, rng_port = random.Random(9), random.Random(9)
    for _ in range(30):
        blob = ref.m.codec.encode_wire_event(ref.wire_event(rng_ref))
        assert port.m.codec.encode_wire_event(
            port.wire_event(rng_port)) == blob
        assert port.canon(port.m.codec.decode_wire_event(blob)) == ref.canon(
            ref.m.codec.decode_wire_event(blob))
    rc, pc = ref.m.codec, port.m.codec
    assert pc.HELLO == rc.HELLO and pc.CODEC_VERSION == rc.CODEC_VERSION
    assert pc.MAX_FRAME == rc.MAX_FRAME
    for args in ((2, rc.FLAG_ERROR, 0xDEADBEEF, b"oops"), (0, 0, 1, b""),
                 (3, 0, 7, bytes(range(256)))):
        assert pc.pack_frame(*args) == rc.pack_frame(*args)
        assert pc.unpack_header(rc.pack_frame(*args)) == rc.unpack_header(
            rc.pack_frame(*args))
