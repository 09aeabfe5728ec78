"""Binary framed wire codec for the gossip hot path.

The seed wire format (net/tcp.py) is canonical JSON with every bytes
field base64-encoded — so each event pushed to a peer pays a dict
build, a b64 walk, and a JSON parse on the far side, per peer. At 16
nodes that codec IS the wall (BENCH_r05). This module replaces it on
the Sync/EagerSync hot path with a length-prefixed binary encoding:

- Each :class:`~babble_tpu_torch.hashgraph.event.WireEvent` is encoded ONCE
  per process into an opaque byte blob (memoized on the shared
  WireEvent exactly like its ``normalized()`` JSON memo) and travels as
  a length-prefixed slice inside the message payload — no intermediate
  Python-dict round-trip, no base64. At ingest the blob is decoded once
  into a WireEvent and handed straight to ``Core.prepare_sync``.
- Cold-path messages (FastForward/Join, which carry Blocks/Frames/peer
  sets) ride as a canonical-JSON blob inside the binary frame: they are
  rare, and reusing the JSON schema keeps them byte-identical with the
  legacy wire (the interop property the codec tests pin).
- A 9-byte HELLO (type 0xBB, u32 length 4, "BLG"+version — a
  well-formed legacy frame) negotiates the protocol per
  connection, so binary peers interoperate with old JSON peers in both
  directions (net/atcp.py; the PR-8 backward-compat pattern extended
  from one optional field to the whole framing).

Byte order is big-endian throughout; all ints are signed 64-bit (peer
ids are 32-bit FNV hashes, indexes may be -1). Frames are bounded by
``MAX_FRAME`` so a hostile length prefix cannot force a huge allocation.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional, Tuple

from ..crypto.canonical import canonical_dumps
from ..hashgraph.event import WireEvent
from .rpc import (
    EAGER_SYNC,
    EagerSyncRequest,
    EagerSyncResponse,
    FAST_FORWARD,
    FastForwardRequest,
    JOIN,
    REQUEST_TYPES,
    RESPONSE_TYPES,
    SYNC,
    SyncRequest,
    SyncResponse,
)

# Upper bound on any frame (request or response) — shared with the
# legacy TCP framing so both protocols refuse the same hostile sizes.
MAX_FRAME = 64 * 1024 * 1024

#: Protocol negotiation: a binary client opens with HELLO and waits for
#: the identical ack. The hello is deliberately shaped as a WELL-FORMED
#: legacy frame — type byte 0xBB, u32 length 4, payload b"BLG"+version —
#: so an old JSON server parses it cleanly and answers with its normal
#: "unknown rpc type 187" error frame (keeping the connection open)
#: instead of tearing the connection down on a hostile-looking length.
#: The client disambiguates on the FIRST REPLY BYTE: a binary server
#: acks with 0xBB; a legacy server's error frame starts with the length
#: prefix's MSB, 0x00 for any sane frame. 0xBB can never be a legacy
#: RPC type byte (0-3), so the server side disambiguates on the first
#: byte of the connection.
CODEC_VERSION = 1
HELLO = b"\xbb" + struct.pack(">I", 4) + b"BLG" + bytes([CODEC_VERSION])

#: Binary frame header: kind(u8) flags(u8) req_id(u32) length(u32).
#: Requests carry the RPC type byte in ``kind``; responses set RESP_BIT.
#: req_id multiplexes many in-flight RPCs over one connection.
FRAME_HEADER = struct.Struct(">BBII")
RESP_BIT = 0x80
FLAG_ERROR = 0x01

_I64 = struct.Struct(">q")
_U32 = struct.Struct(">I")
_EVENT_VERSION = 1


class CodecStats:
    """Process-wide codec tallies (co-located nodes share them; racy
    increments under the GIL may drop an update, never corrupt)."""

    __slots__ = (
        "events_encoded", "event_cache_hits", "events_decoded",
        "bytes_sent", "bytes_received", "conns_binary", "conns_json",
    )

    def __init__(self) -> None:
        self.events_encoded = 0      # event blobs built (memo misses)
        self.event_cache_hits = 0    # sends served from the blob memo
        self.events_decoded = 0      # blobs decoded at ingest
        self.bytes_sent = 0          # wire bytes out (all protocols)
        self.bytes_received = 0      # wire bytes in (all protocols)
        self.conns_binary = 0        # connections negotiated binary
        self.conns_json = 0          # connections fell back to JSON

    def snapshot(self) -> dict:
        return {name: getattr(self, name) for name in self.__slots__}


#: The one shared tally — net/tcp.py and net/atcp.py both feed it.
CODEC_STATS = CodecStats()


# -- primitive writers/readers -------------------------------------------


def _w_bytes(out: List[bytes], b: bytes) -> None:
    out.append(_U32.pack(len(b)))
    out.append(b)


def _w_str(out: List[bytes], s: str) -> None:
    _w_bytes(out, s.encode("utf-8"))


def _w_i64(out: List[bytes], v: int) -> None:
    out.append(_I64.pack(v))


class _Reader:
    """Cursor over one payload; every read is bounds-checked so a
    truncated or hostile frame raises ValueError, never over-reads."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def i64(self) -> int:
        v = _I64.unpack_from(self.buf, self.pos)[0]
        self.pos += 8
        return v

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def nbytes(self) -> bytes:
        n = _U32.unpack_from(self.buf, self.pos)[0]
        self.pos += 4
        if n > MAX_FRAME or self.pos + n > len(self.buf):
            raise ValueError("truncated or oversized field")
        v = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return v

    def string(self) -> str:
        return self.nbytes().decode("utf-8")

    def count(self, limit: int = 1 << 22) -> int:
        n = _U32.unpack_from(self.buf, self.pos)[0]
        self.pos += 4
        if n > limit:
            raise ValueError(f"hostile element count {n}")
        return n


def _w_json(out: List[bytes], obj) -> None:
    """Canonical-JSON blob (cold-path sub-objects: internal transactions,
    trace contexts, FastForward/Join payloads)."""
    _w_bytes(out, canonical_dumps(obj))


def _r_json(r: _Reader):
    return json.loads(_r_bytes_or_empty(r))


def _r_bytes_or_empty(r: _Reader) -> bytes:
    b = r.nbytes()
    return b if b else b"null"


def _w_opt_json(out: List[bytes], obj) -> None:
    if obj is None:
        out.append(b"\x00")
    else:
        out.append(b"\x01")
        _w_json(out, obj)


def _r_opt_json(r: _Reader):
    if r.u8() == 0:
        return None
    return _r_json(r)


def _w_known(out: List[bytes], known: Dict[int, int]) -> None:
    out.append(_U32.pack(len(known)))
    for pid, h in known.items():
        out.append(_I64.pack(pid))
        out.append(_I64.pack(h))


def _r_known(r: _Reader) -> Dict[int, int]:
    return {r.i64(): r.i64() for _ in range(r.count())}


# -- event blobs ----------------------------------------------------------


def encode_wire_event(we: WireEvent) -> bytes:
    """One immutable event → one opaque blob, memoized on the WireEvent:
    ``Event.to_wire()`` shares a single WireEvent per event, so pushing
    an event to 15 peers costs one encode and 15 buffer joins."""
    blob = getattr(we, "_bin", None)
    if blob is not None:
        CODEC_STATS.event_cache_hits += 1
        return blob
    CODEC_STATS.events_encoded += 1
    b = we.body
    out: List[bytes] = [bytes([_EVENT_VERSION])]
    out.append(_I64.pack(b.creator_id))
    out.append(_I64.pack(b.other_parent_creator_id))
    out.append(_I64.pack(b.index))
    out.append(_I64.pack(b.self_parent_index))
    out.append(_I64.pack(b.other_parent_index))
    out.append(_I64.pack(b.timestamp))
    _w_str(out, we.signature)
    out.append(_U32.pack(len(b.transactions)))
    for tx in b.transactions:
        _w_bytes(out, tx)
    out.append(_U32.pack(len(b.block_signatures)))
    for bs in b.block_signatures:
        out.append(_I64.pack(bs.index))
        _w_str(out, bs.signature)
    out.append(_U32.pack(len(b.internal_transactions)))
    for itx in b.internal_transactions:
        _w_json(out, itx.to_dict())
    blob = b"".join(out)
    we._bin = blob
    return blob


def decode_wire_event(blob: bytes) -> WireEvent:
    """Blob → WireEvent, decoded exactly once at ingest (the returned
    object feeds ``Core.prepare_sync`` directly; no dict intermediate)."""
    from ..hashgraph.event import WireBlockSignature, WireBody
    from ..hashgraph.internal_transaction import InternalTransaction

    CODEC_STATS.events_decoded += 1
    r = _Reader(blob)
    if r.u8() != _EVENT_VERSION:
        raise ValueError("unknown event encoding version")
    creator_id = r.i64()
    other_parent_creator_id = r.i64()
    index = r.i64()
    self_parent_index = r.i64()
    other_parent_index = r.i64()
    timestamp = r.i64()
    signature = r.string()
    txs = [r.nbytes() for _ in range(r.count())]
    sigs = [
        WireBlockSignature(index=r.i64(), signature=r.string())
        for _ in range(r.count())
    ]
    itxs = [
        InternalTransaction.from_dict(_r_json(r)) for _ in range(r.count())
    ]
    return WireEvent(
        body=WireBody(
            transactions=txs,
            internal_transactions=itxs,
            block_signatures=sigs,
            creator_id=creator_id,
            other_parent_creator_id=other_parent_creator_id,
            index=index,
            self_parent_index=self_parent_index,
            other_parent_index=other_parent_index,
            timestamp=timestamp,
        ),
        signature=signature,
    )


def _w_events(out: List[bytes], events: List[WireEvent]) -> None:
    out.append(_U32.pack(len(events)))
    for we in events:
        _w_bytes(out, encode_wire_event(we))


def _r_events(r: _Reader) -> List[WireEvent]:
    return [decode_wire_event(r.nbytes()) for _ in range(r.count())]


# -- message payloads -----------------------------------------------------


def encode_request(req) -> Tuple[int, bytes]:
    """Request object → (rpc type byte, binary payload)."""
    out: List[bytes] = []
    if isinstance(req, SyncRequest):
        _w_i64(out, req.from_id)
        _w_known(out, req.known)
        _w_i64(out, req.sync_limit)
        _w_opt_json(out, req.trace)
        return SYNC, b"".join(out)
    if isinstance(req, EagerSyncRequest):
        _w_i64(out, req.from_id)
        _w_events(out, req.events)
        _w_opt_json(out, req.trace)
        return EAGER_SYNC, b"".join(out)
    if isinstance(req, FastForwardRequest):
        _w_i64(out, req.from_id)
        _w_opt_json(out, req.trace)
        return FAST_FORWARD, b"".join(out)
    # JoinRequest (cold path): canonical JSON blob
    _w_json(out, req.to_dict())
    return JOIN, b"".join(out)


def decode_request(type_byte: int, payload: bytes):
    r = _Reader(payload)
    if type_byte == SYNC:
        return SyncRequest(
            from_id=r.i64(), known=_r_known(r), sync_limit=r.i64(),
            trace=_r_opt_json(r),
        )
    if type_byte == EAGER_SYNC:
        return EagerSyncRequest(
            from_id=r.i64(), events=_r_events(r), trace=_r_opt_json(r)
        )
    if type_byte == FAST_FORWARD:
        return FastForwardRequest(from_id=r.i64(), trace=_r_opt_json(r))
    if type_byte == JOIN:
        return REQUEST_TYPES[JOIN].from_dict(_r_json(r))
    raise ValueError(f"unknown rpc type {type_byte}")


def encode_response(type_byte: int, resp) -> bytes:
    out: List[bytes] = []
    if type_byte == SYNC:
        _w_i64(out, resp.from_id)
        _w_events(out, resp.events)
        _w_known(out, resp.known)
    elif type_byte == EAGER_SYNC:
        _w_i64(out, resp.from_id)
        out.append(b"\x01" if resp.success else b"\x00")
    else:
        # FastForwardResponse / JoinResponse: canonical JSON blob
        _w_json(out, resp.to_dict())
    return b"".join(out)


def decode_response(type_byte: int, payload: bytes):
    r = _Reader(payload)
    if type_byte == SYNC:
        return SyncResponse(
            from_id=r.i64(), events=_r_events(r), known=_r_known(r)
        )
    if type_byte == EAGER_SYNC:
        return EagerSyncResponse(from_id=r.i64(), success=r.u8() != 0)
    return RESPONSE_TYPES[type_byte].from_dict(_r_json(r))


# -- frame layer ----------------------------------------------------------


def pack_frame(kind: int, flags: int, req_id: int, payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME:
        raise ValueError(f"frame of {len(payload)} bytes exceeds limit")
    return FRAME_HEADER.pack(kind, flags, req_id, len(payload)) + payload


def unpack_header(buf) -> Tuple[int, int, int, int]:
    """(kind, flags, req_id, length); caller slices the payload."""
    kind, flags, req_id, length = FRAME_HEADER.unpack_from(buf, 0)
    if length > MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds limit")
    return kind, flags, req_id, length
