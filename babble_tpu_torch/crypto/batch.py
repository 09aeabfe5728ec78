"""Host-side batch signature prevalidation via the native C++ library.

The gossip sync path hands every decoded chunk of incoming events here;
one foreign call verifies all creator + internal-transaction signatures
and caches verdicts on the events, making the per-event ``Event.verify()``
in the insert path a cache hit. With ``BABBLE_DEVICE_VERIFY=1`` on a card
the node verifies on the device instead (``babble_tpu_torch.ops.verify``,
kernel K3).

Reference hot loop being replaced: per-event secp256k1 verification at
insert (src/hashgraph/hashgraph.go:672-687 -> src/crypto/keys/signature.go:20).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from babble_tpu_torch import native_crypto
from babble_tpu_torch.common.lru import LRU
from babble_tpu_torch.crypto import secp256k1 as ref
from babble_tpu_torch.crypto.canonical import CacheStats
from babble_tpu_torch.crypto.keys import decode_signature

# ((x, y), msg_hash, r, s)
SigItem = Tuple[Tuple[int, int], bytes, int, int]
# (event, first_item_index, item_count, statically_ok)
SigSpan = Tuple[object, int, int, bool]

# Process-wide verdict cache: a signature's validity is a pure function
# of (pubkey, msg_hash, r, s), so events that arrive again — pushed by a
# second peer, replayed by an adversary, re-decoded after a chaos retry
# — skip the native verify entirely. Per-Event verdict caching
# (Event._sig_ok) cannot catch these: every wire decode builds a fresh
# Event object. Bounded LRU; the lock covers concurrent gossip threads.
VERIFY_CACHE = CacheStats()
_VERDICTS = LRU(32768)
_VERDICTS_LOCK = threading.Lock()


def available() -> bool:
    return native_crypto.available()


def collect_signature_items(events) -> Tuple[List[SigItem], List[SigSpan]]:
    """Gather every verifiable signature of a list of Events: the creator
    signature plus one per internal transaction. Structurally invalid
    items (undecodable signature / malformed key) mark the whole event
    statically failed, same as the scalar verify path. Kept as one
    collector so that the device batch verifier (ops/verify.py) counts the
    same consensus-relevant signatures as the host one."""
    items: List[SigItem] = []
    spans: List[SigSpan] = []
    for ev in events:
        start = len(items)
        ok_static = True
        try:
            pub = ref.unmarshal_pubkey(ev.body.creator)
            r, s = decode_signature(ev.signature)
            items.append((pub, ev.hash(), r, s))
        except Exception:
            ok_static = False
        if ok_static:
            for itx in ev.body.internal_transactions:
                try:
                    ipub = ref.unmarshal_pubkey(
                        itx.body.peer.public_key().bytes()
                    )
                    ir, is_ = decode_signature(itx.signature)
                    items.append((ipub, itx.body.hash(), ir, is_))
                except Exception:
                    ok_static = False
                    break
        spans.append((ev, start, len(items) - start, ok_static))
    return items, spans


def prevalidate_events_host(events) -> bool:
    """Batch-verify signatures for a list of Events in one native call.

    Returns False (leaving events untouched, so the scalar path runs)
    when the native library is unavailable.
    """
    items, spans = collect_signature_items(events)
    verdicts: List[Optional[bool]] = []
    fresh: List[int] = []
    with _VERDICTS_LOCK:
        for it in items:
            v, ok = _VERDICTS.get(it)
            if ok:
                VERIFY_CACHE.hits += 1
                verdicts.append(v)
            else:
                VERIFY_CACHE.misses += 1
                verdicts.append(None)
                fresh.append(len(verdicts) - 1)
    if fresh:
        pubs = []
        msgs = []
        rss = []
        for i in fresh:
            (x, y), m, r, s = items[i]
            pubs.append(x.to_bytes(32, "big") + y.to_bytes(32, "big"))
            msgs.append(m)
            rss.append((r, s))
        results = native_crypto.verify_batch(pubs, msgs, rss)
        if results is None:
            return False
        with _VERDICTS_LOCK:
            for i, ok in zip(fresh, results):
                verdicts[i] = bool(ok)
                _VERDICTS.add(items[i], bool(ok))
    for ev, start, count, ok_static in spans:
        ok = ok_static and all(verdicts[start : start + count])
        ev.prevalidate(ok)
    return True
