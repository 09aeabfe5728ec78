"""Incremental, device-resident voting windows.

The PyTorch counterpart of the JAX package's ``babble_tpu/ops/window_state.py``
(all of it but the mesh path). ``ops.voting.build_voting_window`` rebuilds
the dense window from scratch on every flush — one store fetch per row,
fresh arrays, a full upload — though consecutive sweeps share almost all
rows. :class:`WindowState` replaces that:

- **Host mirrors** of the 11 per-row window arrays live across sweeps, with
  row free-lists. Each snapshot is updated in O(ΔE): new undetermined
  events and new witnesses take rows (fed by the hashgraph's delta
  channels, ``Hashgraph.drain_accel_delta``), events a sweep received
  release theirs, and witness rows are repacked only when their
  ``first_descendants`` changed or their fame was applied.
- **Device residency**: the 11 per-row arrays stay on the device between
  sweeps, as persistent tensors. A sweep uploads a compact delta (row
  indexes and replacement rows, padded to a per-bucket size), scatters it
  into the buffers in place on the sweep's stream and runs the fused sweep
  at B = 1 (``_run_resident``, the JAX package's ``_resident_core``).
  Each buffer has one scratch row past the window: the delta's padding
  indexes point there (the JAX program drops them with ``mode="drop"``,
  which torch's ``index_copy_`` has not got), and the sweep reads only the
  window's rows, a contiguous prefix. No pad index is clamped onto a real
  row, so no real row is written twice.
- **Rebuild fallback**: whatever the delta protocol cannot express falls
  back to a from-scratch ``build_voting_window`` (with headroom added to
  the shape buckets): a repertoire change, an R/S/E/W bucket overflow, a
  round evicted from the store, a laggard event below the frozen window
  floor, or an oracle pass having mutated consensus state behind the
  window's back (``mark_dirty``). The rebuild is the correctness oracle:
  tests/test_torch_window_state.py asserts the mirrors equal a fresh
  rebuild after every step.

Ownership of the resident buffers: ``WindowState.device`` holds the only
reference to them. ``dispatch`` takes them, scatters and sweeps, and puts
them back; a failure marks the state dirty and re-raises, so a buffer that
may be half-written is never swept again. Results are applied only while
``Snapshot.generation == WindowState.generation``: a readback that lands
after a later mutation is discarded, never applied through moved row maps.

The window floor (``base``) is frozen between rebuilds: rows of rounds that
decide under a frozen floor stay in the window as settled voters (settled
fame is never refilled, determined events have ``undet`` False) until the R
bucket overflows and a rebuild re-bases. Per-row rounds stay immutable,
which is what makes the delta protocol O(ΔE).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from babble_tpu_torch.common.errors import StoreError
from babble_tpu_torch.ops import voting
from babble_tpu_torch.ops.voting import (
    INT32_MAX,
    VotingWindow,
    _bucket_pow2,
)


class StaleWindowError(RuntimeError):
    """A window snapshot's WindowState mutated before its results could be
    used; the owner must discard them (and let the oracle carry the
    flush)."""


# The per-row ("resident") window fields, in VotingWindow attribute order.
RESIDENT_FIELDS = (
    "creator", "index", "rounds", "undet", "wit_idx",
    "la_w", "fd_w", "rounds_w", "valid_w", "fame0_w", "mid_w",
)
# The per-sweep ("fresh") fields — tiny [R]/[S,P] arrays recomputed from
# the store every snapshot and uploaded whole (peer-set membership masks
# are cached by peer-set hash, so a mask is built only when membership
# changes).
FRESH_FIELDS = (
    "member", "sm_s", "psi", "sm_r", "exists_r", "prior_dec_r", "lb_gate_r",
)
# The neutral fill of each resident field: what padding rows, the delta's
# padding rows and the buffers' scratch rows hold.
PAD_FILL = {f: voting._FIELD_LAYOUT[f][1] for f in RESIDENT_FIELDS}


def delta_shape(key: tuple) -> Tuple[int, int]:
    """(DE, DW) delta-row buckets for a window bucket, sized for a gossip
    round's worth of churn; a bigger delta takes the full-upload path."""
    W, E, _P, _S, _R = key
    return max(32, E // 8), max(8, W // 8)


def seed_buffers(win: VotingWindow, device: torch.device) -> tuple:
    """The 11 resident buffers for ``win`` on ``device``: each field's rows
    plus one scratch row of its neutral fill, built on the host and copied
    to the device (always a copy, on the CPU too, so that the buffers never
    share memory with the host mirrors)."""
    bufs = []
    for f in RESIDENT_FIELDS:
        rows = getattr(win, f)
        pad = torch.full((1, *rows.shape[1:]), PAD_FILL[f], dtype=rows.dtype)
        bufs.append(torch.cat([rows, pad]).to(device))
    return tuple(bufs)


def _resident_program(bufs: List[torch.Tensor], delta: List[torch.Tensor],
                      fresh: List[torch.Tensor], device: torch.device,
                      scatter: bool) -> torch.Tensor:
    """The resident sweep, one scripted program: with ``scatter``, upload
    the 13 delta arrays and scatter their rows into the 11 resident
    buffers (RESIDENT_FIELDS order) in place; then upload the 7 fresh
    arrays and run the fused sweep at B = 1 over the buffers' window rows
    (every row but the scratch row: a contiguous prefix). The buffers have
    E + 1 and W + 1 rows; the delta's padding rows carry index E or W, the
    scratch row, which the sweep never reads (the JAX program drops them
    instead, window_state.py:107-144). Returns the [W + E] output
    ``[fame | rr]``."""
    if scatter:
        d = [x.to(device) for x in delta]
        e = d[0].long()
        for k in range(4):  # creator, index, rounds, undet
            bufs[k].index_copy_(0, e, d[1 + k])
        w = d[5].long()
        for k in range(7):  # wit_idx, la_w, fd_w, rounds_w, ... mid_w
            bufs[4 + k].index_copy_(0, w, d[6 + k])
    E = bufs[0].shape[0] - 1
    W = bufs[4].shape[0] - 1
    # in voting.WIN_FIELDS order
    fields = [bufs[0][:E], bufs[1][:E], bufs[5][:W], bufs[6][:W],
              bufs[7][:W], bufs[8][:W], bufs[9][:W], bufs[10][:W],
              bufs[4][:W], fresh[0], fresh[1], fresh[2], fresh[3],
              bufs[2][:E], bufs[3][:E], fresh[4], fresh[5], fresh[6]]
    return voting._launch_core(fields, device, True)


def _run_resident(bufs, delta, fresh, scatter: bool) -> torch.Tensor:
    device = bufs[0].device
    return voting.run_scripted(_resident_program, device,
                               bufs[4].shape[0] - 1, list(bufs), list(delta),
                               list(fresh), device, scatter)


def sweep_buffers(bufs, fresh) -> torch.Tensor:
    """The fused sweep over the window rows of the 11 resident buffers and
    the 7 fresh arrays (uploaded to the buffers' device), both in their
    field order. Returns the [W + E] output ``[fame | rr]``."""
    return _run_resident(bufs, (), fresh, False)


def script_programs() -> None:
    """Compile the resident sweep's program (see ``voting.scripted``)."""
    voting.scripted(_resident_program)


@dataclass
class Snapshot:
    """One sweep's view of the WindowState: the mirror-backed VotingWindow,
    the state generation it was taken at, and the packed delta (None: the
    dispatch must upload the whole window and reseed residency)."""

    win: VotingWindow
    generation: int
    delta: Optional[tuple]
    rebuilt: bool
    rows_delta: int
    rows_reused: int


class _Rebuild(Exception):
    """Internal: the delta protocol cannot express this mutation."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class _NotReady(Exception):
    """Internal: an undetermined event has no round yet (divide_rounds has
    not run) — the condition build_voting_window returns None for."""


class WindowState:
    """Persistent incremental window for ONE hashgraph (owned by its
    TensorConsensus). All methods run on the consensus thread."""

    def __init__(self) -> None:
        self.generation = 0  # bumped on every mirror mutation or rebuild
        self.dirty = True  # force a rebuild on the next snapshot
        self.dirty_reason = "initial"
        self.rebuilds = 0
        self.mirror: Optional[Dict[str, np.ndarray]] = None
        self.row: Dict[str, int] = {}
        self.wit_row: Dict[str, int] = {}
        self.undet_set: Set[str] = set()
        self.free_e: List[int] = []
        self.free_w: List[int] = []
        self.base = 0
        self.key: Optional[tuple] = None  # (W, E, P, S, R)
        self.pub_keys: tuple = ()
        self.peer_col: Dict[str, int] = {}
        self.exists_prev: Optional[np.ndarray] = None
        # The ONLY live reference to the resident device buffers: dispatch
        # takes it and puts it back only when the sweep was enqueued.
        self.device: Optional[tuple] = None
        # membership-mask cache keyed by peer-set hash: masks are rebuilt
        # only when membership changes
        self._mask_cache: Dict[bytes, Tuple[np.ndarray, int]] = {}
        # feedback from the owning TensorConsensus's apply step
        self._pending_fame: List[Tuple[str, int]] = []
        self._pending_received: List[str] = []

    # -- lifecycle -----------------------------------------------------------

    def mark_dirty(self, reason: str = "oracle") -> None:
        """Something mutated consensus state behind the window's back (an
        oracle pass, a reset, a failed sweep): drop residency and rebuild
        at the next snapshot. Bumping the generation is what makes sweeps
        in flight from the old state detectably stale."""
        self.dirty = True
        self.dirty_reason = reason
        self.device = None
        self.generation += 1
        self._pending_fame = []
        self._pending_received = []

    def drop_residency(self) -> None:
        """A snapshot's delta was committed to the mirrors but no dispatch
        carried it to the device (admission lost, batcher backlogged): the
        resident buffers now trail the mirrors. Keep the mirrors — the
        delta protocol is still exact — but make the next dispatched sweep
        reseed residency with a full upload."""
        self.device = None

    def note_applied(self, fame_pairs: List[Tuple[str, int]],
                     received: List[str]) -> None:
        """Record what apply_fame/apply_round_received just wrote to the
        store, so that the next delta scan updates the mirrors to match."""
        self._pending_fame.extend(fame_pairs)
        self._pending_received.extend(received)

    # -- snapshot ------------------------------------------------------------

    def snapshot(self, hg, timers: Dict[str, float],
                 copy_rows: bool = False) -> Optional[Snapshot]:
        """Bring the mirrors up to date with the hashgraph (an O(ΔE) delta,
        or a from-scratch rebuild when a trigger fires) and return this
        sweep's Snapshot; None when there is nothing to decide. Raises
        StoreError on an eviction mid-scan (the caller falls back to the
        oracle; the state is marked dirty so that the next snapshot
        rebuilds). ``timers`` gains the ``build``, ``delta_scan`` and
        ``pack`` seconds spent."""
        try:
            if self.dirty or self.mirror is None:
                return self._rebuild(hg, timers, copy_rows,
                                     self.dirty_reason)
            try:
                return self._delta_snapshot(hg, timers, copy_rows)
            except _Rebuild as why:
                return self._rebuild(hg, timers, copy_rows, why.reason)
            except _NotReady:
                # an undetermined event has no round yet — no sweep this
                # flush. The scan may already have consumed channels and
                # feedback, so resync with a rebuild next time.
                self.mark_dirty("round-pending")
                return None
        except BaseException:
            # A half-applied delta scan (a store eviction mid-fetch) leaves
            # the mirrors inconsistent: discard them.
            self.mark_dirty("snapshot-error")
            raise

    def _rebuild(self, hg, timers, copy_rows: bool,
                 reason: str) -> Optional[Snapshot]:
        t0 = time.perf_counter()
        # stale channels and feedback describe the pre-rebuild world
        hg.drain_accel_delta()
        self._pending_fame = []
        self._pending_received = []
        win = voting.build_voting_window(hg)
        if win is None:
            # nothing to decide; stay dirty so that the next snapshot
            # rebuilds
            self.mark_dirty("empty")
            timers["build"] = timers.get("build", 0.0) + (
                time.perf_counter() - t0
            )
            return None
        # Headroom: grow an axis past the builder's bucket only when the
        # real count is already within ``slack`` of the boundary (a rebuild
        # would otherwise fire again within a sweep or two); elsewhere keep
        # the builder's exact buckets, since every bucket step inflates W
        # quadratically. R's slack covers the frozen floor: the round span
        # grows by one per new round until a rebuild re-bases.
        W0, E0, P0, S0, R0 = voting.bucket_key(win)

        def head(n_real: int, bucket: int, minimum: int, slack: int) -> int:
            if n_real + slack <= bucket:
                return bucket
            return _bucket_pow2(n_real + slack, minimum)

        E_real = len(win.hashes)
        W_real = len(win.wit_hashes)
        R_real = hg.store.last_round() - win.base + 2
        key = (
            head(W_real, W0, 16, max(2, W_real // 16)),
            head(E_real, E0, 32, max(8, E_real // 16)),
            P0,
            S0,
            head(R_real, R0, 8, 2),
        )
        win = voting.repad_window(win, key)
        self.mirror = {f: getattr(win, f).numpy() for f in RESIDENT_FIELDS}
        self.row = dict(win.row)
        self.wit_row = dict(win.wit_row)
        self.undet_set = set(hg.undetermined_events)
        W, E = key[0], key[1]
        self.free_e = list(range(E - 1, E_real - 1, -1))
        self.free_w = list(range(W - 1, W_real - 1, -1))
        self.base = win.base
        self.key = key
        rep = hg.store.repertoire_by_pub_key()
        self.pub_keys = tuple(sorted(rep.keys()))
        self.peer_col = {pk: i for i, pk in enumerate(self.pub_keys)}
        self.exists_prev = win.exists_r.numpy()
        self.device = None  # reseeded by the next full dispatch
        self._mask_cache.clear()
        self.generation += 1
        self.rebuilds += 1
        self.dirty = False
        timers["build"] = timers.get("build", 0.0) + (time.perf_counter() - t0)
        rows = len(self.row) + len(self.wit_row)
        fresh = {f: getattr(win, f).numpy() for f in FRESH_FIELDS}
        return Snapshot(
            win=self._window(fresh, copy_rows),
            generation=self.generation,
            delta=None,
            rebuilt=True,
            rows_delta=rows,
            rows_reused=0,
        )

    def _delta_snapshot(self, hg, timers, copy_rows: bool) -> Optional[Snapshot]:
        t0 = time.perf_counter()
        store = hg.store
        m = self.mirror
        W, E, P, S, R = self.key

        rep = store.repertoire_by_pub_key()
        if len(rep) != len(self.pub_keys) or tuple(sorted(rep)) != self.pub_keys:
            raise _Rebuild("repertoire-change")
        last_round = store.last_round()
        if last_round - self.base + 2 > R:
            raise _Rebuild("round-bucket-overflow")

        new_wits, fd_dirty = hg.drain_accel_delta()
        fame_pairs, self._pending_fame = self._pending_fame, []
        received, self._pending_received = self._pending_received, []

        # New undetermined events are a strict suffix of the list: inserts
        # append, and the only removals since the last snapshot were our
        # own apply (recorded in ``received``) — any other mutation path
        # marks the state dirty and never reaches this scan.
        undet = hg.undetermined_events
        new_undet: List[str] = []
        for h in reversed(undet):
            if h in self.undet_set:
                break
            new_undet.append(h)
        new_undet.reverse()

        e_upd: Dict[int, tuple] = {}  # row -> (creator, index, round, undet)
        w_upd: Dict[int, dict] = {}  # w-row -> field dict

        # 1. events our apply received: witnesses keep their row with the
        #    undet flag cleared; plain events release their row.
        for h in received:
            i = self.row.get(h)
            if i is None:
                continue
            self.undet_set.discard(h)
            if h in self.wit_row:
                e_upd[i] = (
                    int(m["creator"][i]), int(m["index"][i]),
                    int(m["rounds"][i]), False,
                )
            else:
                e_upd[i] = (0, -1, -10, False)
                del self.row[h]
                self.free_e.append(i)

        # 2. fresh undetermined events take rows.
        ev_cache: Dict[str, object] = {}
        for h in new_undet:
            ev = store.get_event(h)
            ev_cache[h] = ev
            if ev.round is None:
                raise _NotReady()
            if ev.round < self.base:
                raise _Rebuild("round-below-floor")
            i = self.row.get(h)
            if i is None:
                if not self.free_e:
                    raise _Rebuild("event-bucket-overflow")
                i = self.free_e.pop()
                self.row[h] = i
            self.undet_set.add(h)
            e_upd[i] = (
                self.peer_col[ev.creator()], ev.index(),
                ev.round - self.base, True,
            )

        # 3. new witnesses take W rows (packed from the store).
        for r, h in new_wits:
            if h in self.wit_row:
                continue
            if r < self.base:
                raise _Rebuild("witness-below-floor")
            ev = ev_cache.get(h)
            if ev is None:
                ev = store.get_event(h)
                ev_cache[h] = ev
            i = self.row.get(h)
            if i is None:
                if not self.free_e:
                    raise _Rebuild("event-bucket-overflow")
                i = self.free_e.pop()
                self.row[h] = i
                e_upd[i] = (
                    self.peer_col[ev.creator()], ev.index(),
                    r - self.base, h in self.undet_set,
                )
            if not self.free_w:
                raise _Rebuild("witness-bucket-overflow")
            w = self.free_w.pop()
            self.wit_row[h] = w
            w_upd[w] = self._pack_witness(ev, i, r - self.base, fame0=0)

        # 4. witnesses whose first_descendants changed since the last
        #    snapshot (the one per-row field inserts mutate later) repack.
        for h in fd_dirty:
            w = self.wit_row.get(h)
            if w is None or w in w_upd:
                continue
            ev = ev_cache.get(h)
            if ev is None:
                ev = store.get_event(h)
            w_upd[w] = self._pack_witness(
                ev, int(m["wit_idx"][w]), int(m["rounds_w"][w]),
                fame0=int(m["fame0_w"][w]),
            )

        # 5. fame our apply wrote settles witness rows in place.
        for h, f in fame_pairs:
            w = self.wit_row.get(h)
            if w is None:
                continue
            if w in w_upd:
                w_upd[w]["fame0_w"] = f
            else:
                w_upd[w] = {
                    "wit_idx": int(m["wit_idx"][w]),
                    "la_w": np.array(m["la_w"][w]),
                    "fd_w": np.array(m["fd_w"][w]),
                    "rounds_w": int(m["rounds_w"][w]),
                    "valid_w": bool(m["valid_w"][w]),
                    "fame0_w": f,
                    "mid_w": bool(m["mid_w"][w]),
                }

        if len(self.undet_set) != len(undet):
            raise _Rebuild("undetermined-bookkeeping-divergence")

        # apply to the mirrors
        for i, (c, idx, rr_, ud) in e_upd.items():
            m["creator"][i] = c
            m["index"][i] = idx
            m["rounds"][i] = rr_
            m["undet"][i] = ud
        for w, row in w_upd.items():
            m["wit_idx"][w] = row["wit_idx"]
            m["la_w"][w] = row["la_w"]
            m["fd_w"][w] = row["fd_w"]
            m["rounds_w"][w] = row["rounds_w"]
            m["valid_w"][w] = row["valid_w"]
            m["fame0_w"][w] = row["fame0_w"]
            m["mid_w"][w] = row["mid_w"]
        if e_upd or w_upd:
            self.generation += 1
        timers["delta_scan"] = timers.get("delta_scan", 0.0) + (
            time.perf_counter() - t0
        )

        if not self.undet_set and not (
            hg.pending_rounds.get_ordered_pending_rounds()
        ):
            # Nothing left to decide, so no dispatch carries this delta to
            # the device: the resident buffers now trail the mirrors, and
            # the next dispatched sweep uploads the whole window.
            if e_upd or w_upd:
                self.device = None
            return None

        t1 = time.perf_counter()
        fresh = self._round_block(hg)  # may raise _Rebuild (eviction, S)
        DE, DW = delta_shape(self.key)
        delta = None
        if (
            not copy_rows  # batcher snapshots never dispatch a delta
            and len(e_upd) <= DE
            and len(w_upd) <= DW
        ):
            delta = self._pack_delta(e_upd, w_upd, DE, DW)
        win = self._window(fresh, copy_rows)
        timers["pack"] = timers.get("pack", 0.0) + (time.perf_counter() - t1)
        rows_delta = len(e_upd) + len(w_upd)
        return Snapshot(
            win=win,
            generation=self.generation,
            delta=delta,
            rebuilt=False,
            rows_delta=rows_delta,
            rows_reused=max(
                0, len(self.row) + len(self.wit_row) - rows_delta
            ),
        )

    def _pack_witness(self, ev, e_row: int, round_rebased: int,
                      fame0: int) -> dict:
        from babble_tpu_torch.hashgraph.hashgraph import middle_bit

        P = self.key[2]
        la = np.full(P, -1, np.int32)
        fd = np.full(P, INT32_MAX, np.int32)
        for pk, coords in ev.last_ancestors.items():
            c = self.peer_col.get(pk)
            if c is not None:
                la[c] = coords.index
        for pk, coords in ev.first_descendants.items():
            c = self.peer_col.get(pk)
            if c is not None:
                fd[c] = coords.index
        return {
            "wit_idx": e_row,
            "la_w": la,
            "fd_w": fd,
            "rounds_w": round_rebased,
            "valid_w": True,
            "fame0_w": fame0,
            "mid_w": middle_bit(ev.hex()),
        }

    def _pack_delta(self, e_upd: Dict[int, tuple], w_upd: Dict[int, dict],
                    DE: int, DW: int) -> tuple:
        """The delta as 13 numpy arrays in the JAX ``_resident_core``'s order;
        padding rows carry index E or W (the buffers' scratch rows) and the
        neutral fills."""
        W, E, P, _S, _R = self.key
        e_idx = np.full(DE, E, np.int32)
        e_creator = np.zeros(DE, np.int32)
        e_index = np.full(DE, -1, np.int32)
        e_rounds = np.full(DE, -10, np.int32)
        e_undet = np.zeros(DE, bool)
        for k, (i, (c, idx, rr_, ud)) in enumerate(e_upd.items()):
            e_idx[k] = i
            e_creator[k] = c
            e_index[k] = idx
            e_rounds[k] = rr_
            e_undet[k] = ud
        w_idx = np.full(DW, W, np.int32)
        w_wit_idx = np.zeros(DW, np.int32)
        w_la = np.full((DW, P), -1, np.int32)
        w_fd = np.full((DW, P), INT32_MAX, np.int32)
        w_rounds = np.full(DW, -10, np.int32)
        w_valid = np.zeros(DW, bool)
        w_fame0 = np.zeros(DW, np.int32)
        w_mid = np.zeros(DW, bool)
        for k, (w, row) in enumerate(w_upd.items()):
            w_idx[k] = w
            w_wit_idx[k] = row["wit_idx"]
            w_la[k] = row["la_w"]
            w_fd[k] = row["fd_w"]
            w_rounds[k] = row["rounds_w"]
            w_valid[k] = row["valid_w"]
            w_fame0[k] = row["fame0_w"]
            w_mid[k] = row["mid_w"]
        return (e_idx, e_creator, e_index, e_rounds, e_undet,
                w_idx, w_wit_idx, w_la, w_fd, w_rounds, w_valid,
                w_fame0, w_mid)

    # -- per-sweep round/peer-set block --------------------------------------

    def _round_block(self, hg) -> dict:
        """The [R]/[S,P] fresh arrays, recomputed from the store each sweep
        (they are tiny, and prior_dec_r/exists_r change per sweep). Raises
        _Rebuild when a round readable at the last snapshot was evicted or
        the distinct peer-sets outgrow the S bucket."""
        store = hg.store
        W, E, P, S, R = self.key
        slot_of: Dict[bytes, int] = {}
        members: List[np.ndarray] = []
        sms: List[int] = []
        psi = np.zeros(R, np.int32)
        sm_r = np.full(R, 2**30, np.int32)
        exists_r = np.zeros(R, bool)
        prior_dec_r = np.zeros(R, bool)
        lb_gate_r = np.zeros(R, bool)
        lb = hg.round_lower_bound
        for r in range(R):
            a = self.base + r
            lb_gate_r[r] = lb is None or lb < a
            try:
                ri = store.get_round(a)
            except StoreError:
                if self.exists_prev is not None and self.exists_prev[r]:
                    raise _Rebuild("round-evicted")
            else:
                exists_r[r] = True
                prior_dec_r[r] = ri.decided
            ps = store.get_peer_set(a)
            key = ps.hash()
            s = slot_of.get(key)
            if s is None:
                s = len(members)
                if s >= S:
                    raise _Rebuild("peer-set-slot-overflow")
                slot_of[key] = s
                cached = self._mask_cache.get(key)
                if cached is None:
                    mask = np.zeros(P, bool)
                    for pk in ps.pub_keys():
                        c = self.peer_col.get(pk)
                        if c is not None:
                            mask[c] = True
                    cached = (mask, ps.super_majority())
                    self._mask_cache[key] = cached
                members.append(cached[0])
                sms.append(cached[1])
            psi[r] = s
            sm_r[r] = sms[s]
        member = np.zeros((S, P), bool)
        sm_s = np.full(S, 2**30, np.int32)
        for s, mk in enumerate(members):
            member[s] = mk
            sm_s[s] = sms[s]
        self.exists_prev = exists_r
        return {
            "member": member, "sm_s": sm_s, "psi": psi, "sm_r": sm_r,
            "exists_r": exists_r, "prior_dec_r": prior_dec_r,
            "lb_gate_r": lb_gate_r,
        }

    def _window(self, fresh: dict, copy_rows: bool) -> VotingWindow:
        """A VotingWindow over the mirrors plus this sweep's fresh [R]/[S,P]
        arrays, as CPU tensors. ``copy_rows`` copies the per-row arrays
        (batcher submissions outlive the snapshot and must not see later
        in-place delta mutations); otherwise the tensors share the mirrors'
        memory and consumers rely on the generation check."""
        m = self.mirror
        rows = {
            f: torch.from_numpy(np.array(m[f]) if copy_rows else m[f])
            for f in RESIDENT_FIELDS
        }
        return VotingWindow(
            **rows,
            **{f: torch.from_numpy(a) for f, a in fresh.items()},
            base=self.base,
            hashes=list(self.row),
            row=self.row if not copy_rows else dict(self.row),
            wit_hashes=list(self.wit_row),
            wit_row=self.wit_row if not copy_rows else dict(self.wit_row),
            generation=self.generation,
            state=self,
        )

    # -- dispatch ------------------------------------------------------------

    def dispatch(self, snap: Snapshot, device: torch.device):
        """Enqueue the sweep for a snapshot on the current stream, keeping
        the window resident on ``device``. Delta path (a delta and live
        residency): upload the delta, scatter it into the buffers in place
        and sweep. Full path: upload the whole window into fresh buffers,
        which seed residency for the next sweep. Returns (the unread
        [fame | rr] output, whether the delta path ran)."""
        win = snap.win
        bufs, self.device = self.device, None  # the only reference
        used_delta = snap.delta is not None and bufs is not None
        try:
            fresh = [getattr(win, f) for f in FRESH_FIELDS]
            if used_delta:
                out = _run_resident(
                    bufs, [torch.from_numpy(a) for a in snap.delta], fresh,
                    True)
            else:
                bufs = seed_buffers(win, device)
                out = sweep_buffers(bufs, fresh)
        except BaseException:
            self.mark_dirty("dispatch-error")
            raise
        self.device = bufs
        return out, used_delta

