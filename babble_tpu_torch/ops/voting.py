"""Live consensus offload: fame + round-received as one device sweep.

The PyTorch counterpart of the JAX package's ``babble_tpu/ops/voting.py``.
The division of labour with the host is the same:

- the host keeps the incremental per-insert bookkeeping — signature checks,
  fork prevention, coordinate maintenance, round and witness assignment
  (reference: src/hashgraph/hashgraph.go:672-750, 807-872);
- the device takes virtual voting (DecideFame, hashgraph.go:875-998) and
  round-received (DecideRoundReceived, hashgraph.go:1002-1095) over a dense
  snapshot of the undecided window.

Only witnesses vote and are voted on, so the vote state lives on a compact
witness axis W; the see-visibility mask is [W, E]. Peer-sets may change per
round: the peer axis spans the whole repertoire and each round carries a
peer-set slot (``psi``) selecting a membership mask and super-majority.

The whole sweep is one device program returning one int32 vector
``[fame | round_received]``, so a sweep costs one readback. It is written
once, on a leading batch axis of windows: a single sweep is the batch of
one, and the sweep batcher (``hashgraph/sweep_batcher.py``) stacks
co-located validators' windows where the JAX package vmaps the program.
PyTorch runs eagerly: each ``lax.fori_loop`` of the reference is a Python
loop over the bucketed round axis, and every per-round index is a tensor
view or a batch-indexed gather, so the loop never waits for the device.
The strongly-see counts go through the hand-written kernel K1
(``ops/kernels.member_ss_counts``), one launch per batch.

Shapes are padded to the reference's buckets (W, E, R and S to powers of
two, P to a multiple of 8). Padding rows are neutral and give exactly the
values the JAX package gives, so whole padded vectors compare bit for bit.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from babble_tpu_torch.common.errors import StoreError
from babble_tpu_torch.common.trilean import Trilean
from babble_tpu_torch.ops import kernels  # registers K1's operator

INT32_MAX = np.int32(2**31 - 1)

# Frequency of coin rounds (reference: hashgraph.go:24-25). Kept in sync with
# babble_tpu_torch.hashgraph.hashgraph.COIN_ROUND_FREQ.
COIN_ROUND_FREQ = 4


def _bucket_pow2(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _bucket_mult(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


@dataclass
class VotingWindow:
    """Dense window over the undecided suffix of the hashgraph.

    Two row spaces:
    - E rows: undetermined events + all witnesses of rounds >= the window
      floor (``hashes``/``row``). Carries creator/index/rounds/undet.
    - W rows: the witness subset (``wit_hashes``/``wit_row``), indexing into
      E rows via ``wit_idx``. Carries coordinates, fame state, coin bits.

    Array fields are torch tensors (on the CPU as built; ``launch_sweep``
    moves them to the sweep's device). Rounds are rebased by ``base``.
    """

    # E-space
    creator: torch.Tensor  # [E] int32 peer column of creator (0 for padding)
    index: torch.Tensor  # [E] int32 per-creator sequence (-1 padding)
    rounds: torch.Tensor  # [E] int32 rebased round (-10 padding)
    undet: torch.Tensor  # [E] bool — rows eligible for round-received
    # W-space (witnesses)
    wit_idx: torch.Tensor  # [W] int32 row in E-space (0 for padding)
    la_w: torch.Tensor  # [W, P] int32, -1 missing
    fd_w: torch.Tensor  # [W, P] int32, INT32_MAX missing
    rounds_w: torch.Tensor  # [W] int32 rebased (-10 padding)
    valid_w: torch.Tensor  # [W] bool
    fame0_w: torch.Tensor  # [W] int32 {-1, 0, 1} initial fame
    mid_w: torch.Tensor  # [W] bool coin bits
    # peer-sets per round
    member: torch.Tensor  # [S, P] bool membership masks
    sm_s: torch.Tensor  # [S] int32 super-majority per slot
    psi: torch.Tensor  # [R] int32 rebased-round -> peer-set slot
    sm_r: torch.Tensor  # [R] int32 rebased-round -> super-majority
    # round-scan state for the fused decided/hard-block computation
    exists_r: torch.Tensor  # [R] bool — round info readable from the store
    prior_dec_r: torch.Tensor  # [R] bool — pre-sweep sticky decided flags
    lb_gate_r: torch.Tensor  # [R] bool — round above the fast-sync bound
    base: int  # absolute round of rebased round 0
    hashes: List[str] = field(default_factory=list)  # real E rows
    row: Dict[str, int] = field(default_factory=dict)
    wit_hashes: List[str] = field(default_factory=list)  # real W rows
    wit_row: Dict[str, int] = field(default_factory=dict)
    # Resident-window provenance (ops/window_state.py): windows snapshotted
    # from a persistent WindowState carry the state's generation at
    # snapshot time and the state itself, so that the sweep batcher and
    # TensorConsensus can tell that the state mutated under them and
    # discard the results instead of applying them through moved row maps.
    generation: int = 0
    state: Optional[object] = None

    @property
    def n_events(self) -> int:
        return int(self.creator.shape[0])

    @property
    def n_witnesses(self) -> int:
        return int(self.wit_idx.shape[0])


# Each field's axes in a bucket (W, E, P, S, R) and its neutral fill: what
# padding rows hold (build_voting_window, repad_window, dummy_window).
_FIELD_LAYOUT = {
    "creator": ("E", 0), "index": ("E", -1), "rounds": ("E", -10),
    "undet": ("E", False), "wit_idx": ("W", 0), "la_w": ("WP", -1),
    "fd_w": ("WP", int(INT32_MAX)), "rounds_w": ("W", -10),
    "valid_w": ("W", False), "fame0_w": ("W", 0), "mid_w": ("W", False),
    "member": ("SP", False), "sm_s": ("S", 2**30), "psi": ("R", 0),
    "sm_r": ("R", 2**30), "exists_r": ("R", False),
    "prior_dec_r": ("R", False), "lb_gate_r": ("R", False),
}

def _filled(f: str, key: tuple, *batch: int) -> np.ndarray:
    """A numpy array of field ``f`` at bucket ``key`` (with a leading
    ``batch`` axis, if given) holding only the field's neutral fill."""
    W, E, P, S, R = key
    axes, fill = _FIELD_LAYOUT[f]
    shape = {"E": (E,), "W": (W,), "WP": (W, P), "S": (S,), "SP": (S, P),
             "R": (R,)}[axes]
    return np.full((*batch, *shape), fill,
                   dtype=bool if isinstance(fill, bool) else np.int32)


# VotingWindow attribute names in _sweep_core's positional order (rounds /
# undet are the E-space rounds_e / undet_e arguments).
WIN_FIELDS = (
    "creator", "index", "la_w", "fd_w", "rounds_w", "valid_w", "fame0_w",
    "mid_w", "wit_idx", "member", "sm_s", "psi", "sm_r", "rounds", "undet",
    "exists_r", "prior_dec_r", "lb_gate_r",
)


# =============================================================================
# Device side
# =============================================================================


def _fame_core(creator: torch.Tensor, index: torch.Tensor,
               la_w: torch.Tensor, fd_w: torch.Tensor,
               rounds_w: torch.Tensor, valid_w: torch.Tensor,
               fame0_w: torch.Tensor, mid_w: torch.Tensor,
               wit_idx: torch.Tensor, member: torch.Tensor,
               sm_s: torch.Tensor, psi: torch.Tensor,
               sm_r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Virtual voting on the witness axis (oracle: hashgraph.go:875-998)
    with per-round peer-sets, over a leading batch axis B of windows.
    Returns (see_we, fame_w); ``see_we`` ([B, W, E], witness w sees event
    x) feeds the round-received stage."""
    B, W = rounds_w.shape
    E = creator.shape[1]
    R = psi.shape[1]
    psi_l = psi.long()
    b_ax = torch.arange(B, device=psi.device)

    # SEE[w, x] = w sees x via lastAncestors (oracle: hashgraph.go:96-128).
    la_creator = torch.gather(la_w, 2, creator.long()[:, None, :].expand(
        B, W, E))
    see_we = (la_creator >= index[:, None, :]) & valid_w[:, :, None]
    # witness-to-witness visibility
    see_ww = torch.gather(see_we, 2, wit_idx.long()[:, None, :].expand(
        B, W, W))

    # SS[s, w, w'] per peer-set slot (oracle: hashgraph.go:172-206 with the
    # per-round peer-set argument), counted by K1 in one launch for the
    # whole batch.
    counts = torch.ops.babble_tpu_torch.member_ss_counts(la_w, fd_w, member)
    ss_all = counts >= sm_s[:, :, None, None]  # [B, S, W, W]

    votes = torch.zeros((B, W, W), dtype=torch.bool, device=rounds_w.device)
    fame = fame0_w
    # The reference clips j-1 and j into [0, R-1]; over j in [1, R) both
    # already lie there, so plain slices (views, no host sync) select them.
    for j in range(1, R):
        voter = valid_w & (rounds_w == j)  # [B, W(y)]
        diff = j - rounds_w  # [B, W(x)] per candidate

        # Derived vote: majority among strongly-seen witnesses of j-1,
        # evaluated against round j-1's peer-set (hashgraph.go:928-948).
        prev_w = valid_w & (rounds_w == (j - 1))
        ss_prev = ss_all[b_ax, psi_l[:, j - 1]] & prev_w[:, None, :]
        n_ss = ss_prev.sum(dim=2, dtype=torch.int32)
        # exact 0/1 tally: a float32 product of 0/1 matrices is exact below
        # 2^24 (ops/intdot.py; run_scripted turns TF32 off)
        yays = torch.matmul(ss_prev.to(torch.float32),
                            votes.to(torch.float32)).to(torch.int32)
        nays = n_ss[:, :, None] - yays
        v = yays >= nays
        t = torch.maximum(yays, nays)
        settled = t >= sm_r[:, j, None, None]  # round j's super-majority

        # floor modulo, as jnp's % on negative diff
        # COIN_ROUND_FREQ (TorchScript takes no global int)
        is_coin = torch.remainder(diff, 4) == 0
        derived = torch.where(is_coin[:, None, :] & ~settled,
                              mid_w[:, :, None], v)
        new_vote = torch.where((diff == 1)[:, None, :], see_ww, derived)

        active = (voter[:, :, None] & valid_w[:, None, :]
                  & (diff >= 1)[:, None, :])
        votes = torch.where(active, new_vote, votes)

        decide_pair = (active & ~is_coin[:, None, :] & (diff > 1)[:, None, :]
                       & settled)
        decided_now = decide_pair.any(dim=1)
        decided_val = (decide_pair & v).any(dim=1)
        newly = decided_now & (fame == 0)
        fame = fame.masked_fill(newly & decided_val, 1).masked_fill(
            newly & ~decided_val, -1
        )
    return see_we, fame


def _rr_core(see_we: torch.Tensor, rounds_w: torch.Tensor,
             valid_w: torch.Tensor, fame_w: torch.Tensor,
             rounds_e: torch.Tensor, undet_e: torch.Tensor,
             decided_r: torch.Tensor, hard_block_r: torch.Tensor,
             sm_r: torch.Tensor) -> torch.Tensor:
    """Round-received (oracle: hashgraph.go:1002-1095) over a leading batch
    axis. ``decided_r`` and ``hard_block_r`` carry the oracle's exact scan
    semantics: an event's ascending round scan stops at the first
    hard-blocking round after its own and receives only at decided
    rounds."""
    B, E = rounds_e.shape
    R = decided_r.shape[1]
    rr = torch.full((B, E), -1, dtype=torch.int32, device=rounds_e.device)
    blocked = torch.zeros((B, E), dtype=torch.bool, device=rounds_e.device)
    for i in range(1, R):
        fw = valid_w & (rounds_w == i) & (fame_w == 1)  # famous witnesses
        n_fw = fw.sum(dim=1, dtype=torch.int32)
        sees_x = see_we | (~fw)[:, :, None]
        all_see = sees_x.all(dim=1) & (n_fw >= sm_r[:, i])[:, None]
        relevant = rounds_e < i
        eligible = (
            decided_r[:, i, None] & ~blocked & relevant & (rr < 0) & all_see
            & undet_e
        )
        rr = rr.masked_fill(eligible, i)
        blocked = blocked | (relevant & hard_block_r[:, i, None])
    return rr


def _sweep_core(creator: torch.Tensor, index: torch.Tensor,
                la_w: torch.Tensor, fd_w: torch.Tensor,
                rounds_w: torch.Tensor, valid_w: torch.Tensor,
                fame0_w: torch.Tensor, mid_w: torch.Tensor,
                wit_idx: torch.Tensor, member: torch.Tensor,
                sm_s: torch.Tensor, psi: torch.Tensor, sm_r: torch.Tensor,
                rounds_e: torch.Tensor, undet_e: torch.Tensor,
                exists_r: torch.Tensor, prior_dec_r: torch.Tensor,
                lb_gate_r: torch.Tensor) -> torch.Tensor:
    """The fused sweep over a leading batch axis of windows: fame voting →
    per-round decidedness → round-received, one int32 output ``[B, W + E]``
    (``[fame | rr]`` per window). Windows never mix: row b of the output is
    window b's single sweep (the JAX package vmaps the same program,
    babble_tpu/ops/voting.py:319-323).

    Decidedness replicates ``RoundInfo.witnesses_decided`` (roundInfo.go:
    78-96): a round is decided when no witness is UNDEFINED and the decided
    count reaches the round's super-majority, or when the host's sticky
    pre-sweep flag was already set. Hard-blocking replicates the oracle's
    receive-scan stops (hashgraph.go:1019-1046)."""
    see_we, fame = _fame_core(
        creator, index, la_w, fd_w, rounds_w, valid_w, fame0_w, mid_w,
        wit_idx, member, sm_s, psi, sm_r,
    )
    R = psi.shape[1]
    r_ax = torch.arange(R, dtype=torch.int32, device=psi.device)
    # [B, R, W]: witness w is valid and of round r
    m_rw = valid_w[:, None, :] & (rounds_w[:, None, :] == r_ax[None, :, None])
    undecided_w = fame == 0
    has_undec = (m_rw & undecided_w[:, None, :]).any(dim=2)
    cnt = (m_rw & ~undecided_w[:, None, :]).sum(dim=2, dtype=torch.int32)
    decided_r = prior_dec_r | (exists_r & ~has_undec & (cnt >= sm_r))
    hard_block_r = ~exists_r | (~decided_r & lb_gate_r)
    rr = _rr_core(see_we, rounds_w, valid_w, fame, rounds_e, undet_e,
                  decided_r, hard_block_r, sm_r)
    return torch.cat([fame, rr], dim=1)


def _launch_core(fields: List[torch.Tensor], device: torch.device,
                 single: bool) -> torch.Tensor:
    """The 18 fields in WIN_FIELDS order uploaded to ``device`` (a no-op
    for tensors already there) and swept; ``single`` adds and drops the
    batch axis of one window."""
    t: List[torch.Tensor] = []
    for f in fields:
        x = f.to(device)
        t.append(x.unsqueeze(0) if single else x)
    out = _sweep_core(t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8],
                      t[9], t[10], t[11], t[12], t[13], t[14], t[15], t[16],
                      t[17])
    return out[0] if single else out


_scripts: dict = {}
_script_lock = threading.Lock()


def scripted(fn):
    """``fn`` compiled by TorchScript, once per process (some seconds of
    Python; TensorConsensus compiles the sweep's programs at construction,
    so that no flush waits for it). A scripted program runs its
    operations in C++ with the GIL released, where eager code hands the
    GIL back and retakes it around each one, and among co-located nodes'
    threads each retake waits (PERF.md §5)."""
    with _script_lock:
        if fn not in _scripts:
            with warnings.catch_warnings():
                # deprecated in favour of torch.compile, which would
                # generate kernels of its own; the port wants the
                # operations as written
                warnings.simplefilter("ignore", DeprecationWarning)
                _scripts[fn] = torch.jit.script(fn)
        return _scripts[fn]


def run_scripted(fn, device: torch.device, witnesses: int, *args):
    """Enqueue the scripted ``fn(*args)``, a program ending in the fused
    sweep over ``witnesses`` witness rows, on the current stream of
    ``device``. The executor's optimizations are off, so the program runs
    the operations as written, K1 among them through its dispatcher
    operator."""
    program = scripted(fn)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if witnesses >= 1 << 24:
        raise ValueError("witness axis >= 2**24: the float32 tally is not "
                         "exact")
    with torch.jit.optimized_execution(False):
        return program(*args)


def script_programs() -> None:
    """Compile the sweep's program (see ``scripted``)."""
    scripted(_launch_core)


def _sweep(fields: List[torch.Tensor], device: torch.device,
           single: bool) -> torch.Tensor:
    """The scripted upload and fused sweep (``_launch_core``)."""
    return run_scripted(_launch_core, device, fields[2].shape[-2], fields,
                        device, single)


def launch_sweep(win: VotingWindow, device: torch.device) -> torch.Tensor:
    """Upload the window to ``device`` and enqueue the fused sweep on the
    current stream: the batched program at B = 1. Returns the [W + E]
    int32 output without reading it."""
    return _sweep([getattr(win, f) for f in WIN_FIELDS], device, True)


def launch_batched(wins: List[VotingWindow], device: torch.device,
                   key: Optional[tuple] = None) -> torch.Tensor:
    """Stack windows on a leading batch axis, each padded to the bucket
    ``key`` (default: the first window's) with ``repad_window``'s neutral
    fills, upload them to ``device`` and enqueue ONE fused sweep over all
    of them (one K1 launch) on the current stream. Returns the
    [B, W + E] output of ``key``'s W and E without reading it.

    The padded stack is assembled in numpy, field by field: a repad and a
    stack through torch would cost two calls per field and window, each of
    which hands the GIL back and waits to retake it.

    Only the real windows are stacked: the JAX package pads every batch to
    a fixed B with all-invalid dummies so that one compiled program serves
    every wave; eager PyTorch compiles nothing, so padding would be work for
    nothing."""
    key = key if key is not None else bucket_key(wins[0])
    stacked = []
    for f in WIN_FIELDS:
        a = _filled(f, key, len(wins))
        for b, w in enumerate(wins):
            src = getattr(w, f).numpy()
            a[(b, *(slice(0, n) for n in src.shape))] = src
        stacked.append(torch.from_numpy(a))
    return _sweep(stacked, device, False)


def read_batched(out, wins: List[VotingWindow], key: Optional[tuple] = None):
    """One readback of a [B, W + E] batched output (a tensor, or its host
    copy), split into per-window (fame, rr) numpy arrays over each window's
    own rows; ``key`` is the bucket the batch was padded to (default: each
    window's own)."""
    host = out.cpu().numpy() if isinstance(out, torch.Tensor) else out
    res = []
    for i, w in enumerate(wins):
        W = key[0] if key is not None else w.n_witnesses
        res.append((host[i, :w.n_witnesses], host[i, W:W + w.n_events]))
    return res


def read_sweep(out, win: VotingWindow):
    """Split one readback of ``[fame | round_received]`` (a tensor, or its
    host copy) into (fame[W], rr[E]) numpy arrays."""
    host = out.cpu().numpy() if isinstance(out, torch.Tensor) else out
    W = win.n_witnesses
    return host[:W], host[W:W + win.n_events]


def run_sweep(win: VotingWindow, device: torch.device):
    """Synchronous fused sweep: launch + one readback."""
    return read_sweep(launch_sweep(win, device), win)


def dummy_window(W: int, E: int, P: int, S: int, R: int) -> VotingWindow:
    """An all-invalid window of a given shape bucket: in a batch it sweeps
    to neutral outputs and leaves every other window's unchanged."""
    return VotingWindow(
        **{f: torch.from_numpy(_filled(f, (W, E, P, S, R)))
           for f in WIN_FIELDS},
        base=0,
    )


# =============================================================================
# Host side: window construction and result application
# =============================================================================


def _fame_init(trilean: Trilean) -> int:
    if trilean == Trilean.TRUE:
        return 1
    if trilean == Trilean.FALSE:
        return -1
    return 0


def build_voting_window(hg) -> Optional[VotingWindow]:
    """Snapshot the undecided suffix of a Hashgraph into dense CPU tensors.

    Returns None when there is nothing to decide. Raises StoreError when a
    needed event/round has been evicted — the caller falls back to the
    oracle sweep in that case.

    Window floor = min(first pending round, min round over undetermined
    events): pending rounds can trail the undetermined set when all their
    events were received before fame was decided, and vice versa, so both
    bound the rows the vote and receive scans touch.
    """
    store = hg.store
    undetermined = list(hg.undetermined_events)
    pending = [pr.index for pr in hg.pending_rounds.get_ordered_pending_rounds()]
    if not undetermined and not pending:
        return None

    floors = list(pending)
    undet_rounds: Dict[str, int] = {}
    # Events fetched for the floor computation are reused by the row-fill
    # loop below.
    ev_cache: Dict[str, object] = {}
    for h in undetermined:
        ev = store.get_event(h)
        if ev.round is None:
            return None  # divide_rounds has not run yet
        ev_cache[h] = ev
        undet_rounds[h] = ev.round
        floors.append(ev.round)
    base = min(floors)
    last_round = store.last_round()

    # Peer columns span the full repertoire so any peer-set's mask and any
    # event's coordinates map onto the same axis.
    rep = store.repertoire_by_pub_key()
    pub_keys = sorted(rep.keys())
    peer_col = {pk: i for i, pk in enumerate(pub_keys)}
    n_peers = len(pub_keys)

    # E rows: all undetermined events first (their list order is the
    # oracle's scan order), then every witness of rounds >= base from the
    # round infos. W rows: the witness subset.
    hashes: List[str] = list(undetermined)
    rows = {h: i for i, h in enumerate(hashes)}
    witness_info: Dict[str, tuple] = {}  # hash -> (round, famous)
    for r in range(base, last_round + 1):
        try:
            ri = store.get_round(r)
        except StoreError:
            continue
        for x, re_ in ri.created_events.items():
            if re_.witness:
                witness_info[x] = (r, re_.famous)
                if x not in rows:
                    rows[x] = len(hashes)
                    hashes.append(x)
    wit_hashes = list(witness_info.keys())
    wit_rows = {h: i for i, h in enumerate(wit_hashes)}

    E_real = len(hashes)
    W_real = len(wit_hashes)
    E = _bucket_pow2(E_real, 32)
    W = _bucket_pow2(W_real, 16)
    P = _bucket_mult(n_peers, 8)
    R_real = last_round - base + 2
    R = _bucket_pow2(R_real, 8)

    creator = np.zeros(E, np.int32)
    index = np.full(E, -1, np.int32)
    rounds = np.full(E, -10, np.int32)
    undet_mask = np.zeros(E, bool)
    wit_idx = np.zeros(W, np.int32)
    la_w = np.full((W, P), -1, np.int32)
    fd_w = np.full((W, P), INT32_MAX, np.int32)
    rounds_w = np.full(W, -10, np.int32)
    valid_w = np.zeros(W, bool)
    fame0_w = np.zeros(W, np.int32)
    mid_w = np.zeros(W, bool)

    from babble_tpu_torch.hashgraph.hashgraph import middle_bit

    for h, i in rows.items():
        ev = ev_cache.get(h)
        if ev is None:
            ev = store.get_event(h)
        creator[i] = peer_col[ev.creator()]
        index[i] = ev.index()
        if h in undet_rounds:
            r_abs = undet_rounds[h]
        else:
            r_abs = witness_info[h][0]
        rounds[i] = r_abs - base
        undet_mask[i] = h in undet_rounds
        w = wit_rows.get(h)
        if w is not None:
            wit_idx[w] = i
            rounds_w[w] = r_abs - base
            valid_w[w] = True
            fame0_w[w] = _fame_init(witness_info[h][1])
            mid_w[w] = middle_bit(h)
            for pk, coords in ev.last_ancestors.items():
                c = peer_col.get(pk)
                if c is not None:
                    la_w[w, c] = coords.index
            for pk, coords in ev.first_descendants.items():
                c = peer_col.get(pk)
                if c is not None:
                    fd_w[w, c] = coords.index

    # Per-round peer-sets: one slot per distinct set effective in the window
    # (interval semantics of PeerSetCache.get, caches.go:169-193). Rounds
    # past the last recorded change reuse the final set, which is exactly
    # what the interval lookup returns.
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
        a = base + r
        lb_gate_r[r] = lb is None or lb < a
        try:
            ri = store.get_round(a)
        except StoreError:
            pass  # exists_r stays False -> hard-blocks the receive scan
        else:
            exists_r[r] = True
            prior_dec_r[r] = ri.decided
        ps = store.get_peer_set(a)
        key = ps.hash()
        s = slot_of.get(key)
        if s is None:
            s = len(members)
            slot_of[key] = s
            m = np.zeros(P, bool)
            for pk in ps.pub_keys():
                c = peer_col.get(pk)
                if c is not None:
                    m[c] = True
            members.append(m)
            sms.append(ps.super_majority())
        psi[r] = s
        sm_r[r] = sms[s]

    S = _bucket_pow2(len(members), 1)
    member = np.zeros((S, P), bool)
    sm_s = np.full(S, 2**30, np.int32)
    for s, m in enumerate(members):
        member[s] = m
        sm_s[s] = sms[s]

    t = torch.from_numpy
    return VotingWindow(
        creator=t(creator),
        index=t(index),
        rounds=t(rounds),
        undet=t(undet_mask),
        wit_idx=t(wit_idx),
        la_w=t(la_w),
        fd_w=t(fd_w),
        rounds_w=t(rounds_w),
        valid_w=t(valid_w),
        fame0_w=t(fame0_w),
        mid_w=t(mid_w),
        member=t(member),
        sm_s=t(sm_s),
        psi=t(psi),
        sm_r=t(sm_r),
        exists_r=t(exists_r),
        prior_dec_r=t(prior_dec_r),
        lb_gate_r=t(lb_gate_r),
        base=base,
        hashes=hashes,
        row=rows,
        wit_hashes=wit_hashes,
        wit_row=wit_rows,
    )


def bucket_key(win: VotingWindow) -> tuple:
    return (
        win.n_witnesses,
        win.n_events,
        win.member.shape[1],
        win.member.shape[0],
        win.psi.shape[0],
    )


def repad_window(win: VotingWindow, key: tuple) -> VotingWindow:
    """Grow a window to a LARGER shape bucket with the same neutral fills
    build_voting_window pads with. Invalid W rows never vote and never
    count; sentinel E rows are seen by nobody and cannot receive; extra R
    rows have no voters and lie past every real round; extra S slots are
    unreferenced. Real rows keep their indexes, so the result maps back
    through the ORIGINAL window's row tables."""
    if bucket_key(win) == key:
        return win
    padded = {}
    for f in WIN_FIELDS:
        src = getattr(win, f).numpy()
        a = _filled(f, key)
        a[tuple(slice(0, n) for n in src.shape)] = src
        padded[f] = torch.from_numpy(a)
    return dataclasses.replace(win, **padded)


def apply_fame(hg, win: VotingWindow, fame: np.ndarray) -> tuple:
    """Write fame into the pending rounds' infos and mark decided rounds
    with the oracle's own sticky rule (mirrors the tail of
    Hashgraph.decide_fame, hashgraph.go:985-996). Returns
    (decided_rounds, applied): ``applied`` is the exact [(hash, ±1)] list
    of set_fame writes."""
    store = hg.store
    decided_rounds: List[int] = []
    applied: List[tuple] = []
    for pr in hg.pending_rounds.get_ordered_pending_rounds():
        try:
            ri = store.get_round(pr.index)
        except StoreError:
            continue
        ps = store.get_peer_set(pr.index)
        for x, re_ in ri.created_events.items():
            if not re_.witness or re_.famous != Trilean.UNDEFINED:
                continue
            i = win.wit_row.get(x)
            if i is None:
                continue
            f = int(fame[i])
            if f != 0:
                ri.set_fame(x, f == 1)
                applied.append((x, f))
        if ri.witnesses_decided(ps):
            decided_rounds.append(pr.index)
        store.set_round(pr.index, ri)
    hg.pending_rounds.update(decided_rounds)
    return decided_rounds, applied


def apply_round_received(hg, win: VotingWindow, rr: np.ndarray) -> List[str]:
    """Stamp received events and retire them from the undetermined list, in
    the oracle's scan order (mirrors Hashgraph.decide_round_received,
    hashgraph.go:1047-1091). Returns the received hashes."""
    store = hg.store
    # Two-phase: gather every fallible store read first so a StoreError can
    # abort BEFORE any mutation — a partially-applied receive pass followed
    # by the oracle fallback would double-receive events (add_received_event
    # has no dedup) and fork the node's blocks from its peers'. Each round's
    # info is fetched ONCE and shared by all its received events.
    new_undetermined: List[str] = []
    updates = []  # (event, round_received_abs)
    round_infos = {}  # round -> RoundInfo, fetched once
    for h in hg.undetermined_events:
        i = win.row.get(h)
        r = int(rr[i]) if i is not None else -1
        if r >= 0:
            a = r + win.base
            if a not in round_infos:
                round_infos[a] = store.get_round(a)
            updates.append((store.get_event(h), a))
        else:
            new_undetermined.append(h)
    for ev, a in updates:
        ev.set_round_received(a)
        store.set_event(ev)
        round_infos[a].add_received_event(ev.hex())
    for a, tr in round_infos.items():
        store.set_round(a, tr)
    hg.undetermined_events = new_undetermined
    return [ev.hex() for ev, _ in updates]
