"""The all-at-once DAG consensus pipeline: the whole window as tensors.

The PyTorch counterpart of the JAX package's ``babble_tpu/ops/dag.py``.
Instead of the oracle's per-event recursion with caches (reference:
src/hashgraph/hashgraph.go:172-206 stronglySee, 208-282 round, 875-998
DecideFame, 1002-1095 DecideRoundReceived), a DAG window is packed into
dense struct-of-arrays tensors and processed with masked compares, 0/1
matrix products and fixpoint sweeps:

- events are rows, peers are columns (``PeerSet.peer_index`` order);
- last-ancestors and first-descendants are ``[E, P]`` int32 coordinates;
- strongly-see is the hand-written kernel K2 (``ops/kernels.strongly_see``);
- rounds and lamport timestamps are fixpoint sweeps, each pass propagating
  one DAG level;
- fame is per-round vote matrices updated by exact 0/1 tallies;
- round-received is a per-round reduction over famous witnesses' see rows.

Every stage works on a leading batch axis ``B``: one window is ``B = 1``,
and the batched pipeline (``parallel/pipeline.py``, the JAX package's
``jax.vmap``) is the same code at ``B > 1``. Outputs are identical, bit for
bit, to the JAX package's, window by window.

PyTorch runs eagerly, so the reference's ``lax.while_loop`` and
``lax.fori_loop`` are Python loops:

- a fixpoint sweep tests whether its last pass changed anything only every
  ``FIXPOINT_CHECK_EVERY`` passes (one host sync each time); a sweep at its
  fixpoint returns its input, so the extra passes change nothing, and the
  total stays capped at ``max_iters`` as in the reference;
- the fame and round-received loops stop after round ``max(rounds)``
  (one host read): a later round has no witness, so its pass has no voter
  and decides nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from babble_tpu_torch.ops.device import DeviceLike, resolve_device
from babble_tpu_torch.ops.intdot import vote_matmul
from babble_tpu_torch.ops.kernels import strongly_see
from babble_tpu_torch.ops.voting import COIN_ROUND_FREQ, INT32_MAX

#: passes of a fixpoint sweep between two tests of its change flag
FIXPOINT_CHECK_EVERY = 16

Array = Union[np.ndarray, torch.Tensor]
#: what a pipeline run did, filled in for a caller that asks (batched_core)
Stats = Dict[str, int]


@dataclass
class DagSnapshot:
    """Dense struct-of-arrays view of a DAG window.

    E = number of events (topological order), P = number of peers. Missing
    coordinates: last_ancestors = -1, first_descendants = INT32_MAX. The
    arrays are numpy arrays, or tensors of the same dtypes
    (``interop.snapshot_from_arrays``).
    """

    creator: Array  # [E] int32, peer index of each event's creator
    index: Array  # [E] int32, per-creator sequence number
    self_parent: Array  # [E] int32, event row of self-parent, -1 if none
    other_parent: Array  # [E] int32, event row of other-parent, -1 if none
    last_ancestors: Array  # [E, P] int32
    first_descendants: Array  # [E, P] int32
    middle_bit: Array  # [E] bool, coin-round bit of each event's hash
    n_peers: int
    hashes: List[str]  # row -> event hex (host-side bookkeeping only)

    @property
    def n_events(self) -> int:
        return int(self.creator.shape[0])

    # super-majority threshold of the window's peer-set; filled by
    # snapshot_from_hashgraph from PeerSet.super_majority()
    super_majority: int = 0


#: DagSnapshot's arrays in pipeline_core's argument order
SNAPSHOT_FIELDS = ("creator", "index", "self_parent", "other_parent",
                   "last_ancestors", "first_descendants", "middle_bit")


def snapshot_from_hashgraph(h, event_hashes: Optional[List[str]] = None
                            ) -> DagSnapshot:
    """A DagSnapshot of the port's Hashgraph (oracle) store.

    ``event_hashes`` defaults to all events in topological order. The peer
    coordinate is the sorted-PeerSet index of peer-set 0.
    """
    from babble_tpu_torch.common.errors import StoreError
    from babble_tpu_torch.hashgraph.hashgraph import middle_bit

    store = h.store
    peer_set = store.get_peer_set(0)
    pub_keys = peer_set.pub_keys()
    peer_col = {pk: i for i, pk in enumerate(pub_keys)}
    n_peers = len(pub_keys)

    if event_hashes is None:
        events = []
        for pk in pub_keys:
            try:
                hashes = store.participant_events(pk, -1)
            except StoreError:
                continue  # participant has no events yet
            events.extend(store.get_event(eh) for eh in hashes)
        events.sort(key=lambda e: e.topological_index)
        event_hashes = [e.hex() for e in events]

    row = {eh: i for i, eh in enumerate(event_hashes)}
    E = len(event_hashes)

    creator = np.full(E, -1, np.int32)
    index = np.full(E, -1, np.int32)
    self_parent = np.full(E, -1, np.int32)
    other_parent = np.full(E, -1, np.int32)
    la = np.full((E, n_peers), -1, np.int32)
    fd = np.full((E, n_peers), INT32_MAX, np.int32)
    mid = np.zeros(E, bool)

    for i, eh in enumerate(event_hashes):
        ev = store.get_event(eh)
        creator[i] = peer_col[ev.creator()]
        index[i] = ev.index()
        self_parent[i] = row.get(ev.self_parent(), -1)
        other_parent[i] = row.get(ev.other_parent(), -1)
        for pk, coords in ev.last_ancestors.items():
            if pk in peer_col:
                la[i, peer_col[pk]] = coords.index
        for pk, coords in ev.first_descendants.items():
            if pk in peer_col:
                fd[i, peer_col[pk]] = coords.index
        mid[i] = middle_bit(eh)

    return DagSnapshot(
        creator=creator,
        index=index,
        self_parent=self_parent,
        other_parent=other_parent,
        last_ancestors=la,
        first_descendants=fd,
        middle_bit=mid,
        n_peers=n_peers,
        hashes=list(event_hashes),
        super_majority=peer_set.super_majority(),
    )


# =============================================================================
# Predicates
# =============================================================================


def see_matrix(creator: torch.Tensor, index: torch.Tensor,
               la: torch.Tensor) -> torch.Tensor:
    """SEE[b, x, y] = x sees y = la[b, x, creator(y)] >= index(y)
    (oracle: Hashgraph._ancestor via lastAncestors, hashgraph.go:108-128).
    creator, index: [B, E]; la: [B, E, P]; returns bool [B, E, E]."""
    B, E = creator.shape
    cols = creator.long()[:, None, :].expand(B, E, E)
    return torch.gather(la, 2, cols) >= index[:, None, :]


def strongly_see_matrix(la: torch.Tensor, fd: torch.Tensor,
                        super_majority: int) -> torch.Tensor:
    """SS[b, x, y] = #{p : la[b,x,p] >= fd[b,y,p]} >= super_majority, with
    missing coordinates excluded by the -1 / INT32_MAX sentinels (oracle:
    hashgraph.go:184-206). The kernel K2 on the card, its plain version on
    the CPU."""
    return strongly_see(la, fd, super_majority)


# =============================================================================
# Fixpoint sweeps: rounds and lamport timestamps
# =============================================================================


def _parents(self_parent: torch.Tensor, other_parent: torch.Tensor):
    """(has_sp, sp, has_op, op): parent masks, and parent rows with -1
    clamped to 0 so that they index safely."""
    has_sp = self_parent >= 0
    has_op = other_parent >= 0
    sp = torch.where(has_sp, self_parent, 0).long()
    op = torch.where(has_op, other_parent, 0).long()
    return has_sp, sp, has_op, op


def _fixpoint(sweep, x0: torch.Tensor, max_iters: int
              ) -> Tuple[torch.Tensor, int]:
    """Iterate ``sweep`` from ``x0`` to the reference while loop's result
    (it stops when a pass changes nothing, or after ``max_iters`` passes),
    testing for a change only on the last pass of every
    ``FIXPOINT_CHECK_EVERY``: one host sync each. Returns (result, passes
    made)."""
    x = x0
    done = 0
    while done < max_iters:
        n = min(FIXPOINT_CHECK_EVERY, max_iters - done)
        for _ in range(n - 1):
            x = sweep(x)
        new = sweep(x)
        changed = bool((new != x).any())
        x = new
        done += n
        if not changed:
            break
    return x, done


def compute_rounds(creator: torch.Tensor, self_parent: torch.Tensor,
                   other_parent: torch.Tensor, ss: torch.Tensor,
                   super_majority: int, max_iters: Optional[int] = None,
                   stats: Optional[Stats] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rounds, witness) of every event, [B, E] each (oracle: round and
    witness, hashgraph.go:208-327): each pass recomputes every event's
    round from its parents' current rounds and the strongly-seen witnesses
    of the parent round, to the fixpoint, at most ``max_iters`` (default
    E + 2) passes. The passes made go to ``stats["rounds_passes"]``."""
    E = creator.shape[1]
    if max_iters is None:
        max_iters = E + 2
    has_sp, sp, has_op, op = _parents(self_parent, other_parent)

    def witness_of(rounds):
        # first event of its round on its creator's chain
        # (hashgraph.go:297-327)
        return rounds > torch.where(has_sp, torch.gather(rounds, 1, sp), -1)

    def sweep(rounds):
        sp_round = torch.where(has_sp, torch.gather(rounds, 1, sp), -1)
        op_round = torch.where(has_op, torch.gather(rounds, 1, op), -1)
        parent_round = torch.maximum(sp_round, op_round)  # [B, E]
        wit = rounds > sp_round
        # witnesses w of round parent_round[x] strongly seen by x
        seen = (ss & (rounds[:, None, :] == parent_round[:, :, None])
                & wit[:, None, :])
        inc = seen.sum(dim=2, dtype=torch.int32) >= super_majority
        return torch.where(parent_round < 0, 0, parent_round + inc).to(
            torch.int32)

    rounds0 = torch.zeros(creator.shape, dtype=torch.int32,
                          device=creator.device)
    rounds, passes = _fixpoint(sweep, rounds0, max_iters)
    if stats is not None:
        stats["rounds_passes"] = passes
    return rounds, witness_of(rounds)


def compute_lamport(self_parent: torch.Tensor, other_parent: torch.Tensor,
                    max_iters: Optional[int] = None,
                    stats: Optional[Stats] = None) -> torch.Tensor:
    """Lamport timestamps [B, E] by the same fixpoint pattern (oracle:
    hashgraph.go:355-387). The passes made go to
    ``stats["lamport_passes"]``."""
    E = self_parent.shape[1]
    if max_iters is None:
        max_iters = E + 2
    has_sp, sp, has_op, op = _parents(self_parent, other_parent)

    def sweep(lt):
        plt = torch.maximum(
            torch.where(has_sp, torch.gather(lt, 1, sp), -1),
            torch.where(has_op, torch.gather(lt, 1, op), -1),
        )
        return (plt + 1).to(torch.int32)

    lt0 = torch.zeros(self_parent.shape, dtype=torch.int32,
                      device=self_parent.device)
    lt, passes = _fixpoint(sweep, lt0, max_iters)
    if stats is not None:
        stats["lamport_passes"] = passes
    return lt


# =============================================================================
# Virtual voting and round-received
# =============================================================================


def decide_fame(rounds: torch.Tensor, witness: torch.Tensor,
                see: torch.Tensor, ss: torch.Tensor,
                middle_bit: torch.Tensor, super_majority: int,
                last_round: int, coin_round_freq: int = COIN_ROUND_FREQ,
                ) -> torch.Tensor:
    """Fame of every witness, [B, E] int32: +1 famous, 0 undecided, -1 not
    famous (oracle: VOTE_LOOP, hashgraph.go:875-998). For each voting
    round j in 1..last_round every (voter y of round j, earlier witness x)
    pair updates at once:

    - diff == 1: votes[y, x] = SEE[y, x];
    - else: yays[y, x] = sum_w SS[y, w] * votes[w, x] over the witnesses w
      of round j-1, one exact 0/1 tally for all pairs; majority and
      super-majority decide or carry the vote; coin rounds (diff % freq
      == 0) take y's hash bit when not settled.

    Decisions freeze: the first one wins, as the oracle's sticky fame.
    """
    B, E = rounds.shape
    votes = torch.zeros((B, E, E), dtype=torch.bool, device=rounds.device)
    fame = torch.zeros((B, E), dtype=torch.int32, device=rounds.device)
    for j in range(1, last_round + 1):
        voter = witness & (rounds == j)  # [B, E(y)]
        diff = j - rounds  # [B, E(x)]

        # derived vote: majority among strongly-seen witnesses of j-1
        prev_wit = witness & (rounds == j - 1)
        ss_prev = ss & prev_wit[:, None, :]  # [B, E(y), E(w)]
        n_ss = ss_prev.sum(dim=2, dtype=torch.int32)  # [B, E(y)]
        yays = vote_matmul(ss_prev, votes)  # [B, E(y), E(x)]
        nays = n_ss[:, :, None] - yays
        v = yays >= nays
        settled = torch.maximum(yays, nays) >= super_majority

        # floor modulo, as the reference's % on a negative diff
        is_coin = torch.remainder(diff, coin_round_freq) == 0  # [B, E(x)]
        derived = torch.where(is_coin[:, None, :] & ~settled,
                              middle_bit[:, :, None], v)
        new_vote = torch.where((diff == 1)[:, None, :], see, derived)

        # a pair takes part when y votes and x is an earlier witness
        active = (voter[:, :, None] & witness[:, None, :]
                  & (diff >= 1)[:, None, :])
        votes = torch.where(active, new_vote, votes)

        # decisions: normal rounds only, settled pairs, undecided candidates
        decide_pair = (active & ~is_coin[:, None, :] & (diff > 1)[:, None, :]
                       & settled)
        decided_now = decide_pair.any(dim=1)  # [B, E(x)]
        decided_val = (decide_pair & v).any(dim=1)
        newly = decided_now & (fame == 0)
        fame = fame.masked_fill(newly & decided_val, 1).masked_fill(
            newly & ~decided_val, -1)
    return fame


def decide_round_received(rounds: torch.Tensor, witness: torch.Tensor,
                          fame: torch.Tensor, see: torch.Tensor,
                          super_majority: int, last_round: int,
                          ) -> torch.Tensor:
    """round_received[b, x], or -1 if undetermined (oracle:
    hashgraph.go:1002-1095). For each decided round i (witnesses present,
    none undecided, a super-majority decided), x is received at the first
    i > round(x) where every famous witness of i sees x and the famous
    count reaches the super-majority. An event's scan stops at its first
    undecided round after its own."""
    B, E = rounds.shape
    rr = torch.full((B, E), -1, dtype=torch.int32, device=rounds.device)
    blocked = torch.zeros((B, E), dtype=torch.bool, device=rounds.device)
    for i in range(1, last_round + 1):
        wits = witness & (rounds == i)
        undecided = (wits & (fame == 0)).any(dim=1)  # [B]
        n_decided = (wits & (fame != 0)).sum(dim=1, dtype=torch.int32)
        decided = ~undecided & (n_decided >= super_majority)  # [B]
        fw = wits & (fame == 1)  # famous witnesses of i
        n_fw = fw.sum(dim=1, dtype=torch.int32)
        sees_x = see | (~fw)[:, :, None]  # non-famous rows drop out
        all_see = sees_x.all(dim=1) & (n_fw >= super_majority)[:, None]
        relevant = rounds < i  # the oracle's scan starts at round(x) + 1
        eligible = (decided[:, None] & ~blocked & relevant & (rr < 0)
                    & all_see)
        rr = rr.masked_fill(eligible, i)
        blocked = blocked | (relevant & ~decided[:, None])
    return rr


# =============================================================================
# The whole pipeline
# =============================================================================


def batched_core(creator, index, sp, op, la, fd, mid, sm: int,
                 round_bound: int, stats: Optional[Stats] = None,
                 ss_fn=None):
    """The whole consensus sweep over a batch of windows: inputs [B, E]
    (la, fd [B, E, P]) on one device. Returns (see [B, E, E], ss [B, E, E],
    packed [B, 5, E]) where packed stacks (rounds, witness, lamport, fame,
    round_received) as int32, so one copy carries every per-event result.
    ``ss_fn``, when given, computes the strongly-see matrix in place of
    ``strongly_see_matrix`` (same arguments, same result): the sharded
    pipeline's row split over its shards (parallel/pipeline.py).

    The fame and round-received loops run rounds 1..min(round_bound,
    max(rounds)); the rounds after those are no-ops in the reference.
    ``stats``, when given, receives what the run did: ``rounds_passes``
    and ``lamport_passes`` (fixpoint passes made), ``round_loop`` (rounds
    the fame and round-received loops ran) and ``round_bound``."""
    see = see_matrix(creator, index, la)
    ss = (strongly_see_matrix if ss_fn is None else ss_fn)(la, fd, sm)
    rounds, wit = compute_rounds(creator, sp, op, ss, sm, stats=stats)
    lamport = compute_lamport(sp, op, stats=stats)
    top = int(rounds.max()) if rounds.numel() else 0
    loop = min(round_bound, top)
    if stats is not None:
        stats.update(round_loop=loop, round_bound=round_bound)
    fame = decide_fame(rounds, wit, see, ss, mid, sm, loop)
    rr = decide_round_received(rounds, wit, fame, see, sm, loop)
    packed = torch.stack([rounds, wit.to(torch.int32), lamport, fame, rr],
                         dim=1)
    return see, ss, packed


def pipeline_core(creator, index, sp, op, la, fd, mid, sm: int,
                  round_bound: int, stats: Optional[Stats] = None):
    """One window's consensus sweep: inputs [E] (la, fd [E, P]) on one
    device; returns (see [E, E], ss [E, E], packed [5, E])."""
    see, ss, packed = batched_core(
        *(t[None] for t in (creator, index, sp, op, la, fd, mid)),
        sm, round_bound, stats,
    )
    return see[0], ss[0], packed[0]


def snapshot_tensors(snapshot: DagSnapshot, device: torch.device):
    """The snapshot's arrays as tensors on ``device``, in pipeline_core's
    argument order."""
    return tuple(torch.as_tensor(getattr(snapshot, f), device=device)
                 for f in SNAPSHOT_FIELDS)


def run_pipeline(snapshot: DagSnapshot, return_matrices: bool = False,
                 device: DeviceLike = None, stats: Optional[Stats] = None,
                 ) -> Dict[str, np.ndarray]:
    """Run the pipeline on a snapshot (on the card unless ``device`` says
    otherwise); returns host arrays: rounds, witness, lamport, fame and
    round_received, plus see and strongly_see when ``return_matrices``.
    ``stats``, when given, receives the pass counts (``batched_core``).

    The per-event results come back in one copy; the [E, E] matrices stay
    on the device unless asked for.
    """
    dev = resolve_device(device)
    sm = snapshot.super_majority
    # Every passed round holds >= sm distinct witnesses, so the last round
    # is at most E // sm + 1: the reference's loop bound.
    round_bound = snapshot.n_events // max(1, sm) + 2
    see, ss, packed = pipeline_core(*snapshot_tensors(snapshot, dev), sm,
                                    round_bound, stats)
    host = packed.cpu().numpy()  # one copy for all per-event outputs
    out = {
        "rounds": host[0],
        "witness": host[1].astype(bool),
        "lamport": host[2],
        "fame": host[3],
        "round_received": host[4],
    }
    if return_matrices:
        out["see"] = see.cpu().numpy()
        out["strongly_see"] = ss.cpu().numpy()
    return out


# =============================================================================
# Synthetic DAG windows (benchmarks, batched runs)
# =============================================================================


def synthetic_snapshot(n_peers: int, n_events: int, seed: int = 7
                       ) -> DagSnapshot:
    """A deterministic gossip-shaped DagSnapshot without any crypto: the
    JAX package's ``synthetic_snapshot``, array for array.

    Round-robin-with-jitter gossip: after one root per peer, each new
    event's creator self-parents on its head and other-parents on another
    peer's head. Coordinates come from the exact ancestry closure, one
    peer column at a time.
    """
    assert n_events >= n_peers
    rng = np.random.RandomState(seed)

    creator = np.full(n_events, -1, np.int32)
    index = np.full(n_events, -1, np.int32)
    sp = np.full(n_events, -1, np.int32)
    op = np.full(n_events, -1, np.int32)

    heads = [-1] * n_peers
    per_creator_seq = [0] * n_peers
    # ancestry[i, j] = event j is an ancestor of event i (incl. self)
    anc = np.zeros((n_events, n_events), bool)

    for i in range(n_events):
        c = i if i < n_peers else int(rng.randint(n_peers))
        creator[i] = c
        index[i] = per_creator_seq[c]
        per_creator_seq[c] += 1
        anc[i, i] = True
        if heads[c] >= 0:
            sp[i] = heads[c]
            anc[i] |= anc[heads[c]]
        if i >= n_peers:
            others = [p for p in range(n_peers) if p != c and heads[p] >= 0]
            if others:
                o = int(rng.choice(others))
                op[i] = heads[o]
                anc[i] |= anc[heads[o]]
        heads[c] = i

    la = np.full((n_events, n_peers), -1, np.int32)
    fd = np.full((n_events, n_peers), INT32_MAX, np.int32)
    for p in range(n_peers):
        rows = np.flatnonzero(creator == p)
        if rows.size == 0:
            continue
        idx = index[rows]
        # last ancestor: the largest index of p's events among i's ancestors
        la[:, p] = np.where(anc[:, rows], idx[None, :], -1).max(axis=1)
        # first descendant: the smallest index of p's events descending from i
        fd[:, p] = np.where(anc[rows, :], idx[:, None], INT32_MAX).min(axis=0)

    # deterministic pseudo-random coin bits
    mid = ((np.arange(n_events, dtype=np.uint64) * 2654435761) >> 16) & 1 == 1

    return DagSnapshot(
        creator=creator,
        index=index,
        self_parent=sp,
        other_parent=op,
        last_ancestors=la,
        first_descendants=fd,
        middle_bit=mid,
        n_peers=n_peers,
        hashes=[f"synthetic-{i}" for i in range(n_events)],
        super_majority=2 * n_peers // 3 + 1,
    )
