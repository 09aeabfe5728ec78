"""The live voting sweep with the witness axis split over a device mesh.

The PyTorch counterpart of the JAX package's
``babble_tpu/parallel/voting_shard.py``: the fused fame + decidedness +
round-received sweep of ``ops/voting.py`` with the witness axis W split over
the N shards of a :class:`~babble_tpu_torch.parallel.mesh.Mesh`.

- Each shard owns W/N witness rows of the coordinates and the per-witness
  vectors (la, fd, rounds, valid, fame0, mid), so the [S, W, W] strongly-see
  counts, the sweep's largest tensor, are computed as [S, W/N, W] a shard:
  the shard's own voter rows against every candidate, by one launch of K1
  (``ops/kernels.member_ss_counts``, rectangular) on the shard's device,
  after fd has been gathered to every shard.
- The per-round vote recursion gathers the vote matrix once a round; the
  decided flags and values are summed across shards, so every shard holds
  the same fame.
- Round-received sums the missing-witness reduction across shards, and the
  output ``[fame | rr]`` is replicated: consensus decisions must be the
  same everywhere.

The exchanges are ``parallel/mesh.py``'s copies between the shards'
devices; the JAX package's ``shard_map`` inserts the same collectives. The
sweep is eager PyTorch: one Python loop over the round axis drives every
shard in step, as ``lax.fori_loop`` drives the JAX shards. Semantics equal
``ops.voting``'s sweep bit for bit (tests/test_torch_parallel.py); only the
placement differs. Oracle: DecideFame hashgraph.go:875-998,
DecideRoundReceived hashgraph.go:1002-1095.

The JAX package's compile registries (``_jitted``, ``resident_jitted``,
``precompile*``, ``*bucket_ready``) have no counterpart: eager PyTorch
compiles nothing. ``Mesh.key`` serves as the mesh's cache key.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..ops import kernels, voting
from ..ops.voting import WIN_FIELDS, VotingWindow
from ..ops.window_state import FRESH_FIELDS, PAD_FILL, RESIDENT_FIELDS
from .mesh import Mesh, all_gather, psum, replicate, split_rows

#: the VotingWindow fields split over the witness axis; the rest are
#: replicated on every shard
W_SHARDED = ("la_w", "fd_w", "rounds_w", "valid_w", "fame0_w", "mid_w")


def _sweep_shards(devices: Sequence[torch.device],
                  f: Dict[str, List[torch.Tensor]]) -> List[torch.Tensor]:
    """The sharded fused sweep. ``f`` maps each WIN_FIELDS name to one
    tensor a shard (the W-axis fields the shard's rows, the rest whole),
    each on its shard's device; returns every shard's [W + E] int32
    ``[fame | rr]``, all equal."""
    n = len(devices)
    shards = range(n)
    W_loc = f["la_w"][0].shape[0]
    R = f["psi"][0].shape[0]
    E = f["creator"][0].shape[0]
    if W_loc * n >= 1 << 24:
        raise ValueError("witness axis >= 2**24: the float32 tally is not "
                         "exact")
    if any(d.type == "cuda" for d in devices):
        torch.backends.cuda.matmul.allow_tf32 = False

    # the candidate axis (x) is whole on every shard: fd for the strongly-
    # see compare, and the small per-witness vectors
    fd_full = all_gather(f["fd_w"], devices)
    rounds_full = all_gather(f["rounds_w"], devices)
    valid_full = all_gather(f["valid_w"], devices)
    fame = all_gather(f["fame0_w"], devices)

    see_loc, see_ww_loc, ss_all_loc = [], [], []
    for k in shards:
        # SEE for the shard's voter rows (oracle: hashgraph.go:96-128)
        la = f["la_w"][k]
        see = ((la[:, f["creator"][k].long()] >= f["index"][k][None, :])
               & f["valid_w"][k][:, None])
        see_loc.append(see)
        see_ww_loc.append(see[:, f["wit_idx"][k].long()])
        # strongly-see per peer-set slot, the shard's voter rows against
        # every candidate: K1, one launch a shard (hashgraph.go:172-206)
        counts = kernels.member_ss_counts(la, fd_full[k], f["member"][k])
        ss_all_loc.append(counts >= f["sm_s"][k][:, None, None])

    # the voting math is ops/voting.py's, called on each shard's rows with
    # no batch axis; only the exchanges between shards are written here
    psi = [p.long() for p in f["psi"]]
    votes = [torch.zeros((W_loc, W_loc * n), dtype=torch.bool, device=d)
             for d in devices]
    for j in range(1, R):
        # the whole vote matrix for the derived-vote product: the per-round
        # exchange of the ring formulation
        votes_full = all_gather(votes, devices)
        now_parts, val_parts = [], []
        for k in shards:
            prev_full = valid_full[k] & (rounds_full[k] == (j - 1))
            ss_prev = ss_all_loc[k][psi[k][j - 1]] & prev_full
            votes[k], now, val = voting._vote_round(
                ss_prev, votes_full[k], votes[k], see_ww_loc[k],
                f["mid_w"][k], f["valid_w"][k] & (f["rounds_w"][k] == j),
                valid_full[k], j - rounds_full[k], f["sm_r"][k][j])
            # any over voters crosses shards: summed below
            now_parts.append(now.to(torch.int32))
            val_parts.append(val.to(torch.int32))
        decided_now = psum(now_parts, devices)
        decided_val = psum(val_parts, devices)
        for k in shards:
            fame[k] = voting._apply_decisions(
                fame[k], decided_now[k] > 0, decided_val[k] > 0)

    # per-round decidedness (oracle: roundInfo.go:78-96) from the replicated
    # fame: computed on the first shard, copied to the others
    dec, hard = voting._decided_rounds(
        fame[0], rounds_full[0], valid_full[0], f["sm_r"][0],
        f["exists_r"][0], f["prior_dec_r"][0], f["lb_gate_r"][0])
    decided_r = replicate(dec, devices)
    hard_block_r = replicate(hard, devices)

    # round-received, the witness reduction summed across shards
    # (oracle: hashgraph.go:1002-1095)
    fame_loc = [fame[k][k * W_loc:(k + 1) * W_loc] for k in shards]
    rr = [torch.full((E,), -1, dtype=torch.int32, device=d) for d in devices]
    blocked = [torch.zeros(E, dtype=torch.bool, device=d) for d in devices]
    for i in range(1, R):
        fw_parts, miss_parts = [], []
        for k in shards:
            fw = (f["valid_w"][k] & (f["rounds_w"][k] == i)
                  & (fame_loc[k] == 1))
            fw_parts.append(fw.sum(dtype=torch.int32))
            # every famous witness sees x <=> no shard's famous witness
            # fails to
            miss_parts.append((fw[:, None] & ~see_loc[k]).any(dim=0).to(
                torch.int32))
        n_fw = psum(fw_parts, devices)
        missing = psum(miss_parts, devices)
        for k in shards:
            rr[k], blocked[k] = voting._receive_round(
                rr[k], blocked[k], missing[k] == 0, n_fw[k],
                f["sm_r"][k][i], f["rounds"][k], f["undet"][k],
                decided_r[k][i], hard_block_r[k][i], i)
    return [torch.cat([fame[k], rr[k]]) for k in shards]


def sharded_sweep_fn(mesh: Mesh):
    """The sharded fused sweep for a mesh: a function of ``place_window``'s
    placement (18 lists of per-shard tensors, WIN_FIELDS order) returning
    the replicated [W + E] ``[fame | rr]`` (shard 0's copy, unread)."""
    devices = mesh.flat()

    def run(*placed) -> torch.Tensor:
        return _sweep_shards(devices, dict(zip(WIN_FIELDS, placed)))[0]

    return run


def place_window(mesh: Mesh, win: VotingWindow) -> tuple:
    """A VotingWindow's 18 arrays (WIN_FIELDS order) placed on the mesh:
    the W-axis fields split into one block of rows a shard, the rest one
    copy a shard."""
    devices = mesh.flat()
    return tuple(
        split_rows(getattr(win, f), devices) if f in W_SHARDED
        else replicate(getattr(win, f), devices)
        for f in WIN_FIELDS
    )


def _check_divides(mesh: Mesh, W: int) -> None:
    if W % mesh.size != 0:
        raise ValueError(f"W={W} not divisible by mesh size {mesh.size}")


def launch_sharded_sweep(mesh: Mesh, win: VotingWindow) -> torch.Tensor:
    """Place a window on the mesh and enqueue the sharded sweep on each
    shard device's current stream; returns the replicated [W + E] output
    on the mesh's first device, unread. The witness axis must divide over
    the mesh."""
    _check_divides(mesh, win.n_witnesses)
    return sharded_sweep_fn(mesh)(*place_window(mesh, win))


def run_sharded_sweep(mesh: Mesh, win: VotingWindow):
    """One sharded sweep over a live VotingWindow; returns (fame, rr)
    numpy arrays, identical to ``ops.voting.run_sweep``'s."""
    out = launch_sharded_sweep(mesh, win).cpu().numpy()
    W = win.n_witnesses
    return out[:W], out[W:W + win.n_events]


# -- resident windows on a mesh ----------------------------------------------


def resident_shardings(mesh: Mesh) -> tuple:
    """How each of the 11 resident buffers (RESIDENT_FIELDS order) lies on
    the mesh: "rep" (a copy a shard: the E-space vectors and the
    candidate-axis witness index) or "rows" (one block of witness rows a
    shard), as the sharded sweep's operands lie, so that the resident
    buffers are the sweep's operands."""
    return tuple("rows" if f in W_SHARDED else "rep" for f in RESIDENT_FIELDS)


def place_resident(mesh: Mesh, win) -> tuple:
    """The 11 resident buffers of ``win`` on the mesh (RESIDENT_FIELDS
    order), each a list of one tensor a shard: a replicated buffer's rows,
    or a split one's block of rows, plus one scratch row of the field's
    neutral fill, which the delta's padding indexes take (as the
    single-device buffers' do, ops/window_state.seed_buffers). Always new
    tensors, never sharing memory with ``win``."""
    devices = mesh.flat()
    n = len(devices)
    bufs = []
    for f, how in zip(RESIDENT_FIELDS, resident_shardings(mesh)):
        rows = torch.as_tensor(getattr(win, f))
        pad = torch.full((1, *rows.shape[1:]), PAD_FILL[f], dtype=rows.dtype)
        if how == "rows":
            _check_divides(mesh, rows.shape[0])
            blocks = torch.chunk(rows, n)
        else:
            blocks = [rows] * n
        bufs.append([torch.cat([b, pad]).to(d)
                     for b, d in zip(blocks, devices)])
    return tuple(bufs)


def resident_sweep_fn(mesh: Mesh):
    """The mesh counterpart of ``ops.window_state``'s resident program: a
    function (bufs, delta, fresh) that scatters a bucket-padded delta (the
    13 arrays of ``WindowState._pack_delta``; None: no scatter) into the
    per-shard resident buffers in place, each witness row only into the
    shard that owns it (the others, and the delta's padding rows, take the
    scratch row), then runs the sharded sweep over the buffers' window rows
    with the 7 fresh arrays (FRESH_FIELDS order). Returns (bufs, the
    replicated [W + E] output, unread)."""
    devices = mesh.flat()
    n = len(devices)

    def run(bufs, delta, fresh):
        W_loc = bufs[5][0].shape[0] - 1
        E = bufs[0][0].shape[0] - 1
        W = bufs[4][0].shape[0] - 1
        d = [replicate(torch.as_tensor(a), devices) for a in delta or ()]
        for k in range(n if delta is not None else 0):
            e = d[0][k].long()
            for q in range(4):  # creator, index, rounds, undet
                bufs[q][k].index_copy_(0, e, d[1 + q][k])
            w = d[5][k].long()
            bufs[4][k].index_copy_(0, w, d[6][k])  # wit_idx, replicated
            local = w - k * W_loc
            own = (local >= 0) & (local < W_loc)
            local = torch.where(own, local, torch.full_like(local, W_loc))
            for q in range(6):  # la_w, fd_w, rounds_w, valid_w, fame0_w,
                # mid_w: the shard's own rows
                bufs[5 + q][k].index_copy_(0, local, d[7 + q][k])
        rows = {f: [b[:E] if f in ("creator", "index", "rounds", "undet")
                    else b[:W] if f == "wit_idx" else b[:W_loc]
                    for b in buf]
                for f, buf in zip(RESIDENT_FIELDS, bufs)}
        rows.update({f: replicate(torch.as_tensor(a), devices)
                     for f, a in zip(FRESH_FIELDS, fresh)})
        return bufs, _sweep_shards(devices, rows)[0]

    return run


# -- a test window -------------------------------------------------------------


def synthetic_voting_window(
    n_peers: int = 6, n_events: int = 160, seed: int = 3,
    peer_change: bool = True,
) -> Tuple[object, VotingWindow]:
    """A real Hashgraph (a seeded random gossip stream, voting deferred)
    and its VotingWindow, with an optional peer-set change (the last peer
    leaves from round 3) so that the window carries two peer-set slots.
    The JAX package's function draws fresh keys; this one draws them from
    ``seed`` too, so that the window (its peer columns, its coin bits) is
    the same in every run."""
    import random

    from ..crypto.keys import PrivateKey
    from ..crypto.secp256k1 import N as CURVE_N
    from ..hashgraph import Event, Hashgraph, InmemStore
    from ..peers.peer import Peer
    from ..peers.peer_set import PeerSet

    rng = random.Random(seed)
    key_rng = random.Random(seed * 1_000_003 + 7)
    keys = [PrivateKey(key_rng.randrange(1, CURVE_N)) for _ in range(n_peers)]
    peers = PeerSet([
        Peer(f"inmem://p{i}", k.public_key.hex(), f"p{i}")
        for i, k in enumerate(keys)
    ])
    h = Hashgraph(InmemStore(100000))
    h.init(peers)
    if peer_change:
        h.store.set_peer_set(3, peers.with_removed_peer(peers.peers[-1]))

    heads = [""] * n_peers
    seqs = [-1] * n_peers
    count = 0
    order = list(range(n_peers))
    while count < n_events:
        rng.shuffle(order)
        for i in order:
            if count >= n_events:
                break
            op = ""
            if count:
                j = rng.randrange(n_peers - 1)
                j = j if j < i else j + 1
                op = heads[j]
                if op == "":
                    continue
            idx = seqs[i] + 1
            e = Event.new(
                [b"t"] if idx else [], [], [], [heads[i], op],
                keys[i].public_key.bytes(), idx, timestamp=count,
            )
            e.sign(keys[i])
            e.prevalidate(True)
            heads[i] = e.hex()
            seqs[i] = idx
            h.insert_event(e, set_wire_info=True)
            h.divide_rounds()
            count += 1
    win = voting.build_voting_window(h)
    assert win is not None
    return h, win
