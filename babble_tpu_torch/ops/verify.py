"""Batched secp256k1 ECDSA verification on the card: K3 and its host side.

Ports ``babble_tpu/ops/verify.py``. It replaces the reference's per-event
host verification (src/hashgraph/hashgraph.go:672-687 ->
src/crypto/keys/signature.go:20) with one batch per sync chunk, split as
in the JAX package:

- HOST (``_prepare``, per item, in Python): range checks on (r, s), the
  on-curve check of the key, e = H(m) truncated, w = s^-1 mod n,
  u1 = e w, u2 = r w, the table {infinity, G, Q, G + Q}, r and r + n.
- DEVICE (``shamir``): R = u1 G + u2 Q by the interleaved Shamir ladder
  in Jacobian coordinates, 256 doublings and up to 256 mixed additions,
  then the projective check X == r Z^2 or X == (r + n) Z^2 (where
  r + n < p) with Z != 0: no inversion on the device.

``shamir`` launches K3 (``csrc/ecdsa_verify.cu``) for CUDA tensors and
raises on any failure; CPU tensors (the tests) take ``shamir_plain``, the
JAX ladder written on the port's limbs (``ops/limbs.py``). Results are
bools, equal bit for bit to the JAX kernel's.

A departure from the JAX package: it pads every batch to a multiple of
``TILE`` = 64 so that XLA compiles one program, and slices the padding
away; K3 needs no compile per shape, so the port launches over the real
batch and its outputs are the same.

Differential oracle: ``babble_tpu_torch/crypto/secp256k1.py``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from babble_tpu_torch.crypto import secp256k1 as ref
from babble_tpu_torch.ops import kernels
from babble_tpu_torch.ops.device import DeviceLike, resolve_device
from babble_tpu_torch.ops.limbs import (
    NLIMB,
    _add,
    _mul,
    _sqr,
    _sub,
    eq,
    ints_to_limbs,
    is_zero,
    select,
)

SigItem = Tuple[Tuple[int, int], bytes, int, int]  # (pub (x, y), hash, r, s)


class VerifyInputs(NamedTuple):
    """``_prepare``'s arrays, as the JAX package orders them: int32 16-bit
    limbs and bool masks on one device. ``pre_ok`` is the host's verdict
    (range and curve checks); the other eight are K3's inputs."""

    pre_ok: torch.Tensor  # [B] bool
    u1: torch.Tensor  # [B, 16]
    u2: torch.Tensor  # [B, 16]
    table_x: torch.Tensor  # [B, 4, 16]: index 0 unused, 1 = G, 2 = Q, 3 = G+Q
    table_y: torch.Tensor  # [B, 4, 16]
    table_inf: torch.Tensor  # [B, 4] bool
    r: torch.Tensor  # [B, 16]
    rn: torch.Tensor  # [B, 16]: r + n, checked only where rn_ok
    rn_ok: torch.Tensor  # [B] bool: r + n < p


# -----------------------------------------------------------------------------
# Jacobian point operations on int64 limbs (the plain ladder). A point is
# (X, Y, Z); Z == 0 is infinity. Curve y^2 = x^3 + 7: a = 0.
# -----------------------------------------------------------------------------


def _double(X, Y, Z):
    """dbl-2009-l for a = 0; infinity (Z = 0) maps to Z3 = 0."""
    A = _sqr(X)
    B = _sqr(Y)
    Cc = _sqr(B)
    t = _sqr(_add(X, B))
    D = _sub(_sub(t, A), Cc)
    D = _add(D, D)  # 2 ((X + B)^2 - A - C)
    E = _add(_add(A, A), A)  # 3 A
    F = _sqr(E)
    X3 = _sub(F, _add(D, D))
    eight_c = _add(_add(Cc, Cc), _add(Cc, Cc))
    eight_c = _add(eight_c, eight_c)
    Y3 = _sub(_mul(E, _sub(D, X3)), eight_c)
    YZ = _mul(Y, Z)
    Z3 = _add(YZ, YZ)
    return X3, Y3, Z3


def _add_mixed(X1, Y1, Z1, x2, y2, inf2):
    """Jacobian P1 += affine P2 (z2 = 1), as the JAX package's selects
    decide, in order of priority: P2 infinite -> P1; P1 infinite -> P2
    lifted; P1 == -P2 -> infinity; P1 == P2 -> the doubling of P1; else
    the general addition. The doubling is computed only when a lane
    needs it."""
    inf1 = is_zero(Z1)
    Z1Z1 = _sqr(Z1)
    U2 = _mul(x2, Z1Z1)
    S2 = _mul(y2, _mul(Z1, Z1Z1))
    H = _sub(U2, X1)
    R = _sub(S2, Y1)
    h_zero = is_zero(H)
    r_zero = is_zero(R)
    same_point = h_zero & r_zero & ~inf1 & ~inf2
    negated = h_zero & ~r_zero & ~inf1 & ~inf2  # P1 == -P2

    HH = _sqr(H)
    HHH = _mul(H, HH)
    U1HH = _mul(X1, HH)
    X_out = _sub(_sub(_sqr(R), HHH), _add(U1HH, U1HH))
    Y_out = _sub(_mul(R, _sub(U1HH, X_out)), _mul(Y1, HHH))
    Z_out = _mul(Z1, H)

    if bool(same_point.any()):
        dX, dY, dZ = _double(X1, Y1, Z1)
        X_out = select(same_point, dX, X_out)
        Y_out = select(same_point, dY, Y_out)
        Z_out = select(same_point, dZ, Z_out)
    zero = torch.zeros_like(X1)
    one = zero.clone()
    one[..., 0] = 1
    Z_out = select(negated, zero, Z_out)
    X_out = select(inf1, x2, X_out)
    Y_out = select(inf1, y2, Y_out)
    Z_out = select(inf1, select(inf2, zero, one), Z_out)
    X_out = select(inf2, X1, X_out)
    Y_out = select(inf2, Y1, Y_out)
    Z_out = select(inf2, Z1, Z_out)
    return X_out, Y_out, Z_out


def projective_check(X, Z, r, rn, rn_ok) -> torch.Tensor:
    """[B] bool: the ladder's point (X, Y, Z) is not infinity and its affine
    x = X / Z^2 is r or, where ``rn_ok``, r + n: X == r Z^2 or X == rn Z^2
    (JAX ``_shamir_kernel``'s last step). Limbs int32 or int64."""
    X, Z, r, rn = X.long(), Z.long(), r.long(), rn.long()
    not_inf = ~is_zero(Z)
    Z2 = _sqr(Z)
    ok_r = eq(X, _mul(r, Z2))
    ok_rn = eq(X, _mul(rn, Z2)) & rn_ok
    return not_inf & (ok_r | ok_rn)


def shamir_plain(u1, u2, table_x, table_y, table_inf, r, rn,
                 rn_ok) -> torch.Tensor:
    """[B] bool: u1 G + u2 Q has x-coordinate = r (mod n). The plain version
    of K3: the JAX ladder (``_shamir_kernel``) in PyTorch operations, on
    the inputs' device."""
    B = u1.shape[0]
    tx, ty = table_x.long(), table_y.long()
    # the table index of every step: sel[:, 255 - bit] = u1's bit + 2 u2's
    shifts = torch.arange(NLIMB, device=u1.device)
    bits1 = ((u1.long()[:, :, None] >> shifts) & 1).reshape(B, 256)
    bits2 = ((u2.long()[:, :, None] >> shifts) & 1).reshape(B, 256)
    sel = (bits1 + 2 * bits2).flip(1)
    ainf = table_inf.gather(1, sel) | (sel == 0)
    X = torch.zeros((B, NLIMB), dtype=torch.int64, device=u1.device)
    Y = torch.zeros_like(X)
    Z = torch.zeros_like(X)  # infinity
    for i in range(256):
        X, Y, Z = _double(X, Y, Z)
        idx = sel[:, i, None, None].expand(B, 1, NLIMB)
        ax = tx.gather(1, idx)[:, 0]
        ay = ty.gather(1, idx)[:, 0]
        X, Y, Z = _add_mixed(X, Y, Z, ax, ay, ainf[:, i])
    return projective_check(X, Z, r, rn, rn_ok)


def shamir(u1, u2, table_x, table_y, table_inf, r, rn, rn_ok) -> torch.Tensor:
    """K3. [B] bool verdicts of the ladder from ``_prepare``'s arrays (int32
    16-bit limbs in [0, 2^16), bool masks). CPU tensors take
    ``shamir_plain``; CUDA tensors launch the kernel, or raise."""
    args = (u1, u2, table_x, table_y, table_inf, r, rn, rn_ok)
    if u1.device.type == "cpu":
        kernels.check_ecdsa_inputs(*args)
        return shamir_plain(*args)
    return kernels.ecdsa_shamir(*args)


# -----------------------------------------------------------------------------
# Host side
# -----------------------------------------------------------------------------


def _prepare(items: Sequence[SigItem], device: DeviceLike = None
             ) -> VerifyInputs:
    """items [(pub (x, y), msg_hash, r, s)] -> K3's inputs on ``device``.

    Host rejects (r or s out of range, key off the curve) clear ``pre_ok``;
    their slots get dummy but well-formed data, as in the JAX package."""
    dev = resolve_device(device)
    B = len(items)
    pre_ok = np.zeros(B, dtype=bool)
    rn_ok = np.zeros(B, dtype=bool)
    tinf = np.ones((B, 4), dtype=bool)
    u1s: List[int] = []
    u2s: List[int] = []
    rs: List[int] = []
    rns: List[int] = []
    # table coordinates, four entries an item (entry 0 unused), 0 if absent
    tab_x = [0] * (4 * B)
    tab_y = [0] * (4 * B)
    for b, (pub, msg_hash, r, s) in enumerate(items):
        if not (1 <= r < ref.N and 1 <= s < ref.N) or not ref.is_on_curve(pub):
            u1s.append(1)
            u2s.append(1)
            rs.append(1)
            rns.append(1)
            continue
        pre_ok[b] = True
        e = ref._bits2int(msg_hash)
        w = pow(s, -1, ref.N)
        u1s.append((e * w) % ref.N)
        u2s.append((r * w) % ref.N)
        rs.append(r)
        rn = r + ref.N
        rns.append(rn if rn < ref.P else 1)
        rn_ok[b] = rn < ref.P
        tab_x[4 * b + 1], tab_y[4 * b + 1] = ref.GX, ref.GY
        tab_x[4 * b + 2], tab_y[4 * b + 2] = pub
        tinf[b, 1:3] = False
        gq = ref.point_add(ref.G, pub)
        if gq is not None:
            tab_x[4 * b + 3], tab_y[4 * b + 3] = gq
            tinf[b, 3] = False

    def limbs(xs, *shape):
        return ints_to_limbs(xs).reshape(*shape, NLIMB).to(dev)

    return VerifyInputs(
        pre_ok=torch.from_numpy(pre_ok).to(dev),
        u1=limbs(u1s, B),
        u2=limbs(u2s, B),
        table_x=limbs(tab_x, B, 4),
        table_y=limbs(tab_y, B, 4),
        table_inf=torch.from_numpy(tinf).to(dev),
        r=limbs(rs, B),
        rn=limbs(rns, B),
        rn_ok=torch.from_numpy(rn_ok).to(dev),
    )


def batch_verify(items: Sequence[SigItem], device: DeviceLike = None
                 ) -> np.ndarray:
    """Verify a batch of ECDSA signatures; returns [B] bool, each equal to
    ``crypto.secp256k1.verify`` of its item. ``device`` defaults to the
    card (no card raises); ``"cpu"`` runs the plain ladder."""
    dev = resolve_device(device)
    if len(items) == 0:
        return np.zeros(0, dtype=bool)
    inputs = _prepare(items, dev)
    out = shamir(*inputs[1:]) & inputs.pre_ok
    return out.cpu().numpy()


def warmup(device: DeviceLike = None) -> None:
    """Build the kernel library and verify one signature, ahead of the
    gossip path (``Node.init`` with ``BABBLE_DEVICE_VERIFY=1``)."""
    batch_verify([((ref.GX, ref.GY), b"\x00" * 32, 1, 1)], device)


def prevalidate_events(events, device: DeviceLike = None) -> None:
    """Batch-verify the signatures of a list of Events on ``device`` and
    cache each verdict on its event, so that the insert path's
    ``Event.verify()`` is a cache hit. An event contributes its creator's
    signature and one per internal transaction, collected as the host
    batch verifier collects them (``crypto.batch``); its verdict is the AND
    of its items, and an undecodable signature or key fails it on the
    host."""
    from babble_tpu_torch.crypto.batch import collect_signature_items

    items, spans = collect_signature_items(events)
    results = batch_verify(items, device)
    for ev, start, count, ok_static in spans:
        ev.prevalidate(ok_static and bool(results[start:start + count].all()))


class BatchVerifier:
    """Accumulates (pub, hash, r, s) items and verifies them in one batch on
    ``device`` at ``flush``."""

    def __init__(self, device: DeviceLike = None) -> None:
        self.device = device
        self._items: List[SigItem] = []

    def add(self, pub: Tuple[int, int], msg_hash: bytes, r: int, s: int) -> int:
        self._items.append((pub, msg_hash, r, s))
        return len(self._items) - 1

    def __len__(self) -> int:
        return len(self._items)

    def flush(self) -> np.ndarray:
        out = batch_verify(self._items, self.device)
        self._items = []
        return out
