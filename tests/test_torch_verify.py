"""Twins of tests/test_ops_verify.py: the port's batched secp256k1 verifier
(``babble_tpu_torch/ops/verify.py`` on ``ops/limbs.py``) held against the
JAX package (``babble_tpu.ops.limbs``, ``verify._prepare``,
``verify._kernel_jit``, ``verify.batch_verify``), the pure-Python oracle
and the native verifier, on the CPU, where the port's ladder is K3's plain
version. Every output is an exact integer or a bool: every comparison is
bit for bit.

Vectors: the JAX tests' 21 (valid signatures; wrong hash, r + 1, s + 1,
r = 0, r = n, s = 0, a wrong key, a key off the curve, Q == -G) and three
whose ladders take the mixed addition's rare cases (P1 == P2, P1 == -P2
then a lift, R at infinity). K3 itself runs in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import hashlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babble_tpu.ops import limbs as jl
from babble_tpu.ops import verify as jv
from babble_tpu_torch import interop, native_crypto
from babble_tpu_torch.crypto import secp256k1 as ref
from babble_tpu_torch.crypto.keys import generate_key
from babble_tpu_torch.hashgraph.event import Event
from babble_tpu_torch.ops import limbs as tl
from babble_tpu_torch.ops import verify as tv
from chip_smoke import (
    field_edge_pairs,
    ladder_edge_items,
    signature_batch,
    verify_vectors,
)
from test_ops_verify import _vectors

CPU = "cpu"
P = tl.P_INT


def _items():
    return verify_vectors() + ladder_edge_items()


def _oracle(items):
    return [ref.verify(*it) for it in items]


def _field_pairs():
    """The 52 pairs of test_limb_field_arithmetic_matches_python_ints, then
    the edges of K3's field layer."""
    random.seed(7)
    xs = [random.randrange(P) for _ in range(48)] + [0, 1, P - 1, P // 2]
    ys = [random.randrange(P) for _ in range(48)] + [P - 1, P - 1, 1, 2]
    return list(zip(xs, ys)) + field_edge_pairs()


def test_vectors_are_the_jax_tests_vectors():
    assert verify_vectors() == _vectors()
    assert len(verify_vectors()) == 21


def test_limb_field_arithmetic_matches_python_ints_and_jax():
    pairs = _field_pairs()
    xs, ys = [x for x, _ in pairs], [y for _, y in pairs]
    a, b = tl.ints_to_limbs(xs), tl.ints_to_limbs(ys)
    assert a.dtype == torch.int32 and tuple(a.shape) == (len(pairs), 16)
    ja, jb = jl.ints_to_limbs(xs), jl.ints_to_limbs(ys)
    np.testing.assert_array_equal(a.numpy(), ja.astype(np.int32))
    ours = {
        "mul_wide": tl.mul_wide(a, b),
        "mul_mod_p": tl.mul_mod_p(a, b),
        "sqr_mod_p": tl.sqr_mod_p(a),
        "add_mod_p": tl.add_mod_p(a, b),
        "sub_mod_p": tl.sub_mod_p(a, b),
    }
    ours["reduce_p"] = tl.reduce_p(ours["mul_wide"])
    theirs = {
        "mul_wide": jax.jit(jl.mul_wide)(ja, jb),
        "mul_mod_p": jax.jit(jl.mul_mod_p)(ja, jb),
        "sqr_mod_p": jax.jit(jl.sqr_mod_p)(ja),
        "add_mod_p": jax.jit(jl.add_mod_p)(ja, jb),
        "sub_mod_p": jax.jit(jl.sub_mod_p)(ja, jb),
    }
    theirs["reduce_p"] = jax.jit(jl.reduce_p)(theirs["mul_wide"])
    for name, got in ours.items():
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(theirs[name]).astype(np.int32),
            err_msg=name)
    want = {
        "mul_wide": lambda x, y: x * y,
        "mul_mod_p": lambda x, y: x * y % P,
        "reduce_p": lambda x, y: x * y % P,
        "sqr_mod_p": lambda x, y: x * x % P,
        "add_mod_p": lambda x, y: (x + y) % P,
        "sub_mod_p": lambda x, y: (x - y) % P,
    }
    for name, fn in want.items():
        got = [tl.limbs_to_int(row) for row in ours[name]]
        assert got == [fn(x, y) for x, y in pairs], name


def test_limb_helpers():
    x = (1 << 255) + 0xBEEF
    assert tl.limbs_to_int(tl.int_to_limbs(x)) == x
    assert tl.limbs_to_int(tl.int_to_limbs(-1)) == (1 << 256) - 1
    assert tl.int_to_limbs(x).tolist() == jl.int_to_limbs(x).tolist()
    a = tl.ints_to_limbs([0, P - 1, 5])
    b = tl.ints_to_limbs([0, P - 1, 6])
    assert tl.is_zero(a).tolist() == [True, False, False]
    assert tl.eq(a, b).tolist() == [True, True, False]
    sel = tl.select(torch.tensor([True, False, True]), a, b)
    assert [tl.limbs_to_int(r) for r in sel] == [0, P - 1, 5]
    assert tl.ints_to_limbs([]).shape == (0, 16)


def test_prepare_equals_jax_prepare():
    items = _items()
    ours = tv._prepare(items, CPU)
    theirs = interop.verify_inputs_from_jax(*jv._prepare(items), device=CPU)
    for name, a, b in zip(tv.VerifyInputs._fields, ours, theirs):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    # Q == -G (vector 20): its G + Q table entry is infinite
    assert ours.pre_ok[20] and ours.table_inf[20].tolist() == [True, False,
                                                              False, True]


def test_verify_inputs_from_jax_refuses_other_arrays():
    arrays = list(jv._prepare(_vectors()[:3]))
    bad = arrays.copy()
    bad[1] = bad[1].astype(np.int64)
    with pytest.raises(TypeError, match="u1"):
        interop.verify_inputs_from_jax(*bad, device=CPU)
    bad = arrays.copy()
    bad[3] = bad[3][:, :3]
    with pytest.raises(ValueError, match="table_x"):
        interop.verify_inputs_from_jax(*bad, device=CPU)
    bad = arrays.copy()
    bad[6] = bad[6].copy()
    bad[6][0, 0] = 1 << 16
    with pytest.raises(ValueError, match="2\\^16"):
        interop.verify_inputs_from_jax(*bad, device=CPU)


def test_ladder_equals_jax_kernel():
    """JAX ``_prepare``'s arrays, carried across by interop, through the
    port's plain ladder and through JAX ``_kernel_jit``: the same [B] bools
    at one padded tile."""
    items = _items()
    dummy = ((ref.GX, ref.GY), b"\x00" * 32, 1, 1)
    items += [dummy] * (jv.TILE - len(items))
    arrays = jv._prepare(items)
    theirs = np.asarray(jv._kernel_jit(*(jnp.asarray(a) for a in arrays[1:])))
    inputs = interop.verify_inputs_from_jax(*arrays, device=CPU)
    ours = tv.shamir(*inputs[1:])
    assert ours.dtype == torch.bool
    np.testing.assert_array_equal(ours.numpy(), theirs)
    n = len(_items())
    assert (ours[:n] & inputs.pre_ok[:n]).tolist() == _oracle(_items())


def test_batch_verify_matches_oracle_jax_and_native():
    items = _items()
    got = tv.batch_verify(items, device=CPU)
    assert got.dtype == np.bool_ and got.shape == (len(items),)
    want = _oracle(items)
    assert got.tolist() == want
    assert jv.batch_verify(items).tolist() == want
    # the ladder's rare cases verify as the oracle says: P1 == P2 and
    # P1 == -P2 then a lift are valid signatures; R at infinity is not
    assert want[-3:] == [True, True, False]
    if native_crypto.available():
        pubs = [x.to_bytes(32, "big") + y.to_bytes(32, "big")
                for (x, y), _, _, _ in items]
        native = native_crypto.verify_batch(
            pubs, [h for _, h, _, _ in items], [(r, s) for *_, r, s in items])
        assert native == want


def test_batch_verify_ragged_batch_of_70():
    """70 items, not a multiple of the JAX package's 64-signature tile: the
    port launches over the real batch and agrees with the JAX package's
    padded tiles, the oracle and the native verifier."""
    items = signature_batch(70, 8, seed=70)
    want = _oracle(items)
    assert 0 < sum(want) < 70
    got = tv.batch_verify(items, device=CPU)
    assert got.shape == (70,)
    assert got.tolist() == want
    assert jv.batch_verify(items).tolist() == want
    if native_crypto.available():
        from chip_smoke import native_verify_items

        assert native_verify_items(items) == want


def _crafted_check_inputs():
    """(X, Z, r, rn, rn_ok) rows that take each branch of the projective
    check, with the verdict of each."""
    rng = random.Random(3)
    Z = rng.randrange(1, P)
    z2 = Z * Z % P
    r = rng.randrange(1, P - ref.N)  # so that r + n < p
    rn = r + ref.N
    rows = [
        (0, 0, r, rn, True, False),  # Z = 0: infinity, whatever X is
        (r * z2 % P, Z, r, rn, False, True),  # X = r Z^2
        (rn * z2 % P, Z, r, rn, True, True),  # X = (r + n) Z^2, r + n < p
        (rn * z2 % P, Z, r, rn, False, False),  # the same with r + n >= p
        ((r + 1) * z2 % P, Z, r, rn, True, False),  # neither
    ]
    cols = list(zip(*rows))
    limbs = [tl.ints_to_limbs(c) for c in cols[:4]]
    return (*limbs, torch.tensor(cols[4]), list(cols[5]))


def test_projective_check_branches():
    """The ladder's last step alone: not infinity, and X == r Z^2 or, where
    r + n < p, X == (r + n) Z^2. Real signatures never reach the r + n
    branch (x(R) >= n has probability about 2^-128), so crafted limbs take
    each branch."""
    X, Z, r, rn, rn_ok, want = _crafted_check_inputs()
    assert tv.projective_check(X, Z, r, rn, rn_ok).tolist() == want
    # as the JAX kernel computes it on the same limbs
    jX, jZ, jr, jrn = (jnp.asarray(t.numpy().astype(np.uint32))
                       for t in (X, Z, r, rn))
    jZ2 = jl.sqr_mod_p(jZ)
    theirs = ~jl.is_zero(jZ) & (
        jl.eq(jX, jl.mul_mod_p(jr, jZ2))
        | (jl.eq(jX, jl.mul_mod_p(jrn, jZ2)) & jnp.asarray(rn_ok.numpy())))
    assert np.asarray(theirs).tolist() == want


def test_shamir_refuses_what_it_cannot_take():
    inputs = tv._prepare(verify_vectors()[:2], CPU)
    args = list(inputs[1:])
    with pytest.raises(TypeError, match="u2"):
        tv.shamir(args[0], args[1].long(), *args[2:])
    with pytest.raises(ValueError, match="table_x"):
        tv.shamir(*args[:2], args[2][:, :3], *args[3:])
    with pytest.raises(TypeError, match="rn_ok"):
        tv.shamir(*args[:7], args[7].int())
    with pytest.raises(ValueError, match="CUDA"):
        from babble_tpu_torch.ops import kernels

        kernels.ecdsa_shamir(*args)


def test_batch_verify_empty():
    assert tv.batch_verify([], device=CPU).shape == (0,)


def test_prevalidate_events_caches_batch_verdicts():
    keys = [generate_key() for _ in range(3)]
    events = []
    for i, k in enumerate(keys):
        ev = Event.new(
            [f"tx {i}".encode()], [], [], ["", ""], k.public_key.bytes(), 0
        )
        ev.sign(k)
        events.append(ev)
    # corrupt the middle event's signature
    good_sig = events[1].signature
    events[1].signature = events[0].signature

    tv.prevalidate_events(events, device=CPU)
    assert events[0].verify() is True
    assert events[1].verify() is False
    assert events[2].verify() is True

    # cache is sticky until prevalidate is called again with the fix
    events[1].signature = good_sig
    assert events[1].verify() is False
    tv.prevalidate_events([events[1]], device=CPU)
    assert events[1].verify() is True


def test_batch_verifier_accumulator():
    bv = tv.BatchVerifier(device=CPU)
    d = 0xC0FFEE
    pub = ref.pubkey_from_scalar(d)
    h = hashlib.sha256(b"accumulate").digest()
    r, s = ref.sign(d, h)
    i0 = bv.add(pub, h, r, s)
    i1 = bv.add(pub, h, r + 1, s)
    assert len(bv) == 2
    out = bv.flush()
    assert bool(out[i0]) is True
    assert bool(out[i1]) is False
    assert len(bv) == 0


def test_core_device_verify_on_cpu_takes_the_host_batch_verifier(monkeypatch):
    """``--accelerator`` with BABBLE_DEVICE_VERIFY=1 and the CPU named as the
    accelerator device: the core starts, and its sync chunks go through the
    native host batch verifier, as the JAX package's do on its CPU
    fallback; the offender is found by its single re-check."""
    from babble_tpu_torch.node.core import Core
    from babble_tpu_torch.hashgraph.store import InmemStore
    from babble_tpu_torch.node.validator import Validator
    from babble_tpu_torch.peers.peer import Peer
    from babble_tpu_torch.peers.peer_set import PeerSet
    from babble_tpu_torch.proxy.proxy import dummy_commit_response

    monkeypatch.setenv("BABBLE_DEVICE_VERIFY", "1")
    key = generate_key()
    peers = PeerSet([Peer("", key.public_key.hex(), "")])
    core = Core(Validator(key, ""), peers, peers, InmemStore(100),
                dummy_commit_response, accelerated_verify=True,
                accelerator_device=CPU)
    assert not core._device_verify()

    def refuse(*_args, **_kw):
        raise AssertionError("the device verifier ran on the CPU")

    monkeypatch.setattr(tv, "prevalidate_events", refuse)
    events = []
    for i in range(4):
        k = generate_key()
        ev = Event.new([f"tx {i}".encode()], [], [], ["", ""],
                       k.public_key.bytes(), 0)
        ev.sign(k)
        events.append(ev)
    events[1].signature = events[3].signature
    core._batch_prevalidate(events)
    if native_crypto.available():
        assert [ev.prevalidated() for ev in events] == [True, False, True,
                                                       True]
        assert core.ingest_batch_verifies == 1
        assert core.ingest_fallback_singles == 1
    else:  # no host batch verifier: insert verifies each event itself
        assert [ev.prevalidated() for ev in events] == [None] * 4
