"""K1 of the PyTorch port (babble_tpu_torch.ops.kernels.member_ss_counts)
against the JAX package's Pallas kernel in interpreter mode and its einsum
branch, bit for bit, on the same seeded numpy inputs.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel
itself is held against that plain version on the card by chip_smoke.py and
by tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babble_tpu.ops.pallas_kernels import (
    member_ss_counts_pallas,
    strongly_see_pallas,
)
from babble_tpu_torch.ops import kernels

from chip_smoke import edge_coordinates, edge_super_majority, k1_edge_inputs

INT32_MAX = np.int32(2**31 - 1)

SHAPES = [(16, 4, 1), (32, 13, 2), (64, 40, 4), (128, 21, 3), (256, 16, 1)]
# edge-value shapes: P = 1, P off every multiple of 8 and 16, S up to 3
EDGE_SHAPES = [(16, 4, 1), (37, 13, 3), (64, 1, 2), (70, 17, 2),
               (128, 33, 1)]


def _inputs(W, P, S, seed=7):
    """Random coordinates with both sentinels mixed in, as the Pallas
    kernel's own test makes them."""
    rng = np.random.RandomState(seed + W + P + S)
    la = rng.randint(-1, 50, size=(W, P)).astype(np.int32)
    fd = rng.randint(0, 50, size=(W, P)).astype(np.int32)
    fd[rng.rand(W, P) < 0.3] = INT32_MAX
    la[rng.rand(W, P) < 0.1] = -1
    member = rng.rand(S, P) < 0.7
    return la, fd, member


@pytest.mark.parametrize("W,P,S", SHAPES)
def test_member_ss_counts_matches_pallas_and_einsum(W, P, S):
    la, fd, member = _inputs(W, P, S)
    want = np.asarray(
        member_ss_counts_pallas(
            jnp.asarray(la), jnp.asarray(fd), jnp.asarray(member),
            interpret=True,
        )
    )
    # the einsum branch of the JAX sweep (babble_tpu/ops/voting.py:198-204)
    ge = (jnp.asarray(la)[:, None, :] >= jnp.asarray(fd)[None, :, :])
    einsum = np.asarray(jnp.einsum(
        "vwp,sp->svw", ge.astype(jnp.int8),
        jnp.asarray(member).astype(jnp.int8),
        preferred_element_type=jnp.int32,
    ))
    np.testing.assert_array_equal(einsum, want)

    got = kernels.member_ss_counts(
        torch.from_numpy(la), torch.from_numpy(fd), torch.from_numpy(member)
    )
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (S, W, W)
    np.testing.assert_array_equal(got.numpy(), want)


def test_member_ss_counts_rejects_bad_inputs():
    la, fd, member = (torch.from_numpy(a) for a in _inputs(16, 8, 2))
    with pytest.raises(TypeError):
        kernels.member_ss_counts(la.to(torch.int64), fd, member)
    with pytest.raises(TypeError):
        kernels.member_ss_counts(la, fd.to(torch.float32), member)
    with pytest.raises(TypeError):
        kernels.member_ss_counts(la, fd, member.to(torch.uint8))
    with pytest.raises(ValueError):  # P differs (V and W may)
        kernels.member_ss_counts(la, fd[:, :4], member)
    with pytest.raises(ValueError):
        kernels.member_ss_counts(la, fd[None], member)
    with pytest.raises(ValueError):
        kernels.member_ss_counts(la, fd, member[:, :4])
    with pytest.raises(ValueError):
        kernels.member_ss_counts(la[0], fd[0], member)


def test_member_ss_counts_cpu_takes_plain_version_without_launch():
    """CPU tensors run the plain version and count no kernel launch."""
    la, fd, member = (torch.from_numpy(a) for a in _inputs(32, 8, 2))
    kernels.reset_launch_counts()
    got = kernels.member_ss_counts(la, fd, member)
    assert torch.equal(got, kernels.member_ss_counts_plain(la, fd, member))
    assert kernels.launch_counts() == {"member_ss_counts": 0,
                                      "strongly_see": 0,
                                      "strongly_see_block": 0,
                                      "ecdsa_shamir": 0, "field_ops": 0}



def _pallas(la, fd, member):
    return np.asarray(member_ss_counts_pallas(
        jnp.asarray(la), jnp.asarray(fd), jnp.asarray(member),
        interpret=True,
    ))


@pytest.mark.parametrize("W,P,S", EDGE_SHAPES)
def test_member_ss_counts_edge_values_match_pallas(W, P, S):
    """Coordinates near the int32 edges (bases 0, 2^24 - 3, 2^31 - 2^12
    and 2^12 - 2^31, INT32_MIN, ties la == fd) with both sentinels, la
    below INT32_MAX: the plain version, and the wrapper on the CPU, equal
    the Pallas kernel bit for bit."""
    la, fd, member = k1_edge_inputs(W, P, S, seed=W * P + S)
    assert la.max() < INT32_MAX and (la == fd).any()
    assert (la == -1).any() and (fd == INT32_MAX).any()
    want = _pallas(la, fd, member)
    t = [torch.from_numpy(a) for a in (la, fd, member)]
    np.testing.assert_array_equal(
        kernels.member_ss_counts_plain(*t).numpy(), want)
    np.testing.assert_array_equal(kernels.member_ss_counts(*t).numpy(), want)


def test_member_ss_counts_domain_is_la_below_int32_max():
    """K1's stated domain: the Pallas wrapper folds membership into fd as
    INT32_MAX, so a non-member peer still counts where la == INT32_MAX;
    the plain version multiplies by member and does not. Below INT32_MAX
    the two agree."""
    la = np.array([[INT32_MAX, 5]], dtype=np.int32)
    fd = np.array([[INT32_MAX, 5]], dtype=np.int32)
    member = np.array([[False, True]])
    t = [torch.from_numpy(a) for a in (la, fd, member)]
    assert _pallas(la, fd, member).tolist() == [[[2]]]
    assert kernels.member_ss_counts_plain(*t).tolist() == [[[1]]]
    la[0, 0] = INT32_MAX - 1
    t[0] = torch.from_numpy(la)
    assert _pallas(la, fd, member).tolist() == [[[1]]]
    assert kernels.member_ss_counts_plain(*t).tolist() == [[[1]]]


# -- the batch axis (the sweep batcher's batched sweep) -----------------------

# (B, W, P, S): B 1, 3 and 16, ragged W and P, S up to 3
BATCH_SHAPES = [(1, 16, 4, 1), (3, 37, 13, 3), (3, 64, 17, 2),
                (16, 16, 8, 1), (16, 32, 16, 2)]


def _batch_inputs(B, W, P, S, values):
    """B windows of K1 inputs, each made as the single-window tests make
    theirs (random, or at the int32 edges with la below INT32_MAX)."""
    if values == "random":
        parts = [_inputs(W, P, S, seed=b) for b in range(B)]
    else:
        parts = [k1_edge_inputs(W, P, S, seed=W * P + S + b)
                 for b in range(B)]
    return tuple(np.stack(a) for a in zip(*parts))


@pytest.mark.parametrize("values", ["random", "edge"])
@pytest.mark.parametrize("B,W,P,S", BATCH_SHAPES)
def test_member_ss_counts_batched_matches_vmapped_pallas(B, W, P, S, values):
    """The batched plain version, and the wrapper on the CPU, equal the
    Pallas kernel vmapped over the batch (as jax.vmap of the fused sweep
    carries it, babble_tpu/ops/voting.py:319-323) in interpreter mode and
    the vmapped einsum, bit for bit; each window equals its own 2-D call."""
    la, fd, member = _batch_inputs(B, W, P, S, values)
    jla, jfd, jmember = (jnp.asarray(a) for a in (la, fd, member))
    want = np.asarray(jax.vmap(
        lambda a, b, m: member_ss_counts_pallas(a, b, m, interpret=True)
    )(jla, jfd, jmember))
    ge = (jla[:, :, None, :] >= jfd[:, None, :, :]).astype(jnp.int8)
    einsum = np.asarray(jnp.einsum(
        "bvwp,bsp->bsvw", ge, jmember.astype(jnp.int8),
        preferred_element_type=jnp.int32,
    ))
    np.testing.assert_array_equal(einsum, want)

    t = [torch.from_numpy(a) for a in (la, fd, member)]
    plain = kernels.member_ss_counts_plain(*t)
    assert plain.dtype == torch.int32 and tuple(plain.shape) == (B, S, W, W)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(kernels.member_ss_counts(*t).numpy(), want)
    for b in range(B):
        assert torch.equal(
            plain[b], kernels.member_ss_counts_plain(t[0][b], t[1][b],
                                                     t[2][b]))


def test_member_ss_counts_batched_rejects_bad_inputs():
    la, fd, member = (torch.from_numpy(a)
                      for a in _batch_inputs(3, 16, 8, 2, "random"))
    kernels.member_ss_counts(la, fd, member)  # [B, W, P] and [B, S, P]
    with pytest.raises(ValueError):
        kernels.member_ss_counts(la, fd, member[0])  # a 2-D member
    with pytest.raises(ValueError):
        kernels.member_ss_counts(la, fd, member[:2])  # B differs
    with pytest.raises(ValueError):
        kernels.member_ss_counts(la, fd[:2], member)
    with pytest.raises(ValueError):
        kernels.member_ss_counts(la[None], fd[None], member[None])


# -- the rectangular forms (the multi-device paths) ----------------------------

# (W, P, S) of the full problem and the V voter rows [v0, v0 + V) a shard
# takes: the sharded sweep's W/N rows at N = 2, 4 and 8, and a ragged one
RECT_K1 = [(32, 16, 1, 0, 16), (64, 13, 2, 16, 16), (64, 40, 3, 56, 8),
           (48, 17, 2, 5, 37)]


@pytest.mark.parametrize("values", ["random", "edge"])
@pytest.mark.parametrize("W,P,S,v0,V", RECT_K1)
def test_member_ss_counts_rectangular_matches_pallas_rows(W, P, S, v0, V,
                                                          values):
    """K1 of V voter rows against W candidates (V != W) equals rows
    v0 .. v0 + V of the Pallas kernel's square result on the whole window
    (interpreter mode) and numpy, the plain version and the CPU wrapper
    alike; a batch of such blocks equals each block."""
    make = _inputs if values == "random" else (
        lambda W, P, S: k1_edge_inputs(W, P, S, seed=W + P + S))
    la, fd, member = make(W, P, S)
    want = _pallas(la, fd, member)[:, v0:v0 + V]
    ref = ((la[v0:v0 + V, None, :] >= fd[None, :, :])[None]
           & member[:, None, None, :]).sum(-1)
    np.testing.assert_array_equal(ref, want)
    t = [torch.from_numpy(a) for a in (la[v0:v0 + V].copy(), fd, member)]
    got = kernels.member_ss_counts(*t)
    assert got.dtype == torch.int32 and tuple(got.shape) == (S, V, W)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(kernels.member_ss_counts_plain(*t).numpy(),
                                  want)
    batch = kernels.member_ss_counts(t[0][None].repeat(2, 1, 1),
                                     t[1][None].repeat(2, 1, 1),
                                     t[2][None].repeat(2, 1, 1))
    assert tuple(batch.shape) == (2, S, V, W)
    for b in range(2):
        np.testing.assert_array_equal(batch[b].numpy(), want)


# (E, P, x0, X, y0, Y, ldo, col0): a shard's rows against every candidate,
# one ring step's column block written at an offset of a wider row, ragged
RECT_K2 = [(64, 16, 16, 16, 0, 64, 64, 0), (64, 13, 0, 16, 48, 16, 64, 48),
           (96, 6, 40, 24, 8, 37, 100, 60), (32, 40, 0, 32, 0, 32, 96, 33)]


@pytest.mark.parametrize("values", ["random", "edge"])
@pytest.mark.parametrize("E,P,x0,X,y0,Y,ldo,col0", RECT_K2)
def test_strongly_see_block_matches_pallas_sub_block(E, P, x0, X, y0, Y, ldo,
                                                     col0, values):
    """K2's block form, la rows [x0, x0 + X) against fd rows [y0, y0 + Y)
    written into columns col0 .. col0 + Y of a bool output with rows ldo
    long, equals that sub-block of the Pallas kernel's square result on
    the whole [E, P] coordinates (interpreter mode) and numpy, and leaves
    every other column as it was; without an output it returns the
    [X, Y] block."""
    rng = np.random.RandomState(E + P + X + Y)
    if values == "random":
        la = rng.randint(-1, 40, size=(E, P)).astype(np.int32)
        fd = rng.randint(0, 40, size=(E, P)).astype(np.int32)
        fd[rng.rand(E, P) < 0.25] = INT32_MAX
        sm = 2 * P // 3 + 1
    else:
        la, fd = edge_coordinates((E, P), seed=E * P)
        sm = edge_super_majority(la, fd)
    full = np.asarray(strongly_see_pallas(jnp.asarray(la), jnp.asarray(fd),
                                          sm, interpret=True))
    want = full[x0:x0 + X, y0:y0 + Y]
    ref = (la[x0:x0 + X, None, :] >= fd[None, y0:y0 + Y, :]).sum(-1) >= sm
    np.testing.assert_array_equal(ref, want)
    a = torch.from_numpy(la[x0:x0 + X].copy())
    f = torch.from_numpy(fd[y0:y0 + Y].copy())
    before = torch.from_numpy(rng.rand(X, ldo) < 0.5)
    for fn in (kernels.strongly_see_block, kernels.strongly_see_block_plain):
        out = before.clone()
        assert fn(a, f, sm, out, col0) is out
        np.testing.assert_array_equal(out[:, col0:col0 + Y].numpy(), want)
        rest = np.ones(ldo, bool)
        rest[col0:col0 + Y] = False
        np.testing.assert_array_equal(out[:, rest].numpy(),
                                      before[:, rest].numpy())
        np.testing.assert_array_equal(fn(a, f, sm).numpy(), want)
    batch = kernels.strongly_see_block(a[None].repeat(3, 1, 1),
                                       f[None].repeat(3, 1, 1), sm)
    assert tuple(batch.shape) == (3, X, Y)
    for b in range(3):
        np.testing.assert_array_equal(batch[b].numpy(), want)


def test_strongly_see_block_refuses_what_it_cannot_take():
    a = torch.zeros((8, 4), dtype=torch.int32)
    f = torch.zeros((16, 4), dtype=torch.int32)
    out = torch.zeros((8, 32), dtype=torch.bool)
    kernels.strongly_see_block(a, f, 1, out, 16)  # columns 16..32 fit
    with pytest.raises(ValueError, match="fit"):
        kernels.strongly_see_block(a, f, 1, out, 17)
    with pytest.raises(ValueError, match="fit"):
        kernels.strongly_see_block(a, f, 1, out, -1)
    with pytest.raises(ValueError, match="offset"):
        kernels.strongly_see_block(a, f, 1, None, 4)
    with pytest.raises(TypeError):
        kernels.strongly_see_block(a, f, 1, out.int(), 0)
    with pytest.raises(ValueError):
        kernels.strongly_see_block(a, f, 1, out[:4], 0)  # X differs
    with pytest.raises(ValueError):
        kernels.strongly_see_block(a, f[:, :3], 1)  # P differs
    with pytest.raises(TypeError):
        kernels.strongly_see_block(a.long(), f, 1)
    # the square form keeps its square contract
    with pytest.raises(ValueError):
        kernels.strongly_see(a, f, 1)
