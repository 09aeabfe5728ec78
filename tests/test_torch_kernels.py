"""K1 of the PyTorch port (babble_tpu_torch.ops.kernels.member_ss_counts)
against the JAX package's Pallas kernel in interpreter mode and its einsum
branch, bit for bit, on the same seeded numpy inputs.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel
itself is held against that plain version on the card by chip_smoke.py and
by tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babble_tpu.ops.pallas_kernels import member_ss_counts_pallas
from babble_tpu_torch.ops import kernels

from chip_smoke import k1_edge_inputs

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
    with pytest.raises(ValueError):
        kernels.member_ss_counts(la, fd[:8], member)
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
                                      "strongly_see": 0}



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
