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

INT32_MAX = np.int32(2**31 - 1)

SHAPES = [(16, 4, 1), (32, 13, 2), (64, 40, 4), (128, 21, 3), (256, 16, 1)]


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

