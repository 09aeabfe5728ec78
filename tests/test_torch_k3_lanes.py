"""The G-lane schedule of K3's cooperative field layer
(``babble_tpu_torch/ops/lanes.py``, the model of
``csrc/ecdsa_verify.cu``'s field functions) held against Python integers on
the CPU, at every group size K3 launches: the per-lane rows, the column
sums across lanes, the carries settled by ballots, the folds and the final
subtract of p. Add and subtract are held against the JAX package's
add_mod_p and sub_mod_p too, on non-canonical operands, where they differ
from a + b and a - b mod p. The card runs the same schedule in
tests/test_torch_cuda.py (``bt_field_ops``). Last, the count of multiply
instructions that the schedule does, which stands beside K3's bound."""

from __future__ import annotations

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from babble_tpu.ops import limbs as jl
from babble_tpu_torch.ops import lanes
from babble_tpu_torch.ops.kernels import ECDSA_GROUPS
from chip_smoke import (
    MULS_PER_FIELD_MUL,
    add_mod_p_int,
    field_edge_pairs,
    k3_field_muls,
    k3_own_muls,
    ladder_edge_items,
    noncanonical_pairs,
    signature_batch,
    sub_mod_p_int,
)

P = lanes.P_INT
WANT = {
    "mul": lambda x, y: x * y % P,
    "sqr": lambda x, y: x * x % P,
    "add": add_mod_p_int,
    "sub": sub_mod_p_int,
}
WORD = st.sampled_from([0, 1, 977, 0xFFFFFC2F, 0xFFFFFFFE, 0xFFFFFFFF])
# 256-bit values: uniform, or built from edge words (runs of all-ones words
# and zeros are where carries ripple across lanes)
U256 = st.one_of(
    st.integers(0, 2**256 - 1),
    st.lists(WORD, min_size=8, max_size=8).map(
        lambda ws: sum(w << (32 * j) for j, w in enumerate(ws))),
)


def test_groups_are_the_kernels():
    assert lanes.GROUPS == ECDSA_GROUPS


@pytest.mark.parametrize("group", ECDSA_GROUPS)
def test_split_and_join(group):
    x = (1 << 255) + (0xDEADBEEF << 64) + 977
    parts = lanes.split(x, group)
    assert len(parts) == group and all(len(p) == 8 // group for p in parts)
    assert lanes.join(parts) == x
    assert lanes.join(lanes.split(P, group)) == P


@pytest.mark.parametrize("group", ECDSA_GROUPS)
@pytest.mark.parametrize("op", sorted(WANT))
def test_edges_equal_python_ints(group, op):
    """The edges of chip_smoke.field_edge_pairs: both folds, the final
    subtract, a second fold that carries out of 2^256."""
    for x, y in field_edge_pairs():
        assert lanes.field_op(op, x, y, group) == WANT[op](x, y), (x, y)


@pytest.mark.parametrize("group", ECDSA_GROUPS)
@pytest.mark.parametrize("op", ["add", "sub"])
def test_noncanonical_add_sub_equal_the_jax_semantics(group, op):
    """Operands at or above p: s - p (mod 2^256) where s = a + b reaches p
    or 2^256, and a + ((p - b) mod 2^256), as the JAX package computes."""
    pairs = noncanonical_pairs()
    got = [lanes.field_op(op, x, y, group) for x, y in pairs]
    assert got == [WANT[op](x, y) for x, y in pairs]
    xs, ys = [x for x, _ in pairs], [y for _, y in pairs]
    fn = jax.jit(jl.add_mod_p if op == "add" else jl.sub_mod_p)
    theirs = np.asarray(fn(jl.ints_to_limbs(xs), jl.ints_to_limbs(ys)))
    assert got == [jl.limbs_to_int(row) for row in theirs]


@pytest.mark.parametrize("group", ECDSA_GROUPS)
@pytest.mark.parametrize("op", sorted(WANT))
@settings(max_examples=40, deadline=None)
@given(x=U256, y=U256)
def test_drawn_pairs_equal_python_ints(group, op, x, y):
    assert lanes.field_op(op, x, y, group) == WANT[op](x, y)


@pytest.mark.parametrize("group", ECDSA_GROUPS)
def test_resolve_settles_carries_across_the_group(group):
    """A carry out of lane 0 ripples through lanes of all-ones words to the
    top and out of it; an all-ones lane without a carry below stays;
    a carry out of a lane with no all-ones lanes above stops at the next."""
    W = 8 // group
    ones = [lanes.M32] * W
    full = [ones] * group
    rip = [[0] * W] + [ones] * (group - 1)
    out, top = lanes.resolve([list(w) for w in rip], [1] + [0] * (group - 1))
    assert top == 1 and all(w == [0] * W for w in out)
    out, top = lanes.resolve([list(w) for w in full], [0] * group)
    assert top == 0 and out == full
    low = [[5] + [0] * (W - 1) for _ in range(group)]
    out, top = lanes.resolve([list(w) for w in low], [1] * group)
    assert top == 1
    assert out[0] == low[0] and all(w[0] == 6 for w in out[1:])


@pytest.mark.parametrize("group", ECDSA_GROUPS)
def test_is_zero_and_select(group):
    assert lanes.is_zero(lanes.split(0, group))
    assert not lanes.is_zero(lanes.split(1 << 255, group))
    a, b = lanes.split(3, group), lanes.split(P - 1, group)
    assert lanes.join(lanes.select(True, a, b)) == 3
    assert lanes.join(lanes.select(False, a, b)) == P - 1


@pytest.mark.parametrize("group", ECDSA_GROUPS)
def test_own_multiply_count_beside_the_bound(group):
    """chip_smoke.k3_own_muls, K3's own count of multiply instructions,
    against a walk of each signature's ladder: 256 doublings (2M + 5S), a
    mixed addition (8M + 3S) at each finite table entry after the first,
    the check (2M + S) where one was finite; a multiplication 128
    instructions, a square 72 at one lane (36 products) and 128 at four.
    At four lanes it is the bound's count."""
    from babble_tpu_torch.ops import verify

    items = signature_batch(13, 4, seed=3) + ladder_edge_items()
    inputs = verify._prepare(items, "cpu")
    sq = {1: 72, 4: 128}[group]
    want = 0
    for b in range(len(items)):
        u1 = sum(int(v) << (16 * i) for i, v in enumerate(inputs.u1[b]))
        u2 = sum(int(v) << (16 * i) for i, v in enumerate(inputs.u2[b]))
        finite = [sel != 0 and not bool(inputs.table_inf[b, sel])
                  for sel in (((u1 >> i) & 1) | (((u2 >> i) & 1) << 1)
                              for i in range(256))]
        n = sum(finite)
        mul, sqr = 256 * 2 + 8 * max(n - 1, 0), 256 * 5 + 3 * max(n - 1, 0)
        if n:
            mul, sqr = mul + 2, sqr + 1
        want += 128 * mul + sq * sqr
    assert k3_own_muls(inputs, group) == want
    if group == 4:
        assert want == k3_field_muls(inputs) * MULS_PER_FIELD_MUL
