"""The rules the auction kernel must keep, pinned on the CPU: tie-heavy
costs give the JAX package's assignment and prices exactly, and the
kernel's one-pass (best, lowest column, second best) scan with its merge
rule is the argmax / masked max of ``_auction_phase`` whatever the order of
the merges. The kernel itself is held against the plain version on the card
in test_torch_kernels_gpu.py, at every cluster size."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from shwd_torch.ops import auction as ta
from shwd_tpu.ops import auction as ja


def _tie_costs(kind, b, n, seed):
    """Small-integer entries (ties in every row), optionally with duplicated
    rows (persons that bid alike) and duplicated columns (objects of equal
    value)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, size=(b, n, n)).astype(np.float32)
    if "rows" in kind:
        c[:, 1] = c[:, 0]
        c[:, n - 1] = c[:, n // 2]
    if "cols" in kind:
        c[:, :, 3] = c[:, :, 2]
        c[:, :, n - 2] = c[:, :, 0]
    return c


@pytest.mark.parametrize("kind,n,seed", [
    ("integers", 16, 0), ("integers", 61, 1),
    ("rows", 24, 2), ("cols", 24, 3),
    ("rows+cols", 24, 4), ("rows+cols", 61, 21),
    ("rows+cols", 12, 21),          # two items end at the sweep cap, unassigned persons and all
])
def test_tie_heavy_costs_match_jax_exactly(kind, n, seed):
    """Lowest column on a value tie, lowest person on a bid tie, the bid's
    f32 arithmetic in the JAX order: the same assignment and the same
    prices, to the bit."""
    c = _tie_costs(kind, 3, n, seed)
    a1, p1, _ = ja.auction_assignment(jnp.asarray(c), 1e-7, max_sweeps=4000)
    a2, p2, _ = ta.auction_assignment_reference(torch.from_numpy(c), 1e-7,
                                                max_sweeps=4000)
    np.testing.assert_array_equal(a2.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(p2.numpy(), np.asarray(p1))


def test_tie_heavy_seeded_solve_matches_jax_exactly():
    """A seeded solve on a tie-heavy cost: the screen and the repair give
    the JAX package's result exactly."""
    c = _tie_costs("rows+cols", 2, 24, 5)
    seed = np.tile(np.arange(24, dtype=np.int32)[::-1].copy(), (2, 1))
    prices0 = np.random.default_rng(6).integers(0, 3, size=(2, 24)).astype(np.float32)
    kw = dict(eps0=np.float32(0.25), max_sweeps=4000)
    a1, p1, _ = ja.auction_assignment(jnp.asarray(c), 1e-6, prices0=jnp.asarray(prices0),
                                      assign0=jnp.asarray(seed), **kw)
    a2, p2, _ = ta.auction_assignment_reference(
        torch.from_numpy(c), 1e-6, prices0=torch.from_numpy(prices0),
        assign0=torch.from_numpy(seed), **kw)
    np.testing.assert_array_equal(a2.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(p2.numpy(), np.asarray(p1))


def _scan_chunks(value: torch.Tensor, chunk: int, order=None):
    """The auction kernel's one-pass row scan, in plain PyTorch. Each run of
    ``chunk`` columns carries (best value, its lowest column, best of its
    other columns); runs are merged in ``order`` (default: as they lie)
    by the kernel's rule: the higher best wins, the lower column on a tie,
    and second = max(the winner's second, the loser's best). Returns
    (best, jbest, second) of (..., N) values, second floored at -1e30:
    the argmax and masked max of ``_auction_phase``, whatever the order."""
    n = value.shape[-1]
    lead = value.shape[:-1]
    inf = float("inf")
    best = torch.full(lead, -inf, dtype=value.dtype)
    second = torch.full(lead, -inf, dtype=value.dtype)
    jbest = torch.full(lead, torch.iinfo(torch.int64).max, dtype=torch.int64)
    starts = list(range(0, n, chunk))
    for k in (range(len(starts)) if order is None else order):
        v = value[..., starts[k]:starts[k] + chunk]
        c_best = torch.amax(v, dim=-1)
        c_j = torch.argmax(v, dim=-1)
        c_second = torch.amax(v.scatter(-1, c_j[..., None], -inf), dim=-1)
        c_j = c_j + starts[k]
        take = (c_best > best) | ((c_best == best) & (c_j < jbest))
        loser = torch.where(take, best, c_best)
        best = torch.where(take, c_best, best)
        jbest = torch.where(take, c_j, jbest)
        second = torch.maximum(torch.where(take, c_second, second), loser)
    return best, jbest, torch.clamp_min(second, ta._NEG)


def _argmax_and_masked_max(value):
    """What ``_auction_phase`` computes for every row."""
    best = torch.amax(value, dim=-1)
    jbest = torch.argmax(value, dim=-1)
    second = torch.amax(value.scatter(-1, jbest[..., None], ta._NEG), dim=-1)
    return best, jbest, second


@pytest.mark.parametrize("n,chunk", [(1, 1), (7, 1), (37, 5), (128, 32), (1200, 38),
                                     (1200, 128)])
@pytest.mark.parametrize("order", ["forward", "reverse", "shuffled"])
def test_one_pass_scan_is_argmax_and_masked_max(n, chunk, order):
    """Rows of small integers (the best value repeats within and across
    chunks): carrying (best, lowest column, second) per chunk and merging
    with 'higher best wins, lower column on a tie, second = max(winner's
    second, loser's best)' gives the two-pass result exactly, in any merge
    order."""
    rng = np.random.default_rng(n * 131 + chunk)
    value = torch.from_numpy(rng.integers(-2, 3, size=(40, n)).astype(np.float32))
    chunks = list(range(-(-n // chunk)))
    if order == "reverse":
        chunks = chunks[::-1]
    elif order == "shuffled":
        chunks = rng.permutation(len(chunks)).tolist()
    got = _scan_chunks(value, chunk, chunks)
    for a, b in zip(got, _argmax_and_masked_max(value)):
        assert torch.equal(a, b)


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_one_pass_scan_property(data):
    """The same, over drawn shapes, chunk widths, merge orders and values
    from a three-letter alphabet with an occasional -inf."""
    n = data.draw(st.integers(1, 70))
    chunk = data.draw(st.integers(1, 16))
    rows = data.draw(st.lists(st.lists(st.sampled_from([0.0, 0.5, 1.0, float("-inf")]),
                                       min_size=n, max_size=n), min_size=1, max_size=4))
    order = data.draw(st.permutations(range(-(-n // chunk))))
    value = torch.tensor(rows, dtype=torch.float32)
    got = _scan_chunks(value, chunk, list(order))
    want = _argmax_and_masked_max(value)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    # an all -inf row has no winner in either form; elsewhere the columns agree
    live = torch.isfinite(want[0])
    assert torch.equal(got[1][live], want[1][live])


@pytest.mark.parametrize("batch,want", [(1, 16), (8, 16), (9, 1), (16, 1), (17, 1),
                                        (33, 1), (34, 1), (66, 1), (67, 1), (128, 1),
                                        (4096, 1)])
def test_cluster_size_follows_the_batch(batch, want):
    """16 CTAs per problem while batch * 16 <= 132 SMs and the card reports
    room for a cluster of 16, else one."""
    assert ta._pick_cluster(batch, 132, lambda: True) == want
    assert ta._pick_cluster(batch, 132, lambda: False) == 1
