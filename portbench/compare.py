"""The numbers that decide ``correct``: gaps between the program's readings
and the reference's."""

from __future__ import annotations

import numpy as np
import torch


def rel_gap(program: float, reference: float) -> float:
    """|program - reference| / |reference|."""
    return abs(program - reference) / max(abs(reference), 1e-30)


def leaf_norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def worst_leaf_gap(program: dict, reference: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap of norms: |norm_p - norm_r| over the larger of
    the reference leaf's norm and the median reference leaf's norm.
    ``program`` and ``reference`` map leaf names to norms; ``keep`` limits
    the leaves compared. Returns (gap, leaf)."""
    names = [k for k in reference if keep is None or k in keep]
    median = float(np.median([reference[k] for k in names]))
    worst, leaf = 0.0, ""
    for k in names:
        gap = abs(program[k] - reference[k]) / max(reference[k], median, 1e-30)
        if gap > worst or not np.isfinite(gap):
            worst, leaf = gap, k
    return worst, leaf


def median_leaf_gap(program: dict, reference: dict, keep) -> float:
    """The median over the leaves in ``keep`` of the gap of norms, each
    over the larger of the reference leaf's norm and the median leaf's."""
    names = sorted(keep)
    median = float(np.median([reference[k] for k in names]))
    return float(np.median([abs(program[k] - reference[k]) / max(reference[k], median, 1e-30)
                            for k in names]))


def moved_leaves(first_grad: dict, floor: float = 1e-3) -> set:
    """The leaves whose first reference gradient is not nought to rounding:
    a norm of at least ``floor`` times the median leaf's."""
    median = float(np.median(list(first_grad.values())))
    return {k for k, v in first_grad.items() if v >= floor * median}
