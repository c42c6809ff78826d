"""The comparisons that decide ``correct``.

Training numbers are gaps of norms, taken by the worst leaf: for each
leaf, the distance between the program's norm and the reference's,
over the reference's norm of that leaf or of the median leaf, whichever
is larger (some gradients are all but zero). Leaves whose reference
gradient is under a thousandth of the median leaf's are left out: they
move by round-off alone.
"""

from __future__ import annotations

import statistics

import torch

#: a leaf whose reference gradient is under this share of the median
#: leaf's moves by round-off alone and is left out
ROUNDOFF_SHARE = 1e-3


def norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in leaves.items()}


def moving_leaves(ref_grad: dict) -> list[str]:
    """The leaves the comparison counts, by the rule on the reference's
    first gradient."""
    n = norms(ref_grad)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= ROUNDOFF_SHARE * med]


def norm_gaps(prog: dict, ref: dict, keep: list[str]) -> dict:
    """``|‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)`` of each leaf in
    ``keep``."""
    pn, rn = norms({k: prog[k] for k in keep}), norms({k: ref[k]
                                                        for k in keep})
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep}


def worst_norm_gap(prog: dict, ref: dict, keep: list[str]):
    """``(gap, leaf)``: the worst leaf's :func:`norm_gaps`."""
    gaps = norm_gaps(prog, ref, keep)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def median_norm_gap(prog: dict, ref: dict, keep: list[str]) -> float:
    """The median leaf's :func:`norm_gaps`: steady from seed to seed
    where the worst leaf swings."""
    return statistics.median(norm_gaps(prog, ref, keep).values())
