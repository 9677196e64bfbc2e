"""
The comparisons that decide `correct`.

A training cell compares leaf by leaf; where a kink of the function (a
ReLU whose input rounding puts on either side of 0) makes the worst leaf
swing from seed to seed, the cell compares the median leaf and the leaf
at the 90th percentile instead (of the same per-leaf numbers).

Leaf by leaf, a training number is the gap between the program's norm of
a leaf and the reference's, over the larger of the reference's norm of
that leaf and of the median leaf (some leaves' gradients are all but
zero); the worst leaf is the number. Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone (a key's
bias under softmax) and are left out by that rule, never by name.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List

import torch

LEAF_FLOOR = 1e-3


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in leaves.items()}


def leaves_that_move(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = _norms(ref_grads)
    median = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= LEAF_FLOOR * median]


def leaf_gaps(prog: Dict[str, torch.Tensor], refr: Dict[str, torch.Tensor],
              keep: Iterable[str]) -> Dict[str, float]:
    """Each kept leaf's gap of norms over the larger of its reference
    norm and the median leaf's."""
    keep = list(keep)
    pn, rn = _norms({n: prog[n] for n in keep}), _norms(
        {n: refr[n] for n in keep})
    median = statistics.median(rn.values())
    return {n: abs(pn[n] - rn[n]) / max(rn[n], median) for n in keep}


def worst_leaf_gap(prog: Dict[str, torch.Tensor],
                   refr: Dict[str, torch.Tensor],
                   keep: Iterable[str]) -> float:
    return max(leaf_gaps(prog, refr, keep).values())


def p90(values: Iterable[float]) -> float:
    """The 90th percentile of per-leaf numbers (`statistics.quantiles`,
    exclusive method): a fault in a tenth of the leaves or more moves it,
    a kink in a few leaves does not."""
    return statistics.quantiles(list(values), n=10)[-1]


def leaf_errors(prog: Dict[str, torch.Tensor],
                refr: Dict[str, torch.Tensor],
                keep: Iterable[str]) -> Dict[str, float]:
    """Each kept leaf's norm of the difference over the larger of its
    reference norm and the median leaf's."""
    keep = list(keep)
    rn = _norms({n: refr[n] for n in keep})
    median = statistics.median(rn.values())
    return {n: float((prog[n].double() - refr[n].double()).norm())
            / max(rn[n], median) for n in keep}


def worst_leaf_error(prog: Dict[str, torch.Tensor],
                     refr: Dict[str, torch.Tensor],
                     keep: Iterable[str]) -> float:
    return max(leaf_errors(prog, refr, keep).values())


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct iff every number is finite and within its limit."""
    if set(numbers) != set(limits):
        raise ValueError(f"numbers {sorted(numbers)} against limits "
                         f"{sorted(limits)}")
    return all(v == v and abs(v) != float("inf") and v <= limits[k]
               for k, v in numbers.items())
