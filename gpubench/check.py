"""The comparison that decides ``correct``: the program's first steps
against the reference's on the same weights and batches.

Three numbers, each held to its limit (``limits/<cell>.json``):

- ``loss_gap``: the largest |program's loss - reference's loss| over the
  checked steps, in nats;
- ``grad_gap``: over the leaves, the largest gap between the program's and the
  reference's norm of the first gradient as the optimizer gets it (after
  clipping), as a share of the reference's norm of that leaf or of the median
  leaf's, whichever is larger;
- ``change_gap``: the same of the norm of each leaf's change over the checked
  steps, over every leaf the reference moves.  Adam moves each element of a
  leaf by about the learning rate whatever its gradient's scale, so only a
  leaf whose gradient is nought to rounding moves by round-off alone: one
  whose reference gradient, per element (its norm over the square root of its
  size), is under a thousandth of the median leaf's.  Those are left out and
  named (``left_out``).

A cell's limits file names the numbers it compares: one that no control or
fault separates from the program's own readings is left out there (PERF.md
gives its readings).  A number the program cannot give (a missing leaf, a value that is not finite)
reads ``FAILED``, far above any limit."""

from __future__ import annotations

import math
import statistics

FAILED = 1e30
RULE_UNMOVED = 1e-3


def _gap(prog: dict, ref: dict, keys) -> tuple:
    """(the worst gap, the leaf that gives it)."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    worst, at = 0.0, None
    for k in keys:
        got = prog.get(k)
        if got is None or not math.isfinite(got):
            return FAILED, k
        gap = abs(got - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst:
            worst, at = gap, k
    return worst, at


def left_out(ref: dict) -> list:
    """The leaves whose reference gradient is nought to rounding (the module's
    rule), in order."""
    g, sizes = ref["grad_norms"], ref["sizes"]
    per_element = {k: g[k] / math.sqrt(sizes[k]) for k in g}
    med = statistics.median(per_element.values())
    return sorted(k for k, v in per_element.items() if v < RULE_UNMOVED * med)


def compare(prog: dict, ref: dict) -> tuple:
    """({"loss_gap", "grad_gap", "change_gap"}, {"left_out", "worst"}) of two
    results of ``{"losses", "grad_norms", "change_norms"}`` (the reference's
    also with ``"sizes"``, each leaf's number of elements)."""
    if len(prog["losses"]) != len(ref["losses"]) or not all(map(math.isfinite, prog["losses"])):
        loss_gap = FAILED
    else:
        loss_gap = max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))
    out = set(left_out(ref))
    grad_gap, grad_at = _gap(prog["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    change_gap, change_at = _gap(prog["change_norms"], ref["change_norms"],
                                 [k for k in ref["change_norms"] if k not in out])
    return ({"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap},
            {"left_out": sorted(out), "worst": {"grad_gap": grad_at, "change_gap": change_at}})


def numbers(prog: dict, ref: dict) -> dict:
    return compare(prog, ref)[0]


def judge(nums: dict, limits: dict) -> bool:
    return all(nums[k] <= limits[k] for k in limits)


def lines(nums: dict, limits: dict) -> list:
    """One plain line a number: its name, its value and its limit."""
    return [f"check {k} {nums[k]!r} limit {limits[k]!r}" for k in limits]


def summary(nums: dict, limits: dict) -> dict:
    return {k: {"value": nums[k], "limit": limits[k]} for k in limits}
