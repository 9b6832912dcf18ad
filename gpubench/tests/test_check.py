"""Which leaves the change's comparison leaves out: only those whose
reference gradient is nought to rounding, judged per element, so that a small
leaf that Adam moves like any other (a norm's scale) is compared."""

from __future__ import annotations

import math

import pytest

from gpubench import check


def result(grads: dict, sizes: dict, change: dict) -> dict:
    return {"losses": [1.0], "grad_norms": grads, "change_norms": change, "sizes": sizes}


def test_a_small_leaf_is_compared_and_a_gradient_of_rounding_is_not():
    sizes = {"w1": 10_000, "w2": 10_000, "w3": 10_000, "scale": 100, "bias": 100}
    # per element: 1e-2 for the weights and the scale; 1e-9 for the bias
    grads = {k: 1e-2 * math.sqrt(n) for k, n in sizes.items()}
    grads["bias"] = 1e-9 * math.sqrt(100)
    change = {k: 1e-3 * math.sqrt(n) for k, n in sizes.items()}
    ref = result(grads, sizes, change)
    assert check.left_out(ref) == ["bias"]
    # the scale's gradient norm is a tenth of the weights': not left out
    unmoved = dict(change, scale=0.0)
    nums, about = check.compare(result(grads, sizes, unmoved), ref)
    assert about["worst"]["change_gap"] == "scale"
    assert nums["change_gap"] == pytest.approx(0.1)   # its change over the median leaf's
    # the bias may do anything
    nums, about = check.compare(result(grads, sizes, dict(change, bias=5.0)), ref)
    assert nums["change_gap"] == 0.0 and about["left_out"] == ["bias"]
