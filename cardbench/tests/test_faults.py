"""Each fault that a cell can have, planted under the timed path of a run
(the harness's look for a card skipped: tiny cells on the CPU), turns
``correct`` false; the same run without it is correct."""

from __future__ import annotations

import time

import pytest

from cardbench import faults, harness
from cardbench.tests.conftest import TINY_CELLS

CASES = [(cell, None) for cell in sorted(TINY_CELLS)] + [
    (cell, fault) for cell in sorted(TINY_CELLS)
    for fault in faults.BY_KIND["prefill" if "prefill" in cell else "train"]]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_fault_turns_correct_false(tiny_bench, cell, fault):
    def run():
        return harness.run(tiny_bench, cell, 2 ** 31 + 5, 0.5, False, "cpu",
                           time.perf_counter())

    if fault is None:
        res = run()
        assert res["correct"], res["compared"]
        return
    with faults.FAULTS[fault]():
        res = run()
    assert not res["correct"], res["compared"]
