"""The control, the reference computed in fp8 in the program's place
(bf16 being the configurations' compute dtype), fails the check: at tiny
sizes on the CPU against the tiny cells' limits, and, on the card, at a
cell's own size against its limits."""

from __future__ import annotations

import pytest

from cardbench import harness
from cardbench.tests.conftest import REPO, TINY_CELLS


def _control_numbers(root, cell, seed, device, window):
    bench = harness.Bench(root)
    c = bench.cell(cell)
    cfg, traffic = bench.config(c), bench.traffic(c)
    kind = harness.loop(traffic["kind"])
    run = kind.Run(cfg, traffic, seed, device)
    if traffic["kind"] == "prefill":
        run.setup()          # the compared requests come from a window
        run.window(window)
        run.free()
    want = run.reference("float32")
    got = run.reference("float8")
    return kind.compare(got, want), bench.limits(cell)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_control_fails_tiny(tiny_bench, cell):
    numbers, limits = _control_numbers(tiny_bench, cell, 2 ** 31 + 9, "cpu",
                                       0.5)
    correct, _ = harness.check(numbers, limits)
    assert not correct, numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["spectre350m-prefill-8k-32k",
                                  "hybrid1b-train-32k-b1",
                                  "spectre350m-train-32k-b4"])
def test_control_fails_at_cell_size(card, cell):
    numbers, limits = _control_numbers(REPO, cell, 2 ** 31 + 1234, card,
                                       12.0)
    correct, _ = harness.check(numbers, limits)
    assert not correct, numbers
