"""The control of each cell, the reference with one stated guarantee broken
put in the program's place (its driver's cells module's control), comes
out not correct.

On the CPU at small sizes; on the card (marked `card`) at the cell's own
size on three seeds, where the faults of the module's FAULTS are read too.
The readings print as `CONTROL <cell> <patch> seed=<n> <check>=<value>`.
"""

import json

import pytest

from port_bench import run
from port_bench.tests.cells import hooks_of_cell, with_hooks

MANIFEST = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = with_hooks(MANIFEST)
CARD_SEEDS = (2**32 + 101, 2**32 + 202, 2**32 + 303)


def reading(workload, name, seed, **kwargs):
    result = run.run_cell(workload, seed, kwargs.pop("seconds", 0.05), **kwargs)
    values = {k: c["value"] for k, c in result["checks"].items()}
    print(f"CONTROL {workload} {name} seed={seed} "
          + " ".join(f"{k}={v}" for k, v in values.items()), flush=True)
    return result


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_on_the_cpu(workload):
    cells = hooks_of_cell(MANIFEST, workload)
    result = reading(workload, "control", 11, device="cpu", traffic_override=cells.CONTROL_SMALL,
                     patch=cells.control)
    assert result["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_and_the_faults_at_the_cells_size(card, workload):
    cells = hooks_of_cell(MANIFEST, workload)
    for seed in CARD_SEEDS:
        result = reading(workload, "control", seed, seconds=1.0, patch=cells.control)
        assert result["correct"] is False
    for fault, patch in cells.FAULTS.items():
        result = reading(workload, fault, CARD_SEEDS[0], seconds=1.0, patch=patch)
        assert result["correct"] is False
