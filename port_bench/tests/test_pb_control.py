"""The control of each cell, the reference with one stated guarantee broken
put in the program's place (breakers.CONTROLS), comes out not correct.

On the CPU at small sizes; on the card (marked `card`) at the cell's own
size on three seeds, where the faults of breakers.FAULTS are read too. The
readings print as `CONTROL <cell> <patch> seed=<n> <check>=<value>`.
"""

import json

import pytest

from port_bench import run
from port_bench.tests.breakers import CONTROLS, FAULTS

MANIFEST = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SMALL = {
    "pf-gene-step.cohort": {"genomes": 4096, "sets": 2, "amino_rows": 16},
    "pf-gene-family.near": {"haplotypes": 32, "sets": 1},
    "pf-gene-family.local": {"haplotypes": 24, "sets": 1},
}
CARD_SEEDS = (2**32 + 101, 2**32 + 202, 2**32 + 303)


def driver_of(workload):
    return run.cell_files(MANIFEST, workload)[1]["driver"]


def reading(workload, name, seed, **kwargs):
    result = run.run_cell(workload, seed, kwargs.pop("seconds", 0.05), **kwargs)
    values = {k: c["value"] for k, c in result["checks"].items()}
    print(f"CONTROL {workload} {name} seed={seed} "
          + " ".join(f"{k}={v}" for k, v in values.items()), flush=True)
    return result


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_on_the_cpu(workload):
    result = reading(workload, "control", 11, device="cpu", traffic_override=SMALL[workload],
                     patch=CONTROLS[driver_of(workload)])
    assert result["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_and_the_faults_at_the_cells_size(card, workload):
    driver = driver_of(workload)
    for seed in CARD_SEEDS:
        result = reading(workload, "control", seed, seconds=1.0, patch=CONTROLS[driver])
        assert result["correct"] is False
    for fault, patch in FAULTS[driver].items():
        result = reading(workload, fault, CARD_SEEDS[0], seconds=1.0, patch=patch)
        assert result["correct"] is False
