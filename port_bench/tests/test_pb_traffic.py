"""Each traffic mix fixes the amount of work: at three seeds the same
amounts (its driver's cells module's work_of), while the seed changes the
values of the largest input array; and each input holds what its kind
must (the module's check_inputs), a route only where a reader of the
cell needs it."""

import json

import numpy as np
import pytest

from port_bench import run
from port_bench.tests.cells import hooks, hooks_of_cell, reads, with_hooks

MANIFEST = json.loads((run.ROOT / "BENCHMARK.json").read_text())
SEEDS = (1, 2**31 + 11, 2**40 + 3)


def arrays(x):
    """Every numpy array in an input, in order."""
    if isinstance(x, np.ndarray):
        return [x]
    if isinstance(x, (tuple, list)):
        return [a for item in x for a in arrays(item)]
    return []


@pytest.mark.parametrize("workload", with_hooks(MANIFEST))
def test_work_is_the_same_at_every_seed(workload):
    _cell, config, traffic = run.cell_files(MANIFEST, workload)
    cells = hooks_of_cell(MANIFEST, workload)
    works, seen = [], []
    for seed in SEEDS:
        inputs = cells.inputs(seed, config, traffic)
        cells.check_inputs(config, traffic, inputs, reads(MANIFEST, workload))
        works.append(cells.work_of(config, traffic, inputs))
        seen.append(arrays(inputs))
    assert works[0] == works[1] == works[2]
    first, second = (max(a, key=lambda x: x.size) for a in seen[:2])
    assert not np.array_equal(first, second)  # the seed changes the values


def test_a_step_past_b1_s_bands_is_held_to_b1_only_where_a_cell_reads_b1():
    """A step traffic of 160 slots (no band of B1 holds it) is a sound
    traffic of its own; listed under B1's roofline it fails."""
    config = next(run.load_json(run.ROOT / c["file"]) for c in MANIFEST["configs"]
                  if run.load_json(run.ROOT / c["file"])["driver"] == "forward_step")
    cells = hooks("forward_step")
    traffic = {"generator": "snp_sets", "genomes": 16, "slots": 160, "valid_p": 0.5,
               "sets": 2, "amino_rows": 4}
    inputs = cells.inputs(7, config, traffic)
    cells.check_inputs(config, traffic, inputs, ["genomes_per_s.wide"])
    with pytest.raises(AssertionError):
        cells.check_inputs(config, traffic, inputs, ["b1_roofline_pct.wide"])
    narrow = dict(traffic, slots=8)
    cells.check_inputs(config, narrow, cells.inputs(7, config, narrow), ["b1_roofline_pct.wide"])
