"""A run's result line, its refusals and its imports; and `correct` comes out
false for each fault a cell can have, with the timed path broken under an
otherwise whole run on the CPU (the harness's look for a card skipped)."""

import json
import os
import subprocess
import sys

import pytest

from port_bench import run
from port_bench.tests.breakers import FAULTS

ROOT = run.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
# Cells at sizes a CPU test holds: the port's plain routes stand in for the kernels.
SMALL = {
    "pf-gene-step.cohort": {"genomes": 32, "sets": 2, "amino_rows": 8},
    "pf-gene-family.near": {"haplotypes": 8, "sets": 2},
    "pf-gene-family.local": {"haplotypes": 6, "sets": 2},
}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def small_run(workload, trace=False, patch=None, seed=7):
    return run.run_cell(workload, seed, 0.05, trace=trace, device="cpu",
                        traffic_override=SMALL[workload], patch=patch)


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_contracts_keys(trace):
    workload = "pf-gene-step.cohort"
    result = small_run(workload, trace)
    keys = KEYS[:-1] + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = [m["name"] for m in run.metrics_of(MANIFEST, workload, trace)]
    assert set(result["metrics"]) <= set(want)
    if not trace:
        assert set(result["metrics"]) == set(want)
    else:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(result)


def test_without_a_card_a_run_prints_nothing_and_fails():
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                          "pf-gene-step.cohort", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = ("import json, sys; from port_bench import run; "
            "run.run_cell('pf-gene-family.near', 3, 0.05, device='cpu', traffic_override="
            + repr(SMALL["pf-gene-family.near"]) + "); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "kgl_gene_tpu_torch" in tops
    assert not tops & set(run.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "kgl_gene_tpu_torch_extra", sys)
    assert "kgl_gene_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "kgl_gene_tpu.ops", sys)
    assert "kgl_gene_tpu" in run.forbidden_modules()


def _cases():
    for workload in SMALL:
        _cell, config, _traffic = run.cell_files(MANIFEST, workload)
        for fault in FAULTS[config["driver"]]:
            yield workload, config["driver"], fault


@pytest.mark.parametrize("workload,driver,fault", list(_cases()))
def test_each_fault_makes_the_run_incorrect(workload, driver, fault):
    result = small_run(workload, patch=FAULTS[driver][fault])
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
