"""A run's result line, its refusals and its imports; and `correct` comes out
false for each fault a cell can have, with the timed path broken under an
otherwise whole run on the CPU (the harness's look for a card skipped)."""

import json
import os
import subprocess
import sys

import pytest

from port_bench import run
from port_bench.tests.cells import hooks_of_cell, with_hooks

ROOT = run.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = with_hooks(MANIFEST)
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def small_run(workload, trace=False, patch=None, seed=7):
    """A run at the sizes of its driver's SMALL: the port's plain routes
    stand in for the kernels."""
    return run.run_cell(workload, seed, 0.05, trace=trace, device="cpu",
                        traffic_override=hooks_of_cell(MANIFEST, workload).SMALL, patch=patch)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_the_result_line_has_the_contracts_keys(workload, trace):
    result = small_run(workload, trace)
    keys = KEYS[:-1] + (["breakdown", "unlinked"] if trace else []) + ["checks"]
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
        assert all(len(v) <= 10 for v in result["breakdown"].values())
        assert 0.0 <= result["unlinked"] <= 1.0
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(result)


def test_without_a_card_a_run_prints_nothing_and_fails():
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                          MANIFEST["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_imports_neither_jax_nor_the_jax_package():
    small = {w: hooks_of_cell(MANIFEST, w).SMALL for w in CELLS}
    code = ("import json, sys; from port_bench import run\n"
            f"for w, small in {small!r}.items():\n"
            "    run.run_cell(w, 3, 0.05, device='cpu', traffic_override=small)\n"
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
    for workload in CELLS:
        for fault in hooks_of_cell(MANIFEST, workload).FAULTS:
            yield workload, fault


@pytest.mark.parametrize("workload,fault", list(_cases()))
def test_each_fault_makes_the_run_incorrect(workload, fault):
    result = small_run(workload, patch=hooks_of_cell(MANIFEST, workload).FAULTS[fault])
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
