"""BENCHMARK.json keeps to the benchmark's contract, every file of a cell is
found by name, its driver's test hooks among them, and a new traffic file,
a new metric reader and a cell of a new kind are picked up from a copy of
the folder with no edit to any file that is there."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from port_bench import run
from port_bench.tests import cells

ROOT = run.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT_KEYS = {"why", "layer", "source"}
NEW_KIND = run.BENCH / "tests" / "new_kind"
GROUPS = ("configs", "workloads", "end_to_end", "per_layer")


def test_manifest_keys_names_and_units():
    assert list(MANIFEST) == ["command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"]
    assert MANIFEST["paths"] == ["port_bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert all(not w.startswith("/") and ".." not in w and "\t" not in w and len(w) <= 200
               for w in MANIFEST["command"])
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        moved = next(e for e in MANIFEST["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    for group in GROUPS:
        names = [x["name"] for x in MANIFEST[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
        for x in MANIFEST[group]:
            if "unit" in x:
                assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
            for key in TEXT_KEYS & set(x):
                assert 1 <= len(x[key]) <= 200 and "\n" not in x[key] and "\t" not in x[key]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_reports_what_the_contract_asks(workload):
    e2e = [m["name"] for m in run.metrics_of(MANIFEST, workload, trace=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.metrics_of(MANIFEST, workload, trace=True)


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(workload):
    _cell, config, traffic = run.cell_files(MANIFEST, workload)
    driver = run.load_module("drivers", config["driver"])
    assert callable(driver.Cell) and driver.SPANS
    hooks = cells.hooks(config["driver"])  # raises, naming the file to add, where there is none
    assert traffic["generator"] in hooks.GENERATORS
    for name in cells.REQUIRED:
        assert hasattr(hooks, name), f"port_bench/tests/cells/{config['driver']}.py lacks {name}"
    for trace in (False, True):
        for m in run.metrics_of(MANIFEST, workload, trace):
            assert callable(run.load_module("metrics", m["name"]).read)


def test_a_driver_without_test_hooks_fails_naming_the_file_to_add():
    with pytest.raises(FileNotFoundError, match="port_bench/tests/cells/no_such_driver.py"):
        cells.hooks("no_such_driver")


def test_a_new_traffic_file_and_metric_are_picked_up_with_no_edit(tmp_path):
    """In a copy of the checkout, new files only: two traffic files (one
    past B1's bands) and a metric reader for an existing configuration;
    and a cell of a new kind
    (new_kind/: a driver with its own generator, its reference, its test
    hooks, a configuration, a traffic file, a reader of a span's device
    time), with entries appended to BENCHMARK.json. The benchmark's own
    tests then run on the new kind's cell there, and no byte of a file the
    copy had changes."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "port_bench", copy / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (copy / "port_bench").rglob("*") if p.is_file()}
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((ROOT / "port_bench/traffic/cohort.json").read_text())
    traffic.update(genomes=24, sets=2, amino_rows=8, why="a test's small cohort")
    (copy / "port_bench/traffic/tiny-cohort.json").write_text(json.dumps(traffic))
    (copy / "port_bench/metrics/calls_in_window.py").write_text(
        "def read(ctx):\n    return ctx.calls\n")
    cell = "pf-gene-step.tiny-cohort"
    manifest["workloads"].append({"name": cell, "config": "pf-gene-step",
                                  "traffic": "tiny-cohort", "chips": 1, "why": "a test"})
    manifest["end_to_end"].append({"name": "genomes_per_s.tiny-cohort", "unit": "genomes/s",
                                   "better": "higher", "bound": 0.2, "source": "host_clock",
                                   "workloads": [cell]})
    manifest["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                                  "source": "host_clock", "layer": "entry",
                                  "moves": "genomes_per_s.tiny-cohort", "workloads": [cell]})
    # a step traffic past B1's bands (160 slots, as the hypervariable genes'), whose
    # cell lists no reader of B1: its work and inputs are checked as any cell's
    traffic.update(genomes=16, slots=160, why="a test's step past B1's bands")
    (copy / "port_bench/traffic/tiny-wide.json").write_text(json.dumps(traffic))
    wide = "pf-gene-step.tiny-wide"
    manifest["workloads"].append({"name": wide, "config": "pf-gene-step", "traffic": "tiny-wide",
                                  "chips": 1, "why": "a test"})
    manifest["end_to_end"][-1]["workloads"].append(wide)
    manifest["per_layer"][-1]["workloads"].append(wide)
    for src in NEW_KIND.rglob("*"):
        rel = src.relative_to(NEW_KIND)
        if src.is_file() and len(rel.parts) > 1 and "__pycache__" not in rel.parts:
            dst = copy / "port_bench" / rel
            assert not dst.exists(), f"{rel} is not a new file"
            dst.write_bytes(src.read_bytes())
    for group, entries in json.loads((NEW_KIND / "manifest.json").read_text()).items():
        manifest[group] += entries
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    code = ("import json; from port_bench import run; "
            f"r0 = run.run_cell('{cell}', 5, 0.1, device='cpu'); "
            f"r1 = run.run_cell('{cell}', 5, 0.1, trace=True, device='cpu'); "
            "r2 = run.run_cell('toy-rows.simple', 2**40 + 9, 0.1, trace=True, device='cpu'); "
            "print(json.dumps([r0, r1, r2]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r0, r1, r2 = json.loads(out.stdout.strip().splitlines()[-1])
    assert r0["correct"] and set(r0["metrics"]) == {"genomes_per_s.tiny-cohort", "setup_s"}
    assert r1["correct"] and r1["metrics"]["calls_in_window"]["value"] >= 2
    work = json.loads(out.stdout.strip().splitlines()[0])["work"]
    assert work["genomes_per_call"] == 24
    # the new kind's reader finds its span (no device on the CPU: 0 device ms)
    assert r2["correct"] and r2["metrics"]["call_device_ms.rows64"]["value"] == 0.0

    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "port_bench/tests", "-v", "-p", "no:cacheprovider",
         "-k", "toy-rows or manifest_keys or (work_is_the_same and tiny-wide)"],
        cwd=copy, env=env, capture_output=True, text=True, timeout=600)
    assert tests.returncode == 0, tests.stdout[-3000:] + tests.stderr[-2000:]
    ran = tests.stdout + tests.stderr
    for name in ("test_manifest_keys_names_and_units", "test_every_file_of_a_cell_is_found_by_name",
                 "test_the_control_is_not_correct_on_the_cpu", "test_each_fault_makes_the_run",
                 "test_work_is_the_same_at_every_seed", "test_the_result_line_has_the_contracts"):
        assert name in ran, f"{name} did not run on the new kind's cell"
    assert "test_work_is_the_same_at_every_seed[pf-gene-step.tiny-wide] PASSED" in ran
    passed = int(re.search(r"(\d+) passed", ran).group(1))
    assert passed >= 12 and " failed" not in ran

    after = {p: p.read_bytes() for p in before}
    assert after == before
    written = json.loads((copy / "BENCHMARK.json").read_text())
    for key, value in MANIFEST.items():  # each entry there kept, the new ones appended
        kept = written[key][: len(value)] if key in GROUPS else written[key]
        assert kept == value, key
