"""BENCHMARK.json keeps to the benchmark's contract, every file of a cell is
found by name, and a new traffic file and metric reader are picked up from
a copy of the folder with no edit to any file that is there."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from port_bench import run

ROOT = run.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT_KEYS = {"why", "layer", "source"}


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
        assert m["moves"] in e2e
        moved = next(e for e in MANIFEST["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
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
    assert traffic["generator"] in ("snp_sets", "haplotype_sets")
    for trace in (False, True):
        for m in run.metrics_of(MANIFEST, workload, trace):
            assert callable(run.load_module("metrics", m["name"]).read)


def test_a_new_traffic_file_and_metric_are_picked_up_with_no_edit(tmp_path):
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
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = ("import json; from port_bench import run; "
            f"r0 = run.run_cell('{cell}', 5, 0.1, device='cpu'); "
            f"r1 = run.run_cell('{cell}', 5, 0.1, trace=True, device='cpu'); "
            "print(json.dumps([r0, r1]))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r0, r1 = json.loads(out.stdout.strip().splitlines()[-1])
    assert r0["correct"] and set(r0["metrics"]) == {"genomes_per_s.tiny-cohort", "setup_s"}
    assert r1["correct"] and r1["metrics"]["calls_in_window"]["value"] >= 2
    work = json.loads(out.stdout.strip().splitlines()[0])["work"]
    assert work["genomes_per_call"] == 24
    after = {p: p.read_bytes() for p in before}
    assert after == before
