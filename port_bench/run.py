"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json's
`workloads`; its configuration file, its traffic file
(traffic/<traffic>.json), its driver (drivers/<driver>.py, named by the
configuration) and its metrics (metrics/<metric>.py, or metrics/<the
metric's name up to its first dot>.py) are found by name.

A run: set-up (the driver makes the gene and the input sets from the seed,
builds the program's call and warms every shape the traffic uses), then a
closed loop for --seconds: one call in flight, the next issued when the
last one's outputs are on the host. With --trace 1 torch.profiler records
the window, which then lasts at most TRACE_SECONDS, and trace.py reduces
it: the harness's spans and the port's (kgt.*), each one's host and
device seconds, the idle under each. Then the program's state is freed
and the driver's reference judges the answers. The last line of standard
output is one JSON object: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or with --trace 1 its per-layer ones), device,
with --trace 1 breakdown and `unlinked` (the share of the window's device
time whose launch the trace does not hold), and last `checks`: each
number compared with its limit, also the last lines of standard error. Exit
codes: 0 a result printed, 2 no card or too few cards, 3 a forbidden
module loaded; any other failure raises.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kgl_gene_tpu")
RECORD_SPAN = "bench.record"
# A --trace 1 run's window lasts at most this long: the profiler's trace of a
# longer window takes minutes to reduce, and the per-layer metrics are shares
# and means a call.
TRACE_SECONDS = 10.0


@dataclass
class Context:
    """What a metric reader reads. Times in seconds."""
    setup_s: float
    window_s: float
    calls: int
    units: int            # genomes or pairs whose outputs reached the host
    latencies_s: list     # each call, from the call to its outputs on the host
    host_s: list          # each call, from the call to its return (before the fetch)
    work: dict
    trace: object = None  # trace.Trace of a --trace 1 run


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(kind: str, name: str):
    """port_bench/<kind>/<name>.py as a module (names may hold dots); for a
    metric with no file of its own, metrics/<name up to its first dot>.py."""
    path = BENCH / kind / f"{name}.py"
    if kind == "metrics" and not path.is_file():
        path = BENCH / kind / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path.relative_to(ROOT)} for {name!r}")
    module_name = f"_port_bench_{kind}_{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(manifest: dict, workload: str):
    """(workload entry, configuration, traffic) of a cell, found by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def metrics_of(manifest: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with trace its per-layer ones."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool = False, device: str = "cuda",
             traffic_override: dict | None = None, patch=None) -> dict:
    """One run of a cell; returns the result object. patch(cell), where
    given, is called after set-up: the tests break the timed path with it."""
    return run_and_trace(workload, seed, seconds, trace, device, traffic_override, patch)[0]


def run_and_trace(workload: str, seed: int, seconds: float, trace: bool = False,
                  device: str = "cuda", traffic_override: dict | None = None, patch=None):
    """run_cell's run: (the result object, the window's trace.Trace, or None
    when untraced)."""
    import torch
    from torch.profiler import record_function

    from . import trace as tracing

    manifest = load_json(ROOT / "BENCHMARK.json")
    spec, config, traffic = cell_files(manifest, workload)
    traffic.update(traffic_override or {})
    dev = torch.device(device)
    driver = load_module("drivers", config["driver"])
    cell = driver.Cell(config, traffic, seed, dev)
    on_card = dev.type == "cuda"
    card = torch.cuda.get_device_name(dev) if on_card else "cpu"
    print(json.dumps({"work": cell.work, "card": card, "seed": seed}), flush=True)
    if patch is not None:
        patch(cell)

    prof = None
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
        prof = tracing.profiled()
        prof.start()
    latencies, host = [], []
    calls = 0
    w0 = time.perf_counter()
    setup_s = w0 - T_START
    while True:
        t0 = time.perf_counter()
        t_return, answer = cell.call(calls)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        host.append(t_return - t0)
        with record_function(RECORD_SPAN):
            cell.record(calls, answer)
        calls += 1
        if t1 - w0 >= seconds and calls >= cell.min_calls:
            break
    w1 = time.perf_counter()
    traced = None
    if prof is not None:
        prof.stop()
        traced = tracing.reduce_events(prof.profiler.kineto_results.events(),
                                       set(driver.SPANS) | {RECORD_SPAN})
        del prof
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    cell.release()
    checks, failed = cell.judge()
    ctx = Context(setup_s=setup_s, window_s=w1 - w0, calls=calls,
                  units=calls * cell.units_per_call, latencies_s=latencies, host_s=host,
                  work=cell.work, trace=traced)
    metrics = {}
    for m in metrics_of(manifest, workload, trace):
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(value <= limit for _name, value, limit in checks),
        "attempted": calls,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": card,
                   "count": int(spec["chips"]), "memory_peak_bytes": int(memory_peak)},
    }
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
        result["unlinked"] = traced.unlinked_share()
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result, traced


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    manifest = load_json(ROOT / "BENCHMARK.json")
    chips = int(cell_files(manifest, args.workload)[0]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"port_bench: forbidden modules loaded in this process: {loaded}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
