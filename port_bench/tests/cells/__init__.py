"""What the harness's tests need of each driver's cells: one module a
driver, cells/<driver>.py, found by the driver's name, so that a cell of a
new kind comes with new files only. A module holds:

  GENERATORS     the generators its traffic files may name;
  SMALL          traffic overrides at which a CPU run of any of its cells
                 holds (the port's plain routes stand in for the kernels);
  CONTROL_SMALL  traffic overrides at which its control fails on the CPU;
  control(cell)  the control: the reference, one stated guarantee broken,
                 put in the program's place after set-up;
  FAULTS         {name: patch(cell)}: the faults its cells can have, each
                 breaking the timed path under an otherwise whole run;
  work_of(config, traffic, inputs)        the amounts of work they make,
                                          which must be the same at every seed;
  check_inputs(config, traffic, inputs, reads)
                                          what its kind of input must hold, for
                                          any traffic of the driver; `reads` are
                                          the per-layer metrics the cell reports,
                                          so a route a reader needs is held only
                                          where a cell lists that reader;
and, where it differs from the default:
  inputs(seed, config, traffic)           the driver's inputs from the seed
                                          (default: generate.inputs);
  port_spans(traffic)                     the port's spans (kgt.*) a traced
                                          CPU run of the cell holds (default:
                                          none).

A patch replaces the Cell's `program`, the call the window drives.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

from port_bench import generate, run

__all__ = ["REQUIRED", "hooks", "hooks_of_cell", "path_of", "reads", "with_hooks"]

REQUIRED = ("GENERATORS", "SMALL", "CONTROL_SMALL", "control", "FAULTS", "work_of",
            "check_inputs")
DEFAULTS = {"inputs": generate.inputs, "port_spans": lambda traffic: []}

HERE = Path(__file__).resolve().parent


def path_of(driver: str) -> Path:
    return HERE / f"{driver}.py"


def hooks(driver: str):
    """cells/<driver>.py as a module."""
    path = path_of(driver)
    if not path.is_file():
        raise FileNotFoundError(f"driver {driver!r} has no test hooks: add "
                                f"port_bench/tests/cells/{driver}.py (see cells/__init__.py)")
    spec = importlib.util.spec_from_file_location(f"_port_bench_cells_{driver}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for name, default in DEFAULTS.items():
        if not hasattr(module, name):
            setattr(module, name, default)
    return module


def _driver(manifest: dict, workload: str) -> str:
    return run.cell_files(manifest, workload)[1]["driver"]


def hooks_of_cell(manifest: dict, workload: str):
    return hooks(_driver(manifest, workload))


def reads(manifest: dict, workload: str) -> list:
    """The names of the per-layer metrics the cell reports."""
    return [m["name"] for m in run.metrics_of(manifest, workload, trace=True)]


def with_hooks(manifest: dict) -> list:
    """The manifest's cells whose driver has its module; a cell without one
    fails test_pb_layout's test_every_file_of_a_cell_is_found_by_name."""
    return [w["name"] for w in manifest["workloads"]
            if path_of(_driver(manifest, w["name"])).is_file()]
