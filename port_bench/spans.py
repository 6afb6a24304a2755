"""Every span of one traced run, in full.

run.py's traced run reduces the window with trace.reduce_events and prints
what the cell's per-layer metrics read of it. This prints the rest of the
same reduction: each span's host ms and device ms a call, and its idle
seconds in the window, for the harness's spans and the port's (kgt.*):

    python3 -m port_bench.spans --workload <cell> --seed <n> [--seconds 10]

prints run.py's result line with `spans` added.
"""

from __future__ import annotations

from port_bench import run  # first: run.py's set-up clock starts at its import

import argparse
import json

__all__ = ["run_spans"]


def run_spans(workload: str, seed: int, seconds: float, device: str = "cuda",
              traffic_override: dict | None = None) -> dict:
    """run.run_cell's traced run of a cell, with `spans` added to its result."""
    result, t = run.run_and_trace(workload, seed, seconds, trace=True, device=device,
                                  traffic_override=traffic_override)
    calls = result["attempted"]
    result["spans"] = {
        "calls": calls,
        "host_ms": {k: v / calls * 1e3 for k, v in sorted(t.span_s.items())},
        "device_ms": {k: v / calls * 1e3 for k, v in sorted(t.span_device_s.items())},
        "idle_s": dict(sorted(t.idle_gaps.items())),
        "unlinked_s": t.unlinked_s,
    }
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one traced run of a cell, every span read")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run_spans(args.workload, args.seed, args.seconds, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
