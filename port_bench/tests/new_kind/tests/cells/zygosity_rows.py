"""Test hooks of the zygosity-rows driver's cells (see cells/__init__.py).

Control: the reference computed in bfloat16, the precision below the
configuration's float32. Faults: stale (each call returns the F of the
call before it), half (the first half of the genomes computed, standing
in for the rest), altered (one genome's F moved by 1e-3).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import run

_driver = run.load_module("drivers", "zygosity_rows")

GENERATORS = ("zygosity_rows",)
SMALL = {}
CONTROL_SMALL = {}


def control(cell):
    def program(z, p, valid):
        p, n = p.to(torch.bfloat16), torch.tensor(z.shape[1], dtype=torch.bfloat16)
        expected = (p * p + (1 - p) * (1 - p)).sum().to(torch.bfloat16)
        observed = ((z == 0) | (z == 2)).sum(1).to(torch.bfloat16)
        return ((observed - expected) / (n - expected)).to(torch.float32)

    cell.program = program


def stale(cell):
    real = cell.program
    last = [real(*cell.on_device[-1])]

    def program(*args):
        out = real(*args)
        prev, last[0] = last[0], out
        return prev

    cell.program = program


def half(cell):
    real = cell.program

    def program(z, p, valid):
        h = z.shape[0] // 2
        return real(z[:h], p, valid[:h]).repeat(2)[: z.shape[0]]

    cell.program = program


def altered(cell):
    real = cell.program

    def program(*args):
        f = real(*args).clone()
        f[0] += 1e-3
        return f

    cell.program = program


FAULTS = {"stale": stale, "half": half, "altered": altered}


def inputs(seed, config, traffic):
    return _driver.zygosity_rows(seed, traffic)


def work_of(config, traffic, inputs):
    G, L = inputs[0][0].shape
    assert all(z.shape == (G, L) and p.shape == (L,) for z, p in inputs)
    return {"genomes": G, "loci": L, "sets": len(inputs)}


def check_inputs(config, traffic, inputs, reads):
    for z, p in inputs:
        assert set(np.unique(z).tolist()) <= {0, 1, 2}
        assert (p >= traffic["min_af"]).all() and (p <= traffic["max_af"]).all()
