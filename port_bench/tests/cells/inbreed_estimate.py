"""Test hooks of the INBREED driver's cells (see cells/__init__.py).

Control: the reference in the program's place, its Loglikelihood objective
computed in float32, the precision below the configuration's float64 (the
other three estimators as the reference computes them): the maximum moves
by ~5e-4, five times Loglikelihood's tolerance.
Faults (the program's own outputs, broken where they are produced):
  stale: each call returns the estimate of the call before it;
  wrong_column: each call reads the next set's AF column;
  loci_off_by_one: the analysis estimates the loci one variant past those
      it selects;
  moved: the first genome's Simple F moved by twice its tolerance.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from port_bench import run
from port_bench.reference import inbreed as reference

_driver = run.load_module("drivers", "inbreed_estimate")

GENERATORS = ("inbreed_population",)
_SMALL_POPULATION = {"samples_by_super_population": {"AFR": 9, "AMR": 7, "EAS": 8, "EUR": 8,
                                                     "SAS": 8}}
SMALL = {**_SMALL_POPULATION, "records": 3000,
         "analysis": {"Algorithm": "ALL", "MinAF": 0.05, "MaxAF": 1.0, "SamplingDistance": 1000,
                      "LociiCount": 150}}
CONTROL_SMALL = {**_SMALL_POPULATION, "records": 20000,
                 "analysis": {"Algorithm": "ALL", "MinAF": 0.05, "MaxAF": 1.0,
                              "SamplingDistance": 1000, "LociiCount": 1500}}
# the thinned loci of every AF column drawn from the seed exceed LociiCount
# by this share, so the AF columns counted from the drawn genotypes (which
# move a few loci across MinAF) select LociiCount loci at every seed
LOCI_MARGIN = 1.05


def control(cell):
    def program(column):
        loci = cell.reference_loci(column)
        f = reference.estimators(cell.codes, loci, cell.af(column)[loci],
                                 loglik_dtype=torch.float32)
        return _Estimate(f.cpu().numpy().astype(np.float32), loci)

    cell.program = program


class _Estimate:
    def __init__(self, f, loci):
        self.f, self.loci = f, loci


def stale(cell):
    real = cell.program
    last = [real(cell.sets[-1])]

    def program(column):
        out = real(column)
        prev, last[0] = last[0], out
        return prev

    cell.program = program


def wrong_column(cell):
    real = cell.program
    sets = cell.sets

    def program(column):
        return real(sets[(sets.index(column) + 1) % len(sets)])

    cell.program = program


def loci_off_by_one(cell):
    shifted = copy.copy(cell.analysis)
    select = shifted.select_loci
    shifted.select_loci = lambda *args: np.roll(select(*args), 1)
    cell.program = lambda column: shifted.estimate(cell.columns,
                                                   _driver.super_population_of(column))


def moved(cell):
    real = cell.program
    k = cell.analysis.algorithms.index("Simple")

    def program(column):
        out = real(column)
        f = out.f.copy()
        f[0, k] += 2 * reference.TOLERANCE["Simple"]
        return _Estimate(f, out.loci)

    cell.program = program


FAULTS = {"stale": stale, "wrong_column": wrong_column, "loci_off_by_one": loci_off_by_one,
          "moved": moved}


def inputs(seed, config, traffic):
    return _driver.inbreed_population(seed, config, traffic)


def work_of(config, traffic, inputs):
    s = _driver.sizes(config, traffic)
    G, V = inputs.f.shape[0], inputs.positions.shape[0]
    assert inputs.pop_af.shape == (V, len(s["samples_by_super_population"]))
    return {"genomes": G, "variants": V, "sets": len(traffic["sets"]),
            "loci_per_set": int(s["analysis"]["LociiCount"])}


def check_inputs(config, traffic, inputs, reads):
    """The population's shape: the configuration's counts, positions sorted
    inside the span, the fixed F list; and each AF column's thinned loci
    past LociiCount by LOCI_MARGIN on the drawn frequencies."""
    s = _driver.sizes(config, traffic)
    counts = s["samples_by_super_population"]
    pos = inputs.positions
    assert pos[0] == s["first_position"] and pos[-1] == s["last_position"]
    assert (np.diff(pos) >= 0).all() and len(pos) == s["records"]
    assert np.bincount(inputs.population).tolist() == list(counts.values())
    assert set(np.unique(inputs.f).tolist()) <= set(traffic["f_values"])
    a = s["analysis"]
    for column in traffic["sets"]:
        sp = _driver.super_population_of(column)
        af = inputs.af if sp == "ALL" else inputs.pop_af[:, list(counts).index(sp)]
        loci = reference.select_loci(pos, np.zeros(len(pos), dtype=np.int32), inputs.is_snp, af,
                                     float(a["MinAF"]), float(a["MaxAF"]),
                                     int(a["SamplingDistance"]), 2**62)
        assert len(loci) >= LOCI_MARGIN * int(a["LociiCount"]), (column, len(loci))


def port_spans(traffic):
    return ["kgt.inbreed"] + [f"kgt.inbreed.{s}" for s in
                              ("select", "upload", "gather", "ritland", "simple", "hallme",
                               "loglik", "fetch")]
