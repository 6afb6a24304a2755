"""Test hooks of the PfEMP statistics driver's cells (see cells/__init__.py).

Control: the reference in the program's place, its AF, hs and hs sums
computed in float32, the precision below the configuration's float64: every
count as the float64 reference's, each FWS moved by ~1e-7, past fws_gap's
limit of 1e-11.
Faults (the program's own outputs, broken where they are produced):
  other_set: each call returns the other set's answer;
  af_over_all_genomes: the variant stage counts every genome, so the
      monoclonal set's AF (and its per-variant counts) are over all of them;
  bin_edge_at_or_below: a variant's bin taken as lo < AF <= hi;
  hs_sum_float32: each genome's hs sums over the segments added in float32;
  count_off_by_one: the first genome's first bin holds one heterozygous
      locus too many.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import torch

from port_bench import run
from port_bench.reference import fws as reference

_driver = run.load_module("drivers", "pfemp_fws")

GENERATORS = ("fws_population",)
# 40 genomes (26 monoclonal): 2 x 40 alleles put AF on every bin edge, 2 x 26 on 0.25 and 0.5
SMALL = {"genomes": 40, "variants": 4000}
CONTROL_SMALL = SMALL


class _Result:
    """What the driver reads of a call's result."""

    def __init__(self, index, ref):
        self.index = np.asarray(index, dtype=np.int64)
        for name in ("het_bins", "hom_bins", "het", "hom", "fws"):
            setattr(self, name, ref[name].cpu().numpy())
        self.variant_counts = torch.stack([ref["variant_het"], ref["variant_hom"]]).to(
            torch.int32).cpu().numpy()


def control(cell):
    def program(name):
        index = cell.want_index[name]
        return _Result(index, reference.statistics(cell.codes, index, dtype=torch.float32))

    cell.program = program


def other_set(cell):
    real = cell.program
    sets = cell.sets

    def program(name):
        return real(sets[(sets.index(name) + 1) % len(sets)])

    cell.program = program


def _patched(cell, name, replace):
    """Each call of the program with stats/fws.py's `name` replaced by
    replace(real)."""
    from kgl_gene_tpu_torch.stats import fws

    real_program, stage = cell.program, replace(getattr(fws, name))

    def program(set_name):
        with mock.patch.object(fws, name, stage):
            return real_program(set_name)

    cell.program = program


def af_over_all_genomes(cell):
    def replace(real):
        def stage(codes, mask, genomes):
            every = torch.zeros_like(mask)
            every[:codes.shape[1]] = 1
            return real(codes, every, codes.shape[1])
        return stage

    _patched(cell, "_variant_stage", replace)


def bin_edge_at_or_below(cell):
    def replace(_real):
        def bins(af):
            edges = torch.tensor([lo for lo, _hi in reference.FREQUENCY_BINS[1:]],
                                 dtype=torch.float64, device=af.device)
            return torch.bucketize(af, edges, right=False)
        return bins

    _patched(cell, "frequency_bins", replace)


def hs_sum_float32(cell):
    def replace(real):
        def sums(het_part, hom_part, hs_part, seg_bins):
            het_bins, hom_bins, _hs_sum = real(het_part, hom_part, hs_part, seg_bins)
            return het_bins, hom_bins, hs_part.float().sum(0).double()
        return sums

    _patched(cell, "_segment_sums", replace)


def count_off_by_one(cell):
    real = cell.program

    def program(name):
        out = real(name)
        out.het_bins = out.het_bins.copy()
        out.het_bins[0, 0] += 1
        return out

    cell.program = program


FAULTS = {"other_set": other_set, "af_over_all_genomes": af_over_all_genomes,
          "bin_edge_at_or_below": bin_edge_at_or_below, "hs_sum_float32": hs_sum_float32,
          "count_off_by_one": count_off_by_one}


def inputs(seed, config, traffic):
    return _driver.fws_population(seed, config, traffic)


def work_of(config, traffic, inputs):
    s = _driver.sizes(config, traffic)
    assert inputs.af.shape == (s["variants"],) and inputs.weight.shape == (s["genomes"],)
    return {"genomes": s["genomes"], "variants": s["variants"], "sets": len(traffic["sets"]),
            "monoclonal": int((inputs.weight == 0).sum())}


def check_inputs(config, traffic, inputs, reads):
    """The population's shape: AF inside [1/(2G), 1]; the weights the fixed
    list in its fixed counts; a published FWS of 0.95 or more exactly at
    weight 0."""
    s = _driver.sizes(config, traffic)
    G = s["genomes"]
    assert inputs.af.min() >= 1.0 / (2 * G) - 1e-15 and inputs.af.max() <= 1.0
    values = [0.0] + [float(w) for w in traffic["mixing_weights"]]
    counts = [int((inputs.weight == v).sum()) for v in values]
    assert counts == _driver.weight_counts(G, traffic) and sum(counts) == G
    assert ((inputs.published >= 0.95) == (inputs.weight == 0)).all()


def port_spans(traffic):
    return ["kgt.fws"] + [f"kgt.fws.{s}" for s in ("upload", "variants", "genomes", "fetch")]
