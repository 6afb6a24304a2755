"""Test hooks of the pair-matrix driver's cells (see cells/__init__.py).

Control: the upper triangle alone, the mirror into the lower one left out
(the symmetry guarantee broken: what a matrix would do whose host
assembly was cut to the half the tree reads). The Hamming distance in
place of the edit distance is no control here: on these haplotypes, a few
substitutions apart, the two seldom differ.
Faults (the program's own outputs, broken where they are produced):
  stale: each call returns the matrix of the call before it;
  half: only the first half of the family is computed, its rows standing
      in for the rest;
  altered: one entry in 128 of the matrix changed, in both halves.
The exchange between cards is not a fault of these cells: each runs on
one card.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import generate
from port_bench.reference.dp import pair_distances
from port_bench.tests.cells._gene import check_gene

GENERATORS = ("haplotype_sets",)
SMALL = {"haplotypes": 8, "sets": 2}
CONTROL_SMALL = {"haplotypes": 24, "sets": 1}


def control(cell):
    cache = {}

    def program(seqs):
        key = id(seqs)
        if key not in cache:
            s = torch.as_tensor(seqs, device=cell.device)
            n = s.shape[0]
            out = np.zeros((n, n), dtype=np.float64)
            out[cell.iu, cell.ju] = pair_distances(s[cell.iu], s[cell.ju],
                                                   local=cell.local).cpu().numpy()
            cache[key] = out  # the lower triangle is never filled
        return cache[key]

    cell.program = program


def stale(cell):
    real = cell.program
    last = [real(cell.sets[-1])]

    def program(seqs):
        out = real(seqs)
        prev, last[0] = last[0], out
        return prev

    cell.program = program


def half(cell):
    real = cell.program

    def program(seqs):
        h = seqs.shape[0] // 2
        return real(np.concatenate([seqs[:h], seqs[: seqs.shape[0] - h]]))

    cell.program = program


def altered(cell):
    real = cell.program

    def program(seqs):
        m = real(seqs).copy()
        iu, ju = np.triu_indices(m.shape[0], k=1)
        iu, ju = iu[::128], ju[::128]
        m[iu, ju] += 1
        m[ju, iu] += 1
        return m

    cell.program = program


FAULTS = {"stale": stale, "half": half, "altered": altered}


def work_of(config, traffic, inputs):
    _region, sets = inputs
    n, S = sets[0].shape
    assert all(s.shape == (n, S) for s in sets)
    return {"haplotypes": n, "bases": S, "pairs": n * (n - 1) // 2, "sets": len(sets),
            "metric": traffic["metric"], "band": traffic.get("band")}


def check_inputs(config, traffic, inputs, reads):
    """The gene's reading frame; each haplotype within the traffic's slots
    of the gene, all distinct; for the global metric, the analysis's own
    band, and where the cell reads kernel B1's roofline, every pair of the
    family inside that band, so that B1 answers each pair itself."""
    from kgl_gene_tpu_torch.analysis.lib_seqmutation import DEVICE_BAND

    region, sets = inputs
    check_gene(config, region)
    coding = generate.coding_of(region, config)
    for haps in sets:
        assert ((haps != coding[None, :]).sum(1) <= traffic["slots"]).all()
        assert len(np.unique(haps, axis=0)) == len(haps)
    if traffic["metric"] == "global":
        assert traffic["band"] == DEVICE_BAND
        if any(name.split(".")[0] == "b1_roofline_pct" for name in reads):
            assert 2 * traffic["slots"] <= traffic["band"]


def port_spans(traffic):
    if traffic["metric"] == "local":  # the driver's copy of the local branch: gathered_pairs alone
        return [f"kgt.pairs.{s}" for s in ("upload", "gather", "distance", "fetch")]
    return ["kgt.pairs"] + [f"kgt.pairs.{s}" for s in
                            ("index", "upload", "gather", "distance", "fetch", "assemble")]
