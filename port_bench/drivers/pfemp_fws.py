"""Driver of the PfEMP statistics stage: kgl_gene_tpu_torch.analysis.pfemp_analysis.

Set-up: the driver's own generator (fws_population on the host, then
draw_codes on the device) makes a population from the seed, its genomes'
codes drawn on the card a block of variants at a time, and hands the
analysis its codes (PfEMPAnalysis.prepare_columns): they stay on the card,
variant-major, for the whole run. One analysis a set, each set up through
its resources (initialize_analysis): `qc` with the Pf7 sample resource
(every genome passes QC), `qc_monoclonal` with the Pf7 FWS resource as
well (a genome's published FWS is 0.95 or more exactly when it was drawn
monoclonal). A call is one statistics stage (PfEMPAnalysis.statistics):
the analysis's filters as an index, both passes over the resident codes,
the per-genome and per-variant arrays fetched. The sets are cycled.

Every answer is judged after the window: each distinct answer of each set
against the plain float64 reference (reference/fws.py) computed on the
same device from the same codes, over the subset the set must select:
every count exactly (count_mismatches, the differing counts summed over
the calls), each genome's FWS within FWS_LIMIT (fws_gap). The port's
counters (stats/fws.py COUNTERS) over each set's warm call are printed in
the run's first line.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from port_bench.answers import Answers
from port_bench.reference import fws as reference

UNIT = "genomes"
SPANS = ("fws.call",)
# float64 sums of up to 2 M terms taken in another order differ by ~1e-13
# relative: a genome's FWS by less; hs or AF rounded to float32 move the
# widest genome's FWS by ~1e-10, hs_sum accumulated in float32 by 1e-7 or more
FWS_LIMIT = 1e-11
WRONG_SHAPE = 1e9
# sizes a traffic file may restate (the tests' small runs do)
SIZES = ("genomes", "variants")
# variants drawn on the device at a time: four (block, G) float32 temporaries
DRAW_BLOCK_VARIANTS = 1 << 13


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def sizes(config: dict, traffic: dict) -> dict:
    return {k: int(traffic.get(k, config[k])) for k in SIZES}


class Population(NamedTuple):
    af: np.ndarray         # (V,) float64, each variant's strain allele frequency
    weight: np.ndarray     # (G,) float64, each genome's mixing weight
    published: np.ndarray  # (G,) float64, each genome's "published" Pf7 FWS


def weight_counts(genomes: int, traffic: dict) -> list:
    """How many genomes take each weight of [0] + traffic["mixing_weights"]:
    traffic["monoclonal_share"] of them 0, the rest split as evenly as the
    count allows, the first weights taking one more."""
    mono = int(round(float(traffic["monoclonal_share"]) * genomes))
    k = len(traffic["mixing_weights"])
    q, r = divmod(genomes - mono, k)
    return [mono] + [q + (i < r) for i in range(k)]


def fws_population(seed: int, config: dict, traffic: dict) -> Population:
    """The host's draws of a population, from the seed (numpy only): af (V,)
    from a site-frequency spectrum of density x^-sfs_exponent over [1/(2G),
    1]; each genome's mixing weight from a fixed list permuted by the seed
    (weight_counts); its published FWS 1 - weight / 2, so 0.95 or more
    exactly at weight 0."""
    s = sizes(config, traffic)
    G, V = s["genomes"], s["variants"]
    rng = _rng(seed, 1)
    b = float(traffic["sfs_exponent"]) - 1.0
    low = (2.0 * G) ** b
    af = (low - rng.random(V) * (low - 1.0)) ** (-1.0 / b)
    values = [0.0] + [float(w) for w in traffic["mixing_weights"]]
    weight = rng.permutation(np.repeat(values, weight_counts(G, traffic)))
    return Population(af, weight, 1.0 - weight / 2.0)


def draw_codes(host: Population, seed: int, traffic: dict, codes: torch.Tensor) -> None:
    """Fill codes (V, G) uint8 on the device: a genome's code at a variant is
    the sum of two strain alleles drawn at the variant's AF, the second an
    independent draw with probability the genome's weight, else the first
    again; a homozygous call is made heterozygous at traffic["error_rate"]."""
    V, G = codes.shape
    device = codes.device
    gen = torch.Generator(device=device)
    gen.manual_seed(int(_rng(seed, 2).integers(2**62)))
    af = torch.as_tensor(host.af, dtype=torch.float32, device=device)
    weight = torch.as_tensor(host.weight, dtype=torch.float32, device=device)
    error = float(traffic["error_rate"])
    for v0 in range(0, V, DRAW_BLOCK_VARIANTS):
        v1 = min(v0 + DRAW_BLOCK_VARIANTS, V)
        p = af[v0:v1, None]
        draw = lambda: torch.rand((v1 - v0, G), generator=gen, device=device)  # noqa: E731
        first = draw() < p
        second = torch.where(draw() < weight, draw() < p, first)
        z = first.to(torch.uint8) + second.to(torch.uint8)
        z[(z == 2) & (draw() < error)] = 1
        codes[v0:v1] = z


def counters_of(call) -> dict:
    """The port's counters over one call."""
    from kgl_gene_tpu_torch.stats.fws import COUNTERS

    before = dict(COUNTERS)
    call()
    return {k: n - before.get(k, 0) for k, n in COUNTERS.items() if n != before.get(k, 0)}


def answer_of(result) -> tuple:
    """What a call returns to the host, as arrays: the subset, each genome's
    bins and totals, its FWS, each variant's counts."""
    return (result.index, result.het_bins, result.hom_bins, result.het, result.hom, result.fws,
            result.variant_counts)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from kgl_gene_tpu_torch.analysis.pfemp_analysis import PfEMPAnalysis
        from kgl_gene_tpu_torch.app.resources import AnalysisResources, ResourceType
        from kgl_gene_tpu_torch.genome.genome import GenomeReference
        from kgl_gene_tpu_torch.io.resource_parsers import (
            Pf7FwsResource, Pf7SampleRecord, Pf7SampleResource,
        )
        # the analysis's two stages and the resident layout: a port without
        # them fails here, before any work
        from kgl_gene_tpu_torch.variant.columnar import resident_codes
        prepare = PfEMPAnalysis.prepare_columns
        statistics = PfEMPAnalysis.statistics

        self.device = device
        s = sizes(config, traffic)
        G, V = s["genomes"], s["variants"]
        self.host = fws_population(seed, config, traffic)
        ids = [f"PF7_{g:05d}" for g in range(G)]
        samples = Pf7SampleResource("Pf7Sample", [Pf7SampleRecord(i, qc_pass="True")
                                                  for i in ids])
        published = Pf7FwsResource("Pf7Fws", dict(zip(ids, self.host.published.tolist())))
        self.sets = list(traffic["sets"])
        self.want_index = {"qc": np.arange(G, dtype=np.int64),
                           "qc_monoclonal": np.flatnonzero(self.host.weight == 0)}
        self.analyses = {}
        for name in self.sets:
            resources = AnalysisResources()
            resources.add_resource(ResourceType.GENOME_DATABASE, "Pf3D7",
                                   GenomeReference(config["genome"]["assembly"]))
            resources.add_resource(ResourceType.PF7_SAMPLE, "Pf7Sample", samples)
            if name == "qc_monoclonal":
                resources.add_resource(ResourceType.PF7_FWS, "Pf7Fws", published)
            analysis = PfEMPAnalysis(device)
            if not analysis.initialize_analysis(".", [], resources):
                raise ValueError(f"PfEMP refused the resources of set {name}")
            self.analyses[name] = analysis

        self.codes = resident_codes(V, G, device)
        draw_codes(self.host, seed, traffic, self.codes)
        self.columns = prepare(self.analyses[self.sets[0]], self.codes, ids)
        self.program = lambda name: statistics(self.analyses[name], self.columns)
        self.min_calls = len(self.sets)
        self.genomes_done = 0
        self.calls_done = 0
        counters = []
        for i, name in enumerate(self.sets):  # every shape the window uses
            counters.append(counters_of(lambda: self.call(i)))
            if counters[-1].get("genomes") != len(self.want_index[name]):
                raise RuntimeError(f"set {name} took {counters[-1].get('genomes')} genomes, "
                                   f"not {len(self.want_index[name])}")
        self.work = {"genomes": G, "variants": V, "input_sets": len(self.sets),
                     "sets": self.sets,
                     "genomes_per_set": [len(self.want_index[n]) for n in self.sets],
                     "resident_codes_bytes": V * G, "counters_per_call": counters}
        self.answers = Answers(len(self.sets))

    @property
    def units_per_call(self) -> float:
        """Genomes a call, over the calls recorded (the sets' sizes differ)."""
        return self.genomes_done / max(self.calls_done, 1)

    def call(self, i: int):
        with record_function("fws.call"):
            result = self.program(self.sets[i % len(self.sets)])
        return time.perf_counter(), answer_of(result)

    def record(self, i: int, answer) -> None:
        self.answers.add(i % len(self.sets), answer)
        self.genomes_done += len(answer[0])
        self.calls_done += 1

    def release(self) -> None:
        self.program = self.analyses = self.columns = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self):
        """([("count_mismatches", n, 0), ("fws_gap", gap, FWS_LIMIT)], failed
        calls): n sums, over the calls, the counts (per-variant, per-genome,
        per-bin, and the subset's genomes) that differ from the reference's,
        every count of an answer of the wrong shape; gap is the widest
        distance of a genome's FWS from the reference's over every call."""
        wrong = failed = 0
        gap = 0.0
        for s, seen in enumerate(self.answers.by_set):
            if not seen:
                continue
            index = self.want_index[self.sets[s]]
            ref = reference.statistics(self.codes, index)
            want = [index] + [ref[k].cpu().numpy() for k in ("het_bins", "hom_bins", "het",
                                                             "hom")]
            want.append(np.stack([ref["variant_het"].cpu().numpy(),
                                  ref["variant_hom"].cpu().numpy()]))
            want_fws = ref["fws"].cpu().numpy()
            del ref
            for answer, count in seen:
                got = list(answer[:5]) + [answer[6]]
                differ = sum(int((g != w).sum()) if g.shape == w.shape else w.size
                             for g, w in zip(got, want))
                fws = answer[5]
                g = (float(np.abs(fws - want_fws).max(initial=0.0)) if fws.shape == want_fws.shape
                     else WRONG_SHAPE)
                gap = max(gap, g)
                wrong += differ * count
                failed += count if differ or g > FWS_LIMIT else 0
        return [("count_mismatches", wrong, 0), ("fws_gap", gap, FWS_LIMIT)], failed
