"""Driver of the INBREED analysis: kgl_gene_tpu_torch.analysis.inbreed_analysis.

Set-up: the driver's own generator (inbreed_population, then draw_codes)
makes a population from the seed, its genomes' codes drawn on the device
a block of variants at a time, and hands the analysis its columns
(InbreedAnalysis.prepare_columns): the codes stay on the card, variant-major,
for the whole run. The analysis is set up through its XML parameters
(initialize_analysis). A call is one estimate (InbreedAnalysis.estimate)
with one AF column, the traffic's sets cycled: the loci selected on the
host, gathered on the card, the configuration's algorithms run on them, and
(G, n) F fetched.

Every answer is judged: each distinct answer of each set against the plain
float64 reference (reference/inbreed.py) computed on the same device from
the same codes: the selected loci exactly, and each estimator's F within
its TOLERANCE. The reference's loci and HallME are computed in set-up (the
HallME steps it needs price the estimators' roofline), the rest after the
window. The port's counters (stats/inbreeding.py COUNTERS) over each set's
warm call are printed in the run's first line.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from port_bench.answers import Answers
from port_bench.reference import inbreed as reference

UNIT = "genomes"
SPANS = ("inbreed.call",)
WRONG_SHAPE = 1e9
# sizes a traffic file may restate (the tests' small runs do)
SIZES = ("samples_by_super_population", "records", "first_position", "last_position",
         "analysis")
# variants drawn on the device at a time: four (block, G) float32 temporaries
DRAW_BLOCK_VARIANTS = 1 << 15


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def sizes(config: dict, traffic: dict) -> dict:
    return {k: traffic.get(k, config[k]) for k in SIZES}


def super_population_of(column: str) -> str:
    """The super population an AF column names: AF is ALL, AFR_AF is AFR."""
    return "ALL" if column == "AF" else column.split("_")[0]


class Population(NamedTuple):
    positions: np.ndarray      # (V,) int64
    is_snp: np.ndarray         # (V,) bool
    af: np.ndarray             # (V,) float64
    pop_af: np.ndarray         # (V, S) float64
    population: np.ndarray     # (G,) super-population index
    f: np.ndarray              # (G,) float64
    super_populations: list    # the S names


def inbreed_population(seed: int, config: dict, traffic: dict) -> Population:
    """The host's draws of a population, from the seed (numpy only):
    positions (V,) sorted, the first and last the configuration's; is_snp
    (V,) at traffic["snp_share"]; af (V,) from a site-frequency spectrum of
    density x^-sfs_exponent over [1/(2G), 1]; pop_af (V, S), each super
    population's AF drawn around af (Balding-Nichols at traffic["fst"]);
    population (G,) super-population index and f (G,) inbreeding
    coefficient of each genome, fixed lists permuted by the seed."""
    s = sizes(config, traffic)
    counts = s["samples_by_super_population"]
    G, V = sum(counts.values()), int(s["records"])
    lo, hi = int(s["first_position"]), int(s["last_position"])
    rng = _rng(seed, 1)
    positions = np.concatenate([[lo], np.sort(rng.integers(lo, hi + 1, V - 2)), [hi]])
    is_snp = rng.random(V) < float(traffic["snp_share"])
    b = float(traffic["sfs_exponent"]) - 1.0
    low = (2.0 * G) ** b
    af = (low - rng.random(V) * (low - 1.0)) ** (-1.0 / b)
    fst = float(traffic["fst"])
    shape = (1.0 - fst) / fst
    pop_af = rng.beta(np.repeat(af * shape, len(counts)).reshape(V, -1),
                      np.repeat((1.0 - af) * shape, len(counts)).reshape(V, -1))
    population = rng.permutation(np.repeat(np.arange(len(counts)), list(counts.values())))
    shares = np.asarray(traffic["f_shares"], dtype=np.float64)
    per_f = np.floor(shares / shares.sum() * G).astype(np.int64)
    per_f[0] += G - per_f.sum()
    f = rng.permutation(np.repeat(np.asarray(traffic["f_values"], dtype=np.float64), per_f))
    return Population(positions.astype(np.int64), is_snp, af, pop_af, population, f,
                      list(counts))


def draw_codes(host: Population, seed: int, device: torch.device):
    """(codes (V, G) uint8 on the device, AF columns): each genome's
    genotype at a variant is two draws of the alternate allele at its super
    population's AF, one draw twice with probability its f (identical by
    descent); the AF columns are then counted from the codes, AC / AN, as
    the release's INFO fields are: AF over every genome, <S>_AF over S's."""
    V, S = host.pop_af.shape
    G = host.population.shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(_rng(seed, 2).integers(2**62)))
    population = torch.as_tensor(host.population, device=device)
    f = torch.as_tensor(host.f, dtype=torch.float32, device=device)
    pop_af = torch.as_tensor(host.pop_af, dtype=torch.float32, device=device)
    members = [torch.nonzero(population == s)[:, 0] for s in range(S)]
    codes = torch.empty((V, G), dtype=torch.uint8, device=device)
    ac = torch.empty((V, S), dtype=torch.int64, device=device)
    for v0 in range(0, V, DRAW_BLOCK_VARIANTS):
        v1 = min(v0 + DRAW_BLOCK_VARIANTS, V)
        p = pop_af[v0:v1].index_select(1, population)
        draw = lambda: torch.rand((v1 - v0, G), generator=gen, device=device)  # noqa: E731
        first = draw() < p
        second = torch.where(draw() < f, first, draw() < p)
        z = first.to(torch.uint8) + second.to(torch.uint8)
        codes[v0:v1] = z
        for s, idx in enumerate(members):
            ac[v0:v1, s] = z.index_select(1, idx).sum(1, dtype=torch.int64)
    ac = ac.cpu().numpy()
    an = 2.0 * np.array([len(m) for m in members], dtype=np.float64)
    columns = {"ALL": ac.sum(1) / (2.0 * G)}
    for s, name in enumerate(host.super_populations):
        columns[name] = ac[:, s] / an[s]
    return codes, columns


def counters_of(call) -> dict:
    """The port's counters over one call."""
    from kgl_gene_tpu_torch.stats.inbreeding import COUNTERS

    before = dict(COUNTERS)
    call()
    return {k: n - before.get(k, 0) for k, n in COUNTERS.items() if n != before.get(k, 0)}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from kgl_gene_tpu_torch.analysis.inbreed_analysis import InbreedAnalysis
        from kgl_gene_tpu_torch.app.runtime import ParameterMap

        self.device = device
        s = sizes(config, traffic)
        self.params = {k: str(v) for k, v in s["analysis"].items()}
        analysis = InbreedAnalysis(device)
        # the analysis's first stage: a port without it fails here, before any work
        prepare = analysis.prepare_columns
        block = ParameterMap("INBREED", {k: [v] for k, v in self.params.items()})
        if not analysis.initialize_analysis(".", [block], None):
            raise ValueError(f"INBREED refused the parameters {self.params}")
        self.host = inbreed_population(seed, config, traffic)
        self.codes, self.frequencies = draw_codes(self.host, seed, device)
        V, G = self.codes.shape
        self.columns = prepare(
            self.codes, self.host.positions, np.zeros(V, dtype=np.int32), self.host.is_snp,
            [f"G{g:04d}" for g in range(G)], self.frequencies)
        self.analysis = analysis
        self.program = lambda column: analysis.estimate(self.columns, super_population_of(column))
        self.sets = list(traffic["sets"])
        self.units_per_call = G
        self.min_calls = len(self.sets)
        loci = int(self.params["LociiCount"])
        counters = []
        for i, column in enumerate(self.sets):  # every shape the window uses
            counters.append(counters_of(lambda: self.call(i)))
            if counters[-1].get("loci") != loci:
                raise RuntimeError(f"set {column} selected {counters[-1].get('loci')} loci, "
                                   f"not LociiCount {loci}: the traffic does not fix the work")
        self.want_loci, self.want_hall, steps = [], [], []
        for column in self.sets:
            want = self.reference_loci(column)
            hall, k = reference.hall_me(self.codes, want, self.af(column)[want])
            self.want_loci.append(want)
            self.want_hall.append(hall)
            steps.append(int(k.max()))
        self.work = {"genomes_per_call": G, "variants": V, "loci_per_call": loci,
                     "input_sets": len(self.sets), "columns": self.sets,
                     "algorithms": analysis.algorithms, "analysis": self.params,
                     "resident_codes_bytes": V * G, "reference_hallme_steps": steps,
                     "counters_per_call": counters}
        self.answers = Answers(len(self.sets))

    def af(self, column: str) -> np.ndarray:
        return self.frequencies[super_population_of(column)]

    def reference_loci(self, column: str) -> np.ndarray:
        p = self.params
        return reference.select_loci(
            self.host.positions, np.zeros(len(self.host.positions), dtype=np.int32),
            self.host.is_snp, self.af(column), float(p["MinAF"]), float(p["MaxAF"]),
            int(p["SamplingDistance"]), int(p["LociiCount"]))

    def call(self, i: int):
        with record_function("inbreed.call"):
            estimate = self.program(self.sets[i % len(self.sets)])
        return time.perf_counter(), (estimate.f, estimate.loci)

    def record(self, i: int, answer) -> None:
        self.answers.add(i % len(self.sets), answer)

    def release(self) -> None:
        self.program = self.analysis = self.columns = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self):
        """([("loci_mismatches", n, 0), ("f_gap.<algorithm>", gap, TOLERANCE)
        for each algorithm], failed calls): n counts the calls whose selected
        loci differ from the reference's; a gap is the widest distance of a
        genome's F from the reference's over every call."""
        algorithms = self.work["algorithms"]
        gaps = dict.fromkeys(algorithms, 0.0)
        wrong_loci = failed = 0
        for s, seen in enumerate(self.answers.by_set):
            if not seen:
                continue
            loci = self.want_loci[s]
            want = reference.estimators(self.codes, loci, self.af(self.sets[s])[loci],
                                        hall=self.want_hall[s]).cpu().numpy()
            want = want[:, [reference.ESTIMATORS.index(a) for a in algorithms]]
            for (f, got_loci), count in seen:
                bad = not np.array_equal(got_loci, loci)
                wrong_loci += count if bad else 0
                gap = (np.abs(f.astype(np.float64) - want).max(0) if f.shape == want.shape
                       else np.full(len(algorithms), WRONG_SHAPE))
                for a, g in zip(algorithms, gap):
                    gaps[a] = max(gaps[a], float(g))
                    bad |= g > reference.TOLERANCE[a]
                failed += count if bad else 0
        checks = [("loci_mismatches", wrong_loci, 0)]
        checks += [(f"f_gap.{a}", gaps[a], reference.TOLERANCE[a]) for a in algorithms]
        return checks, failed
