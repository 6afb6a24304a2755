"""Driver of one inbreeding estimator over genomes' zygosity rows:
kgl_gene_tpu_torch.stats.inbreeding.run_estimator(config["estimator"], ...).

A call is F for every genome of one input set, from its (G, L) int32
zygosity, (L,) float32 minor allele frequencies and (G, L) mask already on
the device, fetched to the host. zygosity_rows, the driver's own
generator, makes the sets from the seed; the run cycles through them.
Judged: every distinct answer of every set against the float64 reference
(reference/zygosity_rows.py), by the widest gap of a genome's F.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from port_bench.answers import Answers
from port_bench.reference.zygosity_rows import simple_f

UNIT = "genomes"
SPANS = ("rows.call",)
LIMIT = 1e-5
WRONG_SHAPE = 1e9


def zygosity_rows(seed: int, traffic: dict):
    """traffic["sets"] pairs (zygosity (G, L) int32 in {0, 1, 2}, minor
    allele frequencies (L,) float64 uniform in [min_af, max_af]): each
    genotype two draws of the minor allele at its frequency."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 1])
    G, L = int(traffic["genomes"]), int(traffic["loci"])
    out = []
    for _ in range(int(traffic["sets"])):
        p = rng.uniform(float(traffic["min_af"]), float(traffic["max_af"]), L)
        z = (rng.random((G, L)) < p).astype(np.int32) + (rng.random((G, L)) < p)
        out.append((z, p))
    return out


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from kgl_gene_tpu_torch.stats.inbreeding import run_estimator

        self.device = device
        self.sets = zygosity_rows(seed, traffic)
        self.on_device = [(torch.as_tensor(z, device=device),
                           torch.as_tensor(p.astype(np.float32), device=device),
                           torch.ones(z.shape, dtype=torch.bool, device=device))
                          for z, p in self.sets]
        algorithm = config["estimator"]
        self.program = lambda z, p, valid: run_estimator(algorithm, z, p, valid)
        G, L = self.sets[0][0].shape
        self.units_per_call = G
        self.min_calls = len(self.sets)
        for s in range(1, len(self.sets)):  # every shape the window uses
            self.call(s)
        self.work = {"genomes_per_call": G, "loci": L, "input_sets": len(self.sets),
                     "estimator": algorithm}
        self.answers = Answers(len(self.sets))

    def call(self, i: int):
        with record_function("rows.call"):
            f = self.program(*self.on_device[i % len(self.sets)])
            t_return = time.perf_counter()
            answer = (f.cpu().numpy(),)
        return t_return, answer

    def record(self, i: int, answer) -> None:
        self.answers.add(i % len(self.sets), answer)

    def release(self) -> None:
        self.program = self.on_device = None

    def judge(self):
        """([("f_gap", widest gap of a genome's F, LIMIT)], failed calls)."""
        worst, failed = 0.0, 0
        for s, seen in enumerate(self.answers.by_set):
            want = simple_f(*self.sets[s]) if seen else None
            for (f,), count in seen:
                gap = (float(np.abs(f.astype(np.float64) - want).max())
                       if f.shape == want.shape else WRONG_SHAPE)
                worst = max(worst, gap)
                failed += count if gap > LIMIT else 0
        return [("f_gap", worst, LIMIT)], failed
