"""Driver of the forward step: kgl_gene_tpu_torch.ops.pipeline.make_forward_step.

A call is one step over one cohort of genomes, called with numpy arrays as
users call it (the step uploads them itself), and the fetch of what the
cohort analysis reads on the host: distance, validity_code, valid_protein,
allele_counts, and the amino acids of a sample of genomes drawn from the
seed (traffic["amino_rows"]). mutated_coding and the other genomes' amino
acids stay on the card. The run cycles through the traffic's input sets.

Every answer is judged: each distinct output of each input set is held
against the reference's (reference/gene.py), genome by genome and slot by
slot, and counted once for each call that returned it. The route (which
of the port's kernels a step launches) is read from the port's own launch
counter over one warm step, not worked out here.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import generate
from port_bench.answers import Answers
from port_bench.reference.gene import step_outputs

UNIT = "genomes"
SPANS = ("step.call", "step.fetch")
OUTPUTS = ("distance", "validity_code", "valid_protein", "allele_counts", "amino")
# The port's amino-acid codes, in the order of its alphabet (the reference
# C++'s kgl_alphabet_amino.h), read only to judge its output as letters.
PORT_AMINO_LETTERS = "FLSYCWPHQRIMTNKVADEG*ZUO"


def launches_per_call(call) -> dict:
    """The port's kernel launches of one call, by kernel, from its counter."""
    from kgl_gene_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    call()
    return {k: n - before.get(k, 0) for k, n in kernels.LAUNCHES.items() if n > before.get(k, 0)}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from kgl_gene_tpu_torch.ops.pipeline import make_forward_step

        self.config = config
        self.device = device
        self.region, self.sets = generate.inputs(seed, config, traffic)
        start = int(config.get("region_start", 0))
        self.exons = [(lo - start, hi - start) for lo, hi in config["exons"]]
        self.reverse = config.get("strand", "+") == "-"
        self.program = make_forward_step(self.region, np.asarray(config["exons"], dtype=np.int64),
                                         start, reverse_strand=self.reverse,
                                         table_name=config["table"], device=device)
        B, K = self.sets[0][0].shape
        rows = np.sort(generate.rng_for(seed, 2).choice(B, int(traffic["amino_rows"]),
                                                        replace=False))
        self.amino_rows = rows
        self.amino_index = torch.as_tensor(rows, device=device)
        S = sum(hi - lo for lo, hi in self.exons)
        self.units_per_call = B
        self.min_calls = len(self.sets)
        for s in range(1, len(self.sets)):  # every shape the window uses
            self.call(s)
        self.work = {"genomes_per_call": B, "snp_slots": K, "coding_bases": S,
                     "region_bases": int(self.region.shape[0]), "strand": config["strand"],
                     "amino_rows_fetched": len(rows), "input_sets": len(self.sets),
                     "launches_per_call": launches_per_call(lambda: self.call(0))}
        self.answers = Answers(len(self.sets))

    def call(self, i: int):
        positions, alt, valid = self.sets[i % len(self.sets)]
        with record_function("step.call"):
            out = self.program(positions, alt, valid)
        t_return = time.perf_counter()
        with record_function("step.fetch"):
            answer = tuple(getattr(out, name).cpu().numpy() for name in OUTPUTS[:-1])
            answer += (out.amino.index_select(0, self.amino_index).cpu().numpy(),)
        return t_return, answer

    def record(self, i: int, answer) -> None:
        self.answers.add(i % len(self.sets), answer)

    def release(self) -> None:
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self):
        """([("answer_mismatches", n, 0)], failed calls): n counts, over every
        call of the window, the genomes whose distance, validity code, valid
        flag or (in the sample) amino acids, and the slots whose allele
        count, differ from the reference's."""
        region = torch.as_tensor(self.region, device=self.device)
        letters = np.zeros(256, dtype=np.uint8)
        letters[: len(PORT_AMINO_LETTERS)] = np.frombuffer(PORT_AMINO_LETTERS.encode(), np.uint8)
        wrong = failed = 0
        for s, seen in enumerate(self.answers.by_set):
            if not seen:
                continue
            inputs = (torch.as_tensor(x, device=self.device) for x in self.sets[s])
            want = step_outputs(region, self.exons, *inputs, reverse=self.reverse)
            want = {k: v.cpu().numpy() for k, v in want.items()}
            want["amino"] = want["amino"][self.amino_rows]
            for answer, count in seen:
                got = dict(zip(OUTPUTS, answer))
                got["amino"] = letters[got["amino"].astype(np.uint8)]
                genomes = (_differ(got, want, "distance") | _differ(got, want, "validity_code")
                           | _differ(got, want, "valid_protein"))
                genomes[self.amino_rows] |= _differ(got, want, "amino").any(1)
                n_bad = int(genomes.sum()) + int(_differ(got, want, "allele_counts").sum())
                wrong += n_bad * count
                failed += count if n_bad else 0
        return [("answer_mismatches", wrong, 0)], failed


def _differ(got: dict, want: dict, name: str) -> np.ndarray:
    """Where an output differs from the reference's (everywhere, if its shape does)."""
    g, w = got[name], want[name]
    if g.shape != w.shape:
        return np.ones(w.shape, dtype=bool)
    return g.astype(np.int64) != w.astype(np.int64)
