"""Driver of a gene family's all-pairs distance matrix.

A call is the (n, n) float64 matrix of one family of distinct coding
haplotypes, on the host, as TranscriptFamilyAnalysis.distance_tree_newick
builds it before its tree:
  metric "global": kgl_gene_tpu_torch.ops.edit_distance.
      pairwise_distance_matrix(seqs, lens, band_k=traffic["band"]) (B1's
      per-pair pool with the pairs gathered on the card);
  metric "local": gathered_pairs(batched_levenshtein_local_kernel, pool,
      lens, iu, ju) over the upper triangle, then the symmetric matrix on
      the host. The port has no function for this matrix: these lines copy
      distance_tree_newick's local branch (analysis/lib_seqmutation.py).
The run cycles through the traffic's input sets.

Judged: every call's whole matrix on the host for its stated guarantees
(symmetric, zero diagonal), and after the window every entry of the upper
triangle of every answer against the reference (reference/dp.py), each
distinct answer of an input set held once and counted for each call that
returned it.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import generate
from port_bench.answers import Answers
from port_bench.drivers.forward_step import launches_per_call
from port_bench.reference.dp import pair_distances

UNIT = "pairs"
SPANS = ("matrix.call",)


def _local_matrix(seqs, lens, device):
    from kgl_gene_tpu_torch.ops.edit_distance import gathered_pairs
    from kgl_gene_tpu_torch.ops.local import batched_levenshtein_local_kernel

    n = len(seqs)
    iu, ju = np.triu_indices(n, k=1)
    pool = torch.as_tensor(seqs.astype(np.int32), device=device)
    pool_lens = torch.as_tensor(lens, device=device)
    d = gathered_pairs(batched_levenshtein_local_kernel, pool, pool_lens, iu, ju)
    matrix = np.zeros((n, n), dtype=np.float64)
    matrix[iu, ju] = d
    matrix[ju, iu] = d
    return matrix


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from kgl_gene_tpu_torch.ops.edit_distance import pairwise_distance_matrix

        self.device = device
        self.region, self.sets = generate.inputs(seed, config, traffic)
        n, S = self.sets[0].shape
        self.lens = np.full(n, S, dtype=np.int32)
        self.local = traffic["metric"] == "local"
        if self.local:
            self.program = lambda seqs: _local_matrix(seqs, self.lens, device)
        else:
            band = int(traffic["band"])
            self.program = lambda seqs: pairwise_distance_matrix(seqs, self.lens, band_k=band,
                                                                 device=device)
        P = n * (n - 1) // 2
        self.iu, self.ju = np.triu_indices(n, k=1)
        self.units_per_call = P
        self.min_calls = len(self.sets)
        for s in range(1, len(self.sets)):  # every shape the window uses
            self.call(s)
        self.work = {"pairs_per_call": P, "haplotypes": n, "coding_bases": S,
                     "snp_slots": int(traffic["slots"]),
                     "input_sets": len(self.sets), "metric": traffic["metric"],
                     "band": 0 if self.local else int(traffic["band"]),
                     "launches_per_call": launches_per_call(lambda: self.call(0))}
        self.answers = Answers(len(self.sets))

    def call(self, i: int):
        with record_function("matrix.call"):
            matrix = self.program(self.sets[i % len(self.sets)])
        return time.perf_counter(), matrix

    def record(self, i: int, matrix) -> None:
        """The upper triangle, and the count of entries that break the
        symmetry or the zero diagonal (every entry, for a wrong shape)."""
        n = len(self.sets[0])
        if matrix.shape != (n, n):
            entries, broken = np.full(len(self.iu), -1.0), n * n
        else:
            entries = matrix[self.iu, self.ju]
            broken = (np.count_nonzero(np.diag(matrix))
                      + np.count_nonzero(entries != matrix[self.ju, self.iu]))
        self.answers.add(i % len(self.sets), (entries, np.array([broken])))

    def release(self) -> None:
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self):
        """([("entry_mismatches", n, 0)], failed calls): n counts, over every
        call of the window, the upper-triangle entries that differ from the
        reference's, and the entries that break the symmetry or the zero
        diagonal."""
        wrong = failed = 0
        for s, seen in enumerate(self.answers.by_set):
            if not seen:
                continue
            seqs = torch.as_tensor(self.sets[s], device=self.device)
            want = pair_distances(seqs[self.iu], seqs[self.ju], local=self.local).cpu().numpy()
            for (entries, broken), count in seen:
                n_bad = int((entries != want).sum()) + int(broken[0])
                wrong += n_bad * count
                failed += count if n_bad else 0
        return [("entry_mismatches", wrong, 0)], failed
