"""Typed sequence-distance metric family: global (NW) and local (infix /
edlib HW-mode) Levenshtein over amino, coding and linear sequences.

Capability parity with the reference metric objects
(kgl_classification/kgl_sequence_distance_impl.h:49-122:
LevenshteinGlobal{Amino,Coding,Linear} / LevenshteinLocal{...} and the
zero-valued blosum80 stubs), consumed by the Pf gene-family analysis
(kga_analytic/kga_analysis_library/kga_analysis_lib_Pfgene.cpp) and the
legacy Pf analysis. The local metric is symmetric by construction: the
shorter sequence takes the query role, exactly the reference's edlib
HW-mode symmetrization (kgl_sequence_distance_impl.cpp:46-76).

Device forms: single pairs evaluate host-side (numpy DP); batched forms
run on the card unless device='cpu': the global metrics through kernel B3
(ops/wavefront.wavefront_levenshtein), the local metrics through kernel
`local` (ops/local.local_levenshtein); on the CPU through their plain
PyTorch versions.

Copy of kgl_gene_tpu/classify/distance.py; batched_metric takes a device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from ..ops.edit_distance import levenshtein_local_numpy, levenshtein_numpy
from ..ops.local import local_levenshtein
from ..ops.wavefront import wavefront_levenshtein

__all__ = [
    "SequenceDistanceMetric",
    "levenshtein_global_amino",
    "levenshtein_local_amino",
    "levenshtein_global_coding",
    "levenshtein_local_coding",
    "levenshtein_global_linear",
    "levenshtein_local_linear",
    "global_blosum80_amino",
    "local_blosum80_amino",
    "batched_metric",
]


def _codes_of(seq) -> np.ndarray:
    """Accept raw uint8 code arrays or sequence objects with .codes."""
    return np.asarray(getattr(seq, "codes", seq), dtype=np.uint8)


class SequenceDistanceMetric:
    """A named distance metric callable on two sequences (the reference's
    SequenceDistanceMetric<Seq> function object)."""

    def __init__(self, name: str, fn: Callable[[np.ndarray, np.ndarray], float]):
        self.name = name
        self._fn = fn

    def __call__(self, seq_a, seq_b) -> float:
        return float(self._fn(_codes_of(seq_a), _codes_of(seq_b)))

    def __repr__(self):
        return f"SequenceDistanceMetric({self.name})"


# Typed instances. The alphabets share the uint8-code representation, so
# the same DP core serves every type; the typed names preserve the
# reference API surface (and forbid cross-type comparison by convention).
levenshtein_global_amino = SequenceDistanceMetric(
    "LevenshteinGlobalAmino", levenshtein_numpy)
levenshtein_local_amino = SequenceDistanceMetric(
    "LevenshteinLocalAmino", levenshtein_local_numpy)
levenshtein_global_coding = SequenceDistanceMetric(
    "LevenshteinGlobalCoding", levenshtein_numpy)
levenshtein_local_coding = SequenceDistanceMetric(
    "LevenshteinLocalCoding", levenshtein_local_numpy)
levenshtein_global_linear = SequenceDistanceMetric(
    "LevenshteinGlobalLinear", levenshtein_numpy)
levenshtein_local_linear = SequenceDistanceMetric(
    "LevenshteinLocalLinear", levenshtein_local_numpy)
# blosum80 metrics return 0 in the reference (stub parity:
# kgl_sequence_distance_impl.h:65-76).
global_blosum80_amino = SequenceDistanceMetric(
    "globalblosum80Amino", lambda a, b: 0.0)
local_blosum80_amino = SequenceDistanceMetric(
    "localblosum80Amino", lambda a, b: 0.0)


def batched_metric(
    metric: SequenceDistanceMetric,
    seqs_a: Sequence, seqs_b: Sequence,
    device=None,
) -> np.ndarray:
    """Evaluate a metric over aligned pair lists through the batched device
    kernels (global -> kernel B3; local -> kernel `local`), on the card
    unless device='cpu'. Returns (n,) int64."""
    a_codes = [_codes_of(s) for s in seqs_a]
    b_codes = [_codes_of(s) for s in seqs_b]
    n = len(a_codes)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    wa = max(max((len(c) for c in a_codes), default=1), 1)
    wb = max(max((len(c) for c in b_codes), default=1), 1)
    A = np.zeros((n, wa), np.uint8)
    B = np.zeros((n, wb), np.uint8)
    la = np.zeros(n, np.int32)
    lb = np.zeros(n, np.int32)
    for i, (ca, cb) in enumerate(zip(a_codes, b_codes)):
        A[i, : len(ca)] = ca
        B[i, : len(cb)] = cb
        la[i], lb[i] = len(ca), len(cb)
    if "Local" in metric.name:
        return np.asarray(local_levenshtein(A, la, B, lb, device=device), np.int64)
    if "blosum" in metric.name:
        return np.zeros(n, dtype=np.int64)
    return np.asarray(wavefront_levenshtein(A, la, B, lb, device=device), np.int64)
