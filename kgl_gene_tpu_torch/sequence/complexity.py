"""Sequence complexity measures.

Capability parity with SequenceComplexity
(kgl_genomics/kgl_legacy/kgl_sequence_complexity.h:13-140): Lempel-Ziv
(LZ76) complexity, alphabet Shannon entropy normalised by alphabet size,
relative CpG island density (observed CG pairs x 32 / length — one CpG
expected every 32 random nucleotides), and k-mer counting — vectorized
where the access pattern allows.

Copy of kgl_gene_tpu/sequence/complexity.py.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from .alphabet import DNA5
from .sequence import DNA5SequenceCoding, DNA5SequenceLinear

__all__ = [
    "complexity_lempel_ziv",
    "alphabet_entropy",
    "relative_cpg_islands",
    "kmer_count",
]

_Seq = Union[DNA5SequenceLinear, DNA5SequenceCoding, np.ndarray]


def _codes(sequence: _Seq) -> np.ndarray:
    return sequence.codes if hasattr(sequence, "codes") else np.asarray(sequence)


def complexity_lempel_ziv(sequence: _Seq) -> int:
    """LZ76 complexity: number of distinct phrases in the left-to-right
    exhaustive parse."""
    codes = _codes(sequence)
    n = len(codes)
    if n == 0:
        return 0
    data = codes.tobytes()
    complexity = 0
    i = 0
    while i < n:
        length = 1
        # Extend the phrase while data[i:i+length] occurs in data[:i+length-1].
        while i + length <= n and data.find(data[i : i + length], 0, i + length - 1) != -1:
            length += 1
        complexity += 1
        i += length
    return complexity


def alphabet_entropy(sequence: _Seq, alphabet_size: int = 5) -> float:
    """Shannon entropy of symbol frequencies, normalised to [0, 1] by
    log(alphabet size)."""
    codes = _codes(sequence)
    if len(codes) == 0:
        return 0.0
    counts = np.bincount(codes, minlength=alphabet_size).astype(np.float64)
    ratios = counts[counts > 0] / len(codes)
    return float(-(ratios * np.log(ratios)).sum() / np.log(alphabet_size))


def relative_cpg_islands(sequence: _Seq) -> float:
    """Observed 'CG' dinucleotides x 32 / length."""
    codes = _codes(sequence)
    if len(codes) < 2:
        return 0.0
    count = int(np.sum((codes[:-1] == DNA5.C) & (codes[1:] == DNA5.G)))
    return count * 32.0 / len(codes)


def kmer_count(sequence: _Seq, kmer: _Seq) -> int:
    """Occurrences of a k-mer in the sequence (overlapping)."""
    seq_codes = _codes(sequence)
    kmer_codes = _codes(kmer)
    k = len(kmer_codes)
    if k == 0 or len(seq_codes) < k:
        return 0
    windows = np.lib.stride_tricks.sliding_window_view(seq_codes, k)
    return int(np.sum(np.all(windows == kmer_codes, axis=1)))
