"""Transcript-family statistics: distances, CIGARs and a UPGMA tree over
the distinct mutant coding sequences of one transcript.

Counterpart of kgl_gene_tpu/analysis/lib_seqmutation.py, cut to
TranscriptMutateRecord and TranscriptFamilyAnalysis (the reference's
kga_analysis_lib_seq_stats.cpp:290-456). Each device step runs on the
card unless the analysis was made with device='cpu':

  - reference_distances: global metric on the exact wavefront (kernel
    B3), local (infix) metric in plain PyTorch;
  - distance_tree_newick: the all-pairs matrix (on the card, kernel B1's
    pair pool at band 127 with its exact overflow re-run; on the CPU the
    exact route), then UPGMA and Newick on the host;
  - reference_cigars: the banded traceback (kernel B4, ops/traceback).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import int32_on, resolve_device
from ..classify.upgma import newick, upgma_tree
from ..genome.features import CodingSequenceValidity
from ..ops.edit_distance import batched_levenshtein_local, pairwise_distance_matrix
from ..ops.traceback import batched_cigar
from ..ops.wavefront import wavefront_levenshtein
from ..sequence.alphabet import DNA5

__all__ = ["TranscriptFamilyAnalysis", "TranscriptMutateRecord"]

DEVICE_BAND = 127  # the all-pairs band on the card, as on the TPU


@dataclass
class TranscriptMutateRecord:
    """One genome x transcript mutation outcome."""

    genome_id: str
    gene_id: str
    transcript_id: str
    variant_count: int
    modified_coding: str
    validity: CodingSequenceValidity
    distance: Optional[int] = None  # Levenshtein vs reference coding


class TranscriptFamilyAnalysis:
    """Per-transcript-family distance statistics and UPGMA trees.

    metric: "global" (NW, the default) or "local" (infix, edlib HW mode,
    the Pf gene-family metric)."""

    def __init__(self, records: List[TranscriptMutateRecord], reference_coding: str,
                 metric: str = "global", device=None):
        self.records = records
        self.reference_coding = reference_coding
        self.metric = metric
        self.device = resolve_device(device)

    def distinct_sequences(self) -> Dict[str, List[str]]:
        """Modified sequence -> genomes carrying it, in first-seen order."""
        out: Dict[str, List[str]] = {}
        for rec in self.records:
            out.setdefault(rec.modified_coding, []).append(rec.genome_id)
        return out

    def _padded_codes(self, sequences: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        width = max((len(s) for s in sequences), default=1)
        seqs = np.zeros((len(sequences), width), dtype=np.uint8)
        lens = np.zeros(len(sequences), dtype=np.int32)
        for i, s in enumerate(sequences):
            codes = DNA5.from_string(s) if s else np.empty(0, np.uint8)
            seqs[i, : len(codes)] = codes
            lens[i] = len(codes)
        return seqs, lens

    def _local(self, seq_a, len_a, seq_b, len_b) -> np.ndarray:
        return batched_levenshtein_local(
            *int32_on(self.device, seq_a, len_a, seq_b, len_b)).cpu().numpy()

    def reference_distances(self) -> Dict[str, int]:
        """Distance of each distinct mutant to the reference coding
        sequence (global NW or local infix, per self.metric)."""
        distinct = list(self.distinct_sequences())
        if not distinct:
            return {}
        seqs, lens = self._padded_codes(distinct + [self.reference_coding])
        n = len(distinct)
        ref_len = np.repeat(lens[-1:], n)
        if self.metric == "local":
            distances = self._local(seqs[:n], lens[:n], np.repeat(seqs[-1:], n, axis=0),
                                    ref_len)
        else:  # one reference row shared by every pair
            distances = wavefront_levenshtein(seqs[:n], lens[:n], seqs[-1:], ref_len,
                                              device=self.device)
        return dict(zip(distinct, distances.tolist()))

    def distance_tree_newick(self, max_leaves: int = 256) -> str:
        """All-pairs distance over distinct sequences -> UPGMA -> Newick."""
        distinct = self.distinct_sequences()
        labels = []
        sequences = []
        for seq, genomes in list(distinct.items())[:max_leaves]:
            labels.append(genomes[0] if len(genomes) == 1 else f"{genomes[0]}+{len(genomes) - 1}")
            sequences.append(seq)
        if len(sequences) < 2:
            return f"({labels[0] if labels else 'reference'}:0);"
        seqs, lens = self._padded_codes(sequences)
        if self.metric == "local":
            n = len(sequences)
            iu, ju = np.triu_indices(n, k=1)
            d = self._local(seqs[iu], lens[iu], seqs[ju], lens[ju])
            matrix = np.zeros((n, n), dtype=np.float64)
            matrix[iu, ju] = d
            matrix[ju, iu] = d
        else:
            # Family members differ by few edits, so the card takes the
            # banded pool; overflow pairs re-run exactly, so this is a
            # routing choice and the matrix is the same either way.
            band_k = DEVICE_BAND if self.device.type == "cuda" else None
            matrix = pairwise_distance_matrix(seqs, lens, band_k=band_k, device=self.device)
        return newick(upgma_tree(matrix, labels))

    def reference_cigars(self, band_k: int = 127) -> Dict[str, str]:
        """CIGAR of each distinct mutant against the reference coding
        sequence by the banded traceback; pairs outside every band fall
        back to the exact host DP."""
        distinct = list(self.distinct_sequences())
        if not distinct:
            return {}
        seqs, lens = self._padded_codes([self.reference_coding] + distinct)
        n = len(distinct)
        ref_seq = np.repeat(seqs[:1], n, axis=0)
        ref_len = np.repeat(lens[:1], n)
        cigars = batched_cigar(ref_seq, ref_len, seqs[1:], lens[1:], band_k=band_k,
                               device=self.device)
        return dict(zip(distinct, cigars))

    def write_report(self, path: str, distances: Optional[Dict[str, int]] = None,
                     cigars: bool = False) -> None:
        distances = distances or self.reference_distances()
        cigar_map = self.reference_cigars() if cigars else {}
        with open(path, "w") as f:
            header = "Genome,Gene,Transcript,Variants,Validity,Distance,CodingLength"
            f.write(header + (",Cigar\n" if cigars else "\n"))
            for rec in self.records:
                distance = distances.get(rec.modified_coding, "")
                f.write(
                    f"{rec.genome_id},{rec.gene_id},{rec.transcript_id},"
                    f"{rec.variant_count},{rec.validity.value},{distance},"
                    f"{len(rec.modified_coding)}"
                    + (f",{cigar_map.get(rec.modified_coding, '')}\n" if cigars else "\n")
                )
