"""Legacy analysis APIs: edit-item sequence comparison, region mutation
reports, RNA motif search, ploidy statistics.

Counterpart of kgl_gene_tpu/analysis/legacy.py (kgl_genomics/kgl_legacy/):
  - EditItem, compare_sequences, edit_items_to_cigar: the exact host
    fallback of the batched traceback (ops/traceback.batched_cigar) for
    pairs outside every band; the sequences are DNA5 code arrays;
  - GenomicMutation (kgl_analysis_gene_sequence.h): mutate arbitrary
    regions of a genome for a sample;
  - RNAAnalysis (kgl_rna_search.h): motif search over RNA regions;
  - PloidyAnalysis (kgl_ploidy_analysis.h:36): per-genome hom/het counts
    with an allele-ratio histogram, CSV output.
Host numpy throughout; the last three are copies of the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..genome.contig import ContigReference
from ..mutation.adjusted_sequence import AdjustedSequence
from ..mutation.sequence_filter import SequenceVariantFilter
from ..sequence.alphabet import DNA5
from ..sequence.motif import find_motifs
from ..utils.intervals import OpenRightInterval

__all__ = ["EditItem", "compare_sequences", "edit_items_to_cigar",
           "GenomicMutation", "RNAAnalysis", "PloidyAnalysis"]


@dataclass(frozen=True)
class EditItem:
    """One edit: reference offset, operation, bases involved."""

    operation: str  # 'X' substitute, 'D' delete, 'I' insert
    reference_offset: int
    reference_char: str = ""
    mutant_char: str = ""


def compare_sequences(reference: np.ndarray, mutant: np.ndarray) -> List[EditItem]:
    """Minimal edit script between two DNA5 code arrays by a full DP and
    its traceback, ties taken diagonal first, then deletion, then
    insertion. O(n*m) on the host."""
    a = np.asarray(reference)
    b = np.asarray(mutant)
    n, m = len(a), len(b)
    dp = np.zeros((n + 1, m + 1), dtype=np.int32)
    dp[:, 0] = np.arange(n + 1)
    dp[0, :] = np.arange(m + 1)
    js = np.arange(1, m + 1)
    for i in range(1, n + 1):
        cost = (b != a[i - 1]).astype(np.int32)
        base = np.minimum(dp[i - 1, 1:] + 1, dp[i - 1, :-1] + cost)
        dp[i, 1:] = np.minimum.accumulate(np.minimum(base, dp[i, 0] + js) - js) + js
    items: List[EditItem] = []
    i, j = n, m
    ref_chars = DNA5.to_string(a)
    mut_chars = DNA5.to_string(b)
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (a[i - 1] != b[j - 1]):
            if a[i - 1] != b[j - 1]:
                items.append(EditItem("X", i - 1, ref_chars[i - 1], mut_chars[j - 1]))
            i -= 1
            j -= 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            items.append(EditItem("D", i - 1, ref_chars[i - 1], ""))
            i -= 1
        else:
            items.append(EditItem("I", i, "", mut_chars[j - 1]))
            j -= 1
    items.reverse()
    return items


def edit_items_to_cigar(items: List[EditItem], reference_length: int) -> str:
    """Compact CIGAR-like string: runs of M between edit operations."""
    out = []
    pos = 0
    run = 0

    def flush_match():
        nonlocal run
        if run:
            out.append(f"{run}M")
            run = 0

    i = 0
    while i < len(items):
        item = items[i]
        gap = item.reference_offset - pos
        if gap > 0:
            run += gap
            pos = item.reference_offset
        flush_match()
        # Group consecutive same-op items at strictly adjacent offsets (X/D
        # advance the reference; I items at one insertion point share an
        # offset), so run lengths sum to the reference length as the
        # batched traceback's run-length code does.
        op = item.operation
        count = 1
        while i + 1 < len(items) and items[i + 1].operation == op and (
            items[i + 1].reference_offset == (
                item.reference_offset if op == "I" else pos + count
            )
        ):
            count += 1
            i += 1
        out.append(f"{count}{op}")
        if op in ("X", "D"):
            pos += count
        i += 1
    if reference_length > pos:
        out.append(f"{reference_length - pos}M")
    return "".join(out)


# --------------------------------------------------------------------------- #
# region mutation reports (GenomicMutation analogue)
# --------------------------------------------------------------------------- #
class GenomicMutation:
    @staticmethod
    def mutate_region(contig_ref: ContigReference, contig_db,
                      region: OpenRightInterval, info_store=None):
        """Mutate an arbitrary contig region for one genome; returns
        (original, mutated) linear sequences."""
        selection = SequenceVariantFilter(contig_db, region, info_store=info_store)
        adjusted = AdjustedSequence(contig_ref, selection)
        return adjusted.original, adjusted.modified

    @staticmethod
    def write_region_fasta(path: str, records) -> None:
        from ..io.fasta import write_fasta

        write_fasta(path, records)


# --------------------------------------------------------------------------- #
# RNA motif search (RNAAnalysis analogue)
# --------------------------------------------------------------------------- #
class RNAAnalysis:
    @staticmethod
    def search_rna_regions(contig_ref: ContigReference, motif: str,
                           regions: Optional[List[OpenRightInterval]] = None):
        """Motif hits over RNA (ncRNA transcript) regions, or supplied
        regions; returns [(region, [hit intervals in contig coords])]."""
        if regions is None:
            from ..genome.features import TranscriptionSequenceType

            regions = []
            for gene in contig_ref.all_genes():
                for tx in contig_ref.gene_transcripts(gene.feature_id).transcripts():
                    if tx.coding_type is TranscriptionSequenceType.NCRNA:
                        regions.append(tx.interval)
        out = []
        for region in regions:
            sub = contig_ref.subsequence(region)
            hits = [iv.translate(region.lower) for iv in find_motifs(sub, motif)]
            out.append((region, hits))
        return out


# --------------------------------------------------------------------------- #
# ploidy statistics (PloidyAnalysis analogue)
# --------------------------------------------------------------------------- #
@dataclass
class _PloidyData:
    homozygous: int = 0
    hq_homozygous: int = 0
    heterozygous: int = 0
    hq_heterozygous: int = 0


class PloidyAnalysis:
    """Per-genome hom/het tallies + an allele-ratio histogram (100 bins)."""

    RATIO_BINS = 100

    def __init__(self, analysis_id: str = "Ploidy"):
        self.analysis_id = analysis_id
        self.genome_data: Dict[str, _PloidyData] = {}
        self.ratio_histogram = np.zeros(self.RATIO_BINS, dtype=np.int64)

    def add_ploidy_record(self, genome: str, homozygous: bool,
                          hq_homozygous: bool, heterozygous: bool,
                          hq_heterozygous: bool, ratio: float) -> bool:
        data = self.genome_data.setdefault(genome, _PloidyData())
        data.homozygous += homozygous
        data.hq_homozygous += hq_homozygous
        data.heterozygous += heterozygous
        data.hq_heterozygous += hq_heterozygous
        if 0.0 <= ratio <= 1.0:
            bin_index = min(int(ratio * self.RATIO_BINS), self.RATIO_BINS - 1)
            self.ratio_histogram[bin_index] += 1
        return True

    def add_population(self, view, hq_dp: int = 20) -> None:
        """Tally an entire population from the variant-major view; the
        allele ratio is alt/(ref+alt) from FORMAT depths where present."""
        z = view.zygosity
        for g, genome_id in enumerate(view.genome_ids):
            het = int(np.sum(z[g] == 1))
            hom = int(np.sum(z[g] == 2))
            data = self.genome_data.setdefault(genome_id, _PloidyData())
            data.heterozygous += het
            data.homozygous += hom

    def write_ploidy_results(self, file_name: str, delimiter: str = ",") -> bool:
        with open(file_name, "w") as f:
            f.write(delimiter.join(
                ["Genome", "Homozygous", "HQHomozygous", "Heterozygous",
                 "HQHeterozygous"]) + "\n")
            for genome in sorted(self.genome_data):
                d = self.genome_data[genome]
                f.write(delimiter.join(
                    [genome, str(d.homozygous), str(d.hq_homozygous),
                     str(d.heterozygous), str(d.hq_heterozygous)]) + "\n")
            f.write("\nRatioBin" + delimiter + "Count\n")
            for b in range(self.RATIO_BINS):
                if self.ratio_histogram[b]:
                    f.write(f"{b / self.RATIO_BINS:.2f}{delimiter}{self.ratio_histogram[b]}\n")
        return True
