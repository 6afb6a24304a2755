"""Genome feature model: GFF3 feature hierarchy and transcripts.

Capability parity with the reference feature machinery
(kgl_genomics/kgl_genome/kgl_genome_feature.h:23,104,
kgl_genome_prelim.h:26,85-139, kgl_genome_contig_feature.h:78), re-designed
so transcript exon structure is also available as flat CSR arrays — the
device-friendly layout used by the batched mutation/splice kernels.

Copy of kgl_gene_tpu/genome/features.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

import numpy as np

from ..sequence.sequence import StrandSense
from ..utils.intervals import IntervalSet, OpenRightInterval

__all__ = [
    "Feature",
    "TranscriptionSequence",
    "TranscriptionSequenceArray",
    "TranscriptionSequenceType",
    "CodingSequenceValidity",
    "GENE_TYPES",
    "CODING_TYPES",
]

# GFF3 feature types (case-insensitive matching in the parser).
GENE_TYPES = {"gene", "protein_coding_gene", "ncrna_gene", "pseudogene"}
MRNA_TYPES = {"mrna", "transcript"}
CODING_TYPES = {"cds"}
EXON_TYPES = {"exon"}
UTR_TYPES = {"five_prime_utr", "three_prime_utr"}
TSS_TYPES = {"tss_block"}


class TranscriptionSequenceType(Enum):
    PROTEIN = "PROTEIN"
    NCRNA = "NCRNA"
    EMPTY = "EMPTY"


class CodingSequenceValidity(Enum):
    """Protein/transcript validity classification
    (kgl_genome_prelim.h:85)."""

    NCRNA = "NCRNA"
    VALID_PROTEIN = "VALID_PROTEIN"
    EMPTY = "EMPTY"
    NOT_MOD3 = "NOT_MOD3"
    NO_START_CODON = "NO_START_CODON"
    NONSENSE_MUTATION = "NONSENSE_MUTATION"
    NO_STOP_CODON = "NO_STOP_CODON"

    @staticmethod
    def valid_protein(status: "CodingSequenceValidity") -> bool:
        return status is CodingSequenceValidity.VALID_PROTEIN

    @staticmethod
    def valid_sequence(status: "CodingSequenceValidity") -> bool:
        return status in (CodingSequenceValidity.VALID_PROTEIN, CodingSequenceValidity.NCRNA)


@dataclass
class Feature:
    """A GFF3 feature: id, type, location, attributes and hierarchy links."""

    feature_id: str
    feature_type: str  # lower-cased GFF3 column 3
    contig_id: str
    interval: OpenRightInterval  # ZERO-based right-open (GFF is 1-based closed)
    strand: StrandSense = StrandSense.FORWARD
    phase: Optional[int] = None
    attributes: Dict[str, List[str]] = field(default_factory=dict)
    super_feature: Optional["Feature"] = None
    sub_features: List["Feature"] = field(default_factory=list)

    def is_gene(self) -> bool:
        return self.feature_type in GENE_TYPES

    def is_mrna(self) -> bool:
        return self.feature_type in MRNA_TYPES

    def is_coding(self) -> bool:
        return self.feature_type in CODING_TYPES

    def is_exon(self) -> bool:
        return self.feature_type in EXON_TYPES

    def attribute(self, key: str) -> List[str]:
        return self.attributes.get(key, [])

    def description(self) -> str:
        vals = self.attribute("description") or self.attribute("Name")
        return vals[0] if vals else ""

    def gene_ancestor(self) -> Optional["Feature"]:
        node = self
        while node is not None:
            if node.is_gene():
                return node
            node = node.super_feature
        return None

    def __repr__(self):
        return f"Feature({self.feature_id}, {self.feature_type}, {self.contig_id}:{self.interval})"


class TranscriptionSequence:
    """A gene transcript: the sorted CDS/exon segments that splice into a
    coding sequence (kgl_genome_prelim.h:90).

    ``segments`` are the CDS features for protein transcripts or exon
    features for ncRNA, sorted by genome position (splice order; the strand
    conversion happens after concatenation — kgl_genome_contig.cpp:117-131).
    """

    def __init__(self, gene: Feature, parent: Feature, segments: List[Feature],
                 coding_type: TranscriptionSequenceType):
        if not segments:
            raise ValueError("transcript with no coding segments")
        self.gene = gene
        self.parent = parent
        self.segments = sorted(segments, key=lambda f: (f.interval.lower, f.interval.upper))
        self.coding_type = coding_type

    @property
    def transcript_id(self) -> str:
        return self.parent.feature_id

    @property
    def strand(self) -> StrandSense:
        return self.segments[0].strand

    def exon_intervals(self) -> IntervalSet:
        return IntervalSet(f.interval for f in self.segments)

    def exon_arrays(self) -> np.ndarray:
        """(n_exons, 2) int64 [lower, upper) in genome order — the CSR row
        used by the device splice kernels."""
        return np.array(
            [(f.interval.lower, f.interval.upper) for f in self.segments], dtype=np.int64
        )

    @property
    def start(self) -> int:
        return self.segments[0].interval.lower

    @property
    def end(self) -> int:
        return self.segments[-1].interval.upper

    @property
    def interval(self) -> OpenRightInterval:
        return OpenRightInterval(self.start, self.end)

    def coding_nucleotides(self) -> int:
        return sum(f.interval.size for f in self.segments)

    def __repr__(self):
        return (
            f"Transcript({self.gene.feature_id}/{self.transcript_id}, "
            f"{self.coding_type.value}, {len(self.segments)} segments, "
            f"{self.strand.value})"
        )


class TranscriptionSequenceArray:
    """Sorted map transcript_id -> TranscriptionSequence for one gene
    (kgl_genome_prelim.h:139)."""

    def __init__(self):
        self._map: Dict[str, TranscriptionSequence] = {}

    def add(self, transcript: TranscriptionSequence) -> bool:
        if transcript.transcript_id in self._map:
            return False
        self._map[transcript.transcript_id] = transcript
        return True

    def get(self, transcript_id: str) -> Optional[TranscriptionSequence]:
        return self._map.get(transcript_id)

    def __len__(self):
        return len(self._map)

    def __iter__(self):
        return iter(sorted(self._map.items()))

    def transcripts(self) -> List[TranscriptionSequence]:
        return [t for _, t in sorted(self._map.items())]

    def coding_type(self) -> TranscriptionSequenceType:
        if not self._map:
            return TranscriptionSequenceType.EMPTY
        types = {t.coding_type for t in self._map.values()}
        return types.pop() if len(types) == 1 else TranscriptionSequenceType.PROTEIN


def build_transcripts(gene: Feature) -> TranscriptionSequenceArray:
    """Assemble the transcript array for a gene from its sub-feature tree.

    Protein transcripts come from CDS features grouped by their parent
    (generally an mRNA feature); if a gene has no CDS anywhere below it,
    exon features form an NCRNA transcript (GeneFeature::getTranscriptionSequences
    semantics, kgl_genome_feature.h:104).
    """
    array = TranscriptionSequenceArray()

    cds_by_parent: Dict[str, List[Feature]] = {}
    exon_by_parent: Dict[str, List[Feature]] = {}
    parents: Dict[str, Feature] = {}

    def visit(feature: Feature):
        for sub in feature.sub_features:
            if sub.is_coding():
                parent = sub.super_feature or gene
                parents[parent.feature_id] = parent
                cds_by_parent.setdefault(parent.feature_id, []).append(sub)
            elif sub.is_exon():
                parent = sub.super_feature or gene
                parents[parent.feature_id] = parent
                exon_by_parent.setdefault(parent.feature_id, []).append(sub)
            visit(sub)

    visit(gene)

    for parent_id, cds_list in cds_by_parent.items():
        array.add(
            TranscriptionSequence(
                gene, parents[parent_id], cds_list, TranscriptionSequenceType.PROTEIN
            )
        )
    if not cds_by_parent:
        for parent_id, exon_list in exon_by_parent.items():
            array.add(
                TranscriptionSequence(
                    gene, parents[parent_id], exon_list, TranscriptionSequenceType.NCRNA
                )
            )
    return array
