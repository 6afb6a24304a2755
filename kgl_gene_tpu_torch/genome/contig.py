"""Contig reference: DNA sequence + feature maps + translation table.

Capability parity with ContigReference
(kgl_genomics/kgl_genome/kgl_genome_contig.h:29-99): gene lookup by id and
by interval, transcript extraction, exon splice -> stranded coding sequence,
amino translation and protein validity classification.

Copy of kgl_gene_tpu/genome/contig.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..sequence.alphabet import AminoAcid
from ..sequence.sequence import (
    AminoSequence,
    DNA5SequenceCoding,
    DNA5SequenceLinear,
)
from ..sequence.tables import TranslationTable, amino_translation_table
from ..utils.intervals import OpenRightInterval
from ..utils.logging import log
from .features import (
    CodingSequenceValidity,
    Feature,
    TranscriptionSequence,
    TranscriptionSequenceArray,
    TranscriptionSequenceType,
    build_transcripts,
)

__all__ = ["ContigReference"]


class ContigReference:
    """One contiguous region (chromosome/scaffold) of a reference genome."""

    def __init__(self, contig_id: str, sequence: DNA5SequenceLinear,
                 translation_table: Optional[TranslationTable] = None):
        self.contig_id = contig_id
        self.sequence = sequence
        self.coding_table = translation_table or amino_translation_table()
        # id -> feature (all features), gene id -> gene feature.
        self.features: Dict[str, Feature] = {}
        self.genes: Dict[str, Feature] = {}
        # gene transcripts, built on verify.
        self._transcripts: Dict[str, TranscriptionSequenceArray] = {}
        # genes sorted by start offset for interval queries.
        self._gene_starts: Optional[np.ndarray] = None
        self._gene_order: List[Feature] = []

    # ------------------------------------------------------------------ #
    # feature wiring
    # ------------------------------------------------------------------ #
    def add_feature(self, feature: Feature) -> None:
        # GFF3 ids may repeat for multi-segment features (CDS share an ID);
        # keep the first for the id map but always track genes.
        self.features.setdefault(feature.feature_id, feature)
        if feature.is_gene():
            self.genes[feature.feature_id] = feature

    def setup_features(self) -> None:
        """Build gene transcript arrays and the interval index. Called after
        the GFF3 hierarchy is wired (super/sub features)."""
        self._transcripts.clear()
        for gene_id, gene in self.genes.items():
            transcripts = build_transcripts(gene)
            if len(transcripts):
                self._transcripts[gene_id] = transcripts
        self._gene_order = sorted(self.genes.values(), key=lambda g: g.interval.lower)
        self._gene_starts = np.array([g.interval.lower for g in self._gene_order], dtype=np.int64)

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #
    def get_feature(self, feature_id: str) -> Optional[Feature]:
        return self.features.get(feature_id)

    def get_gene(self, gene_id: str) -> Optional[Feature]:
        return self.genes.get(gene_id)

    def gene_count(self) -> int:
        return len(self.genes)

    def gene_transcripts(self, gene_id: str) -> TranscriptionSequenceArray:
        return self._transcripts.get(gene_id, TranscriptionSequenceArray())

    def get_transcription(
        self, gene_id: str, transcript_id: str
    ) -> Optional[TranscriptionSequence]:
        """ContigReference::getTranscription (kgl_genome_contig.h:74)."""
        return self.gene_transcripts(gene_id).get(transcript_id)

    def find_gene_array(self, interval: OpenRightInterval) -> List[Feature]:
        """All genes whose interval intersects the probe interval."""
        return [g for g in self._gene_order if g.interval.intersects(interval)]

    def genes_at(self, offset: int) -> List[Feature]:
        return [g for g in self._gene_order if offset in g.interval]

    def all_genes(self) -> List[Feature]:
        return list(self._gene_order)

    # ------------------------------------------------------------------ #
    # sequence extraction (the splice path)
    # ------------------------------------------------------------------ #
    def subsequence(self, interval: OpenRightInterval) -> DNA5SequenceLinear:
        return self.sequence.sub_interval(interval)

    def concat_intervals(self, intervals) -> DNA5SequenceLinear:
        """Concatenate sub-sequences in sorted genome order
        (DNA5SequenceLinear::concatSequences, kgl_sequence_base.cpp:101)."""
        parts = [self.sequence.codes[iv.lower : iv.upper] for iv in intervals]
        if not parts:
            return DNA5SequenceLinear(np.empty(0, dtype=np.uint8))
        return DNA5SequenceLinear(np.concatenate(parts))

    def coding_sequence(self, transcript: TranscriptionSequence) -> DNA5SequenceCoding:
        """Splice exons then strand-convert
        (ContigReference::codingSequence, kgl_genome_contig.cpp:117)."""
        spliced = self.concat_intervals(transcript.exon_intervals())
        return spliced.coding_sequence(transcript.strand)

    def get_amino_sequence(self, coding: DNA5SequenceCoding) -> AminoSequence:
        return AminoSequence(self.coding_table.translate(coding.codes))

    # ------------------------------------------------------------------ #
    # validity (kgl_genome_verify.cpp:180-248)
    # ------------------------------------------------------------------ #
    def _start_aminos(self) -> set:
        rows = self.coding_table
        startable = rows.amino_lut[rows.start_lut]
        return set(int(a) for a in startable)

    def check_valid_protein_sequence(self, amino: AminoSequence) -> CodingSequenceValidity:
        if len(amino) == 0 or int(amino.codes[0]) not in self._start_aminos():
            return CodingSequenceValidity.NO_START_CODON
        stops = np.nonzero(amino.codes == AminoAcid.STOP)[0]
        first_stop_size = int(stops[0]) + 1 if len(stops) else len(amino)
        if first_stop_size != len(amino):
            return CodingSequenceValidity.NONSENSE_MUTATION
        if int(amino.codes[-1]) != AminoAcid.STOP:
            return CodingSequenceValidity.NO_STOP_CODON
        return CodingSequenceValidity.VALID_PROTEIN

    def check_valid_coding_sequence(self, coding: DNA5SequenceCoding) -> CodingSequenceValidity:
        if len(coding) % 3 != 0:
            return CodingSequenceValidity.NOT_MOD3
        return self.check_valid_protein_sequence(self.get_amino_sequence(coding))

    def check_valid_amino_batch(
        self, amino: np.ndarray, coding_len: int
    ) -> List[CodingSequenceValidity]:
        """Vectorized check_valid_coding_sequence over a (B, M) amino-code
        batch (the device forward step's translation output). Result order
        and precedence are identical to the scalar check (tested equal):
        NOT_MOD3 > NO_START_CODON > NONSENSE_MUTATION > NO_STOP_CODON >
        VALID_PROTEIN."""
        B, M = amino.shape
        if coding_len % 3 != 0:
            return [CodingSequenceValidity.NOT_MOD3] * B
        starts = np.fromiter(self._start_aminos(), dtype=np.uint8)
        if M == 0:
            return [CodingSequenceValidity.NO_START_CODON] * B
        no_start = ~np.isin(amino[:, 0], starts)
        is_stop = amino == AminoAcid.STOP
        any_stop = is_stop.any(axis=1)
        first_stop = np.argmax(is_stop, axis=1)
        first_stop_size = np.where(any_stop, first_stop + 1, M)
        nonsense = first_stop_size != M
        no_stop = ~is_stop[:, -1]
        ordered = (
            CodingSequenceValidity.VALID_PROTEIN,
            CodingSequenceValidity.NO_STOP_CODON,
            CodingSequenceValidity.NONSENSE_MUTATION,
            CodingSequenceValidity.NO_START_CODON,
        )
        # Precedence via maximum of per-condition codes.
        code = np.maximum(
            np.maximum(no_stop.astype(np.int8), 2 * nonsense.astype(np.int8)),
            3 * no_start.astype(np.int8),
        )
        return [ordered[c] for c in code]

    def check_valid_transcript(self, transcript: TranscriptionSequence) -> CodingSequenceValidity:
        if transcript.coding_type is TranscriptionSequenceType.NCRNA:
            return CodingSequenceValidity.NCRNA
        if transcript.coding_nucleotides() == 0:
            return CodingSequenceValidity.EMPTY
        return self.check_valid_coding_sequence(self.coding_sequence(transcript))

    # ------------------------------------------------------------------ #
    # verification (kgl_genome_verify.cpp:1-180)
    # ------------------------------------------------------------------ #
    def verify_features(self) -> Tuple[int, int]:
        """Verify transcripts; returns (valid, invalid) counts and logs a
        summary (GenomeReference::createVerifyGenomeDatabase analogue)."""
        valid = invalid = 0
        # Hierarchy containment: sub-features should lie within their
        # super-feature interval (kgl_genome_verify.cpp hierarchy checks).
        containment_warnings = 0
        for feature in self.features.values():
            for sub in feature.sub_features:
                if not feature.interval.contains_interval(sub.interval):
                    containment_warnings += 1
        if containment_warnings:
            log().warn(
                "contig {}: {} sub-features extend beyond their super-feature",
                self.contig_id, containment_warnings,
            )
        for gene_id, transcripts in self._transcripts.items():
            for transcript in transcripts.transcripts():
                if transcript.end > len(self.sequence):
                    log().warn(
                        "transcript {} of gene {} exceeds contig {} size",
                        transcript.transcript_id, gene_id, self.contig_id,
                    )
                    invalid += 1
                    continue
                status = self.check_valid_transcript(transcript)
                if CodingSequenceValidity.valid_sequence(status):
                    valid += 1
                else:
                    invalid += 1
        return valid, invalid

    def equivalent(self, other: "ContigReference") -> bool:
        """Contig comparison used for testing (kgl_genome_genome.h:62)."""
        return (
            self.contig_id == other.contig_id
            and self.sequence == other.sequence
            and set(self.genes) == set(other.genes)
        )

    def __len__(self) -> int:
        return len(self.sequence)

    def __repr__(self):
        return f"ContigReference({self.contig_id}, {len(self)} bp, {len(self.genes)} genes)"
