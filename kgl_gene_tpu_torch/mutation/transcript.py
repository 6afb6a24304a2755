"""Transcript mutation: apply a genome's variants to a transcript, splice
modified exons, strand-convert and translate.

Capability parity with SequenceTranscript
(kgl_mutation/kgl_mutation_transcript.h:14-55): mutates the whole
transcript interval via AdjustedSequence, then splices the exon intervals
out of the *modified* sequence using the original->modified offset map,
concatenates in genome order and strand-converts (the coding assembly of
kgl_genome_contig.cpp:117-131), and classifies protein validity.

Copy of kgl_gene_tpu/mutation/transcript.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..genome.contig import ContigReference
from ..genome.features import CodingSequenceValidity, TranscriptionSequence, TranscriptionSequenceType
from ..sequence.sequence import AminoSequence, DNA5SequenceCoding, DNA5SequenceLinear
from ..utils.logging import log
from ..variant.db import ContigDB
from .adjusted_sequence import AdjustedSequence
from .sequence_filter import SeqVariantFilterType, SequenceVariantFilter

__all__ = ["SequenceTranscript"]


class SequenceTranscript:
    """Mutate a transcript with one genome's variants."""

    def __init__(
        self,
        contig_db: ContigDB,
        contig_ref: ContigReference,
        transcript: TranscriptionSequence,
        filter_type: SeqVariantFilterType = SeqVariantFilterType.DEFAULT_SEQ_FILTER,
        info_store=None,
    ):
        self.contig_ref = contig_ref
        self.transcript = transcript
        self.variant_filter = SequenceVariantFilter(
            contig_db, transcript.interval, filter_type, info_store
        )
        self.adjusted = AdjustedSequence(contig_ref, self.variant_filter)

    # ------------------------------------------------------------------ #
    @property
    def stats(self):
        return self.variant_filter.stats

    def variant_count(self) -> int:
        return len(self.variant_filter)

    # --- sequence extraction ---------------------------------------------
    def modified_linear(self) -> DNA5SequenceLinear:
        """Spliced modified exons as an unstranded linear sequence."""
        parts = []
        for segment in self.transcript.segments:
            sub = self.adjusted.modified_sub_sequence(segment.interval)
            if sub is None:
                log().warn(
                    "transcript {}: cannot extract modified exon {}",
                    self.transcript.transcript_id, segment.interval,
                )
                continue
            parts.append(sub.codes)
        return DNA5SequenceLinear(
            np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)
        )

    def original_linear(self) -> DNA5SequenceLinear:
        parts = [
            self.adjusted.original_sub_sequence(segment.interval).codes
            for segment in self.transcript.segments
        ]
        return DNA5SequenceLinear(
            np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)
        )

    def modified_coding(self) -> DNA5SequenceCoding:
        return self.modified_linear().coding_sequence(self.transcript.strand)

    def original_coding(self) -> DNA5SequenceCoding:
        return self.original_linear().coding_sequence(self.transcript.strand)

    # --- translation ------------------------------------------------------
    def modified_amino(self) -> AminoSequence:
        return self.contig_ref.get_amino_sequence(self.modified_coding())

    def original_amino(self) -> AminoSequence:
        return self.contig_ref.get_amino_sequence(self.original_coding())

    def modified_validity(self) -> CodingSequenceValidity:
        if self.transcript.coding_type is TranscriptionSequenceType.NCRNA:
            return CodingSequenceValidity.NCRNA
        return self.contig_ref.check_valid_coding_sequence(self.modified_coding())

    def original_validity(self) -> CodingSequenceValidity:
        if self.transcript.coding_type is TranscriptionSequenceType.NCRNA:
            return CodingSequenceValidity.NCRNA
        return self.contig_ref.check_valid_coding_sequence(self.original_coding())
