"""Protein and transcript validity classes.

Counterpart of kgl_gene_tpu/genome/features.py, cut to
CodingSequenceValidity (the reference's kgl_genome_prelim.h:85).
"""

from __future__ import annotations

from enum import Enum

__all__ = ["CodingSequenceValidity"]


class CodingSequenceValidity(Enum):
    """Protein/transcript validity classification."""

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
