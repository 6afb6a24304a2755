"""Sequence containers over the code alphabets.

Capability parity with the reference containers
(kgl_genomics/kgl_sequence/kgl_sequence_base.h:41,85,109-124 and
kgl_sequence_amino.h:30), re-designed as thin wrappers over NumPy uint8
code arrays: slicing produces zero-copy views (the reference needs separate
*View classes for this — kgl_sequence_base_view.h), and every bulk
operation (complement, reverse, compare) is a vectorized op ready for
device transfer.

Copy of kgl_gene_tpu/sequence/sequence.py.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional

import numpy as np

from .alphabet import DNA5, CodingDNA5, AminoAcid
from .tables import TranslationTable, amino_translation_table, codon_indices
from ..utils.intervals import OpenRightInterval

__all__ = [
    "StrandSense",
    "DNA5SequenceLinear",
    "DNA5SequenceCoding",
    "AminoSequence",
]


class StrandSense(Enum):
    """Feature strand (kgl_genome_prelim.h StrandSense)."""

    FORWARD = "+"
    REVERSE = "-"


class _CodesBase:
    """Common container behaviour for code-array sequences."""

    __slots__ = ("codes",)

    def __init__(self, codes: np.ndarray):
        self.codes = np.ascontiguousarray(codes, dtype=np.uint8)

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    @property
    def length(self) -> int:
        return len(self)

    def __eq__(self, other) -> bool:
        return (
            type(other) is type(self)
            and len(self) == len(other)
            and bool(np.array_equal(self.codes, other.codes))
        )

    def __hash__(self):
        return hash(self.codes.tobytes())

    def __repr__(self):
        s = self.to_string()
        if len(s) > 60:
            s = s[:57] + "..."
        return f"{type(self).__name__}({s!r})"


class DNA5SequenceLinear(_CodesBase):
    """Unstranded linear DNA (5' to 3' reading strand sense).

    Mirrors DNA5SequenceLinear (kgl_sequence_base.h:85): supports base
    modification, sub-sequence delete/insert (used by the mutation engine),
    down-conversion to a stranded coding sequence, and common prefix/suffix
    used for variant canonicalisation.
    """

    alphabet = DNA5

    @classmethod
    def from_string(cls, text: str) -> "DNA5SequenceLinear":
        return cls(DNA5.from_string(text))

    def to_string(self) -> str:
        return DNA5.to_string(self.codes)

    # --- views / slicing ------------------------------------------------
    def subsequence(self, offset: int, size: int) -> "DNA5SequenceLinear":
        """Zero-copy sub-sequence view [offset, offset+size)."""
        if offset < 0 or size < 0 or offset + size > len(self):
            raise IndexError(
                f"subsequence [{offset}, {offset + size}) out of range for length {len(self)}"
            )
        return DNA5SequenceLinear(self.codes[offset : offset + size])

    def sub_interval(self, interval: OpenRightInterval) -> "DNA5SequenceLinear":
        return self.subsequence(interval.lower, interval.size)

    # --- mutation primitives (copying; the mutation engine batches these) --
    def modify_base(self, offset: int, code: int) -> "DNA5SequenceLinear":
        out = self.codes.copy()
        out[offset] = code
        return DNA5SequenceLinear(out)

    def delete_subsequence(self, offset: int, size: int) -> "DNA5SequenceLinear":
        return DNA5SequenceLinear(np.delete(self.codes, slice(offset, offset + size)))

    def insert_subsequence(self, offset: int, insert: "DNA5SequenceLinear") -> "DNA5SequenceLinear":
        return DNA5SequenceLinear(np.insert(self.codes, offset, insert.codes))

    # --- canonicalisation helpers (kgl_variant_db.h:173-176) ------------
    def common_prefix(self, other: "DNA5SequenceLinear") -> int:
        n = min(len(self), len(other))
        neq = self.codes[:n] != other.codes[:n]
        idx = np.argmax(neq)
        return int(idx) if neq.any() else n

    def common_suffix(self, other: "DNA5SequenceLinear") -> int:
        n = min(len(self), len(other))
        if n == 0:
            return 0
        neq = self.codes[len(self) - n :][::-1] != other.codes[len(other) - n :][::-1]
        idx = np.argmax(neq)
        return int(idx) if neq.any() else n

    # --- strand conversion ---------------------------------------------
    def coding_sequence(self, strand: StrandSense) -> "DNA5SequenceCoding":
        """Convert to a stranded coding sequence; reverse strand reverse-
        complements (kgl_sequence_base.h codingSequence())."""
        if strand is StrandSense.REVERSE:
            return DNA5SequenceCoding(DNA5.COMPLEMENT[self.codes[::-1]], strand)
        return DNA5SequenceCoding(self.codes, strand)

    def count_symbols(self) -> np.ndarray:
        """Counts per alphabet column (A,C,G,T,N)."""
        return np.bincount(self.codes, minlength=DNA5.SIZE)[: DNA5.SIZE]


class DNA5SequenceCoding(_CodesBase):
    """Stranded (sense) DNA sequence — the only translatable kind
    (kgl_sequence_base.h:41)."""

    __slots__ = ("codes", "strand")

    alphabet = CodingDNA5

    def __init__(self, codes: np.ndarray, strand: StrandSense = StrandSense.FORWARD):
        super().__init__(codes)
        self.strand = strand

    @classmethod
    def from_string(cls, text: str, strand: StrandSense = StrandSense.FORWARD):
        return cls(CodingDNA5.from_string(text), strand)

    def to_string(self) -> str:
        return CodingDNA5.to_string(self.codes)

    def __eq__(self, other) -> bool:
        return (
            type(other) is type(self)
            and self.strand == other.strand
            and bool(np.array_equal(self.codes, other.codes))
        )

    __hash__ = _CodesBase.__hash__

    # --- back-conversion (kgl_sequence_base.h:109-124) ------------------
    def linear_sequence(self) -> DNA5SequenceLinear:
        """Up-convert to unstranded linear; reverse strand is reverse-
        complemented back to reading-strand sense."""
        if self.strand is StrandSense.REVERSE:
            return DNA5SequenceLinear(CodingDNA5.COMPLEMENT[self.codes[::-1]])
        return DNA5SequenceLinear(self.codes)

    # --- translation -----------------------------------------------------
    def codon_count(self) -> int:
        return len(self) // 3

    def codon_index_array(self) -> np.ndarray:
        return codon_indices(self.codes)

    def get_amino_sequence(self, table: Optional[TranslationTable] = None) -> "AminoSequence":
        table = table or amino_translation_table()
        return AminoSequence(table.translate(self.codes))


class AminoSequence(_CodesBase):
    """Protein sequence container (kgl_sequence_amino.h:30)."""

    alphabet = AminoAcid

    @classmethod
    def from_string(cls, text: str) -> "AminoSequence":
        return cls(AminoAcid.from_string(text))

    def to_string(self) -> str:
        return AminoAcid.to_string(self.codes)

    # --- validity checks used by protein verification -------------------
    def contains_unknown(self) -> bool:
        return bool(np.any(self.codes == AminoAcid.UNKNOWN))

    def internal_stops(self) -> int:
        """Number of stop codons before the final position."""
        if len(self) == 0:
            return 0
        return int(np.sum(self.codes[:-1] == AminoAcid.STOP))

    def ends_with_stop(self) -> bool:
        return len(self) > 0 and int(self.codes[-1]) == AminoAcid.STOP

    def starts_with(self, code: int) -> bool:
        return len(self) > 0 and int(self.codes[0]) == code

    def subsequence(self, offset: int, size: int) -> "AminoSequence":
        if offset < 0 or size < 0 or offset + size > len(self):
            raise IndexError(
                f"subsequence [{offset}, {offset + size}) out of range for length {len(self)}"
            )
        return AminoSequence(self.codes[offset : offset + size])
