"""NCBI amino-acid translation tables as vectorized 64-entry LUTs.

Capability parity with the reference's translation machinery
(kgl_genomics/kgl_sequence/kgl_table.h:24, kgl_table_ncbi.h:23,
kgl_table_organism.h) re-designed for array translation: a codon index is
``16*b0 + 4*b1 + b2`` over codes A=0,C=1,G=2,T=3 (alphabetical order, same
indexing as the reference's table columns); translating a whole coding
sequence is a single gather through the 65-entry LUT (entry 64 = any codon
containing 'N' -> unknown amino 'Z').

Copy of kgl_gene_tpu/sequence/tables.py with two additions: the start
codes a table accepts (TranslationTable.start_codes) and tables_from_numpy.
The tables are this system's parameters: it has no weights, so carrying
state across from the JAX package means carrying these arrays, which
tables_from_numpy does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .alphabet import AminoAcid
from .ncbi_table_data import NCBI_TABLES

__all__ = [
    "STANDARD_TABLE",
    "TABLE_NAMES",
    "TranslationTable",
    "amino_translation_table",
    "codon_indices",
    "tables_from_numpy",
]

STANDARD_TABLE = "NCBI_TABLE_1"
TABLE_NAMES = tuple(NCBI_TABLES.keys())

_BASE_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


@dataclass(frozen=True)
class TranslationTable:
    """A single NCBI genetic code packaged as gather-ready arrays.

    ``amino_lut`` has 65 entries: 64 codons (alphabetical index) plus a
    sentinel at index 64 that yields the unknown amino acid (used when a
    codon contains the unknown base 'N'; the reference generates 'Z' for
    such codons via Codon::containsBaseN, kgl_sequence_codon.h:48).
    """

    name: str
    amino_lut: np.ndarray      # (65,) uint8 amino codes
    start_lut: np.ndarray      # (65,) bool — codon is a start codon
    stop_lut: np.ndarray       # (65,) bool — codon is a stop codon

    def translate_codons(self, codon_index: np.ndarray) -> np.ndarray:
        """Codon indices (with 64 == contains-N sentinel) -> amino codes."""
        return self.amino_lut[codon_index]

    def translate(self, coding_codes: np.ndarray) -> np.ndarray:
        """Translate a stranded coding-sequence code array to amino codes.

        Trailing bases that do not form a whole codon are ignored
        (Codon::codonLength semantics, kgl_sequence_codon.h:30).
        """
        return self.amino_lut[codon_indices(coding_codes)]

    def is_stop_codon(self, codon_index) -> np.ndarray:
        return self.stop_lut[codon_index]

    def is_start_codon(self, codon_index) -> np.ndarray:
        return self.start_lut[codon_index]

    def start_codes(self) -> np.ndarray:
        """The distinct amino codes that a start codon translates to."""
        return np.unique(self.amino_lut[self.start_lut])


def codon_indices(coding_codes: np.ndarray) -> np.ndarray:
    """Vectorized codon indexing: (3k,) base codes -> (k,) codon indices.

    Any codon containing an 'N' (code 4) maps to the sentinel index 64.
    """
    n_codons = len(coding_codes) // 3
    cod = np.asarray(coding_codes[: n_codons * 3], dtype=np.int32).reshape(n_codons, 3)
    idx = cod[:, 0] * 16 + cod[:, 1] * 4 + cod[:, 2]
    has_n = (cod >= 4).any(axis=1)
    return np.where(has_n, 64, idx).astype(np.int32)


def tables_from_numpy(amino_lut, start_lut, name: str = "carried") -> TranslationTable:
    """A TranslationTable from another implementation's arrays, for example
    the JAX package's TranslationTable.amino_lut and .start_lut; a codon
    is a stop codon where it translates to '*'."""
    amino = np.asarray(amino_lut, dtype=np.uint8)
    start = np.asarray(start_lut, dtype=bool)
    if amino.shape != (65,) or start.shape != (65,):
        raise ValueError(
            f"expected (65,) LUTs, got {amino.shape} and {start.shape}"
        )
    return TranslationTable(name=name, amino_lut=amino.copy(), start_lut=start.copy(),
                            stop_lut=amino == AminoAcid.STOP)


def _build(name: str) -> TranslationTable:
    rows = NCBI_TABLES[name]
    amino = np.full(65, AminoAcid.UNKNOWN, dtype=np.uint8)
    start = np.zeros(65, dtype=bool)
    stop = np.zeros(65, dtype=bool)
    for aa, start_flag, b0, b1, b2 in rows:
        idx = _BASE_CODE[b0] * 16 + _BASE_CODE[b1] * 4 + _BASE_CODE[b2]
        amino[idx] = AminoAcid.CHAR_TO_CODE[ord(aa)]
        start[idx] = start_flag == "M"
        stop[idx] = aa == "*"
    return TranslationTable(name=name, amino_lut=amino, start_lut=start, stop_lut=stop)


_TABLES: dict[str, TranslationTable] = {}


def amino_translation_table(name: str = STANDARD_TABLE) -> TranslationTable:
    """Look up a translation table by its NCBI name (e.g. ``NCBI_TABLE_1``).

    Mirrors TranslationTableVector table selection (kgl_table.h), including
    falling back to the standard table for unknown names.
    """
    key = name.upper() if name else STANDARD_TABLE
    if key not in NCBI_TABLES:
        key = STANDARD_TABLE
    if key not in _TABLES:
        _TABLES[key] = _build(key)
    return _TABLES[key]
