"""NCBI amino-acid translation tables as 65-entry codon LUTs.

Counterpart of kgl_gene_tpu/sequence/tables.py (amino_translation_table,
TranslationTable). A codon index is 16*b0 + 4*b1 + b2 over A=0, C=1, G=2,
T=3; entry 64 is the sentinel for a codon that contains N and yields the
unknown amino acid 'Z'.

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
    "TranslationTable",
    "amino_translation_table",
    "tables_from_numpy",
]

STANDARD_TABLE = "NCBI_TABLE_1"

_BASE_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


@dataclass(frozen=True)
class TranslationTable:
    """One genetic code: amino_lut (65,) uint8 and start_lut (65,) bool."""

    name: str
    amino_lut: np.ndarray
    start_lut: np.ndarray

    def start_codes(self) -> np.ndarray:
        """The distinct amino codes that a start codon translates to."""
        return np.unique(self.amino_lut[self.start_lut])


def tables_from_numpy(amino_lut, start_lut, name: str = "carried") -> TranslationTable:
    """A TranslationTable from another implementation's arrays, for example
    the JAX package's TranslationTable.amino_lut and .start_lut."""
    amino = np.asarray(amino_lut, dtype=np.uint8)
    start = np.asarray(start_lut, dtype=bool)
    if amino.shape != (65,) or start.shape != (65,):
        raise ValueError(
            f"expected (65,) LUTs, got {amino.shape} and {start.shape}"
        )
    return TranslationTable(name=name, amino_lut=amino.copy(), start_lut=start.copy())


def _build(name: str) -> TranslationTable:
    amino = np.full(65, AminoAcid.UNKNOWN, dtype=np.uint8)
    start = np.zeros(65, dtype=bool)
    for aa, start_flag, b0, b1, b2 in NCBI_TABLES[name]:
        idx = _BASE_CODE[b0] * 16 + _BASE_CODE[b1] * 4 + _BASE_CODE[b2]
        amino[idx] = AminoAcid.CHAR_TO_CODE[ord(aa)]
        start[idx] = start_flag == "M"
    return TranslationTable(name=name, amino_lut=amino, start_lut=start)


def amino_translation_table(name: str = STANDARD_TABLE) -> TranslationTable:
    """Look up a table by its NCBI name (e.g. ``NCBI_TABLE_1``); an unknown
    name falls back to the standard table, as the reference does."""
    key = name.upper() if name else STANDARD_TABLE
    if key not in NCBI_TABLES:
        key = STANDARD_TABLE
    return _build(key)
