"""Nucleotide and amino-acid code spaces used by the forward step and the
transcript-family analysis.

Counterpart of kgl_gene_tpu/sequence/alphabet.py (classes DNA5 and
AminoAcid), cut to what the port reads: the DNA5 codes, their complement
and their conversion from and to strings, and the amino-acid codes with
STOP. The code
values are the reference's column offsets (A=0, C=1, G=2, T=3, N=4; amino
F..G = 0..19, '*' = 20, 'Z' = 21).
"""

from __future__ import annotations

import numpy as np

__all__ = ["DNA5", "AminoAcid"]


class DNA5:
    """Unstranded DNA alphabet: A, C, G, T and the unknown base N."""

    A: int = 0
    C: int = 1
    G: int = 2
    T: int = 3
    N: int = 4
    LETTERS = "ACGTN"

    # complement (A<->T, C<->G, N->N) as a code LUT.
    COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.uint8)

    # char (byte value) -> code: any other character is N, RNA's U is T.
    CHAR_TO_CODE = np.full(256, 4, dtype=np.uint8)
    for _i, _ch in enumerate(LETTERS):
        CHAR_TO_CODE[ord(_ch)] = _i
        CHAR_TO_CODE[ord(_ch.lower())] = _i
    CHAR_TO_CODE[ord("U")] = 3
    CHAR_TO_CODE[ord("u")] = 3
    del _i, _ch

    CODE_TO_CHAR = np.frombuffer(LETTERS.encode(), dtype=np.uint8).copy()

    @classmethod
    def from_string(cls, text: str) -> np.ndarray:
        """uint8 codes of an ASCII string."""
        return cls.CHAR_TO_CODE[np.frombuffer(text.encode("ascii"), dtype=np.uint8)]

    @classmethod
    def to_string(cls, codes: np.ndarray) -> str:
        return cls.CODE_TO_CHAR[codes].tobytes().decode("ascii")


class AminoAcid:
    """Amino-acid alphabet: 20 natural amino acids, stop '*', unknown 'Z'
    and the rare U/O."""

    LETTERS = "FLSYCWPHQRIMTNKVADEG*ZUO"
    STOP: int = 20
    UNKNOWN: int = 21

    CHAR_TO_CODE = np.full(256, UNKNOWN, dtype=np.uint8)
    for _i, _ch in enumerate(LETTERS):
        CHAR_TO_CODE[ord(_ch)] = _i
        if _ch.isalpha():
            CHAR_TO_CODE[ord(_ch.lower())] = _i
    del _i, _ch
