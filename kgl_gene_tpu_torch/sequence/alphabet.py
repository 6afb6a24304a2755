"""Nucleotide and amino-acid alphabets as small-integer code spaces.

TPU-first design: every alphabet is a set of ``uint8`` codes with NumPy
lookup tables (char -> code, code -> char, complement, transition class) so
whole sequences convert/complement as single vectorized ops and device
kernels index directly with the codes.

Capability parity with the reference toolkit's alphabet classes:
  - DNA5        (kgl_genomics/kgl_sequence/kgl_alphabet_dna5.h:30)
  - CodingDNA5  (kgl_genomics/kgl_sequence/kgl_alphabet_coding_dna5.h)
  - AminoAcid   (kgl_genomics/kgl_sequence/kgl_alphabet_amino.h:87)

Code values deliberately match the reference's column offsets
(A=0, C=1, G=2, T=3, N=4; amino F..G = 0..19, '*'=20, 'Z'=21) so that
count/frequency arrays are layout-compatible with the reference outputs.

Copy of kgl_gene_tpu/sequence/alphabet.py.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DNA5", "CodingDNA5", "AminoAcid"]


class _NucleotideAlphabet:
    """Shared machinery for the two 5-letter nucleotide alphabets.

    The reference distinguishes unstranded ``DNA5`` from strand-converted
    ``CodingDNA5`` purely at the type level (the code values are identical);
    we keep two classes for the same API safety but share the tables.
    """

    A: int = 0
    C: int = 1
    G: int = 2
    T: int = 3
    N: int = 4
    SIZE: int = 5  # NUCLEOTIDE_COLUMNS in the reference

    LETTERS = "ACGTN"

    # IUPAC extended nucleotide codes; all convert to N (unknown), mirroring
    # kgl_alphabet_dna5.cpp convertChar().
    EXTENDED = "RYSWKMBDHV"

    # char (byte value) -> code. Unknown/extended characters map to N.
    CHAR_TO_CODE = np.full(256, 4, dtype=np.uint8)
    for _i, _ch in enumerate(LETTERS):
        CHAR_TO_CODE[ord(_ch)] = _i
        CHAR_TO_CODE[ord(_ch.lower())] = _i
    # RNA uracil maps to T.
    CHAR_TO_CODE[ord("U")] = 3
    CHAR_TO_CODE[ord("u")] = 3

    # code -> char byte value.
    CODE_TO_CHAR = np.frombuffer(LETTERS.encode(), dtype=np.uint8).copy()

    # complement (A<->T, C<->G, N->N) as a code LUT.
    COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.uint8)

    # purine (A,G) = 1, pyrimidine (C,T) = 0, N = 2 — used for
    # transition/transversion classification.
    _RING_CLASS = np.array([1, 0, 1, 0, 2], dtype=np.uint8)

    @classmethod
    def from_string(cls, text: str) -> np.ndarray:
        """Convert a character string to a uint8 code array (vectorized)."""
        raw = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
        return cls.CHAR_TO_CODE[raw]

    @classmethod
    def from_bytes(cls, raw: bytes | np.ndarray) -> np.ndarray:
        arr = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) else raw
        return cls.CHAR_TO_CODE[arr]

    @classmethod
    def to_string(cls, codes: np.ndarray) -> str:
        return cls.CODE_TO_CHAR[codes].tobytes().decode("ascii")

    @classmethod
    def complement_codes(cls, codes: np.ndarray) -> np.ndarray:
        return cls.COMPLEMENT[codes]

    @classmethod
    def is_extended(cls, char: str) -> bool:
        return char.upper() in cls.EXTENDED

    @classmethod
    def valid_codes(cls, codes: np.ndarray) -> bool:
        return bool(np.all(codes < cls.SIZE))

    @classmethod
    def is_transition(cls, code_1: np.ndarray, code_2: np.ndarray):
        """Transition = purine<->purine or pyrimidine<->pyrimidine (and the
        two bases differ). N never transitions.

        Mirrors DNA5::isTransition (kgl_alphabet_dna5.h:105).
        """
        c1 = cls._RING_CLASS[code_1]
        c2 = cls._RING_CLASS[code_2]
        return (c1 == c2) & (c1 != 2) & (np.asarray(code_1) != np.asarray(code_2))

    @classmethod
    def is_transversion(cls, code_1: np.ndarray, code_2: np.ndarray):
        c1 = cls._RING_CLASS[code_1]
        c2 = cls._RING_CLASS[code_2]
        return (c1 != c2) & (c1 != 2) & (c2 != 2)


class DNA5(_NucleotideAlphabet):
    """Unstranded DNA alphabet (never feed directly to translation)."""


class CodingDNA5(_NucleotideAlphabet):
    """Strand-converted (sense) DNA alphabet — the translatable one."""


class AminoAcid:
    """Amino-acid alphabet: 20 natural AAs + stop '*' + unknown 'Z' (+ rare
    U/O selenocysteine/pyrrolysine).

    Code order matches the reference's enum/column order
    (kgl_alphabet_amino.h:87-118): F L S Y C W P H Q R I M T N K V A D E G,
    then stop (20) and unknown (21); U=22, O=23 are valid characters but are
    not counted among the indexed 21 columns.
    """

    LETTERS = "FLSYCWPHQRIMTNKVADEG*ZUO"
    STOP: int = 20          # '*'
    UNKNOWN: int = 21       # 'Z'
    SELENOCYSTEINE: int = 22
    PYRROLYSINE: int = 23
    SIZE: int = 24
    INDEXED_COLUMNS: int = 21  # 20 natural + unknown (symbolToColumn domain)

    CHAR_TO_CODE = np.full(256, 21, dtype=np.uint8)  # unknown default
    for _i, _ch in enumerate(LETTERS):
        CHAR_TO_CODE[ord(_ch)] = _i
        if _ch.isalpha():
            CHAR_TO_CODE[ord(_ch.lower())] = _i

    CODE_TO_CHAR = np.frombuffer(LETTERS.encode(), dtype=np.uint8).copy()

    @classmethod
    def from_string(cls, text: str) -> np.ndarray:
        raw = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
        return cls.CHAR_TO_CODE[raw]

    @classmethod
    def to_string(cls, codes: np.ndarray) -> str:
        return cls.CODE_TO_CHAR[codes].tobytes().decode("ascii")

    @classmethod
    def valid_codes(cls, codes: np.ndarray) -> bool:
        return bool(np.all(codes < cls.SIZE))
