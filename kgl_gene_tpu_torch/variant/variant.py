"""Variant value semantics: phase, type, canonical form, HGVS identity.

Capability parity with the reference's immutable Variant
(kgl_genomics/kgl_variant_db/kgl_variant_db.h:25-189). In the TPU build a
Variant is a lightweight *view* over a columnar VariantArena row plus its
per-genome incidence data (phase + format evidence); all bulk operations
(canonicalisation, typing, interval maths) also exist as vectorized
column ops in arena.py.

Copy of kgl_gene_tpu/variant/variant.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum, IntEnum
from typing import Optional, Tuple

import numpy as np

from ..sequence.sequence import DNA5SequenceLinear
from ..utils.intervals import OpenRightInterval

__all__ = ["VariantPhase", "VariantType", "Variant", "FormatData", "canonicalize"]


class VariantPhase(IntEnum):
    """Chromosome phase (kgl_variant_db.h:25-28)."""

    HAPLOID_PHASED = 0
    DIPLOID_PHASE_A = 1
    DIPLOID_PHASE_B = 2
    UNPHASED = 255


class VariantType(Enum):
    SNP = "SNP"
    INDEL_DELETE = "INDEL_DELETE"
    INDEL_INSERT = "INDEL_INSERT"


@dataclass(frozen=True)
class FormatData:
    """Per-genome per-variant FORMAT evidence (ref/alt depth, DP, GQ,
    record quality) — the reference's FormatData payload."""

    ref_count: int = 0
    alt_count: int = 0
    dp_count: int = 0
    gq_value: float = 0.0
    quality: float = 0.0


def _is_snp(ref: np.ndarray, alt: np.ndarray) -> bool:
    """SNP including the cigar-style '4M1X8M' single-difference case
    (Variant::isSNP, kgl_variant_db.cpp:121)."""
    if len(ref) == 1 and len(alt) == 1:
        return True
    if len(ref) != len(alt):
        return False
    return int(np.sum(ref != alt)) == 1


def canonicalize(
    ref: np.ndarray, alt: np.ndarray, offset: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Reduce (ref, alt, offset) to canonical form: SNP '1X', delete '1MnD',
    insert '1MnI' (Variant::canonicalSequences, kgl_variant_db.cpp:167-194).

    Keeps one matching leading base for indels; trims the common suffix
    bounded so at least one base remains on the shorter side.
    """
    rlen, alen = len(ref), len(alt)
    if (rlen == 1 and alen == 1) or (alen == 1 and rlen > 1) or (rlen == 1 and alen > 1):
        return ref, alt, offset
    n = min(rlen, alen)
    neq = ref[:n] != alt[:n]
    prefix = int(np.argmax(neq)) if neq.any() else n
    prefix = prefix - 1 if prefix > 0 else 0  # keep the '1M' anchor base
    req = ref[rlen - n :][::-1] != alt[alen - n :][::-1]
    suffix = int(np.argmax(req)) if req.any() else n
    adj_suffix = min(n - prefix - 1, suffix)
    adj_suffix = max(adj_suffix, 0)
    c_ref = ref[prefix : rlen - adj_suffix]
    c_alt = alt[prefix : alen - adj_suffix]
    return c_ref, c_alt, offset + prefix


class Variant:
    """Immutable variant view: contig, ZERO-based offset, phase, ref/alt.

    Mirrors the reference Variant API (HGVS identity, canonical clone,
    modify/member intervals, phase equality).
    """

    __slots__ = ("contig_id", "offset", "phase", "identifier", "ref", "alt",
                 "format_data", "info_index", "pass_filter")

    def __init__(
        self,
        contig_id: str,
        offset: int,
        phase: VariantPhase,
        identifier: str,
        ref: DNA5SequenceLinear,
        alt: DNA5SequenceLinear,
        format_data: Optional[FormatData] = None,
        info_index: int = -1,
        pass_filter: bool = True,
    ):
        self.contig_id = contig_id
        self.offset = int(offset)
        self.phase = VariantPhase(phase)
        self.identifier = identifier
        self.ref = ref
        self.alt = alt
        self.format_data = format_data or FormatData()
        self.info_index = info_index
        self.pass_filter = pass_filter

    # --- typing -----------------------------------------------------------
    def is_snp(self) -> bool:
        return _is_snp(self.ref.codes, self.alt.codes)

    def variant_type(self) -> VariantType:
        if not self.is_snp():
            return (
                VariantType.INDEL_INSERT
                if len(self.ref) < len(self.alt)
                else VariantType.INDEL_DELETE
            )
        return VariantType.SNP

    # --- canonical form ---------------------------------------------------
    def is_canonical(self) -> bool:
        rlen, alen = len(self.ref), len(self.alt)
        return (
            (rlen == 1 and alen == 1)
            or (alen == 1 and rlen > 1)
            or (rlen == 1 and alen > 1)
        )

    def clone_canonical(self) -> "Variant":
        c_ref, c_alt, c_off = canonicalize(self.ref.codes, self.alt.codes, self.offset)
        return Variant(
            self.contig_id, c_off, self.phase, self.identifier,
            DNA5SequenceLinear(c_ref), DNA5SequenceLinear(c_alt),
            self.format_data, self.info_index, self.pass_filter,
        )

    def clone_phase(self, phase: VariantPhase) -> "Variant":
        return Variant(
            self.contig_id, self.offset, phase, self.identifier,
            self.ref, self.alt, self.format_data, self.info_index, self.pass_filter,
        )

    # --- intervals (kgl_variant_db.cpp:226-258) ---------------------------
    def modify_interval(self) -> Tuple[VariantType, OpenRightInterval]:
        vtype = self.variant_type()
        if vtype is VariantType.SNP:
            return vtype, OpenRightInterval(self.offset, self.offset + 1)
        if vtype is VariantType.INDEL_DELETE:
            size = len(self.ref) - len(self.alt)
            return vtype, OpenRightInterval(self.offset + 1, self.offset + 1 + size)
        size = len(self.alt) - len(self.ref)
        return vtype, OpenRightInterval(self.offset + 1, self.offset + 1 + size)

    def member_interval(self) -> Tuple[VariantType, OpenRightInterval]:
        vtype, interval = self.modify_interval()
        if vtype is VariantType.INDEL_INSERT:
            return vtype, OpenRightInterval(self.offset + 1, self.offset + 2)
        return vtype, interval

    # --- identity (kgl_variant_db.cpp:287-298) ----------------------------
    def hgvs(self) -> str:
        return f"{self.contig_id}:g.{self.offset}{self.ref.to_string()}>{self.alt.to_string()}"

    def hgvs_phase(self) -> str:
        return f"{self.hgvs()}:{int(self.phase)}"

    def analogous(self, other: "Variant") -> bool:
        """Equal up to phase."""
        return self.hgvs() == other.hgvs()

    def homozygous(self, other: "Variant") -> bool:
        return self.analogous(other) and self.phase != other.phase

    def __eq__(self, other) -> bool:
        return isinstance(other, Variant) and self.hgvs_phase() == other.hgvs_phase()

    def __lt__(self, other) -> bool:
        return self.hgvs_phase() < other.hgvs_phase()

    def __hash__(self):
        return hash(self.hgvs_phase())

    def __repr__(self):
        return f"Variant({self.hgvs_phase()})"
