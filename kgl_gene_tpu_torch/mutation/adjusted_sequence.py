"""Sequence mutation: apply selected canonical variants to a contig region,
tracking original <-> modified coordinate translation across indels.

Capability parity with AdjustedSequence + ModifiedOffsetMap
(kgl_mutation/kgl_mutation_sequence.h:26, kgl_mutation_translate.h:24,72):
keeps both the original and modified copies, supports modified/original
sub-sequence extraction in *contig* coordinates (the primitive the exon
splice uses), and accounts for offsets falling in the shadow of a delete.

Implementation: a single pass builds the modified sequence from slices
(SNPs applied in place, indel pieces concatenated) while recording indel
events; coordinate lookup is a binary search over the cumulative-shift
event table — O(log k) per exon bound instead of the reference's map walk.

Copy of kgl_gene_tpu/mutation/adjusted_sequence.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..sequence.sequence import DNA5SequenceLinear
from ..utils.intervals import OpenRightInterval
from ..utils.logging import log
from ..variant.variant import Variant, VariantType
from .sequence_filter import SequenceVariantFilter

__all__ = ["AdjustedSequence"]


@dataclass
class _IndelEvent:
    """An applied indel: at original position, the sequence gains (insert)
    or loses (delete) bases starting at insert_offset."""

    insert_offset: int  # original coordinate where modification begins
    delta: int          # +n inserted bases / -n deleted bases
    cumulative: int = 0  # cumulative delta INCLUDING this event


class AdjustedSequence:
    """Mutate contig region [a, b) with a SequenceVariantFilter selection."""

    def __init__(self, contig_ref, variant_filter: SequenceVariantFilter):
        self.contig_interval = variant_filter.sequence_interval
        self.original = contig_ref.subsequence(self.contig_interval)
        self._events: List[_IndelEvent] = []
        self.applied_snp = 0
        self.applied_delete = 0
        self.applied_insert = 0
        self.valid = True
        self.modified = self._apply(variant_filter)

    # ------------------------------------------------------------------ #
    def _apply(self, variant_filter: SequenceVariantFilter) -> DNA5SequenceLinear:
        a, b = self.contig_interval.lower, self.contig_interval.upper
        base = self.original.codes.copy()

        # Pass 1: SNPs in place (offset-invariant).
        indels: List[Tuple[int, Variant]] = []
        for insert_offset, variant in variant_filter.variants():
            vtype = variant.variant_type()
            if vtype is VariantType.SNP:
                pos = variant.offset - a
                if 0 <= pos < len(base):
                    if base[pos] != variant.ref.codes[0]:
                        log().warn(
                            "SNP {} reference base mismatch at contig offset {}",
                            variant.hgvs(), variant.offset,
                        )
                        self.valid = False
                    base[pos] = variant.alt.codes[0]
                    self.applied_snp += 1
            else:
                indels.append((insert_offset, variant))

        # Pass 2: indels front-to-back building slices.
        pieces: List[np.ndarray] = []
        cursor = 0  # region-relative
        cumulative = 0
        for insert_offset, variant in indels:
            rel = insert_offset - a
            vtype = variant.variant_type()
            if vtype is VariantType.INDEL_DELETE:
                del_size = len(variant.ref) - len(variant.alt)
                # Clamp upstream deletes reaching into the region and
                # deletes running past the region end.
                del_start = max(rel, 0)
                del_end = min(rel + del_size, len(base))
                if del_end <= del_start:
                    continue
                if del_start > cursor:
                    pieces.append(base[cursor:del_start])
                cursor = del_end
                effective = del_end - del_start
                cumulative -= effective
                self._events.append(
                    _IndelEvent(a + del_start, -effective, cumulative)
                )
                self.applied_delete += 1
            else:  # INDEL_INSERT
                ins_codes = variant.alt.codes[1:]  # drop the '1M' anchor
                if rel < 0 or rel > len(base):
                    continue
                if rel > cursor:
                    pieces.append(base[cursor:rel])
                    cursor = rel
                pieces.append(ins_codes)
                cumulative += len(ins_codes)
                self._events.append(
                    _IndelEvent(a + rel, len(ins_codes), cumulative)
                )
                self.applied_insert += 1
        pieces.append(base[cursor:])
        return DNA5SequenceLinear(
            np.concatenate(pieces) if pieces else np.empty(0, dtype=np.uint8)
        )

    # ------------------------------------------------------------------ #
    # coordinate translation (ModifiedOffsetMap analogue)
    # ------------------------------------------------------------------ #
    def _modified_offset(self, contig_offset: int) -> int:
        """Map an original contig offset to a zero-based offset into the
        modified sequence. Offsets in a delete shadow map to the delete
        point. Offsets at an insert position land AFTER the inserted bases
        (so an exon bound at the position includes the insertion on its
        left side)."""
        rel = contig_offset - self.contig_interval.lower
        shift = 0
        for ev in self._events:
            if ev.insert_offset <= contig_offset:
                if ev.delta < 0:
                    # delete [insert_offset, insert_offset - delta)
                    del_end = ev.insert_offset - ev.delta
                    if contig_offset < del_end:
                        # inside the shadow: clamp to the deletion point
                        shift -= contig_offset - ev.insert_offset
                    else:
                        shift += ev.delta
                else:
                    shift += ev.delta
            else:
                break
        return rel + shift

    def modified_interval(self, sub: OpenRightInterval) -> OpenRightInterval:
        lo = self._modified_offset(sub.lower)
        hi = self._modified_offset(sub.upper)
        return OpenRightInterval(lo, max(lo, hi))

    def modified_sub_sequence(self, sub: OpenRightInterval) -> Optional[DNA5SequenceLinear]:
        """Extract the modified bases for an original-coordinate interval
        (AdjustedSequence::modifiedSubSequence)."""
        if not self.contig_interval.contains_interval(sub):
            log().warn("sub interval {} not within contig interval {}",
                       sub, self.contig_interval)
            return None
        mod = self.modified_interval(sub)
        if mod.empty():
            return DNA5SequenceLinear(np.empty(0, dtype=np.uint8))
        return self.modified.subsequence(mod.lower, mod.size)

    def original_sub_sequence(self, sub: OpenRightInterval) -> Optional[DNA5SequenceLinear]:
        if not self.contig_interval.contains_interval(sub):
            return None
        rel = sub.translate(-self.contig_interval.lower)
        return self.original.subsequence(rel.lower, rel.size)

    # ------------------------------------------------------------------ #
    def size_delta(self) -> int:
        return len(self.modified) - len(self.original)
