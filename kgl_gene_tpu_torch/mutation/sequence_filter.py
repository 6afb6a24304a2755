"""Sequence variant selection: choose the unique canonical variants that
modify a region, ready for sequence application.

Capability parity with SequenceVariantFilter
(kgl_mutation/kgl_mutation_variant_filter.h:40-42, .cpp:20-262): region +
canonical-margin windowing, canonical conversion, modify-interval
filtering, per-offset unique selection (prefer homozygous, then highest
allele frequency), upstream-delete shadow removal, and the
SNP-at-offset / indel-at-offset+1 insert-offset convention. Filter types
DEFAULT / HIGHEST_FREQ / FRAMESHIFT_ADJUSTED (drop frameshift indels) /
SNP_ADJUSTED (SNPs only).

Copy of kgl_gene_tpu/mutation/sequence_filter.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.intervals import OpenRightInterval
from ..utils.logging import log
from ..variant.db import ContigDB
from ..variant.variant import Variant, VariantType

__all__ = ["SeqVariantFilterType", "FilteredVariantStats", "SequenceVariantFilter"]

# Margin below the region start so upstream variants whose canonical offset
# shifts forward are still considered (NUCLEOTIDE_CANONICAL_MARGIN).
CANONICAL_MARGIN = 200


class SeqVariantFilterType(Enum):
    DEFAULT_SEQ_FILTER = "DEFAULT"
    HIGHEST_FREQ_VARIANT = "HIGHEST_FREQ"
    FRAMESHIFT_ADJUSTED = "FRAMESHIFT_ADJUSTED"
    SNP_ADJUSTED = "SNP_ADJUSTED"


@dataclass
class FilteredVariantStats:
    total_interval_variants: int = 0
    total_snp_variants: int = 0
    total_frame_shift: int = 0
    non_unique_count: int = 0
    upstream_deleted: int = 0


class SequenceVariantFilter:
    """Select the applying variant set for [start, end) of a genome contig."""

    def __init__(
        self,
        contig_db: ContigDB,
        sequence_interval: OpenRightInterval,
        filter_type: SeqVariantFilterType = SeqVariantFilterType.DEFAULT_SEQ_FILTER,
        info_store=None,
    ):
        self.sequence_interval = sequence_interval
        self.filter_type = filter_type
        self.info_store = info_store
        self.stats = FilteredVariantStats()
        # insert_offset -> Variant (canonical); SNPs at offset, indels at offset+1.
        self.offset_variant_map: Dict[int, Variant] = {}
        self._select(contig_db)

    # ------------------------------------------------------------------ #
    def _allele_frequency(self, variant: Variant) -> float:
        """AF for frequency-preferenced selection: FORMAT alt/(ref+alt)
        depth if present, else the INFO AF field."""
        fmt = variant.format_data
        total = fmt.ref_count + fmt.alt_count
        if total > 0:
            return fmt.alt_count / total
        if self.info_store is not None and self.info_store.has_field("AF"):
            value = self.info_store.value("AF", variant.info_index)
            if isinstance(value, list) and value:
                return float(value[0] or 0.0)
            if isinstance(value, float):
                return value
        return 0.0

    def _select(self, contig_db: ContigDB) -> None:
        region = self.sequence_interval
        lower = max(0, region.lower - CANONICAL_MARGIN)
        windowed = contig_db.region_variants(OpenRightInterval(lower, region.upper))

        # Canonicalise every incidence, keep those modifying the region.
        canonical: List[Variant] = [v.clone_canonical() for v in windowed]
        modifying: List[Variant] = []
        for v in canonical:
            _, modify_iv = v.modify_interval()
            if modify_iv.lower < region.upper and modify_iv.upper > region.lower:
                modifying.append(v)

        # Filter-type specific pre-selection.
        if self.filter_type is SeqVariantFilterType.SNP_ADJUSTED:
            modifying = [v for v in modifying if v.is_snp()]
        elif self.filter_type is SeqVariantFilterType.FRAMESHIFT_ADJUSTED:
            modifying = [
                v for v in modifying
                if v.is_snp() or abs(len(v.ref) - len(v.alt)) % 3 == 0
            ]

        # Statistics over the modifying set.
        hgvs_counts: Dict[str, int] = {}
        for v in modifying:
            hgvs_counts[v.hgvs()] = hgvs_counts.get(v.hgvs(), 0) + 1
        hetero = [v for v in modifying if hgvs_counts[v.hgvs()] == 1]
        self.stats.total_interval_variants = len(hetero)
        self.stats.total_snp_variants = sum(1 for v in hetero if v.is_snp())
        self.stats.total_frame_shift = sum(
            1 for v in hetero
            if not v.is_snp() and abs(len(v.ref) - len(v.alt)) % 3 != 0
        )

        # Per insert-offset unique selection: prefer homozygous (allele seen
        # twice at the offset), then highest frequency
        # (HomozygousCodingFilter semantics, kgl_variant_filter_coding.h).
        by_insert: Dict[int, List[Variant]] = {}
        for v in modifying:
            insert_offset = v.offset if v.is_snp() else v.offset + 1
            by_insert.setdefault(insert_offset, []).append(v)

        unique_count = len({v.hgvs() for v in modifying})
        selected: Dict[int, Variant] = {}
        for insert_offset, variants in sorted(by_insert.items()):
            # Dedup identical alleles, tracking homozygosity.
            allele_counts: Dict[str, Tuple[Variant, int]] = {}
            for v in variants:
                key = v.hgvs()
                if key in allele_counts:
                    allele_counts[key] = (allele_counts[key][0], allele_counts[key][1] + 1)
                else:
                    allele_counts[key] = (v, 1)
            candidates = list(allele_counts.values())
            if len(candidates) == 1:
                selected[insert_offset] = candidates[0][0]
            else:
                homozygous = [c for c in candidates if c[1] >= 2]
                pool = homozygous if homozygous else candidates
                if self.filter_type is SeqVariantFilterType.HIGHEST_FREQ_VARIANT or len(pool) > 1:
                    selected[insert_offset] = max(
                        pool, key=lambda c: self._allele_frequency(c[0])
                    )[0]
                else:
                    selected[insert_offset] = pool[0][0]

        # Remove variants shadowed by an upstream delete
        # (ContigUpstreamFilter, kgl_variant_filter_db_contig.cpp:120).
        final: Dict[int, Variant] = {}
        delete_shadows: List[OpenRightInterval] = []
        upstream_deleted = 0
        for insert_offset in sorted(selected):
            v = selected[insert_offset]
            vtype, member_iv = v.member_interval()
            if any(shadow.intersects(member_iv) for shadow in delete_shadows):
                upstream_deleted += 1
                continue
            final[insert_offset] = v
            if vtype is VariantType.INDEL_DELETE:
                delete_shadows.append(member_iv)

        self.stats.upstream_deleted = upstream_deleted
        self.stats.non_unique_count = unique_count - len(final) - upstream_deleted
        self.offset_variant_map = final

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self.offset_variant_map)

    def variants(self) -> List[Tuple[int, Variant]]:
        return sorted(self.offset_variant_map.items())
