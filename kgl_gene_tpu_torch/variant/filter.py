"""Composable variant-filter algebra as vectorized mask predicates.

Capability parity with the reference filter framework
(kgl_variant_filter/kgl_variant_filter_type.h:33, _db_variant.h:20-274,
_db_offset.h:27-114, _db_contig.h:23-118, _db_genome.h:27): the same
level-typed vocabulary (variant / offset / contig / genome / population
filters plus Not/And/Or/True/False combinators), but each filter computes a
boolean mask over a ContigDB's incidence columns in one vectorized pass —
the reference's per-variant virtual dispatch becomes `~ & |` on arrays.

Copy of kgl_gene_tpu/variant/filter.py.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ..utils.intervals import OpenRightInterval
from .db import ContigDB, GenomeDB, PopulationDB
from .variant import VariantPhase

__all__ = [
    "BaseFilter", "FilterVariants", "FilterOffsets", "FilterContigs",
    "TrueFilter", "FalseFilter", "NotFilter", "AndFilter", "OrFilter",
    "PassFilter", "SNPFilter", "FrameShiftFilter", "DPCountFilter",
    "RefAltCountFilter", "PhaseFilter", "UniqueUnphasedFilter",
    "UniquePhasedFilter", "HomozygousFilter", "HeterozygousFilter",
    "DiploidFilter", "ContigRegionFilter", "GenomeListFilter",
    "InfoGEQFloatFilter", "P7FrequencyFilter", "VepSubStringFilter",
]


class BaseFilter:
    """Root of the filter algebra. Subclasses implement mask() over a
    ContigDB; structural filters override apply_population directly."""

    filter_name = "BaseFilter"

    def mask(self, contig: ContigDB) -> np.ndarray:
        raise NotImplementedError

    # --- application ------------------------------------------------------
    def apply_contig(self, contig: ContigDB) -> ContigDB:
        return contig.select(self.mask(contig))

    def apply_genome(self, genome: GenomeDB) -> GenomeDB:
        return genome._map_contigs(self.apply_contig)

    def apply_population(self, population: PopulationDB) -> PopulationDB:
        # Empty genomes are preserved (reference viewFilter keeps every
        # genome in the filtered population).
        out = PopulationDB(population.population_id, population.data_source, population.arena)
        for gid, genome in population.genome_map.items():
            out.genome_map[gid] = self.apply_genome(genome)
        return out

    # --- combinators ------------------------------------------------------
    def __and__(self, other: "BaseFilter") -> "AndFilter":
        return AndFilter(self, other)

    def __or__(self, other: "BaseFilter") -> "OrFilter":
        return OrFilter(self, other)

    def __invert__(self) -> "NotFilter":
        return NotFilter(self)

    def __repr__(self):
        return self.filter_name


# Level-typed aliases (the reference's FilterVariants/FilterOffsets/... tags).
class FilterVariants(BaseFilter):
    pass


class FilterOffsets(BaseFilter):
    pass


class FilterContigs(BaseFilter):
    pass


class FilterGenomes(BaseFilter):
    pass


class FilterPopulations(BaseFilter):
    pass


# --------------------------------------------------------------------------- #
# logic combinators
# --------------------------------------------------------------------------- #
class TrueFilter(FilterVariants):
    filter_name = "TrueFilter"

    def mask(self, contig: ContigDB) -> np.ndarray:
        return np.ones(contig.variant_count(), dtype=bool)


class FalseFilter(FilterVariants):
    filter_name = "FalseFilter"

    def mask(self, contig: ContigDB) -> np.ndarray:
        return np.zeros(contig.variant_count(), dtype=bool)


class NotFilter(FilterVariants):
    def __init__(self, inner: BaseFilter):
        self.inner = inner
        self.filter_name = f"NOT({inner.filter_name})"

    def mask(self, contig: ContigDB) -> np.ndarray:
        return ~self.inner.mask(contig)


class AndFilter(FilterVariants):
    def __init__(self, left: BaseFilter, right: BaseFilter):
        self.left, self.right = left, right
        self.filter_name = f"AND({left.filter_name}, {right.filter_name})"

    def mask(self, contig: ContigDB) -> np.ndarray:
        return self.left.mask(contig) & self.right.mask(contig)


class OrFilter(FilterVariants):
    def __init__(self, left: BaseFilter, right: BaseFilter):
        self.left, self.right = left, right
        self.filter_name = f"OR({left.filter_name}, {right.filter_name})"

    def mask(self, contig: ContigDB) -> np.ndarray:
        return self.left.mask(contig) | self.right.mask(contig)


# --------------------------------------------------------------------------- #
# variant-level filters (kgl_variant_filter_db_variant.h)
# --------------------------------------------------------------------------- #
class PassFilter(FilterVariants):
    """VCF FILTER == PASS."""

    filter_name = "PassFilter"

    def mask(self, contig: ContigDB) -> np.ndarray:
        return contig.columns()["pass"].copy()


class SNPFilter(FilterVariants):
    filter_name = "SNPFilter"

    def mask(self, contig: ContigDB) -> np.ndarray:
        snp_col = contig.arena.is_snp_column()
        return snp_col[contig.columns()["row"]]


class FrameShiftFilter(FilterVariants):
    """Indels whose size difference is not mod 3."""

    filter_name = "FrameShiftFilter"

    def mask(self, contig: ContigDB) -> np.ndarray:
        rows = contig.columns()["row"]
        diff = np.abs(contig.arena.ref_lens[rows] - contig.arena.alt_lens[rows])
        snp = contig.arena.is_snp_column()[rows]
        return (~snp) & (diff % 3 != 0)


class DPCountFilter(FilterVariants):
    """Minimum total read depth (DP)."""

    def __init__(self, minimum_count: int):
        self.minimum_count = minimum_count
        self.filter_name = f"DPCountFilter(>={minimum_count})"

    def mask(self, contig: ContigDB) -> np.ndarray:
        return contig.columns()["dp_count"] >= self.minimum_count


class RefAltCountFilter(FilterVariants):
    """Minimum ref+alt base count."""

    def __init__(self, minimum_count: int):
        self.minimum_count = minimum_count
        self.filter_name = f"RefAltCountFilter(>={minimum_count})"

    def mask(self, contig: ContigDB) -> np.ndarray:
        cols = contig.columns()
        return (cols["ref_count"] + cols["alt_count"]) >= self.minimum_count


class PhaseFilter(FilterVariants):
    def __init__(self, phase: VariantPhase):
        self.phase = phase
        self.filter_name = f"PhaseFilter({phase.name})"

    def mask(self, contig: ContigDB) -> np.ndarray:
        return contig.columns()["phase"] == int(self.phase)


# --------------------------------------------------------------------------- #
# offset-level filters (kgl_variant_filter_db_offset.h)
# --------------------------------------------------------------------------- #
def _group_bounds(offsets: np.ndarray):
    """Start index and size of each equal-offset run (offsets sorted)."""
    if len(offsets) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64)
    change = np.concatenate(([True], offsets[1:] != offsets[:-1]))
    starts = np.nonzero(change)[0]
    sizes = np.diff(np.concatenate((starts, [len(offsets)])))
    group_of = np.cumsum(change) - 1
    return starts, sizes, group_of


class HomozygousFilter(FilterOffsets):
    """Offsets with exactly 2 identical (unphased-equal) variants
    (kgl_variant_filter_db_offset.cpp:17)."""

    filter_name = "HomozygousFilter"

    def mask(self, contig: ContigDB) -> np.ndarray:
        cols = contig.columns()
        starts, sizes, group_of = _group_bounds(cols["offset"])
        keep = np.zeros(contig.variant_count(), dtype=bool)
        for g, start in enumerate(starts):
            if sizes[g] == 2 and cols["row"][start] == cols["row"][start + 1]:
                keep[start : start + 2] = True
        return keep


class HeterozygousFilter(FilterOffsets):
    """Variants whose allele appears exactly once at their offset."""

    filter_name = "HeterozygousFilter"

    def mask(self, contig: ContigDB) -> np.ndarray:
        cols = contig.columns()
        keep = np.zeros(contig.variant_count(), dtype=bool)
        starts, sizes, _ = _group_bounds(cols["offset"])
        for g, start in enumerate(starts):
            rows = cols["row"][start : start + sizes[g]]
            uniq, counts = np.unique(rows, return_counts=True)
            singles = set(uniq[counts == 1])
            for i in range(sizes[g]):
                if rows[i] in singles:
                    keep[start + i] = True
        return keep


class DiploidFilter(FilterOffsets):
    """Keep offsets carrying at most 2 variants
    (kgl_variant_filter_db_offset.cpp:112)."""

    filter_name = "DiploidFilter"

    def mask(self, contig: ContigDB) -> np.ndarray:
        cols = contig.columns()
        starts, sizes, group_of = _group_bounds(cols["offset"])
        return sizes[group_of] <= 2 if len(sizes) else np.zeros(0, dtype=bool)


class UniqueUnphasedFilter(FilterOffsets):
    """First instance of each distinct allele at each offset (phase
    ignored)."""

    filter_name = "UniqueUnphasedFilter"

    def mask(self, contig: ContigDB) -> np.ndarray:
        cols = contig.columns()
        key = np.stack([cols["offset"], cols["row"]], axis=1) if contig.variant_count() else np.empty((0, 2))
        keep = np.zeros(contig.variant_count(), dtype=bool)
        seen = set()
        for i, (off, row) in enumerate(map(tuple, key)):
            if (off, row) not in seen:
                seen.add((off, row))
                keep[i] = True
        return keep


class UniquePhasedFilter(FilterOffsets):
    """First instance of each distinct (allele, phase) at each offset."""

    filter_name = "UniquePhasedFilter"

    def mask(self, contig: ContigDB) -> np.ndarray:
        cols = contig.columns()
        keep = np.zeros(contig.variant_count(), dtype=bool)
        seen = set()
        for i in range(contig.variant_count()):
            k = (int(cols["offset"][i]), int(cols["row"][i]), int(cols["phase"][i]))
            if k not in seen:
                seen.add(k)
                keep[i] = True
        return keep


# --------------------------------------------------------------------------- #
# contig-level filters (kgl_variant_filter_db_contig.h)
# --------------------------------------------------------------------------- #
class ContigRegionFilter(FilterContigs):
    """Variants with offset in [start, end) (ContigRegionFilter)."""

    def __init__(self, start: int, end: int):
        self.interval = OpenRightInterval(start, end)
        self.filter_name = f"ContigRegionFilter([{start},{end}))"

    def mask(self, contig: ContigDB) -> np.ndarray:
        offs = contig.columns()["offset"]
        return (offs >= self.interval.lower) & (offs < self.interval.upper)


class ContigModifyFilter(FilterContigs):
    """Canonical variants that modify the region [start, end) — includes
    upstream deletes that reach into the region (ContigModifyFilter
    semantics used by the mutation engine)."""

    def __init__(self, start: int, end: int):
        self.interval = OpenRightInterval(start, end)
        self.filter_name = f"ContigModifyFilter([{start},{end}))"

    def mask(self, contig: ContigDB) -> np.ndarray:
        cols = contig.columns()
        rows = cols["row"]
        offs = cols["offset"]
        ref_len = contig.arena.ref_lens[rows].astype(np.int64)
        alt_len = contig.arena.alt_lens[rows].astype(np.int64)
        is_delete = ref_len > alt_len
        is_insert = alt_len > ref_len
        # modify-interval lower bound per canonical type
        lower = np.where(is_delete | is_insert, offs + 1, offs)
        size = np.where(is_delete, ref_len - alt_len, np.where(is_insert, alt_len - ref_len, 1))
        upper = lower + size
        return (lower < self.interval.upper) & (upper > self.interval.lower)


class InfoGEQFloatFilter(FilterVariants):
    """Variants whose scalar INFO field value >= threshold
    (InfoGEQFloatFilter, kgl_variant_filter_info.h:35). Missing values
    fail the filter."""

    def __init__(self, info_store, field_id: str, threshold: float):
        self.info = info_store
        self.field_id = field_id
        self.threshold = threshold
        self.filter_name = f"InfoGEQFloatFilter({field_id}>={threshold})"

    def _value(self, info_row: int) -> float:
        if info_row < 0:
            return np.nan
        value = self.info.value(self.field_id, info_row)
        if isinstance(value, list):
            value = value[0] if value else None
        if value is None:
            return np.nan
        return float(value)

    def mask(self, contig: ContigDB) -> np.ndarray:
        rows = contig.columns()["row"]
        values = np.array(
            [self._value(contig.arena.info_row(int(r))) for r in rows]
        )
        with np.errstate(invalid="ignore"):
            return values >= self.threshold


class P7FrequencyFilter(InfoGEQFloatFilter):
    """Pf7 allele-frequency floor filter (kgl_variant_filter_Pf7.h:61):
    AF >= threshold; combine with NotFilter of a higher floor for a bin."""

    def __init__(self, info_store, min_freq: float, field_id: str = "AF"):
        super().__init__(info_store, field_id, min_freq)
        self.filter_name = f"P7FrequencyFilter(AF>={min_freq})"


class VepSubStringFilter(FilterVariants):
    """Variants with a VEP sub-field containing a substring
    (VepSubStringFilter, kgl_variant_filter_info.h:86)."""

    def __init__(self, vep, sub_field: str, substring: str):
        self.vep = vep
        self.sub_field = sub_field
        self.substring = substring
        self.filter_name = f"VepSubStringFilter({sub_field}~{substring})"

    def mask(self, contig: ContigDB) -> np.ndarray:
        rows = contig.columns()["row"]
        return np.array([
            self.vep.contains_substring(
                contig.arena.info_row(int(r)), self.sub_field, self.substring
            )
            for r in rows
        ], dtype=bool)


class GenomeListFilter(FilterPopulations):
    """Keep only the listed genomes (kgl_variant_filter_db_genome.h:27)."""

    def __init__(self, genome_ids):
        self.genome_ids = set(genome_ids)
        self.filter_name = f"GenomeListFilter({len(self.genome_ids)} genomes)"

    def apply_population(self, population: PopulationDB) -> PopulationDB:
        out = PopulationDB(population.population_id, population.data_source, population.arena)
        for gid, genome in population.genome_map.items():
            if gid in self.genome_ids:
                out.genome_map[gid] = genome
        return out
