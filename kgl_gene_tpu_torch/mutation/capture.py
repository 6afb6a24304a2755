"""Transcript capture: PopulationDB -> device tensors for the forward step.

This is the bridge between the columnar variant store and the flagship TPU
pipeline (ops/pipeline.py): for one transcript region it classifies every
genome as either *device-capturable* (all windowed variants are simple
1-base SNPs with no per-offset allele conflicts — the overwhelming majority
on population data) or *host-exact* (indels / same-offset allele conflicts,
routed through the reference-parity AdjustedSequence engine).

Capture reproduces the SequenceVariantFilter selection semantics
(kgl_mutation/kgl_mutation_variant_filter.cpp:20-262) for the SNP-only
case as pure vectorized numpy over the contig's incidence columns:
canonical-margin windowing (len-1/len-1 SNPs are already canonical, so
the margin variants never modify the region), region-modify check,
homozygous-duplicate dedup and the filter statistics. Any genome whose
windowed set violates a fast-path precondition falls back to the host
filter, which is the semantic oracle by construction.

The reference runs this workload as a thread-per-genome pool over
AdjustedSequence (kga_analytic/kga_analysis_library/
kga_analysis_lib_seqmutation.cpp:116-140); here the per-genome SNP sets
become one (B, K) tensor batch consumed by make_forward_step.

Copy of kgl_gene_tpu/mutation/capture.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..utils.intervals import OpenRightInterval
from ..variant.arena import VariantArena
from ..variant.db import ContigDB, PopulationDB
from .sequence_filter import (
    CANONICAL_MARGIN,
    FilteredVariantStats,
    SeqVariantFilterType,
    SequenceVariantFilter,
)

__all__ = [
    "GenomeCapture",
    "PopulationCapture",
    "BatchCapture",
    "IndelBatchCapture",
    "fast_snp_capture",
    "capture_population",
    "capture_population_batch",
    "capture_population_split",
    "batch_capture_tensors",
]


@dataclass
class GenomeCapture:
    """One genome's selected SNP set for a transcript region."""

    genome_id: str
    positions: np.ndarray  # (k,) int64 absolute contig offsets (selected SNPs)
    alt_codes: np.ndarray  # (k,) uint8 alternate base codes
    stats: FilteredVariantStats = field(default_factory=FilteredVariantStats)

    @property
    def variant_count(self) -> int:
        return int(self.positions.shape[0])


@dataclass
class PopulationCapture:
    """Population split into device-capturable and host-exact genomes."""

    device: List[GenomeCapture]
    host_genome_ids: List[str]   # need the exact AdjustedSequence path
    empty_genome_ids: List[str]  # no contig / zero incidences for the contig


def fast_snp_capture(
    contig_db: ContigDB,
    region: OpenRightInterval,
) -> Optional[GenomeCapture]:
    """Vectorized SNP-only capture for one genome contig; None -> host path.

    Preconditions for the fast path (checked, not assumed):
      * every incidence in the canonical-margin window is a len-1/len-1
        allele (already canonical: clone_canonical is the identity on
        these, kgl_variant/kgl_variant.cpp canonical trim rules), and
      * no region-modifying offset carries more than one DISTINCT allele
        (so the homozygous-preference / allele-frequency tie-break of
        SequenceVariantFilter never fires).
    """
    arena = contig_db.arena
    cols = contig_db.columns()
    offsets = cols["offset"]
    lower = max(0, region.lower - CANONICAL_MARGIN)
    lo = int(np.searchsorted(offsets, lower, side="left"))
    hi = int(np.searchsorted(offsets, region.upper, side="left"))
    rows = np.asarray(cols["row"][lo:hi], dtype=np.int64)
    stats = FilteredVariantStats()
    if rows.size == 0:
        return GenomeCapture("", np.empty(0, np.int64), np.empty(0, np.uint8), stats)

    # Every windowed allele must be a simple SNP (len-1 ref and alt). A
    # same-length multi-base row can canonicalise to a shifted SNP, so it
    # goes to the host filter too.
    if not bool(np.all((arena.ref_lens[rows] == 1) & (arena.alt_lens[rows] == 1))):
        return None

    # Region-modify check: a canonical SNP modifies [offset, offset+1).
    offs = offsets[lo:hi]
    modifying = (offs >= region.lower) & (offs < region.upper)
    rows_m = rows[modifying]
    if rows_m.size == 0:
        return GenomeCapture("", np.empty(0, np.int64), np.empty(0, np.uint8), stats)

    # Selection + statistics over the modifying set. Same (contig, offset,
    # ref, alt) == same arena row, so row identity == HGVS identity.
    unique_rows, counts = np.unique(rows_m, return_counts=True)
    unique_offsets = arena.offsets[unique_rows]
    order = np.argsort(unique_offsets, kind="stable")
    unique_rows, unique_offsets = unique_rows[order], unique_offsets[order]
    # Per-offset allele conflict (two distinct rows at one insert offset)
    # -> host path for the homozygous/AF tie-break.
    if unique_offsets.size > 1 and bool(np.any(unique_offsets[1:] == unique_offsets[:-1])):
        return None

    counts = counts[order]
    # "hetero" in the filter's stats sense: alleles seen exactly once.
    n_hetero = int(np.sum(counts == 1))
    stats.total_interval_variants = n_hetero
    stats.total_snp_variants = n_hetero  # all fast-path alleles are SNPs
    stats.total_frame_shift = 0
    stats.non_unique_count = 0           # one allele per offset: all selected
    stats.upstream_deleted = 0           # SNPs never shadow downstream

    alt_first = arena.alt_first
    return GenomeCapture(
        "", unique_offsets.astype(np.int64), alt_first[unique_rows], stats
    )


def capture_population(
    population: PopulationDB,
    contig_id: str,
    region: OpenRightInterval,
) -> PopulationCapture:
    """Split a population over one transcript region (sorted genome order)."""
    device: List[GenomeCapture] = []
    host_ids: List[str] = []
    empty_ids: List[str] = []
    for genome_id, genome in population:
        contig_db = genome.get_contig(contig_id)
        if contig_db is None or contig_db.variant_count() == 0:
            empty_ids.append(genome_id)
            continue
        cap = fast_snp_capture(contig_db, region)
        if cap is None:
            host_ids.append(genome_id)
        else:
            cap.genome_id = genome_id
            device.append(cap)
    return PopulationCapture(device, host_ids, empty_ids)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


# --------------------------------------------------------------------------- #
# Vectorized population capture: ONE columnar pass for ALL genomes
# --------------------------------------------------------------------------- #
class PopulationContigIndex:
    """Population-level incidence columns for one contig, globally sorted
    by offset.

    Concatenates every genome's (row, offset) incidence columns with a
    genome-slot column so a transcript window is ONE searchsorted slice and
    the per-genome SNP/conflict classification is pure vectorized numpy —
    no per-genome Python. This is the columnar replacement for the
    reference's thread-per-genome capture fan-out
    (kga_analytic/kga_analysis_library/kga_analysis_lib_seqmutation.cpp:116-140).
    Cached on the population keyed by (contig, incidence count)."""

    def __init__(self, population: PopulationDB, contig_id: str):
        self.contig_id = contig_id
        self.genome_ids: List[str] = [gid for gid, _ in population]
        slot_of = {gid: i for i, gid in enumerate(self.genome_ids)}
        self.empty_mask = np.ones(len(self.genome_ids), dtype=bool)
        gs, rs = [], []
        for gid, genome in population:
            contig_db = genome.get_contig(contig_id)
            if contig_db is None or contig_db.variant_count() == 0:
                continue
            self.empty_mask[slot_of[gid]] = False
            rows = contig_db.incidence_rows()
            gs.append(np.full(len(rows), slot_of[gid], dtype=np.int32))
            rs.append(np.asarray(rows, dtype=np.int64))
        if gs:
            gslot = np.concatenate(gs)
            row = np.concatenate(rs)
            offset = population.arena.offsets[row]
            order = np.argsort(offset, kind="stable")
            self.gslot, self.row, self.offset = gslot[order], row[order], offset[order]
        else:
            self.gslot = np.empty(0, np.int32)
            self.row = np.empty(0, np.int64)
            self.offset = np.empty(0, np.int64)
        self.incidence_count = len(self.row)

    @staticmethod
    def get(population: PopulationDB, contig_id: str) -> "PopulationContigIndex":
        cache = getattr(population, "_capture_index_cache", None)
        if cache is None:
            cache = {}
            population._capture_index_cache = cache
        count = population.variant_count()
        key = contig_id
        entry = cache.get(key)
        if entry is not None and entry[0] == count:
            return entry[1]
        index = PopulationContigIndex(population, contig_id)
        cache[key] = (count, index)
        return index


@dataclass
class BatchCapture:
    """Whole-population capture for one transcript region as (B, K)
    tensors (device genomes) plus the host/empty genome splits.

    Semantics identical to per-genome fast_snp_capture/batch_capture_tensors
    (tested equal): device genomes are packed in sorted-genome order into
    rows [0, len(genome_ids)); k_counts / hetero_counts carry the per-genome
    selection statistics (hetero == FilteredVariantStats.total_snp_variants)."""

    genome_ids: List[str]       # device genomes, sorted order
    positions: np.ndarray       # (B, K) int32 region-relative SNP positions
    alt_codes: np.ndarray       # (B, K) uint8
    valid: np.ndarray           # (B, K) bool
    k_counts: np.ndarray        # (len(genome_ids),) selected variants per genome
    hetero_counts: np.ndarray   # (len(genome_ids),) alleles seen exactly once
    host_genome_ids: List[str]
    empty_genome_ids: List[str]


def capture_population_batch(
    population: PopulationDB,
    contig_id: str,
    region: OpenRightInterval,
    region_start: Optional[int] = None,
    k_bucket: Optional[int] = None,
    b_bucket: Optional[int] = None,
) -> BatchCapture:
    """One vectorized pass over the population's contig incidence columns
    producing the (B, K) device tensors for ALL genomes of a transcript at
    once. Replaces the per-genome fast_snp_capture loop (which remains as
    the tested oracle)."""
    index = PopulationContigIndex.get(population, contig_id)
    n_genomes = len(index.genome_ids)
    arena = population.arena
    empty_ids = [g for g, e in zip(index.genome_ids, index.empty_mask) if e]

    lower = max(0, region.lower - CANONICAL_MARGIN)
    lo = int(np.searchsorted(index.offset, lower, side="left"))
    hi = int(np.searchsorted(index.offset, region.upper, side="left"))
    g = index.gslot[lo:hi]
    r = index.row[lo:hi]
    o = index.offset[lo:hi]

    # Host routing (a): any windowed incidence that is not a len-1/len-1
    # allele (same margin window as fast_snp_capture).
    snp_ok = (arena.ref_lens[r] == 1) & (arena.alt_lens[r] == 1)
    host_flag = np.zeros(n_genomes, dtype=bool)
    if not snp_ok.all():
        host_flag[np.unique(g[~snp_ok])] = True

    # Modifying set: canonical SNPs modify [offset, offset+1).
    modifying = (o >= region.lower) & (o < region.upper)
    gm, rm, om = g[modifying], r[modifying], o[modifying]
    order = np.lexsort((rm, om, gm))
    gs, rs, os_ = gm[order], rm[order], om[order]

    # Unique (genome, row) pairs + incidence counts (hom 1/1 contributes
    # two incidences of one row — dedup keeps one, counts track zygosity).
    n = len(gs)
    first = np.ones(n, dtype=bool)
    if n > 1:
        first[1:] = (gs[1:] != gs[:-1]) | (rs[1:] != rs[:-1])
    uidx = np.nonzero(first)[0]
    counts = np.diff(np.append(uidx, n))
    ug, ur, uo = gs[uidx], rs[uidx], os_[uidx]

    # Host routing (b): two DISTINCT rows at one (genome, offset) — the
    # homozygous-preference / AF tie-break of SequenceVariantFilter.
    if len(ug) > 1:
        conflict = (ug[1:] == ug[:-1]) & (uo[1:] == uo[:-1])
        if conflict.any():
            host_flag[np.unique(ug[1:][conflict])] = True

    host_mask = host_flag & ~index.empty_mask
    host_ids = [gid for gid, h in zip(index.genome_ids, host_mask) if h]
    device_mask = ~host_flag & ~index.empty_mask
    device_slots = np.nonzero(device_mask)[0]
    device_ids = [index.genome_ids[s] for s in device_slots]
    # dense device slot per genome slot (-1 = host/empty)
    dslot_of = np.full(n_genomes, -1, dtype=np.int64)
    dslot_of[device_slots] = np.arange(len(device_slots))

    keep = dslot_of[ug] >= 0
    ug2, ur2, uo2, cnt2 = ug[keep], ur[keep], uo[keep], counts[keep]
    d2 = dslot_of[ug2]

    n_dev = len(device_slots)
    k_counts = np.bincount(d2, minlength=n_dev).astype(np.int32)
    hetero_counts = np.bincount(
        d2[cnt2 == 1], minlength=n_dev
    ).astype(np.int32)

    k_max = int(k_counts.max()) if n_dev else 0
    K = k_bucket if k_bucket is not None else max(8, _next_pow2(k_max))
    B = b_bucket if b_bucket is not None else max(8, _next_pow2(n_dev))
    if k_max > K or n_dev > B:
        raise ValueError(f"bucket too small: need ({n_dev},{k_max}), got ({B},{K})")
    positions = np.zeros((B, K), dtype=np.int32)
    alt_codes = np.zeros((B, K), dtype=np.uint8)
    valid = np.zeros((B, K), dtype=bool)
    if region_start is None:
        region_start = region.lower
    if len(d2):
        # within-genome rank: d2 is non-decreasing (ug2 sorted)
        starts = np.searchsorted(d2, np.arange(n_dev))
        rank = np.arange(len(d2)) - starts[d2]
        positions[d2, rank] = (uo2 - region_start).astype(np.int32)
        alt_codes[d2, rank] = arena.alt_first[ur2]
        valid[d2, rank] = True
    return BatchCapture(
        genome_ids=device_ids,
        positions=positions,
        alt_codes=alt_codes,
        valid=valid,
        k_counts=k_counts,
        hetero_counts=hetero_counts,
        host_genome_ids=host_ids,
        empty_genome_ids=empty_ids,
    )


# --------------------------------------------------------------------------- #
# General (SNP + indel) vectorized capture
# --------------------------------------------------------------------------- #
@dataclass
class IndelBatchCapture:
    """Device tensors for genomes whose selected set contains canonical
    indels (1MnD/1MnI) satisfying the device preconditions: unique allele
    per insert key, no upstream-delete shadow interactions, bounded insert
    width. Slot kinds: 0 SNP / 1 DEL / 2 INS; positions are region-relative
    insert offsets (indels at offset+1, the selection-map convention)."""

    genome_ids: List[str]
    pos: np.ndarray         # (B, K) int32
    kind: np.ndarray        # (B, K) int8
    del_len: np.ndarray     # (B, K) int32 (region-clamped)
    ins_codes: np.ndarray   # (B, K, A) uint8
    ins_len: np.ndarray     # (B, K) int32
    alt_code: np.ndarray    # (B, K) uint8
    valid: np.ndarray       # (B, K) bool (selected AND applied)
    k_counts: np.ndarray        # selected variants per genome (incl. skipped apply)
    hetero_counts: np.ndarray   # stats.total_snp_variants per genome
    frameshift_counts: np.ndarray
    edit_bound: int             # max per-genome edit-op total (band routing)
    a_max: int


def capture_population_split(
    population: PopulationDB,
    contig_id: str,
    region: OpenRightInterval,
    region_start: Optional[int] = None,
    k_bucket: Optional[int] = None,
    b_bucket: Optional[int] = None,
    a_max: int = 16,
) -> Tuple[BatchCapture, Optional[IndelBatchCapture]]:
    """One vectorized pass splitting the population three ways for a
    transcript: SNP-only genomes (fast step), canonical-indel genomes
    (general device step) and host-exact genomes. The SequenceVariantFilter
    remains the tested oracle; every precondition below routes to it on
    violation (kgl_mutation/kgl_mutation_variant_filter.cpp:20-262)."""
    if region_start is None:
        region_start = region.lower
    index = PopulationContigIndex.get(population, contig_id)
    n_genomes = len(index.genome_ids)
    arena = population.arena
    empty_ids = [g for g, e in zip(index.genome_ids, index.empty_mask) if e]
    L = region.upper - region.lower

    lower = max(0, region.lower - CANONICAL_MARGIN)
    lo = int(np.searchsorted(index.offset, lower, side="left"))
    hi = int(np.searchsorted(index.offset, region.upper, side="left"))
    g = index.gslot[lo:hi]
    r = index.row[lo:hi]
    o = index.offset[lo:hi]

    rlen = arena.ref_lens[r].astype(np.int64)
    alen = arena.alt_lens[r].astype(np.int64)
    is_snp = (rlen == 1) & (alen == 1)
    is_del = (alen == 1) & (rlen > 1)
    is_ins = (rlen == 1) & (alen > 1)
    canonical = is_snp | is_del | is_ins
    too_wide = is_ins & (alen - 1 > a_max)

    host_flag = np.zeros(n_genomes, dtype=bool)
    bad = ~canonical | too_wide
    if bad.any():
        host_flag[np.unique(g[bad])] = True

    # kind / sizes per incidence
    kind_i = np.where(is_del, 1, np.where(is_ins, 2, 0)).astype(np.int8)
    dsize = np.where(is_del, rlen - 1, 0)
    isize = np.where(is_ins, alen - 1, 0)

    # Region-modify check per kind (Variant::modifyInterval intersect).
    snp_mod = is_snp & (o >= region.lower) & (o < region.upper)
    del_mod = is_del & (o + 1 < region.upper) & (o + 1 + dsize > region.lower)
    ins_mod = is_ins & (o + 1 < region.upper) & (o + 1 + isize > region.lower)
    modifying = snp_mod | del_mod | ins_mod

    gm = g[modifying]
    rm = r[modifying]
    km = kind_i[modifying]
    # insert key: SNP at offset, indels at offset+1 (selection map).
    key = (o + np.where(is_snp, 0, 1))[modifying]
    order = np.lexsort((rm, key, gm))
    gs, rs, ks, kys = gm[order], rm[order], km[order], key[order]

    n = len(gs)
    first = np.ones(n, dtype=bool)
    if n > 1:
        first[1:] = (gs[1:] != gs[:-1]) | (rs[1:] != rs[:-1])
    uidx = np.nonzero(first)[0]
    counts = np.diff(np.append(uidx, n))
    ug, ur, uk, ukey = gs[uidx], rs[uidx], ks[uidx], kys[uidx]

    # conflict: two DISTINCT rows at one (genome, key) -> tie-break -> host
    if len(ug) > 1:
        conflict = (ug[1:] == ug[:-1]) & (ukey[1:] == ukey[:-1])
        if conflict.any():
            host_flag[np.unique(ug[1:][conflict])] = True

    # upstream-delete shadow interaction -> host. Shadow of a delete is
    # [key, key + dsize); any LATER variant whose member-interval lower
    # (== its key) falls inside a running shadow needs the serial filter.
    udel = arena.ref_lens[ur].astype(np.int64) - 1
    shadow_end = np.where(uk == 1, ukey + udel, np.int64(-1))
    if len(ug):
        # segmented exclusive running max per genome
        offset_base = ug.astype(np.int64) * np.int64(1 << 40)
        run = np.maximum.accumulate(shadow_end + offset_base)
        prev = np.empty_like(run)
        prev[0] = np.int64(-1)
        prev[1:] = run[:-1]
        prev_shadow = prev - offset_base
        # offset_base separates genomes by 2^40 >> any contig offset, so a
        # genome's first entry sees a hugely negative prev_shadow — the
        # running max can never leak across genomes.
        shadowed = ukey < prev_shadow
        if shadowed.any():
            host_flag[np.unique(ug[shadowed])] = True

    host_mask = host_flag & ~index.empty_mask
    host_ids = [gid for gid, h in zip(index.genome_ids, host_mask) if h]

    # which genomes carry at least one modifying indel
    has_indel = np.zeros(n_genomes, dtype=bool)
    indel_rows = uk != 0
    if indel_rows.any():
        has_indel[np.unique(ug[indel_rows])] = True

    snp_mask = ~host_flag & ~index.empty_mask & ~has_indel
    indel_mask = ~host_flag & ~index.empty_mask & has_indel

    def _pack_group(mask: np.ndarray, with_indels: bool):
        device_slots = np.nonzero(mask)[0]
        ids = [index.genome_ids[s] for s in device_slots]
        n_dev = len(device_slots)
        dslot_of = np.full(n_genomes, -1, dtype=np.int64)
        dslot_of[device_slots] = np.arange(n_dev)
        keep = dslot_of[ug] >= 0
        g2, r2, k2, key2, cnt2 = (
            ug[keep], ur[keep], uk[keep], ukey[keep], counts[keep]
        )
        d2 = dslot_of[g2]
        k_counts = np.bincount(d2, minlength=n_dev).astype(np.int32)
        # hetero stats over modifying incidences: count==1 alleles
        het = cnt2 == 1
        snp2 = k2 == 0
        hetero = np.bincount(d2[het & snp2], minlength=n_dev).astype(np.int32)
        rl2 = arena.ref_lens[r2].astype(np.int64)
        al2 = arena.alt_lens[r2].astype(np.int64)
        fs = het & ~snp2 & ((np.abs(rl2 - al2) % 3) != 0)
        frameshift = np.bincount(d2[fs], minlength=n_dev).astype(np.int32)
        # NOTE: total_interval_variants counts ALL hetero (snp + indel)
        hetero_all = np.bincount(d2[het], minlength=n_dev).astype(np.int32)
        return (device_slots, ids, d2, g2, r2, k2, key2, k_counts,
                hetero, hetero_all, frameshift, rl2, al2)

    # ---- SNP-only batch (existing fast step shapes) ----------------------
    (snp_slots, snp_ids, d2, _g2, r2, _k2, key2, k_counts, hetero, _ha, _fs,
     _rl, _al) = _pack_group(snp_mask, False)
    k_max = int(k_counts.max()) if len(k_counts) else 0
    K = k_bucket if k_bucket is not None else max(8, _next_pow2(k_max))
    B = b_bucket if b_bucket is not None else max(8, _next_pow2(len(snp_ids)))
    if k_max > K or len(snp_ids) > B:
        raise ValueError(
            f"bucket too small: need ({len(snp_ids)},{k_max}), got ({B},{K})"
        )
    positions = np.zeros((B, K), dtype=np.int32)
    alt_codes = np.zeros((B, K), dtype=np.uint8)
    validm = np.zeros((B, K), dtype=bool)
    if len(d2):
        starts = np.searchsorted(d2, np.arange(len(snp_ids)))
        rank = np.arange(len(d2)) - starts[d2]
        positions[d2, rank] = (key2 - region_start).astype(np.int32)
        alt_codes[d2, rank] = arena.alt_first[r2]
        validm[d2, rank] = True
    snp_batch = BatchCapture(
        genome_ids=snp_ids, positions=positions, alt_codes=alt_codes,
        valid=validm, k_counts=k_counts, hetero_counts=hetero,
        host_genome_ids=host_ids, empty_genome_ids=empty_ids,
    )

    # ---- indel batch ------------------------------------------------------
    if not indel_mask.any():
        return snp_batch, None
    (islots, iids, d2, _g2, r2, k2, key2, k_counts, het_snp, _het_all, fs,
     rl2, al2) = _pack_group(indel_mask, True)
    k_max = int(k_counts.max()) if len(k_counts) else 0
    K2 = max(8, _next_pow2(k_max))
    B2 = max(8, _next_pow2(len(iids)))
    pos_t = np.zeros((B2, K2), dtype=np.int32)
    kind_t = np.zeros((B2, K2), dtype=np.int8)
    dlen_t = np.zeros((B2, K2), dtype=np.int32)
    icodes_t = np.zeros((B2, K2, a_max), dtype=np.uint8)
    ilen_t = np.zeros((B2, K2), dtype=np.int32)
    alt_t = np.zeros((B2, K2), dtype=np.uint8)
    valid_t = np.zeros((B2, K2), dtype=bool)
    starts = np.searchsorted(d2, np.arange(len(iids)))
    rank = np.arange(len(d2)) - starts[d2]
    rel = (key2 - region_start).astype(np.int64)
    # deletions: clamp upstream spans into the region (host pass-2 clamps)
    dl = np.where(k2 == 1, rl2 - 1, 0)
    dl_eff = np.where(k2 == 1, np.minimum(rel + dl, L) - np.maximum(rel, 0), 0)
    pos_clamped = np.where(k2 == 1, np.maximum(rel, 0), rel)
    applied = np.ones(len(d2), dtype=bool)
    applied &= ~((k2 == 1) & (dl_eff <= 0))
    applied &= ~((k2 == 2) & ((rel < 0) | (rel > L)))  # host skips these
    pos_t[d2, rank] = pos_clamped.astype(np.int32)
    kind_t[d2, rank] = k2
    dlen_t[d2, rank] = np.maximum(dl_eff, 0).astype(np.int32)
    alt_t[d2, rank] = arena.alt_first[r2]
    valid_t[d2, rank] = applied
    # insert codes: gather ONCE per unique INS arena row (a common
    # insertion carried by N genomes costs one row lookup), then scatter
    # the padded code matrix to every carrying slot vectorized.
    ins_sel = np.nonzero(k2 == 2)[0]
    ilen2 = np.where(k2 == 2, al2 - 1, 0)
    ilen_t[d2, rank] = ilen2.astype(np.int32)
    if len(ins_sel):
        uniq_rows, inv = np.unique(r2[ins_sel], return_inverse=True)
        codes_mat = np.zeros((len(uniq_rows), a_max), dtype=np.uint8)
        for u, row in enumerate(uniq_rows.tolist()):
            codes = arena.alt_codes(int(row))[1:]
            codes_mat[u, : len(codes)] = codes
        icodes_t[d2[ins_sel], rank[ins_sel], :] = codes_mat[inv]
    edit_bound = 0
    if len(d2):
        per_g = np.bincount(
            d2,
            weights=np.where(k2 == 0, 1, np.where(k2 == 1, dl_eff, ilen2)),
            minlength=len(iids),
        )
        edit_bound = int(per_g.max())
    indel_batch = IndelBatchCapture(
        genome_ids=iids, pos=pos_t, kind=kind_t, del_len=dlen_t,
        ins_codes=icodes_t, ins_len=ilen_t, alt_code=alt_t, valid=valid_t,
        k_counts=k_counts, hetero_counts=het_snp,
        frameshift_counts=fs, edit_bound=edit_bound, a_max=a_max,
    )
    return snp_batch, indel_batch


def batch_capture_tensors(
    captures: List[GenomeCapture],
    region_start: int,
    k_bucket: Optional[int] = None,
    b_bucket: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack per-genome captures into (positions, alt_codes, valid) tensors.

    Shapes are bucketed to powers of two (K and B) so repeated transcript
    batches reuse the same compiled executable on the TPU.
    """
    n = len(captures)
    k_max = max((c.variant_count for c in captures), default=0)
    K = k_bucket if k_bucket is not None else max(8, _next_pow2(k_max))
    B = b_bucket if b_bucket is not None else max(8, _next_pow2(n))
    if k_max > K or n > B:
        raise ValueError(f"bucket too small: need ({n},{k_max}), got ({B},{K})")
    positions = np.zeros((B, K), dtype=np.int32)
    alt_codes = np.zeros((B, K), dtype=np.uint8)
    valid = np.zeros((B, K), dtype=bool)
    for i, cap in enumerate(captures):
        k = cap.variant_count
        positions[i, :k] = cap.positions - region_start
        alt_codes[i, :k] = cap.alt_codes
        valid[i, :k] = True
    return positions, alt_codes, valid


def exact_capture_reference(
    contig_db: ContigDB,
    region: OpenRightInterval,
    filter_type: SeqVariantFilterType = SeqVariantFilterType.DEFAULT_SEQ_FILTER,
    info_store=None,
) -> Tuple[np.ndarray, np.ndarray, FilteredVariantStats]:
    """Oracle capture through the full SequenceVariantFilter (test parity:
    fast_snp_capture must agree whenever it accepts a genome)."""
    filt = SequenceVariantFilter(contig_db, region, filter_type, info_store)
    pos, alts = [], []
    for insert_offset, variant in filt.variants():
        pos.append(variant.offset)
        alts.append(variant.alt.codes[0] if len(variant.alt) else 0)
    return (
        np.asarray(pos, dtype=np.int64),
        np.asarray(alts, dtype=np.uint8),
        filt.stats,
    )
