"""Variant-major columnar view: the device-ready transposed population.

Capability parity with VariantDBVariant / AlleleSummmary
(kgl_variant_db/kgl_variant_db_variant.h:26-83): variant index x genome
zygosity codes {0 = absent, 1 = heterozygous, 2 = homozygous} plus
per-variant and per-genome allele summaries. In the TPU build this *is* the
compute format: the zygosity matrix ships to the device once and every
population statistic (AF, het/hom, FWS, inbreeding) is a batched reduction
over it (vmap/shard_map instead of the reference's per-genome thread pool).

Copy of kgl_gene_tpu/variant/columnar.py. VariantMajorCSR builds through
the native library (native/: mark_presence, csr_build), which raises when
it cannot be built; presence_plain and csr_triples_plain are the numpy
plain versions the native functions are held against, and csr_triples_plain
also builds a key space too wide for the native build's int32 ranks.

The port adds the resident form of a population (VariantMajorCSR.
device_codes): its (V, G) uint8 codes put on a device once, variant-major,
a block of variants at a time, with each row starting ROW_ALIGN bytes
after the last (resident_codes), so a kernel can read a row in 16-byte
loads. The analyses that keep a population on the device (INBREED, the
PfEMP statistics) build it there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .db import PopulationDB

__all__ = ["AlleleSummary", "BLOCK_VARIANTS", "ROW_ALIGN", "VariantMajorView", "VariantMajorCSR",
           "csr_triples_plain", "presence_plain", "resident_codes"]

# Variants densified and uploaded at a time when codes go to a device.
BLOCK_VARIANTS = 1 << 16
# Bytes between the starts of two rows of resident codes are a multiple of this.
ROW_ALIGN = 16


def resident_codes(variants: int, genomes: int, device, rows=None,
                   block_variants: int = BLOCK_VARIANTS) -> torch.Tensor:
    """A (variants, genomes) uint8 tensor on `device` whose rows start
    ROW_ALIGN bytes apart at least: a view of the first `genomes` columns
    of a buffer whose rows are padded to that multiple. Zeros, or filled
    block_variants rows at a time from rows(v_lo, v_hi), a (v_hi - v_lo,
    genomes) uint8 array or tensor, so that no more than a block is ever
    held off the device."""
    width = -(-max(genomes, 1) // ROW_ALIGN) * ROW_ALIGN
    codes = torch.zeros((variants, width), dtype=torch.uint8, device=device)[:, :genomes]
    if rows is not None:
        for v_lo in range(0, variants, block_variants):
            v_hi = min(v_lo + block_variants, variants)
            codes[v_lo:v_hi] = torch.as_tensor(rows(v_lo, v_hi)).to(device)
    return codes


@dataclass
class AlleleSummary:
    """Het/hom counts (AlleleSummmary in the reference — including its
    spelling's meaning, not its spelling)."""

    heterozygous: int = 0
    homozygous: int = 0

    def __iadd__(self, other: "AlleleSummary"):
        self.heterozygous += other.heterozygous
        self.homozygous += other.homozygous
        return self

    @property
    def total(self) -> int:
        return self.heterozygous + self.homozygous


def _collect_incidences(
    population: PopulationDB,
) -> Tuple[List[str], np.ndarray, np.ndarray, np.ndarray]:
    """Flatten a population to incidence arrays, fully vectorized.

    Returns (genome_ids, g_idx, v_idx, rows): per-incidence genome index,
    per-incidence variant index (into `rows`), and the distinct arena rows
    sorted by (contig, offset) — the canonical variant ordering of the
    reference's VariantDBVariant transpose (kgl_variant_db_variant.h:26).
    """
    genome_ids = sorted(population.genome_map)
    arena = population.arena
    part_gidx: List[int] = []
    part_len: List[int] = []
    r_parts: List[np.ndarray] = []
    for gidx, gid in enumerate(genome_ids):
        for _, contig in population.genome_map[gid].contig_map.items():
            # raw row blocks: no per-genome sorted-column materialisation
            # (order is irrelevant — everything re-sorts globally below)
            rows = contig.incidence_rows()
            if len(rows):
                r_parts.append(rows)
                part_gidx.append(gidx)
                part_len.append(len(rows))
    if not r_parts:
        return genome_ids, np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64)
    # one repeat instead of a full-width per-part genome column; int32
    # everywhere (2 vCPUs at population scale: every 10^8-wide pass counts)
    g_all = np.repeat(
        np.asarray(part_gidx, dtype=np.int32), np.asarray(part_len)
    )
    rows_all = np.concatenate(r_parts)
    # Distinct rows via a presence bitmap over the arena (O(n) scatter +
    # O(arena) scan — the generic np.unique sort over ~10^8 incidences
    # dominated population-scale stats), then permute into the
    # (contig, offset) presentation order and map incidences through a
    # rank-per-arena-row gather.
    present = np.zeros(len(arena), dtype=bool)
    present[rows_all] = True
    sorted_rows = np.nonzero(present)[0]
    order = np.lexsort((arena.offsets[sorted_rows], arena.contigs[sorted_rows]))
    rows = sorted_rows[order]
    rank_of_row = np.empty(len(arena), dtype=np.int32)
    rank_of_row[rows] = np.arange(len(rows), dtype=np.int32)
    return genome_ids, g_all, rank_of_row[rows_all], rows


def presence_plain(parts, arena_len: int) -> np.ndarray:
    """Presence bitmap over arena rows (bool (arena_len,)): the numpy plain
    version of native.mark_presence."""
    present = np.zeros(arena_len, dtype=bool)
    for _gidx, rows in parts:
        present[rows] = True
    return present


def csr_triples_plain(parts, rank_of_row: np.ndarray, n_g: int, key_max: int,
                      total: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(values, variant_of, genome_of) of the (variant, genome) pairs of
    `parts`, sorted by key = rank * n_g + genome, the pair multiplicity
    clamped to 2: the numpy stable-radix form of native.csr_build."""
    key_dtype = np.int32 if key_max < 2**31 else np.int64
    key = np.empty(total, dtype=key_dtype)
    off = 0
    for gidx, rp in parts:
        k = key[off : off + len(rp)]
        np.take(rank_of_row.astype(key_dtype, copy=False), rp, out=k)
        k *= key_dtype(n_g)
        k += key_dtype(gidx)
        off += len(rp)
    key = np.sort(key, kind="stable")
    if len(key):
        first = np.empty(len(key), dtype=bool)
        first[0] = True
        np.not_equal(key[1:], key[:-1], out=first[1:])
        starts = np.nonzero(first)[0]
        counts = np.empty(len(starts), dtype=np.int64)
        np.subtract(starts[1:], starts[:-1], out=counts[:-1])
        counts[-1] = len(key) - starts[-1]
        uniq = key[starts]  # native (int32 when the key space fits)
    else:
        uniq = np.empty(0, np.int64)
        counts = np.empty(0, np.int64)
    # divmod in the key's own width: int64 division over 10^8
    # keys costs whole seconds more than int32
    variant_of, genome_of = np.divmod(uniq, uniq.dtype.type(n_g))
    return np.minimum(counts, 2).astype(np.uint8), variant_of, genome_of


class VariantMajorView:
    """Transpose a PopulationDB into variant-major arrays.

    The build is a flat-index bincount over all incidences — no per-variant
    Python work — so gnomAD-scale views (10^6+ incidences) build in
    milliseconds. For G x V too large to densify use VariantMajorCSR.
    """

    def __init__(self, population: PopulationDB):
        self.population = population
        arena = population.arena
        self.genome_ids, g_all, v_all, self.rows = _collect_incidences(population)

        # Zygosity: incidence count per (genome, variant), clamped to 2
        # (hom 1/1 genotypes contribute TWO incidences).
        n_g, n_v = len(self.genome_ids), len(self.rows)
        counts = np.bincount(g_all * max(n_v, 1) + v_all, minlength=n_g * n_v)
        self.zygosity = np.minimum(counts, 2).astype(np.uint8).reshape(n_g, n_v)

        # Variant coordinate columns (device-ready).
        self.contig_index = arena.contigs[self.rows]
        self.offsets = arena.offsets[self.rows]
        self._hgvs: Optional[List[str]] = None

    @property
    def hgvs(self) -> List[str]:
        """HGVS strings per variant (lazy: only report paths need them)."""
        if self._hgvs is None:
            arena = self.population.arena
            self._hgvs = [arena.hgvs(int(r)) for r in self.rows]
        return self._hgvs

    # ------------------------------------------------------------------ #
    @property
    def genome_count(self) -> int:
        return len(self.genome_ids)

    @property
    def variant_count(self) -> int:
        return len(self.rows)

    # --- summaries (summaryByVariant / summaryByGenome) -------------------
    def summary_by_variant(self, index: int) -> AlleleSummary:
        col = self.zygosity[:, index]
        return AlleleSummary(
            heterozygous=int(np.sum(col == 1)), homozygous=int(np.sum(col == 2))
        )

    def summary_by_genome(self, genome_id: str) -> AlleleSummary:
        row = self.zygosity[self.genome_ids.index(genome_id)]
        return AlleleSummary(
            heterozygous=int(np.sum(row == 1)), homozygous=int(np.sum(row == 2))
        )

    # --- bulk columns ------------------------------------------------------
    def het_hom_by_variant(self) -> Tuple[np.ndarray, np.ndarray]:
        return (
            np.sum(self.zygosity == 1, axis=0),
            np.sum(self.zygosity == 2, axis=0),
        )

    def het_hom_by_genome(self) -> Tuple[np.ndarray, np.ndarray]:
        return (
            np.sum(self.zygosity == 1, axis=1),
            np.sum(self.zygosity == 2, axis=1),
        )

    def alt_allele_counts(self) -> np.ndarray:
        """AC per variant (het counts 1, hom counts 2)."""
        return np.sum(self.zygosity, axis=0, dtype=np.int64)

    def allele_number(self) -> int:
        """AN: two allele draws per diploid genome."""
        return 2 * self.genome_count

    def allele_frequencies(self) -> np.ndarray:
        """AF per variant from the population itself."""
        an = self.allele_number()
        return self.alt_allele_counts() / an if an else np.zeros(self.variant_count)


class VariantMajorCSR:
    """Sparse variant-major view: CSR over variants (rows) x genomes (cols).

    For populations where the dense G x V zygosity matrix does not fit
    (gnomAD scale: 10^7-10^8 variants x thousands of samples). Carries the
    same summaries as VariantMajorView plus a chunked dense exporter that
    ships device-ready blocks of variants.
    """

    def __init__(self, population: PopulationDB):
        self.population = population
        arena = population.arena
        genome_ids = sorted(population.genome_map)
        self.genome_ids = genome_ids
        n_g = max(len(genome_ids), 1)

        # Per-(genome, contig) incidence blocks, visited TWICE: once for
        # the presence bitmap (distinct variants), once writing sort keys
        # straight into one preallocated array — no concatenated
        # rows/genome columns ever materialise (at 10^8 incidences on few
        # cores every full-width temporary costs seconds).
        parts = []
        total = 0
        for gidx, gid in enumerate(genome_ids):
            for contig in population.genome_map[gid].contig_map.values():
                rows = contig.incidence_rows()
                if len(rows):
                    # one int32 conversion shared by both native passes
                    parts.append((gidx, np.ascontiguousarray(rows, np.int32)))
                    total += len(rows)
        from ..native import csr_build, mark_presence

        present = mark_presence(parts, len(arena))
        sorted_rows = np.nonzero(present)[0]
        order = np.lexsort(
            (arena.offsets[sorted_rows], arena.contigs[sorted_rows])
        )
        self.rows = sorted_rows[order]
        n_v = len(self.rows)
        self.genome_count = len(genome_ids)
        self.variant_count = n_v

        # Dedup (variant, genome) pairs; the pair multiplicity (clamped to
        # 2) is the zygosity code: the native threaded key-write + LSD
        # radix sort + run-length dedup (native/kgt_native.cpp
        # kgt_csr_build; the reference builds its transposed view threaded,
        # kgl_variant_db_variant.h:26-83), whose ranks are int32. A wider
        # variant space takes the numpy stable-radix form.
        key_max = n_v * n_g
        rank_dtype = np.int32 if n_v < 2**31 else np.int64
        rank_of_row = np.empty(len(arena), dtype=rank_dtype)
        rank_of_row[self.rows] = np.arange(n_v, dtype=rank_dtype)
        if rank_dtype == np.int32:
            # int32 columns (nnz-sized): widening to int64 would copy
            # ~700 MB at gnomAD scale for nothing.
            self.values, self.variant_of, self.genome_of = csr_build(
                parts, rank_of_row, n_g, key_max, total)
        else:
            self.values, self.variant_of, self.genome_of = csr_triples_plain(
                parts, rank_of_row, n_g, key_max, total)
        del parts
        # variant_of is sorted: indptr from a bincount + cumsum (sequential
        # passes) instead of 10^6 binary searches over 10^8 keys (cache
        # misses made searchsorted the single slowest build step)
        self.indptr = np.zeros(n_v + 1, dtype=np.int64)
        np.cumsum(
            np.bincount(self.variant_of, minlength=n_v), out=self.indptr[1:]
        )

        self.contig_index = arena.contigs[self.rows] if n_v else np.empty(0, np.int32)
        self.offsets = arena.offsets[self.rows] if n_v else np.empty(0, np.int64)

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    # --- summaries ---------------------------------------------------------
    def summary_by_variant(self, index: int) -> AlleleSummary:
        lo, hi = self.indptr[index], self.indptr[index + 1]
        vals = self.values[lo:hi]
        return AlleleSummary(
            heterozygous=int(np.sum(vals == 1)), homozygous=int(np.sum(vals == 2))
        )

    def summary_by_genome(self, genome_id: str) -> AlleleSummary:
        g = self.genome_ids.index(genome_id)
        vals = self.values[self.genome_of == g]
        return AlleleSummary(
            heterozygous=int(np.sum(vals == 1)), homozygous=int(np.sum(vals == 2))
        )

    def het_hom_by_variant(self) -> Tuple[np.ndarray, np.ndarray]:
        het = np.bincount(self.variant_of[self.values == 1], minlength=self.variant_count)
        hom = np.bincount(self.variant_of[self.values == 2], minlength=self.variant_count)
        return het, hom

    def het_hom_by_genome(self) -> Tuple[np.ndarray, np.ndarray]:
        het = np.bincount(self.genome_of[self.values == 1], minlength=self.genome_count)
        hom = np.bincount(self.genome_of[self.values == 2], minlength=self.genome_count)
        return het, hom

    def alt_allele_counts(self) -> np.ndarray:
        # zygosity values are {1, 2}: AC = one count for every incidence
        # plus one extra for homozygotes. Two integer bincounts beat the
        # weights= form, which promotes 10^8 uint8 values to float64.
        ac = np.bincount(self.variant_of, minlength=self.variant_count)
        ac += np.bincount(
            self.variant_of[self.values == 2], minlength=self.variant_count
        )
        return ac.astype(np.int64, copy=False)

    def allele_number(self) -> int:
        return 2 * self.genome_count

    def allele_frequencies(self) -> np.ndarray:
        an = self.allele_number()
        return self.alt_allele_counts() / an if an else np.zeros(self.variant_count)

    # --- chunked device export ---------------------------------------------
    def dense_block(self, v_lo: int, v_hi: int) -> np.ndarray:
        """Densify variants [v_lo, v_hi) -> (G, v_hi-v_lo) zygosity block."""
        lo, hi = self.indptr[v_lo], self.indptr[v_hi]
        block = np.zeros((self.genome_count, v_hi - v_lo), dtype=np.uint8)
        block[self.genome_of[lo:hi], self.variant_of[lo:hi] - v_lo] = self.values[lo:hi]
        return block

    def dense_block_t(self, v_lo: int, v_hi: int) -> np.ndarray:
        """Transposed densify: variants [v_lo, v_hi) -> (v_hi-v_lo, G)
        zygosity block. The CSR is variant-sorted, so the scatter writes
        near-sequential rows — at 10^8 incidences the (G, V) layout's
        column-sweep scatter is all cache/TLB misses (tens of seconds),
        while this orientation streams."""
        lo, hi = self.indptr[v_lo], self.indptr[v_hi]
        block = np.zeros((v_hi - v_lo, self.genome_count), dtype=np.uint8)
        block[self.variant_of[lo:hi] - v_lo, self.genome_of[lo:hi]] = self.values[lo:hi]
        return block

    def device_codes(self, device, block_variants: int = BLOCK_VARIANTS) -> torch.Tensor:
        """The (V, G) uint8 codes on `device` (resident_codes' layout),
        densified and uploaded block_variants rows at a time: no G x V
        array on the host."""
        return resident_codes(self.variant_count, self.genome_count, device,
                              self.dense_block_t, block_variants)

    def iter_dense_blocks(self, block_variants: int = 4096):
        """Yield (v_lo, block) dense chunks sized for device shipping."""
        for v_lo in range(0, self.variant_count, block_variants):
            v_hi = min(v_lo + block_variants, self.variant_count)
            yield v_lo, self.dense_block(v_lo, v_hi)
