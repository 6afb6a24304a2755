"""Population variant database: population -> genome -> contig hierarchy
over the columnar arena.

Capability parity with the reference DB
(kgl_variant_db/kgl_variant_db_population.h:33-163, kgl_variant_db_genome.h,
kgl_variant_db_contig.h, kgl_variant_db_offset.h): thread-safe addVariant,
view/self filtering, deep copy, processAll, compression, unphased/canonical
transforms and reference validation — but each ContigDB is a set of
incidence *columns* (arena row, phase, format evidence) instead of nested
maps of shared_ptrs, so filters are boolean masks and device export is a
slice.

Copy of kgl_gene_tpu/variant/db.py.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.intervals import OpenRightInterval
from ..utils.logging import log
from .arena import VariantArena
from .variant import FormatData, Variant, VariantPhase

__all__ = ["ContigDB", "GenomeDB", "PopulationDB"]


_FORMAT_FIELDS = ("ref_count", "alt_count", "dp_count", "gq_value", "quality")


class ContigDB:
    """Incidence table for one genome x contig: parallel arrays of arena
    rows, phases and format evidence, kept sorted by variant offset
    (the reference's map<offset, OffsetDB> ordering)."""

    def __init__(self, contig_id: str, arena: VariantArena):
        self.contig_id = contig_id
        self.arena = arena
        self._builder_rows: List[int] = []
        self._builder_phase: List[int] = []
        self._builder_fmt: List[Tuple[int, int, int, float, float]] = []
        self._builder_pass: List[bool] = []
        self._blocks: List[dict] = []  # bulk column blocks (native ingest)
        self._cols: Optional[dict] = None

    # --- ingest -----------------------------------------------------------
    def add_incidence(self, row: int, phase: VariantPhase, fmt: FormatData,
                      pass_filter: bool = True) -> None:
        self._builder_rows.append(row)
        self._builder_phase.append(int(phase))
        self._builder_fmt.append(
            (fmt.ref_count, fmt.alt_count, fmt.dp_count, fmt.gq_value, fmt.quality)
        )
        self._builder_pass.append(pass_filter)
        self._cols = None

    def add_incidence_block(
        self,
        rows: np.ndarray,
        phase: np.ndarray,
        ref_count: np.ndarray,
        alt_count: np.ndarray,
        dp_count: np.ndarray,
        gq_value: np.ndarray,
        quality: np.ndarray,
        pass_filter: np.ndarray,
    ) -> None:
        """Bulk append a column block of incidences (no per-element Python
        work — the landing path for the native end-to-end VCF parser)."""
        n = len(rows)
        if n == 0:
            return
        # Integer/float count columns keep their incoming width (the native
        # parser lands int32 — forcing int64 copied every column; consumers
        # are dtype-agnostic, and arena rows always fit int32).
        self._blocks.append({
            "row": np.asarray(rows),
            "phase": np.asarray(phase, dtype=np.uint8),
            "ref_count": np.asarray(ref_count),
            "alt_count": np.asarray(alt_count),
            "dp_count": np.asarray(dp_count),
            "gq_value": np.asarray(gq_value, dtype=np.float32),
            "quality": np.asarray(quality, dtype=np.float32),
            "pass": np.asarray(pass_filter, dtype=bool),
        })
        self._cols = None

    def _flush_builder(self) -> Optional[dict]:
        """Convert the per-element builder lists to a column block."""
        if not self._builder_rows:
            return None
        rows = np.asarray(self._builder_rows, dtype=np.int64)
        fmt = np.asarray(self._builder_fmt, dtype=np.float64).reshape(-1, 5)
        return {
            "row": rows,
            "phase": np.asarray(self._builder_phase, dtype=np.uint8),
            "ref_count": fmt[:, 0].astype(np.int64),
            "alt_count": fmt[:, 1].astype(np.int64),
            "dp_count": fmt[:, 2].astype(np.int64),
            "gq_value": fmt[:, 3].astype(np.float32),
            "quality": fmt[:, 4].astype(np.float32),
            "pass": np.asarray(self._builder_pass, dtype=bool),
        }

    # --- columns ----------------------------------------------------------
    def columns(self) -> dict:
        if self._cols is None:
            blocks = list(self._blocks)
            built = self._flush_builder()
            if built is not None:
                blocks.append(built)
            if not blocks:
                rows = np.empty(0, dtype=np.int64)
                merged = {
                    "row": rows,
                    "phase": np.empty(0, dtype=np.uint8),
                    "ref_count": np.empty(0, dtype=np.int64),
                    "alt_count": np.empty(0, dtype=np.int64),
                    "dp_count": np.empty(0, dtype=np.int64),
                    "gq_value": np.empty(0, dtype=np.float32),
                    "quality": np.empty(0, dtype=np.float32),
                    "pass": np.empty(0, dtype=bool),
                }
            elif len(blocks) == 1:
                merged = dict(blocks[0])
            else:
                merged = {
                    k: np.concatenate([b[k] for b in blocks])
                    for k in blocks[0]
                }
            rows = merged["row"]
            offsets = self.arena.offsets[rows] if len(rows) else np.empty(0, dtype=np.int64)
            order = np.argsort(offsets, kind="stable")
            merged["offset"] = offsets
            self._cols = {k: v[order] for k, v in merged.items()}
        return self._cols

    def _from_columns(self, cols: dict) -> "ContigDB":
        out = ContigDB(self.contig_id, self.arena)
        out._cols = cols
        out._blocks = [{k: v for k, v in cols.items() if k != "offset"}]
        return out

    def select(self, mask_or_index: np.ndarray) -> "ContigDB":
        """New ContigDB restricted to a boolean mask / index array."""
        cols = self.columns()
        sel = {k: v[mask_or_index] for k, v in cols.items()}
        return self._from_columns(sel)

    # --- queries ----------------------------------------------------------
    def incidence_rows(self) -> np.ndarray:
        """Arena rows of all incidences WITHOUT materialising the sorted
        column set (cheap path for population-level capture indexing).
        Order is arbitrary; callers sort globally."""
        if self._cols is not None:
            return self._cols["row"]
        parts = [b["row"] for b in self._blocks]
        if self._builder_rows:
            parts.append(np.asarray(self._builder_rows, dtype=np.int64))
        if not parts:
            return np.empty(0, dtype=np.int64)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def variant_count(self) -> int:
        return len(self._builder_rows) + sum(len(b["row"]) for b in self._blocks)

    def __len__(self) -> int:
        return self.variant_count()

    def _variant_at(self, i: int) -> Variant:
        cols = self.columns()
        fmt = FormatData(
            ref_count=int(cols["ref_count"][i]),
            alt_count=int(cols["alt_count"][i]),
            dp_count=int(cols["dp_count"][i]),
            gq_value=float(cols["gq_value"][i]),
            quality=float(cols["quality"][i]),
        )
        return self.arena.make_variant(
            int(cols["row"][i]), VariantPhase(int(cols["phase"][i])), fmt,
            bool(cols["pass"][i]),
        )

    def __iter__(self) -> Iterator[Variant]:
        for i in range(self.variant_count()):
            yield self._variant_at(i)

    def find_at_offset(self, offset: int) -> List[Variant]:
        """All variants at an offset (the OffsetDB of the reference)."""
        cols = self.columns()
        lo = np.searchsorted(cols["offset"], offset, side="left")
        hi = np.searchsorted(cols["offset"], offset, side="right")
        return [self._variant_at(i) for i in range(lo, hi)]

    def offset_groups(self) -> Iterator[Tuple[int, List[Variant]]]:
        """Iterate (offset, [variants]) groups in offset order."""
        cols = self.columns()
        offsets = cols["offset"]
        i = 0
        n = len(offsets)
        while i < n:
            j = i
            while j < n and offsets[j] == offsets[i]:
                j += 1
            yield int(offsets[i]), [self._variant_at(k) for k in range(i, j)]
            i = j

    def region_variants(self, interval: OpenRightInterval) -> "ContigDB":
        """Sub-view of incidences whose offset lies in [lower, upper)."""
        cols = self.columns()
        lo = np.searchsorted(cols["offset"], interval.lower, side="left")
        hi = np.searchsorted(cols["offset"], interval.upper, side="left")
        return self.select(np.arange(lo, hi))

    # --- transforms -------------------------------------------------------
    def canonical(self) -> "ContigDB":
        """Re-intern every incidence as its canonical allele
        (PopulationDB::canonicalPopulation)."""
        out = ContigDB(self.contig_id, self.arena)
        for variant in self:
            canon = variant.clone_canonical()
            row = self.arena.intern(
                canon.contig_id, canon.offset, canon.ref.codes, canon.alt.codes,
                canon.identifier, canon.info_index,
            )
            out.add_incidence(row, canon.phase, canon.format_data, canon.pass_filter)
        return out

    def unique_unphased(self) -> "ContigDB":
        """Distinct alleles ignoring phase; phase forced to UNPHASED
        (PopulationDB::uniqueUnphased semantics)."""
        cols = self.columns()
        _, first = np.unique(cols["row"], return_index=True)
        sel = self.select(np.sort(first))
        sel_cols = sel.columns()
        sel_cols["phase"] = np.full_like(sel_cols["phase"], int(VariantPhase.UNPHASED))
        return sel._from_columns(sel_cols)

    def validate(self, contig_ref) -> Tuple[int, int]:
        """Check each variant's ref bases match the reference contig
        (PopulationDB::validate, kgl_variant_db_population.h:113)."""
        total = failed = 0
        seq = contig_ref.sequence.codes
        cols = self.columns()
        for i in range(len(cols["row"])):
            row = int(cols["row"][i])
            off = int(cols["offset"][i])
            ref = self.arena.ref_codes(row)
            total += 1
            if off + len(ref) > len(seq) or not np.array_equal(seq[off : off + len(ref)], ref):
                failed += 1
        return total, failed


class GenomeDB:
    """One sample genome: map contig -> ContigDB (kgl_variant_db_genome.h:24)."""

    def __init__(self, genome_id: str, arena: VariantArena):
        self.genome_id = genome_id
        self.arena = arena
        self.contig_map: Dict[str, ContigDB] = {}

    def get_create_contig(self, contig_id: str) -> ContigDB:
        db = self.contig_map.get(contig_id)
        if db is None:
            db = ContigDB(contig_id, self.arena)
            self.contig_map[contig_id] = db
        return db

    def get_contig(self, contig_id: str) -> Optional[ContigDB]:
        return self.contig_map.get(contig_id)

    def variant_count(self) -> int:
        return sum(c.variant_count() for c in self.contig_map.values())

    def __iter__(self) -> Iterator[Tuple[str, ContigDB]]:
        return iter(sorted(self.contig_map.items()))

    def process_all(self, fn: Callable[[Variant], bool]) -> bool:
        for _, contig in self:
            for variant in contig:
                if not fn(variant):
                    return False
        return True

    def _map_contigs(self, fn: Callable[[ContigDB], ContigDB]) -> "GenomeDB":
        out = GenomeDB(self.genome_id, self.arena)
        for cid, contig in self.contig_map.items():
            out.contig_map[cid] = fn(contig)
        return out


class PopulationDB:
    """The population root: map genome -> GenomeDB + the shared arena
    (kgl_variant_db_population.h:33-163)."""

    def __init__(self, population_id: str, data_source: str = "",
                 arena: Optional[VariantArena] = None):
        self.population_id = population_id
        self.data_source = data_source
        self.arena = arena or VariantArena()
        self.genome_map: Dict[str, GenomeDB] = {}
        self._lock = threading.Lock()

    # --- ingest -----------------------------------------------------------
    def get_create_genome(self, genome_id: str) -> GenomeDB:
        with self._lock:
            g = self.genome_map.get(genome_id)
            if g is None:
                g = GenomeDB(genome_id, self.arena)
                self.genome_map[genome_id] = g
            return g

    def add_variant(self, variant: Variant, genomes: Sequence[str]) -> bool:
        """Add a variant to the listed genomes (thread-safe; mirrors
        PopulationDB::addVariant, kgl_variant_db_population.h:106)."""
        row = self.arena.intern(
            variant.contig_id, variant.offset, variant.ref.codes, variant.alt.codes,
            variant.identifier, variant.info_index,
        )
        for genome_id in genomes:
            genome = self.get_create_genome(genome_id)
            contig = genome.get_create_contig(variant.contig_id)
            contig.add_incidence(row, variant.phase, variant.format_data, variant.pass_filter)
        return True

    # --- stats ------------------------------------------------------------
    def genome_count(self) -> int:
        return len(self.genome_map)

    def variant_count(self) -> int:
        return sum(g.variant_count() for g in self.genome_map.values())

    def get_genome(self, genome_id: str) -> Optional[GenomeDB]:
        return self.genome_map.get(genome_id)

    def __iter__(self) -> Iterator[Tuple[str, GenomeDB]]:
        return iter(sorted(self.genome_map.items()))

    # --- functional transforms -------------------------------------------
    def process_all(self, fn: Callable[[Variant], bool]) -> bool:
        """Apply fn to every variant (processAll/processAll_MT; in the TPU
        build per-genome fan-out is done by batching into arrays instead of
        a thread pool, so this stays sequential on the host)."""
        for _, genome in self:
            if not genome.process_all(fn):
                return False
        return True

    def _map_contigs(self, fn: Callable[[ContigDB], ContigDB],
                     suffix: str) -> "PopulationDB":
        out = PopulationDB(self.population_id + suffix, self.data_source, self.arena)
        for gid, genome in self.genome_map.items():
            out.genome_map[gid] = genome._map_contigs(fn)
        return out

    def view_filter(self, filter_obj) -> "PopulationDB":
        """Shallow filtered view (viewFilter); filters are mask predicates
        (variant/filter.py)."""
        return filter_obj.apply_population(self)

    def self_filter(self, filter_obj) -> "PopulationDB":
        """In-place-style filter: returns the filtered population and
        rebinds this object's genome map (selfFilter semantics)."""
        filtered = self.view_filter(filter_obj)
        self.genome_map = filtered.genome_map
        return self

    def deep_copy(self) -> "PopulationDB":
        return self._map_contigs(lambda c: c.select(np.arange(c.variant_count())), "")

    def canonical_population(self) -> "PopulationDB":
        return self._map_contigs(lambda c: c.canonical(), "_canonical")

    def unique_unphased(self) -> "PopulationDB":
        return self._map_contigs(lambda c: c.unique_unphased(), "_unique")

    def compress_population(self) -> "PopulationDB":
        """Merge all genomes into a single-genome population of unique
        unphased variants (compressPopulation)."""
        out = PopulationDB(self.population_id + "_compress", self.data_source, self.arena)
        merged = out.get_create_genome("Compressed")
        seen = set()
        for _, genome in self:
            for cid, contig in genome:
                target = merged.get_create_contig(cid)
                cols = contig.columns()
                for i, row in enumerate(cols["row"]):
                    if int(row) not in seen:
                        seen.add(int(row))
                        target.add_incidence(
                            int(row), VariantPhase.UNPHASED,
                            FormatData(
                                int(cols["ref_count"][i]), int(cols["alt_count"][i]),
                                int(cols["dp_count"][i]), float(cols["gq_value"][i]),
                                float(cols["quality"][i]),
                            ),
                            bool(cols["pass"][i]),
                        )
        return out

    def square_contigs(self) -> int:
        """Ensure every genome holds every contig present anywhere in the
        population (empty ContigDBs created as needed); returns the contig
        count (PopulationDB::squareContigs,
        kgl_variant_db_population.h:100, .cpp:258-295)."""
        contig_set = set()
        for _, genome in self.genome_map.items():
            contig_set.update(genome.contig_map)
        for _, genome in self.genome_map.items():
            for contig_id in contig_set:
                genome.get_create_contig(contig_id)
        return len(contig_set)

    def validate(self, genome_reference) -> Tuple[int, int]:
        """Validate every variant's ref sequence against the reference
        genome; returns (total, failed)."""
        total = failed = 0
        for _, genome in self:
            for cid, contig in genome:
                contig_ref = genome_reference.get_contig(cid)
                if contig_ref is None:
                    log().warn("validate: contig {} not in reference genome", cid)
                    failed += contig.variant_count()
                    total += contig.variant_count()
                    continue
                t, f = contig.validate(contig_ref)
                total += t
                failed += f
        if failed:
            log().warn("population {}: {} of {} variants failed reference validation",
                       self.population_id, failed, total)
        return total, failed

    def merge_population(self, other: "PopulationDB") -> None:
        """Merge another population's incidences into this one (shared
        arena required)."""
        if other.arena is not self.arena:
            for _, genome in other:
                for cid, contig in genome:
                    for variant in contig:
                        self.add_variant(variant, [genome.genome_id])
            return
        for gid, genome in other.genome_map.items():
            mine = self.get_create_genome(gid)
            for cid, contig in genome.contig_map.items():
                target = mine.get_create_contig(cid)
                cols = contig.columns()
                for i in range(len(cols["row"])):
                    target.add_incidence(
                        int(cols["row"][i]), VariantPhase(int(cols["phase"][i])),
                        FormatData(
                            int(cols["ref_count"][i]), int(cols["alt_count"][i]),
                            int(cols["dp_count"][i]), float(cols["gq_value"][i]),
                            float(cols["quality"][i]),
                        ),
                        bool(cols["pass"][i]),
                    )

    def __repr__(self):
        return (
            f"PopulationDB({self.population_id}, {self.genome_count()} genomes, "
            f"{self.variant_count()} incidences, {len(self.arena)} unique alleles)"
        )
