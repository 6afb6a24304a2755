"""Variant sorting / indexing: gene and identifier lookup maps.

Capability parity with VariantSort
(kgl_variant_analysis/kgl_variant_sort.h:40-72): build Ensembl-gene ->
variants, variantId (rsid) -> variants and genome x id maps. The reference
offers an MT variant (thread pool over genomes); here index construction
is a single vectorized pass over the columnar arena + incidence arrays.

Copy of kgl_gene_tpu/variant/sort.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from ..utils.logging import log
from .columnar import VariantMajorView
from .db import PopulationDB

__all__ = ["VariantSort"]


class VariantSort:
    @staticmethod
    def variant_id_index(population: PopulationDB) -> Dict[str, List[int]]:
        """identifier (e.g. rsid) -> arena rows."""
        arena = population.arena
        out: Dict[str, List[int]] = {}
        for row in range(len(arena)):
            ident = arena.identifier(row)
            if ident:
                out.setdefault(ident, []).append(row)
        return out

    @staticmethod
    def genome_variant_id_index(population: PopulationDB) -> Dict[str, Dict[str, List[int]]]:
        """genome -> identifier -> arena rows (variantGenomeIndexMT
        analogue, single vectorized pass)."""
        arena = population.arena
        out: Dict[str, Dict[str, List[int]]] = {}
        for genome_id, genome in population:
            genome_index: Dict[str, List[int]] = {}
            for _, contig in genome:
                for row in contig.columns()["row"]:
                    ident = arena.identifier(int(row))
                    if ident:
                        genome_index.setdefault(ident, []).append(int(row))
            out[genome_id] = genome_index
        return out

    @staticmethod
    def gene_variant_index(population: PopulationDB, genome_reference,
                           use_span: bool = True) -> Dict[str, List[int]]:
        """gene id -> arena rows whose offset falls in the gene interval
        (ensemblIndex analogue, vectorized searchsorted per contig)."""
        view = VariantMajorView(population)
        arena = population.arena
        out: Dict[str, List[int]] = {}
        for contig_idx, contig_name in enumerate(arena.contig_names):
            contig_ref = genome_reference.get_contig(contig_name)
            if contig_ref is None:
                continue
            mask = view.contig_index == contig_idx
            offsets = view.offsets[mask]
            rows = view.rows[mask]
            if len(offsets) == 0:
                continue
            for gene in contig_ref.all_genes():
                lo = np.searchsorted(offsets, gene.interval.lower, side="left")
                hi = np.searchsorted(offsets, gene.interval.upper, side="left")
                if hi > lo:
                    out.setdefault(gene.feature_id, []).extend(
                        int(r) for r in rows[lo:hi]
                    )
        return out
