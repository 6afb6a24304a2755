"""Ontology database resource: graph + annotation packaged for the app.

Capability parity with OntologyDatabase
(kol_ontology/kgl_ontology/kgl_ontology_database.h:29) and the malaria
gene-set cache (kgl_gene_cache_ontology.h:30): loads go.obo + GAF into the
GoGraph/TermAnnotation pair, builds IC and similarity caches on demand,
and exposes gene-level similarity matrices. Includes the load-time
self-test (kgl_ontology_database_test.h analogue).

Copy of kgl_gene_tpu/ontology/database.py.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..utils.logging import log
from .annotation import TermAnnotation
from .cache import TermSimilarityCache
from .graph import GoGraph
from .information import InformationContent
from .obo import parse_go_file
from .similarity import (
    SimilarityJiangConrath,
    SimilarityLin,
    SimilarityRelevance,
    SimilarityResnik,
)

__all__ = ["OntologyDatabase"]

_MEASURES = {
    "Resnik": SimilarityResnik,
    "Lin": SimilarityLin,
    "JiangConrath": SimilarityJiangConrath,
    "Relevance": SimilarityRelevance,
}


class OntologyDatabase:
    def __init__(self, ontology_ident: str, go_obo_file: str, gaf_file: str):
        """go_obo_file may be OBO, OBO-XML or OboGraphs JSON; the factory
        dispatches on the extension (kol_ParserGoFactory parity)."""
        self.ontology_ident = ontology_ident
        records = parse_go_file(go_obo_file)
        self.go_graph = GoGraph(records)
        self.annotation = TermAnnotation.from_gaf_file(gaf_file, graph=self.go_graph)
        self._information: Optional[InformationContent] = None
        self._caches: Dict[tuple, TermSimilarityCache] = {}
        log().info(
            "OntologyDatabase {}: {} terms, {} annotated genes",
            ontology_ident, len(self.go_graph), len(self.annotation.all_genes()),
        )

    @property
    def information(self) -> InformationContent:
        if self._information is None:
            self._information = InformationContent(self.go_graph, self.annotation)
        return self._information

    def similarity(self, measure: str = "Lin"):
        return _MEASURES[measure](self.information)

    def similarity_cache(self, namespace: str, measure: str = "Lin") -> TermSimilarityCache:
        key = (namespace, measure)
        if key not in self._caches:
            self._caches[key] = TermSimilarityCache(
                self.similarity(measure), self.annotation, namespace
            )
        return self._caches[key]

    def gene_similarity_matrix(
        self, genes: Sequence[str], namespace: str = "biological_process",
        measure: str = "Lin", set_measure: str = "BMA",
    ) -> np.ndarray:
        cache = self.similarity_cache(namespace, measure)
        return cache.gene_similarity_matrix(self.annotation, genes, set_measure)

    # --- load-time self test ------------------------------------------------
    def self_test(self) -> bool:
        """Sanity checks run at resource load
        (kgl_ontology_database_test.h analogue): identical annotated terms
        score 1 under Lin, similarities are within [0, 1], matrix symmetric."""
        terms = self.annotation.all_terms()
        if not terms:
            log().warn("OntologyDatabase {}: no annotated terms", self.ontology_ident)
            return False
        lin = self.similarity("Lin")
        probe = terms[: min(5, len(terms))]
        for t in probe:
            if self.information.term_information(t) > 0:
                if abs(lin.calculate_term_similarity(t, t) - 1.0) > 1e-9:
                    return False
        matrix = lin.similarity_matrix(probe)
        if not np.allclose(matrix, matrix.T):
            return False
        if matrix.min() < -1e-9 or matrix.max() > 1.0 + 1e-9:
            return False
        return True
