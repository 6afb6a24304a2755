"""All-pairs term-similarity cache and matrix IO.

Capability parity with TermSimilarityCache / SimilarityMatrix /
SimilarityWriter (kol_SimilarityCache.h:27, kol_SimilarityCache.cpp:126-150,
kol_SimilarityMatrix.h:21, kol_SimilarityWriter.h): the reference computes
the N^2 term matrix one column per pool thread; here the whole matrix
comes from the vectorized MICA path (ontology/information.py mica_matrix),
and gene-set measures against the cache reduce to sub-block max/mean over
the cached matrix rows (cacheBMA etc.). The cache is also the staging
buffer for the TPU-tiled gene x gene similarity kernel (ops/similarity).

Copy of kgl_gene_tpu/ontology/cache.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..utils.logging import log
from .annotation import TermAnnotation
from .graph import GoGraph

__all__ = ["TermSimilarityCache", "TermSimilarityCacheAsymmetric", "write_similarity_matrix", "read_similarity_matrix"]


class TermSimilarityCache:
    """Precomputed symmetric term-similarity matrix over the annotated
    terms of one namespace."""

    def __init__(self, similarity, annotation: TermAnnotation, namespace: str):
        self.namespace = namespace
        self.terms: List[str] = annotation.all_terms(namespace)
        self.term_index: Dict[str, int] = {t: i for i, t in enumerate(self.terms)}
        if self.terms:
            self.matrix = similarity.similarity_matrix(self.terms)
        else:
            self.matrix = np.zeros((0, 0))
        log().info(
            "TermSimilarityCache: namespace {}, {} terms, {} pairs",
            namespace, len(self.terms), len(self.terms) ** 2,
        )

    def term_count(self) -> int:
        return len(self.terms)

    def calculate_term_similarity(self, term_a: str, term_b: str) -> float:
        ia = self.term_index.get(term_a)
        ib = self.term_index.get(term_b)
        if ia is None or ib is None:
            return 0.0
        return float(self.matrix[ia, ib])

    # --- cached set measures (vectorized sub-block reductions) -----------
    def _indices(self, terms: Sequence[str]) -> np.ndarray:
        return np.array(
            [self.term_index[t] for t in terms if t in self.term_index], dtype=np.int64
        )

    def best_match_average(self, row_terms: Set[str], column_terms: Set[str]) -> float:
        ri = self._indices(sorted(row_terms))
        ci = self._indices(sorted(column_terms))
        if len(ri) == 0 or len(ci) == 0:
            return 0.0
        block = self.matrix[np.ix_(ri, ci)]
        return float((block.max(axis=1).mean() + block.max(axis=0).mean()) / 2.0)

    def average_best_match(self, row_terms: Set[str], column_terms: Set[str]) -> float:
        ri = self._indices(sorted(row_terms))
        ci = self._indices(sorted(column_terms))
        if len(ri) == 0 or len(ci) == 0:
            return 0.0
        block = self.matrix[np.ix_(ri, ci)]
        return float(
            (block.max(axis=1).sum() + block.max(axis=0).sum())
            / (block.shape[0] + block.shape[1])
        )

    def all_pairs_max(self, row_terms: Set[str], column_terms: Set[str]) -> float:
        ri = self._indices(sorted(row_terms))
        ci = self._indices(sorted(column_terms))
        if len(ri) == 0 or len(ci) == 0:
            return 0.0
        return float(self.matrix[np.ix_(ri, ci)].max())

    # --- gene x gene matrix (the malaria gene-set cache use case) ---------
    def gene_similarity_matrix(
        self, annotation: TermAnnotation, genes: Sequence[str], measure: str = "BMA"
    ) -> np.ndarray:
        """All-pairs gene similarity from cached term rows."""
        fn = {
            "BMA": self.best_match_average,
            "ABM": self.average_best_match,
            "MAX": self.all_pairs_max,
        }[measure]
        term_sets = [
            annotation.go_terms_for_gene_by_namespace(g, self.namespace) for g in genes
        ]
        n = len(genes)
        out = np.zeros((n, n))
        for i in range(n):
            for j in range(i, n):
                value = fn(term_sets[i], term_sets[j])
                out[i, j] = out[j, i] = value
        return out


class TermSimilarityCacheAsymmetric(TermSimilarityCache):
    """Cache for asymmetric term measures: rows and columns may come from
    different term sets and M[i,j] is NOT assumed equal to M[j,i]
    (kol_SimilarityCacheAsymmetric.cpp:153). The full rectangle computes
    column-blocks through the measure's scalar API."""

    def __init__(self, similarity, annotation: TermAnnotation, namespace: str,
                 column_terms=None):
        self.namespace = namespace
        self.terms: List[str] = annotation.all_terms(namespace)
        self.column_terms: List[str] = list(column_terms) if column_terms else self.terms
        self.term_index = {t: i for i, t in enumerate(self.terms)}
        self.column_index = {t: i for i, t in enumerate(self.column_terms)}
        import numpy as _np

        self.matrix = _np.zeros((len(self.terms), len(self.column_terms)))
        for i, a in enumerate(self.terms):
            for j, b in enumerate(self.column_terms):
                self.matrix[i, j] = similarity.calculate_term_similarity(a, b)

    def calculate_term_similarity(self, term_a: str, term_b: str) -> float:
        ia = self.term_index.get(term_a)
        ib = self.column_index.get(term_b)
        if ia is None or ib is None:
            return 0.0
        return float(self.matrix[ia, ib])


def write_similarity_matrix(path: str, terms: Sequence[str], matrix: np.ndarray) -> None:
    """TSV matrix file (SimilarityWriter format: header row of terms then
    one row per term)."""
    with open(path, "w") as f:
        f.write("\t".join(terms) + "\n")
        for i, term in enumerate(terms):
            f.write(term + "\t" + "\t".join(f"{v:.8g}" for v in matrix[i]) + "\n")


def read_similarity_matrix(path: str):
    """Read a precomputed matrix file (SimilarityMatrix analogue)."""
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = []
        row_terms = []
        for line in f:
            parts = line.rstrip("\n").split("\t")
            row_terms.append(parts[0])
            rows.append([float(v) for v in parts[1:]])
    return row_terms, np.asarray(rows)
