"""Term-set (gene-to-gene) similarity measures.

Capability parity with the 9 reference set-similarity classes
(kol_SetSimilarityInterface.h and kol_SetSimilarity*.cpp): Jaccard, SimUI
(Gentleman), SimGIC (Pesquita), SimDIC/SimUIC (Mazandu), AllPairsMax,
AllPairsAverage, BestMatchAverage and AverageBestMatch — matching the
reference's exact accumulator formulas. Pairwise measures accept a
precomputed term-similarity matrix so gene x gene matrices reduce to
max/mean over sub-blocks (the TPU-tiled path in cache.py).

Copy of kgl_gene_tpu/ontology/set_similarity.py.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Set

import numpy as np

from .graph import GoGraph
from .information import InformationContent

__all__ = [
    "SetSimilarityJaccard",
    "SetSimilarityGentlemanSimUI",
    "SetSimilarityPesquitaSimGIC",
    "SetSimilarityMazanduSimDIC",
    "SetSimilarityMazanduSimUIC",
    "SetSimilarityAllPairsMax",
    "SetSimilarityAllPairsAverage",
    "SetSimilarityBestMatchAverage",
    "SetSimilarityAverageBestMatch",
]


class SetSimilarityJaccard:
    """|A n B| / |A u B| over the raw term sets."""

    def calculate_similarity(self, row_terms: Set[str], column_terms: Set[str]) -> float:
        if not row_terms or not column_terms:
            return 0.0
        union = row_terms | column_terms
        if not union:
            return 0.0
        return len(row_terms & column_terms) / len(union)


class _InducedSetSimilarity:
    """Shared: measures over the ancestor-extended (induced) term sets."""

    def __init__(self, graph: GoGraph, information: InformationContent):
        self.graph = graph
        self.info = information

    def _induced(self, terms: Iterable[str]) -> Set[str]:
        return self.graph.get_extended_term_set(terms)

    def _ic_sum(self, terms: Iterable[str]) -> float:
        return float(sum(self.info.term_information(t) for t in terms))


class SetSimilarityGentlemanSimUI(_InducedSetSimilarity):
    """|induced A n induced B| / |induced A u induced B|."""

    def calculate_similarity(self, row_terms: Set[str], column_terms: Set[str]) -> float:
        a = self._induced(row_terms)
        b = self._induced(column_terms)
        union = a | b
        if not union:
            return 0.0
        return len(a & b) / len(union)


class SetSimilarityPesquitaSimGIC(_InducedSetSimilarity):
    """IC-weighted Jaccard over the induced sets."""

    def calculate_similarity(self, row_terms: Set[str], column_terms: Set[str]) -> float:
        a = self._induced(row_terms)
        b = self._induced(column_terms)
        union_sum = self._ic_sum(a | b)
        if union_sum == 0.0:
            return 0.0
        return self._ic_sum(a & b) / union_sum


class SetSimilarityMazanduSimDIC(_InducedSetSimilarity):
    """2 IC(A n B) / (IC(A) + IC(B)) over induced sets."""

    def calculate_similarity(self, row_terms: Set[str], column_terms: Set[str]) -> float:
        a = self._induced(row_terms)
        b = self._induced(column_terms)
        denom = self._ic_sum(a) + self._ic_sum(b)
        if denom == 0.0:
            return 0.0
        return 2.0 * self._ic_sum(a & b) / denom


class SetSimilarityMazanduSimUIC(_InducedSetSimilarity):
    """IC(A n B) / max(IC(A), IC(B)) over induced sets."""

    def calculate_similarity(self, row_terms: Set[str], column_terms: Set[str]) -> float:
        a = self._induced(row_terms)
        b = self._induced(column_terms)
        sum_a = self._ic_sum(a)
        sum_b = self._ic_sum(b)
        if sum_a + sum_b == 0.0:
            return 0.0
        return self._ic_sum(a & b) / max(sum_a, sum_b)


class _PairwiseSetSimilarity:
    """Shared: measures built on a term-level similarity measure."""

    def __init__(self, term_similarity):
        self.term_similarity = term_similarity

    def _pair_matrix(self, row_terms: Sequence[str], column_terms: Sequence[str]) -> np.ndarray:
        rows = list(row_terms)
        cols = list(column_terms)
        out = np.zeros((len(rows), len(cols)))
        for i, a in enumerate(rows):
            for j, b in enumerate(cols):
                out[i, j] = self.term_similarity.calculate_term_similarity(a, b)
        return out


class SetSimilarityAllPairsMax(_PairwiseSetSimilarity):
    def calculate_similarity(self, row_terms: Set[str], column_terms: Set[str]) -> float:
        if not row_terms or not column_terms:
            return 0.0
        return float(self._pair_matrix(sorted(row_terms), sorted(column_terms)).max())


class SetSimilarityAllPairsAverage(_PairwiseSetSimilarity):
    def calculate_similarity(self, row_terms: Set[str], column_terms: Set[str]) -> float:
        if not row_terms or not column_terms:
            return 0.0
        return float(self._pair_matrix(sorted(row_terms), sorted(column_terms)).mean())


class SetSimilarityBestMatchAverage(_PairwiseSetSimilarity):
    """(mean of row best-matches + mean of column best-matches) / 2
    (kol_SetSimilarityBestMatchAverage.cpp:28-80)."""

    def calculate_similarity(self, row_terms: Set[str], column_terms: Set[str]) -> float:
        if not row_terms or not column_terms:
            return 0.0
        m = self._pair_matrix(sorted(row_terms), sorted(column_terms))
        return float((m.max(axis=1).mean() + m.max(axis=0).mean()) / 2.0)


class SetSimilarityAverageBestMatch(_PairwiseSetSimilarity):
    """(sum of row best-matches + sum of column best-matches) /
    (|A| + |B|) (kol_SetSimilarityAverageBestMatch.cpp)."""

    def calculate_similarity(self, row_terms: Set[str], column_terms: Set[str]) -> float:
        if not row_terms or not column_terms:
            return 0.0
        m = self._pair_matrix(sorted(row_terms), sorted(column_terms))
        return float(
            (m.max(axis=1).sum() + m.max(axis=0).sum()) / (m.shape[0] + m.shape[1])
        )
