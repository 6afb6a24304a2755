"""Term-to-term semantic similarity measures.

Capability parity with the reference similarity classes
(kol_SimilarityResnik.h:28, kol_SimilarityLin.h:32, kol_SimilarityJiangConrath.h,
kol_SimilarityPekarStaab.h, kol_SimilarityRelevance.h; formulas from
kol_SimilarityImpl.cpp:20-140):

  Resnik       IC(MICA) / maxIC                       (normalized)
  Lin          2 IC(MICA) / (IC(a) + IC(b));  sim(a,a) = 1
  JiangConrath 1 - min(1, (IC(a)+IC(b)-2 IC(MICA)) / maxIC)
  Relevance    (2 IC(MICA) / (IC(a)+IC(b))) (1 - e^{-IC(MICA)})
  PekarStaab   d(lca) / (d(a)-d(lca) + d(b)-d(lca) + d(lca))

Every measure has a scalar API (calculate_term_similarity) and a
vectorized matrix API over a term subset (the host MICA of
information.py; ops/similarity.py computes the same MICA on the card).

Copy of kgl_gene_tpu/ontology/similarity.py.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .graph import GoGraph
from .information import InformationContent

__all__ = [
    "SimilarityResnik",
    "SimilarityLin",
    "SimilarityJiangConrath",
    "SimilarityRelevance",
    "SimilarityPekarStaab",
]


class _ICSimilarity:
    """Shared machinery for IC/MICA-based measures."""

    def __init__(self, information: InformationContent):
        self.info = information

    # scalar path -----------------------------------------------------------
    def calculate_term_similarity(self, term_a: str, term_b: str) -> float:
        raise NotImplementedError

    # vectorized path -------------------------------------------------------
    def similarity_matrix(self, term_ids: Sequence[str]) -> np.ndarray:
        graph = self.info.graph
        idxs = [graph.term_index(t) for t in term_ids]
        valid = np.array([i is not None for i in idxs])
        safe = np.array([i if i is not None else 0 for i in idxs], dtype=np.int64)
        mica = self.info.mica_matrix(safe)
        ic = self.info.ic[safe]
        counts = self.info.cumulative_counts[safe]
        ns = self.info.graph.namespace_code[safe].astype(np.int64)
        max_ic = self.info.max_ic[np.clip(ns, 0, 2)]
        ok = (
            valid[:, None] & valid[None, :]
            & (counts[:, None] > 0) & (counts[None, :] > 0)
            & (ns[:, None] == ns[None, :])
        )
        out = self._formula_matrix(mica, ic, max_ic)
        return np.where(ok, out, 0.0)

    def _formula_matrix(self, mica, ic, max_ic) -> np.ndarray:
        raise NotImplementedError


class SimilarityResnik(_ICSimilarity):
    def calculate_term_similarity(self, term_a: str, term_b: str) -> float:
        if not self.info.validate_terms(term_a, term_b):
            return 0.0
        max_info = self.info.max_information_content(term_a)
        if max_info == 0.0:
            return 0.0
        return self.info.shared_information(term_a, term_b) / max_info

    def _formula_matrix(self, mica, ic, max_ic):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(max_ic[:, None] > 0, mica / max_ic[:, None], 0.0)


class SimilarityLin(_ICSimilarity):
    def calculate_term_similarity(self, term_a: str, term_b: str) -> float:
        if term_a == term_b and self.info.term_information(term_a) > 0:
            return 1.0
        if not self.info.validate_terms(term_a, term_b):
            return 0.0
        denom = self.info.term_information(term_a) + self.info.term_information(term_b)
        if denom == 0.0:
            return 0.0
        return 2.0 * self.info.shared_information(term_a, term_b) / denom

    def _formula_matrix(self, mica, ic, max_ic):
        denom = ic[:, None] + ic[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(denom > 0, 2.0 * mica / denom, 0.0)
        # sim(a, a) = 1 by definition.
        np.fill_diagonal(out, np.where(ic > 0, 1.0, 0.0))
        return out


class SimilarityJiangConrath(_ICSimilarity):
    def calculate_term_similarity(self, term_a: str, term_b: str) -> float:
        if not self.info.validate_terms(term_a, term_b):
            return 0.0
        max_ic = self.info.max_information_content(term_a)
        if max_ic == 0.0:
            return 0.0
        dist = (
            self.info.term_information(term_a)
            + self.info.term_information(term_b)
            - 2.0 * self.info.shared_information(term_a, term_b)
        )
        return 1.0 - min(1.0, dist / max_ic)

    def _formula_matrix(self, mica, ic, max_ic):
        dist = ic[:, None] + ic[None, :] - 2.0 * mica
        with np.errstate(divide="ignore", invalid="ignore"):
            scaled = np.where(max_ic[:, None] > 0, dist / max_ic[:, None], 1.0)
        return 1.0 - np.minimum(1.0, scaled)


class SimilarityRelevance(_ICSimilarity):
    def calculate_term_similarity(self, term_a: str, term_b: str) -> float:
        if not self.info.validate_terms(term_a, term_b):
            return 0.0
        mica = self.info.shared_information(term_a, term_b)
        denom = self.info.term_information(term_a) + self.info.term_information(term_b)
        if denom == 0.0 or mica == 0.0:
            return 0.0
        return (2.0 * mica / denom) * (1.0 - np.exp(-mica))

    def _formula_matrix(self, mica, ic, max_ic):
        denom = ic[:, None] + ic[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(
                (denom > 0) & (mica > 0),
                (2.0 * mica / denom) * (1.0 - np.exp(-mica)),
                0.0,
            )
        return out


class SimilarityPekarStaab:
    """Depth-based (graph distance) similarity
    (kol_SimilarityPekarStaab.cpp:17-60)."""

    def __init__(self, graph: GoGraph, depth: Optional[np.ndarray] = None):
        self.graph = graph
        self.depth = depth if depth is not None else graph.depth_map()

    def calculate_term_similarity(self, term_a: str, term_b: str) -> float:
        ia = self.graph.term_index(term_a)
        ib = self.graph.term_index(term_b)
        if ia is None or ib is None:
            return 0.0
        if self.graph.namespace_code[ia] != self.graph.namespace_code[ib]:
            return 0.0
        anc = self.graph.ancestor_bitsets()
        common = anc[ia] & anc[ib]
        idxs = GoGraph._bits_to_indices(common)
        if len(idxs) == 0:
            return 0.0
        # LCA = deepest common ancestor.
        lca_depth = int(self.depth[idxs].max())
        da, db = int(self.depth[ia]), int(self.depth[ib])
        denom = (da - lca_depth) + (db - lca_depth) + lca_depth
        if denom == 0:
            return 0.0
        return lca_depth / denom
