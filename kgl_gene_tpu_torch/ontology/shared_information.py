"""Alternative shared-information (CDA) calculators.

Capability parity with the reference's InformationInterface family
(kol_InformationAncestorMean.h, kol_InformationCoutoGraSM.h/.cpp,
kol_InformationCoutoGraSMAdjusted.h, kol_InformationFrontier.h,
kol_InformationExclusiveInherited.h): Couto et al. proposed replacing the
MICA's IC with the MEAN IC over a set of "common disjoint ancestors"
(CDA) when computing Resnik/Lin/Jiang-Conrath. Each class below derives a
different CDA set and returns mean IC over it; all delegate
term_information / validate_terms / max_information_content to the base
InformationContent so they drop into the similarity measures unchanged.

CDA derivations:
  - AncestorMean: all common self-ancestors (the simplest).
  - CoutoGraSM: Couto's exact greedy algorithm — common ancestors in
    descending IC order, admitted if path-count disjoint from every
    previously admitted ancestor (isDisjoint with DAG path counting,
    kol_InformationCoutoGraSM.cpp:100-197).
  - CoutoGraSMAdjusted: same greedy with the adjusted (strict) path test.
  - Frontier: the maximal common ancestors (no admitted ancestor is an
    ancestor of another) — the frontier of the common-ancestor set.
  - ExclusiveInherited: common ancestors reached directly from the
    exclusive (non-common) parts of either term's ancestry.

Copy of kgl_gene_tpu/ontology/shared_information.py.
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import numpy as np

from .graph import GoGraph
from .information import InformationContent

__all__ = [
    "InformationAncestorMean",
    "InformationCoutoGraSM",
    "InformationCoutoGraSMAdjusted",
    "InformationFrontier",
    "InformationExclusiveInherited",
]


class _SharedInfoBase:
    """Delegating base: only shared_information differs per subclass."""

    def __init__(self, graph: GoGraph, information: InformationContent):
        self.graph = graph
        self.info = information

    # --- delegation so similarity measures can swap calculators -----------
    def term_information(self, term_id: str) -> float:
        return self.info.term_information(term_id)

    def max_information_content(self, term_id: str) -> float:
        return self.info.max_information_content(term_id)

    def validate_terms(self, term_a: str, term_b: str) -> bool:
        return self.info.validate_terms(term_a, term_b)

    # --- common machinery -------------------------------------------------
    def _common_ancestors(self, term_a: str, term_b: str) -> Set[str]:
        return (
            self.graph.get_self_ancestor_terms(term_a)
            & self.graph.get_self_ancestor_terms(term_b)
        )

    def _mean_ic(self, terms: Set[str]) -> float:
        if not terms:
            return 0.0
        return float(np.mean([self.info.term_information(t) for t in terms]))

    def common_disjoint_ancestors(self, term_a: str, term_b: str) -> Set[str]:
        raise NotImplementedError

    def shared_information(self, term_a: str, term_b: str) -> float:
        if not self.validate_terms(term_a, term_b):
            return 0.0
        return self._mean_ic(self.common_disjoint_ancestors(term_a, term_b))


class InformationAncestorMean(_SharedInfoBase):
    """Mean IC over ALL common ancestors (kol_InformationAncestorMean)."""

    def common_disjoint_ancestors(self, term_a: str, term_b: str) -> Set[str]:
        return self._common_ancestors(term_a, term_b)


class InformationCoutoGraSM(_SharedInfoBase):
    """Couto's exact GraSM disjoint-ancestor algorithm."""

    adjusted = False

    def __init__(self, graph: GoGraph, information: InformationContent):
        super().__init__(graph, information)
        self._path_memory: Dict[Tuple[int, int], int] = {}

    def _path_count(self, ancestor_idx: int, term_idx: int) -> int:
        """Number of distinct upward paths from term to ancestor in the
        DAG (memoized DP over parents)."""
        key = (ancestor_idx, term_idx)
        cached = self._path_memory.get(key)
        if cached is not None:
            return cached
        if ancestor_idx == term_idx:
            result = 1
        else:
            result = 0
            for parent in self.graph.parents(term_idx):
                result += self._path_count(ancestor_idx, int(parent))
        self._path_memory[key] = result
        return result

    def _paths(self, term_a: str, term_b: str) -> int:
        """Paths from the lower-IC term up to... the reference counts
        paths from B up toward A (0 if A is more informative)."""
        ia = self.graph.term_index(term_a)
        ib = self.graph.term_index(term_b)
        if ia is None or ib is None:
            return 0
        if self.info.term_information(term_a) > self.info.term_information(term_b):
            return 0
        return self._path_count(ia, ib)

    def _is_disjoint(self, term_c: str, term_a1: str, term_a2: str) -> bool:
        """(kol_InformationCoutoGraSM.cpp:162-197)."""
        if self.info.term_information(term_a1) > self.info.term_information(term_a2):
            return False
        n_paths = self._paths(term_a1, term_a2)
        n_paths_1 = self._paths(term_a1, term_c)
        n_paths_2 = self._paths(term_a2, term_c)
        if self.adjusted:
            return n_paths_1 > n_paths * n_paths_2
        return n_paths_1 >= n_paths * n_paths_2

    def common_disjoint_ancestors(self, term_c1: str, term_c2: str) -> Set[str]:
        if term_c1 == term_c2:
            return {term_c1}
        common = self._common_ancestors(term_c1, term_c2)
        ordered = sorted(
            common, key=lambda t: self.info.term_information(t), reverse=True
        )
        cda: Set[str] = set()
        for term_a in ordered:
            is_disjoint = True
            for term_cda in cda:
                if term_cda == term_a:
                    continue
                is_disjoint = is_disjoint and (
                    self._is_disjoint(term_c1, term_a, term_cda)
                    or self._is_disjoint(term_c2, term_a, term_cda)
                )
            if is_disjoint:
                cda.add(term_a)
        return cda


class InformationCoutoGraSMAdjusted(InformationCoutoGraSM):
    """GraSM with the strict (adjusted) disjointness inequality."""

    adjusted = True


class InformationFrontier(_SharedInfoBase):
    """Maximal common ancestors: drop any common ancestor that is an
    ancestor of another common ancestor (the frontier of the set)."""

    def common_disjoint_ancestors(self, term_a: str, term_b: str) -> Set[str]:
        if term_a == term_b:
            return {term_a}
        common = self._common_ancestors(term_a, term_b)
        frontier = set()
        for term in common:
            descendants = self.graph.get_descendant_terms(term)
            if not (descendants & common):
                frontier.add(term)
        return frontier


class InformationExclusiveInherited(_SharedInfoBase):
    """Common ancestors inherited directly from the exclusive ancestry:
    a common ancestor qualifies if one of its DAG children is an exclusive
    (non-common) ancestor-or-self of either term."""

    def common_disjoint_ancestors(self, term_a: str, term_b: str) -> Set[str]:
        if term_a == term_b:
            return {term_a}
        anc_a = self.graph.get_self_ancestor_terms(term_a)
        anc_b = self.graph.get_self_ancestor_terms(term_b)
        common = anc_a & anc_b
        exclusive = (anc_a | anc_b) - common
        cda = set()
        for term in common:
            idx = self.graph.term_index(term)
            for child in self.graph.children(idx):
                child_term = self.graph.term_ids[int(child)]
                if child_term in exclusive:
                    cda.add(term)
                    break
        return cda
