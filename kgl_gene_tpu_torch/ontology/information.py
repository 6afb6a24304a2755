"""Term information content over the annotated DAG.

Capability parity with InformationContent/InformationContentDAG
(kol_ontology/kol_InformationContent.cpp:15-77,
kol_InformationContentImpl.cpp:39-180): cumulative annotation counts over
each term's self+descendant SET, probability = count / namespace-root
count, IC = -ln(p), per-namespace max IC, and MICA shared information.

Copy of kgl_gene_tpu/ontology/information.py with the same values, bit for
bit, and no dense (terms x terms) temporary. The reference unpacks every
descendant bitset into an (n, n) float64 matrix (14.8 GB at GO's ~43,000
terms) and its mica_matrix builds (256, 256, n) float64 blocks (22.5 GB at
that size); here both walk blocks of at most BLOCK_BYTES:

- cumulative counts: a term's count is the sum of the direct counts of the
  annotated terms below it, so each block of annotated terms adds its
  counts to the unpacked rows of its ancestor bitsets. The counts are
  integers summed in float64, exact in any order;
- mica_matrix: max over ancestors of min(weighted_i, weighted_j), in
  blocks of rows and of the ancestor axis. Only terms that are an ancestor
  of some term of the subset can be common; every other term adds
  min(0, 0) = 0, which the zeros the matrix starts from stand for (IC is
  never negative). Max and min select, so any blocking gives the same
  numbers.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from .annotation import TermAnnotation
from .graph import GoGraph
from .obo import NAMESPACES

__all__ = ["InformationContent"]

BAD_INFO_VALUE = 0.0
# The most bytes a blocked temporary may take (tests set it small so that
# many blocks run).
BLOCK_BYTES = 256 << 20


def _unpack(words: np.ndarray, n: int) -> np.ndarray:
    """(rows, words) uint64 bitsets -> (rows, n) uint8 0/1."""
    return np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")[:, :n]


class InformationContent:
    def __init__(self, graph: GoGraph, annotation: TermAnnotation):
        self.graph = graph
        counts = annotation.annotation_count_vector(graph)

        # Cumulative annotations: for each term, the sum of direct counts
        # over its self+descendant set, i.e. every annotated term adds its
        # count to itself and each of its ancestors.
        anc = graph.ancestor_bitsets()  # (n, words) uint64
        n = len(graph)
        annotated = np.flatnonzero(counts)
        rows = max(1, BLOCK_BYTES // (9 * max(n, 1)))  # uint8 bits + float64 copy
        self.cumulative_counts = np.zeros(n, dtype=np.float64)
        for start in range(0, len(annotated), rows):
            block = annotated[start : start + rows]
            self.cumulative_counts += counts[block] @ _unpack(anc[block], n).astype(np.float64)

        # Namespace root counts.
        self.root_counts = np.ones(3, dtype=np.float64)
        for ns_code, namespace in enumerate(NAMESPACES):
            root = graph.root_index(namespace)
            if root is not None and self.cumulative_counts[root] > 0:
                self.root_counts[ns_code] = self.cumulative_counts[root]

        ns_code = graph.namespace_code.astype(np.int64)
        root_for_term = self.root_counts[np.clip(ns_code, 0, 2)]
        with np.errstate(divide="ignore"):
            prob = self.cumulative_counts / root_for_term
            ic = np.where(prob > 0, -np.log(prob), BAD_INFO_VALUE)
        ic = np.where(ns_code >= 0, ic, BAD_INFO_VALUE)
        self.ic = ic

        # Per-namespace max IC (convertProbtoIC max tracking).
        self.max_ic = np.zeros(3, dtype=np.float64)
        for code in range(3):
            mask = (ns_code == code) & (self.cumulative_counts > 0)
            if mask.any():
                self.max_ic[code] = float(ic[mask].max())

    # ------------------------------------------------------------------ #
    def term_information(self, term_id: str) -> float:
        idx = self.graph.term_index(term_id)
        if idx is None or self.cumulative_counts[idx] <= 0:
            return BAD_INFO_VALUE
        return float(self.ic[idx])

    def max_information_content(self, term_id: str) -> float:
        idx = self.graph.term_index(term_id)
        if idx is None:
            return 0.0
        code = int(self.graph.namespace_code[idx])
        return float(self.max_ic[code]) if code >= 0 else 0.0

    def validate_terms(self, term_a: str, term_b: str) -> bool:
        ia = self.graph.term_index(term_a)
        ib = self.graph.term_index(term_b)
        if ia is None or ib is None:
            return False
        if self.cumulative_counts[ia] <= 0 or self.cumulative_counts[ib] <= 0:
            return False
        return self.graph.namespace_code[ia] == self.graph.namespace_code[ib]

    def shared_information(self, term_a: str, term_b: str) -> float:
        """IC of the Most Informative Common Ancestor (MICA)."""
        ia = self.graph.term_index(term_a)
        ib = self.graph.term_index(term_b)
        if ia is None or ib is None:
            return 0.0
        anc = self.graph.ancestor_bitsets()
        common = anc[ia] & anc[ib]
        if not common.any():
            return 0.0
        idxs = GoGraph._bits_to_indices(common)
        return float(self.ic[idxs].max()) if len(idxs) else 0.0

    # --- all-pairs MICA on the host (the similarity cache's feed) ---------
    def mica_matrix(self, term_indices: Sequence[int]) -> np.ndarray:
        """MICA IC for every pair in a term subset: (k, k) float64.

        The IC applied as a weight on the unpacked ancestor bit-planes,
        max-reduced over the pairwise min, in blocks of rows and of the
        ancestor axis (module docstring)."""
        term_indices = np.asarray(term_indices, dtype=np.int64)
        k = len(term_indices)
        out = np.zeros((k, k), dtype=np.float64)
        if k == 0:
            return out
        anc = self.graph.ancestor_bitsets()[term_indices]  # (k, words)
        n = len(self.graph)
        cols = GoGraph._bits_to_indices(np.bitwise_or.reduce(anc, axis=0))
        b = max(1, min(256, k, math.isqrt(BLOCK_BYTES // (8 * 64))))
        tb = max(8, BLOCK_BYTES // (8 * b * b) // 8 * 8)
        # The subset's bits on the ancestor axis `cols`, packed again: at
        # most k * n / 8 bytes (231 MB at 43,000 terms).
        packed = np.concatenate([
            np.packbits(_unpack(anc[r : r + b], n)[:, cols], axis=1, bitorder="little")
            for r in range(0, k, b)])
        for t0 in range(0, len(cols), tb):
            ic = self.ic[cols[t0 : t0 + tb]]
            bits = np.unpackbits(packed[:, t0 // 8 : (t0 + tb) // 8], axis=1,
                                 bitorder="little")[:, : len(ic)]
            for start in range(0, k, b):
                rows = bits[start : start + b].astype(np.float64) * ic[None, :]
                for jstart in range(0, k, b):
                    cols_w = bits[jstart : jstart + b].astype(np.float64) * ic[None, :]
                    pair_min = np.minimum(rows[:, None, :], cols_w[None, :, :])
                    dst = out[start : start + b, jstart : jstart + b]
                    np.maximum(dst, pair_min.max(axis=2), out=dst)
        return out
