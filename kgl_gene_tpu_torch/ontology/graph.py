"""GO DAG as integer-indexed CSR arrays with bitset closures.

Capability parity with GoGraph/GoGraphImpl
(kol_ontology/kol_GoGraph.h:25, contrib/kol_GoGraphImpl.h:122-145) —
ancestors/descendants/roots/namespace queries — re-designed for array
compute: terms are dense integer indices, parent/child edges are CSR
arrays, and the ancestor/descendant closures are packed bitset matrices
built in one topological sweep. Device kernels (the all-pairs similarity
cache) consume the ancestor structures directly.

Relationship policy: which edge types climb the DAG (default is_a +
part_of — the reference's PolicyRelationship default).

Copy of kgl_gene_tpu/ontology/graph.py.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..utils.logging import log
from .obo import NAMESPACES, GoTermRecord

__all__ = ["GoGraph", "DEFAULT_RELATIONSHIPS", "ROOT_TERMS"]

DEFAULT_RELATIONSHIPS = ("is_a", "part_of")

ROOT_TERMS = {
    "biological_process": "GO:0008150",
    "molecular_function": "GO:0003674",
    "cellular_component": "GO:0005575",
}


class GoGraph:
    """Integer-indexed GO DAG."""

    def __init__(self, records: Sequence[GoTermRecord],
                 relationships: Sequence[str] = DEFAULT_RELATIONSHIPS):
        active = [r for r in records if not r.obsolete and r.term_id]
        self.term_ids: List[str] = [r.term_id for r in active]
        self.index: Dict[str, int] = {t: i for i, t in enumerate(self.term_ids)}
        # alt_id -> canonical index
        for r in active:
            for alt in r.alt_ids:
                self.index.setdefault(alt, self.index[r.term_id])
        self.names: List[str] = [r.name for r in active]
        self.namespaces: List[str] = [r.namespace for r in active]
        self.namespace_code = np.array(
            [NAMESPACES.index(ns) if ns in NAMESPACES else -1 for ns in self.namespaces],
            dtype=np.int8,
        )

        n = len(self.term_ids)
        rel_set = set(relationships)
        edges: List[Tuple[int, int]] = []  # (child, parent)
        dropped = 0
        for r in active:
            child = self.index[r.term_id]
            for rel, target in r.relations:
                if rel not in rel_set:
                    continue
                parent = self.index.get(target)
                if parent is None:
                    dropped += 1
                    continue
                edges.append((child, parent))
        if dropped:
            log().warn("GoGraph: {} edges to unknown terms dropped", dropped)

        edge_arr = np.array(edges, dtype=np.int64).reshape(-1, 2)
        # parents CSR
        order = np.argsort(edge_arr[:, 0], kind="stable")
        self._parent_targets = edge_arr[order, 1].astype(np.int32)
        self._parent_offsets = np.zeros(n + 1, dtype=np.int64)
        np.add.at(self._parent_offsets, edge_arr[:, 0] + 1, 1)
        np.cumsum(self._parent_offsets, out=self._parent_offsets)
        # children CSR
        order = np.argsort(edge_arr[:, 1], kind="stable")
        self._child_targets = edge_arr[order, 0].astype(np.int32)
        self._child_offsets = np.zeros(n + 1, dtype=np.int64)
        np.add.at(self._child_offsets, edge_arr[:, 1] + 1, 1)
        np.cumsum(self._child_offsets, out=self._child_offsets)

        self._topo = self._topological_order()
        self._ancestor_bits: Optional[np.ndarray] = None
        self._descendant_bits: Optional[np.ndarray] = None
        self._words = (n + 63) // 64

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self.term_ids)

    def has_term(self, term_id: str) -> bool:
        return term_id in self.index

    def term_index(self, term_id: str) -> Optional[int]:
        return self.index.get(term_id)

    def term_ontology(self, term_id: str) -> str:
        idx = self.index.get(term_id)
        return self.namespaces[idx] if idx is not None else ""

    def parents(self, idx: int) -> np.ndarray:
        return self._parent_targets[self._parent_offsets[idx] : self._parent_offsets[idx + 1]]

    def children(self, idx: int) -> np.ndarray:
        return self._child_targets[self._child_offsets[idx] : self._child_offsets[idx + 1]]

    def roots(self) -> List[int]:
        return [
            i for i in range(len(self))
            if len(self.parents(i)) == 0 and self.namespace_code[i] >= 0
        ]

    def root_index(self, namespace: str) -> Optional[int]:
        return self.index.get(ROOT_TERMS.get(namespace, ""))

    # ------------------------------------------------------------------ #
    def _topological_order(self) -> np.ndarray:
        """Order with all parents before their children (DAG sweep)."""
        n = len(self)
        in_deg = np.diff(self._parent_offsets)  # number of parents per term
        remaining = in_deg.copy()
        order = []
        stack = [i for i in range(n) if remaining[i] == 0]
        while stack:
            node = stack.pop()
            order.append(node)
            for child in self.children(node):
                remaining[child] -= 1
                if remaining[child] == 0:
                    stack.append(int(child))
        if len(order) != n:
            log().warn("GoGraph: cycle detected; {} terms unordered", n - len(order))
            ordered = set(order)
            order.extend(i for i in range(n) if i not in ordered)
        return np.asarray(order, dtype=np.int64)

    def ancestor_bitsets(self) -> np.ndarray:
        """(n, words) uint64: self + all ancestors, one topological sweep."""
        if self._ancestor_bits is None:
            n = len(self)
            bits = np.zeros((n, self._words), dtype=np.uint64)
            for idx in self._topo:
                row = bits[idx]
                row[idx >> 6] |= np.uint64(1) << np.uint64(idx & 63)
                for parent in self.parents(int(idx)):
                    row |= bits[parent]
            self._ancestor_bits = bits
        return self._ancestor_bits

    def descendant_bitsets(self) -> np.ndarray:
        """(n, words) uint64: self + all descendants."""
        if self._descendant_bits is None:
            n = len(self)
            bits = np.zeros((n, self._words), dtype=np.uint64)
            for idx in self._topo[::-1]:
                row = bits[idx]
                row[idx >> 6] |= np.uint64(1) << np.uint64(idx & 63)
                for child in self.children(int(idx)):
                    row |= bits[child]
            self._descendant_bits = bits
        return self._descendant_bits

    @staticmethod
    def _bits_to_indices(row: np.ndarray) -> np.ndarray:
        return np.nonzero(
            np.unpackbits(row.view(np.uint8), bitorder="little")
        )[0]

    # --- set queries (GoGraphImpl API surface) ----------------------------
    def get_self_ancestor_terms(self, term_id: str) -> Set[str]:
        idx = self.index.get(term_id)
        if idx is None:
            return set()
        rows = self._bits_to_indices(self.ancestor_bitsets()[idx])
        return {self.term_ids[i] for i in rows}

    def get_ancestor_terms(self, term_id: str) -> Set[str]:
        out = self.get_self_ancestor_terms(term_id)
        out.discard(term_id)
        return out

    def get_self_descendant_terms(self, term_id: str) -> Set[str]:
        idx = self.index.get(term_id)
        if idx is None:
            return set()
        rows = self._bits_to_indices(self.descendant_bitsets()[idx])
        return {self.term_ids[i] for i in rows}

    def get_descendant_terms(self, term_id: str) -> Set[str]:
        out = self.get_self_descendant_terms(term_id)
        out.discard(term_id)
        return out

    def get_extended_term_set(self, term_ids: Iterable[str]) -> Set[str]:
        """Union of self+ancestors over a term set (getExtendedTermSet) —
        the induced-ancestor set used by SimGIC/SimUI/SimDIC."""
        out: Set[str] = set()
        for term in term_ids:
            out |= self.get_self_ancestor_terms(term)
        return out

    # --- depth map (InformationDepthMap analogue) -------------------------
    def depth_map(self) -> np.ndarray:
        """Minimum distance from the namespace root per term (roots = 0)."""
        n = len(self)
        depth = np.full(n, -1, dtype=np.int64)
        for idx in self._topo:
            parents = self.parents(int(idx))
            if len(parents) == 0:
                depth[idx] = 0
            else:
                pd = depth[parents]
                pd = pd[pd >= 0]
                depth[idx] = int(pd.min()) + 1 if len(pd) else 0
        return depth
