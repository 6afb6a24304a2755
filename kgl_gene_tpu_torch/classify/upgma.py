"""Distance matrices, UPGMA agglomerative trees and Newick output.

A copy of kgl_gene_tpu/classify/upgma.py (numpy only), whose trees and
Newick strings the port must reproduce exactly: ties go to the first
minimum in scan order and branch lengths print as %.6g. The all-pairs
matrix comes from ops/edit_distance.pairwise_distance_matrix; this module
owns the host-side agglomeration (leaf-count weighted UPGMA merges, the
reference's kgl_distance_tree_upgma.cpp:122-225) and the Newick writer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["TreeNode", "DistanceMatrix", "upgma_tree", "newick"]


@dataclass
class TreeNode:
    """Leaf or clade node with UPGMA branch length to its parent."""

    name: str
    children: List["TreeNode"] = field(default_factory=list)
    parent_distance: float = 0.0
    leaf_count: int = 1
    height: float = 0.0  # UPGMA ultrametric height of this node

    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self) -> List["TreeNode"]:
        if self.is_leaf():
            return [self]
        out: List[TreeNode] = []
        for child in self.children:
            out.extend(child.leaves())
        return out


class DistanceMatrix:
    """Symmetric distance matrix with the reference API surface
    (kgl_distance_matrix_triangular.h): resize/get/set, min/max search,
    normalisation."""

    def __init__(self, size: int = 0):
        self._m = np.zeros((size, size), dtype=np.float64)

    @classmethod
    def from_array(cls, matrix: np.ndarray) -> "DistanceMatrix":
        out = cls(0)
        m = np.asarray(matrix, dtype=np.float64)
        if m.ndim != 2 or m.shape[0] != m.shape[1]:
            raise ValueError("distance matrix must be square")
        out._m = m.copy()
        return out

    def size(self) -> int:
        return self._m.shape[0]

    def get_distance(self, i: int, j: int) -> float:
        return float(self._m[i, j])

    def set_distance(self, i: int, j: int, d: float) -> None:
        self._m[i, j] = d
        self._m[j, i] = d

    def as_array(self) -> np.ndarray:
        return self._m

    def minimum(self) -> Tuple[float, int, int]:
        """(min, row, column) over the strict lower triangle, first in
        row-major scan order on ties (matching the reference's scan)."""
        n = self.size()
        tril = np.tril_indices(n, k=-1)
        vals = self._m[tril]
        k = int(np.argmin(vals))
        return float(vals[k]), int(tril[0][k]), int(tril[1][k])

    def maximum(self) -> Tuple[float, int, int]:
        n = self.size()
        tril = np.tril_indices(n, k=-1)
        vals = self._m[tril]
        k = int(np.argmax(vals))
        return float(vals[k]), int(tril[0][k]), int(tril[1][k])

    def normalize_distance(self) -> None:
        """Scale distances into [0, 1] by the max (normalizeDistance)."""
        mx, _, _ = self.maximum()
        if mx > 0:
            self._m /= mx


def upgma_tree(matrix: DistanceMatrix | np.ndarray, leaf_names: Sequence[str]) -> TreeNode:
    """Agglomerative UPGMA: repeatedly merge the closest pair; merged
    distances are leaf-count weighted means; branch length = height/2 minus
    child height (kgl_distance_tree_upgma.cpp:187-225)."""
    if isinstance(matrix, DistanceMatrix):
        dist = matrix.as_array().copy()
    else:
        dist = np.asarray(matrix, dtype=np.float64).copy()
    n = dist.shape[0]
    if n != len(leaf_names):
        raise ValueError("matrix size != number of leaves")
    if n == 0:
        raise ValueError("empty distance matrix")
    nodes: List[TreeNode] = [TreeNode(name) for name in leaf_names]
    if n == 1:
        return nodes[0]
    active = list(range(n))

    while len(active) > 1:
        # find closest active pair (first minimum in scan order)
        best = (np.inf, -1, -1)
        for ai in range(1, len(active)):
            for aj in range(ai):
                d = dist[active[ai], active[aj]]
                if d < best[0]:
                    best = (d, ai, aj)
        dmin, ai, aj = best
        i, j = active[ai], active[aj]
        node_i, node_j = nodes[i], nodes[j]
        height = dmin / 2.0
        node_i.parent_distance = height - node_i.height
        node_j.parent_distance = height - node_j.height
        merged = TreeNode(
            "Clade",
            children=[node_i, node_j],
            leaf_count=node_i.leaf_count + node_j.leaf_count,
            height=height,
        )
        # weighted-average distances to the merged cluster
        li, lj = node_i.leaf_count, node_j.leaf_count
        for k in active:
            if k in (i, j):
                continue
            dist[i, k] = dist[k, i] = (li * dist[k, i] + lj * dist[k, j]) / (li + lj)
        nodes[i] = merged
        active.remove(j)

    return nodes[active[0]]


def newick(root: TreeNode, precision: int = 6, max_depth: Optional[int] = None) -> str:
    """Serialise a tree to Newick (ClassificationTree::writeNewick)."""

    def fmt(x: float) -> str:
        return f"{x:.{precision}g}"

    def write(node: TreeNode, depth: int) -> str:
        depth += 1
        if max_depth is not None and depth >= max_depth:
            if node.is_leaf():
                text = node.name
            else:
                text = f"Clade_Depth_{depth}_Leaves_{node.leaf_count}"
        elif node.children:
            text = "(" + ",".join(write(c, depth) for c in node.children) + ")"
        else:
            text = node.name
        return f"{text}:{fmt(node.parent_distance)}"

    return write(root, 0) + ";"
