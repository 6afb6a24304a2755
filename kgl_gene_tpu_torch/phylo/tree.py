"""Phylogenetic tree structure: Newick IO, manipulation, array flattening.

Capability parity with the kpl tree machinery (kpl_phylogenetic/kpl_tree.h,
kpl_treemanip.h, kpl_tree_io.h, kpl_splittree.h): rooted binary-ish trees
with branch lengths, Newick parse/serialise, leaf/internal indexing, the
postorder traversal arrays the device likelihood consumes, split (bipartition)
hashing for topology summaries, and the random/equiprobable starting tree.

Copy of kgl_gene_tpu/phylo/tree.py: Python and numpy on the host.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PhyloNode", "PhyloTree", "parse_newick", "random_tree"]


@dataclass
class PhyloNode:
    index: int                     # leaves: 0..n_leaves-1; internals after
    name: str = ""
    edge_length: float = 0.0       # branch to parent
    parent: Optional["PhyloNode"] = None
    children: List["PhyloNode"] = field(default_factory=list)

    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self) -> List["PhyloNode"]:
        if self.is_leaf():
            return [self]
        out: List["PhyloNode"] = []
        for child in self.children:
            out.extend(child.leaves())
        return out


class PhyloTree:
    """A rooted tree over named leaves."""

    def __init__(self, root: PhyloNode, leaf_names: List[str]):
        self.root = root
        self.leaf_names = leaf_names

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_names)

    # ------------------------------------------------------------------ #
    def nodes_postorder(self) -> List[PhyloNode]:
        out: List[PhyloNode] = []

        def visit(node: PhyloNode):
            for child in node.children:
                visit(child)
            out.append(node)

        visit(self.root)
        return out

    def internal_nodes(self) -> List[PhyloNode]:
        return [n for n in self.nodes_postorder() if not n.is_leaf()]

    def edges(self) -> List[PhyloNode]:
        """All non-root nodes (each owns its edge to the parent)."""
        return [n for n in self.nodes_postorder() if n.parent is not None]

    def tree_length(self) -> float:
        return sum(n.edge_length for n in self.edges())

    def renumber(self) -> None:
        """Reassign internal indices after topology changes: leaves keep
        0..n-1 (by leaf_names order), internals get n, n+1, ... in
        postorder."""
        name_index = {name: i for i, name in enumerate(self.leaf_names)}
        next_internal = self.n_leaves
        for node in self.nodes_postorder():
            if node.is_leaf():
                node.index = name_index[node.name]
            else:
                node.index = next_internal
                next_internal += 1

    # --- array flattening (the device likelihood input) -------------------
    def traversal_arrays(self) -> dict:
        """Postorder traversal as arrays: for each internal node, its
        children indices and edge lengths."""
        self.renumber()
        nodes = self.nodes_postorder()
        internals = [n for n in nodes if not n.is_leaf()]
        max_children = max((len(n.children) for n in internals), default=2)
        n_nodes = self.n_leaves + len(internals)
        child_index = np.full((len(internals), max_children), -1, dtype=np.int32)
        child_edge = np.zeros((len(internals), max_children), dtype=np.float64)
        node_index = np.zeros(len(internals), dtype=np.int32)
        parent_index = np.full(n_nodes, -1, dtype=np.int32)
        for k, node in enumerate(internals):
            node_index[k] = node.index
            for c, child in enumerate(node.children):
                child_index[k, c] = child.index
                child_edge[k, c] = child.edge_length
                parent_index[child.index] = node.index
        return {
            "n_nodes": n_nodes,
            "n_internals": len(internals),
            "root_index": self.root.index,
            "internal_index": node_index,
            "child_index": child_index,
            "child_edge": child_edge,
            "parent_index": parent_index,
        }

    # --- splits (kpl_splittree.h) -----------------------------------------
    def splits(self) -> set:
        """Bipartition set (frozenset of leaf names on the child side of
        each internal edge) — topology identity."""
        out = set()

        def leafset(node: PhyloNode) -> frozenset:
            if node.is_leaf():
                return frozenset([node.name])
            combined: frozenset = frozenset()
            for child in node.children:
                combined |= leafset(child)
            return combined

        for node in self.edges():
            if not node.is_leaf():
                out.add(leafset(node))
        return out

    # --- Newick -----------------------------------------------------------
    def newick(self, precision: int = 6) -> str:
        def write(node: PhyloNode) -> str:
            if node.is_leaf():
                text = node.name
            else:
                text = "(" + ",".join(write(c) for c in node.children) + ")"
            if node.parent is not None:
                text += f":{node.edge_length:.{precision}g}"
            return text

        return write(self.root) + ";"

    def copy(self) -> "PhyloTree":
        """Structural clone (indices, names, lengths; parents rebuilt).
        Replaces the Newick serialize/re-parse round trip — tree copies
        run once per MCMC proposal, and at 4 copies/iteration the parse
        was a measurable share of the fused sampler's host time. Custom
        node attributes (e.g. the fused iteration's _orig tags) are
        deliberately NOT copied."""

        def clone(n: PhyloNode) -> PhyloNode:
            m = PhyloNode(index=n.index, name=n.name,
                          edge_length=n.edge_length)
            for c in n.children:
                cc = clone(c)
                cc.parent = m
                m.children.append(cc)
            return m

        return PhyloTree(clone(self.root), list(self.leaf_names))


def parse_newick(text: str, leaf_order: Optional[List[str]] = None) -> PhyloTree:
    """Parse a Newick string with branch lengths. Bracket comments (e.g.
    the NEXUS [&U] rooting annotation our own tree writer emits) are
    stripped first so written trees round-trip."""
    import re as _re

    text = _re.sub(r"\[[^\]]*\]", "", text).strip().rstrip(";")
    pos = 0

    def parse_node() -> PhyloNode:
        nonlocal pos
        node = PhyloNode(index=-1)
        if text[pos] == "(":
            pos += 1
            while True:
                node.children.append(parse_node())
                node.children[-1].parent = node
                if text[pos] == ",":
                    pos += 1
                    continue
                if text[pos] == ")":
                    pos += 1
                    break
        # name
        start = pos
        while pos < len(text) and text[pos] not in ",():;":
            pos += 1
        node.name = text[start:pos]
        # branch length
        if pos < len(text) and text[pos] == ":":
            pos += 1
            start = pos
            while pos < len(text) and text[pos] not in ",()":
                pos += 1
            node.edge_length = float(text[start:pos])
        return node

    root = parse_node()
    leaves = [n.name for n in _collect_leaves(root)]
    if leaf_order is not None:
        missing = set(leaves) ^ set(leaf_order)
        if missing:
            raise ValueError(f"leaf mismatch: {missing}")
        leaves = leaf_order
    tree = PhyloTree(root, leaves)
    tree.renumber()
    return tree


def _collect_leaves(node: PhyloNode) -> List[PhyloNode]:
    if node.is_leaf():
        return [node]
    out: List[PhyloNode] = []
    for child in node.children:
        out.extend(_collect_leaves(child))
    return out


def random_tree(leaf_names: List[str], rng: Optional[random.Random] = None,
                mean_edge: float = 0.1) -> PhyloTree:
    """Random bifurcating starting tree (Strom's starting tree analogue)."""
    rng = rng or random.Random(0)
    nodes = [PhyloNode(index=i, name=name, edge_length=rng.expovariate(1.0 / mean_edge))
             for i, name in enumerate(leaf_names)]
    while len(nodes) > 1:
        a = nodes.pop(rng.randrange(len(nodes)))
        b = nodes.pop(rng.randrange(len(nodes)))
        parent = PhyloNode(index=-1, edge_length=rng.expovariate(1.0 / mean_edge))
        parent.children = [a, b]
        a.parent = parent
        b.parent = parent
        nodes.append(parent)
    root = nodes[0]
    root.edge_length = 0.0
    tree = PhyloTree(root, list(leaf_names))
    tree.renumber()
    return tree
