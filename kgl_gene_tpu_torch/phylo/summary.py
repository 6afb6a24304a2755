"""Tree summaries: split (bipartition) frequencies and majority consensus.

Capability parity with kpl's tree summary machinery (kpl_treesummary.h,
kpl_splittree.h): tally split frequencies over the sampled trees, report
the best topologies, and construct the majority-rule consensus tree with
mean branch lengths.

Copy of kgl_gene_tpu/phylo/summary.py: Python on the host.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, FrozenSet, List, Optional, Tuple

from .tree import PhyloNode, PhyloTree

__all__ = ["TreeSummary"]


class TreeSummary:
    def __init__(self, leaf_names: Optional[List[str]] = None):
        self.leaf_names = leaf_names
        self.n_trees = 0
        self.split_counts: Counter = Counter()
        self.split_lengths: Dict[FrozenSet[str], float] = defaultdict(float)
        self.topology_counts: Counter = Counter()

    # ------------------------------------------------------------------ #
    def add_tree(self, tree: PhyloTree) -> None:
        if self.leaf_names is None:
            self.leaf_names = sorted(tree.leaf_names)
        self.n_trees += 1
        splits = tree.splits()
        self.topology_counts[frozenset(splits)] += 1
        for node in tree.edges():
            if node.is_leaf():
                self.split_lengths[frozenset([node.name])] += node.edge_length
                self.split_counts[frozenset([node.name])] += 1
                continue
            leafset = frozenset(l.name for l in node.leaves())
            self.split_counts[leafset] += 1
            self.split_lengths[leafset] += node.edge_length

    # ------------------------------------------------------------------ #
    def split_frequencies(self) -> Dict[FrozenSet[str], float]:
        return {s: c / self.n_trees for s, c in self.split_counts.items()}

    def best_topologies(self, top: int = 5) -> List[Tuple[float, FrozenSet]]:
        return [
            (count / self.n_trees, topo)
            for topo, count in self.topology_counts.most_common(top)
        ]

    def majority_consensus(self, threshold: float = 0.5) -> PhyloTree:
        """Majority-rule consensus: splits above threshold, mean branch
        lengths; compatible splits nest greedily by frequency."""
        if self.n_trees == 0:
            raise ValueError("no trees accumulated")
        taxa = set(self.leaf_names)
        majority = [
            (count / self.n_trees, s)
            for s, count in self.split_counts.items()
            if count / self.n_trees > threshold and 1 < len(s) < len(taxa)
        ]
        majority.sort(reverse=True, key=lambda t: (t[0], -len(t[1])))

        # Greedy compatible subset.
        accepted: List[FrozenSet[str]] = []
        for _, split in majority:
            if all(
                split <= other or other <= split or not (split & other)
                for other in accepted
            ):
                accepted.append(split)

        # Build the tree: start with a star, insert splits largest-first.
        root = PhyloNode(index=-1)
        leaf_nodes: Dict[str, PhyloNode] = {}
        for name in sorted(taxa):
            leaf = PhyloNode(index=-1, name=name,
                             edge_length=self._mean_length(frozenset([name])))
            leaf.parent = root
            root.children.append(leaf)
            leaf_nodes[name] = leaf

        for split in sorted(accepted, key=len, reverse=True):
            # Find the current parent containing all split leaves directly.
            parent = root
            while True:
                advanced = False
                for child in parent.children:
                    if child.is_leaf():
                        continue
                    child_leaves = {l.name for l in child.leaves()}
                    if split <= child_leaves:
                        parent = child
                        advanced = True
                        break
                if not advanced:
                    break
            moved = [
                c for c in parent.children
                if {l.name for l in c.leaves()} <= split
            ]
            if len(moved) < 2:
                continue
            clade = PhyloNode(index=-1, edge_length=self._mean_length(split))
            for child in moved:
                parent.children.remove(child)
                child.parent = clade
                clade.children.append(child)
            clade.parent = parent
            parent.children.append(clade)

        tree = PhyloTree(root, sorted(taxa))
        tree.renumber()
        return tree

    def _mean_length(self, split: FrozenSet[str]) -> float:
        count = self.split_counts.get(split, 0)
        if count == 0:
            return 0.0
        return self.split_lengths[split] / count
