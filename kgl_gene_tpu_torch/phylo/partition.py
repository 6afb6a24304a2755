"""Data partitions: per-subset substitution models with relative rates.

Capability parity with the kpl partition/subset machinery
(kpl_partition.h, kpl_model.h subset structure, and the subset
relative-rate updater kpl_mcmc_subset.h): sites are assigned to subsets
(e.g. by codon position or by gene), each subset has its own substitution
model, and subset relative rates (site-weighted mean 1) scale the branch
lengths per subset. The partition log likelihood is the sum of subset
likelihoods — each an independent batched pruning, so subsets parallelise
trivially on device.

Copy of kgl_gene_tpu/phylo/partition.py: numpy on the host, on the host
log_likelihood of phylo/likelihood.py.
"""

from __future__ import annotations

import math
import random as _random
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from .likelihood import log_likelihood
from .model import SubstitutionModel
from .tree import PhyloTree

__all__ = ["PartitionSubset", "PartitionModel", "partition_log_likelihood",
           "update_subset_relrates"]


@dataclass
class PartitionSubset:
    name: str
    site_indices: np.ndarray          # columns of the alignment in this subset
    model: SubstitutionModel = field(default_factory=SubstitutionModel)


class PartitionModel:
    def __init__(self, subsets: List[PartitionSubset],
                 relative_rates: Optional[Sequence[float]] = None):
        self.subsets = subsets
        if relative_rates is None:
            relative_rates = np.ones(len(subsets))
        self.relative_rates = np.asarray(relative_rates, dtype=np.float64)
        self._normalise()

    # --- relative rates: site-weighted mean must equal 1 ------------------
    def _site_weights(self) -> np.ndarray:
        sizes = np.array([len(s.site_indices) for s in self.subsets], dtype=np.float64)
        return sizes / sizes.sum()

    def _normalise(self) -> None:
        weights = self._site_weights()
        mean = float(np.sum(weights * self.relative_rates))
        if mean > 0:
            self.relative_rates = self.relative_rates / mean

    @classmethod
    def by_codon_position(cls, n_sites: int,
                          models: Optional[List[SubstitutionModel]] = None
                          ) -> "PartitionModel":
        """The classic first/second/third codon-position partition."""
        subsets = []
        for p in range(3):
            sites = np.arange(p, n_sites, 3)
            model = models[p] if models else SubstitutionModel()
            subsets.append(PartitionSubset(f"codon{p + 1}", sites, model))
        return cls(subsets)

    def copy(self) -> "PartitionModel":
        subsets = [
            PartitionSubset(
                s.name, s.site_indices,
                SubstitutionModel(
                    s.model.exchangeabilities.copy(), s.model.frequencies.copy(),
                    s.model.gamma_shape, s.model.n_rate_categories,
                    s.model.p_invariant,
                ),
            )
            for s in self.subsets
        ]
        return PartitionModel(subsets, self.relative_rates.copy())


def _scaled_tree(tree: PhyloTree, rate: float) -> PhyloTree:
    scaled = tree.copy()
    for node in scaled.edges():
        node.edge_length *= rate
    return scaled


def partition_log_likelihood(tree: PhyloTree, alignment: np.ndarray,
                             partition: PartitionModel) -> float:
    """Sum of per-subset likelihoods with relrate-scaled branch lengths."""
    total = 0.0
    for subset, rate in zip(partition.subsets, partition.relative_rates):
        if len(subset.site_indices) == 0:
            continue
        sub_alignment = alignment[:, subset.site_indices]
        total += log_likelihood(_scaled_tree(tree, float(rate)), sub_alignment,
                                subset.model)
    return total


def update_subset_relrates(tree: PhyloTree, alignment: np.ndarray,
                           partition: PartitionModel, current_loglike: float,
                           rng: Optional[_random.Random] = None,
                           window: float = 0.3):
    """One Metropolis update of the subset relative rates
    (kpl_mcmc_subset.h): multiplicative proposal on one subset's rate, then
    renormalise to site-weighted mean 1. Returns (partition, loglike,
    accepted)."""
    rng = rng or _random.Random(0)
    proposal = partition.copy()
    k = rng.randrange(len(proposal.subsets))
    factor = math.exp(window * (rng.random() - 0.5))
    proposal.relative_rates[k] *= factor
    proposal._normalise()
    proposal_like = partition_log_likelihood(tree, alignment, proposal)
    log_ratio = proposal_like - current_loglike + math.log(factor)
    if math.log(rng.random() + 1e-300) < log_ratio:
        return proposal, proposal_like, True
    return partition, current_loglike, False
