"""Codon substitution model (Goldman-Yang / Muse-Gaut M0 style).

Capability parity with the kpl codon Q-matrix (kpl_qmatrixcodon.h and the
omega updater kpl_mcmc_omega.h): 61 sense-codon states (standard code,
stops excluded), instantaneous rates non-zero only between codons differing
at ONE position, scaled by kappa for transitions and omega (dN/dS) for
non-synonymous changes, codon frequencies from the stationary distribution.
The transition probabilities are a 61x61 spectral exponential.

Copy of kgl_gene_tpu/phylo/codon.py: numpy on the host, on the port's
sequence.alphabet and sequence.tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from ..sequence.alphabet import AminoAcid
from ..sequence.tables import amino_translation_table

__all__ = ["CodonSubstitutionModel", "codon_states", "codon_alignment",
           "codon_log_likelihood"]

_TRANSITIONS = {(0, 2), (2, 0), (1, 3), (3, 1)}  # A<->G, C<->T


def codon_states() -> Tuple[np.ndarray, np.ndarray]:
    """(sense codon indices (61,), amino codes (61,)) for the standard
    code (stop codons excluded)."""
    table = amino_translation_table("NCBI_TABLE_1")
    sense = np.array([i for i in range(64) if not table.stop_lut[i]], dtype=np.int32)
    amino = table.amino_lut[sense]
    return sense, amino


@dataclass
class CodonSubstitutionModel:
    kappa: float = 2.0            # transition/transversion rate ratio
    omega: float = 0.2            # dN/dS
    frequencies: Optional[np.ndarray] = None  # (61,) codon frequencies

    def __post_init__(self):
        self.sense, self.amino = codon_states()
        self.n_states = len(self.sense)  # 61
        if self.frequencies is None:
            self.frequencies = np.full(self.n_states, 1.0 / self.n_states)
        self.state_of_codon = np.full(65, -1, dtype=np.int32)
        for s, codon in enumerate(self.sense):
            self.state_of_codon[codon] = s

    # ------------------------------------------------------------------ #
    def q_matrix(self) -> np.ndarray:
        n = self.n_states
        pi = self.frequencies / self.frequencies.sum()
        Q = np.zeros((n, n))
        bases = [(c // 16, (c // 4) % 4, c % 4) for c in self.sense]
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                bi, bj = bases[i], bases[j]
                diffs = [(a, b) for a, b in zip(bi, bj) if a != b]
                if len(diffs) != 1:
                    continue
                rate = pi[j]
                if (diffs[0][0], diffs[0][1]) in _TRANSITIONS:
                    rate *= self.kappa
                if self.amino[i] != self.amino[j]:
                    rate *= self.omega
                Q[i, j] = rate
        np.fill_diagonal(Q, -Q.sum(axis=1))
        scale = -np.dot(pi, np.diag(Q))
        return Q / scale if scale > 0 else Q

    def eigen(self):
        pi = self.frequencies / self.frequencies.sum()
        Q = self.q_matrix()
        sqrt_pi = np.sqrt(pi)
        S = Q * sqrt_pi[:, None] / sqrt_pi[None, :]
        lam, U = np.linalg.eigh((S + S.T) / 2.0)
        V = U / sqrt_pi[:, None]
        Vinv = U.T * sqrt_pi[None, :]
        return lam, V, Vinv

    def transition_matrix(self, t: float) -> np.ndarray:
        lam, V, Vinv = self.eigen()
        return np.clip(V @ np.diag(np.exp(lam * t)) @ Vinv, 0.0, None)


def codon_alignment(dna_codes: np.ndarray, model: CodonSubstitutionModel) -> np.ndarray:
    """(taxa, 3k) DNA codes -> (taxa, k) codon-state indices; any codon
    containing N or mapping to a stop becomes the ambiguity state -1."""
    from ..sequence.tables import codon_indices

    n_taxa = dna_codes.shape[0]
    k = dna_codes.shape[1] // 3
    out = np.full((n_taxa, k), -1, dtype=np.int32)
    for t in range(n_taxa):
        idx = codon_indices(dna_codes[t, : 3 * k])
        valid = idx < 64
        states = np.where(valid, model.state_of_codon[np.clip(idx, 0, 64)], -1)
        out[t] = states
    return out


def codon_log_likelihood(tree, codon_states_matrix: np.ndarray,
                         model: CodonSubstitutionModel) -> float:
    """Felsenstein pruning over 61 codon states (host path; the einsum per
    edge is a (sites, 61) x (61, 61) matmul)."""
    arrays = tree.traversal_arrays()
    n = model.n_states
    n_sites = codon_states_matrix.shape[1]
    partials = np.ones((arrays["n_nodes"], n_sites, n))
    eye = np.eye(n)
    for leaf in range(tree.n_leaves):
        states = codon_states_matrix[leaf]
        tip = np.where(states[:, None] >= 0, eye[np.clip(states, 0, n - 1)], 1.0)
        partials[leaf] = tip
    for k in range(arrays["n_internals"]):
        node = arrays["internal_index"][k]
        acc = np.ones((n_sites, n))
        for c in range(arrays["child_index"].shape[1]):
            child = arrays["child_index"][k, c]
            if child < 0:
                continue
            P = model.transition_matrix(arrays["child_edge"][k, c])
            acc = acc * (partials[child] @ P.T)
        partials[node] = acc
    pi = model.frequencies / model.frequencies.sum()
    site_like = partials[arrays["root_index"]] @ pi
    return float(np.sum(np.log(np.maximum(site_like, 1e-300))))
