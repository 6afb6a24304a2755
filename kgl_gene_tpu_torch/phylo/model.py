"""Substitution models: GTR family Q matrices + discrete-gamma ASRV.

Capability parity with the kpl model stack (kpl_phylogenetic/kpl_model.h,
kpl_qmatrix.h / kpl_qmatrixnucleotide.h, kpl_asrv.h): JC69/K80/HKY85/GTR
nucleotide rate matrices (exchangeabilities + state frequencies,
normalised to one expected substitution per unit time), spectral transition
probabilities P(t) = V e^{Lambda t} V^{-1}, discrete-gamma
among-site-rate-variation categories (mean-one, equal-probability
category means) and proportion-invariant sites.

Copy of kgl_gene_tpu/phylo/model.py: numpy and scipy on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
from scipy import stats as _stats

__all__ = ["SubstitutionModel", "discrete_gamma_rates"]

N_STATES = 4  # A C G T


def discrete_gamma_rates(shape: float, n_categories: int) -> np.ndarray:
    """Mean-one discrete gamma category rates (mean of each quantile
    segment — Yang 1994, the kpl_asrv.h calculation)."""
    if n_categories == 1:
        return np.ones(1)
    # Category boundaries at equal probabilities.
    upper = np.arange(1, n_categories) / n_categories
    cut = _stats.gamma.ppf(upper, shape, scale=1.0 / shape)
    # Mean rate within each segment via the incomplete gamma identity:
    # E[X | a<X<b] * P = shape/rate * (F_{a+1}(b) - F_{a+1}(a)).
    bounds = np.concatenate(([0.0], cut, [np.inf]))
    upper_cdf = _stats.gamma.cdf(bounds[1:], shape + 1.0, scale=1.0 / shape)
    lower_cdf = _stats.gamma.cdf(bounds[:-1], shape + 1.0, scale=1.0 / shape)
    rates = (upper_cdf - lower_cdf) * n_categories
    return rates / rates.mean()  # exact mean-one normalisation


@dataclass
class SubstitutionModel:
    """GTR parameterisation: 6 exchangeabilities (AC, AG, AT, CG, CT, GT)
    and 4 state frequencies."""

    exchangeabilities: np.ndarray = field(
        default_factory=lambda: np.ones(6, dtype=np.float64)
    )
    frequencies: np.ndarray = field(
        default_factory=lambda: np.full(4, 0.25, dtype=np.float64)
    )
    gamma_shape: float = 1.0
    n_rate_categories: int = 1
    p_invariant: float = 0.0

    # --- named constructions ---------------------------------------------
    @classmethod
    def jc69(cls) -> "SubstitutionModel":
        return cls()

    @classmethod
    def hky85(cls, kappa: float, frequencies: np.ndarray) -> "SubstitutionModel":
        # transitions AG (index 1) and CT (index 4) get kappa.
        ex = np.array([1.0, kappa, 1.0, 1.0, kappa, 1.0])
        return cls(exchangeabilities=ex, frequencies=np.asarray(frequencies, float))

    @classmethod
    def gtr(cls, exchangeabilities, frequencies, gamma_shape: float = 1.0,
            n_rate_categories: int = 1, p_invariant: float = 0.0) -> "SubstitutionModel":
        return cls(
            np.asarray(exchangeabilities, float), np.asarray(frequencies, float),
            gamma_shape, n_rate_categories, p_invariant,
        )

    # --- Q matrix ---------------------------------------------------------
    def q_matrix(self) -> np.ndarray:
        """Normalised GTR rate matrix (one expected substitution / unit t)."""
        ex = self.exchangeabilities
        pi = self.frequencies / self.frequencies.sum()
        R = np.zeros((4, 4))
        pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
        for rate, (i, j) in zip(ex, pairs):
            R[i, j] = R[j, i] = rate
        Q = R * pi[None, :]
        np.fill_diagonal(Q, 0.0)
        np.fill_diagonal(Q, -Q.sum(axis=1))
        # Normalise: -sum_i pi_i Q_ii = 1.
        scale = -np.dot(pi, np.diag(Q))
        return Q / scale

    def eigen(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Symmetric-similarity eigendecomposition (numerically stable for
        reversible Q): returns (eigenvalues, V, V_inverse) with
        Q = V diag(lam) V^-1."""
        pi = self.frequencies / self.frequencies.sum()
        Q = self.q_matrix()
        sqrt_pi = np.sqrt(pi)
        S = Q * sqrt_pi[:, None] / sqrt_pi[None, :]
        lam, U = np.linalg.eigh((S + S.T) / 2.0)
        V = U / sqrt_pi[:, None]
        Vinv = U.T * sqrt_pi[None, :]
        return lam, V, Vinv

    def transition_matrices(self, edge_lengths: np.ndarray) -> np.ndarray:
        """P(t) for a vector of branch lengths x rate categories:
        returns (n_edges, n_rates, 4, 4)."""
        lam, V, Vinv = self.eigen()
        rates = discrete_gamma_rates(self.gamma_shape, self.n_rate_categories)
        if self.p_invariant > 0:
            rates = rates / (1.0 - self.p_invariant)
        t = np.asarray(edge_lengths, float)[:, None, None] * rates[None, :, None]
        # exp(lam * t): (edges, rates, states)
        e = np.exp(lam[None, None, :] * t)
        P = np.einsum("ik,erk,kj->erij", V, e, Vinv)
        return np.clip(P, 0.0, None)

    @property
    def rate_categories(self) -> np.ndarray:
        return discrete_gamma_rates(self.gamma_shape, self.n_rate_categories)
