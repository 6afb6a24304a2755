"""Statistical distributions and RNG facade.

Capability parity with kel_math/kel_distribution.h:26-260: deterministic
and entropy seeding, Uniform/Normal/LogNormal/Gamma/Beta/Binomial/
NegativeBinomial/Poisson samplers, and the pdf/cdf/quantile accessors the
analytics use (hypergeometric for enrichment, normal for z-scores, beta-
binomial for allele models). Sampling is numpy Generator based host-side.

Copy of kgl_gene_tpu/utils/distributions.py.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
from scipy import stats as _stats

__all__ = [
    "RandomEntropySource",
    "DeterministicSource",
    "UniformUnitDistribution",
    "UniformRealDistribution",
    "UniformIntegerDistribution",
    "NormalDistribution",
    "StdNormalDistribution",
    "LogNormalDistribution",
    "GammaDistribution",
    "BetaDistribution",
    "BinomialDistribution",
    "NegativeBinomialDistribution",
    "PoissonDistribution",
    "HypergeometricDistribution",
]


class RandomEntropySource:
    """OS-entropy seeded generator (RandomEntropySource)."""

    def __init__(self):
        self._gen = np.random.default_rng()

    def generator(self) -> np.random.Generator:
        return self._gen


class DeterministicSource:
    """Deterministically seeded generator (DeterministicEntropySource)."""

    def __init__(self, seed: int = 0):
        self._gen = np.random.default_rng(seed)

    def generator(self) -> np.random.Generator:
        return self._gen


class _Distribution:
    def random(self, generator: np.random.Generator):
        raise NotImplementedError


class UniformUnitDistribution(_Distribution):
    """U[0, 1)."""

    def random(self, generator):
        return float(generator.random())


class UniformRealDistribution(_Distribution):
    def __init__(self, upper: float, lower: float):
        self.lower, self.upper = sorted((lower, upper))

    def random(self, generator):
        return float(generator.uniform(self.lower, self.upper))


class UniformIntegerDistribution(_Distribution):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def random(self, generator):
        return int(generator.integers(self.lower, self.upper + 1))


class NormalDistribution(_Distribution):
    def __init__(self, mean: float, std_deviation: float):
        self.mean = mean
        self.std = std_deviation

    def random(self, generator):
        return float(generator.normal(self.mean, self.std))

    def pdf(self, x: float) -> float:
        return float(_stats.norm.pdf(x, self.mean, self.std))

    def cdf(self, x: float) -> float:
        return float(_stats.norm.cdf(x, self.mean, self.std))

    def quantile(self, p: float) -> float:
        return float(_stats.norm.ppf(p, self.mean, self.std))


class StdNormalDistribution(NormalDistribution):
    def __init__(self):
        super().__init__(0.0, 1.0)


class LogNormalDistribution(_Distribution):
    def __init__(self, mean: float, std_deviation: float):
        self.mean, self.std = mean, std_deviation

    def random(self, generator):
        return float(generator.lognormal(self.mean, self.std))

    def pdf(self, x):
        return float(_stats.lognorm.pdf(x, self.std, scale=math.exp(self.mean)))

    def cdf(self, x):
        return float(_stats.lognorm.cdf(x, self.std, scale=math.exp(self.mean)))


class GammaDistribution(_Distribution):
    def __init__(self, shape: float, scale: float):
        self.shape, self.scale = shape, scale

    def random(self, generator):
        return float(generator.gamma(self.shape, self.scale))

    def pdf(self, x):
        return float(_stats.gamma.pdf(x, self.shape, scale=self.scale))

    def cdf(self, x):
        return float(_stats.gamma.cdf(x, self.shape, scale=self.scale))

    def quantile(self, p):
        return float(_stats.gamma.ppf(p, self.shape, scale=self.scale))


class BetaDistribution(_Distribution):
    def __init__(self, a: float, b: float):
        self.a, self.b = a, b

    def random(self, generator):
        return float(generator.beta(self.a, self.b))

    def pdf(self, x):
        return float(_stats.beta.pdf(x, self.a, self.b))

    def cdf(self, x):
        return float(_stats.beta.cdf(x, self.a, self.b))


class BinomialDistribution(_Distribution):
    def __init__(self, trials: int, prob_success: float):
        self.n, self.p = trials, prob_success

    def random(self, generator):
        return int(generator.binomial(self.n, self.p))

    def pdf(self, k: int) -> float:
        return float(_stats.binom.pmf(k, self.n, self.p))

    def cdf(self, k: int) -> float:
        return float(_stats.binom.cdf(k, self.n, self.p))


class NegativeBinomialDistribution(_Distribution):
    def __init__(self, successes: float, prob_success: float):
        self.r, self.p = successes, prob_success

    def random(self, generator):
        return int(generator.negative_binomial(self.r, self.p))

    def pdf(self, k: int) -> float:
        return float(_stats.nbinom.pmf(k, self.r, self.p))


class PoissonDistribution(_Distribution):
    def __init__(self, lam: float):
        self.lam = lam

    def random(self, generator):
        return int(generator.poisson(self.lam))

    def pdf(self, k: int) -> float:
        return float(_stats.poisson.pmf(k, self.lam))


class HypergeometricDistribution:
    """Hypergeometric pmf/cdf/upper-tail — the enrichment-significance
    primitive (kol_EnrichmentTools.h:58 uses this via kel_math)."""

    def __init__(self, K: int, n: int, N: int):
        """K successes in population, n draws, N population size."""
        self.K, self.n, self.N = K, n, N

    def pdf(self, k: int) -> float:
        return float(_stats.hypergeom.pmf(k, self.N, self.K, self.n))

    def cdf(self, k: int) -> float:
        return float(_stats.hypergeom.cdf(k, self.N, self.K, self.n))

    def upper_tail(self, k: int) -> float:
        """P(X >= k) — enrichment p-value."""
        return float(_stats.hypergeom.sf(k - 1, self.N, self.K, self.n))
