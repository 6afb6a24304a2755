"""The Simple inbreeding estimator in plain numpy float64, every locus
valid: F = (observed - expected homozygous loci) / (loci - expected),
expected = sum of p^2 + q^2 (kga_analysis_inbreed_calc.cpp)."""

from __future__ import annotations

import numpy as np


def simple_f(zygosity: np.ndarray, minor_freq: np.ndarray) -> np.ndarray:
    p = np.asarray(minor_freq, dtype=np.float64)
    expected = float((p * p + (1.0 - p) * (1.0 - p)).sum())
    observed = ((zygosity == 0) | (zygosity == 2)).sum(1).astype(np.float64)
    return (observed - expected) / (zygosity.shape[1] - expected)
