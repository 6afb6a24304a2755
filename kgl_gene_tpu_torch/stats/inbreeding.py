"""Inbreeding-coefficient estimation, batched over genomes on the device.

Counterpart of kgl_gene_tpu/stats/inbreeding.py, in PyTorch. Capability
parity with the reference inbreeding plugin's four algorithms
(kga_analytic/kga_inbreed/kga_analysis_inbreed_calc.h:72,113-118 and
.cpp:94-432): Ritland multi-locus, Simple (F = 1 - obs/exp heterozygosity),
Hall expectation-maximisation, and maximum log-likelihood. Every genome is
a row of a (genomes x loci) int32 zygosity tensor and each estimator works
on all rows at once, in float32 (the JAX package's default precision):

  - HallME iterates every row until its own stop test holds (|f - prev| <=
    1e-4, or 1,000 steps); a row that stopped is frozen while the others
    run on, as JAX's while_loop under vmap does.
  - Loglikelihood scans a 65-point grid of f in chunks of grid points
    (the whole (G, 65, L) grid would not fit at population size), takes
    the first best point, then refines by 40 golden-section steps.

Locus classes (kga_analysis_inbreed_freq.cpp:426-515): for each biallelic
SNP locus with minor allele frequency p (q = 1-p), a diploid genome is
MAJOR_HOMOZYGOUS (no minor allele, first-allele freq q), MAJOR_HETEROZYGOUS
(one minor, freqs p and q), or MINOR_HOMOZYGOUS (two minor, freq p).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device

__all__ = [
    "LocusData",
    "ritland_f",
    "simple_f",
    "hall_me_f",
    "loglikelihood_f",
    "inbreeding_all",
    "synthetic_diploid_population",
]

_SMALL_PROB = 1e-10
_MIN_RITLAND_FREQ = 0.001  # rare-homozygote guard (processRitlandLocus)
_EM_TOL = 1e-4
_EM_MAX_ITER = 1000
_EM_CHECK_EVERY = 8        # steps between host reads of "any row still running"
_GRID_POINTS = 65
_GOLDEN_STEPS = 40
_GRID_CHUNK_ELEMENTS = 1 << 25  # (G, chunk, L) float64 temporaries of 256 MB at most


@dataclass
class LocusData:
    """Per-genome locus classification arrays.

    zygosity: (G, L) uint8 in {0 = major hom, 1 = het, 2 = minor hom};
    minor_freq: (L,) minor allele frequency p from the super-population;
    valid: (G, L) bool mask of usable loci (frequency known, biallelic).
    """

    zygosity: np.ndarray
    minor_freq: np.ndarray
    valid: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.valid is None:
            ok = (self.minor_freq > 0.0) & (self.minor_freq < 1.0)
            self.valid = np.broadcast_to(ok, self.zygosity.shape).copy()

    @classmethod
    def from_variant_view(cls, view, minor_freq: np.ndarray) -> "LocusData":
        return cls(zygosity=np.asarray(view.zygosity), minor_freq=np.asarray(minor_freq))


def _first_allele_freq(z: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """First-allele frequency per class: hom-major -> q, het -> p, hom-minor -> p."""
    return torch.where(z == 0, 1.0 - p, p)


# --------------------------------------------------------------------------- #
# estimators: each maps (zygosity (G, L), p (L,), valid (G, L)) -> F (G,)
# --------------------------------------------------------------------------- #
def _ritland_rows(z, p, valid):
    first = _first_allele_freq(z, p)
    is_hom = (z == 0) | (z == 2)
    hom_ok = is_hom & (first > _MIN_RITLAND_FREQ) & valid
    het_ok = (z == 1) & valid
    contrib = torch.where(hom_ok, 1.0 / torch.where(hom_ok, first, 1.0) - 1.0, 0.0)
    contrib = contrib + torch.where(het_ok, -1.0, 0.0)
    count = hom_ok.sum(1) + het_ok.sum(1)
    return torch.where(count > 0, contrib.sum(1) / count, 0.0)


def _simple_rows(z, p, valid):
    q = 1.0 - p
    obs_hom = (((z == 0) | (z == 2)) & valid).sum(1)
    exp_hom = torch.where(valid, p * p + q * q, 0.0).sum(1)
    n = valid.sum(1)
    denom = n - exp_hom
    return torch.where(denom != 0, (obs_hom - exp_hom) / denom, 0.0)


def _hall_me_rows(z, p, valid):
    first = _first_allele_freq(z, p)
    is_hom = ((z == 0) | (z == 2)) & valid
    n = valid.sum(1)
    G = z.shape[0]
    f = torch.full((G,), 0.25, dtype=first.dtype, device=z.device)
    prev = torch.full((G,), 1.0, dtype=first.dtype, device=z.device)
    it = torch.zeros(G, dtype=torch.int32, device=z.device)
    active = torch.ones(G, dtype=torch.bool, device=z.device)
    for step in range(_EM_MAX_ITER):
        if step % _EM_CHECK_EVERY == 0 and not bool(active.any()):
            break
        fc = f[:, None]
        denom = fc + (1.0 - fc) * first
        term = torch.where(is_hom & (denom != 0), fc / denom, 0.0)
        new_f = torch.where(n > 0, term.sum(1) / n, 0.0)
        # a row whose stop test holds keeps its f: frozen rows do not move
        prev = torch.where(active, f, prev)
        f = torch.where(active, new_f, f)
        it = it + active.to(torch.int32)
        active = ((f - prev).abs() > _EM_TOL) & (it < _EM_MAX_ITER)
    return f


def _loglik(f, z, p, valid):
    """Log-likelihood of f (G,) per row, or of f (G, C) at C points per row,
    in the dtype of f."""
    p = p.to(f.dtype)
    first = _first_allele_freq(z, p)
    second = torch.where(z == 1, 1.0 - p, first)
    is_hom = (z == 0) | (z == 2)
    if f.dim() == 2:  # (G, C) points: broadcast over a middle axis
        f = f[:, :, None]
        first, second, is_hom, valid = (x[:, None, :] for x in (first, second, is_hom, valid))
    else:
        f = f[:, None]
    hom_prob = f * first + (1.0 - f) * first * first
    het_prob = 2.0 * (1.0 - f) * first * second
    prob = torch.where(is_hom, hom_prob, het_prob).clamp(_SMALL_PROB, 1.0)
    return torch.where(valid, torch.log(prob), 0.0).sum(-1)


def _loglik_rows(z, p, valid):
    """MLE of f in [-1, 1]: coarse grid then golden-section refinement
    (replaces the nlopt LN_NELDERMEAD call, kga_analysis_inbreed_calc.cpp:131).

    The objective is evaluated in float64. In float32 a sum of L log terms
    (about -0.6 L) carries rounding of order 1e-4 to 1e-3 at L in the
    thousands, while within a few 1e-4 of the optimum the function changes
    by less than that: two float32 sums in different orders (the JAX
    package's XLA reduction, PyTorch's on the CPU or on the card) then stop
    at points up to about 5e-4 apart. The JAX package's float32 result lies
    that far from the exact maximum itself; with x64 enabled it agrees with
    this one. Returns float32, as the other estimators."""
    G, L = z.shape
    grid = torch.linspace(-1.0, 1.0, _GRID_POINTS, dtype=torch.float64, device=z.device)
    chunk = max(1, min(_GRID_POINTS, _GRID_CHUNK_ELEMENTS // max(G * L, 1)))
    vals = torch.cat([
        _loglik(grid[c0:c0 + chunk].expand(G, -1), z, p, valid)
        for c0 in range(0, _GRID_POINTS, chunk)
    ], dim=1)
    k = torch.argmax(vals, dim=1)  # ties: the first index, as jnp.argmax
    lo = (grid[k] - 0.04).clamp(-1.0, 1.0)
    hi = (grid[k] + 0.04).clamp(-1.0, 1.0)
    gr = 0.618033988749895
    for _ in range(_GOLDEN_STEPS):
        a = hi - gr * (hi - lo)
        b = lo + gr * (hi - lo)
        b_better = _loglik(a, z, p, valid) < _loglik(b, z, p, valid)
        lo, hi = torch.where(b_better, a, lo), torch.where(b_better, hi, b)
    return ((lo + hi) / 2.0).to(torch.float32)


_ESTIMATORS = {
    "RitlandLocus": _ritland_rows,
    "Simple": _simple_rows,
    "HallME": _hall_me_rows,
    "Loglikelihood": _loglik_rows,
}


def run_estimator(algorithm: str, zygosity: torch.Tensor, minor_freq: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """F per genome (G,) float32 from device tensors: zygosity (G, L) int32,
    minor_freq (L,) float32, valid (G, L) bool."""
    with torch.no_grad():
        return _ESTIMATORS[algorithm](zygosity, minor_freq, valid)


def _estimate(algorithm: str, data: LocusData, device=None) -> np.ndarray:
    dev = resolve_device(device)
    return run_estimator(
        algorithm,
        torch.as_tensor(np.asarray(data.zygosity), device=dev).to(torch.int32),
        torch.as_tensor(np.asarray(data.minor_freq, dtype=np.float32), device=dev),
        torch.as_tensor(np.asarray(data.valid, dtype=bool), device=dev),
    ).cpu().numpy()


def ritland_f(data: LocusData, device=None) -> np.ndarray:
    return _estimate("RitlandLocus", data, device)


def simple_f(data: LocusData, device=None) -> np.ndarray:
    return _estimate("Simple", data, device)


def hall_me_f(data: LocusData, device=None) -> np.ndarray:
    return _estimate("HallME", data, device)


def loglikelihood_f(data: LocusData, device=None) -> np.ndarray:
    return _estimate("Loglikelihood", data, device)


def inbreeding_all(data: LocusData, device=None) -> Dict[str, np.ndarray]:
    """All four estimators per genome (the reference's algoMap)."""
    return {name: _estimate(name, data, device) for name in _ESTIMATORS}


# --------------------------------------------------------------------------- #
# synthetic validation data (InbreedSynthetic analogue,
# kga_analysis_inbreed_synthetic.h:56)
# --------------------------------------------------------------------------- #
def synthetic_diploid_population(
    n_genomes: int,
    n_loci: int,
    inbreeding: np.ndarray,
    seed: int = 0,
    freq_low: float = 0.05,
    freq_high: float = 0.45,
) -> LocusData:
    """Generate diploid genotypes with known per-genome inbreeding
    coefficients: with probability f the genome is IBD at a locus (genotype
    drawn as one allele), else HWE."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(freq_low, freq_high, size=n_loci)
    inbreeding = np.asarray(inbreeding, dtype=np.float64)
    z = np.zeros((n_genomes, n_loci), dtype=np.uint8)
    for g in range(n_genomes):
        f = inbreeding[g]
        ibd = rng.random(n_loci) < f
        one_draw = rng.random(n_loci) < p
        a1 = np.where(ibd, one_draw, rng.random(n_loci) < p)
        a2 = np.where(ibd, one_draw, rng.random(n_loci) < p)
        z[g] = a1.astype(np.uint8) + a2.astype(np.uint8)
    return LocusData(zygosity=z, minor_freq=p)
