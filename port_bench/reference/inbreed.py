"""INBREED in plain PyTorch, float64: the locus selection and the four
inbreeding estimators of KGL_Gene's inbreeding analysis
(kga_analytic/kga_inbreed: kga_analysis_inbreed_args.h, _locus.h,
_calc.cpp, _freq.cpp:426-515), written from their equations. It imports
nothing of the port.

A locus is a biallelic SNP with alternate allele frequency p (q = 1 - p).
A genome is homozygous for the reference allele there (code 0; the
homozygous allele's frequency a = q), heterozygous (code 1) or homozygous
for the alternate allele (code 2; a = p). For a genome over its N loci:

  RitlandLocus  F = (sum over homozygous loci with a > 0.001 of (1/a - 1)
                - heterozygous loci) / (those homozygous loci + heterozygous
                loci), 0 where there are none;
  Simple        F = (O - E) / (N - E): O homozygous loci, E = sum (p^2 + q^2);
  HallME        the EM iteration f <- (1/N) sum over homozygous loci of
                f / (f + (1 - f) a), from f = 0.25;
  Loglikelihood the f in [-1, 1] that maximises sum over homozygous loci of
                log(f a + (1 - f) a^2) plus sum over heterozygous loci of
                log(2 (1 - f) p q), each probability held in [1e-10, 1].

Departures from the reference C++, as in the port:
  - Loglikelihood maximises by a 65-point grid over [-1, 1] (the first
    best point) and 40 golden-section steps over that point +- 0.04, in
    place of nlopt's Nelder-Mead;
  - HallME stops a genome when |f_new - f| <= 1e-4, or after 1,000 steps.

Locus selection (select_loci): the SNPs whose p lies in [MinAF, MaxAF] with
0 < p < 1 and whose offset lies in [LowerWindow, UpperWindow]; on each
contig, walking by offset, a locus is kept when it lies SamplingDistance
or more past the last one kept, and the first LociiCount kept loci stay.

The estimators work in blocks of genomes (GENOME_BLOCK columns of the
selected loci at a time), so that on the card they fit beside the program.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ESTIMATORS", "TOLERANCE", "estimators", "hall_me", "select_loci"]

ESTIMATORS = ("RitlandLocus", "Simple", "HallME", "Loglikelihood")
# How far each genome's F of a program computing in float32 (float64 for the
# Loglikelihood objective) may lie from this reference, and why:
TOLERANCE = {
    # sums of per-locus terms in float32 over up to ~10^5 loci: a few 1e-7 of
    # F; a bfloat16 sum is off by ~1e-3
    "RitlandLocus": 1e-5,
    "Simple": 1e-5,
    # the stop test: in float32 a genome's |f_new - f| may cross 1e-4 a step
    # before or after float64's, and a step there moves f by up to ~1e-4
    "HallME": 1e-3,
    # the objective in float64 and a final interval of 3e-10: ~1e-7 apart;
    # in float32 the sum of L log terms rounds by 1e-4-1e-2, and the maximum
    # moves by ~5e-4 at thousands of loci
    "Loglikelihood": 1e-4,
}
GENOME_BLOCK = 512
MIN_RITLAND_FREQ = 0.001
SMALL_PROB = 1e-10
EM_START, EM_TOL, EM_MAX_STEPS = 0.25, 1e-4, 1000
GRID_POINTS, GOLDEN_STEPS, GOLDEN_HALF_WIDTH = 65, 40, 0.04
GOLDEN = (5 ** 0.5 - 1) / 2


def _exact():
    """float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def select_loci(offsets, contigs, is_snp, af, min_af, max_af, spacing, count,
                lower=0, upper=2**62) -> np.ndarray:
    """Indices (L,) of the selected loci, in the columns' order (sorted by
    contig, then offset)."""
    af = np.nan_to_num(np.asarray(af, dtype=np.float64), nan=0.0)
    ok = (is_snp & (af >= min_af) & (af <= max_af) & (af > 0) & (af < 1)
          & (offsets >= lower) & (offsets <= upper))
    kept, contig, last, taken = [], None, 0, 0
    for i in np.flatnonzero(ok).tolist():
        if contigs[i] != contig:
            contig, last, taken = contigs[i], None, 0
        if taken < count and (last is None or offsets[i] >= last + spacing):
            kept.append(i)
            last, taken = offsets[i], taken + 1
    return np.asarray(kept, dtype=np.int64)


def _classes(codes, loci, g0, g1, dtype):
    """Indicator matrices (L, g1 - g0) of the three genotypes of genomes
    g0..g1 at the loci."""
    z = codes.index_select(0, loci)[:, g0:g1]
    return tuple((z == c).to(dtype) for c in (0, 1, 2))


def _loglik(f, hom_ref, het, hom_alt, p):
    """Log-likelihood (G,) of f (G,) for each genome."""
    q = 1.0 - p
    ref = torch.log((f * q + (1.0 - f) * q * q).clamp(SMALL_PROB, 1.0))
    alt = torch.log((f * p + (1.0 - f) * p * p).clamp(SMALL_PROB, 1.0))
    mixed = torch.log((2.0 * (1.0 - f) * p * q).clamp(SMALL_PROB, 1.0))
    return (hom_ref * ref + het * mixed + hom_alt * alt).sum(0)


def _max_loglik(hom_ref, het, hom_alt, p):
    """The grid, then golden-section steps, in the dtype of p (L, 1)."""
    q = 1.0 - p
    grid = torch.linspace(-1.0, 1.0, GRID_POINTS, dtype=p.dtype, device=p.device)
    # every genome's log-likelihood at every grid point: the log-probabilities
    # (points, L) of each class, times the genomes' indicators, summed over loci
    on_grid = 0.0
    for a_prob, member in (((grid * q + (1.0 - grid) * q * q), hom_ref),
                           ((2.0 * (1.0 - grid) * p * q), het),
                           ((grid * p + (1.0 - grid) * p * p), hom_alt)):
        on_grid = on_grid + torch.log(a_prob.clamp(SMALL_PROB, 1.0)).t() @ member
    best = grid[on_grid.argmax(0)]
    lo = (best - GOLDEN_HALF_WIDTH).clamp(-1.0, 1.0)
    hi = (best + GOLDEN_HALF_WIDTH).clamp(-1.0, 1.0)
    for _ in range(GOLDEN_STEPS):
        a = hi - GOLDEN * (hi - lo)
        b = lo + GOLDEN * (hi - lo)
        right = _loglik(a, hom_ref, het, hom_alt, p) < _loglik(b, hom_ref, het, hom_alt, p)
        lo = torch.where(right, a, lo)
        hi = torch.where(right, hi, b)
    return (lo + hi) / 2.0


def hall_me(codes, loci, af, genome_block=GENOME_BLOCK, dtype=torch.float64):
    """(F (G,), steps (G,) int64): HallME for every genome in `dtype`, each
    genome's own steps beside its F."""
    _exact()
    loci = torch.as_tensor(np.asarray(loci, dtype=np.int64), device=codes.device)
    p = torch.as_tensor(np.asarray(af, dtype=np.float64), device=codes.device)[:, None].to(dtype)
    out, steps = [], []
    for g0 in range(0, codes.shape[1], genome_block):
        hom_ref, _het, hom_alt = _classes(codes, loci, g0, g0 + genome_block, dtype)
        n = float(loci.shape[0])
        f = torch.full((hom_ref.shape[1],), EM_START, dtype=dtype, device=codes.device)
        k = torch.zeros_like(f, dtype=torch.int64)
        running = torch.ones_like(f, dtype=torch.bool)
        while bool(running.any()):
            share = (hom_ref * f / (f + (1.0 - f) * (1.0 - p))
                     + hom_alt * f / (f + (1.0 - f) * p)).sum(0)
            new = share / n if n else torch.zeros_like(f)
            k = k + running.to(torch.int64)
            moved = (new - f).abs()
            f = torch.where(running, new, f)
            running = running & (moved > EM_TOL) & (k < EM_MAX_STEPS)
        out.append(f)
        steps.append(k)
    return torch.cat(out), torch.cat(steps)


def estimators(codes, loci, af, hall=None, genome_block=GENOME_BLOCK,
               dtype=torch.float64, loglik_dtype=torch.float64):
    """F (G, 4) float64 of every genome, the columns in ESTIMATORS' order,
    from codes (V, G) uint8 on a device (variant-major), the selected loci
    (L,) and their AF (L,). hall: HallME's F (G,) where already computed.
    dtype: the precision of RitlandLocus, Simple and HallME; loglik_dtype:
    that of the Loglikelihood objective."""
    _exact()
    dev = codes.device
    loci = torch.as_tensor(np.asarray(loci, dtype=np.int64), device=dev)
    p64 = torch.as_tensor(np.asarray(af, dtype=np.float64), device=dev)
    if hall is None:
        hall = hall_me(codes, loci.cpu().numpy(), af, genome_block, dtype)[0]
    p, q = p64.to(dtype), (1.0 - p64).to(dtype)
    # each class's per-locus Ritland term: 1/a - 1 where a > 0.001, else no locus
    r_ref, r_alt = ((1.0 / a - 1.0) * (a > MIN_RITLAND_FREQ) for a in (q, p))
    c_ref, c_alt = ((a > MIN_RITLAND_FREQ).to(dtype) for a in (q, p))
    expected = (p * p + q * q).sum()
    n = float(loci.shape[0])
    columns = []
    for g0 in range(0, codes.shape[1], genome_block):
        hom_ref, het, hom_alt = _classes(codes, loci, g0, g0 + genome_block, dtype)
        ritland_sum = r_ref @ hom_ref + r_alt @ hom_alt - het.sum(0)
        ritland_n = c_ref @ hom_ref + c_alt @ hom_alt + het.sum(0)
        ritland = torch.where(ritland_n > 0, ritland_sum / ritland_n.clamp(min=1.0), 0.0)
        observed = hom_ref.sum(0) + hom_alt.sum(0)
        simple = torch.where(n != expected, (observed - expected) / (n - expected), 0.0)
        low = tuple(m.to(loglik_dtype) for m in (hom_ref, het, hom_alt))
        loglik = _max_loglik(*low, p64.to(loglik_dtype)[:, None]).to(torch.float64)
        columns.append(torch.stack([x.to(torch.float64) for x in (
            ritland, simple, hall[g0:g0 + genome_block].to(dev), loglik)], dim=1))
    return torch.cat(columns)
