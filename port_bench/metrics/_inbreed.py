"""What the estimators' readers share: the work of an INBREED call, from its
shapes and the reference's step counts only, so that any implementation
of the four estimators is priced against the same work.

Bytes: the (G, L) uint8 codes of the selected loci read once for each pass
the algorithms' dependencies force: one for the sums that need no iterate
(RitlandLocus, Simple) and the Loglikelihood grid, one for each
golden-section step (its two points read together), one for each HallME
step the reference needs (its slowest genome's, reference/inbreed.py
hall_me); with each pass the loci's AF (float32) and, for an iterate, the
genomes' f read and written (float64); each estimator's F written once
(float32). Operations: the Loglikelihood's float64 terms, a genome at a
locus at a point (65 grid points, two a golden-section step), at
LOGLIK_TERM_OPS each, against the card's FP64 rate.
"""

from __future__ import annotations

from port_bench.metrics._spans import device_ms
from port_bench.yardstick import HBM_BYTES_PER_S

__all__ = ["ESTIMATOR_SPANS", "FP64_OPS_PER_S", "bound_s", "call_bytes", "call_ops",
           "roofline_pct"]

# NVIDIA's H100 SXM data sheet: FP64 outside the tensor cores, 700 W.
FP64_OPS_PER_S = 34e12
GRID_POINTS, GOLDEN_STEPS = 65, 40
# the hom or het probability (5 multiplies and adds), its clamp (2), the
# log (counted as one), the class select and the sum: a floor
LOGLIK_TERM_OPS = 10
ESTIMATOR_SPANS = ("kgt.inbreed.ritland", "kgt.inbreed.simple", "kgt.inbreed.hallme",
                   "kgt.inbreed.loglik")
ESTIMATORS = 4


def call_bytes(genomes: int, loci: int, hallme_steps: int) -> int:
    iterated = GOLDEN_STEPS + hallme_steps
    passes = 1 + iterated
    return (passes * (genomes * loci + 4 * loci) + iterated * 2 * 8 * genomes
            + ESTIMATORS * 4 * genomes)


def call_ops(genomes: int, loci: int) -> int:
    return (GRID_POINTS + 2 * GOLDEN_STEPS) * genomes * loci * LOGLIK_TERM_OPS


def bound_s(genomes: int, loci: int, hallme_steps: int) -> float:
    return max(call_ops(genomes, loci) / FP64_OPS_PER_S,
               call_bytes(genomes, loci, hallme_steps) / HBM_BYTES_PER_S)


def roofline_pct(ctx):
    """The mean bound of the window's calls (the sets cycled from the first)
    over the four estimators' device time a call, in %; None where the
    window holds no estimator span or the work lacks the reference's steps."""
    steps = ctx.work.get("reference_hallme_steps")
    ms = device_ms(ctx, ESTIMATOR_SPANS.__contains__)
    if not steps or not ms:
        return None
    G, L = ctx.work["genomes_per_call"], ctx.work["loci_per_call"]
    bound = sum(bound_s(G, L, steps[i % len(steps)]) for i in range(ctx.calls)) / ctx.calls
    return 100.0 * bound * 1e3 / ms
