"""The table of peaks and the arithmetic the readers share.

Peaks are NVIDIA's published figures for one H100 SXM at its 700 W limit:
67 TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of HBM3. The
kernels the benchmark prices do integer work; no int32 rate is published
outside the tensor cores, so the float32 rate stands in, which makes each
bound a floor (Hopper issues int32 at half that rate).
"""

from __future__ import annotations

import numpy as np

__all__ = ["HBM_BYTES_PER_S", "OPS_PER_S", "bound_s", "p95"]

OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of the operation
    floor and the byte floor."""
    return max(ops / OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def p95(values) -> float:
    """95th percentile (linear interpolation) over every value."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))
