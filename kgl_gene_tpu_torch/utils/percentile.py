"""Running percentile container (kel_math/kel_percentile.h parity):
accumulate (value, payload) pairs, query percentile values/payloads and
quantile ranks over the sorted distribution.

Copy of kgl_gene_tpu/utils/percentile.py.
"""

from __future__ import annotations

import bisect
from typing import Generic, List, Optional, Tuple, TypeVar

__all__ = ["Percentile"]

T = TypeVar("T")


class Percentile(Generic[T]):
    def __init__(self):
        self._items: List[Tuple[float, T]] = []
        self._sorted = True

    def add_element(self, value: float, payload: T = None) -> None:
        self._items.append((float(value), payload))
        self._sorted = False

    def _ensure_sorted(self):
        if not self._sorted:
            self._items.sort(key=lambda t: t[0])
            self._sorted = True

    def __len__(self):
        return len(self._items)

    def percentile(self, fraction: float) -> Optional[Tuple[float, T]]:
        """The element at the given percentile fraction [0, 1]."""
        if not self._items:
            return None
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("percentile fraction must be in [0, 1]")
        self._ensure_sorted()
        index = min(int(fraction * len(self._items)), len(self._items) - 1)
        return self._items[index]

    def percentile_range(self, lower: float, upper: float) -> List[Tuple[float, T]]:
        """Elements between two percentile fractions."""
        if not self._items:
            return []
        self._ensure_sorted()
        lo = min(int(lower * len(self._items)), len(self._items))
        hi = min(int(upper * len(self._items)), len(self._items))
        return self._items[lo:hi]

    def rank(self, value: float) -> float:
        """Quantile rank of a value in [0, 1]."""
        if not self._items:
            return 0.0
        self._ensure_sorted()
        idx = bisect.bisect_right([v for v, _ in self._items], value)
        return idx / len(self._items)
