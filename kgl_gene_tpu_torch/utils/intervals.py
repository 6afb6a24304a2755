"""Right-open interval algebra ``[lower, upper)``.

Capability parity with the reference interval machinery
(kel_utility/kel_interval_type.h:45, kel_interval_unsigned.h:36,
kel_interval_set.h / kel_interval_map.h) used throughout the genome feature
model and the mutation engine. Re-designed with NumPy-friendly helpers so
batched interval work (exon splice maps, density bins) can be expressed as
array ops.

Copy of kgl_gene_tpu/utils/intervals.py.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional

import numpy as np

__all__ = ["OpenRightInterval", "IntervalSet", "intervals_to_array"]


@dataclass(frozen=True, order=True)
class OpenRightInterval:
    """Immutable right-open interval [lower, upper); lower <= upper."""

    lower: int
    upper: int

    def __post_init__(self):
        if self.lower > self.upper:
            raise ValueError(f"invalid interval [{self.lower}, {self.upper})")

    # --- basic properties -------------------------------------------------
    @property
    def size(self) -> int:
        return self.upper - self.lower

    def empty(self) -> bool:
        return self.size == 0

    def __contains__(self, offset: int) -> bool:
        return self.lower <= offset < self.upper

    # --- set relations ----------------------------------------------------
    def contains_interval(self, other: "OpenRightInterval") -> bool:
        """True if other is wholly within self (empty intervals contained if
        their point lies within)."""
        if other.empty():
            return self.lower <= other.lower <= self.upper
        return self.lower <= other.lower and other.upper <= self.upper

    def intersects(self, other: "OpenRightInterval") -> bool:
        return max(self.lower, other.lower) < min(self.upper, other.upper)

    def disjoint(self, other: "OpenRightInterval") -> bool:
        return not self.intersects(other)

    def adjacent(self, other: "OpenRightInterval") -> bool:
        return self.upper == other.lower or other.upper == self.lower

    def intersection(self, other: "OpenRightInterval") -> "OpenRightInterval":
        lo = max(self.lower, other.lower)
        hi = min(self.upper, other.upper)
        if lo >= hi:
            return OpenRightInterval(lo, lo)  # empty at lo
        return OpenRightInterval(lo, hi)

    def merge(self, other: "OpenRightInterval") -> "OpenRightInterval":
        """Union hull of two intersecting/adjacent intervals."""
        if not (self.intersects(other) or self.adjacent(other)):
            raise ValueError(f"cannot merge disjoint {self} and {other}")
        return OpenRightInterval(min(self.lower, other.lower), max(self.upper, other.upper))

    def translate(self, shift: int) -> "OpenRightInterval":
        return OpenRightInterval(self.lower + shift, self.upper + shift)

    def __repr__(self):
        return f"[{self.lower}, {self.upper})"


class IntervalSet:
    """Ordered set of disjoint-or-not intervals sorted by (lower, upper).

    Mirrors IntervalSetLower (kel_interval_set.h): supports membership,
    lower-bound style queries, and finding all intervals intersecting a probe
    interval (the exon/feature lookup primitive).
    """

    def __init__(self, intervals: Iterable[OpenRightInterval] = ()):  # noqa: D401
        self._intervals: list[OpenRightInterval] = sorted(intervals)
        self._lowers = [iv.lower for iv in self._intervals]

    def __len__(self) -> int:
        return len(self._intervals)

    def __iter__(self) -> Iterator[OpenRightInterval]:
        return iter(self._intervals)

    def __contains__(self, interval: OpenRightInterval) -> bool:
        i = bisect.bisect_left(self._intervals, interval)
        return i < len(self._intervals) and self._intervals[i] == interval

    def add(self, interval: OpenRightInterval) -> None:
        i = bisect.bisect_left(self._intervals, interval)
        self._intervals.insert(i, interval)
        self._lowers.insert(i, interval.lower)

    def containing_point(self, offset: int) -> list[OpenRightInterval]:
        """All intervals containing the point offset."""
        return [iv for iv in self._candidates(offset, offset + 1) if offset in iv]

    def intersecting(self, probe: OpenRightInterval) -> list[OpenRightInterval]:
        """All intervals intersecting the probe interval."""
        return [iv for iv in self._candidates(probe.lower, probe.upper) if iv.intersects(probe)]

    def containing(self, probe: OpenRightInterval) -> Optional[OpenRightInterval]:
        """The first interval wholly containing probe, if any."""
        for iv in self._candidates(probe.lower, probe.upper):
            if iv.contains_interval(probe):
                return iv
        return None

    def _candidates(self, lo: int, hi: int) -> Iterator[OpenRightInterval]:
        # Intervals are sorted by lower; any interval with lower >= hi cannot
        # intersect. Intervals with smaller lower may still reach past lo, so
        # scan left-bounded by a max-span heuristic: we simply scan from the
        # start when the set is small, else use the sorted structure with an
        # upper-bound cut. Feature sets per contig are typically small enough.
        end = bisect.bisect_left(self._lowers, hi)
        return iter(self._intervals[:end])

    def union_size(self) -> int:
        """Total covered size of the union of all intervals."""
        total = 0
        cur_lo = cur_hi = None
        for iv in self._intervals:
            if iv.empty():
                continue
            if cur_hi is None or iv.lower > cur_hi:
                if cur_hi is not None:
                    total += cur_hi - cur_lo
                cur_lo, cur_hi = iv.lower, iv.upper
            else:
                cur_hi = max(cur_hi, iv.upper)
        if cur_hi is not None:
            total += cur_hi - cur_lo
        return total


def intervals_to_array(intervals: Iterable[OpenRightInterval]) -> np.ndarray:
    """Pack intervals into an (n, 2) int64 array [[lower, upper), ...] —
    the device-side representation for batched interval kernels."""
    return np.array([(iv.lower, iv.upper) for iv in intervals], dtype=np.int64).reshape(-1, 2)
