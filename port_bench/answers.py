"""Every answer of a window, held once per distinct value: each input set's
distinct answers (tuples of arrays) with the number of calls that returned
each, so that the reference judges every call's answer after the window."""

from __future__ import annotations

import numpy as np

__all__ = ["Answers"]


class Answers:
    def __init__(self, n_sets: int):
        self.by_set = [[] for _ in range(n_sets)]  # [answer, calls] pairs

    def add(self, s: int, answer: tuple) -> None:
        for entry in self.by_set[s]:
            if all(np.array_equal(a, b) for a, b in zip(answer, entry[0])):
                entry[1] += 1
                return
        self.by_set[s].append([answer, 1])
