"""Regex motif search over sequence text returning intervals
(kel_utility/kel_search.h:15 Search::searchView parity). Used by the
sequence-motif (promoter/TFBS) analytics.

Copy of kgl_gene_tpu/utils/search.py.
"""

from __future__ import annotations

import re
from typing import List, Pattern, Union

from .intervals import OpenRightInterval

__all__ = ["search_view"]


def search_view(pattern: Union[str, Pattern], sequence_text: str) -> List[OpenRightInterval]:
    """All (possibly overlapping) match intervals of the regex in the text."""
    regex = re.compile(pattern) if isinstance(pattern, str) else pattern
    intervals: List[OpenRightInterval] = []
    pos = 0
    while True:
        match = regex.search(sequence_text, pos)
        if match is None:
            break
        start, end = match.span()
        if end == start:  # zero-width safety
            pos = start + 1
            continue
        intervals.append(OpenRightInterval(start, end))
        pos = start + 1  # allow overlapping matches
    return intervals
