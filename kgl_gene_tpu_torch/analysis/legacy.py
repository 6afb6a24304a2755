"""Edit items between two sequences by a full host DP, and their CIGAR.

Counterpart of kgl_gene_tpu/analysis/legacy.py (EditItem,
compare_sequences, edit_items_to_cigar): the exact host fallback of the
batched traceback (ops/traceback.batched_cigar) for pairs outside every
band. Host numpy; the sequences are DNA5 code arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..sequence.alphabet import DNA5

__all__ = ["EditItem", "compare_sequences", "edit_items_to_cigar"]


@dataclass(frozen=True)
class EditItem:
    """One edit: reference offset, operation, bases involved."""

    operation: str  # 'X' substitute, 'D' delete, 'I' insert
    reference_offset: int
    reference_char: str = ""
    mutant_char: str = ""


def compare_sequences(reference: np.ndarray, mutant: np.ndarray) -> List[EditItem]:
    """Minimal edit script between two DNA5 code arrays by a full DP and
    its traceback, ties taken diagonal first, then deletion, then
    insertion. O(n*m) on the host."""
    a = np.asarray(reference)
    b = np.asarray(mutant)
    n, m = len(a), len(b)
    dp = np.zeros((n + 1, m + 1), dtype=np.int32)
    dp[:, 0] = np.arange(n + 1)
    dp[0, :] = np.arange(m + 1)
    js = np.arange(1, m + 1)
    for i in range(1, n + 1):
        cost = (b != a[i - 1]).astype(np.int32)
        base = np.minimum(dp[i - 1, 1:] + 1, dp[i - 1, :-1] + cost)
        dp[i, 1:] = np.minimum.accumulate(np.minimum(base, dp[i, 0] + js) - js) + js
    items: List[EditItem] = []
    i, j = n, m
    ref_chars = DNA5.to_string(a)
    mut_chars = DNA5.to_string(b)
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (a[i - 1] != b[j - 1]):
            if a[i - 1] != b[j - 1]:
                items.append(EditItem("X", i - 1, ref_chars[i - 1], mut_chars[j - 1]))
            i -= 1
            j -= 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            items.append(EditItem("D", i - 1, ref_chars[i - 1], ""))
            i -= 1
        else:
            items.append(EditItem("I", i, "", mut_chars[j - 1]))
            j -= 1
    items.reverse()
    return items


def edit_items_to_cigar(items: List[EditItem], reference_length: int) -> str:
    """Compact CIGAR-like string: runs of M between edit operations."""
    out = []
    pos = 0
    run = 0

    def flush_match():
        nonlocal run
        if run:
            out.append(f"{run}M")
            run = 0

    i = 0
    while i < len(items):
        item = items[i]
        gap = item.reference_offset - pos
        if gap > 0:
            run += gap
            pos = item.reference_offset
        flush_match()
        # Group consecutive same-op items at strictly adjacent offsets (X/D
        # advance the reference; I items at one insertion point share an
        # offset), so run lengths sum to the reference length as the
        # batched traceback's run-length code does.
        op = item.operation
        count = 1
        while i + 1 < len(items) and items[i + 1].operation == op and (
            items[i + 1].reference_offset == (
                item.reference_offset if op == "I" else pos + count
            )
        ):
            count += 1
            i += 1
        out.append(f"{count}{op}")
        if op in ("X", "D"):
            pos += count
        i += 1
    if reference_length > pos:
        out.append(f"{reference_length - pos}M")
    return "".join(out)
