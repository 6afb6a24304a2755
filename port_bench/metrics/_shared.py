"""What the readers share: device time a call from the trace, and the
operations and bytes of the distance kernels, from shapes and route only.

The count is a frozen copy of the one the port's kernel table uses
(chip_smoke.py's MYERS_OPS_PER_BLOCK_COLUMN and its B1 and `local` work):
17 word operations of 64 bits, two int32 operations each, for one 64-row
block and one text column. B1 runs its window of NB blocks over every
column; `local` runs ceil(len / 64) blocks over every column of the
longer row. A later kernel that does the same work is priced against the
same count. Bytes: each input row and length read once, each distance
written once.
"""

from __future__ import annotations

import re

from port_bench.yardstick import bound_s

__all__ = ["OPS_PER_BLOCK_COLUMN", "full_ops", "kernel_ms_per_call", "myers_window_blocks",
           "pair_bytes", "roofline_pct", "shared_text_bytes"]

OPS_PER_BLOCK_COLUMN = 34
_MYERS = re.compile(r"\bmyers\w*<(\d+)>")


def myers_window_blocks(ctx):
    """B1's window of NB blocks, read from the traced kernel's template
    argument (myers_group_kernel<NB>, myers_kernel<NB>); None unless the
    window ran B1 at exactly one NB."""
    found = {int(m.group(1)) for name in (ctx.trace.kernels if ctx.trace else ())
             for m in [_MYERS.search(name)] if m}
    return found.pop() if len(found) == 1 else None


def full_ops(pairs: int, query_len: int, text_len: int) -> int:
    return pairs * -(-query_len // 64) * text_len * OPS_PER_BLOCK_COLUMN


def shared_text_bytes(pairs: int, length: int) -> int:
    """int32 rows of every pair against one shared row, two lengths and a
    distance a pair."""
    return pairs * length * 4 + length * 4 + 3 * pairs * 4


def pair_bytes(pairs: int, length: int) -> int:
    """Two gathered int32 rows, two lengths and a distance a pair."""
    return 2 * pairs * length * 4 + 3 * pairs * 4


def kernel_ms_per_call(ctx, match):
    """Device ms a call of the traced kernels whose name match() accepts;
    None where there are none."""
    t = ctx.trace.kernel_seconds(match) if ctx.trace else 0
    return t / ctx.calls * 1e3 if t > 0 else None


def roofline_pct(ctx, match, ops_per_call, bytes_per_call):
    """The bound of a call's work over the matched kernels' time a call, in %."""
    ms = kernel_ms_per_call(ctx, match)
    return None if ms is None else 100.0 * bound_s(ops_per_call, bytes_per_call) * 1e3 / ms
