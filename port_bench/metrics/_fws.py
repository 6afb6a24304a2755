"""What the PfEMP statistics readers share: the work of a call, from its
shapes only, so that any implementation is priced against the same work.

Bytes: the (V, G_sub) uint8 codes of the call's genomes read once; each
variant's heterozygous and homozygous counts written once (int32); each
genome's 11 bins' two counts and its two totals (int32), its hs_sum and
FWS (float64) written once. The arithmetic is a few operations a byte, far
under the card's rate: the bound is the bytes'.

The G_sub x V read assumes the subset's codes lie together. The program
holds every genome's codes in one (V, G) layout, where a scattered subset
(the cell's qc_monoclonal, 65% of the genomes) touches nearly every 32-byte
sector of a row, so its reads cost nearly G x V bytes: on that set the
share cannot approach 100%, and the qc set's calls show the distance to
the floor.
"""

from __future__ import annotations

from port_bench.metrics._spans import device_ms
from port_bench.yardstick import HBM_BYTES_PER_S

__all__ = ["SPANS", "call_bytes", "device_ms_per_call", "roofline_pct"]

SPANS = ("kgt.fws.variants", "kgt.fws.genomes")
BINS = 11


def call_bytes(genomes: int, variants: int) -> int:
    return genomes * variants + 2 * 4 * variants + genomes * ((2 * BINS + 2) * 4 + 2 * 8)


def device_ms_per_call(ctx):
    return device_ms(ctx, SPANS.__contains__)


def roofline_pct(ctx):
    """The mean bound of the window's calls (the sets cycled from the first)
    over the device time a call of the two stages, in %; None where the
    window holds neither span."""
    ms = device_ms_per_call(ctx)
    per_set = ctx.work.get("genomes_per_set")
    if not ms or not per_set:
        return None
    V = ctx.work["variants"]
    bound = sum(call_bytes(per_set[i % len(per_set)], V)
                for i in range(ctx.calls)) / ctx.calls / HBM_BYTES_PER_S
    return 100.0 * bound * 1e3 / ms
