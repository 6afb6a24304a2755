"""b1_roofline_pct: kernel B1 (csrc/myers.cu), its call's work bound over its
trace time: every genome against the shared gene in a step, or every pair of
the per-pair pool in a matrix, over the NB blocks of B1's window."""

from port_bench.metrics._shared import (
    OPS_PER_BLOCK_COLUMN, myers_window_blocks, pair_bytes, roofline_pct, shared_text_bytes,
)


def read(ctx):
    nb = myers_window_blocks(ctx)
    if nb is None:
        return None
    w = ctx.work
    S = w["coding_bases"]
    if "genomes_per_call" in w:
        n, nbytes = w["genomes_per_call"], shared_text_bytes(w["genomes_per_call"], S)
    else:
        n, nbytes = w["pairs_per_call"], pair_bytes(w["pairs_per_call"], S)
    return roofline_pct(ctx, lambda name: "myers" in name, n * S * nb * OPS_PER_BLOCK_COLUMN,
                        nbytes)
