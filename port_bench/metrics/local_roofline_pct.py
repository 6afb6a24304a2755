"""local_roofline_pct: kernel `local` (bitvector_kernel<K, true>, kgt_local in
csrc/wavefront.cu): every block of every column of the matrix's pairs, over
the kernel's trace time."""

from port_bench.metrics._shared import full_ops, pair_bytes, roofline_pct


def read(ctx):
    P, S = ctx.work["pairs_per_call"], ctx.work["coding_bases"]
    return roofline_pct(ctx, lambda name: "bitvector_kernel" in name and "true" in name,
                        full_ops(P, S, S), pair_bytes(P, S))
