"""The port's entry point: the forward step at a small example shape.

Counterpart of __graft_entry__.entry (and its _example_geometry and
_example_batch): a 240 bp region whose two exons splice to 120 coding
bases, 8 genomes and 6 SNP slots each.
"""

from __future__ import annotations

import numpy as np

from .ops.pipeline import make_forward_step

__all__ = ["entry", "example_batch", "example_geometry"]


def example_geometry():
    """Tiny deterministic transcript geometry: (region codes, exon intervals)."""
    rng = np.random.default_rng(0)
    region = rng.integers(0, 4, size=240).astype(np.uint8)
    exon_intervals = np.array([[20, 80], [120, 180]], dtype=np.int64)
    return region, exon_intervals


def example_batch(batch: int, n_snps: int, L: int, seed: int = 1):
    """(positions, alt_codes, valid) for `batch` genomes with `n_snps`
    slots each, 70% of them valid."""
    rng = np.random.default_rng(seed)
    positions = rng.integers(0, L, size=(batch, n_snps)).astype(np.int32)
    alt_codes = rng.integers(0, 4, size=(batch, n_snps)).astype(np.uint8)
    valid = rng.random((batch, n_snps)) < 0.7
    return positions, alt_codes, valid


def entry(device=None):
    """(step, example_args): the forward step and its example inputs, on
    the card unless device='cpu'."""
    region, exons = example_geometry()
    step = make_forward_step(region, exons, region_start=0, reverse_strand=False,
                             device=device)
    return step, example_batch(8, 6, len(region))
