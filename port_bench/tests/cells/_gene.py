"""What the gene drivers' cells share in their tests."""

from __future__ import annotations

import numpy as np

from port_bench import generate


def check_gene(config, region):
    """The gene's exons splice, read on its strand, to an open reading
    frame: ATG, sense codons, TAA."""
    codons = generate.coding_of(region, config).reshape(-1, 3) @ np.array([16, 4, 1])
    assert codons[0] == generate.START_CODON and codons[-1] == generate.END_CODON
    assert not np.isin(codons[1:-1], generate.STOP_CODONS).any()
