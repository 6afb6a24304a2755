"""The population x transcript forward step.

Counterpart of kgl_gene_tpu/ops/pipeline.py (ForwardOutputs, _forward,
make_forward_step). For a batch of sample genomes against one transcript:
  1. apply each sample's SNPs to the region,
  2. splice the exons and convert the strand,
  3. translate the codons (kernel B2),
  4. compute each mutant's edit distance to the reference coding sequence
     (kernel B1, banded Myers, when the SNP budget bounds the band and the
     transcript is long; kernel B3, the exact wavefront, otherwise),
  5. derive the validity code and the allele counts.

On the card every kernel launches; on the CPU each wrapper runs its plain
PyTorch version, which is how the tests hold the step against the JAX one.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..sequence.alphabet import AminoAcid
from ..sequence.tables import amino_translation_table
from .myers import myers_band_for, myers_distance_padded
from .variant_apply import apply_snp_batch, complement_codes, translate_batch_kernel
from .wavefront import batched_levenshtein_kernel

__all__ = ["ForwardOutputs", "forward", "make_forward_step"]

# The banded distance pays off only on long transcripts.
MIN_BANDED_LEN = 512


class ForwardOutputs(NamedTuple):
    mutated_coding: torch.Tensor  # (B, S) uint8 spliced mutated coding codes
    amino: torch.Tensor           # (B, S//3) uint8 amino codes
    distance: torch.Tensor        # (B,) int32 edit distance mutant vs reference
    allele_counts: torch.Tensor   # (K,) int32 alt allele counts over the batch
    valid_protein: torch.Tensor   # (B,) bool: start, stop, no internal stop
    validity_code: torch.Tensor   # (B,) int32: 0 valid / 1 no-stop / 2 nonsense / 3 no-start


def _splice_slices(batch: torch.Tensor, exon_starts: Sequence[int],
                   exon_lens: Sequence[int]) -> torch.Tensor:
    """Contiguous-exon splice: a concat of slices. A start is clamped so
    its slice fits, as a dynamic slice clamps."""
    L = batch.shape[1]
    parts = []
    for s, n in zip(exon_starts, exon_lens):
        s = min(max(int(s), 0), L - n)
        parts.append(batch[:, s : s + n])
    return parts[0] if len(parts) == 1 else torch.cat(parts, 1)


def forward(
    region: torch.Tensor,          # (L,) uint8 reference region codes
    exon_starts: Sequence[int],    # region-relative exon starts
    exon_lens: Sequence[int],      # exon lengths (sum = S)
    reverse_strand: bool,
    positions: torch.Tensor,       # (B, K) region-relative SNP positions
    alt_codes: torch.Tensor,       # (B, K)
    valid: torch.Tensor,           # (B, K) bool
    amino_lut: torch.Tensor,       # (65,) uint8
    stop_code: int,
    start_codes: torch.Tensor,     # amino codes acceptable at position 0
) -> ForwardOutputs:
    mutated = apply_snp_batch(region, positions, alt_codes, valid)
    coding = _splice_slices(mutated, exon_starts, exon_lens)
    ref_coding = _splice_slices(region[None, :], exon_starts, exon_lens)
    if reverse_strand:
        coding = complement_codes(torch.flip(coding, [1]))
        ref_coding = complement_codes(torch.flip(ref_coding, [1]))
    coding = coding.contiguous()
    amino = translate_batch_kernel(coding, amino_lut)

    B, S = coding.shape
    lens = torch.full((B,), S, dtype=torch.int32, device=coding.device)
    a = coding.to(torch.int32)
    b = ref_coding.to(torch.int32).contiguous()
    # Every variant is a substitution, so Levenshtein <= Hamming <= K and
    # the lengths are equal: a band >= K provably holds the distance.
    band_k = myers_band_for(positions.shape[1], max_band=127)
    if band_k and S >= MIN_BANDED_LEN:
        distance = myers_distance_padded(a, lens, b, lens, band_k=band_k)
    else:
        distance = batched_levenshtein_kernel(a, lens, b, lens)

    # Validity: starts with a start amino, ends with stop, no internal stop.
    starts_ok = torch.isin(amino[:, 0], start_codes)
    ends_ok = amino[:, -1] == stop_code
    internal_stops = (amino[:, :-1] == stop_code).sum(1)
    valid_protein = starts_ok & ends_ok & (internal_stops == 0)
    # 0 VALID_PROTEIN, 1 NO_STOP_CODON, 2 NONSENSE_MUTATION, 3 NO_START_CODON,
    # the highest applicable code winning.
    validity_code = torch.maximum(
        torch.maximum((~ends_ok).to(torch.int32), 2 * (internal_stops > 0).to(torch.int32)),
        3 * (~starts_ok).to(torch.int32),
    )
    allele_counts = valid.to(torch.int32).sum(0, dtype=torch.int32)
    return ForwardOutputs(
        mutated_coding=coding, amino=amino, distance=distance,
        allele_counts=allele_counts, valid_protein=valid_protein,
        validity_code=validity_code,
    )


def make_forward_step(
    region_codes: np.ndarray,
    exon_intervals: np.ndarray,
    region_start: int,
    reverse_strand: bool = False,
    table_name: str = "NCBI_TABLE_1",
    device=None,
):
    """A forward step closed over one transcript's geometry.

    step(positions, alt_codes, valid) -> ForwardOutputs, with numpy arrays
    or tensors in and tensors on `device` out. The step runs on the card
    unless device='cpu'."""
    dev = resolve_device(device)
    table = amino_translation_table(table_name)
    exon_intervals = np.asarray(exon_intervals, dtype=np.int64)
    exon_starts = [int(lo - region_start) for lo, _hi in exon_intervals]
    exon_lens = [int(hi - lo) for lo, hi in exon_intervals]
    region = torch.as_tensor(np.asarray(region_codes, dtype=np.uint8), device=dev)
    amino_lut = torch.as_tensor(table.amino_lut, dtype=torch.uint8, device=dev)
    start_codes = torch.as_tensor(table.start_codes(), dtype=torch.uint8, device=dev)

    def step(positions, alt_codes, valid) -> ForwardOutputs:
        return forward(
            region, exon_starts, exon_lens, reverse_strand,
            torch.as_tensor(positions, device=dev),
            torch.as_tensor(alt_codes, device=dev),
            torch.as_tensor(valid, device=dev),
            amino_lut, AminoAcid.STOP, start_codes,
        )

    return step
