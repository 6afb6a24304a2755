"""Batched SNP application, exon splice, strand conversion and codon
translation.

Counterpart of kgl_gene_tpu/ops/variant_apply.py (apply_snp_batch,
build_splice_index, gather_splice, reverse_complement_batch,
_codon_index, translate_batch, translate_batch_pallas). Kernel B2, the
fused codon indexing and LUT lookup, is csrc/translate.cu, launched by
translate_batch_kernel; translate_batch is its plain PyTorch version,
which a CPU tensor takes.

B2 is bound by bytes (4/3 bytes per base, microseconds at any batch the
step sees), so at the step's shapes a call costs what its launch costs on
the host. The kernel streams 16 codons a thread with 16-byte loads and
stores when the rows form one aligned flat stream (S = 3k, contiguous) and
falls to a byte-wise body otherwise; the wrapper does no more than the
checks the kernel needs, one new_empty and one ctypes call.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

__all__ = [
    "apply_snp_batch",
    "build_splice_index",
    "complement_codes",
    "gather_splice",
    "last_valid_slots",
    "reverse_complement_batch",
    "translate_batch",
    "translate_batch_kernel",
    "translate_kernel_body",
]


def last_valid_slots(pos: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """keep (B, K) with every slot masked that a later kept slot at the
    same position overrides: a (B, K, K) compare, cheap at K <= 160. The
    kept positions of a row are then unique."""
    K = pos.shape[1]
    later = torch.ones(K, K, dtype=torch.bool, device=pos.device).triu(1)
    overridden = ((pos[:, :, None] == pos[:, None, :]) & keep[:, None, :] & later).any(2)
    return keep & ~overridden


def apply_snp_batch(region, positions, alt_codes, valid) -> torch.Tensor:
    """Apply per-sample SNP sets to a shared region: (B, L) uint8 codes.

    region (L,) uint8; positions (B, K) region offsets (negative ones count
    from the end, as in a JAX scatter); alt_codes (B, K); valid (B, K)
    bool. Invalid and out-of-range slots drop. Where several valid slots
    hit one position the LAST one wins, as the JAX scatter does on the
    CPU: every slot that a later valid slot at the same position
    overrides is masked first, so the scatter sees unique indices and its
    result does not depend on the order the card writes them in."""
    L = region.shape[0]
    B = positions.shape[0]
    pos = positions.to(torch.int64)
    pos = torch.where(pos < 0, pos + L, pos)
    keep = last_valid_slots(pos, valid.to(torch.bool) & (pos >= 0) & (pos < L))
    idx = torch.where(keep, pos, L)  # column L is a sink for dropped slots
    buf = torch.cat([region.to(torch.uint8), region.new_zeros(1, dtype=torch.uint8)])
    buf = buf.expand(B, L + 1).clone()
    buf.scatter_(1, idx, alt_codes.to(torch.uint8))
    return buf[:, :L]


def build_splice_index(exon_intervals: np.ndarray, region_start: int) -> np.ndarray:
    """Flat region-relative indices selecting spliced exon bases in genome
    order."""
    parts = [
        np.arange(lo - region_start, hi - region_start, dtype=np.int32)
        for lo, hi in exon_intervals
    ]
    return np.concatenate(parts) if parts else np.empty(0, dtype=np.int32)


def gather_splice(mutated: torch.Tensor, splice_index) -> torch.Tensor:
    """(B, L) x (S,) -> (B, S) spliced coding bases."""
    idx = torch.as_tensor(splice_index, dtype=torch.int64, device=mutated.device)
    return mutated[:, idx]


def complement_codes(x: torch.Tensor) -> torch.Tensor:
    """DNA5 complement (COMPLEMENT = [3, 2, 1, 0, 4]) as arithmetic, in
    int32 so that 3 - x never wraps: 3 - x for bases, identity for N."""
    x32 = x.to(torch.int32)
    return torch.where(x32 >= 4, x32, 3 - x32).to(x.dtype)


def reverse_complement_batch(coding: torch.Tensor) -> torch.Tensor:
    """(B, S) -> (B, S) reverse complement (for '-' strand transcripts)."""
    return complement_codes(torch.flip(coding, [1]))


def _codon_index(coding: torch.Tensor) -> torch.Tensor:
    """(B, 3k) base codes -> (B, k) int64 codon LUT indices (64 = holds N)."""
    B = coding.shape[0]
    k = coding.shape[1] // 3
    cod = coding[:, : 3 * k].reshape(B, k, 3).to(torch.int64)
    idx = cod[..., 0] * 16 + cod[..., 1] * 4 + cod[..., 2]
    return torch.where((cod >= 4).any(-1), 64, idx)


def translate_batch(coding: torch.Tensor, amino_lut: torch.Tensor) -> torch.Tensor:
    """Plain translation: (B, 3k) codes -> (B, k) amino codes through the
    65-entry LUT (entry 64: a codon holding N)."""
    return amino_lut[_codon_index(coding)]


def translate_batch_kernel(coding: torch.Tensor, amino_lut: torch.Tensor) -> torch.Tensor:
    """Translation through kernel B2 on the card; the plain version for a
    CPU tensor. coding (B, S) uint8 contiguous, amino_lut (65,) uint8."""
    if coding.device.type == "cpu":
        return translate_batch(coding, amino_lut)
    kernels.check_args(torch.uint8, coding=coding, amino_lut=amino_lut)
    if coding.dim() != 2 or amino_lut.shape != (65,):
        raise ValueError(
            f"expected (B, S) coding and a (65,) LUT, got {tuple(coding.shape)}, "
            f"{tuple(amino_lut.shape)}"
        )
    B, S = coding.shape
    k = S // 3
    out = coding.new_empty((B, k))
    kernels.launch(
        "translate", "kgt_translate", coding.device,
        coding.data_ptr(), coding.stride(0), B, k,
        amino_lut.data_ptr(), out.data_ptr(),
    )
    return out


def translate_kernel_body(coding: torch.Tensor) -> str:
    """Which body of kernel B2 a launch on `coding` (a CUDA tensor) takes:
    'vector' or 'scalar'. Asks the launcher's own test; launches nothing.
    An output of torch.empty is always 16-byte aligned, so 0 stands for it."""
    kernels.check_args(torch.uint8, coding=coding)
    body = kernels.library().kgt_translate_body(
        coding.data_ptr(), coding.stride(0), coding.shape[1] // 3, 0)
    return "vector" if body else "scalar"
