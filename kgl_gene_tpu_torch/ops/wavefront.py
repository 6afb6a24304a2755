"""Exact batched Levenshtein on the card: the wrapper of kernel B3.

Counterpart of kgl_gene_tpu/ops/pallas_edit_distance.py (_pallas_call and
pallas_batched_levenshtein). The CUDA kernel is csrc/wavefront.cu: one
thread block per pair, its threads across the cells of an anti-diagonal,
three diagonal buffers in shared memory. Its plain PyTorch version is
ops/edit_distance.batched_levenshtein, which a CPU tensor takes; a CUDA
tensor launches the kernel or raises.

Dropped from the TPU version: the lane-reversed b, the 128-lane width, the
BLOCK_B batch quantum and the shape bucketing.
"""

from __future__ import annotations

import torch

from .. import kernels
from .edit_distance import batched_levenshtein

__all__ = ["MAX_KERNEL_LEN", "batched_levenshtein_kernel"]

# Three int32 diagonals of Ma + 1 cells must fit one block's shared memory
# (227 KB on Hopper).
MAX_KERNEL_LEN = (227 * 1024) // 12 - 1


def batched_levenshtein_kernel(seq_a, len_a, seq_b, len_b) -> torch.Tensor:
    """Exact Levenshtein distances, (B,) int32.

    seq_a (B, Ma) int32 codes; seq_b (B, Mb) per-pair, or (1, Mb) shared by
    every pair; len_a, len_b (B,) int32 (clamped to the widths)."""
    if seq_a.device.type == "cpu":
        return batched_levenshtein(seq_a, len_a, seq_b, len_b)
    kernels.check_args(torch.int32, seq_a=seq_a, len_a=len_a, seq_b=seq_b, len_b=len_b)
    B, Ma = seq_a.shape
    if seq_b.dim() != 2 or seq_b.shape[0] not in (1, B):
        raise ValueError(f"seq_b must be ({B}, Mb) or (1, Mb), got {tuple(seq_b.shape)}")
    if len_a.shape != (B,) or len_b.shape != (B,):
        raise ValueError(f"lengths must be ({B},)")
    if Ma > MAX_KERNEL_LEN:
        raise ValueError(f"seq_a width {Ma} exceeds the kernel's {MAX_KERNEL_LEN}")
    out = torch.empty(B, dtype=torch.int32, device=seq_a.device)
    with torch.cuda.device(seq_a.device):
        kernels.launch(
            "wavefront", "kgt_wavefront",
            seq_a.data_ptr(), seq_a.stride(0), Ma,
            seq_b.data_ptr(), 0 if seq_b.shape[0] == 1 else seq_b.stride(0),
            seq_b.shape[1],
            len_a.data_ptr(), len_b.data_ptr(), out.data_ptr(), B,
        )
    return out

