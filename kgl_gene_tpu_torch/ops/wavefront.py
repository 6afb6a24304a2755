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

import numpy as np
import torch

from .. import int32_on, kernels, resolve_device
from .edit_distance import batched_levenshtein

__all__ = ["MAX_KERNEL_LEN", "band_doubling", "batched_levenshtein_kernel",
           "wavefront_levenshtein"]

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


def wavefront_levenshtein(seq_a, len_a, seq_b, len_b, device=None) -> np.ndarray:
    """Host wrapper (pallas_batched_levenshtein's counterpart): numpy pairs
    in, numpy (B,) int32 exact distances out, on the card unless
    device='cpu'. seq_b may be one (1, Mb) row shared by every pair."""
    dev = resolve_device(device)
    out = batched_levenshtein_kernel(*int32_on(dev, seq_a, len_a, seq_b, len_b))
    return out.cpu().numpy()


def band_doubling(seq_a, len_a, seq_b, len_b, bands, banded, device=None) -> np.ndarray:
    """Edlib's band doubling: banded(a, la, b, lb, band_k=k) runs for each
    band of `bands` in turn on the pairs still outside the previous band's
    exactness contract (result <= k and |la - lb| <= k); what is left goes
    to the exact wavefront (kernel B3). Numpy in, numpy (B,) int32 exact
    distances out, on the card unless device='cpu'."""
    dev = resolve_device(device)
    la_np = np.asarray(len_a, dtype=np.int32)
    lb_np = np.asarray(len_b, dtype=np.int32)
    a, la, b, lb = int32_on(dev, seq_a, la_np, seq_b, lb_np)
    result = np.full(len(la_np), -1, dtype=np.int32)
    pending = np.arange(len(la_np))
    for k in bands:
        if not len(pending):
            break
        sel = torch.as_tensor(pending, device=dev)
        d = banded(a.index_select(0, sel), la.index_select(0, sel), b.index_select(0, sel),
                   lb.index_select(0, sel), band_k=k).cpu().numpy()
        ok = (d <= k) & (np.abs(la_np[pending] - lb_np[pending]) <= k)
        result[pending[ok]] = d[ok]
        pending = pending[~ok]
    if len(pending):
        result[pending] = wavefront_levenshtein(
            np.asarray(seq_a)[pending], la_np[pending],
            np.asarray(seq_b)[pending], lb_np[pending], device=dev)
    return result
