"""PyTorch/CUDA port of kgl_gene_tpu for NVIDIA Hopper (H100).

The JAX package kgl_gene_tpu stays the reference; this package imports
torch and numpy only, never jax and nothing of kgl_gene_tpu. Its entry
points run on the card unless the caller passes device="cpu"; with no
card and no such request they raise.

Slice in place: the population x transcript forward step
(ops/pipeline.py make_forward_step) with hand-written CUDA kernels for
codon translation, the anti-diagonal wavefront and banded Myers
(csrc/, built by kernels/).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card by default, the CPU only
    when the caller asks for it. Raises when no card is present and the
    caller did not ask for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return torch.device("cuda")
