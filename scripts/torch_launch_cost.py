"""What one kernel launch of the port costs on the host, piece by piece.

    python3 scripts/torch_launch_cost.py

Kernel B2 at the step's shape, (256, 3,000) uint8, runs a few microseconds
on the card, so a call costs what the host spends issuing it. This script
times, in host microseconds per call (a host clock around a few hundred
calls, the pieces taking turns over many rounds), each piece a wrapper
pays: the argument checks, the output's torch.empty, the device switch,
the stream lookup both ways, the ctypes call with and without a launch
behind it. Then the whole B2 wrapper, the launch path as it was before it was shortened (rebuilt here
from the same pieces: per-call import, getattr on the library, a
torch.cuda.device context around every launch, torch.cuda.current_stream),
and lut[idx], the nearest single PyTorch call. Needs a CUDA device.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import nvidia_smi_line  # noqa: E402
from kgl_gene_tpu_torch import kernels  # noqa: E402
from kgl_gene_tpu_torch.ops.myers import myers_distance_padded  # noqa: E402
from kgl_gene_tpu_torch.ops.variant_apply import _codon_index, translate_batch_kernel  # noqa: E402
from kgl_gene_tpu_torch.sequence.tables import amino_translation_table  # noqa: E402

CALLS = 300
ROUNDS = 21


def host_us(pieces):
    """name -> (least, median) over ROUNDS of the mean host microseconds
    of one call. The host's cores are shared and its speed shifts within a
    run, so the pieces take turns, CALLS calls each per round: every piece
    meets the same mix of fast and slow moments. The least round is the
    steadier reading; the median shows what a caller met in this run."""
    for piece in pieces.values():
        for _ in range(50):
            piece()
    per = {name: [] for name in pieces}
    for _ in range(ROUNDS):
        for name, piece in pieces.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                piece()
            per[name].append((time.perf_counter() - t0) / CALLS * 1e6)
    torch.cuda.synchronize()
    return {name: (min(v), statistics.median(v)) for name, v in per.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {nvidia_smi_line()}; torch {torch.__version__}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    B, S = 256, 3000
    k = S // 3
    coding = torch.as_tensor(rng.integers(0, 4, size=(B, S)).astype(np.uint8), device=dev)
    lut = torch.as_tensor(amino_translation_table().amino_lut, device=dev)
    idx = _codon_index(coding)
    out = torch.empty((B, k), dtype=torch.uint8, device=dev)
    lib = kernels.library()
    fn = lib.kgt_translate
    small = torch.zeros((8, 64), dtype=torch.int32, device=dev)
    small_len = torch.full((8,), 64, dtype=torch.int32, device=dev)

    def imported():
        import torch  # noqa: F401

    def earlier_path():
        kernels.check_args(torch.uint8, coding=coding, amino_lut=lut)
        o = torch.empty(B, k, dtype=torch.uint8, device=coding.device)
        with torch.cuda.device(coding.device):
            import torch as t

            getattr(kernels.library(), "kgt_translate")(
                coding.data_ptr(), coding.stride(0), B, k, lut.data_ptr(), o.data_ptr(),
                t.cuda.current_stream().cuda_stream)
        return o

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    pieces = {
        "import torch inside a function": imported,
        "getattr(library(), name)": lambda: getattr(kernels.library(), "kgt_translate"),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "with torch.cuda.device(dev): pass": device_ctx,
        "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "kernels.current_stream_handle(0)": lambda: kernels.current_stream_handle(0),
        "check_args on two tensors": lambda: kernels.check_args(torch.uint8, coding=coding, amino_lut=lut),
        "torch.empty((256, 1000), uint8)": lambda: torch.empty((B, k), dtype=torch.uint8, device=dev),
        "coding.new_empty((256, 1000))": lambda: coding.new_empty((B, k)),
        "three data_ptr() and a stride()": lambda: (coding.data_ptr(), lut.data_ptr(), out.data_ptr(),
                                                     coding.stride(0)),
        "ctypes call, no launch behind it (B = 0)": lambda: fn(
            coding.data_ptr(), S, 0, k, lut.data_ptr(), out.data_ptr(), 0),
        "ctypes call with the launch": lambda: fn(
            coding.data_ptr(), S, B, k, lut.data_ptr(), out.data_ptr(),
            kernels.current_stream_handle(0)),
        "translate_batch_kernel, whole wrapper": lambda: translate_batch_kernel(coding, lut),
        "the launch path before it was shortened": earlier_path,
        "lut[idx] (int64 index ready)": lambda: lut[idx],
        "myers_distance_padded, whole wrapper (B = 8, S = 64)": lambda: myers_distance_padded(
            small, small_len, small[:1], small_len, band_k=31),
    }
    print("   least   median  (host us per call)")
    for name, (least, median) in host_us(pieces).items():
        print(f"  {least:7.3f}  {median:7.3f}  {name}")
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
