"""Banded Levenshtein by rows: kernels B5 (distance) and B4 (traceback codes).

Counterpart of kgl_gene_tpu/ops/pallas_banded.py (banded_levenshtein,
banded_pairs_device, adaptive_banded_levenshtein, MAX_BAND and the two
Pallas kernels). The CUDA kernels are csrc/banded.cu; banded_plain and
banded_choices_plain below are their plain PyTorch versions, with the same
band layout and the same arithmetic, so each pair agrees bit for bit. On a
CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernel or raise.

B4 and B5 each have two bodies, chosen by their launchers from the band
alone (banded_choices_kernel_body and banded_kernel_body say which). Up to
band 255 a warp holds a pair, each lane 2 to 16 consecutive band cells in
registers: the insertion chain is a serial prefix-min inside the lane, a
three-round warp scan of the lanes' last values and a combine, with no
block barrier in the row loop. It is one kernel for both: B4's codes of a
row are made while the next row's scan is in flight and leave through a
shared-memory stage in 16-byte stores; B5 compiles the codes out and
keeps only the last row's cell lb - la + k. Bands 256 to 511 keep one
thread per band cell and a block per pair. On the card B4's codes lie pair by pair (a pair's rows
contiguous, the pair pitch a multiple of 16 bytes) and banded_choices
returns the (M, B, 2k+1) view of that buffer, which ops/traceback.tb_walk
reads by its strides.

Band layout: cell c = j - i + k of row i holds D[i][j], over exactly 2k+1
cells. The TPU's 128-lane padding, its `lead` sentinel pad of b
(band_layout) and its BLOCK_B pair quantum are gone, and rows and columns
stop at each pair's own la and lb, so pad values are never compared.

Exactness contract: a banded distance equals the true distance iff it is
<= k and |la - lb| <= k. Pairs with |la - lb| > k return max(la, lb), which
is >= the true distance and > k (the JAX kernel returns 0 there, below the
true distance; only its adaptive wrapper's length test hid that).
Inside the contract every cell on an optimal path holds a value <= k in
both layouts, so the traceback codes the walk reads agree with the JAX
kernel's even though its band reaches further to the right.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import int32_on, kernels, resolve_device
from .edit_distance import gathered_pairs
from .wavefront import band_doubling

__all__ = [
    "MAX_BAND",
    "adaptive_banded_levenshtein",
    "banded_choices",
    "banded_choices_kernel_body",
    "banded_choices_plain",
    "banded_distance",
    "banded_kernel_body",
    "banded_levenshtein",
    "banded_pairs_device",
    "banded_plain",
]

MAX_BAND = 511  # 2k+1 <= 1023 cells: one thread per cell in the block body
BIG = 1 << 29   # out-of-band value, as in csrc/banded.cu
RUN_CAP = 252   # match runs saturate so that code = run + 2 <= 255


def _check_band(band_k: int) -> None:
    if not 0 <= band_k <= MAX_BAND:
        raise ValueError(f"band_k must be in [0, {MAX_BAND}]; use the exact kernel beyond")


def _band_rows(a, la, b, lb, band_k: int):
    """Yield (i, cur, diag, up, cost, valid) for rows i = 1..max(la): the
    row DP of both kernels over (B, 2k+1) band cells. `diag` and `up` are
    the candidates prev[c] + cost and prev[c+1] + 1; `cur` is the row."""
    B = a.shape[0]
    dev = a.device
    k = band_k
    W = 2 * k + 1
    c_idx = torch.arange(W, dtype=torch.int64, device=dev)
    lbc = lb[:, None]
    j0 = c_idx - k
    prev = torch.where((j0 >= 0) & (j0 <= lbc), j0, BIG)
    big_col = torch.full((B, 1), BIG, dtype=torch.int64, device=dev)
    a64 = a.to(torch.int64)
    # An empty b (every lb = 0) gets one column, which no valid cell reads.
    b64 = b.to(torch.int64) if b.shape[1] else torch.zeros((B, 1), dtype=torch.int64, device=dev)
    rows = int(la.max()) if B else 0
    for i in range(1, rows + 1):
        j = i - k + c_idx
        valid = (j >= 0) & (j <= lbc)
        bj = b64.gather(1, (j - 1).clamp(0, b64.shape[1] - 1).expand(B, W))
        cost = torch.where(valid & (j >= 1), (a64[:, i - 1 : i] != bj).to(torch.int64), 1)
        up = torch.cat([prev[:, 1:], big_col], 1) + 1
        diag = prev + cost
        base = torch.minimum(up, diag)
        base = torch.where(j == 0, i, base)
        base = torch.where(valid, base, BIG)
        cur = torch.cummin(base - c_idx, dim=1).values + c_idx
        cur = torch.where(valid, cur, BIG)
        yield i, cur, diag, up, cost, valid
        prev = cur


def _clamped_lengths(a, la, b, lb):
    return (la.to(torch.int64).clamp(0, a.shape[1]),
            lb.to(torch.int64).clamp(0, b.shape[1]))


def banded_plain(a, la, b, lb, band_k: int) -> torch.Tensor:
    """Plain PyTorch banded distance (the plain version of kernel B5):
    a (B, Wa), b (B, Wb) codes, la, lb (B,) lengths (clamped to the
    widths). Returns (B,) int32."""
    _check_band(band_k)
    la, lb = _clamped_lengths(a, la, b, lb)
    B = a.shape[0]
    result = torch.zeros(B, dtype=torch.int64, device=a.device)
    cap = (lb - la + band_k).clamp(0, 2 * band_k)[:, None]
    for i, cur, *_ in _band_rows(a, la, b, lb, band_k):
        result = torch.where(la == i, cur.gather(1, cap)[:, 0], result)
    result = torch.where(la == 0, lb, result)
    result = torch.where((la - lb).abs() > band_k, torch.maximum(la, lb), result)
    return result.to(torch.int32)


def banded_choices_plain(a, la, b, lb, band_k: int, rows: int) -> torch.Tensor:
    """Plain PyTorch traceback codes (the plain version of kernel B4):
    (rows, B, 2k+1) uint8, row i - 1 holding the codes of DP row i; cells
    out of the band, past lb or in rows past la are 0. rows must be >= every
    clamped la."""
    _check_band(band_k)
    la, lb = _clamped_lengths(a, la, b, lb)
    B = a.shape[0]
    W = 2 * band_k + 1
    if B and int(la.max()) > rows:
        raise ValueError(f"rows {rows} < max la {int(la.max())}")
    codes = torch.zeros((rows, B, W), dtype=torch.uint8, device=a.device)
    run = torch.zeros((B, W), dtype=torch.int64, device=a.device)
    for i, cur, diag, up, cost, valid in _band_rows(a, la, b, lb, band_k):
        is_diag = cur == diag
        is_match = is_diag & (cost == 0)
        run = torch.where(valid & is_match, run.clamp(max=RUN_CAP) + 1, 0)
        code = torch.where(is_match, run + 2,
                           torch.where(is_diag, 2, torch.where(cur == up, 1, 0)))
        code = torch.where(valid & (la[:, None] >= i), code, 0)
        codes[i - 1] = code.to(torch.uint8)
    return codes


def _check_pairs(a, la, b, lb) -> int:
    kernels.check_args(torch.int32, a=a, la=la, b=b, lb=lb)
    B = a.shape[0]
    if a.dim() != 2 or b.dim() != 2 or b.shape[0] != B:
        raise ValueError(f"a and b must be (B, W) with one row per pair, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if la.shape != (B,) or lb.shape != (B,):
        raise ValueError(f"la, lb must be ({B},), got {tuple(la.shape)}, {tuple(lb.shape)}")
    return B


BODIES = ("block", "warp")


def banded_kernel_body(band_k: int) -> str:
    """Which body of kernel B5 a launch at band_k takes: 'warp' (a pair a
    warp, a lane several cells) or 'block' (a pair a block, a thread a
    cell). Asks the launcher's own rule; launches nothing."""
    _check_band(band_k)
    return BODIES[kernels.library().kgt_banded_body(band_k)]


def banded_distance(a, la, b, lb, *, band_k: int, _body: str | None = None) -> torch.Tensor:
    """Banded distances, (B,) int32: a (B, Wa) and b (B, Wb) int32 codes,
    la, lb (B,) int32. On the card this launches kernel B5. _body names the
    kernel's body ('warp' or 'block') for measurements that hold one beside
    the other; callers leave it to the launcher's rule."""
    _check_band(band_k)
    if a.device.type == "cpu":
        return banded_plain(a, la, b, lb, band_k)
    B = _check_pairs(a, la, b, lb)
    out = la.new_empty(B)
    kernels.launch(
        "banded", "kgt_banded", a.device,
        a.data_ptr(), a.stride(0), a.shape[1], b.data_ptr(), b.stride(0), b.shape[1],
        la.data_ptr(), lb.data_ptr(), out.data_ptr(), B, band_k,
        -1 if _body is None else BODIES.index(_body),
    )
    return out


def banded_choices_kernel_body(band_k: int) -> str:
    """Which body of kernel B4 a launch at band_k takes: 'warp' (a pair a
    warp, a lane several cells) or 'block' (a pair a block, a thread a
    cell). Asks the launcher's own rule; launches nothing."""
    _check_band(band_k)
    return BODIES[kernels.library().kgt_banded_choices_body(band_k)]


def banded_choices(a, la, b, lb, *, band_k: int, _body: str | None = None) -> torch.Tensor:
    """Traceback codes, (max(Wa, 1), B, 2k+1) uint8: a (B, Wa) and b (B, Wb)
    int32 codes, la, lb (B,) int32. On the card this launches kernel B4 and
    returns a view, not contiguous, of a buffer that holds the codes pair
    by pair. _body names the kernel's body ('warp' or 'block') for
    measurements that hold one beside the other; callers leave it to the
    launcher's rule."""
    _check_band(band_k)
    rows = max(a.shape[1], 1)
    if a.device.type == "cpu":
        return banded_choices_plain(a, la, b, lb, band_k, rows)
    B = _check_pairs(a, la, b, lb)
    W = 2 * band_k + 1
    pitch = -(-rows * W // 16) * 16
    buf = torch.empty((B, pitch), dtype=torch.uint8, device=a.device)
    kernels.launch(
        "banded_choices", "kgt_banded_choices", a.device,
        a.data_ptr(), a.stride(0), a.shape[1], b.data_ptr(), b.stride(0), b.shape[1],
        la.data_ptr(), lb.data_ptr(), buf.data_ptr(), pitch, B, rows, band_k,
        -1 if _body is None else BODIES.index(_body),
    )
    return buf.as_strided((rows, B, W), (W, pitch, 1))


def banded_levenshtein(seq_a, len_a, seq_b, len_b, band_k: int = 63,
                       device=None) -> np.ndarray:
    """Host wrapper: numpy pairs in, numpy (B,) int32 banded distances out,
    on the card unless device='cpu'."""
    dev = resolve_device(device)
    return banded_distance(*int32_on(dev, seq_a, len_a, seq_b, len_b),
                           band_k=band_k).cpu().numpy()


def banded_pairs_device(seqs_dev, lens_dev, iu, ju, band_k: int = 63,
                        uniform_cap: bool = False) -> np.ndarray:
    """Banded distances for an index-pair batch over a sequence pool on
    its device: rows iu and ju are gathered there, in chunks, and only
    the indices cross from the host. uniform_cap promises that every
    length equals the pool's width (the JAX kernel's specialisation); it
    is checked, and the results are the same either way."""
    if uniform_cap and bool((lens_dev != seqs_dev.shape[1]).any()):
        raise ValueError("uniform_cap: every length must equal the pool width")
    return gathered_pairs(functools.partial(banded_distance, band_k=band_k),
                          seqs_dev, lens_dev, iu, ju)


def adaptive_banded_levenshtein(seq_a, len_a, seq_b, len_b, start_k: int = 63,
                                max_band: int = MAX_BAND, device=None) -> np.ndarray:
    """Edlib's band doubling on kernel B5: pairs outside the contract re-run
    at 2k+1 up to max_band, and what is left goes to the exact wavefront
    (kernel B3). Exact for every pair."""
    bands = [start_k]
    while bands[-1] < max_band:
        bands.append(min(2 * bands[-1] + 1, max_band))
    return band_doubling(seq_a, len_a, seq_b, len_b, [k for k in bands if k <= max_band],
                         banded_distance, device)
