"""Banded Levenshtein by the Myers/Hyyro bit-vector recurrence (kernel B1).

Counterpart of kgl_gene_tpu/ops/pallas_myers.py (myers_distance_padded,
myers_banded_levenshtein, myers_band_for, MYERS_BANDS, _myers_layout,
myers_pairs_device and adaptive_myers_levenshtein).
The CUDA kernel is csrc/myers.cu; myers_plain below is its plain PyTorch
version, with the same 64-row block layout and the same band window, so
the two agree bit for bit on every input. On a CPU tensor the wrapper runs
the plain version; on a CUDA tensor it launches the kernel or raises.

The kernel has two bodies, chosen by its launcher from the shapes alone
(myers_kernel_body says which). Launches that one thread a pair does not
fill the card with (the forward step's few hundred to few thousand pairs,
and up to 32,768 pairs at bands to 127) are bound by one pair's dependence
chain, so a pair is spread over a group of NB lanes of a warp: each lane
owns one block of the window, takes eight text columns a step one step
behind the lane above, whose carries come by a warp shuffle, and the
ownership rotates as the window slides; the Peq words sit in shared
memory, built once per pair, and D[la][lb] is read down column lb by
popcounts at the end. More pairs than that are bound by the rate the card
issues integer operations at, and keep one thread per pair with the window
in registers.

Exactness contract (as in the JAX kernel): the result is >= the true
distance, and equal to it iff result <= band_k and |la - lb| <= band_k.
Pairs with |la - lb| > band_k return max(la, lb). Outside the contract the
64-row window may give other overestimates than the JAX kernel's 32-row
one. Codes are DNA5 (0..4); any other code matches nothing. Lengths are
clamped to the array widths.

Dropped from the TPU version: the bit-plane pack on the matrix unit
(_pack_planes, also the pool's Peq pack in the all-pairs driver), the
1,024-pair padding and the optimization barrier.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import int32_on, kernels, resolve_device
from .edit_distance import gathered_pairs
from .wavefront import WORD, band_doubling, block_step, pack_words

__all__ = [
    "MYERS_BANDS",
    "adaptive_myers_levenshtein",
    "myers_band_for",
    "myers_banded_levenshtein",
    "myers_distance_padded",
    "myers_layout",
    "myers_kernel_body",
    "myers_pairs_device",
    "myers_plain",
]

MYERS_BANDS = (31, 63, 127, 255, 511)


def myers_layout(band_k: int):
    """(shift, NB) for a band: shift = ceil(band_k / 64) blocks of slack on
    each side, and an NB = 2*shift + 1 block window."""
    if band_k not in MYERS_BANDS:
        raise ValueError(f"band_k must be one of {MYERS_BANDS}, got {band_k}")
    shift = (band_k + WORD - 1) // WORD
    return shift, 2 * shift + 1


def myers_band_for(bound: int, max_band: int = 511):
    """Smallest Myers band covering an edit bound, or None when the bound
    exceeds max_band."""
    for k in MYERS_BANDS:
        if k > max_band:
            break
        if bound <= k:
            return k
    return None


def myers_plain(a, la, text, lb, band_k: int) -> torch.Tensor:
    """Plain PyTorch banded Myers: a (B, Wa) pattern codes, la (B,), text
    (1 or B, Wt) codes, lb (B,). Returns (B,) int32. Works in int64, where
    `+` wraps like the kernel's unsigned add and carry-out bits are taken
    as (x >> 63) & 1."""
    shift, NB = myers_layout(band_k)
    B, Wa = a.shape
    dev = a.device
    la = la.to(torch.int64).clamp(0, Wa)
    lb = lb.to(torch.int64).clamp(0, text.shape[1])
    L = int(lb.max()) if B else 0
    n_blk = max((L + WORD - 1) // WORD - shift - 1, 0) + NB

    # Peq words (B, n_blk, 6): one word per DNA5 symbol plus an all-zero
    # slot 5 for codes that match nothing; rows >= la match nothing.
    rows = n_blk * WORD
    codes = torch.full((B, rows), -1, dtype=torch.int64, device=dev)
    w = min(Wa, rows)
    codes[:, :w] = a[:, :w].to(torch.int64)
    idx = torch.arange(rows, device=dev)
    codes = torch.where(idx[None, :] < la[:, None], codes, -1)
    codes = codes.view(B, n_blk, WORD)
    peq = torch.stack(
        [pack_words(codes == s) for s in range(5)]
        + [torch.zeros(B, n_blk, dtype=torch.int64, device=dev)],
        dim=2,
    )
    tcodes = text.to(torch.int64)
    tcodes = torch.where((tcodes >= 0) & (tcodes < 5), tcodes, 5)

    one = torch.ones(B, dtype=torch.int64, device=dev)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    vp = [torch.full((B,), -1, dtype=torch.int64, device=dev) for _ in range(NB)]
    vn = [zero.clone() for _ in range(NB)]
    la_blk = torch.where(la > 0, (la - 1) >> 6, -1)
    la_pos = (la - 1) & 63
    score = la.clone()
    result = la.clone()  # lb = 0 pairs
    for j in range(1, L + 1):
        g = (j - 1) // WORD
        wb = max(g - shift, 0)
        if g > shift and (j - 1) % WORD == 0:
            vp = vp[1:] + [torch.full((B,), -1, dtype=torch.int64, device=dev)]
            vn = vn[1:] + [zero.clone()]
        c = tcodes[:, j - 1]
        slot = la_blk - wb
        ph_in, mh_in = one, zero
        ph_sel, mh_sel = zero, zero
        for t in range(NB):
            win = peq[:, wb + t, :]
            eq = win[:, c[0]] if c.shape[0] == 1 else win.gather(1, c[:, None])[:, 0]
            ph, mh, vp[t], vn[t], ph_in, mh_in = block_step(eq, vp[t], vn[t], ph_in, mh_in)
            in_slot = slot == t
            ph_sel = torch.where(in_slot, ph, ph_sel)
            mh_sel = torch.where(in_slot, mh, mh_sel)
        bit_delta = ((ph_sel >> la_pos) & 1) - ((mh_sel >> la_pos) & 1)
        delta = torch.where(
            slot < 0, 1, torch.where(slot < NB, bit_delta, ph_in - mh_in)
        )
        score = score + delta
        result = torch.where(lb == j, score, result)
    result = torch.where((la - lb).abs() > band_k, torch.maximum(la, lb), result)
    return result.to(torch.int32)


BODIES = ("thread", "group")


def myers_kernel_body(B: int, Wa: int, Wb: int, band_k: int) -> str:
    """Which body of kernel B1 a launch of B pairs at widths (Wa, Wb) takes:
    'group' (a pair over NB lanes of a warp) or 'thread' (a pair a thread).
    Asks the launcher's own rule; launches nothing."""
    myers_layout(band_k)
    return BODIES[kernels.library().kgt_myers_body(B, Wa, Wb, band_k)]


def myers_distance_padded(a, la, b, lb, *, band_k: int, _body: str | None = None):
    """Banded Myers distances, the distance stage of the forward step.

    a: (B, Wa) int32 codes; la, lb: (B,) int32; b: (B, Wb) per-pair texts,
    or (1, Wb), one text shared by every pair (the mutant-vs-reference
    step, the JAX version's shared_b mode). On the card this launches
    kernel B1; the name is the JAX function's, though the pair axis is no
    longer padded. _body names the kernel's body ('group' or 'thread') for
    measurements that hold one beside the other; callers leave it to the
    launcher's rule."""
    myers_layout(band_k)
    if a.device.type == "cpu":
        return myers_plain(a, la, b, lb, band_k)
    kernels.check_args(torch.int32, a=a, la=la, b=b, lb=lb)
    B = a.shape[0]
    if a.dim() != 2 or b.dim() != 2 or b.shape[0] not in (1, B):
        raise ValueError(f"bad shapes a {tuple(a.shape)}, b {tuple(b.shape)}")
    if la.shape != (B,) or lb.shape != (B,):
        raise ValueError(f"la, lb must be ({B},), got {tuple(la.shape)}, {tuple(lb.shape)}")
    out = la.new_empty(B)
    args = (a.data_ptr(), a.stride(0), a.shape[1],
            b.data_ptr(), 0 if b.shape[0] == 1 else b.stride(0), b.shape[1],
            la.data_ptr(), lb.data_ptr(), out.data_ptr(), B, band_k)
    if _body is None:
        kernels.launch("myers", "kgt_myers", a.device, *args)
    else:
        kernels.launch("myers", "kgt_myers_with_body", a.device, *args, BODIES.index(_body))
    return out


def myers_banded_levenshtein(seq_a, len_a, seq_b, len_b, band_k: int = 63,
                             device=None) -> np.ndarray:
    """Host wrapper: numpy pairs in, numpy (B,) int32 distances out, on
    the card unless device='cpu'."""
    dev = resolve_device(device)
    out = myers_distance_padded(*int32_on(dev, seq_a, len_a, seq_b, len_b), band_k=band_k)
    return out.cpu().numpy()


def myers_pairs_device(seqs_dev, lens_dev, iu, ju, band_k: int = 63) -> np.ndarray:
    """Banded Myers distances for an index-pair batch over a sequence pool
    on its device: pattern rows seqs[iu] and per-pair texts seqs[ju] are
    gathered there in chunks (edit_distance.PAIR_GATHER_BYTES) and run
    through kernel B1's per-pair mode; only the indices cross from the
    host. Returns numpy (P,) int32 under the banded contract."""
    return gathered_pairs(functools.partial(myers_distance_padded, band_k=band_k),
                          seqs_dev, lens_dev, iu, ju)


def adaptive_myers_levenshtein(seq_a, len_a, seq_b, len_b, start_k: int = 63,
                               max_band: int = 511, device=None) -> np.ndarray:
    """Edlib's band doubling on kernel B1: every band of MYERS_BANDS from
    start_k to max_band in turn, each re-running only the pairs outside
    the previous band's contract; what is left goes to the exact
    wavefront (kernel B3). Exact for every pair."""
    bands = [k for k in MYERS_BANDS if start_k <= k <= max_band] or [
        max(k for k in MYERS_BANDS if k <= max_band)
    ]
    return band_doubling(seq_a, len_a, seq_b, len_b, bands, myers_distance_padded, device)
