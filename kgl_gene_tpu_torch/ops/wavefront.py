"""Exact batched Levenshtein on the card: the wrapper of kernel B3.

Counterpart of kgl_gene_tpu/ops/pallas_edit_distance.py (_pallas_call and
pallas_batched_levenshtein). The CUDA kernel is csrc/wavefront.cu: the
Myers/Hyyro bit-vector recurrence over all ceil(la / 64) blocks of the
pattern, no band, so it is exact for every pair. One warp holds one pair:
lane t holds one or two 64-row blocks with their vertical deltas in
registers, works on text column s - t (- 32 for its second block) at step
s, and takes the two carry bits from the lane above by a warp shuffle;
patterns above 4,096 rows go in stripes whose carries pass through shared
memory. Codes are compared as int32 values whatever the alphabet: match
words for symbols 0..31 are built once per pair in shared memory, any
other symbol's on the spot.

What bounds it on the card: word operations (34 int32 operations per
64-row block and column), far below the anti-diagonal wavefront it
replaced (one cell per operation and a block barrier per diagonal). At a
few hundred pairs it is latency-bound all the same: a pair is a dependent
chain of (lb + 63) * ceil(la / 4096) steps on one warp. With thousands of
pairs it is bound by the rate the SMs dispatch operations at.

Two plain PyTorch versions stand beside it. ops/edit_distance.
batched_levenshtein (the cell-level wavefront) is what a CPU tensor takes
and what the kernel is held against at full shapes; bitvector_plain below
is the kernel's own word-level algorithm in int64 words, for the CPU tests
and a small-shape check on the card. A CUDA tensor launches the kernel or
raises.

Dropped from the TPU version: the lane-reversed b, the 128-lane width, the
BLOCK_B batch quantum and the shape bucketing.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import int32_on, kernels, resolve_device
from .edit_distance import batched_levenshtein

__all__ = ["MAX_KERNEL_LEN", "band_doubling", "batched_levenshtein_kernel",
           "bitvector_plain", "block_step", "kernel_smem_bytes", "pack_words",
           "wavefront_levenshtein"]

WORD = 64
SIGMA = 32               # symbols with a match word in shared memory
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block may take on Hopper


def kernel_smem_bytes(Ma: int, Mb: int) -> int:
    """Shared memory of one pair in csrc/wavefront.cu: SIGMA match words
    for each 64-row pattern block (the block count padded to odd) and two
    buffers of one carry byte per text column."""
    nblk = max(-(-Ma // WORD), 1) | 1
    slots = 1 if Ma <= 2048 else 2  # blocks a lane holds at once
    hstride = -(-(Mb + 32 * slots) // 16) * 16
    return SIGMA * nblk * 8 + 2 * hstride


# The widest Ma = Mb the kernel takes: 605 blocks (154,880 bytes of match
# words) and 2 x 38,784 carry bytes, all 232,448 bytes a block may take. (The
# wavefront it replaced held three int32 diagonals and stopped at 19,369.)
# The wrapper checks the two widths it is given, so a narrow pattern may
# meet a longer text.
MAX_KERNEL_LEN = 38720


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """(..., 64) bool -> (...,) int64 word with bit r = bits[..., r]. The
    terms are distinct powers of two, so the sum never carries and equals
    the bitwise OR (bit 63 is int64's sign bit)."""
    shifts = torch.arange(WORD, dtype=torch.int64, device=bits.device)
    return (bits.to(torch.int64) << shifts).sum(-1)


def block_step(eq, pv, mv, ph_in, mh_in):
    """One text column through one 64-row block (edlib's calculateBlock) on
    int64 words, where `+` wraps like the kernels' unsigned add. eq: match
    word; pv, mv: the block's vertical +1/-1 deltas; ph_in, mh_in: 0/1
    horizontal deltas of the row above. Returns (ph, mh, pv, mv, ph_out,
    mh_out): the horizontal deltas before the shift (bit r: row r of the
    block), the new vertical deltas and the 0/1 carries of the last row."""
    xv = eq | mv
    eq2 = eq | mh_in
    xh = (((eq2 & pv) + pv) ^ pv) | eq2
    ph = mv | ~(xh | pv)
    mh = pv & xh
    ph_out = (ph >> 63) & 1
    mh_out = (mh >> 63) & 1
    ph_s = (ph << 1) | ph_in
    mh_s = (mh << 1) | mh_in
    return ph, mh, mh_s | ~(xv | ph_s), ph_s & xv, ph_out, mh_out


def bitvector_plain(seq_a, len_a, seq_b, len_b) -> torch.Tensor:
    """Plain PyTorch version of kernel B3's algorithm: full-width
    Myers/Hyyro over int64 words, every block of the pattern, equality over
    any integer codes. seq_a (B, Ma), seq_b (B or 1, Mb), len_a, len_b (B,)
    (clamped to the widths). Returns (B,) int32 exact distances."""
    B, Ma = seq_a.shape
    dev = seq_a.device
    la = len_a.to(torch.int64).clamp(0, Ma)
    lb = len_b.to(torch.int64).clamp(0, seq_b.shape[1])
    L = int(lb.max()) if B else 0
    n_blk = max(-(-(int(la.max()) if B else 0) // WORD), 1)
    rows = n_blk * WORD
    codes = torch.zeros((B, rows), dtype=torch.int64, device=dev)
    w = min(Ma, rows)
    codes[:, :w] = seq_a[:, :w].to(torch.int64)
    codes = codes.view(B, n_blk, WORD)
    in_a = (torch.arange(rows, device=dev)[None, :] < la[:, None]).view(B, n_blk, WORD)
    text = seq_b.to(torch.int64).expand(B, -1)

    vp = [torch.full((B,), -1, dtype=torch.int64, device=dev) for _ in range(n_blk)]
    vn = [torch.zeros(B, dtype=torch.int64, device=dev) for _ in range(n_blk)]
    la_blk = ((la - 1) >> 6).clamp(min=0)
    la_pos = (la - 1) & 63
    score = la.clone()
    result = la.clone()  # lb = 0 pairs
    for j in range(1, L + 1):
        # Rows >= la match nothing.
        eq = pack_words((codes == text[:, j - 1, None, None]) & in_a)  # (B, n_blk)
        ph_in = torch.ones(B, dtype=torch.int64, device=dev)  # D[0][j] - D[0][j-1]
        mh_in = torch.zeros(B, dtype=torch.int64, device=dev)
        ph_sel, mh_sel = mh_in, mh_in
        for t in range(n_blk):
            ph, mh, vp[t], vn[t], ph_in, mh_in = block_step(eq[:, t], vp[t], vn[t], ph_in, mh_in)
            owns = la_blk == t
            ph_sel = torch.where(owns, ph, ph_sel)
            mh_sel = torch.where(owns, mh, mh_sel)
        score = score + ((ph_sel >> la_pos) & 1) - ((mh_sel >> la_pos) & 1)
        result = torch.where(lb == j, score, result)
    result = torch.where(la == 0, lb, result)
    return result.to(torch.int32)


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
    Mb = seq_b.shape[1]
    if kernel_smem_bytes(Ma, Mb) > SMEM_LIMIT:
        raise ValueError(f"widths ({Ma}, {Mb}) exceed the kernel's shared memory "
                         f"(both up to {MAX_KERNEL_LEN})")
    out = len_a.new_empty(B)
    kernels.launch(
        "wavefront", "kgt_wavefront", seq_a.device,
        seq_a.data_ptr(), seq_a.stride(0), Ma,
        seq_b.data_ptr(), 0 if seq_b.shape[0] == 1 else seq_b.stride(0), Mb,
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
