"""The local (infix, edlib HW mode) distance on the card: the wrapper of
kernel `local`.

Counterpart of the device loop of kgl_gene_tpu/ops/edit_distance.py
(_batched_local_impl, a lax.scan that XLA runs outside any Pallas kernel,
called by batched_levenshtein_local). Per pair the shorter sequence is the
query (a on a tie) and is aligned against any substring of the longer
one: D[0][j] = 0, D[i][0] = i, and the distance is the minimum of row lq
over columns 0..lt; an empty query gives 0.

The CUDA kernel is kgt_local in csrc/wavefront.cu: kernel B3's bit-vector
body (one warp a pair, the pattern's 64-row blocks skewed over the lanes)
instantiated with a zero top carry and the query chosen per pair inside
the kernel. The query is preceded by -lq mod 64 rows that match every
symbol and start with vertical delta 0, which repeat the zero top row, so
row lq is the last block's bit 63 and its deltas along the row are the
carries that block hands down anyway. Idle slots ahead of block 0 put the
last block in lane 31's last slot, whose carries B3 stores a byte a
column for the stripe below; the last stripe stores them too, and the
warp takes the minimum of their prefix sums after the scan. What bounds
it is B3's: 34 int32 operations a block step over sum ceil(lq / 64) * lt
steps.

Two plain PyTorch versions stand beside it: ops/edit_distance.
batched_levenshtein_local (the cell-level row DP) is what a CPU tensor
takes and the oracle the kernel is held against at full shapes;
bitvector_local_plain below is the kernel's own word-level algorithm in
int64 words, pad rows and carries included. A CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import int32_on, kernels, resolve_device
from .edit_distance import batched_levenshtein_local
from .wavefront import MAX_KERNEL_LEN, SMEM_LIMIT, WORD, block_step, kernel_smem_bytes, pack_words

__all__ = ["batched_levenshtein_local_kernel", "bitvector_local_plain", "local_levenshtein",
           "local_smem_bytes"]


def local_smem_bytes(Ma: int, Mb: int) -> int:
    """Shared memory of one pair in kgt_local: B3's layout with the
    narrower width as the pattern's and the wider as the text's."""
    return kernel_smem_bytes(min(Ma, Mb), max(Ma, Mb))


def _query_target(seq_a, len_a, seq_b, len_b):
    """Per pair (q, lq, t, lt): the shorter sequence as the query (a on a
    tie), both padded to one width, as int64; lengths clamped."""
    B = seq_a.shape[0]
    M = max(seq_a.shape[1], seq_b.shape[1])
    a = torch.nn.functional.pad(seq_a.to(torch.int64), (0, M - seq_a.shape[1]))
    b = torch.nn.functional.pad(seq_b.to(torch.int64), (0, M - seq_b.shape[1])).expand(B, M)
    la = len_a.to(torch.int64).clamp(0, seq_a.shape[1])
    lb = len_b.to(torch.int64).clamp(0, seq_b.shape[1])
    swap = la > lb
    q = torch.where(swap[:, None], b, a)
    t = torch.where(swap[:, None], a, b)
    return q, torch.minimum(la, lb), t, torch.maximum(la, lb)


def bitvector_local_plain(seq_a, len_a, seq_b, len_b) -> torch.Tensor:
    """Plain PyTorch version of the local kernel's algorithm: B3's
    full-width Myers/Hyyro over int64 words (ops/wavefront.bitvector_plain)
    with a zero carry into the top block and the shorter sequence as the
    pattern, preceded by pad = -lq mod 64 rows that match every symbol
    and start with vertical delta 0. Row lq is then bit 63 of the last
    block, whose carries are D[lq][j] - D[lq][j-1] column by column; after
    the scan the distance is the minimum over j = 0..lt of lq plus their
    prefix sums. As in the kernel's systolic skew, block k works on text
    column s - k at step s, taking the carries block k - 1 left one step
    before, so all blocks advance in one step of tensor operations. seq_a
    (B, Ma), seq_b (B or 1, Mb), len_a, len_b (B,) (clamped to the widths).
    Returns (B,) int32."""
    B = seq_a.shape[0]
    dev = seq_a.device
    q, lq, t, lt = _query_target(seq_a, len_a, seq_b, len_b)
    L = int(lt.max()) if B else 0
    n_blk = max(-(-(int(lq.max()) if B else 0) // WORD), 1)
    rows = n_blk * WORD
    pad = -lq & (WORD - 1)
    src = torch.arange(rows, device=dev)[None, :] - pad[:, None]  # the query row of each row
    in_q = ((src >= 0) & (src < lq[:, None])).view(B, n_blk, WORD)
    is_pad = (src < 0).view(B, n_blk, WORD)
    codes = q.gather(1, src.clamp(0, q.shape[1] - 1)).view(B, n_blk, WORD)

    blk = torch.arange(n_blk, device=dev)
    vp = torch.full((B, n_blk), -1, dtype=torch.int64, device=dev)
    vp[:, 0] = ~((1 << pad) - 1)  # pad rows: D[i][0] = 0
    vn = torch.zeros((B, n_blk), dtype=torch.int64, device=dev)
    ph_c = torch.zeros((B, n_blk), dtype=torch.int64, device=dev)  # each block's last carries
    mh_c = torch.zeros_like(ph_c)
    last = ((lq - 1) >> 6).clamp(min=0)[:, None]  # the block holding row lq at bit 63
    zero = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    deltas = []  # the last block's carry, step by step: D[lq][j] - D[lq][j-1]
    for s in range(L + n_blk - 1):
        col = s - blk  # (n_blk,) the column each block works on, 0-based
        live = (col[None, :] >= 0) & (col[None, :] < lt[:, None])  # (B, n_blk)
        sym = t[:, col.clamp(0, max(L - 1, 0))]
        eq = pack_words(((codes == sym[:, :, None]) & in_q) | is_pad)
        # Block k takes what block k - 1 left; the top block reads
        # D[0][j] - D[0][j-1] = 0.
        ph_in = torch.cat([zero, ph_c[:, :-1]], 1)
        mh_in = torch.cat([zero, mh_c[:, :-1]], 1)
        _ph, _mh, vp_new, vn_new, ph_out, mh_out = block_step(eq, vp, vn, ph_in, mh_in)
        vp = torch.where(live, vp_new, vp)
        vn = torch.where(live, vn_new, vn)
        ph_c = torch.where(live, ph_out, ph_c)
        mh_c = torch.where(live, mh_out, mh_c)
        deltas.append(torch.where(live.gather(1, last)[:, 0],
                                  (ph_out - mh_out).gather(1, last)[:, 0], 0))
    if deltas:
        best = torch.minimum(lq, (lq[:, None] + torch.stack(deltas, 1).cumsum(1)).amin(1))
    else:
        best = lq
    return torch.where(lq == 0, 0, best).to(torch.int32)


def batched_levenshtein_local_kernel(seq_a, len_a, seq_b, len_b) -> torch.Tensor:
    """Local (infix) distances, (B,) int32, the shorter sequence of each
    pair as the query.

    seq_a (B, Ma) int32 codes; seq_b (B, Mb) per-pair, or (1, Mb) shared by
    every pair (read with stride 0); len_a, len_b (B,) int32 (clamped to
    the widths). A CPU tensor takes the cell-level plain version; a CUDA
    tensor launches kgt_local or raises."""
    if seq_a.device.type == "cpu":
        return batched_levenshtein_local(seq_a, len_a, seq_b, len_b)
    kernels.check_args(torch.int32, seq_a=seq_a, len_a=len_a, seq_b=seq_b, len_b=len_b)
    B, Ma = seq_a.shape
    if seq_b.dim() != 2 or seq_b.shape[0] not in (1, B):
        raise ValueError(f"seq_b must be ({B}, Mb) or (1, Mb), got {tuple(seq_b.shape)}")
    if len_a.shape != (B,) or len_b.shape != (B,):
        raise ValueError(f"lengths must be ({B},)")
    Mb = seq_b.shape[1]
    if local_smem_bytes(Ma, Mb) > SMEM_LIMIT:
        raise ValueError(f"widths ({Ma}, {Mb}) exceed the kernel's shared memory "
                         f"(both up to {MAX_KERNEL_LEN})")
    out = len_a.new_empty(B)
    kernels.launch(
        "local", "kgt_local", seq_a.device,
        seq_a.data_ptr(), seq_a.stride(0), Ma,
        seq_b.data_ptr(), 0 if seq_b.shape[0] == 1 else seq_b.stride(0), Mb,
        len_a.data_ptr(), len_b.data_ptr(), out.data_ptr(), B,
    )
    return out


def local_levenshtein(seq_a, len_a, seq_b, len_b, device=None) -> np.ndarray:
    """Host wrapper: numpy pairs in, numpy (B,) int32 local distances out,
    on the card unless device='cpu'. seq_b may be one (1, Mb) row shared
    by every pair."""
    dev = resolve_device(device)
    out = batched_levenshtein_local_kernel(*int32_on(dev, seq_a, len_a, seq_b, len_b))
    return out.cpu().numpy()
