"""The local (infix, edlib HW mode) distance on the card: the wrapper of
kernel `local`.

Counterpart of the device loop of kgl_gene_tpu/ops/edit_distance.py
(_batched_local_impl, a lax.scan that XLA runs outside any Pallas kernel,
called by batched_levenshtein_local). Per pair the shorter sequence is the
query (a on a tie) and is aligned against any substring of the longer
one: D[0][j] = 0, D[i][0] = i, and the distance is the minimum of row lq
over columns 0..lt; an empty query gives 0.

The CUDA kernel is kgt_local in csrc/wavefront.cu: kernel B3's bit-vector
body (the pattern's 64-row blocks skewed over lanes) instantiated with a
zero top carry and the query chosen per pair inside the kernel. The query
is preceded by -lq mod 64 rows that match every symbol and start with
vertical delta 0, which repeat the zero top row, so row lq is the last
block's bit 63 and its deltas along the row are the carries that block
hands down anyway. Idle slots ahead of block 0 put the last block in the
last slot of the pair's last lane, whose carries are stored a byte a
column; the minimum of their prefix sums is taken after the scan. What
bounds it is B3's: 34 int32 operations a block step over sum ceil(lq / 64)
* lt steps, issued whether a slot's block is live or not.

The layout (G, K): a pair over G lanes of a warp, K blocks a lane, 32 // G
pairs a warp. G = 32 is B3's (a pair a warp, stripes of 32 K blocks); G < 32
is the group layout (one stripe, G K >= the pattern's blocks). local_layout
takes it from the shapes a launch shows: among LOCAL_LAYOUTS (the kernel's
instantiations) the one with the largest live share (live_share) at the
pattern width's block count; G = 32 below GROUP_MIN_PAIRS pairs (with few
pairs a warp a pair spreads them over more of the card) and above 4,096
rows.

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
from .wavefront import MAX_KERNEL_LEN, SIGMA, SMEM_LIMIT, WORD, block_step, pack_words

__all__ = ["GROUP_MIN_PAIRS", "GROUP_SYMBOLS", "LOCAL_LAYOUTS", "batched_levenshtein_local_kernel",
           "bitvector_local_plain", "live_share", "local_layout", "local_levenshtein",
           "local_smem_bytes"]

# (G, K) of every instantiation of kernel `local` (with_local_layout in
# csrc/wavefront.cu): G lanes a pair, K 64-row blocks a lane.
LOCAL_LAYOUTS = ((32, 1), (32, 2), (5, 7), (6, 6), (8, 6))
GROUP_SYMBOLS = 5     # match-word rows a block in the group layout: DNA5 (SIGMA_GROUP)
GROUP_MAX_ROWS = 4096  # the group layout runs one stripe of at most 64 blocks
# Pairs from which the group layout is taken. Timed on an H100 over 128 to
# 32,640 pairs at 2,181, 2,304, 3,000 and 3,072 bases (scripts/
# torch_kernel_bodies.py --local), the group layout was the faster at every
# width from 5,120 pairs on; below, a pair a warp spreads the pairs over more
# of the card (a group-layout warp holds 4 to 6 pairs).
GROUP_MIN_PAIRS = 5120


def live_share(nblk: int, G: int, K: int) -> float:
    """Share of the issued slots whose block is live, for a pattern of nblk
    blocks in layout (G, K): nblk of the G K slots a stripe of a pair, 32 //
    G pairs over the warp's 32 lanes, each lane's K slots issued in each of
    ceil(nblk / (G K)) stripes."""
    return nblk * (32 // G) / (32 * K * -(-nblk // (G * K)))


def local_smem_bytes(Ma: int, Mb: int, layout: tuple[int, int] | None = None) -> int:
    """Shared memory of one block (a warp) of kgt_local at widths (Ma, Mb),
    the narrower the pattern's: G = 32 is B3's layout (SIGMA match words a
    pattern block, two carry buffers of the text's width plus 32 K); G < 32
    holds 32 // G pairs of GROUP_SYMBOLS words a block and one buffer of lt
    bytes. layout (G, K) defaults to a pair a warp at B3's K."""
    Wp, Wt = min(Ma, Mb), max(Ma, Mb)
    G, K = layout or (32, 1 if Wp <= 2048 else 2)
    if G == 32:
        return SIGMA * _nblk_pad(Wp) * 8 + 2 * _ceil16(Wt + 32 * K)
    return (32 // G) * (GROUP_SYMBOLS * _nblk_pad(Wp) * 8 + _ceil16(Wt))


def _nblk_pad(W: int) -> int:
    return max(-(-W // WORD), 1) | 1


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def local_layout(B: int, Ma: int, Mb: int) -> tuple[int, int]:
    """The layout (G, K) kernel `local` takes for B pairs at widths (Ma,
    Mb): a pair a warp (G = 32, B3's K) below GROUP_MIN_PAIRS pairs and for
    patterns over GROUP_MAX_ROWS rows; else, of the layouts that cover the
    pattern's blocks in one stripe and fit in shared memory, the one with the
    largest live share, the larger K on a tie."""
    Wp = min(Ma, Mb)
    wide = (32, 1 if Wp <= 2048 else 2)
    if B < GROUP_MIN_PAIRS or Wp > GROUP_MAX_ROWS:
        return wide
    nblk = max(-(-Wp // WORD), 1)
    fits = [(G, K) for G, K in LOCAL_LAYOUTS
            if (G == 32 or G * K >= nblk) and local_smem_bytes(Ma, Mb, (G, K)) <= SMEM_LIMIT]
    return max(fits, key=lambda gk: (live_share(nblk, *gk), gk[1]))


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


def batched_levenshtein_local_kernel(seq_a, len_a, seq_b, len_b, *,
                                     _layout: tuple[int, int] | None = None) -> torch.Tensor:
    """Local (infix) distances, (B,) int32, the shorter sequence of each
    pair as the query.

    seq_a (B, Ma) int32 codes; seq_b (B, Mb) per-pair, or (1, Mb) shared by
    every pair (read with stride 0); len_a, len_b (B,) int32 (clamped to
    the widths). A CPU tensor takes the cell-level plain version; a CUDA
    tensor launches kgt_local or raises. _layout names the kernel's layout
    (G, K) for measurements that hold one beside another; callers leave it
    to local_layout."""
    if seq_a.device.type == "cpu":
        return batched_levenshtein_local(seq_a, len_a, seq_b, len_b)
    kernels.check_args(torch.int32, seq_a=seq_a, len_a=len_a, seq_b=seq_b, len_b=len_b)
    B, Ma = seq_a.shape
    if seq_b.dim() != 2 or seq_b.shape[0] not in (1, B):
        raise ValueError(f"seq_b must be ({B}, Mb) or (1, Mb), got {tuple(seq_b.shape)}")
    if len_a.shape != (B,) or len_b.shape != (B,):
        raise ValueError(f"lengths must be ({B},)")
    Mb = seq_b.shape[1]
    G, K = _layout or local_layout(B, Ma, Mb)
    if (G, K) not in LOCAL_LAYOUTS or (G < 32 and G * K * WORD < min(Ma, Mb)):
        raise ValueError(f"layout {(G, K)} does not hold widths ({Ma}, {Mb}) in one stripe")
    if local_smem_bytes(Ma, Mb, (G, K)) > SMEM_LIMIT:
        raise ValueError(f"widths ({Ma}, {Mb}) exceed the kernel's shared memory "
                         f"(both up to {MAX_KERNEL_LEN})")
    out = len_a.new_empty(B)
    kernels.launch(
        "local", "kgt_local", seq_a.device,
        seq_a.data_ptr(), seq_a.stride(0), Ma,
        seq_b.data_ptr(), 0 if seq_b.shape[0] == 1 else seq_b.stride(0), Mb,
        len_a.data_ptr(), len_b.data_ptr(), out.data_ptr(), B, G, K,
    )
    return out


def local_levenshtein(seq_a, len_a, seq_b, len_b, device=None) -> np.ndarray:
    """Host wrapper: numpy pairs in, numpy (B,) int32 local distances out,
    on the card unless device='cpu'. seq_b may be one (1, Mb) row shared
    by every pair."""
    dev = resolve_device(device)
    out = batched_levenshtein_local_kernel(*int32_on(dev, seq_a, len_a, seq_b, len_b))
    return out.cpu().numpy()
