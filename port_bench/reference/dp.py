"""Edit distances of equal-length code rows by a banded row DP, in plain
PyTorch: the benchmark's reference for the distances the port computes.

Every pair the benchmark makes has two rows of one length that differ by
substitutions only. The identity alignment then costs their Hamming
distance h, so the optimal cost C is at most h. A path of cost C moves off
the main diagonal by at most C cells: each step off it is an insertion or
a deletion, which costs 1. For the global distance the path starts and
ends on the diagonal. For the local (infix) distance it starts at (0, s)
and ends at (n, e) with e <= n, and s <= C because the path has to come
back from offset s. So a DP over the diagonals |j - i| <= h, with every
cell outside them infinite, sees the optimal path and only paths no
cheaper: its answer is exact. The band is the largest Hamming distance of
a block of pairs, worked out here from the rows themselves.

Row i of the band holds D[i][i + d] for d = -h..h. A row is built from
the one above it (the diagonal and the vertical move) and then the
horizontal moves as a running minimum (cummin of D - d, plus d).
"""

from __future__ import annotations

import torch

__all__ = ["banded_distance", "hamming", "pair_distances"]

# Pairs in one block of the DP: (pairs x (2h + 1)) int32 cells a row.
BLOCK_PAIRS = 32768


def hamming(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(P,) int64: positions where the equal-length rows q, t (P, n) differ."""
    return (q != t).sum(1)


def banded_distance(q: torch.Tensor, t: torch.Tensor, band: int,
                    local: bool = False) -> torch.Tensor:
    """(P,) int64 edit distances of q against t, (P, n) each, over the
    diagonals |j - i| <= band. Exact when band is at least the distance
    (see the module's note). local=False: Levenshtein. local=True: q
    against any substring of t (D[0][j] = 0, the minimum of row n)."""
    P, n = q.shape
    if t.shape != q.shape:
        raise ValueError(f"rows must have one shape, got {tuple(q.shape)} and {tuple(t.shape)}")
    dev = q.device
    h = int(band)
    W = 2 * h + 1
    big = n + 4 * h + 8
    q = q.to(torch.int32)
    # tp[:, h + m] = t[:, m]; the pads never equal a code.
    tp = torch.cat([torch.full((P, h), -1, dtype=torch.int32, device=dev), t.to(torch.int32),
                    torch.full((P, h + 1), -1, dtype=torch.int32, device=dev)], 1)
    d = torch.arange(-h, h + 1, dtype=torch.int32, device=dev)
    # Row 0: D[0][j] = j (global) or 0 (local) for j = d >= 0.
    row0 = torch.zeros_like(d) if local else d.clone()
    prev = torch.where(d < 0, big, row0).expand(P, W).contiguous()
    inf_col = torch.full((P, 1), big, dtype=torch.int32, device=dev)
    for i in range(1, n + 1):
        cost = (q[:, i - 1 : i] != tp[:, i - 1 : i - 1 + W]).to(torch.int32)
        up = torch.cat([prev[:, 1:], inf_col], 1)  # D[i-1][j] sits at d + 1
        base = torch.minimum(prev + cost, up + 1)
        if i <= h:
            base[:, : h - i] = big  # j < 0
            base[:, h - i] = i      # D[i][0] = i
        prev = torch.cummin(base - d, dim=1).values + d
    if local:
        return prev[:, : h + 1].amin(1).to(torch.int64)  # j = n + d for d <= 0
    return prev[:, h].to(torch.int64)  # j = n


def pair_distances(q: torch.Tensor, t: torch.Tensor, local: bool = False) -> torch.Tensor:
    """(P,) int64 exact distances of equal-length rows that differ by
    substitutions, in blocks of BLOCK_PAIRS, each at its largest Hamming
    distance as the band."""
    out = []
    for lo in range(0, q.shape[0], BLOCK_PAIRS):
        qb, tb = q[lo : lo + BLOCK_PAIRS], t[lo : lo + BLOCK_PAIRS]
        band = max(int(hamming(qb, tb).max()), 1)
        out.append(banded_distance(qb, tb, band, local=local))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64, device=q.device)
