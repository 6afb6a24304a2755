"""Exact Levenshtein distance: the numpy oracle and the plain batched
anti-diagonal wavefront.

Counterpart of kgl_gene_tpu/ops/edit_distance.py (levenshtein_numpy and
_batched_levenshtein_impl). batched_levenshtein is the plain PyTorch
version of kernel B3 (csrc/wavefront.cu, wrapped by
ops/wavefront.batched_levenshtein_kernel).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["batched_levenshtein", "levenshtein_numpy"]


def levenshtein_numpy(a: np.ndarray, b: np.ndarray) -> int:
    """Exact Levenshtein distance between two code arrays (row DP with the
    insertion chain resolved by a min-scan)."""
    a = np.asarray(a)
    b = np.asarray(b)
    m, n = len(a), len(b)
    if m == 0:
        return n
    if n == 0:
        return m
    js = np.arange(n + 1, dtype=np.int32)
    prev = js.copy()
    base = np.empty(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        cost = (b != a[i - 1]).astype(np.int32)
        base[0] = i
        np.minimum(prev[1:] + 1, prev[:-1] + cost, out=base[1:])
        prev = np.minimum.accumulate(base - js) + js
    return int(prev[n])


def batched_levenshtein(seq_a, len_a, seq_b, len_b) -> torch.Tensor:
    """Plain anti-diagonal wavefront over a batch of pairs.

    seq_a (B, Ma) and seq_b (B or 1, Mb) integer codes, len_a / len_b (B,)
    true lengths (clamped to the widths). Lane i of diagonal d holds
    D[i][d - i]; each diagonal is built from the two before it and the
    result is captured where d == len_a + len_b. Returns (B,) int32."""
    B, Ma = seq_a.shape
    Mb = seq_b.shape[1]
    dev = seq_a.device
    la = len_a.to(torch.int64).clamp(0, Ma)
    lb = len_b.to(torch.int64).clamp(0, Mb)
    n = la + lb
    result = torch.where(n < 2, n, 0)
    d_end = int(n.max()) if B else 0
    if d_end < 2:
        return result.to(torch.int32)

    W = Ma + 1
    BIG = Ma + Mb + 1
    i_idx = torch.arange(W, device=dev)
    # a_sh[:, i] = a[i - 1]; lane 0 is a boundary lane whatever it holds.
    a_sh = torch.cat(
        [torch.zeros(B, 1, dtype=torch.int32, device=dev), seq_a.to(torch.int32)], 1
    )
    # b_pad[:, Ma + 1 + Mb - d + i] = b[d - i - 1]: reversed b between pads,
    # so diagonal d reads its b codes as one slice.
    b_rev = seq_b.to(torch.int32).flip(1).expand(B, Mb)
    pad = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    b_pad = torch.cat([pad, b_rev, pad], 1)

    i32 = torch.int32
    diag_pp = torch.where(i_idx == 0, 0, BIG).to(i32).expand(B, W)
    diag_p = torch.where(i_idx <= 1, 1, BIG).to(i32).expand(B, W)
    la_col = la[:, None]
    for d in range(2, d_end + 1):
        off = Ma + 1 + Mb - d
        cost = (a_sh != b_pad[:, off : off + W]).to(i32)
        cand = torch.empty(B, W, dtype=i32, device=dev)
        cand[:, 1:] = torch.minimum(
            torch.minimum(diag_p[:, :-1], diag_p[:, 1:]) + 1,
            diag_pp[:, :-1] + cost[:, 1:],
        )
        cand[:, 0] = d          # D[0][d]
        if d < W:
            cand[:, d] = d      # D[d][0]
        j_idx = d - i_idx
        cand.masked_fill_((j_idx < 0) | (j_idx > Mb), BIG)
        hit = n == d
        result = torch.where(hit, cand.gather(1, la_col)[:, 0].to(torch.int64), result)
        diag_pp, diag_p = diag_p, cand
    return result.to(torch.int32)
