"""Levenshtein distances: the numpy oracles, the plain batched wavefront,
the local (infix) metric and the all-pairs matrix of either metric, on one
device or over a mesh of ranks.

Counterpart of kgl_gene_tpu/ops/edit_distance.py. batched_levenshtein is
the cell-level plain PyTorch version of kernel B3 (csrc/wavefront.cu,
wrapped by ops/wavefront.batched_levenshtein_kernel, which is what the
paths call): the route a CPU tensor takes and what the kernel is held
against at full shapes. The kernel's own word-level algorithm in plain
PyTorch is ops/wavefront.bitvector_plain.
batched_levenshtein_local is the cell-level plain version of kernel
`local` (csrc/wavefront.cu, wrapped by ops/local.
batched_levenshtein_local_kernel): the route a CPU tensor takes and the
oracle the kernel is held against at full shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.dist import gather_rows, mesh_of, rank_rows
from ..tracing import span

__all__ = [
    "PAIR_GATHER_BYTES",
    "batched_levenshtein",
    "batched_levenshtein_local",
    "gathered_pairs",
    "levenshtein_local_numpy",
    "levenshtein_numpy",
    "pairwise_distance_matrix",
]

# Device memory for the two int32 buffers of one chunk of gathered pairs:
# the 32,640 pairs of 256 sequences of 3,000 bases take 783 MB, one chunk.
PAIR_GATHER_BYTES = 1 << 30


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


def _hw_distance_numpy(query: np.ndarray, target: np.ndarray) -> int:
    """Infix (edlib HW-mode) distance: best edit distance of `query`
    against any substring of `target`. Row DP with D[0][j] = 0, answer =
    min over the final row."""
    query = np.asarray(query)
    target = np.asarray(target)
    m, n = len(query), len(target)
    if m == 0:
        return 0
    js = np.arange(n + 1, dtype=np.int32)
    prev = np.zeros(n + 1, dtype=np.int32)
    base = np.empty(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        cost = (target != query[i - 1]).astype(np.int32)
        base[0] = i
        np.minimum(prev[1:] + 1, prev[:-1] + cost, out=base[1:])
        prev = np.minimum.accumulate(base - js) + js
    return int(prev.min())


def levenshtein_local_numpy(a: np.ndarray, b: np.ndarray) -> int:
    """Local (infix) Levenshtein, symmetric: the shorter sequence is the
    query (edlib HW mode with the smaller sequence first)."""
    if len(a) <= len(b):
        return _hw_distance_numpy(a, b)
    return _hw_distance_numpy(b, a)


def batched_levenshtein_local(seq_a, len_a, seq_b, len_b) -> torch.Tensor:
    """Batched symmetric local (infix) distance, (B,) int32: per pair the
    shorter sequence is the query and D[0][j] = 0 over the target; row DP
    over query bases with the insertion chain as a cummin over target
    columns, the answer the minimum of row len_q over columns <= len_t.
    seq_a (B, Ma), seq_b (B, Mb) codes; lengths clamped to the widths."""
    B = seq_a.shape[0]
    dev = seq_a.device
    M = max(seq_a.shape[1], seq_b.shape[1])

    def pad(x):
        x = x.to(torch.int64)
        return torch.nn.functional.pad(x, (0, M - x.shape[1])) if x.shape[1] < M else x

    la = len_a.to(torch.int64).clamp(0, seq_a.shape[1])
    lb = len_b.to(torch.int64).clamp(0, seq_b.shape[1])
    swap = (la > lb)[:, None]
    q = torch.where(swap, pad(seq_b), pad(seq_a))
    t = torch.where(swap, pad(seq_a), pad(seq_b))
    lq = torch.minimum(la, lb)
    lt = torch.maximum(la, lb)
    BIG = 2 * M + 1
    j_idx = torch.arange(M + 1, dtype=torch.int64, device=dev)
    lane_valid = j_idx[None, :] <= lt[:, None]
    prev = torch.zeros((B, M + 1), dtype=torch.int64, device=dev)
    result = torch.where(lq == 0, 0, BIG)
    for i in range(1, int(lq.max()) + 1 if B else 1):
        cost = (t != q[:, i - 1 : i]).to(torch.int64)
        base = torch.cat([torch.full((B, 1), i, dtype=torch.int64, device=dev),
                          torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost)], 1)
        cur = torch.cummin(base - j_idx, dim=1).values + j_idx
        row_min = torch.where(lane_valid, cur, BIG).min(1).values
        result = torch.where(lq == i, row_min, result)
        prev = cur
    return result.to(torch.int32)


def gathered_pairs(distance, seqs, lens, iu, ju) -> np.ndarray:
    """distance(a, la, b, lb) over the index pairs (iu, ju) of a pool seqs
    (n, W) and lens (n,) on its device: the rows are cast to int32 and
    gathered there with index_select in chunks whose two row buffers stay
    within PAIR_GATHER_BYTES; only the indices cross from the host.
    Returns numpy (P,) int32."""
    dev = seqs.device
    seqs = seqs.to(torch.int32).contiguous()
    lens = lens.to(torch.int32)
    with span("kgt.pairs.upload"):
        iu = torch.as_tensor(np.asarray(iu, dtype=np.int64), device=dev)
        ju = torch.as_tensor(np.asarray(ju, dtype=np.int64), device=dev)
    per_pair = 2 * seqs.element_size() * max(seqs.shape[1], 1)
    step = max(1, PAIR_GATHER_BYTES // per_pair)
    parts = []
    for lo in range(0, iu.shape[0], step):
        with span("kgt.pairs.gather"):
            i, j = iu[lo : lo + step], ju[lo : lo + step]
            rows = (seqs.index_select(0, i), lens.index_select(0, i),
                    seqs.index_select(0, j), lens.index_select(0, j))
        with span("kgt.pairs.distance"):
            parts.append(distance(*rows))
    with span("kgt.pairs.fetch"):
        return torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.int32)


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


def _rerun_overflow_pairs(seq_a, len_a, seq_b, len_b, failed_k: int, device) -> np.ndarray:
    """Exact distances for pairs that overflowed band failed_k: the Myers
    band doubling from the next band (2k+1) on, or straight to the exact
    wavefront when no wider band exists; the failed band never re-runs."""
    from .myers import MYERS_BANDS, adaptive_myers_levenshtein
    from .wavefront import wavefront_levenshtein

    next_k = 2 * failed_k + 1
    if next_k > MYERS_BANDS[-1]:
        return wavefront_levenshtein(seq_a, len_a, seq_b, len_b, device=device)
    return adaptive_myers_levenshtein(seq_a, len_a, seq_b, len_b, start_k=next_k,
                                      device=device)


def pairwise_distance_matrix(seqs, lens, band_k=None, device=None,
                             metric: str = "global") -> np.ndarray:
    """All-pairs distance matrix of n padded sequences (n, M): a dense
    symmetric (n, n) float64 array with a zero diagonal.

    metric "global" is Levenshtein; "local" the symmetric infix distance
    (batched_levenshtein_local), which has no band. device: None (the
    card), a device, or a parallel.dist.SampleMesh, whose ranks split the
    upper triangle's pairs (padded to a multiple of the world size, cut
    into equal blocks) and gather the distances, every rank returning the
    whole matrix. The pool of sequences goes to the device once; a rank
    gathers its pairs' rows there in chunks (gathered_pairs) and runs them
    through a kernel: for "global" with band_k, kernel B1's per-pair mode
    at the smallest Myers band >= band_k, the pairs outside the band's
    exactness contract re-run after the assembly at wider bands, then on
    the exact wavefront; for "global" with band_k=None, kernel B3; for
    "local", kernel `local`. Every route is exact."""
    from .local import batched_levenshtein_local_kernel
    from .myers import myers_band_for, myers_pairs_device
    from .wavefront import batched_levenshtein_kernel

    if metric not in ("global", "local"):
        raise ValueError(f"metric is 'global' or 'local', not {metric!r}")
    if metric == "local" and band_k is not None:
        raise ValueError("the local metric has no band: band_k must be None")
    mesh = mesh_of(device)
    seqs = np.asarray(seqs)
    lens = np.asarray(lens, dtype=np.int32)
    n = seqs.shape[0]
    with span("kgt.pairs"):
        with span("kgt.pairs.index"):
            iu, ju = np.triu_indices(n, k=1)
            n_pairs = len(iu)
            mine = rank_rows(np.stack([iu, ju], axis=1), mesh)
        with span("kgt.pairs.upload"):
            pool = torch.as_tensor(np.ascontiguousarray(seqs, dtype=np.int32), device=mesh.device)
            pool_lens = torch.as_tensor(lens, device=mesh.device)
        if band_k is not None:
            band_k = myers_band_for(band_k) or 511
            found = myers_pairs_device(pool, pool_lens, mine[:, 0], mine[:, 1], band_k=band_k)
        else:
            kernel = (batched_levenshtein_local_kernel if metric == "local"
                      else batched_levenshtein_kernel)
            found = gathered_pairs(kernel, pool, pool_lens, mine[:, 0], mine[:, 1])
        if mesh.group is not None:  # one rank alone holds every pair already
            with span("kgt.pairs.gather_ranks"):
                found = gather_rows(torch.as_tensor(found, device=mesh.device),
                                    mesh).cpu().numpy()
        with span("kgt.pairs.assemble"):
            distances = found[:n_pairs].astype(np.int64)
            pending = np.zeros(0, dtype=np.int64)
            if band_k is not None:
                ok = (distances <= band_k) & (np.abs(lens[iu] - lens[ju]) <= band_k)
                pending = np.nonzero(~ok)[0]
            out = np.zeros((n, n), dtype=np.float64)
            out[iu, ju] = distances
            out[ju, iu] = distances
        if pending.size:
            with span("kgt.pairs.rerun"):
                bi, bj = iu[pending], ju[pending]
                exact = _rerun_overflow_pairs(seqs[bi], lens[bi], seqs[bj], lens[bj], band_k,
                                              mesh.device)
                out[bi, bj] = exact
                out[bj, bi] = exact
    return out
