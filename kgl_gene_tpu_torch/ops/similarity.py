"""All-pairs MICA and Lin similarity over a GO term subset on the card.

Counterpart of kgl_gene_tpu/ops/similarity.py (ancestor_lists,
_mica_tile, _mica_tile_chunked, mica_matrix_device, lin_matrix_device).
Each term carries its padded ancestor list with IC values, and

    MICA[i, j] = max(0, max over (p, q) with id_i[p] == id_j[q] of
                        min(ic_i[p], ic_j[q]))

is computed for the whole matrix by csrc/mica.cu in one launch (mica:
the kernel for a CUDA tensor, mica_plain for a CPU tensor) and fetched
once; the reference's host loop of 128-term tiles with a fetch each is
gone, and `tile` stays in the signatures without changing a result.
mica_plain is the reference's compare in 64 x 64 chunks of the ancestor
cross product, with a tail chunk when K % 64 != 0: the reference's
chunked form drops the columns past (K // 64) * 64, a fault the port does
not carry. TermSimilarityCache and OntologyDatabase stay on the host MICA
(ontology/information.py), as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels, resolve_device
from ..ontology.graph import GoGraph

__all__ = ["ancestor_lists", "id_order", "lin_matrix_device", "mica", "mica_from_lists",
           "mica_matrix_device", "mica_plain"]

CHUNK = 64
# Elements of one (rows_i, rows_j, CHUNK, CHUNK) compare block of mica_plain.
PLAIN_BLOCK_ELEMS = 1 << 26
_PAD_KEY = torch.iinfo(torch.int32).max  # sorts a pad after every id


def ancestor_lists(information, term_indices: Sequence[int],
                   max_ancestors: Optional[int] = None,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(n, K) ancestor ids (-1 pad) and IC values for each term.

    max_ancestors=None (the default) is EXACT: K pads to the longest
    ancestor list in the subset (rounded to a multiple of 64), each row
    ascending. Passing an int keeps the old top-IC truncation (approximate
    for terms with more ancestors; such a row is in descending IC order)."""
    graph = information.graph
    anc_bits = graph.ancestor_bitsets()
    ic = information.ic
    n = len(term_indices)
    anc_all = [GoGraph._bits_to_indices(anc_bits[t]) for t in term_indices]
    if max_ancestors is None:
        longest = max((len(a) for a in anc_all), default=1)
        K = max(64, ((longest + 63) // 64) * 64)
        truncate = False
    else:
        K = max_ancestors
        truncate = True
    ids = np.full((n, K), -1, dtype=np.int32)
    vals = np.zeros((n, K), dtype=np.float32)
    overflow = 0
    for row, anc in enumerate(anc_all):
        if truncate and len(anc) > K:
            overflow += 1
            order = np.argsort(ic[anc])[::-1][:K]
            anc = anc[order]
        ids[row, : len(anc)] = anc
        vals[row, : len(anc)] = ic[anc]
    if overflow:
        from ..utils.logging import log

        log().warn("ancestor_lists: {} terms truncated to top-{} IC ancestors",
                   overflow, K)
    return ids, vals


def mica_plain(ids_i: torch.Tensor, ic_i: torch.Tensor, ids_j: torch.Tensor,
               ic_j: torch.Tensor) -> torch.Tensor:
    """(TI, Ki) x (TJ, Kj) -> (TI, TJ) float32 max-min over matching
    ancestor ids, from 0: the reference's chunked compare over every
    column, in blocks of rows of at most PLAIN_BLOCK_ELEMS compares."""
    TI, Ki = ids_i.shape
    TJ, Kj = ids_j.shape
    out = torch.zeros(TI, TJ, dtype=torch.float32, device=ids_i.device)
    rows_j = max(1, min(TJ, math.isqrt(PLAIN_BLOCK_ELEMS // (CHUNK * CHUNK))))
    rows_i = max(1, PLAIN_BLOCK_ELEMS // (rows_j * CHUNK * CHUNK))
    for i0 in range(0, TI, rows_i):
        for j0 in range(0, TJ, rows_j):
            acc = out[i0 : i0 + rows_i, j0 : j0 + rows_j]
            for a in range(0, Ki, CHUNK):
                idi = ids_i[i0 : i0 + rows_i, a : a + CHUNK, None]
                ici = ic_i[i0 : i0 + rows_i, a : a + CHUNK, None]
                for b in range(0, Kj, CHUNK):
                    idj = ids_j[j0 : j0 + rows_j, None, b : b + CHUNK]
                    icj = ic_j[j0 : j0 + rows_j, None, b : b + CHUNK]
                    eq = (idi[:, None] == idj[None]) & (idi[:, None] >= 0)
                    pair_min = torch.minimum(ici[:, None], icj[None])
                    block = torch.where(eq, pair_min, 0.0).amax(dim=(2, 3))
                    torch.maximum(acc, block, out=acc)
    return out


def id_order(ids: torch.Tensor, ic: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's ids >= 0 in ascending order with their ICs, then -1 pads:
    the order csrc/mica.cu merges in. One sort a row set; pads may lie
    anywhere in the input."""
    key = ids.masked_fill(ids < 0, _PAD_KEY)
    key, order = key.sort(dim=1)
    return key.masked_fill_(key == _PAD_KEY, -1), ic.gather(1, order)


def mica(ids_i: torch.Tensor, ic_i: torch.Tensor, ids_j: Optional[torch.Tensor] = None,
         ic_j: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MICA of every pair of rows: (TI, TJ) float32, through csrc/mica.cu
    for CUDA tensors and mica_plain for CPU tensors. ids int32 and ic
    float32, (rows, K), contiguous; a row's ids >= 0 count and ids < 0 are
    pads, in any order (ancestor_lists' exact rows ascend, its truncated
    rows come in IC order; the kernel gets both sorted by id_order). The
    ids >= 0 of a row must be distinct, as ancestor_lists makes them: on
    the card a row with a repeated id gives an undefined result
    (mica_from_lists checks it). With no j set the matrix is that of the i
    set with itself, and the kernel computes its upper triangle of tiles
    and mirrors it."""
    symmetric = ids_j is None
    if symmetric:
        ids_j, ic_j = ids_i, ic_i
    if ids_i.device.type == "cpu":
        return mica_plain(ids_i, ic_i, ids_j, ic_j)
    kernels.check_args(torch.int32, ids_i=ids_i, ids_j=ids_j)
    kernels.check_args(torch.float32, ic_i=ic_i, ic_j=ic_j)
    if ids_i.dim() != 2 or ids_j.dim() != 2 or ic_i.shape != ids_i.shape \
            or ic_j.shape != ids_j.shape:
        raise ValueError("ids and ic must be matching (rows, K) matrices")
    if ids_j.device != ids_i.device:
        raise ValueError("both row sets must lie on one device")
    (ni, ki), (nj, kj) = ids_i.shape, ids_j.shape
    out = torch.empty(ni, nj, dtype=torch.float32, device=ids_i.device)
    if out.numel() and ki and kj:
        ids_i, ic_i = id_order(ids_i, ic_i)
        ids_j, ic_j = (ids_i, ic_i) if symmetric else id_order(ids_j, ic_j)
        kernels.launch("mica", "kgt_mica", ids_i.device, ids_i.data_ptr(), ic_i.data_ptr(),
                       ni, ki, ids_j.data_ptr(), ic_j.data_ptr(), nj, kj, out.data_ptr(),
                       int(symmetric))
    elif out.numel():
        out.zero_()
    return out


def mica_from_lists(ids: np.ndarray, ic: np.ndarray, device=None) -> np.ndarray:
    """All-pairs MICA of ancestor_lists' (ids, ic) arrays as an (n, n)
    float64 array: one upload, one launch, one fetch. Raises ValueError
    when a row repeats an id >= 0 (mica's precondition)."""
    dev = resolve_device(device)
    srt = np.sort(ids, axis=1)
    if ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any():
        raise ValueError("mica_from_lists: a row repeats an ancestor id")
    ids_t = torch.as_tensor(np.ascontiguousarray(ids, dtype=np.int32), device=dev)
    ic_t = torch.as_tensor(np.ascontiguousarray(ic, dtype=np.float32), device=dev)
    return mica(ids_t, ic_t).cpu().numpy().astype(np.float64)


def mica_matrix_device(information, term_indices: Sequence[int],
                       tile: int = 128,
                       max_ancestors: Optional[int] = None, device=None) -> np.ndarray:
    """All-pairs MICA IC over a term subset on the card (the CPU with
    device="cpu"). Exact by default (kol_SimilarityCache.cpp:126-150).
    `tile` is the reference's host tile and changes nothing here."""
    dev = resolve_device(device)
    ids, vals = ancestor_lists(information, term_indices, max_ancestors)
    return mica_from_lists(ids, vals, dev)


def lin_matrix_device(information, term_ids: Sequence[str],
                      tile: int = 128,
                      max_ancestors: Optional[int] = None, device=None) -> np.ndarray:
    """Lin similarity matrix from the device MICA: the reference's formula
    in float64 on the same device, one fetch. Matches
    SimilarityLin.similarity_matrix up to the MICA's float32 rounding."""
    dev = resolve_device(device)
    graph = information.graph
    idxs = [graph.term_index(t) for t in term_ids]
    valid = np.array([i is not None for i in idxs])
    safe = np.array([i if i is not None else 0 for i in idxs], dtype=np.int64)
    ids, vals = ancestor_lists(information, safe, max_ancestors)
    ids_t = torch.as_tensor(ids, device=dev)
    mica_t = mica(ids_t, torch.as_tensor(vals, device=dev)).double()

    def host(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    ic = host(information.ic[safe])
    counts = host(information.cumulative_counts[safe])
    ns = host(graph.namespace_code[safe].astype(np.int64))
    ok = host(valid)
    ok = (ok[:, None] & ok[None, :] & (counts[:, None] > 0) & (counts[None, :] > 0)
          & (ns[:, None] == ns[None, :]))
    denom = ic[:, None] + ic[None, :]
    out = torch.where(denom > 0, 2.0 * mica_t / denom, 0.0)
    out.diagonal().copy_(torch.where(ic > 0, 1.0, 0.0))
    return torch.where(ok, out, 0.0).cpu().numpy()
