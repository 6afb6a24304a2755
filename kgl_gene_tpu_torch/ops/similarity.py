"""All-pairs MICA and Lin similarity over a GO term subset on the card.

Counterpart of kgl_gene_tpu/ops/similarity.py (ancestor_lists,
_mica_tile, _mica_tile_chunked, mica_matrix_device, lin_matrix_device).
Each term carries its ancestors with their IC values, and

    MICA[i, j] = max(0, max over (p, q) with id_i[p] == id_j[q] of
                        min(ic_i[p], ic_j[q]))

is computed for the whole matrix by csrc/mica.cu in one launch and
fetched once; the reference's host loop of 128-term tiles with a fetch
each is gone, and `tile` stays in the signatures without changing a
result.

The input stage. ancestor_rows builds the exact rows of a subset in one
pass from graph.ancestor_bitsets(): the nonzero words of the subset's
bitset rows, unpacked in blocks, give every (row, id) in ascending order,
so the rows come out compact (CSR offsets, ids, ICs) with no per-term
loop. mica_matrix_device and lin_matrix_device hand those rows to the
kernel (mica_rows); ancestor_lists pads the same rows to the reference's
(n, K) arrays, and its truncated form (max_ancestors=int) sorts only the
rows it cuts, as the reference does.

The kernel (mica_rows for a RowSet, mica for padded (rows, K) lists, which
rows_on_card makes compact on the card first): a block per 64 x 64 tile of
pairs copies the two tiles' real entries into shared memory, sized by the
largest two tiles (mica_tile; a narrower tile when rows are very long),
orders each side's rows by length inside the tile, and runs warp rounds
of 8 x 4 neighbouring pairs, one merge of two sorted rows a lane, the
heads in registers, two steps a loop trip ended by sentinels. mica_plain
(the reference's compare in 64 x 64 chunks of the ancestor cross product,
with a tail chunk when K % 64 != 0) is what CPU tensors take and the
card's oracle: the reference's chunked form drops the columns past
(K // 64) * 64, a fault the port does not carry. TermSimilarityCache and
OntologyDatabase stay on the host MICA (ontology/information.py), as in
the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels, resolve_device

__all__ = ["RowSet", "ancestor_lists", "ancestor_rows", "id_order", "lin_matrix_device", "mica",
           "mica_from_lists", "mica_matrix_device", "mica_plain", "mica_rows", "mica_smem_bytes",
           "mica_tile", "row_set", "rows_on_card", "rows_to_padded"]

CHUNK = 64
# Elements of one (rows_i, rows_j, CHUNK, CHUNK) compare block of mica_plain.
PLAIN_BLOCK_ELEMS = 1 << 26
_PAD_KEY = torch.iinfo(torch.int32).max  # sorts a pad after every id
ROW_BLOCK_WORDS = 1 << 22  # bitset words ancestor_rows takes at once (32 MB)
TILE_ROWS = (64, 32, 16, 8, 4, 2, 1)  # csrc/mica.cu's tiles, widest first
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block may take on Hopper


def ancestor_rows(information, term_indices: Sequence[int]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The exact ancestor rows of each term as compact rows: (offsets
    (n + 1,) int64, ids (nnz,) int32, ic (nnz,) float32), row r being
    ids[offsets[r]:offsets[r + 1]] in ascending order with their IC values.
    Built in one pass from graph.ancestor_bitsets(): the nonzero words of
    the subset's bitset rows, ROW_BLOCK_WORDS words at a time, unpacked
    little-endian as GoGraph._bits_to_indices unpacks one row."""
    bits = information.graph.ancestor_bitsets()
    terms = np.asarray(term_indices, dtype=np.int64).reshape(-1)
    n = len(terms)
    counts = np.zeros(n, dtype=np.int64)
    parts = []
    step = max(1, ROW_BLOCK_WORDS // max(bits.shape[1], 1))
    for r0 in range(0, n, step):
        block = bits[terms[r0 : r0 + step]]
        rows, words = np.nonzero(block)  # row-major: rows, then words, ascending
        unpacked = np.unpackbits(block[rows, words].view(np.uint8).reshape(-1, 8), axis=1,
                                 bitorder="little")
        at, bit = np.nonzero(unpacked)
        counts[r0 : r0 + step] = np.bincount(rows[at], minlength=len(block))
        parts.append((words[at] * 64 + bit).astype(np.int32))
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    ids = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    return offsets, ids, information.ic[ids].astype(np.float32)


def rows_to_padded(offsets: np.ndarray, ids: np.ndarray, ic: np.ndarray, K: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Compact rows as (n, K) arrays: each row's entries first, then -1 ids
    and 0.0 ICs. Every row must hold at most K entries."""
    n = len(offsets) - 1
    lens = np.diff(offsets)
    row = np.repeat(np.arange(n), lens)
    col = np.arange(len(ids)) - offsets[row]
    out_ids = np.full((n, K), -1, dtype=np.int32)
    out_ic = np.zeros((n, K), dtype=np.float32)
    out_ids[row, col] = ids
    out_ic[row, col] = ic
    return out_ids, out_ic


def ancestor_lists(information, term_indices: Sequence[int],
                   max_ancestors: Optional[int] = None,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(n, K) ancestor ids (-1 pad) and IC values for each term.

    max_ancestors=None (the default) is EXACT: K pads to the longest
    ancestor list in the subset (rounded to a multiple of 64), each row
    ascending. Passing an int keeps the old top-IC truncation (approximate
    for terms with more ancestors; such a row is in descending IC order).
    The rows come from ancestor_rows; only a truncated row is sorted on
    its own, as the reference sorts it."""
    offsets, ids, vals = ancestor_rows(information, term_indices)
    lens = np.diff(offsets)
    if max_ancestors is None:
        longest = int(lens.max()) if len(lens) else 1
        K = max(64, ((longest + 63) // 64) * 64)
        return rows_to_padded(offsets, ids, vals, K)
    K = max_ancestors
    over = np.flatnonzero(lens > K)
    keep = np.repeat(lens <= K, lens)
    short = np.zeros_like(offsets)
    np.cumsum(np.where(lens <= K, lens, 0), out=short[1:])
    out_ids, out_ic = rows_to_padded(short, ids[keep], vals[keep], K)
    ic = information.ic
    for row in over:
        anc = ids[offsets[row] : offsets[row + 1]].astype(np.int64)
        anc = anc[np.argsort(ic[anc])[::-1][:K]]
        out_ids[row] = anc
        out_ic[row] = ic[anc]
    if len(over):
        from ..utils.logging import log

        log().warn("ancestor_lists: {} terms truncated to top-{} IC ancestors",
                   len(over), K)
    return out_ids, out_ic


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


class RowSet(NamedTuple):
    """Compact rows on one device, as csrc/mica.cu reads them: row r is
    ids[ptr[r]:ptr[r + 1]], distinct ids >= 0 in ascending order, with
    their ICs; offsets is ptr on the host, from which the launch takes its
    tile and shared memory without a device sync."""
    ptr: torch.Tensor  # (n + 1,) int32
    ids: torch.Tensor  # (nnz,) int32
    ic: torch.Tensor  # (nnz,) float32
    offsets: np.ndarray  # (n + 1,) int64

    def __len__(self) -> int:
        return len(self.offsets) - 1


def row_set(offsets, ids, ic, device) -> RowSet:
    """ancestor_rows' arrays as a RowSet on `device` (three uploads)."""
    offsets = np.asarray(offsets, dtype=np.int64)
    if offsets[-1] > np.iinfo(np.int32).max:
        raise ValueError("more than 2**31 - 1 row entries")
    return RowSet(torch.as_tensor(offsets.astype(np.int32), device=device),
                  torch.as_tensor(np.ascontiguousarray(ids, dtype=np.int32), device=device),
                  torch.as_tensor(np.ascontiguousarray(ic, dtype=np.float32), device=device),
                  offsets)


def _padded_on_cpu(rows: RowSet) -> Tuple[torch.Tensor, torch.Tensor]:
    """CPU rows as (n, K) ids and ICs, K their longest row (at least 1):
    what mica_plain takes."""
    lens = np.diff(rows.offsets)
    K = max(1, int(lens.max()) if len(lens) else 1)
    ids, ic = rows_to_padded(rows.offsets, rows.ids.numpy(), rows.ic.numpy(), K)
    return torch.as_tensor(ids), torch.as_tensor(ic)


def mica_smem_bytes(tile: int, entries: int) -> int:
    """Shared memory of one block of csrc/mica.cu: the entries of its two
    row tiles with two sentinels a row and two for an empty row (8 bytes
    each), each row's start, length and local order (4 bytes each), and
    the tile x (tile + 1) output tile."""
    return 8 * (entries + 4 * tile + 2) + 24 * tile + 4 * tile * (tile + 1)


def _tile_entries(offsets: np.ndarray, tile: int) -> int:
    """The most entries any `tile` consecutive rows (from row 0 on) hold."""
    if len(offsets) < 2:
        return 0
    edges = offsets[np.minimum(np.arange(0, len(offsets) - 1 + tile, tile), len(offsets) - 1)]
    return int(np.diff(edges).max())


def mica_tile(offsets_i: np.ndarray, offsets_j: np.ndarray, symmetric: bool
              ) -> Tuple[int, int]:
    """(tile rows, entries) of a launch of csrc/mica.cu: the widest tile of
    TILE_ROWS whose two row tiles fit a block's shared memory, and the most
    entries two of its tiles hold together (the sum of both sides' largest;
    twice the largest with one row set, whose diagonal tiles stage one
    tile twice). Raises ValueError when not even one row a tile fits."""
    for tile in TILE_ROWS:
        ei = _tile_entries(offsets_i, tile)
        entries = 2 * ei if symmetric else ei + _tile_entries(offsets_j, tile)
        if mica_smem_bytes(tile, entries) <= SMEM_LIMIT:
            return tile, entries
    raise ValueError("an ancestor row is too long for the mica kernel's shared memory")


def mica_rows(rows_i: RowSet, rows_j: Optional[RowSet] = None) -> torch.Tensor:
    """MICA of every pair of compact rows: (ni, nj) float32, through
    csrc/mica.cu for rows on the card and mica_plain (on the rows padded)
    for rows on the CPU. With no j set the matrix is that of the i set
    with itself, and the kernel computes its upper triangle of tiles and
    mirrors it."""
    symmetric = rows_j is None
    if symmetric:
        rows_j = rows_i
    if rows_i.ids.device.type == "cpu":
        return mica_plain(*_padded_on_cpu(rows_i), *_padded_on_cpu(rows_j))
    kernels.check_args(torch.int32, ptr_i=rows_i.ptr, ids_i=rows_i.ids, ptr_j=rows_j.ptr,
                       ids_j=rows_j.ids)
    kernels.check_args(torch.float32, ic_i=rows_i.ic, ic_j=rows_j.ic)
    if len({rows_i.ptr.device, rows_i.ids.device, rows_j.ptr.device, rows_j.ids.device}) > 1:
        raise ValueError("both row sets must lie on one device")
    ni, nj = len(rows_i), len(rows_j)
    out = torch.empty(ni, nj, dtype=torch.float32, device=rows_i.ids.device)
    if out.numel():
        tile, entries = mica_tile(rows_i.offsets, rows_j.offsets, symmetric)
        kernels.launch("mica", "kgt_mica", out.device, rows_i.ptr.data_ptr(),
                       rows_i.ids.data_ptr(), rows_i.ic.data_ptr(), ni, rows_j.ptr.data_ptr(),
                       rows_j.ids.data_ptr(), rows_j.ic.data_ptr(), nj, tile, entries,
                       out.data_ptr(), int(symmetric))
    return out


def rows_on_card(ids: torch.Tensor, ic: torch.Tensor) -> RowSet:
    """Padded (rows, K) lists on the card as compact rows: id_order, each
    row's count of ids >= 0 (fetched: the one sync), their exclusive
    cumsum as offsets, and the entries scattered to their places."""
    ids, ic = id_order(ids, ic)
    valid = ids >= 0
    offsets = np.zeros(ids.shape[0] + 1, dtype=np.int64)
    np.cumsum(valid.sum(1).cpu().numpy(), out=offsets[1:])
    if offsets[-1] > np.iinfo(np.int32).max:
        raise ValueError("more than 2**31 - 1 row entries")
    total = int(offsets[-1])
    ptr = torch.as_tensor(offsets.astype(np.int32), device=ids.device)
    cols = torch.arange(ids.shape[1], device=ids.device)
    dest = torch.where(valid, ptr[:-1, None].long() + cols, total).flatten()
    flat_ids = ids.new_empty(total + 1).scatter_(0, dest, ids.flatten())[:total]
    flat_ic = ic.new_empty(total + 1).scatter_(0, dest, ic.flatten())[:total]
    return RowSet(ptr, flat_ids, flat_ic, offsets)


def mica(ids_i: torch.Tensor, ic_i: torch.Tensor, ids_j: Optional[torch.Tensor] = None,
         ic_j: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MICA of every pair of rows: (TI, TJ) float32, through csrc/mica.cu
    for CUDA tensors and mica_plain for CPU tensors. ids int32 and ic
    float32, (rows, K), contiguous; a row's ids >= 0 count and ids < 0 are
    pads, in any order (ancestor_lists' exact rows ascend, its truncated
    rows come in IC order; rows_on_card puts both in the kernel's compact
    rows). The ids >= 0 of a row must be distinct, as ancestor_lists
    makes them: on the card a row with a repeated id gives an undefined
    result (mica_from_lists checks it). With no j set the matrix is that of
    the i set with itself, and the kernel computes its upper triangle of
    tiles and mirrors it."""
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
    rows_i = rows_on_card(ids_i, ic_i)
    return mica_rows(rows_i, None if symmetric else rows_on_card(ids_j, ic_j))


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


def _mica_on(information, term_indices, max_ancestors, dev) -> torch.Tensor:
    """The MICA matrix of the terms on `dev`: exact from their compact
    rows, truncated from ancestor_lists' padded rows."""
    if max_ancestors is None:
        return mica_rows(row_set(*ancestor_rows(information, term_indices), dev))
    ids, vals = ancestor_lists(information, term_indices, max_ancestors)
    return mica(torch.as_tensor(ids, device=dev), torch.as_tensor(vals, device=dev))


def mica_matrix_device(information, term_indices: Sequence[int],
                       tile: int = 128,
                       max_ancestors: Optional[int] = None, device=None) -> np.ndarray:
    """All-pairs MICA IC over a term subset on the card (the CPU with
    device="cpu"). Exact by default (kol_SimilarityCache.cpp:126-150).
    `tile` is the reference's host tile and changes nothing here."""
    dev = resolve_device(device)
    return _mica_on(information, term_indices, max_ancestors, dev).cpu().numpy().astype(
        np.float64)


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
    mica_t = _mica_on(information, safe, max_ancestors, dev).double()

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
