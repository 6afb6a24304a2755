"""Batched banded alignment traceback: CIGARs for pair batches on the card.

Counterpart of kgl_gene_tpu/ops/traceback.py. Three stages:

  1. Kernel B4 (ops/banded.banded_choices) runs the banded row DP and
     writes one uint8 traceback code per band cell, (M, B, 2k+1), which
     stays on the device.
  2. tb_walk follows every pair's path from (la, lb) back to (0, 0) and
     emits (op, count) run tapes; a diagonal match run is one tape entry.
     On the card it is the kernel of csrc/walk.cu, one thread per pair,
     step-major tapes, a warp leaving its loop once its 32 pairs have
     ended, in place of the JAX package's lax.scan; tb_walk_plain is its plain
     PyTorch version, every pair at once, one step per loop turn. Only
     the (B, steps) tapes cross to the host.
  3. The host turns each tape into a CIGAR string ("12M1X3M2D..."), the
     format of analysis/legacy.edit_items_to_cigar.

A tape is exact iff its cost is <= k, |la - lb| <= k and it consumed
both sequences; batched_cigar re-runs the others at doubled bands and
sends what is left to the host DP, counting and logging those pairs.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from .. import int32_on, kernels, resolve_device
from ..analysis import legacy
from .banded import banded_choices

__all__ = ["OP_CHARS", "banded_traceback_ops", "batched_cigar", "tb_walk", "tb_walk_plain"]

log = logging.getLogger(__name__)

# op tape codes (0 terminates)
OP_END, OP_M, OP_X, OP_D, OP_I = 0, 1, 2, 3, 4
OP_CHARS = {OP_M: "M", OP_X: "X", OP_D: "D", OP_I: "I"}

CHUNK_CODE_BYTES = 3e9  # device memory for one chunk's traceback codes


def tb_walk_plain(codes, la, lb, *, band_k: int, max_steps: int):
    """Plain PyTorch version of the walk (see tb_walk): every pair at once,
    one step per loop turn, the counterpart of the JAX package's lax.scan
    _tb_walk. Reads codes by its strides, so it takes the view
    banded_choices returns on the card as well as a contiguous tensor."""
    M, B, W = codes.shape
    dev = codes.device
    pair = torch.arange(B, dtype=torch.int64, device=dev)
    i = la.to(torch.int64).clamp(min=0)
    j = lb.to(torch.int64).clamp(min=0)
    ops = torch.empty((max_steps, B), dtype=torch.uint8, device=dev)
    counts = torch.empty((max_steps, B), dtype=torch.int32, device=dev)
    for s in range(max_steps):
        done = (i <= 0) & (j <= 0)
        c = (j - i + band_k).clamp(0, W - 1)
        row = (i - 1).clamp(0, M - 1)
        code = codes[row, pair, c].to(torch.int64)
        both = (i > 0) & (j > 0)
        is_match = both & (code >= 3)
        take_diag = both & (code >= 2)
        take_up = (both & (code == 1)) | ((i > 0) & (j <= 0))
        take_left = ~take_diag & ~take_up
        op = torch.where(take_diag, torch.where(is_match, OP_M, OP_X),
                         torch.where(take_up, OP_D, OP_I))
        op = torch.where(done, OP_END, op)
        count = torch.where(is_match, (code - 2).clamp(min=1), 1)
        count = torch.where(done, 0, count)
        i = torch.where(done | take_left, i, i - count)
        j = torch.where(done | take_up, j, j - count)
        ops[s] = op.to(torch.uint8)
        counts[s] = count.to(torch.int32)
    return ops.T, counts.T


def tb_walk(codes, la, lb, *, band_k: int, max_steps: int):
    """Path walk over the codes of kernel B4 ((M, B, 2k+1) uint8: 0 left, 1
    up, 2 diagonal substitution, >= 3 diagonal match ending a run of
    code - 2). la, lb (B,) lengths. Returns (ops, counts): (B, max_steps)
    uint8 and int32 run tapes in reverse path order (end to start),
    OP_END with count 0 after the end. A match run moves code - 2 rows and
    columns in one step, so the steps scale with the edits, not the
    length. Both are transposed views of (max_steps, B) tensors. On a CUDA
    tensor this launches the walk kernel (csrc/walk.cu) or raises; on a
    CPU tensor it runs tb_walk_plain."""
    if codes.device.type == "cpu":
        return tb_walk_plain(codes, la, lb, band_k=band_k, max_steps=max_steps)
    M, B, W = codes.shape
    kernels.check_args(torch.int32, la=la, lb=lb)
    if not codes.is_cuda or codes.dtype is not torch.uint8:
        raise TypeError(f"codes must be uint8 on the card, got {codes.dtype} on {codes.device}")
    if W != 2 * band_k + 1 or M < 1 or codes.stride(2) != 1:
        raise ValueError(f"codes must be (M >= 1, B, {2 * band_k + 1}) with unit cell stride, "
                         f"got {tuple(codes.shape)}, strides {codes.stride()}")
    if la.shape != (B,) or lb.shape != (B,):
        raise ValueError(f"la, lb must be ({B},), got {tuple(la.shape)}, {tuple(lb.shape)}")
    # Step-major tapes, as tb_walk_plain builds them: a warp's store at a
    # step covers 32 consecutive entries.
    ops = torch.empty((max_steps, B), dtype=torch.uint8, device=codes.device)
    counts = torch.empty((max_steps, B), dtype=torch.int32, device=codes.device)
    kernels.launch(
        "walk", "kgt_walk", codes.device,
        codes.data_ptr(), codes.stride(0), codes.stride(1), M, W,
        la.data_ptr(), lb.data_ptr(), ops.data_ptr(), counts.data_ptr(), B, band_k, max_steps,
    )
    return ops.T, counts.T


def banded_traceback_ops(seq_a, len_a, seq_b, len_b, band_k: int = 127, device=None):
    """(ops, counts) numpy run tapes, each (B, steps), in reverse path
    order; seq_a is the reference (rows, D ops), seq_b the mutant
    (columns, I ops). Codes and the walk run on the card unless
    device='cpu'."""
    dev = resolve_device(device)
    la = np.asarray(len_a, dtype=np.int32)
    lb = np.asarray(len_b, dtype=np.int32)
    M = int(max(la.max(initial=0), lb.max(initial=0), 1))
    # In-band worst case: up to 2k+1 non-match entries interleave with
    # match runs of at most 253 bases per entry. A shorter tape silently
    # sends in-band pairs to the ~100 ms/pair host DP.
    max_steps = int(min((la + lb).max(initial=1), 2 * band_k + 1 + (M + 252) // 253 + 8))
    a, la_t, b, lb_t = int32_on(dev, seq_a, la, seq_b, lb)
    codes = banded_choices(a, la_t, b, lb_t, band_k=band_k)
    ops, counts = tb_walk(codes, la_t, lb_t, band_k=band_k, max_steps=max_steps)
    return ops.cpu().numpy(), counts.cpu().numpy()


def _runs_to_cigar(ops: np.ndarray, counts: np.ndarray) -> str:
    """One reverse-order (op, count) run tape -> forward CIGAR string."""
    live = ops != OP_END
    o = ops[live][::-1]
    n = counts[live][::-1]
    if len(o) == 0:
        return ""
    starts = np.concatenate([[0], np.flatnonzero(o[1:] != o[:-1]) + 1])
    sums = np.add.reduceat(n, starts)
    return "".join(f"{s}{OP_CHARS[op]}" for s, op in zip(sums.tolist(), o[starts].tolist()))


def _cigar_pass(seq_a, la, seq_b, lb, indices, band_k, distances, chunk_pairs, out,
                device) -> List[int]:
    """One banded pass over `indices` at band_k: fills out[] for pairs
    proven exact and returns the indices that overflowed the band or
    truncated their tapes."""
    failed: List[int] = []
    # Codes take M * (2k+1) bytes per pair: cap the chunk to ~3 GB of them
    # (k = 511 at 3 kb would need 25 GB at 8,192 pairs).
    M = int(max(la[indices].max(initial=0), lb[indices].max(initial=0), 1))
    per_pair = M * (2 * band_k + 1)
    chunk_pairs = min(chunk_pairs, max(512, int(CHUNK_CODE_BYTES // per_pair) // 512 * 512))
    for lo in range(0, len(indices), chunk_pairs):
        sel = indices[lo : lo + chunk_pairs]
        ops, counts = banded_traceback_ops(
            seq_a[sel], la[sel], seq_b[sel], lb[sel], band_k=band_k, device=device)
        # The tape's cost must meet the band's exactness condition and the
        # tape must be complete (a truncated walk consumes fewer bases).
        edit = (ops == OP_X) | (ops == OP_D) | (ops == OP_I)
        costs = np.sum(counts * edit, axis=1)
        ref_used = np.sum(counts * ((ops == OP_M) | (ops == OP_X) | (ops == OP_D)), axis=1)
        mut_used = np.sum(counts * ((ops == OP_M) | (ops == OP_X) | (ops == OP_I)), axis=1)
        for p, idx in enumerate(sel):
            exact = (
                costs[p] <= band_k
                and abs(int(la[idx]) - int(lb[idx])) <= band_k
                and ref_used[p] == la[idx]
                and mut_used[p] == lb[idx]
                and (distances is None or costs[p] == distances[idx])
            )
            if exact:
                out[idx] = _runs_to_cigar(ops[p], counts[p])
            else:
                failed.append(idx)
    return failed


def batched_cigar(seq_a, len_a, seq_b, len_b, band_k: int = 127,
                  distances: Optional[np.ndarray] = None, chunk_pairs: int = 8192,
                  max_band: int = 511, device=None) -> List[str]:
    """CIGAR strings for (reference, mutant) pairs by the banded traceback,
    on the card unless device='cpu'. Without distances, pairs outside the
    band retry at doubled bands (edlib's k -> 2k+1, up to max_band); with
    known distances each pair goes straight to the smallest band that
    holds it. Pairs left after that take the exact host DP, which is
    logged with its count."""
    dev = resolve_device(device)
    la = np.asarray(len_a, dtype=np.int32)
    lb = np.asarray(len_b, dtype=np.int32)
    B = len(la)
    out: List[str] = [""] * B
    if distances is not None:
        distances = np.asarray(distances)
        bound = np.maximum(distances, np.abs(la - lb))
        bands = [band_k] + [b for b in (127, 255, 511) if band_k < b <= max_band]
        pending = np.nonzero(bound > bands[-1])[0].tolist()
        lo_bound = -1
        for k in bands:
            group = np.nonzero((bound > lo_bound) & (bound <= k))[0]
            lo_bound = k
            if len(group):
                pending += _cigar_pass(seq_a, la, seq_b, lb, group, k, distances,
                                       chunk_pairs, out, dev)
    else:
        pending = list(range(B))
        k = band_k
        while pending:
            pending = _cigar_pass(seq_a, la, seq_b, lb, np.asarray(pending, np.int64), k,
                                  distances, chunk_pairs, out, dev)
            if not pending or k >= max_band:
                break
            k = min(2 * k + 1, max_band)
    if pending:
        log.info("batched_cigar: %d/%d pairs overflowed band %d; host DP fallback",
                 len(pending), B, max_band)
        for p in pending:
            items = legacy.compare_sequences(np.asarray(seq_a[p][: la[p]], np.uint8),
                                             np.asarray(seq_b[p][: lb[p]], np.uint8))
            out[p] = legacy.edit_items_to_cigar(items, int(la[p]))
    return out
