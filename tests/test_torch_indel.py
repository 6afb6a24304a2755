"""The port's SNP + indel forward step (kgl_gene_tpu_torch/ops/pipeline.py
forward_indel, make_indel_forward_step, reconstruct_indel_coding_host)
against the JAX package's on the CPU. Every output is an integer code, so
the tolerance is zero.

The JAX step splices exons by a one-hot convolution when band_k > 0 and
by a gather at band 0; the port always gathers, so bands 31, 63 and 127
hold the port's gather against the JAX convolution. At a band the port's
distance comes from the banded Myers plain version, which is exact while
every genome makes at most band_k edits: the slot sets below keep to
that, as capture's edit bound does."""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from test_indel_device import _oracle_apply, _random_slots  # noqa: E402

import kgl_gene_tpu.native as j_native  # noqa: E402
from kgl_gene_tpu.ops import pipeline as jp  # noqa: E402
from kgl_gene_tpu_torch.ops import pipeline as tp  # noqa: E402

L, A = 300, 6
EXONS = np.asarray([(30, 120), (150, 270)], np.int64)
# Slots a genome may carry at each band: at most K * A <= band_k edits.
K_FOR_BAND = {0: 8, 31: 5, 63: 8, 127: 8}


def _slot_batch(rng, B, K):
    pos = np.zeros((B, K), np.int32)
    kind = np.zeros((B, K), np.int8)
    dlen = np.zeros((B, K), np.int32)
    icodes = np.zeros((B, K, A), np.uint8)
    ilen = np.zeros((B, K), np.int32)
    alt = np.zeros((B, K), np.uint8)
    valid = np.zeros((B, K), bool)
    slots = []
    for b in range(B):
        slots.append(_random_slots(rng, L, K, A, EXONS))
        for s, (p, k, d, ic, il, a) in enumerate(slots[-1]):
            pos[b, s], kind[b, s], dlen[b, s] = p, k, d
            icodes[b, s], ilen[b, s], alt[b, s] = ic, il, a
            valid[b, s] = True
    return (pos, kind, dlen, icodes, ilen, alt, valid), slots


def _steps(region, reverse, pad_coding, band_k):
    j = jp.make_indel_forward_step(region, EXONS, 0, reverse_strand=reverse,
                                   pad_coding=pad_coding, band_k=band_k)
    t = tp.make_indel_forward_step(region, EXONS, 0, reverse_strand=reverse,
                                   pad_coding=pad_coding, band_k=band_k, device="cpu")
    return j, t


def _assert_equal(j_out, t_out):
    assert t_out._fields == j_out._fields
    for field in j_out._fields:
        j = np.asarray(getattr(j_out, field))
        t = getattr(t_out, field)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        t = t.numpy()
        assert t.dtype == j.dtype, (field, t.dtype, j.dtype)
        np.testing.assert_array_equal(t, j, err_msg=field)


@pytest.mark.parametrize("band_k", [0, 31, 63, 127])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_forward_indel_matches_jax(seed, reverse, band_k):
    rng = np.random.default_rng(seed)
    region = rng.integers(0, 4, size=L).astype(np.uint8)
    K = K_FOR_BAND[band_k]
    args, slots = _slot_batch(rng, 12, K)
    j_step, t_step = _steps(region, reverse, K * A, band_k)
    t_out = t_step(*args)
    _assert_equal(j_step(*args), t_out)
    # And against the AdjustedSequence-style oracle of the JAX tests.
    lens = t_out.coding_len.numpy()
    for b, s in enumerate(slots):
        want = _oracle_apply(region, EXONS, s, reverse=reverse)
        np.testing.assert_array_equal(t_out.mutated_coding.numpy()[b, : lens[b]], want)


@pytest.mark.parametrize("reverse", [False, True])
def test_duplicate_snp_slots_and_dropped_writes(reverse):
    """Two valid SNP slots at one position (the later one wins, as in the
    JAX scatter), insertions past the last exon that push the region's
    tail beyond the output buffer (pad_coding 3 against 15 inserted bases:
    those writes drop), an insertion at the region's end, a deletion
    clamped at the end, and slots that are not valid. The coding sequence
    itself stays within the padded width, as capture guarantees."""
    rng = np.random.default_rng(11)
    region = rng.integers(0, 4, size=L).astype(np.uint8)
    B, K = 6, 6
    pos = np.zeros((B, K), np.int32)
    kind = np.zeros((B, K), np.int8)
    dlen = np.zeros((B, K), np.int32)
    icodes = rng.integers(0, 4, size=(B, K, A)).astype(np.uint8)
    ilen = np.zeros((B, K), np.int32)
    alt = rng.integers(0, 4, size=(B, K)).astype(np.uint8)
    valid = np.ones((B, K), bool)
    for b in range(B):
        p = 40 + 10 * b
        pos[b] = [p, p, p + 3, 290, 298, 300]
        kind[b] = [0, 0, 2, 2, 1, 2]
        dlen[b, 4] = 5 + b  # runs past the region's end: clamped at L
        ilen[b] = [0, 0, 3, A, 0, A]
        valid[b, 1] = b % 2 == 0  # duplicate SNP slot, valid in half the rows
    valid[5, 2:] = False
    args = (pos, kind, dlen, icodes, ilen, alt, valid)
    # pad_coding 3: every row inserting 15 bases drops some of its writes.
    for pad in (3, K * A):
        j_step, t_step = _steps(region, reverse, pad, 0)
        _assert_equal(j_step(*args), t_step(*args))


def _no_native(monkeypatch):
    monkeypatch.setattr(j_native, "indel_reconstruct", lambda *a, **k: None)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_reconstruct_host_matches_jax_and_step(seed, reverse, monkeypatch):
    """The port's replays, native and numpy, against the JAX package's
    numpy replay (its native branch patched off) and against the port's
    own step."""
    _no_native(monkeypatch)
    rng = np.random.default_rng(seed)
    region = rng.integers(0, 4, size=L).astype(np.uint8)
    K = 8
    args, _slots = _slot_batch(rng, 12, K)
    j_coding, j_len = jp.reconstruct_indel_coding_host(
        region, EXONS, reverse, *args, pad_coding=K * A)
    t_coding, t_len = tp.reconstruct_indel_coding_host(
        region, EXONS, reverse, *args, pad_coding=K * A)
    np.testing.assert_array_equal(t_len, j_len)
    np.testing.assert_array_equal(t_coding, j_coding)
    p_coding, p_len = tp.reconstruct_indel_coding_plain(
        region, EXONS, reverse, *args, pad_coding=K * A)
    np.testing.assert_array_equal(p_len, j_len)
    np.testing.assert_array_equal(p_coding, j_coding)
    out = tp.make_indel_forward_step(region, EXONS, 0, reverse_strand=reverse,
                                     pad_coding=K * A, device="cpu")(*args)
    np.testing.assert_array_equal(out.coding_len.numpy(), t_len)
    np.testing.assert_array_equal(out.mutated_coding.numpy(), t_coding)


def test_reconstruct_host_random_slots_matches_jax(monkeypatch):
    """Unconstrained random slots (overlapping spans, out-of-buffer
    writes): the port's native and numpy replays agree with the JAX
    package's numpy replay entry by entry."""
    _no_native(monkeypatch)
    rng = np.random.default_rng(17)
    region = rng.integers(0, 4, size=L).astype(np.uint8)
    B, K = 8, 8
    pos = rng.integers(0, L, (B, K)).astype(np.int32)
    kind = rng.integers(0, 3, (B, K)).astype(np.int8)
    dlen = rng.integers(1, 5, (B, K)).astype(np.int32)
    icodes = rng.integers(0, 4, (B, K, A)).astype(np.uint8)
    ilen = rng.integers(1, A + 1, (B, K)).astype(np.int32)
    alt = rng.integers(0, 4, (B, K)).astype(np.uint8)
    valid = rng.random((B, K)) < 0.4
    for reverse in (False, True):
        args = (region, EXONS, reverse, pos, kind, dlen, icodes, ilen, alt, valid)
        j = jp.reconstruct_indel_coding_host(*args, pad_coding=K * A)
        for t in (tp.reconstruct_indel_coding_host(*args, pad_coding=K * A),
                  tp.reconstruct_indel_coding_plain(*args, pad_coding=K * A)):
            np.testing.assert_array_equal(t[1], j[1])
            np.testing.assert_array_equal(t[0], j[0])


@pytest.mark.parametrize("bound", [0, 1, 31, 32, 63, 64, 127, 128, 4000])
def test_band_and_padding_rules_match_jax(bound):
    want = 31 if bound <= 31 else 63 if bound <= 63 else (127 if bound <= 127 else 0)
    assert tp.indel_band_for(bound) == want
    assert tp.pad_coding_for(bound) == ((max(bound, 3) + 2) // 3) * 3
