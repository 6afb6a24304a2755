"""Kernel B3's word-level plain version (kgl_gene_tpu_torch/ops/wavefront.py
bitvector_plain: full-width Myers/Hyyro over int64 words, general integer
equality) against the JAX package's exact Levenshtein (the Pallas wavefront
kernel in interpret mode and the scan formulation) and the numpy oracle, on
the CPU. Distances are integers, so they must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgl_gene_tpu.ops.edit_distance import _batched_levenshtein_impl
from kgl_gene_tpu.ops.edit_distance import levenshtein_numpy as j_oracle
from kgl_gene_tpu.ops.pallas_edit_distance import pallas_batched_levenshtein
from kgl_gene_tpu_torch.ops import wavefront as tw
from kgl_gene_tpu_torch.ops.edit_distance import batched_levenshtein, levenshtein_numpy
from kgl_gene_tpu_torch.ops.wavefront import bitvector_plain


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _oracle(sa, la, sb, lb):
    shared = sb.shape[0] == 1
    return [levenshtein_numpy(sa[i, : la[i]], sb[0 if shared else i, : lb[i]])
            for i in range(len(la))]


def _mutants(rng, ref, B, rate, alphabet):
    out = np.tile(ref, (B, 1))
    hit = rng.random(out.shape) < rate
    out[hit] = rng.integers(0, alphabet, int(hit.sum()))
    return out


@pytest.mark.parametrize("seed,B,Ma,Mb,alphabet", [
    (0, 10, 40, 40, 5),     # one block, DNA5
    (1, 9, 70, 57, 5),      # two blocks, Ma != Mb
    (2, 7, 150, 30, 5),     # three blocks against a short text
    (3, 8, 30, 140, 5),     # a short pattern against a long text
    (4, 8, 90, 90, 25),     # an amino-sized alphabet
])
def test_bitvector_plain_matches_jax_ragged(seed, B, Ma, Mb, alphabet):
    rng = np.random.default_rng(seed)
    sa = rng.integers(0, alphabet, (B, Ma)).astype(np.int32)
    sb = rng.integers(0, alphabet, (B, Mb)).astype(np.int32)
    la = rng.integers(0, Ma + 1, B).astype(np.int32)
    lb = rng.integers(0, Mb + 1, B).astype(np.int32)
    la[0], lb[1], la[2], lb[2] = 0, 0, 0, 0
    la[3], lb[3] = Ma, Mb
    got = bitvector_plain(*_t(sa, la, sb, lb))
    assert got.dtype == torch.int32
    j_scan = np.asarray(_batched_levenshtein_impl(
        jnp.asarray(sa), jnp.asarray(la), jnp.asarray(sb), jnp.asarray(lb), Ma, Mb))
    j_pallas = pallas_batched_levenshtein(sa, la, sb, lb, interpret=True)
    want = _oracle(sa, la, sb, lb)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), j_scan)
    np.testing.assert_array_equal(got.numpy(), j_pallas)
    np.testing.assert_array_equal(batched_levenshtein(*_t(sa, la, sb, lb)).numpy(), want)


@pytest.mark.parametrize("la_edge", [1, 63, 64, 65, 127, 128, 129])
def test_bitvector_plain_block_edges(la_edge):
    """Row la on, just under and just over a 64-row block edge, against
    related texts (a few edits) and unrelated ones."""
    rng = np.random.default_rng(la_edge)
    B, Mb = 6, 140
    ref = rng.integers(0, 4, 140).astype(np.int32)
    sa = _mutants(rng, ref, B, 0.08, 4)[:, :la_edge].copy()
    sb = np.tile(ref, (B, 1))
    sb[B // 2:] = rng.integers(0, 4, (B - B // 2, Mb))
    la = np.full(B, la_edge, np.int32)
    lb = rng.integers(max(la_edge - 20, 0), min(la_edge + 20, Mb) + 1, B).astype(np.int32)
    got = bitvector_plain(*_t(sa, la, sb, lb)).numpy()
    np.testing.assert_array_equal(got, _oracle(sa, la, sb, lb))
    np.testing.assert_array_equal(got, pallas_batched_levenshtein(sa, la, sb, lb, interpret=True))
    np.testing.assert_array_equal(got, [j_oracle(sa[i, : la[i]], sb[i, : lb[i]]) for i in range(B)])


@pytest.mark.parametrize("low,high", [(-3, 3), (28, 40), (-(2 ** 31), 2 ** 31 - 1), (1000, 1004)])
def test_bitvector_plain_equality_over_any_int32_code(low, high):
    """Codes that are negative, >= 32 or at the ends of int32 match exactly
    themselves: no alphabet is built in."""
    rng = np.random.default_rng(7)
    B, M = 6, 100
    pool = rng.integers(low, high, 5, endpoint=True)
    ref = rng.choice(pool, M).astype(np.int32)
    sa = np.tile(ref, (B, 1))
    hit = rng.random(sa.shape) < 0.1
    sa[hit] = rng.choice(pool, int(hit.sum()))
    sb = np.tile(ref, (B, 1))
    sb[-1] = rng.choice(pool, M)
    la = rng.integers(60, M + 1, B).astype(np.int32)
    lb = rng.integers(60, M + 1, B).astype(np.int32)
    got = bitvector_plain(*_t(sa, la, sb, lb)).numpy()
    np.testing.assert_array_equal(got, _oracle(sa, la, sb, lb))
    np.testing.assert_array_equal(got, pallas_batched_levenshtein(sa, la, sb, lb, interpret=True))


@pytest.mark.parametrize("M", [50, 130])
def test_bitvector_plain_shared_b_row(M):
    rng = np.random.default_rng(M)
    B = 6
    ref = rng.integers(0, 4, (1, M)).astype(np.int32)
    sa = _mutants(rng, ref[0], B, 0.1, 5)
    la = rng.integers(M - 10, M + 1, B).astype(np.int32)
    lb = rng.integers(M - 10, M + 1, B).astype(np.int32)
    shared = bitvector_plain(*_t(sa, la, ref, lb)).numpy()
    full = bitvector_plain(*_t(sa, la, np.tile(ref, (B, 1)), lb)).numpy()
    np.testing.assert_array_equal(shared, full)
    np.testing.assert_array_equal(shared, _oracle(sa, la, ref, lb))
    j = np.asarray(_batched_levenshtein_impl(
        jnp.asarray(sa), jnp.asarray(la), jnp.asarray(np.tile(ref, (B, 1))),
        jnp.asarray(lb), M, M))
    np.testing.assert_array_equal(shared, j)


def test_bitvector_plain_degenerate_lengths_and_widths():
    sa = np.zeros((4, 8), np.int32)
    la = np.array([0, 1, 0, 1], np.int32)
    lb = np.array([0, 0, 1, 1], np.int32)
    got = bitvector_plain(*_t(sa, la, sa, lb)).numpy()
    np.testing.assert_array_equal(got, [0, 1, 1, 0])
    np.testing.assert_array_equal(got, pallas_batched_levenshtein(sa, la, sa, lb, interpret=True))
    # lengths beyond the widths are clamped; an empty batch and empty widths
    la = np.array([99, 99, 3, 8], np.int32)
    lb = np.array([99, 2, 99, 8], np.int32)
    sa = np.arange(32, dtype=np.int32).reshape(4, 8) % 3
    sb = np.arange(24, dtype=np.int32).reshape(4, 6) % 4
    got = bitvector_plain(*_t(sa, la, sb, lb)).numpy()
    np.testing.assert_array_equal(got, _oracle(sa, la.clip(0, 8), sb, lb.clip(0, 6)))
    np.testing.assert_array_equal(got, batched_levenshtein(*_t(sa, la, sb, lb)).numpy())
    empty = bitvector_plain(*_t(sa[:0], la[:0], sb[:0], lb[:0]))
    assert empty.shape == (0,) and empty.dtype == torch.int32
    no_cols = bitvector_plain(*_t(sa, la, sb[:, :0], lb)).numpy()
    np.testing.assert_array_equal(no_cols, la.clip(0, 8))
    no_rows = bitvector_plain(*_t(sa[:, :0], la, sb, lb)).numpy()
    np.testing.assert_array_equal(no_rows, lb.clip(0, 6))


def test_kernel_widths_fit_shared_memory():
    """MAX_KERNEL_LEN is the widest square the kernel's shared memory
    holds, and no narrower than the 19,369 of the wavefront it replaced."""
    L = tw.MAX_KERNEL_LEN
    assert L >= 19369
    assert tw.kernel_smem_bytes(L, L) <= tw.SMEM_LIMIT < tw.kernel_smem_bytes(L + 1, L + 1)
    assert tw.kernel_smem_bytes(3000, 3000) == 32 * 47 * 8 + 2 * 3072
    assert tw.kernel_smem_bytes(0, 0) == 32 * 8 + 2 * 32
    assert tw.kernel_smem_bytes(8000, 8000) < 48 * 1024 < tw.kernel_smem_bytes(9000, 9000)
