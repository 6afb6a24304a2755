"""The port's plain banded Myers (the plain version of kernel B1) against
the JAX package's myers_banded_levenshtein in interpret mode, on the CPU,
with the cases of test_myers_kernel.py and the frozen oracle distances.

Inside the exactness contract (distance <= k and |la - lb| <= k) both
equal the oracle exactly. Outside it the two windows differ (64-row words
here, 32-row there), so both are only required to be >= the oracle and
> k."""

import numpy as np
import pytest
import torch

from kgl_gene_tpu.ops.edit_distance import levenshtein_numpy
from kgl_gene_tpu.ops.pallas_myers import myers_banded_levenshtein as j_myers
from kgl_gene_tpu_torch.ops.myers import (
    MYERS_BANDS,
    myers_band_for,
    myers_banded_levenshtein,
    myers_distance_padded,
    myers_layout,
)
from test_myers_kernel import _indel_mutate, _mutated_pairs


def _check(sa, la, sb, lb, k):
    got = myers_banded_levenshtein(sa, la, sb, lb, band_k=k, device="cpu")
    ref = j_myers(sa, la, sb, lb, band_k=k, interpret=True)
    want = np.array([levenshtein_numpy(sa[i, : la[i]], sb[i, : lb[i]])
                     for i in range(len(la))])
    exact = (want <= k) & (np.abs(la - lb) <= k)
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_array_equal(ref[exact], want[exact])
    assert np.all(got >= want) and np.all(ref >= want)
    assert np.all(got[~exact] > k) and np.all(ref[~exact] > k)
    return got, want, exact


@pytest.mark.parametrize("M,k,edits", [(150, 63, 4), (640, 63, 4), (300, 31, 60)])
def test_substitution_pairs(M, k, edits):
    rng = np.random.default_rng(M + edits)
    sa, sb = _mutated_pairs(rng, 6, M, edits)
    la = np.full(6, M, np.int32)
    _check(sa, la, sb, la, k)


def test_variable_lengths():
    rng = np.random.default_rng(2)
    B, M = 6, 320
    sa, sb0 = _mutated_pairs(rng, B, M, 3)
    sb = np.zeros((B, M + 16), np.int32)
    sb[:, :M] = sb0
    la = np.full(B, M, np.int32)
    lb = la + rng.integers(-16, 17, B).astype(np.int32)
    _, _, exact = _check(sa, la, sb, lb, 31)
    assert exact.all()


def test_empty_sequences_and_length_gap():
    sa = np.zeros((2, 8), np.int32)
    got = myers_banded_levenshtein(sa, np.array([0, 4]), sa, np.array([3, 0]),
                                   band_k=63, device="cpu")
    np.testing.assert_array_equal(got, [3, 4])
    z = np.zeros((1, 200), np.int32)
    got = myers_banded_levenshtein(z, np.array([200]), z, np.array([40]),
                                   band_k=31, device="cpu")
    assert got[0] > 31 and got[0] >= 160


@pytest.mark.parametrize("M,k", [(90, 31), (640, 63), (1030, 127), (700, 255)])
def test_indel_fuzz(M, k):
    rng = np.random.default_rng(42 + k)
    B, W = 6, M + 120
    sa = np.zeros((B, W), np.int32)
    sb = np.zeros((B, W), np.int32)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    for i in range(B):
        base = rng.integers(0, 5, M).astype(np.int32)
        mut = _indel_mutate(rng, base, int(rng.integers(0, k + k // 2)))[:W]
        sa[i, :M] = base
        la[i] = M
        lb[i] = len(mut)
        sb[i, : len(mut)] = mut
    _check(sa, la, sb, lb, k)


@pytest.mark.parametrize("k", [31, 127])
def test_edits_at_both_ends(k):
    """Insertions and deletions at the first and last positions: the row-0
    boundary (D[0][j] = j) and the end of the band both matter here."""
    rng = np.random.default_rng(k)
    M, B = 300, 6
    base = rng.integers(0, 5, M).astype(np.int32)
    sa = np.tile(base, (B, 1))
    sb = np.zeros((B, M + 20), np.int32)
    lb = np.zeros(B, np.int32)
    for i in range(B):
        head = rng.integers(0, 5, i + 1).astype(np.int32)
        mut = np.concatenate([head, base[i + 2 :]]) if i % 2 else np.concatenate(
            [base[i + 1 :], head])
        sb[i, : len(mut)] = mut
        lb[i] = len(mut)
    _, _, exact = _check(sa, np.full(B, M, np.int32), sb, lb, k)
    assert exact.all()


def test_shared_text_equals_per_pair():
    rng = np.random.default_rng(9)
    M, B = 400, 6
    ref = rng.integers(0, 5, M).astype(np.int32)
    sa = np.tile(ref, (B, 1))
    for i in range(B):
        pos = rng.choice(M, 3 + i, replace=False)
        sa[i, pos] = (sa[i, pos] + 1 + rng.integers(0, 4, len(pos))) % 5
    la = np.full(B, M, np.int32)
    la[3] = M - 10
    lb = np.full(B, M, np.int32)
    t = [torch.as_tensor(x) for x in (sa, la, ref[None, :], lb, np.tile(ref, (B, 1)))]
    shared = myers_distance_padded(t[0], t[1], t[2], t[3], band_k=31)
    per_pair = myers_distance_padded(t[0], t[1], t[4], t[3], band_k=31)
    want = [levenshtein_numpy(sa[i, : la[i]], ref) for i in range(B)]
    np.testing.assert_array_equal(shared.numpy(), want)
    np.testing.assert_array_equal(per_pair.numpy(), want)


def test_frozen_oracle_distances():
    from test_frozen_oracle import EXPECT, REF_CODING

    code = {c: i for i, c in enumerate("ACGTN")}
    codings = [v[0] for v in EXPECT.values()]
    W = max(len(REF_CODING), *map(len, codings))
    sa = np.zeros((len(codings), W), np.int32)
    la = np.zeros(len(codings), np.int32)
    for i, s in enumerate(codings):
        sa[i, : len(s)] = [code[c] for c in s]
        la[i] = len(s)
    sb = np.zeros_like(sa)
    sb[:, : len(REF_CODING)] = [code[c] for c in REF_CODING]
    lb = np.full(len(codings), len(REF_CODING), np.int32)
    got = myers_banded_levenshtein(sa, la, sb, lb, band_k=31, device="cpu")
    np.testing.assert_array_equal(got, [v[2] for v in EXPECT.values()])


def test_bands_and_layout():
    assert myers_band_for(10) == 31
    assert myers_band_for(63) == 63
    assert myers_band_for(64) == 127
    assert myers_band_for(600) is None
    assert MYERS_BANDS[-1] == 511
    assert [myers_layout(k) for k in MYERS_BANDS] == [(1, 3), (1, 3), (2, 5), (4, 9), (8, 17)]
    with pytest.raises(ValueError):
        myers_layout(64)


def test_kernel_wrapper_refuses_non_cpu_tensors_it_cannot_launch():
    x = torch.zeros(2, 8, dtype=torch.int32, device="meta")
    n = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="on the card"):
        myers_distance_padded(x, n, x, n, band_k=31)
