"""The port's plain banded distance (the plain version of kernel B5) and
its drivers against the JAX package's banded_levenshtein,
adaptive_banded_levenshtein and banded_pairs_device in interpret mode, on
the CPU, with the cases of test_banded_kernel.py.

Inside the exactness contract (distance <= k and |la - lb| <= k) the port,
the JAX kernel and the numpy oracle are equal. Outside it the port returns
max(la, lb) where the JAX kernel's capture never fires and gives 0, so
there the port is only held to >= the oracle and > k, never to the JAX
value. The adaptive results are exact and always equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgl_gene_tpu.ops.edit_distance import levenshtein_numpy
from kgl_gene_tpu.ops.pallas_banded import adaptive_banded_levenshtein as j_adaptive
from kgl_gene_tpu.ops.pallas_banded import banded_levenshtein as j_banded
from kgl_gene_tpu.ops.pallas_banded import banded_pairs_device as j_pairs
from kgl_gene_tpu_torch.ops.banded import (
    MAX_BAND,
    adaptive_banded_levenshtein,
    banded_choices,
    banded_distance,
    banded_levenshtein,
    banded_pairs_device,
)
from test_banded_kernel import _mutated_pairs


def _oracle(sa, la, sb, lb):
    return np.array([levenshtein_numpy(sa[i, : la[i]], sb[i, : lb[i]]) for i in range(len(la))])


def _check(sa, la, sb, lb, k):
    """Port and JAX against the oracle under the contract; returns the
    in-contract mask."""
    la = np.asarray(la, np.int32)
    lb = np.asarray(lb, np.int32)
    got = banded_levenshtein(sa, la, sb, lb, band_k=k, device="cpu")
    ref = j_banded(sa, la, sb, lb, band_k=k, interpret=True)
    want = _oracle(sa, la, sb, lb)
    exact = (want <= k) & (np.abs(la - lb) <= k)
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_array_equal(ref[exact], want[exact])
    assert np.all(got >= want) and np.all(got[~exact] > k)
    return exact


def test_in_band_exact():
    rng = np.random.default_rng(0)
    sa, sb = _mutated_pairs(rng, 6, 150, 4)
    la = np.full(6, 150, np.int32)
    assert _check(sa, la, sb, la, 63).all()


def test_variable_lengths():
    rng = np.random.default_rng(1)
    B, M = 6, 120
    sa, sb0 = _mutated_pairs(rng, B, M, 3)
    sb = np.zeros((B, M + 8), dtype=np.int32)
    sb[:, :M] = sb0
    la = np.full(B, M, dtype=np.int32)
    lb = la + rng.integers(-8, 9, B).astype(np.int32)
    assert _check(sa, la, sb, lb, 63).all()


def test_empty_sequences():
    sa = np.zeros((2, 8), dtype=np.int32)
    got = banded_levenshtein(sa, [0, 4], sa, [3, 0], band_k=63, device="cpu")
    np.testing.assert_array_equal(got, [3, 4])
    np.testing.assert_array_equal(got, j_banded(sa, np.array([0, 4]), sa, np.array([3, 0]),
                                                band_k=63, interpret=True))


@pytest.mark.parametrize("band_k", [255, 511])
def test_multi_tile_divergent_pairs(band_k):
    rng = np.random.default_rng(band_k)
    B, S = 4, 900
    base = rng.integers(0, 4, S).astype(np.int32)
    seq_a = np.tile(base, (B, 1))
    seq_b = np.tile(base, (B, 1))
    for i in range(B):
        for p in rng.choice(S, size=band_k // 2 - 10, replace=False):
            seq_b[i, p] = (seq_b[i, p] + 1 + rng.integers(0, 3)) % 4
    la = np.full(B, S, np.int32)
    assert _check(seq_a, la, seq_b, la, band_k).all()


def test_unequal_lengths_multi_tile():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 4, 640).astype(np.int32)
    b = np.concatenate([a[:300], a[460:]])  # 160-base deletion
    assert _check(a[None, :], [640], np.pad(b, (0, 640 - len(b)))[None, :], [len(b)], 255).all()


def test_outside_the_band_reach():
    """Length gaps beyond the band: the JAX kernel's capture never fires
    there (it returns 0, below the true distance); the port returns
    max(la, lb), which is >= the true distance and > k."""
    rng = np.random.default_rng(4)
    sa = rng.integers(0, 4, (3, 300)).astype(np.int32)
    sb = rng.integers(0, 4, (3, 300)).astype(np.int32)
    la, lb = np.array([10, 300, 300]), np.array([250, 150, 220])
    exact = _check(sa, la, sb, lb, 31)
    assert not exact.any()
    got = banded_levenshtein(sa, la, sb, lb, band_k=31, device="cpu")
    np.testing.assert_array_equal(got, np.maximum(la, lb))


def test_unrelated_pairs_and_ragged_pads():
    """Distances far beyond the band, and pad values that would match:
    rows and columns stop at each pair's own la and lb."""
    rng = np.random.default_rng(5)
    B, M = 8, 200
    sa, sb = _mutated_pairs(rng, B, M, 6)
    sb[:2] = rng.integers(0, 4, (2, M))  # unrelated: distance >> k
    la = np.full(B, M, np.int32) - rng.integers(0, 20, B).astype(np.int32)
    lb = np.full(B, M, np.int32) - rng.integers(0, 20, B).astype(np.int32)
    exact = _check(sa, la, sb, lb, 63)
    assert exact[2:].all() and not exact[:2].any()
    pa, pb = sa.copy(), sb.copy()
    for i in range(B):
        pa[i, la[i]:] = 9
        pb[i, lb[i]:] = 9
    np.testing.assert_array_equal(banded_levenshtein(pa, la, pb, lb, band_k=63, device="cpu"),
                                  banded_levenshtein(sa, la, sb, lb, band_k=63, device="cpu"))


@pytest.mark.parametrize("start_k", [15, 63])
def test_adaptive_escalates_out_of_band(start_k):
    rng = np.random.default_rng(2)
    B, M = 6, 150
    sa, sb = _mutated_pairs(rng, B, M, 4)
    sb[0] = rng.integers(0, 4, M)  # far pair: distance >> band
    la = np.full(B, M, dtype=np.int32)
    got = adaptive_banded_levenshtein(sa, la, sb, la, start_k=start_k, device="cpu")
    np.testing.assert_array_equal(got, j_adaptive(sa, la, sb, la, start_k=start_k, interpret=True))
    np.testing.assert_array_equal(got, _oracle(sa, la, sb, la))


def test_adaptive_reaches_multi_tile():
    rng = np.random.default_rng(1)
    S = 700
    a = rng.integers(0, 4, S).astype(np.int32)
    b = a.copy()
    for p in rng.choice(S, size=200, replace=False):
        b[p] = (b[p] + 1 + rng.integers(0, 3)) % 4
    args = (a[None, :], np.array([S], np.int32), b[None, :], np.array([S], np.int32))
    got = adaptive_banded_levenshtein(*args, start_k=63, device="cpu")
    assert got[0] == j_adaptive(*args, start_k=63, interpret=True)[0] == levenshtein_numpy(a, b)


@pytest.mark.parametrize("uniform_cap", [False, True])
def test_banded_pairs_device(uniform_cap):
    rng = np.random.default_rng(11)
    base = rng.integers(0, 4, 640).astype(np.int32)
    n = 5
    seqs = np.tile(base, (n, 1))
    for i in range(1, n):
        idx = rng.choice(640, 9, replace=False)
        seqs[i, idx] = (seqs[i, idx] + 1 + rng.integers(0, 3, 9)) % 4
    lens = np.full(n, 640, np.int32)
    iu, ju = np.triu_indices(n, k=1)
    got = banded_pairs_device(torch.as_tensor(seqs), torch.as_tensor(lens), iu, ju, band_k=63,
                              uniform_cap=uniform_cap)
    ref = j_pairs(jnp.asarray(seqs), jnp.asarray(lens), iu, ju, band_k=63, interpret=True,
                  uniform_cap=uniform_cap)
    want = [levenshtein_numpy(seqs[i], seqs[j]) for i, j in zip(iu, ju)]
    assert got.tolist() == ref.tolist() == want


def test_banded_pairs_device_ragged_pool():
    """A pool with ragged lengths: the contract applies pair by pair, and
    uniform_cap's promise is checked."""
    rng = np.random.default_rng(12)
    seqs = rng.integers(0, 4, (6, 120)).astype(np.int32)
    seqs[1:] = seqs[0]
    seqs[2, 40] = (seqs[2, 40] + 1) % 4
    lens = np.array([120, 110, 120, 0, 60, 115], np.int32)
    iu, ju = np.triu_indices(6, k=1)
    got = banded_pairs_device(torch.as_tensor(seqs), torch.as_tensor(lens), iu, ju, band_k=31)
    want = np.array([levenshtein_numpy(seqs[i, : lens[i]], seqs[j, : lens[j]])
                     for i, j in zip(iu, ju)])
    exact = (want <= 31) & (np.abs(lens[iu] - lens[ju]) <= 31)
    np.testing.assert_array_equal(got[exact], want[exact])
    assert np.all(got[~exact] > 31) and np.all(got >= want)
    with pytest.raises(ValueError):
        banded_pairs_device(torch.as_tensor(seqs), torch.as_tensor(lens), iu, ju, band_k=31,
                            uniform_cap=True)


def test_band_limits_and_cuda_only_checks():
    a = torch.zeros((1, 4), dtype=torch.int32)
    n = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(ValueError):
        banded_distance(a, n, a, n, band_k=MAX_BAND + 1)
    with pytest.raises(ValueError):
        banded_choices(a, n, a, n, band_k=-1)
    assert banded_choices(a, n, a, n, band_k=MAX_BAND).shape == (4, 1, 2 * MAX_BAND + 1)
