"""The port's plain anti-diagonal wavefront (the plain version of kernel
B3) and its numpy oracle against the JAX package's, on the CPU: the scan
formulation _batched_levenshtein_impl and the Pallas wavefront kernel in
interpret mode. Distances are exact, so they must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgl_gene_tpu.ops.edit_distance import _batched_levenshtein_impl
from kgl_gene_tpu.ops.edit_distance import levenshtein_numpy as j_oracle
from kgl_gene_tpu.ops.pallas_edit_distance import pallas_batched_levenshtein
from kgl_gene_tpu_torch.ops.edit_distance import batched_levenshtein, levenshtein_numpy
from kgl_gene_tpu_torch.ops.wavefront import batched_levenshtein_kernel


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("seed,B,Ma,Mb", [(0, 12, 40, 40), (1, 9, 33, 57), (2, 7, 64, 20)])
def test_wavefront_matches_jax_ragged(seed, B, Ma, Mb):
    rng = np.random.default_rng(seed)
    sa = rng.integers(0, 5, (B, Ma)).astype(np.int32)
    sb = rng.integers(0, 5, (B, Mb)).astype(np.int32)
    la = rng.integers(0, Ma + 1, B).astype(np.int32)
    lb = rng.integers(0, Mb + 1, B).astype(np.int32)
    la[0], lb[1], la[2], lb[2] = 0, 0, 0, 0
    j_scan = np.asarray(_batched_levenshtein_impl(
        jnp.asarray(sa), jnp.asarray(la), jnp.asarray(sb), jnp.asarray(lb), Ma, Mb))
    j_pallas = pallas_batched_levenshtein(sa, la, sb, lb, interpret=True)
    got = batched_levenshtein(*_t(sa, la, sb, lb))
    wrap = batched_levenshtein_kernel(*_t(sa, la, sb, lb))
    want = [j_oracle(sa[i, : la[i]], sb[i, : lb[i]]) for i in range(B)]
    assert got.dtype == torch.int32
    for x in (j_scan, j_pallas, got.numpy(), wrap.numpy()):
        np.testing.assert_array_equal(x, want)


def test_degenerate_lengths():
    sa = np.zeros((4, 8), np.int32)
    la = np.array([0, 1, 0, 1], np.int32)
    lb = np.array([0, 0, 1, 1], np.int32)
    got = batched_levenshtein(*_t(sa, la, sa, lb)).numpy()
    np.testing.assert_array_equal(got, pallas_batched_levenshtein(sa, la, sa, lb, interpret=True))
    np.testing.assert_array_equal(got, [0, 1, 1, 0])


def test_shared_b_row_equals_broadcast():
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, (1, 50)).astype(np.int32)
    sa = np.tile(ref, (6, 1))
    sa[rng.random(sa.shape) < 0.1] = 4
    lens = np.full(6, 50, np.int32)
    shared = batched_levenshtein(*_t(sa, lens, ref, lens))
    full = batched_levenshtein(*_t(sa, lens, np.tile(ref, (6, 1)), lens))
    np.testing.assert_array_equal(shared.numpy(), full.numpy())
    j = np.asarray(_batched_levenshtein_impl(
        jnp.asarray(sa), jnp.asarray(lens), jnp.asarray(np.tile(ref, (6, 1))),
        jnp.asarray(lens), 50, 50))
    np.testing.assert_array_equal(shared.numpy(), j)


@pytest.mark.parametrize("seed", range(3))
def test_numpy_oracle_equals_reference_oracle(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 5, int(rng.integers(0, 30)))
    b = rng.integers(0, 5, int(rng.integers(0, 30)))
    assert levenshtein_numpy(a, b) == j_oracle(a, b)


def test_kernel_wrapper_refuses_non_cpu_tensors_it_cannot_launch():
    x = torch.zeros(2, 8, dtype=torch.int32, device="meta")
    n = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="on the card"):
        batched_levenshtein_kernel(x, n, x, n)
