"""The typed metric family of the port (kgl_gene_tpu_torch/classify/
distance.py: the six Levenshtein metrics, the two blosum80 stubs and
batched_metric) against the JAX package's classify/distance.py, on the
cases of tests/test_local_distance.py and seeded batches: global pairs
through kernel B3's CPU route, local pairs through kernel `local`'s CPU
route. Distances are integers: equality is exact."""

import numpy as np
import pytest
import torch

import kgl_gene_tpu.classify.distance as jd
import kgl_gene_tpu_torch.classify.distance as td
from kgl_gene_tpu.sequence.sequence import DNA5SequenceCoding as JCoding
from kgl_gene_tpu.sequence.sequence import StrandSense as JStrand
from kgl_gene_tpu_torch.sequence.sequence import DNA5SequenceCoding as TCoding
from kgl_gene_tpu_torch.sequence.sequence import StrandSense as TStrand

METRICS = ["levenshtein_global_amino", "levenshtein_local_amino", "levenshtein_global_coding",
           "levenshtein_local_coding", "levenshtein_global_linear", "levenshtein_local_linear",
           "global_blosum80_amino", "local_blosum80_amino"]


def test_the_family_surface():
    assert td.__all__ == jd.__all__
    for name in METRICS:
        assert getattr(td, name).name == getattr(jd, name).name
        assert repr(getattr(td, name)) == repr(getattr(jd, name))
    assert isinstance(td.levenshtein_local_coding, td.SequenceDistanceMetric)


CASES = [
    # tests/test_local_distance.py: an exact substring, the symmetric pair,
    # the local <= global pair, an empty query, the longer-query swap.
    (np.array([2, 3, 0], np.uint8), np.array([0, 1, 2, 3, 0, 1, 2], np.uint8)),
    (np.random.default_rng(0).integers(0, 4, 30).astype(np.uint8),
     np.random.default_rng(0).integers(0, 4, 80).astype(np.uint8)),
    (np.random.default_rng(3).integers(0, 4, 40).astype(np.uint8),
     np.random.default_rng(3).integers(0, 4, 90).astype(np.uint8)),
    (np.empty(0, np.uint8), np.array([1, 2], np.uint8)),
    (np.array([0, 1, 2, 3, 0, 1], np.uint8), np.array([1, 2, 3, 0], np.uint8)),
]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("name", METRICS)
def test_single_pair_equal(name, case):
    a, b = CASES[case]
    got = getattr(td, name)(a, b)
    assert isinstance(got, float)
    assert got == getattr(jd, name)(a, b)
    assert got == getattr(td, name)(b, a)  # both metrics are symmetric


def test_sequence_objects():
    """test_local_distance.py::TestTypedMetrics on both packages."""
    rng = np.random.default_rng(1)
    c1, c2 = rng.integers(0, 4, 30).astype(np.uint8), rng.integers(0, 4, 60).astype(np.uint8)
    j1, j2 = JCoding(c1, JStrand.FORWARD), JCoding(c2, JStrand.FORWARD)
    t1, t2 = TCoding(c1, TStrand.FORWARD), TCoding(c2, TStrand.FORWARD)
    d_local = td.levenshtein_local_coding(t1, t2)
    assert d_local == jd.levenshtein_local_coding(j1, j2)
    assert 0 <= d_local <= td.levenshtein_global_coding(t1, t2)
    assert td.global_blosum80_amino(t1, t2) == 0.0
    batch = td.batched_metric(td.levenshtein_local_coding, [t1], [t2], device="cpu")
    assert batch[0] == d_local
    batch_amino = td.batched_metric(td.levenshtein_local_amino, [t1, t2], [t2, t1], device="cpu")
    assert batch_amino[0] == batch_amino[1] == d_local


@pytest.mark.parametrize("seed,n,max_a,max_b,alphabet", [
    (0, 24, 40, 70, 4), (7, 24, 40, 70, 4), (2, 16, 150, 90, 5), (3, 12, 130, 130, 25),
])
@pytest.mark.parametrize("name", METRICS)
def test_batched_metric_equal(name, seed, n, max_a, max_b, alphabet):
    rng = np.random.default_rng(seed)
    a = [rng.integers(0, alphabet, int(rng.integers(0, max_a + 1))).astype(np.uint8)
         for _ in range(n)]
    b = [rng.integers(0, alphabet, int(rng.integers(1, max_b + 1))).astype(np.uint8)
         for _ in range(n)]
    metric = getattr(td, name)
    got = td.batched_metric(metric, a, b, device="cpu")
    want = jd.batched_metric(getattr(jd, name), a, b)
    assert got.dtype == np.int64 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [metric(x, y) for x, y in zip(a, b)])


def test_batched_metric_empty_and_device():
    assert td.batched_metric(td.levenshtein_local_coding, [], [], device="cpu").shape == (0,)
    a = [np.array([0, 1, 2], np.uint8)]
    b = [np.array([0, 2], np.uint8)]
    np.testing.assert_array_equal(
        td.batched_metric(td.levenshtein_global_linear, a, b, device="cpu"), [1])


def test_batched_metric_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = [np.array([0, 1, 2], np.uint8)]
    for name in ("levenshtein_local_coding", "levenshtein_global_coding"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td.batched_metric(getattr(td, name), a, a)
    # The stubs compute nothing on any device.
    np.testing.assert_array_equal(td.batched_metric(td.local_blosum80_amino, a, a), [0])
