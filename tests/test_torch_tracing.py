"""The port's spans (kgl_gene_tpu_torch/tracing.py): with no profiler
recording, span() hands out one shared null context and the forward step
and the pair matrix construct no profiler range; under a CPU profiler the
forward step and the pair matrix record their stages, nested under the
call's span in the order they run."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kgl_gene_tpu_torch import tracing
from kgl_gene_tpu_torch.ops.edit_distance import levenshtein_numpy, pairwise_distance_matrix
from kgl_gene_tpu_torch.ops.pipeline import make_forward_step

REGION = np.random.default_rng(11).integers(0, 4, size=1200).astype(np.uint8)
EXONS = np.array([[100, 400], [500, 800]], dtype=np.int64)  # S = 600: the Myers branch
STEP_STAGES = ["upload", "apply", "translate", "distance", "checks"]


def _snps(seed, B=6, K=8):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, len(REGION), size=(B, K)).astype(np.int32),
            rng.integers(0, 4, size=(B, K)).astype(np.uint8), rng.random((B, K)) < 0.7)


def _family(seed, n=6, S=200, far=False):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=S).astype(np.uint8)
    seqs = np.repeat(base[None], n, axis=0)
    for r in range(1, n):
        seqs[r, rng.choice(S, 3, replace=False)] = rng.integers(0, 4, 3)
    if far:  # one row past band 31 from every other: its pairs re-run exactly
        seqs[-1] = rng.integers(0, 4, size=S)
    return seqs, np.full(n, S, dtype=np.int32)


def _kgt_spans(prof):
    """(name, start, end) of every kgt.* range the profiler recorded, by start."""
    out = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in prof.profiler.kineto_results.events()
           if ev.is_user_annotation() and ev.name().startswith("kgt.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _children(spans, parent):
    """The spans whose innermost enclosing span is `parent` (a tuple of spans)."""
    inside = [s for s in spans if s != parent and parent[1] <= s[1] and s[2] <= parent[2]]
    return [s for s in inside
            if not any(o != s and o[1] <= s[1] and s[2] <= o[2] for o in inside)]


def test_with_no_profiler_span_is_one_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    first = tracing.span("kgt.step")
    assert first is tracing.span("kgt.pairs.fetch") is tracing.span("anything")
    assert isinstance(first, contextlib.nullcontext)
    with first, first:  # reentrant: spans nest
        pass


def test_with_no_profiler_the_step_and_the_matrix_build_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler recording")

    monkeypatch.setattr(tracing, "record_function", refuse)
    out = make_forward_step(REGION, EXONS, 0, reverse_strand=True, device="cpu")(*_snps(1))
    assert out.distance.shape == (6,)
    seqs, lens = _family(2, far=True)
    assert pairwise_distance_matrix(seqs, lens, band_k=31, device="cpu").shape == (6, 6)


def test_a_cpu_forward_step_records_its_stages_nested_in_order():
    step = make_forward_step(REGION, EXONS, 0, reverse_strand=True, device="cpu")
    args = _snps(3)
    plain = step(*args)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = step(*args)
    for field in plain._fields:
        assert torch.equal(getattr(plain, field), getattr(traced, field)), field
    spans = _kgt_spans(prof)
    assert [s[0] for s in spans] == ["kgt.step"] + [f"kgt.step.{s}" for s in STEP_STAGES]
    children = _children(spans, spans[0])
    assert [s[0] for s in children] == [f"kgt.step.{s}" for s in STEP_STAGES]
    assert all(a[2] <= b[1] for a, b in zip(children, children[1:]))


@pytest.mark.parametrize("far", [False, True], ids=["in_band", "rerun"])
def test_a_cpu_pair_matrix_records_its_stages(far):
    seqs, lens = _family(4, far=far)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        matrix = pairwise_distance_matrix(seqs, lens, band_k=31, device="cpu")
    n = len(seqs)
    want = np.array([[levenshtein_numpy(seqs[i], seqs[j]) for j in range(n)] for i in range(n)])
    np.testing.assert_array_equal(matrix, want.astype(np.float64))
    spans = _kgt_spans(prof)
    top = [s for s in spans if s[0] == "kgt.pairs"]
    assert len(top) == 1
    children = [s[0] for s in _children(spans, top[0])]
    stages = ["index", "upload", "upload", "gather", "distance", "fetch", "assemble"]
    if far:
        assert "kgt.pairs.rerun" in children
    assert [c for c in children if c != "kgt.pairs.rerun"] == [f"kgt.pairs.{s}" for s in stages]
    if far:  # the band doubling re-runs after the matrix is assembled
        assert children[-1] == "kgt.pairs.rerun"
