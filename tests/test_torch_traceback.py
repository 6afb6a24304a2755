"""The port's banded traceback (plain kernel B4 + tb_walk) and its host DP
against the JAX package's, on the CPU, with the cases of
test_legacy_and_device_sim.py.

Inside the exactness contract the two packages' tapes are equal, code for
code: every cell on an optimal path holds a value <= k in both band
layouts. CIGARs are exact and equal everywhere, and so is the number of
pairs each package sends to its host DP, counted by wrapping each
package's compare_sequences.

The JAX package's host-DP branch calls `log.info` on its `log` function
(kgl_gene_tpu/ops/traceback.py:299) and raises AttributeError whenever a
pair reaches it; for the test the fixture puts a `log` there that also has
`.info`, so the reference's intended branch runs. The JAX package is not
changed."""

import dataclasses

import numpy as np
import pytest
import torch

import kgl_gene_tpu.analysis.legacy as j_legacy
import kgl_gene_tpu.utils.logging as j_logging
import kgl_gene_tpu_torch.analysis.legacy as t_legacy
from kgl_gene_tpu.ops.edit_distance import levenshtein_numpy
from kgl_gene_tpu.ops.traceback import banded_traceback_ops as j_tapes
from kgl_gene_tpu.ops.traceback import batched_cigar as j_cigar
from kgl_gene_tpu.sequence.sequence import DNA5SequenceLinear
from kgl_gene_tpu_torch.ops.banded import RUN_CAP, banded_choices
from kgl_gene_tpu_torch.ops.traceback import (
    banded_traceback_ops, batched_cigar, tb_walk, tb_walk_plain,
)
import test_legacy_and_device_sim as legacy_cases

_mutate = legacy_cases.TestBatchedTraceback()._mutate


@pytest.fixture
def host_dp_counts(monkeypatch):
    """{'jax': n, 'port': n}: calls of each package's compare_sequences."""
    counts = {"jax": 0, "port": 0}
    for key, mod in (("jax", j_legacy), ("port", t_legacy)):
        orig = mod.compare_sequences

        def counting(*args, _orig=orig, _key=key):
            counts[_key] += 1
            return _orig(*args)

        monkeypatch.setattr(mod, "compare_sequences", counting)
    monkeypatch.setattr(j_logging, "log", _LogWithInfo(j_logging.log))
    return counts


class _LogWithInfo:
    """The JAX package's log() that also answers log.info(...)."""

    def __init__(self, log):
        self._log = log

    def __call__(self):
        return self._log()

    def info(self, msg, *args):
        self._log().info(msg, *args)


def _pack(seqs):
    W = max(max(len(s) for s in seqs), 1)
    out = np.zeros((len(seqs), W), np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out, np.array([len(s) for s in seqs], np.int32)


def _fuzz_pairs(seed=7, n=12, S=150):
    rng = np.random.default_rng(seed)
    refs = [rng.integers(0, 4, size=S).astype(np.uint8) for _ in range(n)]
    muts = [_mutate(rng, r) for r in refs]
    a, la = _pack(refs)
    b, lb = _pack(muts)
    W = max(a.shape[1], b.shape[1])
    return np.pad(a, ((0, 0), (0, W - a.shape[1]))), la, np.pad(b, ((0, 0), (0, W - b.shape[1]))), lb


def _both(host_dp_counts, *args, **kw):
    got = batched_cigar(*args, **kw, device="cpu")
    want = j_cigar(*args, **kw)
    assert got == want
    assert host_dp_counts["port"] == host_dp_counts["jax"]
    return got


@pytest.mark.parametrize("band_k", [7, 31])
def test_in_contract_tapes_equal_jax(band_k):
    a, la, b, lb = _fuzz_pairs()
    ops, counts = banded_traceback_ops(a, la, b, lb, band_k=band_k, device="cpu")
    j_ops, j_counts = j_tapes(a, la, b, lb, band_k=band_k)
    assert ops.shape == j_ops.shape and ops.dtype == j_ops.dtype
    d = np.array([levenshtein_numpy(a[i, : la[i]], b[i, : lb[i]]) for i in range(len(la))])
    inside = (d <= band_k) & (np.abs(la - lb) <= band_k)
    assert inside.sum() >= 4
    np.testing.assert_array_equal(ops[inside], j_ops[inside])
    np.testing.assert_array_equal(counts[inside], j_counts[inside])


def test_fuzz_parity(host_dp_counts):
    got = _both(host_dp_counts, *_fuzz_pairs(), band_k=31)
    a, la, b, lb = _fuzz_pairs()
    for i in range(len(la)):
        items = t_legacy.compare_sequences(a[i, : la[i]], b[i, : lb[i]])
        assert got[i] == t_legacy.edit_items_to_cigar(items, int(la[i]))


@pytest.mark.parametrize("max_band", [15, 511])
def test_band_overflow_falls_back_exact(host_dp_counts, max_band):
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 4, size=64).astype(np.uint8)
    mut = rng.integers(0, 4, size=64).astype(np.uint8)  # ~48 edits >> k
    _both(host_dp_counts, ref[None, :], [64], mut[None, :], [64], band_k=7, max_band=max_band)
    assert host_dp_counts["port"] == (1 if max_band == 15 else 0)


def test_cigar_length_conservation(host_dp_counts):
    import re

    rng = np.random.default_rng(11)
    ref = rng.integers(0, 4, size=200).astype(np.uint8)
    mut = _mutate(rng, ref)
    W = max(len(ref), len(mut))
    a = np.zeros((1, W), np.uint8)
    a[0, : len(ref)] = ref
    b = np.zeros((1, W), np.uint8)
    b[0, : len(mut)] = mut
    cig = _both(host_dp_counts, a, [len(ref)], b, [len(mut)], band_k=31)[0]
    runs = re.findall(r"(\d+)([MXDI])", cig)
    assert sum(int(n) for n, op in runs if op in "MXD") == len(ref)
    assert sum(int(n) for n, op in runs if op in "MXI") == len(mut)


@pytest.mark.parametrize("known_distances", [False, True])
def test_band_doubling_and_distance_routing(host_dp_counts, known_distances):
    rng = np.random.default_rng(8)
    S, B = 500, 6
    base = rng.integers(0, 4, S).astype(np.uint8)
    seq_a = np.repeat(base[None, :], B, axis=0)
    la = np.full(B, S, np.int32)
    seq_b = np.zeros((B, S + 80), np.uint8)
    lb = np.zeros(B, np.int32)
    for i in range(B):
        s = list(base)
        for _ in range([3, 40, 100, 150, 5, 60][i]):  # spans bands 31..255
            p = int(rng.integers(0, len(s)))
            s[p] = int((s[p] + 1 + rng.integers(0, 3)) % 4)
        for _ in range(4):
            s.insert(int(rng.integers(0, len(s))), int(rng.integers(0, 4)))
        seq_b[i, : len(s)] = s
        lb[i] = len(s)
    kw = {}
    if known_distances:
        kw["distances"] = np.array([levenshtein_numpy(seq_a[i][: la[i]], seq_b[i][: lb[i]])
                                    for i in range(B)], np.int64)
    _both(host_dp_counts, seq_a, la, seq_b, lb, band_k=31, **kw)
    assert host_dp_counts["port"] == 0


def test_match_runs_saturate():
    """A 600-base identical pair: match runs saturate at 253 so no code
    exceeds 255, and the walk jumps code - 2 bases per tape entry."""
    rng = np.random.default_rng(1)
    s = rng.integers(0, 4, size=(1, 600)).astype(np.int32)
    n = torch.tensor([600], dtype=torch.int32)
    codes = banded_choices(torch.as_tensor(s), n, torch.as_tensor(s), n, band_k=7)
    assert codes.dtype == torch.uint8 and int(codes.max()) == RUN_CAP + 3
    assert batched_cigar(s, [600], s, [600], band_k=7, device="cpu") == ["600M"]
    ops, counts = banded_traceback_ops(s, [600], s, [600], band_k=7, device="cpu")
    np.testing.assert_array_equal(counts[0, :3], [253, 253, 94])


def test_pads_past_the_lengths_are_never_read():
    a, la, b, lb = _fuzz_pairs(seed=21, n=6)
    pa, pb = a.copy(), b.copy()
    for i in range(len(la)):
        pa[i, la[i]:] = pb[i, lb[i]:] = 1  # pad codes that would match
    assert (batched_cigar(pa, la, pb, lb, band_k=31, device="cpu")
            == batched_cigar(a, la, b, lb, band_k=31, device="cpu"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compare_sequences_and_cigar_equal_jax(seed):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 5, size=int(rng.integers(0, 60))).astype(np.uint8)
    mut = _mutate(rng, ref) if len(ref) > 4 else rng.integers(0, 5, 7).astype(np.uint8)
    got = t_legacy.compare_sequences(ref, mut)
    want = j_legacy.compare_sequences(DNA5SequenceLinear(ref), DNA5SequenceLinear(mut))
    assert [dataclasses.astuple(x) for x in got] == [dataclasses.astuple(x) for x in want]
    assert (t_legacy.edit_items_to_cigar(got, len(ref))
            == j_legacy.edit_items_to_cigar(want, len(ref)))


# --- The walk kernel (csrc/walk.cu), lane by lane --------------------------
#
# A Python mirror of walk_kernel: warps of 32 pairs (the block), each lane a
# pair, one step of every lane at a time over the codes' bytes, addressed by
# the strides the wrapper hands the kernel, each lane's load before the
# vote (inside the codes for an ended lane); the warp leaves its loop when
# every lane is at (0, 0) (__all_sync; lanes past B count as ended), stores
# go to step-major (max_steps, B) tapes, and the steps the warp did not run
# get the OP_END / 0 tail. Held against tb_walk_plain (which tb_walk runs on
# a CPU tensor and the tests above hold against the JAX package's lax.scan
# through the tapes). Change it with the kernel.

def walk_mirror(codes, la_arr, lb_arr, band_k, max_steps, reads=None, trips=None):
    """(ops, counts), each (B, max_steps): the transposed views of the
    kernel's step-major tapes. Each byte read is appended to `reads`, when
    given, as (pair, step, offset from the codes' first byte); each warp's
    loop trips (the steps before its vote ends it) to `trips`."""
    M, B, W = codes.shape
    flat = np.lib.stride_tricks.as_strided(codes, (_span(codes),), (1,))
    row_stride, pair_stride, _ = codes.strides
    ops = np.full((max_steps, B), 99, np.uint8)
    counts = np.full((max_steps, B), -1, np.int32)
    for warp in range(-(-B // 32)):
        lanes = range(warp * 32, warp * 32 + 32)
        i = {p: max(int(la_arr[p]), 0) if p < B else 0 for p in lanes}
        j = {p: max(int(lb_arr[p]), 0) if p < B else 0 for p in lanes}
        s = 0
        while s < max_steps:
            # Every lane loads its clamped cell before the vote, an ended
            # lane and a lane past B (pair 0's codes) too.
            code, at = {}, {}
            for p in lanes:
                c = min(max(j[p] - i[p] + band_k, 0), W - 1)
                row = min(max(i[p] - 1, 0), M - 1)
                at[p] = row * row_stride + (p if p < B else 0) * pair_stride + c
                code[p] = int(flat[at[p]])
            done = {p: i[p] <= 0 and j[p] <= 0 for p in lanes}
            if all(done.values()):  # __all_sync
                break
            for p in lanes:
                op, count = 0, 0
                if not done[p]:
                    if reads is not None:
                        reads.append((p, s, at[p]))
                    code_p = code[p]
                    both = i[p] > 0 and j[p] > 0
                    is_match = both and code_p >= 3
                    take_diag = both and code_p >= 2
                    take_up = (both and code_p == 1) or (i[p] > 0 and j[p] <= 0)
                    take_left = not take_diag and not take_up
                    count = max(code_p - 2, 1) if is_match else 1
                    op = (1 if is_match else 2) if take_diag else 3 if take_up else 4
                    if not take_left:
                        i[p] -= count
                    if not take_up:
                        j[p] -= count
                if p < B:
                    ops[s, p], counts[s, p] = op, count
            s += 1
        if trips is not None:
            trips.append(s)
        real = [p for p in lanes if p < B]
        ops[s:, real], counts[s:, real] = 0, 0  # the tail after the loop
    return ops.T, counts.T


def _span(x):
    return 1 + sum((n - 1) * s for n, s in zip(x.shape, x.strides))


def _walk_inputs(seed, band_k, n=10, S=150):
    a, la, b, lb = _fuzz_pairs(seed=seed, n=n, S=S)
    la, lb = la.copy(), lb.copy()
    la[0], lb[1] = 0, 0
    la[2], lb[2] = 0, 0
    b[3, : lb[3]] = np.random.default_rng(seed).integers(0, 4, lb[3])  # outside the band
    t = [torch.as_tensor(np.asarray(x, np.int32)) for x in (a, la, b, lb)]
    return banded_choices(*t, band_k=band_k), t[1], t[3]


def _pair_major(codes):
    """The same codes in the layout banded_choices hands out on the card."""
    M, B, W = codes.shape
    pitch = -(-M * W // 16) * 16
    buf = torch.zeros((B, pitch), dtype=torch.uint8)
    view = buf.as_strided((M, B, W), (W, pitch, 1))
    view.copy_(codes)
    assert not view.is_contiguous()
    return view


@pytest.mark.parametrize("pair_major", [False, True], ids=["row_major", "pair_major_view"])
@pytest.mark.parametrize("band_k,max_steps", [(7, 60), (31, 140), (31, 9), (63, 300)])
def test_walk_mirror_equals_plain(band_k, max_steps, pair_major):
    codes, la, lb = _walk_inputs(band_k, band_k)
    if pair_major:
        codes = _pair_major(codes)
    ops, counts = tb_walk(codes, la, lb, band_k=band_k, max_steps=max_steps)
    p_ops, p_counts = tb_walk_plain(codes, la, lb, band_k=band_k, max_steps=max_steps)
    assert torch.equal(ops, p_ops) and torch.equal(counts, p_counts)
    m_ops, m_counts = walk_mirror(codes.numpy(), la.numpy(), lb.numpy(), band_k, max_steps)
    assert m_ops.shape == tuple(ops.shape) and m_counts.dtype == np.int32
    np.testing.assert_array_equal(m_ops, ops.numpy())
    np.testing.assert_array_equal(m_counts, counts.numpy())


@pytest.mark.parametrize("pair_major", [False, True], ids=["row_major", "pair_major_view"])
@pytest.mark.parametrize("band_k", [7, 31])
def test_walk_latency_bound_counts_each_warps_new_lines(band_k, pair_major):
    """chip_smoke.walk_new_lines, which prices the walk's latency bound,
    against the mirror's own reads: each pair's live steps, and those whose
    128-byte line no pair of its warp (32 pairs) read at an earlier step."""
    import chip_smoke

    B = 40
    codes, la, lb = _walk_inputs(band_k, band_k, n=B)
    if pair_major:
        codes = _pair_major(codes)
    reads = []
    ops, counts = walk_mirror(codes.numpy(), la.numpy(), lb.numpy(), band_k, 200, reads)
    assert (ops[:, -1] == 0).all()
    first = {}
    for p, s, at in reads:
        key = (p // 32, (codes.data_ptr() + at) // 128)
        first[key] = min(first.get(key, s), s)
    want_new, want_live = np.zeros(B, np.int64), np.zeros(B, np.int64)
    for p, s, at in reads:
        want_live[p] += 1
        want_new[p] += first[(p // 32, (codes.data_ptr() + at) // 128)] == s
    new, live = chip_smoke.walk_new_lines(codes, la, lb, band_k, torch.as_tensor(ops),
                                          torch.as_tensor(counts))
    np.testing.assert_array_equal(live, want_live)
    np.testing.assert_array_equal(new, want_new)
    assert 0 < new.sum() < live.sum()
    # The cold bound's split: new lines on a row below the last 60 rows.
    row_stride = codes.stride(0)
    want_below = np.zeros(B, np.int64)
    for p, s, at in reads:
        row = (at - p * codes.stride(1)) // row_stride
        want_below[p] += (first[(p // 32, (codes.data_ptr() + at) // 128)] == s
                          and row < codes.shape[0] - 60)
    got = chip_smoke.walk_new_lines(codes, la, lb, band_k, torch.as_tensor(ops),
                                    torch.as_tensor(counts), cached_rows=60)
    np.testing.assert_array_equal(got[0], want_new)
    np.testing.assert_array_equal(got[2], want_below)
    assert 0 < want_below.sum() < want_new.sum()


@pytest.mark.parametrize("B,max_steps", [(40, 200), (70, 120), (33, 9)])
def test_walk_mirror_warps_whose_pairs_end_apart(B, max_steps):
    """The kernel's early exit: within a warp the pairs end at different
    steps (lengths 0 to 150, some pairs outside the band), the warp runs
    its longest pair's steps and no more, its ended lanes store OP_END / 0
    in the loop and the tail does after it; the last warp is partial
    (lanes past B take part in the vote only). Tapes equal tb_walk_plain's,
    byte for byte."""
    band_k = 31
    codes, la, lb = _walk_inputs(B, band_k, n=B)
    la[5:9] = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    trips = []
    m_ops, m_counts = walk_mirror(codes.numpy(), la.numpy(), lb.numpy(), band_k, max_steps,
                                  trips=trips)
    p_ops, p_counts = tb_walk_plain(codes, la, lb, band_k=band_k, max_steps=max_steps)
    np.testing.assert_array_equal(m_ops, p_ops.numpy())
    np.testing.assert_array_equal(m_counts, p_counts.numpy())
    live = (p_ops.numpy() != 0).sum(1)
    assert len(trips) == -(-B // 32)
    for w, t in enumerate(trips):
        lanes = live[w * 32:(w + 1) * 32]
        assert t == lanes.max()  # the warp stops after its longest pair
        assert len(lanes) == 1 or len(set(lanes.tolist())) > 1  # pairs end apart
    # Without a cut tape some warp leaves its loop before max_steps.
    assert min(trips) < max_steps or max_steps < 10


def test_walk_mirror_saturated_runs_and_arbitrary_codes():
    rng = np.random.default_rng(1)
    s = torch.as_tensor(rng.integers(0, 4, size=(1, 600)).astype(np.int32))
    n = torch.tensor([600], dtype=torch.int32)
    codes = banded_choices(s, n, s, n, band_k=7)
    ops, counts = tb_walk(codes, n, n, band_k=7, max_steps=12)
    m_ops, m_counts = walk_mirror(codes.numpy(), n.numpy(), n.numpy(), 7, 12)
    np.testing.assert_array_equal(m_counts, counts.numpy())
    np.testing.assert_array_equal(m_counts[0, :4], [253, 253, 94, 0])
    np.testing.assert_array_equal(m_ops, ops.numpy())
    # Any bytes at all, lengths beyond the rows: the clamps keep both inside.
    junk = torch.as_tensor(rng.integers(0, 256, size=(20, 5, 15)).astype(np.uint8))
    la = torch.tensor([20, 25, 3, 0, 19], dtype=torch.int32)
    lb = torch.tensor([20, 9, 30, 6, -4], dtype=torch.int32)
    ops, counts = tb_walk_plain(junk, la, lb, band_k=7, max_steps=50)
    m_ops, m_counts = walk_mirror(junk.numpy(), la.numpy(), lb.numpy(), 7, 50)
    np.testing.assert_array_equal(m_ops, ops.numpy())
    np.testing.assert_array_equal(m_counts, counts.numpy())


def test_walk_wrapper_refuses_what_the_kernel_does_not_take():
    codes = torch.zeros((4, 2, 15), dtype=torch.uint8, device="meta")
    n = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="on the card"):
        tb_walk(codes, n, n, band_k=7, max_steps=5)
