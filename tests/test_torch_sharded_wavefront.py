"""The port's sharded long-pair wavefront (ops/sharded_wavefront.py)
against the JAX package's sharded_levenshtein on the 8-device CPU mesh and
the numpy DP, at worlds 1 (in this process), 2 and 4 (gloo ranks on the
CPU, one spawn a world with its own deadline; the rank body is in
tests/torch_ranks.py). The cases mirror tests/test_sharded_wavefront.py;
its 32,768-base pair runs on the card (chip_smoke.py phase 3i).

wavefront_chunk_mirror below is a lane-level mirror of csrc/
sharded_wavefront.cu's kernel (its tiles of T + H threads, the text run in
shared memory, the block-level halo, the capture and the owned-lane
stores), held against chunk_plain chunk by chunk; change it with the
kernel.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_ranks  # noqa: E402
from kgl_gene_tpu.ops.edit_distance import levenshtein_numpy  # noqa: E402
from kgl_gene_tpu.ops.sharded_wavefront import sharded_levenshtein as j_sharded  # noqa: E402
from kgl_gene_tpu_torch.ops import sharded_wavefront as sw  # noqa: E402
from kgl_gene_tpu_torch.parallel.dist import SampleMesh, run_ranks  # noqa: E402

RANK_TIMEOUT_S = 90.0


def _pad(rows, width):
    out = np.zeros((len(rows), width), dtype=np.int32)
    lens = np.zeros(len(rows), dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
        lens[i] = len(r)
    return out, lens


def _small_pairs():
    rng = np.random.default_rng(0)
    a_rows = [rng.integers(0, 4, n) for n in (257, 100, 31, 256)]
    b_rows = [rng.integers(0, 4, n) for n in (190, 211, 257, 256)]
    return (*_pad(a_rows, 257), *_pad(b_rows, 257), 32), a_rows, b_rows


def _degenerate():
    seq_a = np.zeros((3, 8), dtype=np.int32)
    seq_b = np.zeros((3, 8), dtype=np.int32)
    seq_b[1, :5] = [1, 2, 3, 0, 1]
    len_a = np.array([0, 0, 1], dtype=np.int32)
    len_b = np.array([0, 5, 0], dtype=np.int32)
    return (seq_a, len_a, seq_b, len_b, 16), None, None


def _related_pair():
    """4,000 bases with SNPs and indels."""
    rng = np.random.default_rng(1)
    a = rng.integers(0, 4, 4000)
    b = a.copy()
    idx = rng.choice(4000, 25, replace=False)
    b[idx] = (b[idx] + 1 + rng.integers(0, 3, 25)) % 4
    b = np.delete(b, rng.choice(len(b), 7, replace=False))
    b = np.insert(b, rng.choice(len(b), 5, replace=False), rng.integers(0, 4, 5))
    return (*_pad([a], 4000), *_pad([b], 4000), 128), [a], [b]


CASES = {"small_pairs": _small_pairs(), "degenerate": _degenerate(),
         "related_4000": _related_pair()}
NAMES = tuple(CASES)


def _jax(name):
    (a, la, b, lb, halo), _a, _b = CASES[name]
    return j_sharded(a, la, b, lb, mesh=Mesh(np.array(jax.devices()), ("wave",)), halo=halo)


def _oracle(name):
    args, a_rows, b_rows = CASES[name]
    if a_rows is None:
        return [0, 5, 1]
    return [levenshtein_numpy(a, b) for a, b in zip(a_rows, b_rows)]


@pytest.fixture(scope="module", params=(2, 4), ids=lambda w: f"world{w}")
def ranks(request):
    out = run_ranks(torch_ranks.wavefront_checks, request.param, device="cpu",
                    timeout_s=RANK_TIMEOUT_S, args=([CASES[n][0] for n in NAMES],))
    return dict(zip(NAMES, zip(*out)))


@pytest.mark.parametrize("name", NAMES)
def test_one_rank_equals_jax_and_oracle(name):
    args, _a, _b = CASES[name]
    got = sw.sharded_levenshtein(*args[:4], mesh=SampleMesh.single("cpu"), halo=args[4])
    assert got.dtype == np.int32
    assert got.tolist() == _oracle(name) == _jax(name).tolist()


@pytest.mark.parametrize("name", NAMES)
def test_ranks_equal_jax_and_oracle(ranks, name):
    want = _jax(name).tolist()
    assert want == _oracle(name)
    for got in ranks[name]:  # every rank holds the whole result
        assert got.tolist() == want


def _simulate(seq_a, la, seq_b, lb, world, halo, step):
    """Every rank of a world in this process, in lock step, the ring
    exchange done by hand: the final rank lanes and the summed result."""
    states = [sw.rank_lanes(seq_a, la, seq_b, lb, r, world, halo, "cpu") for r in range(world)]
    for c in range(states[0].n_chunks):
        states = [sw.run_chunk(s, c, step) for s in states]
        sends = [sw.halo_lanes(s) for s in states]
        if world > 1:
            for r, s in enumerate(states):
                sw.refresh_halo(s, sends[(r - 1) % world])
    return states, sum(s.result for s in states).numpy()


def wavefront_chunk_mirror(s: sw.RankLanes, d0: int) -> None:
    """csrc/sharded_wavefront.cu's launch, block by block and lane by lane
    in numpy, on the same buffers as chunk."""
    a_lane, b, la, lb = (x.numpy() for x in (s.a_lane, s.b, s.la, s.lb))
    in_pp, in_p = s.pp.numpy(), s.p.numpy()
    out_pp, out_p, result = s.out_pp.numpy(), s.out_p.numpy(), s.result.numpy()
    B, W = a_lane.shape
    H = s.H
    n = min(512 if H <= 256 else 1024, -(-W // 32) * 32)  # threads a block
    T = n - H
    big = s.Ma + s.Mb + 1
    for pair in range(B):
        for tile in range(-(-(W - H) // T)):
            k0 = tile * T
            m = np.arange(n)
            k = k0 + m
            i = s.i0 + k
            in_w = k < W
            kc = np.minimum(k, W - 1)
            lane_ok = in_w & (i >= 0) & (i <= s.Ma)
            ac = np.where(in_w, a_lane[pair, kc], -1)
            p = np.where(in_w, in_p[pair, kc], big)
            left_pp = np.where((m > 0) & in_w, in_pp[pair, np.maximum(kc - 1, 0)], big)
            pp = np.where(in_w, in_pp[pair, kc], big)
            j_lo = d0 - (s.i0 + k0) - (n - 1)
            jx = j_lo + np.arange(n + H - 1)
            sb = np.where((jx >= 1) & (jx <= s.Mb),
                          b[pair, np.clip(jx - 1, 0, b.shape[1] - 1)], -2)
            capture = (m >= H) & in_w & (i == la[pair])
            for t in range(H):
                d = d0 + t
                left_p = np.concatenate([[big], p[:-1]])  # the buffer of step t
                j = d - i
                cand = np.minimum(np.minimum(left_p, p) + 1,
                                  left_pp + (ac != sb[t - m + n - 1]))
                cand = np.where(j == 0, i, cand)
                cand = np.where(i == 0, j, cand)
                cand = np.where(lane_ok & (j >= 0) & (j <= s.Mb), cand, big)
                if d == la[pair] + lb[pair] and capture.any():
                    result[pair] = cand[capture][0]
                left_pp, pp, p = left_p, p, cand
            own = (m >= H) & in_w
            out_p[pair, k[own]] = p[own]
            out_pp[pair, k[own]] = pp[own]


@pytest.mark.parametrize("world, halo", [(1, 32), (1, 300), (2, 32), (3, 128), (4, 600)])
def test_kernel_mirror_equals_plain_chunk_by_chunk(world, halo):
    """The kernel's tiling on ragged pairs (empty, one base, several tiles
    of a rank, a halo wider than a rank's lanes): every rank's owned lanes
    after every chunk and the distances equal chunk_plain's and the DP's."""
    rng = np.random.default_rng(7)
    a_rows = [rng.integers(0, 4, n) for n in (700, 0, 1, 130, 64)]
    b_rows = [rng.integers(0, 4, n) for n in (650, 5, 0, 131, 1)]
    args = (*_pad(a_rows, 700), *_pad(b_rows, 650))
    plain = [sw.rank_lanes(*args, r, world, halo, "cpu") for r in range(world)]
    mirror = [sw.rank_lanes(*args, r, world, halo, "cpu") for r in range(world)]
    for c in range(plain[0].n_chunks):
        plain = [sw.run_chunk(s, c, sw.chunk_plain) for s in plain]
        mirror = [sw.run_chunk(s, c, wavefront_chunk_mirror) for s in mirror]
        for got, want in zip(mirror, plain):
            assert torch.equal(got.p[:, got.H:], want.p[:, want.H:])
            assert torch.equal(got.pp[:, got.H:], want.pp[:, want.H:])
        for states in (plain, mirror):
            sends = [sw.halo_lanes(s) for s in states]
            if world > 1:
                for r, s in enumerate(states):
                    sw.refresh_halo(s, sends[(r - 1) % world])
    want = [levenshtein_numpy(a, b) for a, b in zip(a_rows, b_rows)]
    assert sum(s.result for s in plain).tolist() == want
    assert sum(s.result for s in mirror).tolist() == want


@pytest.mark.parametrize("world", (1, 2, 3, 5))
def test_rank_geometry_owns_every_lane_once(world):
    """The ranks' owned lanes tile rows 0..la exactly, each rank's halo is
    min(halo, its lanes), and the simulated ranks give the DP's distances."""
    (a, la, b, lb, _h), a_rows, b_rows = CASES["small_pairs"]
    states = [sw.rank_lanes(a, la, b, lb, r, world, 400, "cpu") for r in range(world)]
    owned = np.concatenate([s.i0 + np.arange(s.H, s.H + s.Wl) for s in states])
    np.testing.assert_array_equal(owned[: int(la.max()) + 1], np.arange(int(la.max()) + 1))
    assert all(s.H == min(400, s.Wl) for s in states)
    _states, got = _simulate(a, la, b, lb, world, 400, sw.chunk_plain)
    assert got.tolist() == [levenshtein_numpy(x, y) for x, y in zip(a_rows, b_rows)]
