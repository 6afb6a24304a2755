"""The port's sharded long-pair wavefront (ops/sharded_wavefront.py)
against the JAX package's sharded_levenshtein on the 8-device CPU mesh and
the numpy DP, at worlds 1 (in this process), 2 and 4 (gloo ranks on the
CPU, one spawn a world with its own deadline; the rank body is in
tests/torch_ranks.py). The cases mirror tests/test_sharded_wavefront.py;
its 32,768-base pair runs on the card (chip_smoke.py phase 3i).

chunk_launch_mirror below is a lane-level mirror of csrc/
sharded_wavefront.cu's kernel (4 lanes a thread, the shuffle from the
thread to the left, the warps' 8 halo lanes refreshed every 8 steps, the
16-byte text loads and the code window, the tile geometry, the dead tiles,
steps with no edge selects, the capture and the owned-lane stores with the
sentinel off the table), held against
chunk_plain chunk by chunk, a chunk as the wrapper runs it (sub-steps past
MAX_SUB_HALO) and a run of chunks as the cooperative launch runs it.
Change it with the kernel.
"""

import re
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


def _ragged(extra=()):
    """Ragged pairs: empty, one base, several tiles of a rank; `extra`
    (length of a, length of b) pairs after them."""
    rng = np.random.default_rng(7)
    a_rows = [rng.integers(0, 4, n) for n in (700, 0, 1, 130, 64)]
    b_rows = [rng.integers(0, 4, n) for n in (650, 5, 0, 131, 1)]
    a_rows += [rng.integers(0, 4, n) for n, _m in extra]
    b_rows += [rng.integers(0, 4, m) for _n, m in extra]
    return (*_pad(a_rows, 700), *_pad(b_rows, 650)), a_rows, b_rows


def _mirror_chunk_by_chunk(world, halo, step, extra=()):
    """Every rank's owned lanes after every chunk through `step` against
    chunk_plain's, and both results against the DP."""
    args, a_rows, b_rows = _ragged(extra)
    plain = [sw.rank_lanes(*args, r, world, halo, "cpu") for r in range(world)]
    mirror = [sw.rank_lanes(*args, r, world, halo, "cpu") for r in range(world)]
    for c in range(plain[0].n_chunks):
        plain = [sw.run_chunk(s, c, sw.chunk_plain) for s in plain]
        mirror = [sw.run_chunk(s, c, step) for s in mirror]
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


def chunk_launch_mirror(s: sw.RankLanes, src, dst, d0: int, h: int, k_first: int,
                        sms: int) -> None:
    """One launch of kgt_wavefront_chunk (h steps from diagonal d0, tiles
    laid from local lane k_first, captures on lanes >= s.H) in numpy, every
    pair and tile at once, thread by thread: src and dst are (pp, p) numpy
    (B, W) arrays; writes dst's lanes [k_first + h, W) and s.result. The
    steps have no edge selects (cells off the table hold what the
    recurrence gives them, a warp's lane 0 its own shuffled value); the
    stores write the sentinel off the table."""
    R, S = sw.CHUNK_LANES_A_THREAD, sw.CHUNK_EXCHANGE_STEPS
    L = 32 * R
    a_lane, b, la, lb = (x.numpy() for x in (s.a_lane, s.b, s.la, s.lb))
    result = s.result.numpy()
    B, W = a_lane.shape
    warps, T, tiles = sw.chunk_geometry(W - k_first - h, h, B, sms)
    nl = sw.block_lanes(warps)
    assert T == nl - h >= 1 and warps <= sw.CHUNK_MAX_WARPS and h <= sw.MAX_SUB_HALO
    big = s.Ma + s.Mb + 1
    w, m, x = np.meshgrid(np.arange(warps), np.arange(32), np.arange(R), indexing="ij")
    lf = w * (L - S) + R * m                    # the block lane of a thread's lane 0
    ell = lf + x                                # (warps, 32, R) block lanes
    own = (w == 0) | (m >= S // R)              # the lanes a warp writes
    assert nl % 4 == 0 and (lf % 4 == 0).all() and ell.max() == nl - 1
    k0 = k_first + T * np.arange(tiles)
    k = k0[:, None, None, None] + ell           # (tiles, warps, 32, R) local lanes
    out_lane = own & (ell >= h) & (k < W)
    i_lo, i_hi = s.i0 + k0, s.i0 + k0 + nl - 1
    lo, hi = np.maximum(i_lo, 0), np.minimum(i_hi, s.Ma)
    dead = (lo > hi) | (lo > d0 + h - 1) | (hi < min(d0, d0 + h - 2) - s.Mb)
    d_hit, k_la = la + lb, la - s.i0
    capture = (((d_hit >= d0) & (d_hit < d0 + h))[:, None]
               & (k_la[:, None] >= k0) & (k_la[:, None] < k0 + nl))
    t_hit = np.where(capture, (d_hit - d0)[:, None], -1)  # (B, tiles)
    in_w = k < W
    kc = np.minimum(k, W - 1)
    ac = np.where(in_w, a_lane[:, kc], -1)
    p = np.where(in_w, src[1][:, kc], big)
    pp = np.where(in_w, src[0][:, kc], big)
    cap_lane = (own & (ell >= h) & (k[None] == k_la[:, None, None, None, None])
                & (k_la >= s.H)[:, None, None, None, None] & (k_la < W)[:, None, None, None, None])
    # the text run of each (pair, tile), read 4 codes (16 bytes) at a time
    n_sb = (nl + h + 8 + 3) & ~3
    j = d0 - s.i0 - k0[:, None] - nl + np.arange(n_sb)  # (tiles, n_sb)
    sb = np.where((j >= 1) & (j <= s.Mb), b[:, np.clip(j - 1, 0, b.shape[1] - 1)], -2)
    sb4 = sb.reshape(B, tiles, n_sb // 4, 4)
    q = (nl - lf[:, :, 0]) // 4                 # (warps, 32)
    t_ix = np.arange(tiles)[:, None, None]
    bc = np.zeros_like(p)
    first = sb4[:, t_ix, q - 1]                 # (B, tiles, warps, 32, 4)
    bc[..., 0], bc[..., 1], bc[..., 2] = first[..., 3], first[..., 2], first[..., 1]

    def shfl_up(v):  # __shfl_up_sync(v, 1) across each warp's 32 threads
        return np.concatenate([v[..., :1], v[..., :-1]], -1)

    up0, diag0 = shfl_up(p[..., R - 1]), shfl_up(pp[..., R - 1])

    def step(t, code):
        nonlocal up0, diag0, p, pp
        bc[..., 1:] = bc[..., :-1].copy()
        bc[..., 0] = code
        up = np.concatenate([up0[..., None], p[..., :-1]], -1)
        diag = np.concatenate([diag0[..., None], pp[..., :-1]], -1)
        # the three-way min over the values plus one: a match takes diag itself
        cand = np.minimum(np.minimum(up + 1, p + 1), np.where(ac == bc, diag, diag + 1))
        hit = cap_lane & (t_hit == t)[:, :, None, None, None]
        for pair in np.nonzero(hit.any(axis=(1, 2, 3, 4)))[0]:
            assert hit[pair].sum() == 1
            result[pair] = cand[pair][hit[pair]][0]
        diag0, up0 = up0, shfl_up(cand[..., R - 1])
        pp, p = p, cand

    t = 0
    while t + S <= h:
        for u in range(S):  # a run of four steps from one 16-byte load
            step(t + u, sb4[:, t_ix, q + (t + u) // 4][..., u % 4])
        if t + S < h:  # each warp's first S lanes from the last S of the warp to its left
            for v in (p, pp):
                flat = v.reshape(*v.shape[:2], warps, L)
                flat[:, :, 1:, :S] = flat[:, :, :-1, L - S:].copy()
            up0, diag0 = shfl_up(p[..., R - 1]), shfl_up(pp[..., R - 1])
        t += S
    for t in range(t, h):  # the last h % 8 steps: a 4-byte load a step
        step(t, sb[:, t_ix, 4 * q + t])
    i = s.i0 + k
    jj = d0 + h - 1 - i
    on_p = (i >= 0) & (i <= s.Ma) & (jj >= 0) & (jj <= s.Mb)
    on_pp = (i >= 0) & (i <= s.Ma) & (jj >= 1) & (jj <= s.Mb + 1)
    dead = dead[None, :, None, None, None]
    p = np.where(on_p & ~dead, p, big)
    pp = np.where(on_pp & ~dead, pp, big)
    for pair in range(B):
        dst[1][pair, k[out_lane]] = p[pair][out_lane]
        dst[0][pair, k[out_lane]] = pp[pair][out_lane]


def new_chunk_mirror(sms: int):
    """sharded_wavefront.chunk's launches in numpy: the sub_steps of the
    chunk, each from the last exact lane of the one before, through
    scratch buffers (filled with a value no lane may keep), the last into
    the out buffers."""

    def step(s: sw.RankLanes, d0: int) -> None:
        B, W = s.a_lane.shape
        src = (s.pp.numpy(), s.p.numpy())
        steps = sw.sub_steps(s.H)
        k_first = 0
        for n, h in enumerate(steps):
            last = n == len(steps) - 1
            dst = ((s.out_pp.numpy(), s.out_p.numpy()) if last
                   else (np.full((B, W), -7, np.int32), np.full((B, W), -7, np.int32)))
            chunk_launch_mirror(s, src, dst, d0 + k_first, h, k_first, sms)
            src, k_first = dst, k_first + h

    return step


def chunks_launch_mirror(s: sw.RankLanes, c0: int, n: int, sms: int) -> sw.RankLanes:
    """kgt_wavefront_chunks in numpy: n chunks, chunk c reading (pp0, p0)
    and writing (pp1, p1) when c is even and the other way when odd (the
    grid barrier between them), then run_chunks' swap when n is odd."""
    bufs = [(s.pp.numpy(), s.p.numpy()), (s.out_pp.numpy(), s.out_p.numpy())]
    for c in range(n):
        chunk_launch_mirror(s, bufs[c % 2], bufs[1 - c % 2], 2 + (c0 + c) * s.H, s.H, 0, sms)
    return s._replace(pp=s.out_pp, p=s.out_p, out_pp=s.pp, out_p=s.p) if n % 2 else s


@pytest.mark.parametrize("world, halo, sms, max_sub", [
    (1, 32, 6, 512), (1, 128, 132, 512), (1, 300, 6, 512), (1, 600, 132, 512),
    (1, 1024, 6, 512), (2, 32, 132, 512), (2, 600, 6, 512), (2, 600, 132, 200),
    (3, 128, 6, 512), (3, 128, 132, 50), (3, 1024, 132, 512), (4, 300, 132, 512),
    (4, 600, 6, 512)])
def test_new_body_mirror_equals_plain_chunk_by_chunk(world, halo, sms, max_sub, monkeypatch):
    """The kernel's schedule on the ragged pairs at worlds 1-4,
    halos 32 to 1,024 and the tile geometry of a card of `sms` SMs (6: wide
    blocks of several warps at every halo): every rank's owned lanes after
    every chunk and the distances equal chunk_plain's and the DP's. A chunk
    past MAX_SUB_HALO runs as sub-steps; `max_sub` below the kernel's 512
    splits the chunks of the ranks past world 1 too; the pair of 200 x 100
    bases ends in rank 1's halo lanes at world 3, in a first sub-step, where
    only rank 0 may capture it."""
    monkeypatch.setattr(sw, "MAX_SUB_HALO", max_sub)
    _mirror_chunk_by_chunk(world, halo, new_chunk_mirror(sms), extra=((200, 100),))


@pytest.mark.parametrize("halo, sms, runs", [
    (32, 6, (5, 0)), (128, 132, (1, 0)), (300, 6, (3, 2)), (512, 132, (0, 3))])
def test_multi_chunk_mirror_equals_run_chunk(halo, sms, runs):
    """The cooperative launch's schedule at world 1: runs of chunks (the
    first `runs[0]` chunks in one launch, then `runs[1]`, then the rest),
    buffers swapped inside the launch and d0 moved a chunk at a time, equal
    lane for lane to as many run_chunk calls of chunk_plain, the captures
    included, and to the DP."""
    args, a_rows, b_rows = _ragged()
    plain = sw.rank_lanes(*args, 0, 1, halo, "cpu")
    assert plain.H <= sw.MAX_SUB_HALO and len(sw.sub_steps(plain.H)) == 1
    mirror = sw.rank_lanes(*args, 0, 1, halo, "cpu")
    c = 0
    for n in (*runs, plain.n_chunks - sum(runs)):
        plain = sw.run_chunks_plain(plain, c, n)
        mirror = chunks_launch_mirror(mirror, c, n, sms)
        c += n
        assert torch.equal(mirror.p[:, mirror.H:], plain.p[:, plain.H:])
        assert torch.equal(mirror.pp[:, mirror.H:], plain.pp[:, plain.H:])
        assert torch.equal(mirror.result, plain.result)
    want = [levenshtein_numpy(a, b) for a, b in zip(a_rows, b_rows)]
    assert plain.result.tolist() == want
    assert sw.run_chunks(sw.rank_lanes(*args, 0, 1, halo, "cpu"), 0,
                         plain.n_chunks).result.tolist() == want


@pytest.mark.parametrize("halo", (600, 1024))
@pytest.mark.parametrize("name", ("small_pairs", "related_4000"))
def test_one_rank_halo_past_the_first_cap_equals_jax_and_oracle(name, halo):
    """sharded_levenshtein at world 1 with halos over one launch's 512
    diagonals (sub-steps) equals the JAX package's and the DP."""
    (a, la, b, lb, _h), _a, _b = CASES[name]
    got = sw.sharded_levenshtein(a, la, b, lb, mesh=SampleMesh.single("cpu"), halo=halo)
    want = j_sharded(a, la, b, lb, mesh=Mesh(np.array(jax.devices()), ("wave",)), halo=halo)
    assert got.tolist() == want.tolist() == _oracle(name)


def test_chunk_geometry_and_the_kernel_constants():
    """The wrapper's geometry constants are the kernel's; at the card's 132
    SMs the 32,768-base pair's chunks of 128 diagonals take 114 tiles of 4
    warps (288 owned lanes) at world 1 and 86 of 3 warps a rank at world 2
    (the busiest SM's lanes fewest); sub_steps split any halo into launches
    of at most MAX_SUB_HALO."""
    src = (Path(sw.__file__).resolve().parent.parent / "csrc" / "sharded_wavefront.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kR"]), int(consts["kS"]), int(consts["kMaxWarps"]),
            int(consts["kMaxHalo"])) == (sw.CHUNK_LANES_A_THREAD, sw.CHUNK_EXCHANGE_STEPS,
                                         sw.CHUNK_MAX_WARPS, sw.MAX_SUB_HALO)
    assert sw.chunk_geometry(32_769, 128, 1, 132) == (4, 288, 114)
    assert sw.chunk_geometry(16_385, 128, 1, 132) == (3, 192, 86)
    for H in (1, 7, 128, 512, 513, 600, 1024, 5_000, 49_153):
        steps = sw.sub_steps(H)
        assert sum(steps) == H and max(steps) <= sw.MAX_SUB_HALO and min(steps) >= 1
        assert max(steps) - min(steps) <= 1
        for h in steps:
            warps, T, tiles = sw.chunk_geometry(10_000, h, 1, 132)
            assert sw.block_lanes(warps) == h + T and T >= 1 and tiles * T >= 10_000


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
