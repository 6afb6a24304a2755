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


# --- The warp body of kernels B4 and B5 (csrc/banded.cu), lane by lane ----
#
# A Python mirror of banded_warp_kernel: 32 lanes of C consecutive band
# cells each, the neighbour's first cell for `up`, the serial prefix-min
# inside a lane, the warp scan of the lanes' last values and the combine,
# the fast path of lanes away from the matrix's edges with its one pad
# cell. With codes (B4) it stages a pair's code stream into 16-byte units
# at a padded pair pitch, and is held against banded_choices_plain, which
# test_torch_traceback.py holds against the JAX package through the tapes;
# without (B5) it reads D[la][lb] from the last row, and is held against
# banded_plain, which the tests above hold against the JAX kernel.

_BIG = 1 << 29


_SCAN_BIG = 1 << 30


def _masked_min(vals, offsets, own):
    """Per lane the min of vals[lane - off] over `offsets` (a lane that has
    no such source reads _SCAN_BIG), and of its own value if `own`."""
    return [min([vals[t]] * own + [vals[t - off] if t >= off else _SCAN_BIG for off in offsets])
            for t in range(32)]


def _lane_cells(k):
    """C, the fewest cells a lane (2, 4, 8 or 16) that cover 2k+1."""
    cells = -(-(2 * k + 1) // 32)
    return next(c for c in (2, 4, 8, 16) if cells <= c)


def _warp_rows(a_row, la, b_row, lb, k):
    """The warp body's row loop over one pair (la, lb already clamped):
    yields, for rows i = 1..la, i and per lane the C cells' (cur, up, diag,
    ne, valid)."""
    W = 2 * k + 1
    C = _lane_cells(k)
    Wb = len(b_row)
    ldb = lambda idx: int(b_row[min(max(idx, 0), Wb - 1)]) if Wb > 0 else 0
    n_real = [min(max(W - t * C, 0), C) for t in range(32)]
    prev = [[(t * C + x - k) if (t * C + x < W and 0 <= t * C + x - k <= lb) else _BIG
             for x in range(C)] for t in range(32)]
    bw = [[ldb(t * C + x - k) for x in range(C)] for t in range(32)]
    b_next = [ldb(t * C + C - k) for t in range(32)]
    for i in range(1, la + 1):
        ai = int(a_row[i - 1])
        nb = [prev[t + 1][0] if t < 31 else _BIG for t in range(32)]
        j_hi = min(lb, i + k)
        lane_rows, g = [], []
        for t in range(32):
            jbase = i - k + t * C
            edge = n_real[t] < C - 1 or jbase < 1 or jbase + n_real[t] - 1 > lb
            up, diag, loc, ne = [], [], [], []
            m = 0
            for x in range(C):
                jx = jbase + x
                valid = (not edge) or 0 <= jx <= j_hi
                up.append((prev[t][x + 1] if x < C - 1 else nb[t]) + 1)
                ne.append(True if edge and not (valid and jx >= 1) else ai != bw[t][x])
                diag.append(prev[t][x] + int(ne[x]))
                base = min(up[x], diag[x])
                if edge:
                    if jx == 0:
                        base = i
                    if not valid:
                        base = _BIG
                m = base if x == 0 else min(m + 1, base)
                loc.append(m)
            lane_rows.append((edge, jbase, up, diag, loc, ne))
            g.append(loc[C - 1] - C * t)
        # Exclusive prefix-min in three rounds: the 4 lanes before, 16, all.
        g = _masked_min(g, (1, 2, 3, 4), own=False)
        g = _masked_min(g, (4, 8, 12), own=True)
        g = _masked_min(g, (16,), own=True)
        cells = []
        for t in range(32):
            edge, jbase, up, diag, loc, ne = lane_rows[t]
            carry0 = g[t] + C * t - C + 1
            lane = []
            for x in range(C):
                valid = (not edge) or 0 <= jbase + x <= j_hi
                cur = min(carry0 + x, loc[x])
                if edge and not valid:
                    cur = _BIG
                if x == C - 1 and n_real[t] == C - 1:
                    cur = _BIG
                lane.append((cur, up[x], diag[x], ne[x], valid))
                prev[t][x] = cur
            cells.append(lane)
            bw[t] = bw[t][1:] + [b_next[t]]
            b_next[t] = ldb(i - k + t * C + C)
        yield i, cells


def _clamp(n, width):
    return min(max(int(n), 0), width)


def banded_choices_warp_mirror(a, la_arr, b, lb_arr, k, M):
    B, Wa = a.shape
    Wb = b.shape[1]
    W = 2 * k + 1
    C = _lane_cells(k)
    pitch = -(-M * W // 16) * 16
    buf = np.full((B, pitch), 0xEE, np.uint8)  # every byte must be written
    stage_rows = 16
    n_real = [min(max(W - t * C, 0), C) for t in range(32)]
    for p in range(B):
        la, lb = _clamp(la_arr[p], Wa), _clamp(lb_arr[p], Wb)
        run = [[0] * C for _ in range(32)]
        stage = np.zeros(stage_rows * W + 32, np.uint8)
        org = 0
        for i, cells in _warp_rows(a[p], la, b[p], lb, k):
            for t in range(32):
                for x, (cur, up, diag, ne, valid) in enumerate(cells[t]):
                    is_diag = cur == diag
                    is_match = is_diag and not ne
                    run[t][x] = min(run[t][x], 252) + 1 if valid and is_match else 0
                    cd = run[t][x] + 2 if is_match else 2 if is_diag else int(cur == up)
                    if not valid:
                        cd = 0
                    if x < n_real[t]:
                        stage[(i - 1) * W - org + t * C + x] = cd
            if i % stage_rows == 0 or i == la:
                filled = i * W - org
                units, rem = filled >> 4, filled & 15
                buf[p, org : org + 16 * units] = stage[: 16 * units]
                keep = stage[16 * units : 16 * units + rem].copy()
                stage[:16] = 0
                stage[:rem] = keep
                org += 16 * units
        if la * W > org:
            buf[p, org : org + 16] = stage[:16]
            org += 16
        buf[p, org:] = 0
    return np.lib.stride_tricks.as_strided(buf, (M, B, W), (W, pitch, 1))


def banded_warp_mirror(a, la_arr, b, lb_arr, k):
    """B5's warp body: (B,) distances, la = 0 and gaps beyond k answered
    before the row loop, D[la][lb] read from the lane that holds cell
    lb - la + k."""
    B, Wa = a.shape
    Wb = b.shape[1]
    C = _lane_cells(k)
    out = np.full(B, -1, np.int64)  # every pair must be written
    for p in range(B):
        la, lb = _clamp(la_arr[p], Wa), _clamp(lb_arr[p], Wb)
        if la == 0 or abs(la - lb) > k:
            out[p] = lb if la == 0 else max(la, lb)
            continue
        for _i, cells in _warp_rows(a[p], la, b[p], lb, k):
            pass
        cs = lb - la + k
        out[p] = cells[cs // C][cs % C][0]
    assert (out >= 0).all()
    return out.astype(np.int32)


def _choices_case(rng, B, S, edits):
    ref = rng.integers(0, 4, S).astype(np.int32)
    a = np.zeros((B, S), np.int32)
    b = np.zeros((B, S + 12), np.int32)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    for i in range(B):
        mut = list(ref)
        for _ in range(int(rng.integers(0, edits + 1))):
            q = int(rng.integers(0, len(mut)))
            r = rng.random()
            if r < 0.6:
                mut[q] = int((mut[q] + 1 + rng.integers(0, 3)) % 4)
            elif r < 0.8 and len(mut) > 1:
                del mut[q]
            elif len(mut) < S + 12:
                mut.insert(q, int(rng.integers(0, 4)))
        la[i] = S - int(rng.integers(0, 9))
        a[i, : la[i]] = ref[: la[i]]
        a[i, la[i]:] = 7  # pads that must never be compared
        lb[i] = len(mut)
        b[i, : lb[i]] = mut
        b[i, lb[i]:] = 7
    if B > 3:
        la[1] = 0
        lb[2] = 0
        b[3, : lb[3]] = rng.integers(0, 4, lb[3])  # unrelated
    if B > 4:
        lb[4] = max(lb[4] - 40, 0)  # a length gap beyond the narrow bands
    return a, la, b, lb


@pytest.mark.parametrize("k,S,B,edits", [
    (31, 150, 6, 10), (63, 200, 5, 40), (127, 300, 4, 60), (255, 330, 3, 100),
    (7, 90, 6, 4), (15, 70, 5, 6), (0, 20, 3, 0), (40, 130, 1, 12),
])
def test_choices_warp_body_mirror_equals_plain(k, S, B, edits):
    rng = np.random.default_rng(k + S)
    a, la, b, lb = _choices_case(rng, B, S, edits)
    want = banded_choices(*(torch.as_tensor(x) for x in (a, la, b, lb)), band_k=k).numpy()
    got = banded_choices_warp_mirror(a, la, b, lb, k, max(S, 1))
    np.testing.assert_array_equal(got, want)


def test_choices_warp_body_mirror_saturated_runs_and_empty_b():
    rng = np.random.default_rng(3)
    s = rng.integers(0, 4, (2, 600)).astype(np.int32)
    n = np.array([600, 600], np.int32)
    want = banded_choices(*(torch.as_tensor(x) for x in (s, n, s, n)), band_k=31).numpy()
    assert int(want.max()) == 255
    np.testing.assert_array_equal(banded_choices_warp_mirror(s, n, s, n, 31, 600), want)
    e = np.zeros((2, 0), np.int32)
    z = np.zeros(2, np.int32)
    want = banded_choices(*(torch.as_tensor(x) for x in (s[:, :40], n // 15, e, z)), band_k=31)
    np.testing.assert_array_equal(
        banded_choices_warp_mirror(s[:, :40], n // 15, e, z, 31, 40), want.numpy())


@pytest.mark.parametrize("k,S,B,edits", [
    (31, 150, 6, 10), (63, 200, 5, 40), (127, 300, 4, 60), (255, 330, 3, 100),
    (7, 90, 6, 4), (15, 70, 5, 6), (0, 20, 3, 0), (40, 130, 1, 12),
])
def test_distance_warp_body_mirror_equals_plain(k, S, B, edits):
    rng = np.random.default_rng(k + S)
    a, la, b, lb = _choices_case(rng, B, S, edits)
    want = banded_distance(*(torch.as_tensor(x) for x in (a, la, b, lb)), band_k=k).numpy()
    np.testing.assert_array_equal(banded_warp_mirror(a, la, b, lb, k), want)


def _edge_pairs(case):
    """(a, la, b, lb, k) for B5's edge cases: la = 0, lb = 0, gaps of k + 1
    on both sides beside one of k, k = 0 and the warp body's widest band."""
    rng = np.random.default_rng(17)
    s = rng.integers(0, 4, (4, 300)).astype(np.int32)
    t = s.copy()
    t[:, ::23] = (t[:, ::23] + 1) % 4
    n = np.full(4, 300, np.int32)
    if case == "la=0":
        return s, np.array([0, 0, 0, 5], np.int32), t, np.array([0, 7, 300, 5], np.int32), 15
    if case == "lb=0":
        return s, np.array([1, 15, 16, 300], np.int32), t, np.zeros(4, np.int32), 15
    if case == "gap>k":
        return s, np.array([300, 100, 200, 132], np.int32), t, np.array([268, 132, 231, 100], np.int32), 31
    if case == "k=0":
        return s, np.array([300, 299, 40, 1], np.int32), np.where(np.arange(300) < 200, s, t), \
            np.array([300, 299, 41, 1], np.int32), 0
    return s, n, rng.integers(0, 4, (4, 300)).astype(np.int32), n - np.array([0, 255, 256, 100], np.int32), 255


@pytest.mark.parametrize("case", ["la=0", "lb=0", "gap>k", "k=0", "k=255"])
def test_distance_warp_body_mirror_edges(case):
    a, la, b, lb, k = _edge_pairs(case)
    want = banded_distance(*(torch.as_tensor(x) for x in (a, la, b, lb)), band_k=k).numpy()
    np.testing.assert_array_equal(banded_warp_mirror(a, la, b, lb, k), want)


@pytest.mark.parametrize("k", [0, 31, 255])
def test_distance_warp_body_mirror_ragged_batch(k):
    """B = 5 pairs of one launch with lengths on both sides of each other,
    within the band and beyond it: each pair's result is its own."""
    rng = np.random.default_rng(5 + k)
    a, _la, b, _lb = _choices_case(rng, 5, 80, 8)
    la = np.array([80, 41, 0, 77, 80], np.int32)
    lb = np.array([79, 41 + k, 80, 80 - 2 * k - 1, 12], np.int32).clip(0, 80)
    want = banded_distance(*(torch.as_tensor(x) for x in (a, la, b, lb)), band_k=k).numpy()
    np.testing.assert_array_equal(banded_warp_mirror(a, la, b, lb, k), want)
