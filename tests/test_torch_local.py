"""The local (infix, edlib HW mode) distance of the port against the JAX
package, on the CPU: the cell-level plain version (kgl_gene_tpu_torch/ops/
edit_distance.py batched_levenshtein_local, the CPU route and the card's
oracle), the word-level plain version of kernel `local`
(ops/local.py bitvector_local_plain) and a lane-level mirror of the kernel
(csrc/wavefront.cu, bitvector_kernel<G, K, true>) against JAX's
batched_levenshtein_local and a scalar infix DP. Lengths 0-300, both
orders, a shared row, codes >= 32, the 64-row block edges and, in the
mirror, stripe and slot edges; the group layout (G lanes a pair, 32 // G
pairs a warp) at the edges of its table, at kelch13's 2,181 bases, on
warps of mixed lengths and odd codes; the layout rule (local_layout) and
its table. Distances are integers: equality is exact."""

import numpy as np
import pytest
import torch

from kgl_gene_tpu.ops.edit_distance import batched_levenshtein_local as j_local
from kgl_gene_tpu_torch.ops.edit_distance import batched_levenshtein_local
from kgl_gene_tpu_torch.ops.local import (
    GROUP_MIN_PAIRS, GROUP_SYMBOLS, LOCAL_LAYOUTS, batched_levenshtein_local_kernel,
    bitvector_local_plain, live_share, local_layout, local_levenshtein, local_smem_bytes,
)
from kgl_gene_tpu_torch.ops.wavefront import MAX_KERNEL_LEN, SMEM_LIMIT

MASK = (1 << 64) - 1
U64 = np.uint64


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def scalar_hw(query, target):
    """Textbook O(mn) infix DP: D[0][j] = 0, min over the last row."""
    m, n = len(query), len(target)
    prev = [0] * (n + 1)
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if query[i - 1] == target[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return min(prev)


def scalar_local(a, b):
    """The symmetric metric: the shorter sequence is the query, a on a tie."""
    return scalar_hw(list(a), list(b)) if len(a) <= len(b) else scalar_hw(list(b), list(a))


def _u(x):
    return np.asarray(x, dtype=np.uint64)


def local_kernel_mirror(a, la, b, lb, *, G=None, K=None, lanes=32):
    """Lane-level mirror of bitvector_kernel<G, K, true> over a launch: a
    (B, Wa), b (B or 1, Wb) int32 rows, la, lb (B,); returns (B,) ints.

    Each block is one warp of `lanes` lanes (32 in the kernel) holding P =
    lanes // G pairs, lanes t of group grp = lane // G; lanes past the last
    group or the last pair run on pair p0's state with nothing live. Per
    pair: the swap, the pad rows ahead of the query (matching every symbol,
    vertical delta 0), the warp's match-word build (32 rows a
    __match_any_sync, half words, the pad rows' bits after), the systolic
    skew of 64-row blocks over the group's G lanes and K slots with `off`
    idle slots ahead of block 0 (so that the last block is the last slot of
    the group's last lane), the shuffles from the lane above (the group's
    lane 0 from its last lane), the symbols from a chunk of G columns loaded
    G steps ahead, the zero top carry, odd codes' words built on the spot.
    G = lanes (the default) is the layout of a pair a warp: stripes whose
    carries pass through two byte buffers (the last stripe's too: row lq's
    deltas) and a scan of `lanes` columns at a time; K defaults to B3's.
    G < lanes is the group layout: one stripe (G K >= the blocks), the warp
    looping to its longest group, one buffer a pair, each group's scan of G
    columns by shuffles from lane t - o and its minimum by a cyclic tree.
    lanes < 32 with G = lanes reaches the stripe and slot edges at small
    lengths."""
    a, b = np.asarray(a), np.asarray(b)
    la, lb = np.asarray(la), np.asarray(lb)
    B, Wa = a.shape
    Wb = b.shape[1]
    G = lanes if G is None else G
    grouped = G < lanes
    if K is None:
        assert not grouped
        K = 1 if min(Wa, Wb) <= 64 * lanes else 2
    P, span = lanes // G, G * K
    rows = GROUP_SYMBOLS if grouped else 32
    nblk_pad = max(-(-min(Wa, Wb) // 64), 1) | 1
    hstride = -(-(max(Wa, Wb) + (0 if grouped else lanes * K)) // 16) * 16
    nbuf = 1 if grouped else 2
    if grouped:
        assert span * 64 >= min(Wa, Wb)
    lane = np.arange(lanes)
    grp = lane // G if grouped else np.zeros(lanes, int)
    t = lane - grp * G
    ks = np.arange(K)
    out = np.full(B, -1)

    def pair(p):
        la0, lb0 = min(max(int(la[p]), 0), Wa), min(max(int(lb[p]), 0), Wb)
        swap = la0 > lb0
        row_b = b[0 if b.shape[0] == 1 else p]
        return (lb0, la0, row_b, a[p]) if swap else (la0, lb0, a[p], row_b)

    for p0 in range(0, B, P):
        has = ~np.zeros(lanes, bool) if not grouped else (grp < P) & (p0 + grp < B)
        p = np.where(has, p0 + grp, p0)
        st = [pair(int(x)) for x in p]
        lq = np.array([x[0] for x in st])
        lt = np.array([x[1] for x in st])
        if not grouped and (lq[0] == 0 or lt[0] == 0):
            out[p0] = 0  # an empty query matches
            continue
        lb_run = np.where(grouped & ~(has & (lq > 0)), 0, lt)
        nblk = (lq + 63) >> 6
        pad = -lq & 63
        pad_rows = _u([(1 << int(x)) - 1 for x in pad])
        gs = np.where(has, grp, 0)
        peq = np.zeros(P * rows * nblk_pad, np.uint64)
        hbytes = np.zeros(P * nbuf * hstride, np.uint8)  # the top carry 0

        def build(base, row, n, pd):  # the warp's 32 lanes, whatever `lanes`
            half = peq.view(np.uint32)
            for q in range(-(-(n + pd) // 32)):
                i = q * 32 + np.arange(32) - pd
                inn = (i >= 0) & (i < n)
                c = np.where(inn, row[np.clip(i, 0, max(len(row) - 1, 0))], -1)
                for ln in range(32):
                    first = int(np.flatnonzero(c == c[ln])[0])  # __ffs(__match_any_sync)
                    if inn[ln] and 0 <= c[ln] < rows and first == ln:
                        m = sum(1 << int(x) for x in np.flatnonzero(c == c[ln]))
                        half[(base + int(c[ln]) * nblk_pad + (q >> 1)) * 2 + (q & 1)] = m
            for c in range(rows):  # the pad rows match every symbol
                peq[base + c * nblk_pad] |= U64((1 << pd) - 1)

        for g in range(P):
            if p0 + g < B:
                n, _, row, _ = pair(p0 + g)
                build(g * rows * nblk_pad, row, n, -n & 63)

        src = np.where(t > 0, lane - 1, lane + G - 1) if grouped else (lane + lanes - 1) % lanes
        off = span - nblk if grouped else (span - nblk % span) % span
        vblk = span if grouped else int(nblk[0] + off[0])
        words = {}

        def odd_word(ln, blk, c):  # match_word_padded
            key = (int(p[ln]), blk, c)
            if key not in words:
                n, _, row, _ = st[ln]
                base = blk * 64 - int(pad[ln])
                words[key] = sum(1 << r for r in range(min(64, n - base))
                                 if base + r < 0 or int(row[base + r]) == c)
            return words[key]

        for r, blk0 in enumerate(range(0, vblk, span)):
            nact = min(span, vblk - blk0)
            keeps = t == G - 1
            hin = gs * nbuf * hstride + (0 if grouped else (r & 1) * hstride)
            hout = gs * nbuf * hstride + (0 if grouped else ((r + 1) & 1) * hstride)
            blk = blk0 + G * ks[None, :] + t[:, None] - off[:, None]  # (lanes, K)
            lb_mine = np.where(blk >= 0, lb_run[:, None], 0)
            peq_blk = (gs * rows * nblk_pad)[:, None] + np.maximum(blk, 0)
            vp = np.where(blk == 0, ~pad_rows[:, None], U64(MASK)).astype(np.uint64)
            vn = np.zeros((lanes, K), np.uint64)
            carry = np.zeros((lanes, K), int)
            c_mine = np.zeros((lanes, K), np.int64)
            textp = [x[3] for x in st]

            def load(col):  # bp[col] where col < lb_run, else 0
                return np.array([int(textp[ln][col[ln]]) if col[ln] < lb_run[ln] else 0
                                 for ln in range(lanes)], np.int64)

            chunk = np.zeros(lanes, np.int64)
            ahead = load(t)
            steps = lb_run + nact - 1
            steps = int(np.where(lb_run > 0, steps, 0).max()) if grouped else int(steps[0])
            for s in range(steps):
                u = s % G
                if u == 0:
                    chunk, ahead = ahead, load(s + G + t)
                c0 = chunk[(grp * G + u) % lanes]
                h0 = 0 if grouped else hbytes[hin + s]
                c_up, h_up = c_mine[src % lanes], carry[src % lanes]
                c = np.where(t[:, None] > 0, c_up,
                             np.where(ks[None, :] > 0, np.roll(c_up, 1, axis=1), c0[:, None]))
                h = np.where(t[:, None] > 0, h_up,
                             np.where(ks[None, :] > 0, np.roll(h_up, 1, axis=1),
                                      np.broadcast_to(np.asarray(h0)[..., None], (lanes, 1))))
                c_mine = c
                live = ((s - t[:, None] - G * ks[None, :]) >= 0) & (
                    (s - t[:, None] - G * ks[None, :]) < lb_mine)
                known = (c >= 0) & (c < rows)
                eq = peq[peq_blk + np.where(known, c, 0) * nblk_pad]
                for ln, k in zip(*np.nonzero(live & ~known)):
                    eq[ln, k] = U64(odd_word(ln, int(blk[ln, k]), int(c[ln, k])))
                ph_in, mh_in = _u(h & 1), _u(h >> 1)
                xv = eq | vn
                eq2 = eq | mh_in
                xh = (((eq2 & vp) + vp) ^ vp) | eq2
                ph = vn | ~(xh | vp)
                mh = vp & xh
                carry_out = (ph >> U64(63)).astype(int) | ((mh >> U64(63)).astype(int) << 1)
                ph = (ph << U64(1)) | ph_in
                mh = (mh << U64(1)) | mh_in
                vp = np.where(live, mh | ~(xv | ph), vp)
                vn = np.where(live, ph & xv, vn)
                carry = np.where(live, carry_out, carry)
                for ln in np.flatnonzero(keeps & live[:, K - 1]):
                    hbytes[hout[ln] + s - (G - 1) - G * (K - 1)] = carry[ln, K - 1]
        if grouped:
            assert all(blk[ln, K - 1] == nblk[ln] - 1 for ln in range(lanes) if has[ln] and t[ln] == G - 1)
            run, best = lq.copy(), lq.copy()
            for c0 in range(0, int(lb_run.max()), G):
                hh = np.where(c0 + t < lb_run, hbytes[hout + np.minimum(c0 + t, hstride - 1)], 0).astype(int)
                d = (hh & 1) - (hh >> 1)
                o = 1
                while o < G:
                    v = d[(lane - o) % lanes]
                    d = d + np.where(t >= o, v, 0)
                    o <<= 1
                best = np.minimum(best, run + d)
                run = run + d[(grp * G + G - 1) % lanes]
            o = 1
            while o < G:
                best = np.minimum(best, best[(grp * G + (t + o) % G) % lanes])
                o <<= 1
            for ln in np.flatnonzero(has & (t == 0)):
                out[p[ln]] = best[ln]
        else:
            assert blk[lanes - 1, K - 1] == nblk[0] - 1  # the last block is the last slot
            hl = hout[0]
            run = best = int(lq[0])  # D[lq][0]
            for c0 in range(0, int(lt[0]), lanes):  # a warp scan of `lanes` columns
                d = [(int(x) & 1) - (int(x) >> 1) for x in
                     (hbytes[hl + c0 + ln] if c0 + ln < lt[0] else 0 for ln in range(lanes))]
                prefix = np.cumsum(d)
                best = min(best, run + int(prefix.min()))
                run += int(prefix[-1])
            out[p0] = best
    return out


def _pairs(seed, B, Ma, Mb, alphabet, *, lo=0):
    rng = np.random.default_rng(seed)
    sa = rng.integers(lo, alphabet, (B, Ma)).astype(np.int32)
    sb = rng.integers(lo, alphabet, (B, Mb)).astype(np.int32)
    la = rng.integers(0, Ma + 1, B).astype(np.int32)
    lb = rng.integers(0, Mb + 1, B).astype(np.int32)
    return sa, la, sb, lb


def _want(sa, la, sb, lb):
    shared = sb.shape[0] == 1
    return np.array([scalar_local(sa[i, : la[i]], sb[0 if shared else i, : lb[i]])
                     for i in range(len(la))])


@pytest.mark.parametrize("seed,B,Ma,Mb,alphabet", [
    (0, 12, 40, 70, 5),     # a shorter than b, one block
    (1, 12, 70, 40, 5),     # a longer: the query swaps
    (2, 8, 150, 150, 4),    # equal widths, ties keep a as the query
    (3, 6, 300, 260, 5),    # five blocks
    (4, 8, 90, 90, 40),     # codes 32..39 beside 0..31
])
def test_plain_versions_match_jax_and_scalar_dp(seed, B, Ma, Mb, alphabet):
    sa, la, sb, lb = _pairs(seed, B, Ma, Mb, alphabet)
    la[0], lb[1], la[2], lb[2] = 0, 0, 0, 0
    la[3], lb[3] = Ma, Mb
    want = _want(sa, la, sb, lb)
    cell = batched_levenshtein_local(*_t(sa, la, sb, lb))
    word = bitvector_local_plain(*_t(sa, la, sb, lb))
    assert cell.dtype == word.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(j_local(sa, la, sb, lb)), want)
    np.testing.assert_array_equal(cell.numpy(), want)
    np.testing.assert_array_equal(word.numpy(), want)


@pytest.mark.parametrize("lq", [63, 64, 65, 127, 128, 129, 192, 256, 257])
def test_block_edges(lq):
    """Query lengths at the 64-row block edges, against targets just
    shorter, equal and longer (lq == lt keeps a as the query)."""
    rng = np.random.default_rng(lq)
    for lt in (lq - 1, lq, lq + 37):
        B = 4
        sa = rng.integers(0, 4, (B, lq)).astype(np.int32)
        sb = rng.integers(0, 4, (B, lt)).astype(np.int32)
        sb[1, 5 : 5 + min(lq, lt) - 10] = sa[1, : min(lq, lt) - 10]  # a near match
        la = np.full(B, lq, np.int32)
        lb = np.full(B, lt, np.int32)
        want = _want(sa, la, sb, lb)
        np.testing.assert_array_equal(bitvector_local_plain(*_t(sa, la, sb, lb)).numpy(), want)
        np.testing.assert_array_equal(batched_levenshtein_local(*_t(sa, la, sb, lb)).numpy(),
                                      want)
        np.testing.assert_array_equal(np.asarray(j_local(sa, la, sb, lb)), want)


def test_shared_row():
    """One (1, Mb) row shared by every pair, as reference_distances
    passes the reference."""
    sa, la, sb, _ = _pairs(5, 10, 120, 100, 5)
    lb = np.full(10, 90, np.int32)
    sb = sb[:1]
    want = _want(sa, la, sb, lb)
    np.testing.assert_array_equal(bitvector_local_plain(*_t(sa, la, sb, lb)).numpy(), want)
    np.testing.assert_array_equal(batched_levenshtein_local(*_t(sa, la, sb, lb)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(j_local(sa, la, np.repeat(sb, 10, 0), lb)), want)


def test_codes_outside_0_31_and_negative():
    sa, la, sb, lb = _pairs(6, 8, 80, 110, 3)
    sa = sa * 1000 - 7  # -7, 993, 1993
    sb = sb * 1000 - 7
    sa[0, :4] = [-2**31, 2**31 - 1, 31, 32]
    sb[0, :4] = [-2**31, 2**31 - 1, 32, 31]
    la[0], lb[0] = 40, 90
    want = _want(sa, la, sb, lb)
    np.testing.assert_array_equal(bitvector_local_plain(*_t(sa, la, sb, lb)).numpy(), want)
    np.testing.assert_array_equal(batched_levenshtein_local(*_t(sa, la, sb, lb)).numpy(), want)


def test_pads_beyond_lt_never_enter_the_minimum():
    """The target's pad copies the query: a minimum taken past lt would
    read 0."""
    q = np.array([[1, 2, 3, 0, 1, 2, 3, 0]], np.int32)
    t = np.zeros((1, 40), np.int32)
    t[0, :12] = 3
    t[0, 12:20] = q[0]
    la, lb = np.array([8], np.int32), np.array([12], np.int32)
    want = scalar_local(q[0], t[0, :12])
    assert want > 0
    for fn in (bitvector_local_plain, batched_levenshtein_local):
        assert int(fn(*_t(q, la, t, lb))[0]) == want


@pytest.mark.parametrize("seed,Ma,Mb", [(0, 50, 90), (1, 130, 70), (2, 200, 200), (3, 1, 300)])
def test_mirror_matches_plain_one_stripe(seed, Ma, Mb):
    """The mirror with the kernel's 32 lanes (K = 1, one stripe)."""
    sa, la, sb, lb = _pairs(seed, 4, Ma, Mb, 5)
    la[0], lb[0] = Ma, Mb
    la[1] = 0
    want = bitvector_local_plain(*_t(sa, la, sb, lb)).numpy()
    np.testing.assert_array_equal(local_kernel_mirror(sa, la, sb, lb), want)


@pytest.mark.parametrize("lanes,K", [(2, 1), (2, 2), (3, 2)])
@pytest.mark.parametrize("lq", [64, 128, 129, 256, 257, 300])
def test_mirror_stripe_and_slot_edges(lanes, K, lq):
    """Fewer lanes put the stripe edge (lanes * K blocks) and the slot
    edge (lanes blocks) at small lengths: the owner of the last block at
    each, queries in several stripes, both orders and lq == lt."""
    rng = np.random.default_rng(lq * 7 + lanes * K)
    for lt, flip in ((lq + 21, False), (lq, False), (lq + 5, True)):
        q = rng.integers(0, 4, lq).astype(np.int32)
        t = rng.integers(0, 4, lt).astype(np.int32)
        t[3 : 3 + lq // 2] = q[: lq // 2]
        a, b = (t, q) if flip else (q, t)
        want = scalar_local(a, b)
        assert local_kernel_mirror(a[None], [len(a)], b[None], [len(b)], lanes=lanes, K=K)[0] == want


def _query_cases(seed, lq, shape, B=6):
    """B pairs whose query has lq rows: a shorter than b ("shorter"),
    equal lengths ("equal", a stays the query) or a longer, so the query
    is b ("swap"); codes in -3..39 (outside 0..31 on both sides) with a
    near copy of the query in the target of every other pair. Rows are at
    least 5 wide (lq = 0: the lengths are 0, the rows not empty)."""
    rng = np.random.default_rng(seed)
    lt = lq + 45 if shape != "equal" else lq
    q = rng.integers(-3, 40, (B, max(lq, 5))).astype(np.int32)
    t = rng.integers(-3, 40, (B, max(lt, 5))).astype(np.int32)
    for i in range(0, B, 2):
        at = int(rng.integers(0, lt - lq + 1))
        t[i, at:at + lq] = q[i, :lq]
        t[i, at + lq // 2:at + lq // 2 + 1] = 41  # one substitution
    q[0, :min(lq, 2)] = [-2**31, 2**31 - 1][:min(lq, 2)]
    lens_q, lens_t = np.full(B, lq, np.int32), np.full(B, lt, np.int32)
    if shape == "swap":
        return t, lens_t, q, lens_q
    return q, lens_q, t, lens_t


@pytest.mark.parametrize("shape", ["shorter", "equal", "swap"])
@pytest.mark.parametrize("lq", [0, 1, 63, 64, 65, 128])
def test_pad_rows_plain_equals_jax(lq, shape):
    """bitvector_local_plain (pad rows ahead of the query, row lq's deltas
    read as the last block's carries, the minimum after the scan) against
    JAX's batched_levenshtein_local and the scalar DP, exactly, at the
    64-row block edges, lq == lt, the swap, lq = 0 and odd codes."""
    sa, la, sb, lb = _query_cases(lq * 10 + len(shape), lq, shape)
    want = _want(sa, la, sb, lb)
    np.testing.assert_array_equal(np.asarray(j_local(sa, la, sb, lb)), want)
    np.testing.assert_array_equal(bitvector_local_plain(*_t(sa, la, sb, lb)).numpy(), want)


@pytest.mark.parametrize("lq", [1, 63, 65, 128])
def test_mirror_pad_rows_and_odd_codes(lq):
    """The lane mirror at the kernel's 32 lanes on the same cases: pad
    rows in match words built on the spot for codes outside 0..31."""
    for shape in ("shorter", "swap"):
        sa, la, sb, lb = _query_cases(lq + len(shape), lq, shape, B=2)
        np.testing.assert_array_equal(local_kernel_mirror(sa, la, sb, lb), _want(sa, la, sb, lb))


def test_cpu_tensor_takes_the_cell_level_version():
    sa, la, sb, lb = _pairs(8, 6, 60, 60, 5)
    got = batched_levenshtein_local_kernel(*_t(sa, la, sb, lb))
    np.testing.assert_array_equal(got.numpy(), _want(sa, la, sb, lb))
    np.testing.assert_array_equal(local_levenshtein(sa, la, sb, lb, device="cpu"),
                                  _want(sa, la, sb, lb))


def test_entry_point_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sa, la, sb, lb = _pairs(9, 2, 10, 10, 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local_levenshtein(sa, la, sb, lb)


def test_shared_memory_limit_is_b3s():
    """The pattern is the narrower width: a narrow row against the widest
    text fits, as it does for B3."""
    assert local_smem_bytes(MAX_KERNEL_LEN, MAX_KERNEL_LEN) <= SMEM_LIMIT
    assert local_smem_bytes(MAX_KERNEL_LEN + 64, MAX_KERNEL_LEN + 64) > SMEM_LIMIT
    assert local_smem_bytes(3000, MAX_KERNEL_LEN) == local_smem_bytes(MAX_KERNEL_LEN, 3000)


# The layout kernel `local` takes at each width (many pairs): (G, K), the
# pattern's blocks and the live share PERF.md states, at the table's edges.
LAYOUT_TABLE = {
    2048: ((32, 1), 32, 1.0),
    2112: ((5, 7), 33, 0.8839),
    2181: ((5, 7), 35, 0.9375),  # kelch13
    2304: ((6, 6), 36, 0.9375),
    3000: ((8, 6), 47, 0.9792),
    3072: ((8, 6), 48, 1.0),
    4096: ((32, 2), 64, 1.0),
}


@pytest.mark.parametrize("W", sorted(LAYOUT_TABLE))
def test_layout_table_covers_the_pattern(W):
    """At GROUP_MIN_PAIRS pairs the rule's layout covers the pattern in one
    stripe (G K >= its blocks), fits its groups in the warp (G P <= 32) and
    in shared memory, and has the live share PERF.md states."""
    layout, nblk, share = LAYOUT_TABLE[W]
    G, K = local_layout(GROUP_MIN_PAIRS, W, W)
    assert (G, K) == layout and (G, K) in LOCAL_LAYOUTS
    assert -(-W // 64) == nblk and G * K >= nblk and G * (32 // G) <= 32
    assert round(live_share(nblk, G, K), 4) == share
    assert local_smem_bytes(W, W, (G, K)) <= SMEM_LIMIT
    assert local_layout(GROUP_MIN_PAIRS, W, W + 900) == (G, K)  # a wider text


def test_layout_rule_keeps_a_pair_a_warp():
    """A pair a warp at B3's K below GROUP_MIN_PAIRS pairs (the shared-row
    launch of reference_distances), up to 2,048 rows (no group layout has a
    larger live share) and above 4,096 rows (stripes); a narrow query
    against a wide text takes a layout that fits."""
    assert local_layout(256, 2181, 2181) == (32, 2)
    assert local_layout(GROUP_MIN_PAIRS - 1, 2181, 2181) == (32, 2)
    assert local_layout(GROUP_MIN_PAIRS, 2181, 2181) == (5, 7)
    assert local_layout(32640, 2048, 2048) == (32, 1)  # 32 blocks: no group layout does better
    assert local_layout(32640, 4097, 4097) == (32, 2)
    assert local_layout(32640, 12300, 12300) == (32, 2)
    G, K = local_layout(32640, 2181, MAX_KERNEL_LEN)
    assert G < 32 and G * K >= 35 and local_smem_bytes(2181, MAX_KERNEL_LEN, (G, K)) <= SMEM_LIMIT
    # 35 blocks: today's 53% live against the group layout's 93.8%.
    assert round(live_share(35, 32, 2), 4) == 0.5469


def test_group_layout_shared_memory():
    """kelch13 at (5, 7): 6 pairs of 5 match words x 35 blocks and 2,192
    carry bytes; B3's layout of a pair a warp: 13,472 bytes."""
    assert local_smem_bytes(2181, 2181, (5, 7)) == 6 * (GROUP_SYMBOLS * 35 * 8 + 2192) == 21552
    assert local_smem_bytes(2181, 2181) == local_smem_bytes(2181, 2181, (32, 2)) == 13472


def test_kernel_instantiates_the_table():
    """csrc/wavefront.cu instantiates exactly LOCAL_LAYOUTS (at most six)
    and keeps GROUP_SYMBOLS match words a block in the group layout."""
    import re
    from pathlib import Path

    import kgl_gene_tpu_torch

    src = (Path(kgl_gene_tpu_torch.__file__).parent / "csrc" / "wavefront.cu").read_text()
    cases = re.findall(r"case (\d+): return f\(integral_constant<int, (\d+)>\(\), "
                       r"integral_constant<int, (\d+)>\(\)\);", src)
    assert {(int(g), int(k)) for _c, g, k in cases} == set(LOCAL_LAYOUTS)
    assert all(int(c) == 100 * int(g) + int(k) for c, g, k in cases)
    assert len(LOCAL_LAYOUTS) <= 6
    assert re.search(r"constexpr int SIGMA_GROUP = (\d+);", src).group(1) == str(GROUP_SYMBOLS)


def _family(seed, lengths, Wa, Wb, lo=0, hi=5):
    """Rows (a, b) of widths Wa, Wb for each (la, lb): b carries a near
    copy of a's middle (a few substitutions), codes lo..hi - 1; the pads
    past each length copy the other row's start."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    a = rng.integers(lo, hi, (B, Wa)).astype(np.int32)
    b = rng.integers(lo, hi, (B, Wb)).astype(np.int32)
    la = np.array([x for x, _ in lengths], np.int32)
    lb = np.array([y for _, y in lengths], np.int32)
    for i, (x, y) in enumerate(lengths):
        n = min(x, y) // 2
        if n:
            at = int(rng.integers(0, y - n + 1))
            piece = a[i, (x - n) // 2:(x - n) // 2 + n].copy()
            piece[rng.random(n) < 0.02] = lo
            b[i, at:at + n] = piece
        a[i, x:] = np.resize(b[i], Wa - x)
        b[i, y:] = np.resize(a[i], Wb - y)
    return a, la, b, lb


@pytest.mark.parametrize("nblk", [33, 35, 36, 47, 48, 64])
def test_group_mirror_at_the_layout_edges(nblk):
    """The mirror in the rule's layout at each edge of the table (a warp's
    pairs: the full width, one row short of it, the last block a single
    row, the other order) against the word-level plain version."""
    W = 64 * nblk - 5
    G, K = local_layout(GROUP_MIN_PAIRS, W, W)
    P = 32 // G
    full = [(W, W), (W - 1, W), (64 * (nblk - 1) + 1, W), (W, W - 3), (W - 64, W - 7),
            (W - 2, W - 2)]
    a, la, b, lb = _family(nblk, full[:max(P, 2)], W, W)
    want = bitvector_local_plain(*_t(a, la, b, lb)).numpy()
    np.testing.assert_array_equal(local_kernel_mirror(a, la, b, lb, G=G, K=K), want)


def test_group_mirror_kelch13_both_orders():
    """2,181 against 2,181 at (5, 7), a warp of six pairs, in both orders
    (lq == lt keeps a as the query, so the orders differ)."""
    a, la, b, lb = _family(2181, [(2181, 2181)] * 6, 2181, 2181)
    for x, lx, y, ly in ((a, la, b, lb), (b, lb, a, la)):
        want = bitvector_local_plain(*_t(x, lx, y, ly)).numpy()
        np.testing.assert_array_equal(local_kernel_mirror(x, lx, y, ly, G=5, K=7), want)


def test_group_mirror_mixed_warp():
    """A warp whose pairs differ in length: an empty query, a pair that ends
    long before the warp's last step, a one-row query, both orders; eight
    pairs, so the second warp holds two pairs and four lanes' groups none."""
    lengths = [(0, 2181), (2181, 2181), (300, 520), (2181, 100), (1, 7), (2000, 2181),
               (2181, 0), (1500, 2181)]
    a, la, b, lb = _family(7, lengths, 2181, 2181)
    want = bitvector_local_plain(*_t(a, la, b, lb)).numpy()
    np.testing.assert_array_equal(local_kernel_mirror(a, la, b, lb, G=5, K=7), want)
    assert want[0] == want[6] == 0


def test_group_mirror_odd_codes_and_shared_row():
    """Codes outside 0..4 (match words built on the spot, pad bits
    included), negative and >= 32, in the group layout; and one (1, Mb) row
    shared by every pair."""
    lengths = [(700, 650), (640, 700), (65, 700), (700, 700), (1, 300), (0, 5)]
    a, la, b, lb = _family(3, lengths, 700, 700, lo=-3, hi=40)
    a[0, :2] = [-2**31, 2**31 - 1]
    b[1, :3] = [2**31 - 1, 32, 5]
    want = bitvector_local_plain(*_t(a, la, b, lb)).numpy()
    np.testing.assert_array_equal(local_kernel_mirror(a, la, b, lb, G=5, K=7), want)
    ref = b[3:4]
    lr = np.full(len(lengths), 680, np.int32)
    want = _want(a[:, :100], np.minimum(la, 100), ref, np.minimum(lr, 100))
    got = local_kernel_mirror(a[:, :100], np.minimum(la, 100), ref[:, :100], np.minimum(lr, 100),
                              G=5, K=7)
    np.testing.assert_array_equal(got, want)
    want = bitvector_local_plain(*_t(a, la, ref, lr)).numpy()
    np.testing.assert_array_equal(local_kernel_mirror(a, la, ref, lr, G=5, K=7), want)


@pytest.mark.parametrize("G,K", [(2, 1), (2, 3), (3, 2), (4, 2), (5, 1), (7, 2)])
def test_group_mirror_small_layouts(G, K):
    """Small groups at small lengths against the scalar DP: many pairs a
    warp, ragged lengths, empty rows, the widths at G K blocks, codes 0..5."""
    W = 64 * G * K
    sa, la, sb, lb = _pairs(G * 10 + K, 21, W, W - 17, 6)
    la[0], lb[1] = 0, 0
    la[2], lb[2] = W, W - 17
    np.testing.assert_array_equal(local_kernel_mirror(sa, la, sb, lb, G=G, K=K),
                                  _want(sa, la, sb, lb))
