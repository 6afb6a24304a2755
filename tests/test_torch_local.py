"""The local (infix, edlib HW mode) distance of the port against the JAX
package, on the CPU: the cell-level plain version (kgl_gene_tpu_torch/ops/
edit_distance.py batched_levenshtein_local, the CPU route and the card's
oracle), the word-level plain version of kernel `local`
(ops/local.py bitvector_local_plain) and a lane-level mirror of the kernel
(csrc/wavefront.cu, bitvector_kernel<K, true>) against JAX's
batched_levenshtein_local and a scalar infix DP. Lengths 0-300, both
orders, a shared row, codes >= 32, the 64-row block edges and, in the
mirror, stripe and slot edges. Distances are integers: equality is exact."""

import numpy as np
import pytest
import torch

from kgl_gene_tpu.ops.edit_distance import batched_levenshtein_local as j_local
from kgl_gene_tpu_torch.ops.edit_distance import batched_levenshtein_local
from kgl_gene_tpu_torch.ops.local import (
    batched_levenshtein_local_kernel, bitvector_local_plain, local_levenshtein, local_smem_bytes,
)
from kgl_gene_tpu_torch.ops.wavefront import MAX_KERNEL_LEN, SMEM_LIMIT

MASK = (1 << 64) - 1


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


def local_kernel_mirror(a, la0, b, lb0, lanes=32, K=None):
    """Lane-level mirror of bitvector_kernel<K, true> for one pair: the
    per-pair swap, the pad rows ahead of the query (matching every symbol,
    vertical delta 0), B3's systolic skew of 64-row blocks over `lanes`
    lanes and K slots with `off` idle slots ahead of block 0 (so that the
    last block is the last slot of lane lanes - 1), the shuffles from the
    lane above, stripes whose carries pass through two byte buffers (the
    last stripe's too: row lq's deltas), the zero top carry, and the scan
    of those deltas `lanes` columns at a time.
    lanes=32 with K from the pattern's width is the kernel; fewer lanes
    reach the stripe and slot edges at small lengths."""
    Wa, Wb = len(a), len(b)
    la0, lb0 = min(max(la0, 0), Wa), min(max(lb0, 0), Wb)
    swap = la0 > lb0
    la, lb = (lb0, la0) if swap else (la0, lb0)
    ap, bp = (b, a) if swap else (a, b)
    if la == 0 or lb == 0:
        return 0
    if K is None:
        K = 1 if min(Wa, Wb) <= 64 * lanes else 2
    pad = -la & 63
    nblk = (la + pad) >> 6
    assert nblk == (la + 63) >> 6

    words = {}  # Peq: (code, block) -> match word over the padded rows

    def match(c, blk):
        if (c, blk) not in words:
            base = blk * 64 - pad
            words[c, blk] = sum(1 << r for r in range(min(64, la - base))
                                if base + r < 0 or int(ap[base + r]) == c)
        return words[c, blk]

    hstride = -(-(max(Wa, Wb) + lanes * K) // 16) * 16
    hbytes = [[0] * hstride, [0] * hstride]  # top carry 0 in both buffers
    span = lanes * K
    off = (span - nblk % span) % span
    vblk = nblk + off
    hout = None
    for r, blk0 in enumerate(range(0, vblk, span)):
        nact = min(span, vblk - blk0)
        hin, hout = hbytes[r & 1], hbytes[(r + 1) & 1]
        blk = [[blk0 + lanes * k + ln - off for k in range(K)] for ln in range(lanes)]
        lb_mine = [[lb if 0 <= blk[ln][k] < nblk else 0 for k in range(K)]
                   for ln in range(lanes)]
        vp = [[MASK & ~((1 << pad) - 1) if blk[ln][k] == 0 else MASK for k in range(K)]
              for ln in range(lanes)]
        vn = [[0] * K for _ in range(lanes)]
        carry = [[0] * K for _ in range(lanes)]
        c_mine = [[0] * K for _ in range(lanes)]
        for s in range(lb + nact - 1):
            c0 = int(bp[s]) if s < lb else 0
            h0 = hin[s]
            c_up = [[c_mine[(ln - 1) % lanes][k] for k in range(K)] for ln in range(lanes)]
            h_up = [[carry[(ln - 1) % lanes][k] for k in range(K)] for ln in range(lanes)]
            for ln in range(lanes):
                for k in range(K):
                    c = c_up[ln][k] if ln else (c_up[0][k - 1] if k else c0)
                    h = h_up[ln][k] if ln else (h_up[0][k - 1] if k else h0)
                    c_mine[ln][k] = c
                    live = 0 <= s - ln - lanes * k < lb_mine[ln][k]
                    eq = match(c, min(max(blk[ln][k], 0), nblk - 1))
                    ph_in, mh_in = h & 1, h >> 1
                    xv = eq | vn[ln][k]
                    eq2 = eq | mh_in
                    xh = ((((eq2 & vp[ln][k]) + vp[ln][k]) & MASK) ^ vp[ln][k]) | eq2
                    ph = (vn[ln][k] | ~(xh | vp[ln][k])) & MASK
                    mh = vp[ln][k] & xh
                    carry_out = (ph >> 63) | ((mh >> 63) << 1)
                    ph = ((ph << 1) | ph_in) & MASK
                    mh = ((mh << 1) | mh_in) & MASK
                    if live:
                        vp[ln][k] = (mh | ~(xv | ph)) & MASK
                        vn[ln][k] = ph & xv
                        carry[ln][k] = carry_out
            col = s - (lanes - 1) - lanes * (K - 1)
            if 0 <= col < lb_mine[lanes - 1][K - 1]:  # every stripe keeps its carries
                hout[col] = carry[lanes - 1][K - 1]
    assert blk[lanes - 1][K - 1] == nblk - 1  # the last block is the last slot
    run = best = la  # D[la][0]
    for c0 in range(0, lb, lanes):  # a warp scan of `lanes` columns
        d = [(h & 1) - (h >> 1) for h in
             (hout[c0 + ln] if c0 + ln < lb else 0 for ln in range(lanes))]
        prefix = np.cumsum(d)
        best = min(best, run + int(prefix.min()))
        run += int(prefix[-1])
    return best


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
    got = [local_kernel_mirror(sa[i], int(la[i]), sb[i], int(lb[i])) for i in range(4)]
    np.testing.assert_array_equal(got, want)


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
        assert local_kernel_mirror(a, len(a), b, len(b), lanes=lanes, K=K) == want


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
        got = [local_kernel_mirror(sa[i], int(la[i]), sb[i], int(lb[i])) for i in range(2)]
        np.testing.assert_array_equal(got, _want(sa, la, sb, lb))


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
