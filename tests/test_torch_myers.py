"""The port's plain banded Myers (the plain version of kernel B1) against
the JAX package's myers_banded_levenshtein in interpret mode, on the CPU,
with the cases of test_myers_kernel.py and the frozen oracle distances.

Inside the exactness contract (distance <= k and |la - lb| <= k) both
equal the oracle exactly. Outside it the two windows differ (64-row words
here, 32-row there), so both are only required to be >= the oracle and
> k."""

import numpy as np
import pytest
import torch

from kgl_gene_tpu.ops.edit_distance import levenshtein_numpy
from kgl_gene_tpu.ops.pallas_myers import myers_banded_levenshtein as j_myers
from kgl_gene_tpu_torch.ops.myers import (
    MYERS_BANDS,
    myers_band_for,
    myers_banded_levenshtein,
    myers_distance_padded,
    myers_layout,
)
from test_myers_kernel import _indel_mutate, _mutated_pairs


def _check(sa, la, sb, lb, k):
    got = myers_banded_levenshtein(sa, la, sb, lb, band_k=k, device="cpu")
    ref = j_myers(sa, la, sb, lb, band_k=k, interpret=True)
    want = np.array([levenshtein_numpy(sa[i, : la[i]], sb[i, : lb[i]])
                     for i in range(len(la))])
    exact = (want <= k) & (np.abs(la - lb) <= k)
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_array_equal(ref[exact], want[exact])
    assert np.all(got >= want) and np.all(ref >= want)
    assert np.all(got[~exact] > k) and np.all(ref[~exact] > k)
    return got, want, exact


@pytest.mark.parametrize("M,k,edits", [(150, 63, 4), (640, 63, 4), (300, 31, 60)])
def test_substitution_pairs(M, k, edits):
    rng = np.random.default_rng(M + edits)
    sa, sb = _mutated_pairs(rng, 6, M, edits)
    la = np.full(6, M, np.int32)
    _check(sa, la, sb, la, k)


def test_variable_lengths():
    rng = np.random.default_rng(2)
    B, M = 6, 320
    sa, sb0 = _mutated_pairs(rng, B, M, 3)
    sb = np.zeros((B, M + 16), np.int32)
    sb[:, :M] = sb0
    la = np.full(B, M, np.int32)
    lb = la + rng.integers(-16, 17, B).astype(np.int32)
    _, _, exact = _check(sa, la, sb, lb, 31)
    assert exact.all()


def test_empty_sequences_and_length_gap():
    sa = np.zeros((2, 8), np.int32)
    got = myers_banded_levenshtein(sa, np.array([0, 4]), sa, np.array([3, 0]),
                                   band_k=63, device="cpu")
    np.testing.assert_array_equal(got, [3, 4])
    z = np.zeros((1, 200), np.int32)
    got = myers_banded_levenshtein(z, np.array([200]), z, np.array([40]),
                                   band_k=31, device="cpu")
    assert got[0] > 31 and got[0] >= 160


@pytest.mark.parametrize("M,k", [(90, 31), (640, 63), (1030, 127), (700, 255)])
def test_indel_fuzz(M, k):
    rng = np.random.default_rng(42 + k)
    B, W = 6, M + 120
    sa = np.zeros((B, W), np.int32)
    sb = np.zeros((B, W), np.int32)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    for i in range(B):
        base = rng.integers(0, 5, M).astype(np.int32)
        mut = _indel_mutate(rng, base, int(rng.integers(0, k + k // 2)))[:W]
        sa[i, :M] = base
        la[i] = M
        lb[i] = len(mut)
        sb[i, : len(mut)] = mut
    _check(sa, la, sb, lb, k)


@pytest.mark.parametrize("k", [31, 127])
def test_edits_at_both_ends(k):
    """Insertions and deletions at the first and last positions: the row-0
    boundary (D[0][j] = j) and the end of the band both matter here."""
    rng = np.random.default_rng(k)
    M, B = 300, 6
    base = rng.integers(0, 5, M).astype(np.int32)
    sa = np.tile(base, (B, 1))
    sb = np.zeros((B, M + 20), np.int32)
    lb = np.zeros(B, np.int32)
    for i in range(B):
        head = rng.integers(0, 5, i + 1).astype(np.int32)
        mut = np.concatenate([head, base[i + 2 :]]) if i % 2 else np.concatenate(
            [base[i + 1 :], head])
        sb[i, : len(mut)] = mut
        lb[i] = len(mut)
    _, _, exact = _check(sa, np.full(B, M, np.int32), sb, lb, k)
    assert exact.all()


def test_shared_text_equals_per_pair():
    rng = np.random.default_rng(9)
    M, B = 400, 6
    ref = rng.integers(0, 5, M).astype(np.int32)
    sa = np.tile(ref, (B, 1))
    for i in range(B):
        pos = rng.choice(M, 3 + i, replace=False)
        sa[i, pos] = (sa[i, pos] + 1 + rng.integers(0, 4, len(pos))) % 5
    la = np.full(B, M, np.int32)
    la[3] = M - 10
    lb = np.full(B, M, np.int32)
    t = [torch.as_tensor(x) for x in (sa, la, ref[None, :], lb, np.tile(ref, (B, 1)))]
    shared = myers_distance_padded(t[0], t[1], t[2], t[3], band_k=31)
    per_pair = myers_distance_padded(t[0], t[1], t[4], t[3], band_k=31)
    want = [levenshtein_numpy(sa[i, : la[i]], ref) for i in range(B)]
    np.testing.assert_array_equal(shared.numpy(), want)
    np.testing.assert_array_equal(per_pair.numpy(), want)


def test_frozen_oracle_distances():
    from test_frozen_oracle import EXPECT, REF_CODING

    code = {c: i for i, c in enumerate("ACGTN")}
    codings = [v[0] for v in EXPECT.values()]
    W = max(len(REF_CODING), *map(len, codings))
    sa = np.zeros((len(codings), W), np.int32)
    la = np.zeros(len(codings), np.int32)
    for i, s in enumerate(codings):
        sa[i, : len(s)] = [code[c] for c in s]
        la[i] = len(s)
    sb = np.zeros_like(sa)
    sb[:, : len(REF_CODING)] = [code[c] for c in REF_CODING]
    lb = np.full(len(codings), len(REF_CODING), np.int32)
    got = myers_banded_levenshtein(sa, la, sb, lb, band_k=31, device="cpu")
    np.testing.assert_array_equal(got, [v[2] for v in EXPECT.values()])


def test_bands_and_layout():
    assert myers_band_for(10) == 31
    assert myers_band_for(63) == 63
    assert myers_band_for(64) == 127
    assert myers_band_for(600) is None
    assert MYERS_BANDS[-1] == 511
    assert [myers_layout(k) for k in MYERS_BANDS] == [(1, 3), (1, 3), (2, 5), (4, 9), (8, 17)]
    with pytest.raises(ValueError):
        myers_layout(64)


def test_kernel_wrapper_refuses_non_cpu_tensors_it_cannot_launch():
    x = torch.zeros(2, 8, dtype=torch.int32, device="meta")
    n = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="on the card"):
        myers_distance_padded(x, n, x, n, band_k=31)


# --- The group body of csrc/myers.cu, lane by lane -------------------------
#
# A Python mirror of myers_group_kernel: groups of NB lanes in a 32-lane
# warp, block beta in lane beta mod NB working on the four columns from
# 4 (s - beta) at step s, the carries read from the lane above as that lane
# left them one step earlier, rotating ownership at the window's slide,
# and D[la][lb] read down column lb from the blocks' vertical deltas where
# each stopped. Held against myers_plain, which the tests above hold
# against the JAX kernel and the oracle.

_M64 = (1 << 64) - 1


_COLS = 8  # text columns a step


def _column(eq, h, vp, vn):
    """One column through a 64-row block; h and the result hold ph (bit 0)
    and mh (bit 1). Returns (carries out, vp, vn)."""
    ph_in, mh_in = h & 1, (h >> 1) & 1
    xv = eq | vn
    eq2 = eq | mh_in
    xh = ((((eq2 & vp) + vp) & _M64) ^ vp) | eq2
    ph = (vn | ~(xh | vp)) & _M64
    mh = vp & xh
    out = (ph >> 63) | ((mh >> 63) << 1)
    ph = ((ph << 1) | ph_in) & _M64
    mh = ((mh << 1) | mh_in) & _M64
    return out, (mh | ~(xv | ph)) & _M64, ph & xv


def myers_group_mirror(a, la_arr, text, lb_arr, band_k):
    shift, NB = myers_layout(band_k)
    B, Wa = a.shape
    Wt = text.shape[1]
    ppw = 32 // NB
    reach = max(((Wt - 1) >> 6) - shift, 0) if Wt > 0 else 0
    nblk = max(-(-Wa // 64), reach + NB)
    out = np.zeros(B, np.int64)
    for p0 in range(0, B, ppw):
        npairs = min(ppw, B - p0)
        peq = np.zeros((ppw, 6, nblk), dtype=object)
        peq[:] = 0
        for g in range(npairs):
            la_g = min(max(int(la_arr[p0 + g]), 0), Wa)
            for i in range(la_g):
                c = int(a[p0 + g, i])
                if 0 <= c < 5:
                    peq[g, c, i >> 6] |= 1 << (i & 63)
        lanes = []
        for lane in range(32):
            grp, l = divmod(lane, NB)
            has = grp < ppw and p0 + grp < B
            p = p0 + grp if has else p0
            la = min(max(int(la_arr[p]), 0), Wa)
            lb = min(max(int(lb_arr[p]), 0), Wt)
            outside = abs(la - lb) > band_k
            lb_run = lb if has and not outside else 0
            st = dict(has=has, p=p, l=l, la=la, lb=lb, outside=outside, lb_run=lb_run,
                      grp=grp if has else 0, la_blk=(la - 1) >> 6 if la > 0 else -1,
                      la_pos=(la - 1) & 63, beta=l, vp=_M64, vn=0, carry=0, partial=0,
                      src=lane - l + (l + NB - 1) % NB if has else lane,
                      steps=(-(-lb_run // _COLS) + max(0, ((lb_run - 1) >> 6) - shift) + NB - 1)
                      if lb_run > 0 else 0)
            lanes.append(st)

        def enter(st):
            beta = st["beta"]
            st["lo"] = 0 if beta < NB else 64 * (beta - shift)
            end_j = 64 * (beta + shift + 1)
            st["change_at"] = end_j // _COLS + beta
            st["hi"] = max(min(st["lb_run"], end_j), st["lo"])
            st["top_from"] = -(2 ** 31) if beta == 0 else 64 * (beta + shift)
            st["blk"] = min(beta, nblk - 1)

        def rows_total(st):
            """Vertical deltas of the lane's block, rows <= la, where it stopped."""
            beta = st["beta"]
            if st["lo"] >= st["lb_run"] or beta > st["la_blk"]:
                return 0
            rows = _M64 if beta < st["la_blk"] else (1 << (st["la_pos"] + 1)) - 1
            return bin(st["vp"] & rows).count("1") - bin(st["vn"] & rows).count("1")

        t_last = max(Wt - 1, 0)
        trow = lambda st: text[st["p"] if text.shape[0] > 1 else 0]
        clamp = lambda j: j if 0 <= j <= t_last else t_last  # unsigned min
        symbols = lambda st, j: [int(trow(st)[clamp(j + u)]) if Wt > 0 else 0
                                 for u in range(_COLS)]
        for st in lanes:
            enter(st)
            st["c_next"] = symbols(st, _COLS * (0 - st["beta"]))
            st["c_after"] = symbols(st, _COLS * (1 - st["beta"]))
        for s in range(max(st["steps"] for st in lanes)):
            carries = [st["carry"] for st in lanes]  # as the shuffle sees them
            for st in lanes:
                if s == st["change_at"]:
                    st["partial"] += rows_total(st)
                    st["beta"] += NB
                    st["vp"], st["vn"] = _M64, 0
                    enter(st)
                j0 = _COLS * (s - st["beta"])
                hh = 0x5555 if j0 >= st["top_from"] else carries[st["src"]]
                c = st["c_next"]  # loaded two steps ahead
                st["c_next"] = st["c_after"]
                st["c_after"] = symbols(st, j0 + 2 * _COLS)
                if not st["lo"] <= j0 < st["hi"]:
                    continue
                vp, vn, out_bits = st["vp"], st["vn"], 0
                for u in range(_COLS):
                    if j0 + u < st["hi"]:  # fewer than COLS only in the pair's last step
                        eq = peq[st["grp"], c[u] if 0 <= c[u] < 5 else 5, st["blk"]]
                        o, vp, vn = _column(eq, hh >> (2 * u), vp, vn)
                        out_bits |= o << (2 * u)
                st["vp"], st["vn"], st["carry"] = vp, vn, out_bits
        for st in lanes:
            st["partial"] += rows_total(st)
        for lane, st in enumerate(lanes):
            if st["has"] and st["l"] == 0:
                total = sum(lanes[min(lane + t, 31)]["partial"] for t in range(NB))
                lbr = st["lb_run"]
                reached = 64 * (max(0, ((lbr - 1) >> 6) - shift) + NB) if lbr > 0 else 0
                score = st["lb"] + total + max(0, st["la"] - reached)
                if st["outside"]:
                    score = max(st["la"], st["lb"])
                out[st["p"]] = score
    return out


def _mirror_case(rng, B, Wa, Wt, edits, shared):
    """Related pairs with substitutions and indels, ragged la and lb, and
    among them la = 0, lb = 0, an unrelated pair, a length gap beyond every
    band, la on block edges, and codes outside DNA5."""
    ref = rng.integers(0, 5, max(Wa, Wt)).astype(np.int32)
    a = np.zeros((B, Wa), np.int32)
    la = np.zeros(B, np.int32)
    for i in range(B):
        mut = _indel_mutate(rng, ref[:Wa], int(rng.integers(0, edits + 1)))[:Wa]
        a[i, : len(mut)] = mut
        la[i] = len(mut) - min(len(mut), int(rng.integers(0, 12)))
    if shared:
        text = ref[None, :Wt].copy()
    else:
        text = np.tile(ref[:Wt], (B, 1))
        hit = rng.random(text.shape) < 0.01
        text[hit] = rng.integers(0, 7, int(hit.sum()))  # 5, 6 match nothing
    lb = (Wt - rng.integers(0, 12, B)).clip(0).astype(np.int32)
    edges = [e for e in (63, 64, 65, 128) if e <= Wa]
    la[: len(edges)] = edges[: B]
    if B > 6:
        la[4], lb[5] = 0, 0
        a[6] = rng.integers(0, 5, Wa)  # unrelated
    if B > 7:
        la[7], lb[7] = 0, 0
    if B > 8:
        lb[8] = max(Wt - 600, 0)
    a[0, Wa // 2] = 9  # a pattern code outside DNA5
    return a, la, text, lb


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_pair"])
@pytest.mark.parametrize("band_k,Wa,Wt,B", [
    (31, 200, 210, 23), (63, 330, 300, 11), (127, 700, 720, 13),
    (255, 1300, 1290, 7), (511, 2300, 2330, 3), (63, 64, 64, 10), (31, 700, 40, 9),
    (63, 100, 900, 5),
])
def test_group_body_mirror_equals_plain(band_k, Wa, Wt, B, shared):
    rng = np.random.default_rng(band_k + Wa + B)
    a, la, text, lb = _mirror_case(rng, B, Wa, Wt, band_k + band_k // 2, shared)
    want = myers_distance_padded(*(torch.as_tensor(x) for x in (a, la, text, lb)),
                                 band_k=band_k).numpy()
    got = myers_group_mirror(a, la, text, lb, band_k)
    np.testing.assert_array_equal(got, want)


def test_group_body_mirror_single_pair_and_empty_text():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 5, (1, 130)).astype(np.int32)
    for la, lb in ((130, 130), (128, 100), (0, 90), (64, 0)):
        t = a[:, :lb].copy() if lb else np.zeros((1, 0), np.int32)
        want = myers_distance_padded(torch.as_tensor(a), torch.tensor([la], dtype=torch.int32),
                                     torch.as_tensor(t), torch.tensor([lb], dtype=torch.int32),
                                     band_k=63).numpy()
        got = myers_group_mirror(a, np.array([la]), t, np.array([lb]), 63)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("band_k,seed", [(31, 0), (63, 1), (127, 2), (255, 3), (511, 4), (63, 5)])
def test_group_body_mirror_outside_the_contract(band_k, seed):
    """Unrelated sequences of random lengths: most pairs lie outside the
    exactness contract, where the result depends on the 64-row window
    alone and must still be the plain version's."""
    rng = np.random.default_rng(seed)
    B, Wa, Wt = 9, int(rng.integers(60, 800)), int(rng.integers(60, 800))
    a = rng.integers(0, 5, (B, Wa)).astype(np.int32)
    text = rng.integers(0, 5, (B, Wt)).astype(np.int32)
    la = rng.integers(0, Wa + 1, B).astype(np.int32)
    lb = rng.integers(0, Wt + 1, B).astype(np.int32)
    lb[:3] = (la[:3] + rng.integers(-20, 21, 3)).clip(0, Wt)  # inside the band by length
    want = myers_distance_padded(*(torch.as_tensor(x) for x in (a, la, text, lb)),
                                 band_k=band_k).numpy()
    np.testing.assert_array_equal(myers_group_mirror(a, la, text, lb, band_k), want)
