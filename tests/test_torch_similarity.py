"""The port's device MICA / Lin path (kgl_gene_tpu_torch/ops/similarity.py)
against the JAX package's (kgl_gene_tpu/ops/similarity.py): mica_plain
against _mica_tile and _mica_tile_chunked bit for bit, the reference's
chunked form's fault at K % 64 != 0, a lane-level mirror of csrc/mica.cu
against mica_plain, and ancestor_lists, mica_matrix_device and
lin_matrix_device(device="cpu") against JAX's on the mini DAG, a 150-deep
DAG and a GO-shaped synthetic DAG, exact and truncated."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kgl_gene_tpu.io.gaf import GafRecord as JGafRecord
from kgl_gene_tpu.ontology.annotation import TermAnnotation as JAnnotation
from kgl_gene_tpu.ontology.graph import GoGraph as JGraph
from kgl_gene_tpu.ontology.information import InformationContent as JInfo
from kgl_gene_tpu.ontology.obo import parse_go_obo as jparse
from kgl_gene_tpu.ontology.similarity import SimilarityLin as JLin
from kgl_gene_tpu.ops import similarity as jsim
from kgl_gene_tpu_torch.io.gaf import GafRecord as TGafRecord
from kgl_gene_tpu_torch.ontology.annotation import TermAnnotation as TAnnotation
from kgl_gene_tpu_torch.ontology.graph import GoGraph as TGraph
from kgl_gene_tpu_torch.ontology.information import InformationContent as TInfo
from kgl_gene_tpu_torch.ontology.obo import parse_go_obo as tparse
from kgl_gene_tpu_torch.ontology.similarity import SimilarityLin as TLin
from kgl_gene_tpu_torch.ops import similarity as tsim

from test_ontology import OBO_TEXT, _gaf


def random_lists(rng, n, K, universe=None, ic_order=False, fill=1.0):
    """(n, K) ancestor-list-shaped arrays: distinct ids >= 0 then -1 pads,
    ascending or in descending IC order; ICs in [0, 8)."""
    universe = universe or 3 * K
    ids = np.full((n, K), -1, np.int32)
    ic = np.zeros((n, K), np.float32)
    for r in range(n):
        L = int(rng.integers(0, int(K * fill) + 1))
        row = rng.choice(universe, L, replace=False).astype(np.int32)
        val = (rng.random(L) * 8).astype(np.float32)
        order = np.argsort(val)[::-1] if ic_order else np.argsort(row)
        ids[r, :L], ic[r, :L] = row[order], val[order]
    return ids, ic


def plain(ids_i, ic_i, ids_j, ic_j):
    return tsim.mica_plain(*(torch.as_tensor(x) for x in (ids_i, ic_i, ids_j, ic_j))).numpy()


def jax_tile(fn, ids_i, ic_i, ids_j, ic_j, **kw):
    return np.asarray(fn(jnp.asarray(ids_i), jnp.asarray(ic_i), jnp.asarray(ids_j),
                         jnp.asarray(ic_j), **kw))


# ------------------------------------------------- the plain version vs JAX
@pytest.mark.parametrize("K", [64, 128, 192])
@pytest.mark.parametrize("ic_order", [False, True])
def test_mica_plain_equals_jax_tiles(K, ic_order):
    rng = np.random.default_rng(K + ic_order)
    ids_i, ic_i = random_lists(rng, 37, K, ic_order=ic_order)
    ids_j, ic_j = random_lists(rng, 29, K, ic_order=not ic_order)
    got = plain(ids_i, ic_i, ids_j, ic_j)
    assert got.dtype == np.float32 and got.shape == (37, 29)
    np.testing.assert_array_equal(got, jax_tile(jsim._mica_tile, ids_i, ic_i, ids_j, ic_j))
    np.testing.assert_array_equal(
        got, jax_tile(jsim._mica_tile_chunked, ids_i, ic_i, ids_j, ic_j, chunk=64))
    assert (got > 0).mean() > 0.3  # the inputs do share ancestors


def test_mica_plain_blocks_rows(monkeypatch):
    """Blocks of rows smaller than the matrix give the same matrix."""
    rng = np.random.default_rng(5)
    ids, ic = random_lists(rng, 45, 70, ic_order=True)
    want = plain(ids, ic, ids, ic)
    monkeypatch.setattr(tsim, "PLAIN_BLOCK_ELEMS", 4 * 64 * 64)
    np.testing.assert_array_equal(plain(ids, ic, ids, ic), want)


def test_reference_chunked_fault_at_k_100():
    """The reference's _mica_tile_chunked takes K // 64 chunks and drops the
    columns past 64: two rows of width 100 sharing one ancestor at columns
    80 and 90 (IC 2.5) get 0.0 from it and 2.5 from _mica_tile. The port
    follows _mica_tile."""
    K = 100
    ids = np.full((2, K), -1, np.int32)
    ic = np.zeros((2, K), np.float32)
    ids[0, :81] = np.arange(1000, 1081)
    ids[1, :91] = np.arange(2000, 2091)
    ids[0, 80] = ids[1, 90] = 7
    ic[0, 80] = ic[1, 90] = 2.5
    ic[0, :80] = ic[1, :90] = 1.0
    chunked = jax_tile(jsim._mica_tile_chunked, ids[:1], ic[:1], ids[1:], ic[1:], chunk=64)
    whole = jax_tile(jsim._mica_tile, ids[:1], ic[:1], ids[1:], ic[1:])
    assert chunked[0, 0] == 0.0 and whole[0, 0] == 2.5
    got = tsim.mica(torch.as_tensor(ids), torch.as_tensor(ic))
    assert got[0, 1] == 2.5 and got[1, 0] == 2.5
    np.testing.assert_array_equal(plain(ids[:1], ic[:1], ids[1:], ic[1:]), whole)


def test_mica_wrapper_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(9)
    ids, ic = random_lists(rng, 20, 64)
    ids_j, ic_j = random_lists(rng, 11, 100, ic_order=True)
    t = [torch.as_tensor(x) for x in (ids, ic, ids_j, ic_j)]
    np.testing.assert_array_equal(tsim.mica(t[0], t[1]).numpy(), plain(ids, ic, ids, ic))
    np.testing.assert_array_equal(tsim.mica(*t).numpy(), plain(ids, ic, ids_j, ic_j))
    assert tsim.mica(t[0][:0], t[1][:0]).shape == (0, 0)


# ------------------------------------------------- the kernel's lane mirror
def mica_kernel_mirror(ids_i, ic_i, ids_j=None, ic_j=None, T=None, counts=None):
    """ops/similarity.mica and csrc/mica.cu (mica_rows_kernel) block by
    block: the padded rows made compact by rows_on_card (id_order, counts,
    offsets), the tile and shared entries of mica_tile (or tile T), the
    grid of T x T tiles (the upper triangle with mirrored stores for one
    row set), each block's staging with two sentinels a row, its local
    order by (length, row), the warps' rounds of 8 x 4 pairs, a lane's
    merge two steps a trip (every read inside its row and sentinels), and
    the output tile. `counts`, a dict, gains the trips of each round's
    longest lane summed over the warps ("trips")."""
    symmetric = ids_j is None

    def compact(ids, ic):
        rows = tsim.rows_on_card(torch.as_tensor(ids), torch.as_tensor(ic))
        return rows.offsets, rows.ids.numpy(), rows.ic.numpy()

    off_i, fid_i, fic_i = compact(ids_i, ic_i)
    off_j, fid_j, fic_j = (off_i, fid_i, fic_i) if symmetric else compact(ids_j, ic_j)
    ni, nj = len(off_i) - 1, len(off_j) - 1
    tile, entries = tsim.mica_tile(off_i, off_j, symmetric)
    if T is not None:
        tile = T
        entries = (2 * tsim._tile_entries(off_i, T) if symmetric
                   else tsim._tile_entries(off_i, T) + tsim._tile_entries(off_j, T))
    T = tile
    out = np.full((ni, nj), np.nan, np.float32)
    SI, SJ = min(8, T), min(4, T)
    nsj = T // SJ
    nsb = (T // SI) * nsj
    per = -(-nsb // 8)
    trips = 0
    for bi in range(-(-ni // T)):
        for bj in range(-(-nj // T)):
            if symmetric and bi > bj:
                continue
            i0, j0 = bi * T, bj * T
            span_i = off_i[min(i0 + T, ni)] - off_i[i0]
            span_j = off_j[min(j0 + T, nj)] - off_j[j0]
            assert span_i + span_j <= entries
            s_ent = [None] * (entries + 4 * T + 2)
            s_ent[0] = s_ent[1] = (-1, np.float32(0.0))
            start, length, region = [0] * (2 * T), [0] * (2 * T), {}
            for r in range(2 * T):
                side_j = r >= T
                k = r - T if side_j else r
                first, off, n = (j0, off_j, nj) if side_j else (i0, off_i, ni)
                if first + k < n:
                    start[r] = 2 + (span_i + 2 * T if side_j else 0) + off[first + k] \
                        - off[first] + 2 * k
                    length[r] = off[first + k + 1] - off[first + k]
            for r in range(2 * T):
                if start[r] == 0:
                    continue
                side_j = r >= T
                src = (off_j[j0 + r - T] if side_j else off_i[i0 + r])
                fid, fic = (fid_j, fic_j) if side_j else (fid_i, fic_i)
                for e in range(length[r] + 2):
                    s_ent[start[r] + e] = ((int(fid[src + e]), fic[src + e]) if e < length[r]
                                           else (-1, np.float32(0.0)))
                region[start[r]] = start[r] + length[r] + 2
            region[0] = 2
            order = [0] * (2 * T)
            for r in range(2 * T):
                side = T if r >= T else 0
                k = r - side
                rank = sum(length[side + q] < length[r] or (length[side + q] == length[r] and q < k)
                           for q in range(T))
                order[side + rank] = k
            s_out = np.full((T, T + 1), np.nan, np.float32)
            for warp in range(8):
                for sb in range(warp * per, min(nsb, (warp + 1) * per)):
                    longest = 0
                    for lane in range(32):
                        li, lj = lane % 8, lane // 8
                        if not (li < SI and lj < SJ):
                            continue
                        ri = order[(sb // nsj) * SI + li]
                        rj = order[T + (sb % nsj) * SJ + lj]
                        pa, pb = start[ri], start[T + rj]
                        end_a, end_b = region[pa], region[pb]
                        (x, cx), (y, cy) = s_ent[pa], s_ent[pb]
                        best, n_trips = np.float32(0.0), 0
                        while (x | y) >= 0:
                            n_trips += 1
                            for _u in range(2):
                                if x == y:
                                    best = max(best, np.float32(min(cx, cy)))
                                adv_a, adv_b = x <= y, y <= x
                                pa += adv_a
                                pb += adv_b
                                assert pa < end_a and pb < end_b
                                if adv_a:
                                    x, cx = s_ent[pa]
                                if adv_b:
                                    y, cy = s_ent[pb]
                        longest = max(longest, n_trips)
                        s_out[ri, rj] = best
                    trips += longest
            for e in range(T * T):
                r, c = divmod(e, T)
                if i0 + r < ni and j0 + c < nj:
                    out[i0 + r, j0 + c] = s_out[r, c]
                if symmetric and bi != bj and j0 + r < nj and i0 + c < ni:
                    out[j0 + r, i0 + c] = s_out[c, r]
    if counts is not None:
        counts["trips"] = trips
    return out


@pytest.mark.parametrize("n,K,T,ic_order", [(37, 20, 16, True), (40, 7, 8, False),
                                            (9, 5, 1, True), (33, 13, 4, False),
                                            (17, 64, 16, False)])
def test_kernel_mirror_symmetric(n, K, T, ic_order):
    rng = np.random.default_rng(n * K)
    ids, ic = random_lists(rng, n, K, ic_order=ic_order)
    np.testing.assert_array_equal(mica_kernel_mirror(ids, ic, T=T), plain(ids, ic, ids, ic))


def test_kernel_mirror_pads_anywhere():
    """Rows with pads between their ids and in IC order: id_order puts
    them in the kernel's order, and the result is mica_plain's."""
    rng = np.random.default_rng(5)
    ids, ic = random_lists(rng, 23, 12, ic_order=True, fill=0.7)
    for r in range(len(ids)):
        perm = rng.permutation(ids.shape[1])
        ids[r], ic[r] = ids[r, perm], ic[r, perm]
    assert ((ids[:, :-1] < 0) & (ids[:, 1:] >= 0)).any()
    np.testing.assert_array_equal(mica_kernel_mirror(ids, ic, T=4), plain(ids, ic, ids, ic))


def test_mica_from_lists_rejects_a_repeated_id():
    ids = np.array([[3, -1, 5, 3], [1, 2, -1, -1]], np.int32)
    ic = np.ones((2, 4), np.float32)
    with pytest.raises(ValueError, match="repeats"):
        tsim.mica_from_lists(ids, ic, device="cpu")
    ids[0, 3] = -1
    np.testing.assert_array_equal(tsim.mica_from_lists(ids, ic, device="cpu"),
                                  plain(ids, ic, ids, ic))


def test_kernel_mirror_two_row_sets():
    rng = np.random.default_rng(2)
    ids_i, ic_i = random_lists(rng, 21, 9)
    ids_j, ic_j = random_lists(rng, 30, 14, ic_order=True)
    np.testing.assert_array_equal(mica_kernel_mirror(ids_i, ic_i, ids_j, ic_j, T=8),
                                  plain(ids_i, ic_i, ids_j, ic_j))


def test_mica_work_counts_the_merge_steps():
    """chip_smoke.mica_work's merge steps against the merge loop run pair by
    pair on the rows in the kernel's order, and its lane slots against the
    kernel mirror's trips: each round's longest lane, two steps a trip, 32
    lanes, over the upper triangle of tiles (a tile of 16 rows here)."""
    import chip_smoke

    rng = np.random.default_rng(4)
    ids, ic = random_lists(rng, 37, 12, universe=20, ic_order=True)
    ids[5] = -1  # an empty row
    srt = tsim.id_order(torch.as_tensor(ids), torch.as_tensor(ic))[0].numpy()
    n = len(ids)
    steps = np.zeros((n, n), np.int64)
    for i in range(n):
        for j in range(n):
            a, b = srt[i][srt[i] >= 0], srt[j][srt[j] >= 0]
            p = q = 0
            while p < len(a) and q < len(b):
                x, y = a[p], b[q]
                p += x <= y
                q += y <= x
                steps[i, j] += 1
    counts = {}
    np.testing.assert_array_equal(mica_kernel_mirror(ids, ic, T=16, counts=counts),
                                  plain(ids, ic, ids, ic))
    assert chip_smoke.mica_work(ids, "cpu", tile=16, rows=16) == (
        float(np.triu(steps).sum()), float(2 * 32 * counts["trips"]))


def test_kernel_mirror_tile_walk_at_64():
    """The kernel's own tile (64 rows): n not a multiple of it, empty rows,
    lengths that vary widely (the local order), equal to mica_plain and to
    the JAX package's chunked tile (K a multiple of 64, where the
    reference scans every column), and mica_work's slots to its trips."""
    import chip_smoke

    rng = np.random.default_rng(64)
    ids, ic = random_lists(rng, 70, 128, universe=400)
    ids[[3, 40, 66]] = -1
    ic[[3, 40, 66]] = 0.0
    ids[7, 2:], ic[7, 2:] = -1, 0.0  # a short row beside long ones
    assert tsim.mica_tile(np.r_[0, np.cumsum((ids >= 0).sum(1))], None, True)[0] == 64
    counts = {}
    got = mica_kernel_mirror(ids, ic, counts=counts)
    np.testing.assert_array_equal(got, plain(ids, ic, ids, ic))
    np.testing.assert_array_equal(got, jax_tile(jsim._mica_tile_chunked, ids, ic, ids, ic,
                                                chunk=64))
    assert chip_smoke.mica_work(ids, "cpu", tile=64, rows=64)[1] == float(2 * 32 * counts["trips"])


def test_kernel_mirror_two_row_sets_against_jax():
    """i != j at the kernel's tile: 37 rows of K = 64 against 70 rows of K
    = 128, each set with empty rows."""
    rng = np.random.default_rng(37)
    ids_i, ic_i = random_lists(rng, 37, 64, universe=300)
    ids_j, ic_j = random_lists(rng, 70, 128, universe=300, ic_order=True)
    ids_i[0], ic_i[0] = -1, 0.0
    ids_j[69], ic_j[69] = -1, 0.0
    got = mica_kernel_mirror(ids_i, ic_i, ids_j, ic_j)
    np.testing.assert_array_equal(got, plain(ids_i, ic_i, ids_j, ic_j))
    # the JAX tile takes one width: the i rows padded to 128 columns
    wide_i = np.pad(ids_i, ((0, 0), (0, 64)), constant_values=-1)
    wide_ic = np.pad(ic_i, ((0, 0), (0, 64)))
    np.testing.assert_array_equal(got, jax_tile(jsim._mica_tile_chunked, wide_i, wide_ic, ids_j,
                                                ic_j, chunk=64))


def test_wide_rows_take_a_smaller_tile():
    """Rows of about 1,000 ancestors do not fit two 64-row tiles in a
    block's shared memory: mica_tile takes the widest tile that fits, and
    the mirror at that tile equals mica_plain."""
    rng = np.random.default_rng(1000)
    n, K = 20, 800
    ids = np.sort(np.stack([rng.choice(1200, K, replace=False) for _ in range(n)]), 1)
    ids = ids.astype(np.int32)
    ic = (rng.random((n, K)) * 8).astype(np.float32)
    ids[2, 700:], ic[2, 700:] = -1, 0.0
    off = np.r_[0, np.cumsum((ids >= 0).sum(1))]
    tile, entries = tsim.mica_tile(off, off, True)
    assert tile < 64 and tsim.mica_smem_bytes(tile, entries) <= tsim.SMEM_LIMIT
    assert tsim.mica_smem_bytes(2 * tile, 2 * tsim._tile_entries(off, 2 * tile)) \
        > tsim.SMEM_LIMIT
    np.testing.assert_array_equal(mica_kernel_mirror(ids, ic), plain(ids, ic, ids, ic))


def test_a_row_beyond_shared_memory_raises():
    off = np.array([0, 40_000, 40_010], np.int64)
    with pytest.raises(ValueError, match="too long"):
        tsim.mica_tile(off, off, True)


def test_rows_on_card_and_row_sets_on_the_cpu():
    """rows_on_card's compact rows (on CPU tensors here) hold each padded
    row's ids >= 0 in ascending order with their ICs; mica_rows on CPU
    rows is mica_plain of the rows padded, with one row set and two."""
    rng = np.random.default_rng(12)
    ids, ic = random_lists(rng, 25, 40, ic_order=True, fill=0.8)
    ids[4], ic[4] = -1, 0.0
    rows = tsim.rows_on_card(torch.as_tensor(ids), torch.as_tensor(ic))
    assert rows.ptr.dtype == torch.int32 and len(rows) == 25
    for r in range(25):
        got = rows.ids[rows.offsets[r]:rows.offsets[r + 1]].numpy()
        keep = ids[r] >= 0
        order = np.argsort(ids[r][keep])
        np.testing.assert_array_equal(got, ids[r][keep][order])
        np.testing.assert_array_equal(rows.ic[rows.offsets[r]:rows.offsets[r + 1]].numpy(),
                                      ic[r][keep][order])
    cpu = tsim.row_set(rows.offsets, rows.ids.numpy(), rows.ic.numpy(), "cpu")
    np.testing.assert_array_equal(tsim.mica_rows(cpu).numpy(), plain(ids, ic, ids, ic))
    ids_j, ic_j = random_lists(rng, 9, 17)
    rows_j = tsim.rows_on_card(torch.as_tensor(ids_j), torch.as_tensor(ic_j))
    np.testing.assert_array_equal(tsim.mica_rows(cpu, rows_j).numpy(),
                                  plain(ids, ic, ids_j, ic_j))


# ------------------------------------------- the device path on DAGs vs JAX
def _stacks(obo_path, gafs):
    jg, tg = JGraph(jparse(str(obo_path))), TGraph(tparse(str(obo_path)))
    ji = JInfo(jg, JAnnotation(gafs, graph=jg))
    ti = TInfo(tg, TAnnotation([TGafRecord(**r.__dict__) for r in gafs], graph=tg))
    return jg, ji, tg, ti


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    path = tmp_path_factory.mktemp("obo") / "mini.obo"
    path.write_text(OBO_TEXT)
    gafs = [_gaf("geneA", "GO:0000004"), _gaf("geneB", "GO:0000005"),
            _gaf("geneC", "GO:0000006"), _gaf("geneD", "GO:0000002"),
            _gaf("geneE", "GO:0000003")]
    terms = ["GO:0000002", "GO:0000003", "GO:0000004", "GO:0000005", "GO:0000006"]
    return _stacks(path, gafs) + (terms,)


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """The 150-deep chain with a side parent of tests/
    test_legacy_and_device_sim.py::test_exact_at_deep_dag: lists longer
    than 64, K = 192 exact."""
    depth = 150

    def tid(i):
        return "GO:0008150" if i == 0 else f"GO:{i:07d}"

    lines = ["format-version: 1.2", ""]
    for i in range(depth):
        lines += ["[Term]", f"id: {tid(i)}", f"name: t{i}", "namespace: biological_process"]
        if i > 0:
            lines.append(f"is_a: {tid(i - 1)} ! t{i - 1}")
        if i == 120:
            lines.append(f"is_a: {tid(50)} ! t50")
        lines.append("")
    path = tmp_path_factory.mktemp("obo") / "deep.obo"
    path.write_text("\n".join(lines))
    gafs = [_gaf(f"gene{k}", tid(k)) for k in range(0, depth, 7)]
    terms = [tid(i) for i in (30, 70, 100, 130, 140, 149)] + ["GO:9999999"]
    return _stacks(path, gafs) + (terms,)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """A GO-shaped ~2,000-term DAG (chip_smoke's generator at 1/20 of its
    sizes) and 120 of its annotated terms."""
    import chip_smoke

    base = tmp_path_factory.mktemp("go")
    sizes = chip_smoke.GO_NAMESPACES, chip_smoke.GO_GENES
    chip_smoke.GO_NAMESPACES = tuple((ns, root, size // 20, aspect)
                                     for ns, root, size, aspect in sizes[0])
    chip_smoke.GO_GENES = 150
    try:
        chip_smoke.write_go_gaf(str(base / "go.gaf"),
                                chip_smoke.write_go_obo(str(base / "go.obo")))
    finally:
        chip_smoke.GO_NAMESPACES, chip_smoke.GO_GENES = sizes
    from kgl_gene_tpu.io.gaf import read_gaf_records

    gafs = read_gaf_records(str(base / "go.gaf"))
    stacks = _stacks(base / "go.obo", gafs)
    ann = JAnnotation(gafs, graph=stacks[0])
    terms = ann.all_terms()[::3][:120]
    return stacks + (terms,)


@pytest.mark.parametrize("which", ["mini", "deep", "synthetic"])
@pytest.mark.parametrize("max_ancestors", [None, 64])
def test_device_path_equals_jax(which, max_ancestors, request):
    jg, ji, tg, ti, terms = request.getfixturevalue(which)
    idxs = [jg.term_index(t) for t in terms if jg.term_index(t) is not None]
    j_ids, j_ic = jsim.ancestor_lists(ji, idxs, max_ancestors)
    t_ids, t_ic = tsim.ancestor_lists(ti, idxs, max_ancestors)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_ic, j_ic)
    if which == "deep" and max_ancestors is None:
        assert t_ids.shape[1] == 192  # lists longer than 128: three chunks
    # the port's matrix from JAX's own arrays, and from its own
    want = jsim.mica_matrix_device(ji, idxs, tile=4, max_ancestors=max_ancestors)
    np.testing.assert_array_equal(tsim.mica_from_lists(j_ids, j_ic, device="cpu"), want)
    got = tsim.mica_matrix_device(ti, idxs, tile=4, max_ancestors=max_ancestors, device="cpu")
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    lin = tsim.lin_matrix_device(ti, terms, tile=3, max_ancestors=max_ancestors, device="cpu")
    np.testing.assert_array_equal(
        lin, jsim.lin_matrix_device(ji, terms, tile=3, max_ancestors=max_ancestors))
    if max_ancestors is None:
        np.testing.assert_allclose(got, ti.mica_matrix(idxs), rtol=0, atol=1e-6)
        np.testing.assert_allclose(lin, TLin(ti).similarity_matrix(terms), rtol=0, atol=1e-6)
        np.testing.assert_allclose(lin, JLin(ji).similarity_matrix(terms), rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["mini", "deep", "synthetic"])
def test_ancestor_rows_are_the_bitset_rows(which, request, monkeypatch):
    """The vectorised row builder, in blocks of a few rows: each row is
    GoGraph._bits_to_indices of the term's ancestor bitset (the port's and
    the JAX package's), with its ICs; ancestor_lists built on it equals the
    JAX package's ancestor_lists, exact and truncated (rows cut in top-IC
    order by the reference's own sort)."""
    jg, ji, tg, ti, terms = request.getfixturevalue(which)
    idxs = [jg.term_index(t) for t in terms if jg.term_index(t) is not None]
    idxs = idxs + idxs[:2]  # a repeated term
    monkeypatch.setattr(tsim, "ROW_BLOCK_WORDS", 3 * tg.ancestor_bitsets().shape[1])
    offsets, ids, ic = tsim.ancestor_rows(ti, idxs)
    assert offsets.dtype == np.int64 and ids.dtype == np.int32 and ic.dtype == np.float32
    bits_t, bits_j = tg.ancestor_bitsets(), jg.ancestor_bitsets()
    for r, term in enumerate(idxs):
        row = ids[offsets[r]:offsets[r + 1]]
        np.testing.assert_array_equal(row, TGraph._bits_to_indices(bits_t[term]))
        np.testing.assert_array_equal(row, JGraph._bits_to_indices(bits_j[term]))
        np.testing.assert_array_equal(ic[offsets[r]:offsets[r + 1]],
                                      ti.ic[row].astype(np.float32))
    longest = int(np.diff(offsets).max())
    for cut in (None, 64, 3, max(1, longest - 1)):
        j_ids, j_ic = jsim.ancestor_lists(ji, idxs, cut)
        t_ids, t_ic = tsim.ancestor_lists(ti, idxs, cut)
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_array_equal(t_ic, j_ic)


def test_ancestor_rows_of_no_terms(mini):
    _jg, ji, _tg, ti, _terms = mini
    offsets, ids, ic = tsim.ancestor_rows(ti, [])
    assert offsets.tolist() == [0] and len(ids) == len(ic) == 0
    for a, b in zip(tsim.ancestor_lists(ti, []), jsim.ancestor_lists(ji, [])):
        assert a.shape == b.shape == (0, 64) and a.dtype == b.dtype


def test_truncation_differs_on_the_deep_dag(deep):
    """As in the reference: the top-64 IC cut lowers some similarities on
    the deep DAG, which is why exact is the default."""
    _jg, _ji, tg, ti, terms = deep
    idxs = [tg.term_index(t) for t in terms[:-1]]
    exact = tsim.mica_matrix_device(ti, idxs, device="cpu")
    cut = tsim.mica_matrix_device(ti, idxs, max_ancestors=64, device="cpu")
    assert not np.allclose(cut, exact, atol=1e-6)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(mini, monkeypatch):
    _jg, _ji, tg, ti, terms = mini
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idxs = [tg.term_index(t) for t in terms]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.mica_matrix_device(ti, idxs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.lin_matrix_device(ti, terms)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.mica_from_lists(*tsim.ancestor_lists(ti, idxs))
    assert tsim.lin_matrix_device(ti, terms, device="cpu").shape == (5, 5)
