"""The port's transcript-family path against the JAX package's, on the
CPU: TranscriptFamilyAnalysis (global and local), the all-pairs matrix of
both metrics on every route, on a device and on a mesh of one rank, the
Myers pool driver and band doubling, the local metric, and UPGMA/Newick.
Distances, CIGARs, Newick strings and report bytes are exact, so they must
be equal."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgl_gene_tpu.analysis.lib_seqmutation import TranscriptFamilyAnalysis as JFamily
from kgl_gene_tpu.analysis.lib_seqmutation import TranscriptMutateRecord as JRecord
from kgl_gene_tpu.classify.upgma import DistanceMatrix as JMatrix
from kgl_gene_tpu.classify.upgma import newick as j_newick
from kgl_gene_tpu.classify.upgma import upgma_tree as j_upgma
from kgl_gene_tpu.genome.features import CodingSequenceValidity as JValidity
from kgl_gene_tpu.ops.edit_distance import batched_levenshtein_local as j_local
from kgl_gene_tpu.ops.edit_distance import levenshtein_local_numpy as j_local_oracle
from kgl_gene_tpu.ops.edit_distance import levenshtein_numpy
from kgl_gene_tpu.ops.edit_distance import pairwise_distance_matrix as j_pairwise
from kgl_gene_tpu.ops.pallas_myers import adaptive_myers_levenshtein as j_adaptive_myers
from kgl_gene_tpu.ops.pallas_myers import myers_pairs_device as j_myers_pairs
from kgl_gene_tpu_torch.analysis.lib_seqmutation import TranscriptFamilyAnalysis as TFamily
from kgl_gene_tpu_torch.analysis.lib_seqmutation import TranscriptMutateRecord as TRecord
from kgl_gene_tpu_torch.classify.upgma import DistanceMatrix as TMatrix
from kgl_gene_tpu_torch.classify.upgma import newick as t_newick
from kgl_gene_tpu_torch.classify.upgma import upgma_tree as t_upgma
from kgl_gene_tpu_torch.genome.features import CodingSequenceValidity as TValidity
from kgl_gene_tpu_torch.ops.edit_distance import (
    batched_levenshtein_local,
    levenshtein_local_numpy,
    pairwise_distance_matrix,
)
from kgl_gene_tpu_torch.ops.myers import adaptive_myers_levenshtein, myers_pairs_device
from kgl_gene_tpu_torch.parallel.dist import SampleMesh
from kgl_gene_tpu_torch.sequence.alphabet import DNA5

REPO = Path(__file__).resolve().parent.parent

LETTERS = np.array(list("ACGTN"))


def _mutant(rng, ref, n_sub, n_indel):
    s = ref.copy()
    pos = rng.choice(len(s), n_sub, replace=False)
    s[pos] = (s[pos] + 1 + rng.integers(0, 3, n_sub)) % 4
    for _ in range(n_indel):
        p = int(rng.integers(0, len(s)))
        if rng.random() < 0.5:
            s = np.delete(s, slice(p, p + int(rng.integers(1, 4))))
        else:
            s = np.insert(s, p, rng.integers(0, 4, int(rng.integers(1, 4))))
    return s


def _family(seed=0, n=12):
    """(reference string, [(genome, variants, coding string, validity
    name)]): mutants of 150-300 bases with substitutions and indels, one
    equal to the reference, two sharing one sequence, one unrelated."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, int(rng.integers(150, 300)))
    names = [v.name for v in TValidity]
    codings = []
    for i in range(n):
        codings.append(_mutant(rng, ref, int(rng.integers(0, 12)), int(rng.integers(0, 4))))
    codings[1] = ref.copy()
    codings[3] = codings[2].copy()
    codings[4] = rng.integers(0, 5, 200)  # unrelated, with N bases
    rows = [(f"g{i:02d}", int(rng.integers(0, 12)), "".join(LETTERS[c]), names[i % len(names)])
            for i, c in enumerate(codings)]
    return "".join(LETTERS[ref]), rows


def _both(ref, rows, metric="global"):
    j = JFamily([JRecord(g, "GENE", "GENE.1", v, s, JValidity[val]) for g, v, s, val in rows],
                ref, metric=metric)
    t = TFamily([TRecord(g, "GENE", "GENE.1", v, s, TValidity[val]) for g, v, s, val in rows],
                ref, metric=metric, device="cpu")
    return j, t


@pytest.mark.parametrize("metric", ["global", "local"])
@pytest.mark.parametrize("seed", [0, 1])
def test_family_equals_jax(tmp_path, metric, seed):
    ref, rows = _family(seed)
    j, t = _both(ref, rows, metric)
    assert t.distinct_sequences() == j.distinct_sequences()
    assert t.reference_distances() == j.reference_distances()
    assert t.distance_tree_newick() == j.distance_tree_newick()
    assert t.reference_cigars() == j.reference_cigars()
    for cigars in (False, True):
        j.write_report(str(tmp_path / "j.csv"), cigars=cigars)
        t.write_report(str(tmp_path / "t.csv"), cigars=cigars)
        assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_family_report_cigars(tmp_path):
    ref = "ATGGCATAA"
    rows = [("g1", 1, "ATGGCGTAA", "VALID_PROTEIN"), ("g2", 0, ref, "VALID_PROTEIN")]
    j, t = _both(ref, rows)
    cigars = t.reference_cigars(band_k=31)
    assert cigars == j.reference_cigars(band_k=31)
    assert cigars[ref] == "9M" and cigars["ATGGCGTAA"] == "5M1X3M"
    j.write_report(str(tmp_path / "j.csv"), cigars=True)
    t.write_report(str(tmp_path / "t.csv"), cigars=True)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_family_degenerate():
    j, t = _both("ACGT", [("g1", 0, "ACGT", "VALID_PROTEIN")])
    assert t.distance_tree_newick() == j.distance_tree_newick() == "(g1:0);"
    j, t = _both("ACGT", [])
    assert t.reference_distances() == j.reference_distances() == {}
    assert t.distance_tree_newick() == j.distance_tree_newick()


def _pool(seed=3, n=8):
    """Padded codes and lengths: a few close mutants, ragged lengths, an
    empty one and an unrelated one (beyond band 63)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 240)
    rows = [_mutant(rng, ref, int(rng.integers(0, 20)), int(rng.integers(0, 5)))
            for _ in range(n - 2)]
    rows += [rng.integers(0, 5, 230), ref[:0]]
    W = max(len(r) for r in rows)
    seqs = np.zeros((n, W), np.uint8)
    for i, r in enumerate(rows):
        seqs[i, : len(r)] = r
    return seqs, np.array([len(r) for r in rows], np.int32)


def _one_base_too(seqs, lens, code):
    """The pool with a one-base row `code` appended."""
    row = np.zeros((1, seqs.shape[1]), seqs.dtype)
    row[0, 0] = code
    return np.vstack([seqs, row]), np.append(lens, 1).astype(np.int32)


@pytest.mark.parametrize("metric, band_k, seed", [
    ("global", None, 3), ("global", 63, 3), ("local", None, 3), ("local", None, 9)],
    ids=["None", "63", "local-3", "local-9"])
def test_pairwise_distance_matrix(metric, band_k, seed):
    """Global: the JAX matrix and the DP. Local, on ragged rows with an
    empty and a one-base row: every entry the numpy DP's and the JAX
    package's batched_levenshtein_local. Both symmetric, zero diagonal."""
    seqs, lens = _pool(seed=seed)
    if metric == "local":
        seqs, lens = _one_base_too(seqs, lens, code=seed % 4)
    got = pairwise_distance_matrix(seqs, lens, band_k=band_k, device="cpu", metric=metric)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, got.T)
    assert not np.diag(got).any()
    iu, ju = np.triu_indices(len(lens), k=1)
    rows = [(seqs[i, : lens[i]], seqs[j, : lens[j]]) for i, j in zip(iu, ju)]
    if metric == "local":
        assert {0, 1} <= set(lens.tolist())
        np.testing.assert_array_equal(got[iu, ju],
                                      np.asarray(j_local(seqs[iu], lens[iu], seqs[ju], lens[ju])))
        np.testing.assert_array_equal(got[iu, ju], [levenshtein_local_numpy(a, b) for a, b in rows])
    else:
        np.testing.assert_array_equal(got, j_pairwise(seqs, lens, band_k=band_k))
        np.testing.assert_array_equal(got[iu, ju], [levenshtein_numpy(a, b) for a, b in rows])


@pytest.mark.parametrize("metric, band_k", [("local", 63), ("hamming", None)])
def test_pairwise_distance_matrix_refuses_a_band_or_metric_it_lacks(metric, band_k):
    seqs, lens = _pool()
    with pytest.raises(ValueError):
        pairwise_distance_matrix(seqs, lens, band_k=band_k, device="cpu", metric=metric)


@pytest.mark.parametrize("metric, band_k", [("global", 63), ("local", None)])
def test_pairwise_distance_matrix_on_a_mesh_of_one_rank(metric, band_k):
    """A SampleMesh of one rank as the device gives the device's matrix
    (the banded route with its overflow re-run, and the local route)."""
    seqs, lens = _pool(seed=5)
    got = pairwise_distance_matrix(seqs, lens, band_k=band_k, device=SampleMesh.single("cpu"),
                                   metric=metric)
    np.testing.assert_array_equal(
        got, pairwise_distance_matrix(seqs, lens, band_k=band_k, device="cpu", metric=metric))


def test_edit_distance_imports_no_mesh_module():
    """ops sits below parallel.mesh: importing the all-pairs matrix loads
    parallel.dist only."""
    code = ("import sys\n"
            "import kgl_gene_tpu_torch.ops.edit_distance\n"
            "assert 'kgl_gene_tpu_torch.parallel.dist' in sys.modules\n"
            "assert 'kgl_gene_tpu_torch.parallel.mesh' not in sys.modules\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("band_k", [31, 127])
def test_myers_pairs_device(band_k):
    seqs, lens = _pool(seed=4)
    iu, ju = np.triu_indices(len(lens), k=1)
    got = myers_pairs_device(torch.as_tensor(seqs), torch.as_tensor(lens), iu, ju, band_k=band_k)
    ref = j_myers_pairs(jnp.asarray(seqs, jnp.int32), jnp.asarray(lens), iu, ju, band_k=band_k,
                        interpret=True)
    want = np.array([levenshtein_numpy(seqs[i, : lens[i]], seqs[j, : lens[j]])
                     for i, j in zip(iu, ju)])
    exact = (want <= band_k) & (np.abs(lens[iu] - lens[ju]) <= band_k)
    assert exact.sum() >= 10 and (~exact).any()
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_array_equal(ref[exact], want[exact])
    assert np.all(got >= want) and np.all(got[~exact] > band_k)


def test_pair_pools_in_chunks(monkeypatch):
    """A gather budget of three pairs per chunk gives the same distances
    as one chunk, for both pool drivers."""
    from kgl_gene_tpu_torch.ops import edit_distance
    from kgl_gene_tpu_torch.ops.banded import banded_pairs_device

    seqs, lens = _pool(seed=7)
    iu, ju = np.triu_indices(len(lens), k=1)
    pool, plens = torch.as_tensor(seqs), torch.as_tensor(lens)
    whole = [f(pool, plens, iu, ju, band_k=63) for f in (myers_pairs_device, banded_pairs_device)]
    monkeypatch.setattr(edit_distance, "PAIR_GATHER_BYTES", 3 * 2 * 4 * seqs.shape[1])
    for f, want in zip((myers_pairs_device, banded_pairs_device), whole):
        np.testing.assert_array_equal(f(pool, plens, iu, ju, band_k=63), want)


@pytest.mark.parametrize("start_k", [31, 100, 600])
def test_adaptive_myers_levenshtein(start_k):
    seqs, lens = _pool(seed=5)
    iu, ju = np.triu_indices(len(lens), k=1)
    args = (seqs[iu], lens[iu], seqs[ju], lens[ju])
    got = adaptive_myers_levenshtein(*args, start_k=start_k, device="cpu")
    np.testing.assert_array_equal(got, j_adaptive_myers(*args, start_k=start_k, interpret=True))
    np.testing.assert_array_equal(got, [levenshtein_numpy(seqs[i, : lens[i]], seqs[j, : lens[j]])
                                        for i, j in zip(iu, ju)])


def test_batched_levenshtein_local():
    seqs, lens = _pool(seed=6)
    iu, ju = np.triu_indices(len(lens), k=1)
    args = (seqs[iu], lens[iu], seqs[ju], lens[ju])
    got = batched_levenshtein_local(*(torch.as_tensor(x) for x in args))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_local(*args)))
    oracle = [j_local_oracle(seqs[i, : lens[i]], seqs[j, : lens[j]]) for i, j in zip(iu, ju)]
    np.testing.assert_array_equal(got.numpy(), oracle)
    assert all(levenshtein_local_numpy(seqs[i, : lens[i]], seqs[j, : lens[j]]) == o
               for (i, j), o in zip(zip(iu, ju), oracle))


@pytest.mark.parametrize("seed", range(4))
def test_upgma_newick_with_ties(seed):
    """Small integer distances give many ties: the first minimum in scan
    order must win in both, and %.6g must print the same."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 12))
    m = rng.integers(0, 4, (n, n)).astype(np.float64) + (rng.random() < 0.5) / 3
    m = np.triu(m, 1) + np.triu(m, 1).T
    labels = [f"s{i}" for i in range(n)]
    assert t_newick(t_upgma(m, labels)) == j_newick(j_upgma(m, labels))
    assert t_newick(t_upgma(TMatrix.from_array(m), labels), max_depth=3) == j_newick(
        j_upgma(JMatrix.from_array(m), labels), max_depth=3)
    assert TMatrix.from_array(m).minimum() == JMatrix.from_array(m).minimum()


def test_dna5_strings_equal_reference():
    from kgl_gene_tpu.sequence.alphabet import DNA5 as JDNA5

    text = "ACGTNacgtnUuRYX-"
    np.testing.assert_array_equal(DNA5.from_string(text), JDNA5.from_string(text))
    codes = np.arange(5, dtype=np.uint8)
    assert DNA5.to_string(codes) == JDNA5.to_string(codes)
