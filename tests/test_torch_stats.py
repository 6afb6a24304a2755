"""The port's population statistics against the JAX package's on the CPU:
the variant-major views (variant/columnar.py), VariantSort, allele
frequencies (stats/frequency.py), FWS (stats/fws.py), the four inbreeding
estimators (stats/inbreeding.py) and the single-device reductions of
parallel/mesh.py, on tests/test_stats.py's fixture population, on a
synthetic scale VCF and on synthetic_diploid_population, from numpy seeds.

Tolerances: counts, CSR arrays, zygosity, summaries and FWS bins exact;
Simple and RitlandLocus within 1e-5; HallME within 1e-3 (its stop test is
1e-4, so one step more or fewer is allowed); Loglikelihood within 1e-4 of
the JAX package run with x64 enabled. The JAX package's float32
Loglikelihood is itself up to ~5e-4 from the exact maximum (float32
rounding of the objective, see the port's _loglik_rows), which the port
avoids by evaluating the objective in float64."""

import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from fixtures import make_genome_files, write_vcf  # noqa: E402

from kgl_gene_tpu.genome.genome import GenomeReference as JGenome  # noqa: E402
from kgl_gene_tpu.io.vcf import parse_vcf_population as j_parse  # noqa: E402
from kgl_gene_tpu.parallel import mesh as j_mesh  # noqa: E402
from kgl_gene_tpu.stats import inbreeding as j_inb  # noqa: E402
from kgl_gene_tpu.stats.frequency import FrequencyDatabaseRead as JFreq  # noqa: E402
from kgl_gene_tpu.stats.fws import CalcFWS as JFws  # noqa: E402
from kgl_gene_tpu.variant import columnar as j_col  # noqa: E402
from kgl_gene_tpu.variant.sort import VariantSort as JSort  # noqa: E402
from kgl_gene_tpu_torch.genome.genome import GenomeReference as TGenome  # noqa: E402
from kgl_gene_tpu_torch.io.synthetic import generate_scale_vcf  # noqa: E402
from kgl_gene_tpu_torch.io.vcf import parse_vcf_population as t_parse  # noqa: E402
from kgl_gene_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from kgl_gene_tpu_torch.stats import inbreeding as t_inb  # noqa: E402
from kgl_gene_tpu_torch.stats.frequency import FrequencyDatabaseRead as TFreq  # noqa: E402
from kgl_gene_tpu_torch.stats.fws import FREQUENCY_BINS, CalcFWS as TFws  # noqa: E402
from kgl_gene_tpu_torch.variant import columnar as t_col  # noqa: E402
from kgl_gene_tpu_torch.variant.sort import VariantSort as TSort  # noqa: E402

ESTIMATOR_ATOL = {"Simple": 1e-5, "RitlandLocus": 1e-5, "HallME": 1e-3, "Loglikelihood": 1e-4}
ESTIMATORS = sorted(ESTIMATOR_ATOL)


@pytest.fixture(scope="module", params=["fixture", "scale"])
def populations(request, tmp_path_factory):
    """(JAX population, JAX info, port population, port info) of one VCF:
    test_stats.py's fixture, or a 600-record x 40-sample scale VCF."""
    base = tmp_path_factory.mktemp("pop")
    if request.param == "fixture":
        path, sub = write_vcf(str(base / "pop.vcf")), None
    else:
        path, sub = generate_scale_vcf(str(base / "s.vcf"), n_records=600, n_samples=40), ["AF"]
    jpop, _h, jinfo = j_parse(path, "pop", "PF_DIPLOID", subscribed_info=sub)
    tpop, _h, tinfo = t_parse(path, "pop", "PF_DIPLOID", subscribed_info=sub)
    return jpop, jinfo, tpop, tinfo


def _same_arrays(t, j, names):
    for name in names:
        tv, jv = getattr(t, name), getattr(j, name)
        np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv), err_msg=name)


def test_variant_major_view_equal(populations):
    jpop, _ji, tpop, _ti = populations
    j, t = j_col.VariantMajorView(jpop), t_col.VariantMajorView(tpop)
    assert t.genome_ids == j.genome_ids
    assert (t.genome_count, t.variant_count) == (j.genome_count, j.variant_count)
    _same_arrays(t, j, ("zygosity", "rows", "contig_index", "offsets"))
    assert t.hgvs == j.hgvs
    for pair in (*zip(t.het_hom_by_variant(), j.het_hom_by_variant()),
                 *zip(t.het_hom_by_genome(), j.het_hom_by_genome()),
                 (t.alt_allele_counts(), j.alt_allele_counts()),
                 (t.allele_frequencies(), j.allele_frequencies())):
        np.testing.assert_array_equal(*pair)
    assert t.allele_number() == j.allele_number()
    for i in range(t.variant_count):
        assert vars(t.summary_by_variant(i)) == vars(j.summary_by_variant(i))
    for gid in t.genome_ids:
        assert vars(t.summary_by_genome(gid)) == vars(j.summary_by_genome(gid))


def test_variant_major_csr_equal(populations):
    jpop, _ji, tpop, _ti = populations
    j, t = j_col.VariantMajorCSR(jpop), t_col.VariantMajorCSR(tpop)
    assert t.genome_ids == j.genome_ids and t.nnz == j.nnz
    _same_arrays(t, j, ("values", "variant_of", "genome_of", "indptr", "rows",
                        "contig_index", "offsets"))
    for pair in (*zip(t.het_hom_by_variant(), j.het_hom_by_variant()),
                 *zip(t.het_hom_by_genome(), j.het_hom_by_genome()),
                 (t.alt_allele_counts(), j.alt_allele_counts()),
                 (t.allele_frequencies(), j.allele_frequencies())):
        np.testing.assert_array_equal(*pair)
    for i in range(t.variant_count):
        assert vars(t.summary_by_variant(i)) == vars(j.summary_by_variant(i))
    for gid in t.genome_ids:
        assert vars(t.summary_by_genome(gid)) == vars(j.summary_by_genome(gid))


@pytest.mark.parametrize("block", [1, 2, 7, 4096])
def test_dense_blocks_equal(populations, block):
    jpop, _ji, tpop, _ti = populations
    j, t = j_col.VariantMajorCSR(jpop), t_col.VariantMajorCSR(tpop)
    dense = t_col.VariantMajorView(tpop).zygosity
    got = list(t.iter_dense_blocks(block_variants=block))
    want = list(j.iter_dense_blocks(block_variants=block))
    assert [v for v, _b in got] == [v for v, _b in want]
    for (_v, tb), (_w, jb) in zip(got, want):
        np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(np.concatenate([b for _v, b in got], axis=1), dense)
    for v_lo in range(0, t.variant_count, block):
        v_hi = min(v_lo + block, t.variant_count)
        np.testing.assert_array_equal(t.dense_block_t(v_lo, v_hi), j.dense_block_t(v_lo, v_hi))
        np.testing.assert_array_equal(t.dense_block_t(v_lo, v_hi), dense[:, v_lo:v_hi].T)


def test_csr_native_build_equals_plain_build(populations, monkeypatch):
    """VariantMajorCSR's native presence and dedup against the numpy plain
    versions, as test_stats.py holds the JAX package's native build against
    its numpy fallback."""
    _jpop, _ji, tpop, _ti = populations
    a = t_col.VariantMajorCSR(tpop)
    import kgl_gene_tpu_torch.native as native

    monkeypatch.setattr(native, "mark_presence", t_col.presence_plain)
    monkeypatch.setattr(native, "csr_build", t_col.csr_triples_plain)
    b = t_col.VariantMajorCSR(tpop)
    _same_arrays(a, b, ("values", "variant_of", "genome_of", "indptr", "rows"))


def test_csr_of_a_large_random_population_equals_jax():
    """Many (genome, contig) parts and an arena of 5,000 alleles, as
    test_stats.py's million-incidence build (at a tenth of its size)."""
    from kgl_gene_tpu.variant.db import PopulationDB as JPop
    from kgl_gene_tpu_torch.variant.db import PopulationDB as TPop

    rng = np.random.default_rng(0)
    pops = (JPop("scale", "TEST"), TPop("scale", "TEST"))
    n_alleles, n_genomes, per_genome = 5000, 50, 2000
    base = rng.integers(0, 4, size=n_alleles).astype(np.uint8)
    alt = (base + 1) % 4
    picks = [rng.integers(0, n_alleles, size=per_genome) for _ in range(n_genomes)]
    zi, zf, ones = (np.zeros(per_genome, np.int64), np.zeros(per_genome, np.float32),
                    np.ones(per_genome, bool))
    for pop in pops:
        rows = np.asarray([pop.arena.intern(f"chr{1 + i % 2}", 10 * i, base[i:i + 1],
                                            alt[i:i + 1]) for i in range(n_alleles)])
        for g in range(n_genomes):
            contig = pop.get_create_genome(f"G{g}").get_create_contig(f"chr{1 + g % 2}")
            contig.add_incidence_block(rows[picks[g]], zi.astype(np.uint8), zi, zi, zi,
                                       zf, zf, ones)
    j, t = j_col.VariantMajorCSR(pops[0]), t_col.VariantMajorCSR(pops[1])
    _same_arrays(t, j, ("values", "variant_of", "genome_of", "indptr", "rows"))
    np.testing.assert_array_equal(t.alt_allele_counts(), j.alt_allele_counts())


def test_variant_sort_equal(tmp_path):
    files = make_genome_files(tmp_path)
    path = write_vcf(str(tmp_path / "pop.vcf"))
    jpop, _h, _i = j_parse(path, "pop", "PF_DIPLOID")
    tpop, _h, _i = t_parse(path, "pop", "PF_DIPLOID")
    assert TSort.variant_id_index(tpop) == JSort.variant_id_index(jpop)
    assert TSort.genome_variant_id_index(tpop) == JSort.genome_variant_id_index(jpop)
    jg = JGenome.create_genome_database("ref", files["fasta"], files["gff"])
    tg = TGenome.create_genome_database("ref", files["fasta"], files["gff"])
    for span in (True, False):
        got = TSort.gene_variant_index(tpop, tg, use_span=span)
        assert got == JSort.gene_variant_index(jpop, jg, use_span=span)
    assert got


def test_frequency_read_equal(populations):
    _jpop, jinfo, _tpop, tinfo = populations
    j, t = JFreq(jinfo), TFreq(tinfo)
    for sp in ("AFR", "AMR", "EAS", "EUR", "SAS", "ALL"):
        for row in range(jinfo.count):
            assert t.allele_frequency(sp, row) == j.allele_frequency(sp, row)
            assert t.allele_count(sp, row) == j.allele_count(sp, row)
            assert t.allele_total(sp, row) == j.allele_total(sp, row)
        jc, tc = j.frequency_column(sp), t.frequency_column(sp)
        assert (jc is None) == (tc is None)
        if jc is not None:
            np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("supplied_af", [False, True])
def test_fws_equal(populations, supplied_af, tmp_path):
    jpop, _ji, tpop, _ti = populations
    jv, tv = j_col.VariantMajorView(jpop), t_col.VariantMajorView(tpop)
    af = (np.random.default_rng(4).uniform(0.0, 1.0, tv.variant_count)
          if supplied_af else None)
    j, t = JFws(jv, allele_freq=af), TFws(tv, allele_freq=af)
    assert list(t.genome_map) == list(j.genome_map)
    for gid, jr in j.genome_map.items():
        tr = t.genome_map[gid]
        assert tr.fws == jr.fws, gid
        assert [vars(b) for b in tr.bins] == [vars(b) for b in jr.bins]
        assert len(tr.bins) == len(FREQUENCY_BINS)
    assert {k: vars(v) for k, v in t.variant_map.items()} == \
        {k: vars(v) for k, v in j.variant_map.items()}
    assert t.monoclonal_genomes(0.95) == j.monoclonal_genomes(0.95)
    for writer in ("write_genome_results", "write_variant_results"):
        getattr(j, writer)(str(tmp_path / "j.csv"))
        getattr(t, writer)(str(tmp_path / "t.csv"))
        assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


def _jax_estimate(name, data):
    """The JAX package's estimator; Loglikelihood with x64 enabled (see the
    module docstring)."""
    if name == "Loglikelihood":
        with jax.enable_x64(True):
            return j_inb._estimate(name, data)
    return j_inb._estimate(name, data)


def _locus_cases():
    """(name, LocusData) pairs: synthetic populations from numpy seeds, one
    with loci of p = 0 and p = 1 (invalid), one with a genome of no valid
    locus and constant genomes."""
    out = []
    for seed, G, L in ((7, 6, 5000), (3, 9, 700)):
        truth = np.linspace(0.0, 0.9, G)
        out.append((f"synthetic_{seed}", t_inb.synthetic_diploid_population(G, L, truth,
                                                                            seed=seed)))
    rng = np.random.default_rng(11)
    z = rng.integers(0, 3, (5, 400)).astype(np.uint8)
    z[1] = 0
    z[2] = 2
    z[3] = 1
    p = rng.uniform(0.0, 0.5, 400)
    p[::7] = 0.0
    p[::11] = 1.0
    valid = np.broadcast_to((p > 0) & (p < 1), z.shape).copy()
    valid[4] = False
    out.append(("edges", t_inb.LocusData(zygosity=z, minor_freq=p, valid=valid)))
    return out


LOCUS_CASES = _locus_cases()


def test_synthetic_population_equal():
    for seed in (0, 7):
        truth = np.array([0.0, 0.3, 0.8])
        j = j_inb.synthetic_diploid_population(3, 500, truth, seed=seed)
        t = t_inb.synthetic_diploid_population(3, 500, truth, seed=seed)
        for name in ("zygosity", "minor_freq", "valid"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


@pytest.mark.parametrize("case", [name for name, _d in LOCUS_CASES])
@pytest.mark.parametrize("algorithm", ESTIMATORS)
def test_estimator_equal(algorithm, case):
    data = dict(LOCUS_CASES)[case]
    want = _jax_estimate(algorithm, data)
    got = t_inb._estimate(algorithm, data, "cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ESTIMATOR_ATOL[algorithm])


def test_estimator_functions_and_truth():
    """The public functions, inbreeding_all, and the synthetic truth within
    test_stats.py's 0.05."""
    truth = np.array([0.0, 0.1, 0.25, 0.5, 0.75])
    data = t_inb.synthetic_diploid_population(5, 20000, truth, seed=7)
    every = t_inb.inbreeding_all(data, device="cpu")
    assert sorted(every) == ESTIMATORS
    for fn, name in ((t_inb.simple_f, "Simple"), (t_inb.ritland_f, "RitlandLocus"),
                     (t_inb.hall_me_f, "HallME"), (t_inb.loglikelihood_f, "Loglikelihood")):
        got = fn(data, device="cpu")
        np.testing.assert_array_equal(got, every[name])
        np.testing.assert_allclose(got, truth, atol=0.05)


def test_loglikelihood_grid_chunks_do_not_change_the_result(monkeypatch):
    data = dict(LOCUS_CASES)["synthetic_3"]
    whole = t_inb.loglikelihood_f(data, device="cpu")
    monkeypatch.setattr(t_inb, "_GRID_CHUNK_ELEMENTS", 9 * 700 * 3)  # 3 grid points a chunk
    np.testing.assert_array_equal(t_inb.loglikelihood_f(data, device="cpu"), whole)


def test_entry_points_need_a_device_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = dict(LOCUS_CASES)["edges"]
    with pytest.raises(RuntimeError):
        t_inb.simple_f(data)
    with pytest.raises(RuntimeError):
        t_mesh.sharded_allele_counts(data.zygosity)


def test_pad_to_multiple_equal():
    a = np.arange(15).reshape(5, 3)
    for multiple, axis, fill in ((8, 0, 0), (4, 1, -1), (5, 0, 0)):
        np.testing.assert_array_equal(t_mesh.pad_to_multiple(a, multiple, axis, fill),
                                      j_mesh.pad_to_multiple(a, multiple, axis, fill))


def test_allele_counts_and_het_hom_equal(populations):
    jpop, _ji, tpop, _ti = populations
    z = t_col.VariantMajorView(tpop).zygosity
    mesh = j_mesh.sample_mesh()
    np.testing.assert_array_equal(t_mesh.sharded_allele_counts(z, "cpu"),
                                  j_mesh.sharded_allele_counts(z, mesh))
    for got, want in zip(t_mesh.sharded_het_hom(z, "cpu"), j_mesh.sharded_het_hom(z, mesh)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("algorithm", ESTIMATORS)
def test_sharded_inbreeding_equal(algorithm):
    data = dict(LOCUS_CASES)["synthetic_3"]
    p = data.minor_freq.copy()
    p[::13] = 0.0  # invalid loci, excluded by the function's own mask
    got = t_mesh.sharded_inbreeding(data.zygosity, p, "cpu", algorithm)
    if algorithm == "HallME":
        # The JAX package's HallME does not trace under its shard_map here
        # (the while_loop's carry starts as a constant, unvarying over the
        # mesh axis): its unsharded estimator on the same loci is the
        # reference.
        valid = (p.astype(np.float32) > 0) & (p.astype(np.float32) < 1)
        want = j_inb._estimate(algorithm, j_inb.LocusData(data.zygosity, p, np.broadcast_to(
            valid, data.zygosity.shape).copy()))
    elif algorithm == "Loglikelihood":
        with jax.enable_x64(True):
            want = j_mesh.sharded_inbreeding(data.zygosity, p, j_mesh.sample_mesh(), algorithm)
    else:
        want = j_mesh.sharded_inbreeding(data.zygosity, p, j_mesh.sample_mesh(), algorithm)
    np.testing.assert_allclose(got, want, rtol=0, atol=ESTIMATOR_ATOL[algorithm])
    local = t_inb._estimate(algorithm, t_inb.LocusData(data.zygosity, p), "cpu")
    np.testing.assert_allclose(got, local, rtol=0, atol=1e-6)


@pytest.mark.parametrize("block, slab", [(None, t_mesh.SLAB_ELEMENTS), (64, 40), (8, 1),
                                         (100, 4000)])
def test_streamed_inbreeding_equals_single_shot_and_jax(tmp_path, monkeypatch, block, slab):
    """Blocks small enough to take several, and row slabs of one row up to
    the whole block: equal within 1e-5 to the single-shot estimators on the
    dense matrix and to the JAX package's streamed result."""
    path = generate_scale_vcf(str(tmp_path / "s.vcf"), n_records=900, n_samples=30)
    tpop, _h, _i = t_parse(path, "s", "PF_DIPLOID")
    jpop, _h, _i = j_parse(path, "s", "PF_DIPLOID")
    csr = t_col.VariantMajorCSR(tpop)
    af = csr.allele_frequencies()
    assert block is None or csr.variant_count > 2 * block
    with pytest.raises(ValueError):
        t_mesh.streamed_inbreeding(csr, af, "cpu", algorithms=("HallME",))
    monkeypatch.setattr(t_mesh, "SLAB_ELEMENTS", slab)
    got = t_mesh.streamed_inbreeding(csr, af, "cpu", block_variants=block)
    want = j_mesh.streamed_inbreeding(j_col.VariantMajorCSR(jpop), af, j_mesh.sample_mesh(1),
                                      block_variants=block)
    dense = csr.dense_block(0, csr.variant_count)
    for name in ("Simple", "RitlandLocus"):
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5)
        single = t_mesh.sharded_inbreeding(dense, af, "cpu", name)
        np.testing.assert_allclose(got[name], single, rtol=0, atol=1e-5)


def test_inbreed_moments_slabs_equal_one_slab(monkeypatch):
    rng = np.random.default_rng(5)
    block = rng.integers(0, 3, (64, 12)).astype(np.uint8)
    packed = torch.from_numpy(t_mesh.pack_block(block))
    p = torch.from_numpy(rng.uniform(0.0, 0.6, 64).astype(np.float32))
    acc = torch.zeros((12, 5))
    one = t_mesh._inbreed_moments(packed, p, acc, 16)
    for slab_rows in (1, 3, 5):
        np.testing.assert_allclose(t_mesh._inbreed_moments(packed, p, acc, slab_rows).numpy(),
                                   one.numpy(), rtol=1e-6, atol=1e-5)
    monkeypatch.setattr(t_mesh, "SLAB_ELEMENTS", 60)
    assert [t_mesh.slab_rows_for(g) for g in (1, 12, 16, 61)] == [32, 4, 2, 1]
    unpacked = np.stack([(t_mesh.pack_block(block) >> (2 * j)) & 3 for j in range(4)], axis=1)
    np.testing.assert_array_equal(unpacked.reshape(64, 12), block)
