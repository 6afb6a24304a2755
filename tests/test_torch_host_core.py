"""The host remainder of the genomics core in the port against the JAX
package on the same inputs: analysis/legacy.py (GenomicMutation,
RNAAnalysis, PloidyAnalysis), sequence/complexity.py, variant/vep.py,
variant/filter.py (every filter class) and utils/{date_time, memory,
optimize, percentile, utility}. The oracles are the JAX package's tests of
the same modules (tests/test_legacy_and_device_sim.py,
test_complexity_motif_sort.py, test_variant_db.py, test_utils_infra.py,
test_aux_subsystems.py). Codes, counts, strings and the optimiser's floats
are compared exactly: both packages run the same numpy and scipy code."""

import sys

import numpy as np
import pytest

sys.path.insert(0, "tests")
from fixtures import CONTIG_1, make_genome_files, write_vcf  # noqa: E402

import kgl_gene_tpu.analysis.legacy as jleg  # noqa: E402
import kgl_gene_tpu.sequence.complexity as jcx  # noqa: E402
import kgl_gene_tpu.utils.date_time as jdt  # noqa: E402
import kgl_gene_tpu.utils.memory as jmem  # noqa: E402
import kgl_gene_tpu.utils.optimize as jopt  # noqa: E402
import kgl_gene_tpu.utils.percentile as jpct  # noqa: E402
import kgl_gene_tpu.utils.utility as jutil  # noqa: E402
import kgl_gene_tpu.variant.filter as jf  # noqa: E402
import kgl_gene_tpu.variant.vep as jvep  # noqa: E402
import kgl_gene_tpu_torch.analysis.legacy as tleg  # noqa: E402
import kgl_gene_tpu_torch.sequence.complexity as tcx  # noqa: E402
import kgl_gene_tpu_torch.utils.date_time as tdt  # noqa: E402
import kgl_gene_tpu_torch.utils.memory as tmem  # noqa: E402
import kgl_gene_tpu_torch.utils.optimize as topt  # noqa: E402
import kgl_gene_tpu_torch.utils.percentile as tpct  # noqa: E402
import kgl_gene_tpu_torch.utils.utility as tutil  # noqa: E402
import kgl_gene_tpu_torch.variant.filter as tf  # noqa: E402
import kgl_gene_tpu_torch.variant.vep as tvep  # noqa: E402
from kgl_gene_tpu.genome.genome import GenomeReference as JGenome  # noqa: E402
from kgl_gene_tpu.io import vcf as jvcf  # noqa: E402
from kgl_gene_tpu.sequence.sequence import DNA5SequenceLinear as JSeq  # noqa: E402
from kgl_gene_tpu.utils.intervals import OpenRightInterval as JIv  # noqa: E402
from kgl_gene_tpu.variant.columnar import VariantMajorView as JView  # noqa: E402
from kgl_gene_tpu.variant.variant import VariantPhase as JPhase  # noqa: E402
from kgl_gene_tpu_torch.genome.genome import GenomeReference as TGenome  # noqa: E402
from kgl_gene_tpu_torch.io import vcf as tvcf  # noqa: E402
from kgl_gene_tpu_torch.io.synthetic import generate_population_files  # noqa: E402
from kgl_gene_tpu_torch.sequence.sequence import DNA5SequenceLinear as TSeq  # noqa: E402
from kgl_gene_tpu_torch.utils.intervals import OpenRightInterval as TIv  # noqa: E402
from kgl_gene_tpu_torch.variant.columnar import VariantMajorView as TView  # noqa: E402
from kgl_gene_tpu_torch.variant.variant import VariantPhase as TPhase  # noqa: E402


def population_columns(pop):
    """{genome: {contig: {column: list}}} of a PopulationDB, and its ids."""
    return pop.population_id, {
        gid: {cid: {k: np.asarray(v).tolist() for k, v in c.columns().items()}
              for cid, c in g}
        for gid, g in pop
    }


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    base = tmp_path_factory.mktemp("hc")
    out = make_genome_files(base)
    out["vcf"] = write_vcf(str(base / "pop.vcf"))
    out["synthetic"] = generate_population_files(
        str(tmp_path_factory.mktemp("hcs")), n_samples=10, contig_len=20_000, n_genes=2,
        n_records=400, coding_len=300, seed=5, snp_only=False)
    return out


@pytest.fixture(scope="module")
def populations(files):
    """(JAX, port) populations and INFO stores of the fixture VCF and of a
    synthetic one with indels, both by the streaming loop."""
    out = {}
    for name, path in (("fixture", files["vcf"]), ("synthetic", files["synthetic"].vcf)):
        jp, _, ji = jvcf.parse_vcf_population(path, "p", "PF_DIPLOID", use_native=False)
        tp, _, ti = tvcf.parse_vcf_population(path, "p", "PF_DIPLOID", use_native=False)
        out[name] = (jp, ji, tp, ti)
    return out


# --------------------------------------------------------------------------- #
# variant/filter.py and variant/vep.py
# --------------------------------------------------------------------------- #
def _csq_store(mod):
    schemas = {"CSQ": mod.InfoSchema("CSQ", ".", "String",
                                     'Consequence annotations. Format: Allele|Consequence|Gene')}
    store = mod.InfoStore(schemas, ["CSQ"])
    store.add_record("CSQ=A|missense_variant|GENE1,A|synonymous_variant|GENE2")
    store.add_record("CSQ=T|stop_gained|GENE3")
    store.add_record("DP=4")
    return store


FILTERS = {
    "true": lambda m, p, i: m.TrueFilter(),
    "false": lambda m, p, i: m.FalseFilter(),
    "not_snp": lambda m, p, i: m.NotFilter(m.SNPFilter()),
    "invert_true": lambda m, p, i: ~m.TrueFilter(),
    "and": lambda m, p, i: m.DPCountFilter(18) & m.RefAltCountFilter(20),
    "or": lambda m, p, i: m.SNPFilter() | m.FrameShiftFilter(),
    "pass": lambda m, p, i: m.PassFilter(),
    "snp": lambda m, p, i: m.SNPFilter(),
    "frameshift": lambda m, p, i: m.FrameShiftFilter(),
    "dp_count": lambda m, p, i: m.DPCountFilter(21),
    "ref_alt_count": lambda m, p, i: m.RefAltCountFilter(20),
    "phase": lambda m, p, i: m.PhaseFilter(p.UNPHASED),
    "homozygous": lambda m, p, i: m.HomozygousFilter(),
    "heterozygous": lambda m, p, i: m.HeterozygousFilter(),
    "diploid": lambda m, p, i: m.DiploidFilter(),
    "unique_unphased": lambda m, p, i: m.UniqueUnphasedFilter(),
    "unique_phased": lambda m, p, i: m.UniquePhasedFilter(),
    "contig_region": lambda m, p, i: m.ContigRegionFilter(50, 130),
    "contig_modify": lambda m, p, i: m.ContigModifyFilter(50, 130),
    "info_geq": lambda m, p, i: (m.InfoGEQFloatFilter(i, "DP", 85.0) if i.has_field("DP")
                                 else m.InfoGEQFloatFilter(i, "AF", 0.15)),
    "p7_frequency": lambda m, p, i: m.P7FrequencyFilter(i, 0.2),
    "genome_list": lambda m, p, i: m.GenomeListFilter(["S1", "S3", "S0003"]),
}


@pytest.mark.parametrize("which", ["fixture", "synthetic"])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_equal(populations, which, name):
    jp, ji, tp, ti = populations[which]
    jout = jp.view_filter(FILTERS[name](jf, JPhase, ji))
    tout = tp.view_filter(FILTERS[name](tf, TPhase, ti))
    assert repr(FILTERS[name](tf, TPhase, ti)) == repr(FILTERS[name](jf, JPhase, ji))
    assert population_columns(tout) == population_columns(jout)
    if name in ("true", "pass"):
        assert tout.variant_count() == tp.variant_count()


def test_filter_levels_and_names():
    for cls in ("FilterVariants", "FilterOffsets", "FilterContigs", "FilterGenomes",
                "FilterPopulations"):
        assert issubclass(getattr(tf, cls), tf.BaseFilter)
    assert [c for c in tf.__all__] == [c for c in jf.__all__]


def test_vep_subfields_and_filter():
    jv, tv = jvep.VEPSubFields(_csq_store(jvcf)), tvep.VEPSubFields(_csq_store(tvcf))
    assert tv.has_vep() and tv.sub_fields == jv.sub_fields == ["Allele", "Consequence", "Gene"]
    for row in range(3):
        assert tv.records(row) == jv.records(row)
        for field in ("Gene", "Consequence", "Nope"):
            assert tv.sub_field_values(row, field) == jv.sub_field_values(row, field)
        for sub in ("missense", "stop", "x"):
            assert (tv.contains_substring(row, "Consequence", sub)
                    == jv.contains_substring(row, "Consequence", sub))
    assert tv.sub_field_index("Gene") == 2 and tv.sub_field_index("Nope") is None
    empty = tvep.VEPSubFields(tvcf.InfoStore({}, None))
    assert not empty.has_vep() and empty.records(0) == []


def test_vep_substring_filter():
    from kgl_gene_tpu.variant.db import PopulationDB as JPop
    from kgl_gene_tpu.variant.variant import Variant as JVar
    from kgl_gene_tpu_torch.variant.db import PopulationDB as TPop
    from kgl_gene_tpu_torch.variant.variant import Variant as TVar

    out = []
    for vcf_mod, pop_cls, var_cls, phase, seq, fmod, vmod in (
            (jvcf, JPop, JVar, JPhase, JSeq, jf, jvep), (tvcf, TPop, TVar, TPhase, TSeq, tf, tvep)):
        store = _csq_store(vcf_mod)
        pop = pop_cls("vep")
        for off, row in ((5, 0), (9, 1), (12, 2)):
            pop.add_variant(var_cls(CONTIG_1, off, phase.UNPHASED, "", seq.from_string("A"),
                                    seq.from_string("T"), info_index=row), ["G"])
        kept = pop.view_filter(fmod.VepSubStringFilter(vmod.VEPSubFields(store),
                                                       "Consequence", "missense"))
        out.append(population_columns(kept))
    assert out[1] == out[0]
    assert sum(len(c["offset"]) for g in out[1][1].values() for c in g.values()) == 1


# --------------------------------------------------------------------------- #
# sequence/complexity.py
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(4))
def test_complexity_equal(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 300))
    codes = rng.integers(0, 5 if seed % 2 else 4, n).astype(np.uint8)
    if seed == 3:
        codes = np.tile(np.array([1, 2], np.uint8), n // 2)  # repetitive, CpG-rich
    kmer = rng.integers(0, 4, int(rng.integers(1, 4))).astype(np.uint8)
    for j_seq, t_seq in ((JSeq(codes), TSeq(codes)), (codes, codes)):
        assert tcx.complexity_lempel_ziv(t_seq) == jcx.complexity_lempel_ziv(j_seq)
        assert tcx.alphabet_entropy(t_seq) == jcx.alphabet_entropy(j_seq)
        assert tcx.relative_cpg_islands(t_seq) == jcx.relative_cpg_islands(j_seq)
        assert tcx.kmer_count(t_seq, kmer) == jcx.kmer_count(j_seq, kmer)


def test_complexity_oracle_values():
    assert tcx.relative_cpg_islands(TSeq.from_string("CGCGCGCG")) == 4 * 32.0 / 8
    assert tcx.kmer_count(TSeq.from_string("AAAA"), TSeq.from_string("AA")) == 3
    assert tcx.complexity_lempel_ziv(TSeq.from_string("")) == 0
    assert abs(tcx.alphabet_entropy(TSeq.from_string("ACGT" * 100))
               - np.log(4) / np.log(5)) < 1e-12


# --------------------------------------------------------------------------- #
# analysis/legacy.py
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def genomes(files):
    return (JGenome.create_genome_database("g", files["fasta"], files["gff"]),
            TGenome.create_genome_database("g", files["fasta"], files["gff"]))


@pytest.mark.parametrize("region", [(50, 130), (0, 40), (90, 200)])
@pytest.mark.parametrize("sample", ["S1", "S2", "S4"])
def test_genomic_mutation_equal(genomes, populations, region, sample):
    jg, tg = genomes
    jp, ji, tp, ti = populations["fixture"]
    j_orig, j_mut = jleg.GenomicMutation.mutate_region(
        jg.get_contig(CONTIG_1), jp.get_genome(sample).get_contig(CONTIG_1), JIv(*region), ji)
    t_orig, t_mut = tleg.GenomicMutation.mutate_region(
        tg.get_contig(CONTIG_1), tp.get_genome(sample).get_contig(CONTIG_1), TIv(*region), ti)
    assert t_orig.to_string() == j_orig.to_string()
    assert t_mut.to_string() == j_mut.to_string()
    if region == (50, 130) and sample == "S1":
        assert (len(t_orig), len(t_mut)) == (80, 77)  # the 3-base deletion


def test_region_fasta(genomes, populations, tmp_path):
    _, tg = genomes
    _, _, tp, ti = populations["fixture"]
    orig, mut = tleg.GenomicMutation.mutate_region(
        tg.get_contig(CONTIG_1), tp.get_genome("S1").get_contig(CONTIG_1), TIv(50, 130), ti)
    path = str(tmp_path / "region.fasta")
    tleg.GenomicMutation.write_region_fasta(path, [("orig", orig), ("mut", mut)])
    text = open(path).read()
    assert text.startswith(">orig") and mut.to_string() in text


@pytest.mark.parametrize("motif", ["NN", "ATG", "RY"])
def test_rna_search_equal(genomes, motif):
    jg, tg = genomes
    spans = lambda res: [((r.lower, r.upper), [(h.lower, h.upper) for h in hits])  # noqa: E731
                         for r, hits in res]
    got = spans(tleg.RNAAnalysis.search_rna_regions(tg.get_contig(CONTIG_1), motif))
    assert got == spans(jleg.RNAAnalysis.search_rna_regions(jg.get_contig(CONTIG_1), motif))
    assert len(got) == 1
    supplied = spans(tleg.RNAAnalysis.search_rna_regions(
        tg.get_contig(CONTIG_1), motif, [TIv(0, 60), TIv(100, 180)]))
    assert supplied == spans(jleg.RNAAnalysis.search_rna_regions(
        jg.get_contig(CONTIG_1), motif, [JIv(0, 60), JIv(100, 180)]))


@pytest.mark.parametrize("which", ["fixture", "synthetic"])
def test_ploidy_equal(populations, which, tmp_path):
    jp, _, tp, _ = populations[which]
    out = []
    for mod, view, pop in ((jleg, JView, jp), (tleg, TView, tp)):
        ploidy = mod.PloidyAnalysis()
        ploidy.add_ploidy_record("S1", True, True, False, False, 0.95)
        ploidy.add_ploidy_record("S1", False, False, True, True, 0.5)
        ploidy.add_ploidy_record("S2", True, False, False, False, 1.5)  # outside [0, 1]
        ploidy.add_population(view(pop))
        path = str(tmp_path / f"{mod.__name__}.csv")
        assert ploidy.write_ploidy_results(path)
        out.append((open(path).read(), ploidy.ratio_histogram.tolist(),
                    {g: vars(d) for g, d in ploidy.genome_data.items()}))
    assert out[1] == out[0]
    assert "0.50,1" in out[1][0]


# --------------------------------------------------------------------------- #
# utils
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("text", ["2020/1/1", "2001-Feb-28", "2020-Jan-01", "1999/12/31",
                                  "2024-feb-29"])
def test_date_equal(text):
    j, t = jdt.DateGP(text), tdt.DateGP(text)
    assert (t.year, t.month, t.day, t.text()) == (j.year, j.month, j.day, j.text())
    a, b = tdt.DateGP(2020, 1, 1), tdt.DateGP(text)
    assert tdt.DateGP.days_difference(a, b) == jdt.DateGP.days_difference(jdt.DateGP(2020, 1, 1),
                                                                          j)
    assert tdt.DateGP.months_difference(a, b) == jdt.DateGP.months_difference(
        jdt.DateGP(2020, 1, 1), j)
    assert tdt.DateGP().not_initialized() and not t.not_initialized()


@pytest.mark.parametrize("bad", ["2001/2/29", "2001-Foo-01", "20010101"])
def test_date_invalid(bad):
    for mod in (jdt, tdt):
        with pytest.raises(ValueError):
            mod.DateGP(bad)


@pytest.mark.parametrize("algo,sense,dim", [
    ("LN_NELDERMEAD", "MAXIMIZE", 1), ("LD_LBFGS", "MINIMIZE", 2), ("LN_COBYLA", "MINIMIZE", 2),
    ("LN_SBPLX", "MINIMIZE", 2), ("GN_DIRECT", "MINIMIZE", 2),
])
def test_optimize_equal(algo, sense, dim):
    def objective(x, data):
        v = sum((xi - c) ** 2 for xi, c in zip(x, (3.0, -2.0)))
        return -v if sense == "MAXIMIZE" else v

    out = []
    for mod in (jopt, topt):
        opt = mod.Optimize(getattr(mod.OptimizationAlgorithm, algo), dim,
                           getattr(mod.OptimizationType, sense))
        opt.bounding_hypercube([10.0] * dim, [-10.0] * dim)
        opt.stopping_criteria(max_evaluations=2000, parameter_threshold=1e-9)
        coeffs = [0.5] * dim
        code, value, evals = opt.optimize(coeffs, None, objective)
        out.append((code.name, value, evals, coeffs, mod.Optimize.return_success(code)))
    assert out[1] == out[0]
    assert abs(out[1][3][0] - 3.0) < 1e-2


def test_optimize_direct_needs_bounds():
    opt = topt.Optimize(topt.OptimizationAlgorithm.GN_DIRECT, 1)
    assert opt.optimize([0.0], None, lambda x, d: x[0] ** 2) == (
        topt.OptimizeResult.FAILURE, 0.0, 0)


def test_percentile_equal():
    rng = np.random.default_rng(2)
    values = rng.normal(size=257)
    j, t = jpct.Percentile(), tpct.Percentile()
    assert t.percentile(0.5) is None and t.percentile_range(0, 1) == [] and t.rank(1.0) == 0.0
    for i, v in enumerate(values):
        j.add_element(v, f"p{i}")
        t.add_element(v, f"p{i}")
    assert len(t) == len(j) == 257
    for f in (0.0, 0.1, 0.5, 0.99, 1.0):
        assert t.percentile(f) == j.percentile(f)
    assert t.percentile_range(0.25, 0.75) == j.percentile_range(0.25, 0.75)
    for v in (-5.0, 0.0, 0.3, 5.0):
        assert t.rank(v) == j.rank(v)
    with pytest.raises(ValueError):
        t.percentile(1.5)


def test_utility_equal(tmp_path):
    path = tmp_path / "x.vcf.gz"
    path.write_text("x")
    for fn, args in (("tokenize", ("a\tb\t\tc", "\t")), ("tokenize", ("a::b", "::")),
                     ("char_tokenize", ("a,b,c", ",")), ("trim_ends", ("  ab \n",)),
                     ("file_exists", (str(path),)), ("file_exists", (str(tmp_path / "no"),)),
                     ("file_extension", (str(path),)), ("file_name", (str(path),))):
        assert getattr(tutil, fn)(*args) == getattr(jutil, fn)(*args), fn
    vm, rss = tutil.process_mem_usage()
    assert rss > 0 and vm >= rss
    sys_t, user_t = tutil.process_time_usage()
    assert sys_t >= 0 and user_t > 0
    assert tutil.__all__ == jutil.__all__


def test_memory_audit():
    """AuditMemory's probes on both packages (tracemalloc; the oracle is
    tests/test_aux_subsystems.py::TestMemoryAndHash::test_audit)."""
    for mod in (jmem, tmem):
        mod.AuditMemory.start_audit()
        big = np.zeros(500_000)
        current, peak = mod.AuditMemory.traced_bytes()
        assert peak >= big.nbytes and current > 0
        delta = mod.AuditMemory.audit_delta(top=5)
        assert isinstance(delta, list) and len(delta) <= 5
        assert mod.AuditMemory.trim_free_store() >= 0
        del big
    import tracemalloc
    tracemalloc.stop()
    assert tmem.AuditMemory.traced_bytes() == (0, 0)
