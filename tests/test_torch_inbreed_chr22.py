"""INBREED in two stages (analysis/inbreed_analysis.py: prepare, then
estimate) against the benchmark's plain float64 reference
(port_bench/reference/inbreed.py), on the CPU at a small size of the
1000 Genomes shape: 40 phased genomes in 3 super-populations x 3,000
records (SNPs and indels) over 2 contigs, with the release's INFO AF
columns (AF, AFR_AF, EUR_AF, EAS_AF) counted from the genotypes.

Tolerances (reference.TOLERANCE, each with its reason there): RitlandLocus
and Simple 1e-5 (float32 sums), HallME 1e-3 (the stop test), Loglikelihood
1e-4 (a float64 objective; a float32 one fails it). The selected loci must
be the reference's exactly. The estimators run in blocks of loci smaller
than L here, so the blocking is exercised.
"""

import math

import numpy as np
import pytest
import torch

from kgl_gene_tpu_torch.analysis import inbreed_analysis
from kgl_gene_tpu_torch.analysis.inbreed_analysis import InbreedAnalysis, InbreedColumns
from kgl_gene_tpu_torch.app.runtime import ParameterMap
from kgl_gene_tpu_torch.io.synthetic import generate_population_files
from kgl_gene_tpu_torch.io.vcf import parse_vcf_population
from kgl_gene_tpu_torch.stats import inbreeding as inb
from kgl_gene_tpu_torch.stats.frequency import FrequencyDatabaseRead
from kgl_gene_tpu_torch.variant.columnar import VariantMajorView
from port_bench.reference import inbreed as reference

from fixtures import write_vcf

SUPER = {"AFR": 14, "EUR": 13, "EAS": 13}
CONTIGS = {"21": 1500, "22": 1500}
TOLERANCE = reference.TOLERANCE


def _write_population_vcf(path, seed=5):
    """A phased VCF: per record a SNP (95%) or a 2-base deletion, an AF
    drawn uniform in [0, 1], each super population's AF drawn around it,
    each genome's F from a small list (an identical-by-descent draw with
    probability F), and the INFO AF fields counted from the genotypes."""
    rng = np.random.default_rng(seed)
    pops = np.repeat(np.arange(len(SUPER)), list(SUPER.values()))
    G = len(pops)
    f = rng.choice([0.0, 0.0625, 0.25, 0.5], G)
    names = [f"S{g:02d}" for g in range(G)]
    with open(path, "w") as out:
        out.write("##fileformat=VCFv4.2\n")
        for contig in CONTIGS:
            out.write(f"##contig=<ID={contig},length=3000000>\n")
        for field in ["AF"] + [f"{s}_AF" for s in SUPER]:
            out.write(f'##INFO=<ID={field},Number=A,Type=Float,Description="{field}">\n')
        out.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="gt">\n')
        out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  + "\t".join(names) + "\n")
        for contig, n in CONTIGS.items():
            positions = np.sort(rng.choice(np.arange(100, 2_000_000), n, replace=False))
            for pos in positions:
                p = rng.random()
                p_pop = rng.beta(p * 19 + 1e-3, (1 - p) * 19 + 1e-3, len(SUPER))[pops]
                a1 = rng.random(G) < p_pop
                a2 = np.where(rng.random(G) < f, a1, rng.random(G) < p_pop)
                alt = a1.astype(int) + a2
                info = [f"AF={alt.sum() / (2 * G):.6g}"] + [
                    f"{s}_AF={alt[pops == k].sum() / (2 * SUPER[s]):.6g}"
                    for k, s in enumerate(SUPER)]
                ref, alt_base = ("AC", "A") if rng.random() < 0.05 else ("A", "G")
                gts = [f"{int(x)}|{int(y)}" for x, y in zip(a1, a2)]
                out.write(f"{contig}\t{pos}\t.\t{ref}\t{alt_base}\t50\tPASS\t{';'.join(info)}\tGT\t"
                          + "\t".join(gts) + "\n")
    return path


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: an estimate is thousands
    of operations on small tensors, and with the suite's workers sharing the
    host, each operation's threads would wait on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def population(tmp_path_factory):
    path = _write_population_vcf(str(tmp_path_factory.mktemp("chr22") / "pop.vcf"))
    fields = ["AF"] + [f"{s}_AF" for s in SUPER]
    pop, _header, store = parse_vcf_population(path, "1kg", "PHASED_DIPLOID",
                                               subscribed_info=fields)
    pop.info_store = store
    return pop


@pytest.fixture(scope="module")
def columns(population):
    """The population prepared in blocks of 256 variants."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(inbreed_analysis, "PREPARE_BLOCK_VARIANTS", 256)
        return InbreedColumns.from_population(population, "cpu")


def _analysis(**params):
    analysis = InbreedAnalysis("cpu")
    block = ParameterMap("INBREED", {k: [str(v)] for k, v in params.items()})
    assert analysis.initialize_analysis(".", [block], None)
    return analysis


def test_columns_through_the_csr_equal_the_view(population, columns):
    view = VariantMajorView(population)
    # a record no genome carries holds no incidence
    assert view.genome_count == 40 and 2800 < view.variant_count <= sum(CONTIGS.values())
    assert columns.codes.dtype == torch.uint8
    np.testing.assert_array_equal(columns.codes.numpy().T, view.zygosity)
    np.testing.assert_array_equal(columns.offsets, view.offsets)
    np.testing.assert_array_equal(columns.contig_index, view.contig_index)
    np.testing.assert_array_equal(columns.is_snp, population.arena.is_snp_column()[view.rows])
    assert columns.genome_ids == view.genome_ids
    assert not columns.is_snp.all() and columns.is_snp.mean() > 0.9
    freq = FrequencyDatabaseRead(population.info_store)
    rows = np.array([population.arena.info_row(int(r)) for r in view.rows])
    for name in ("ALL", *SUPER):
        np.testing.assert_array_equal(columns.frequencies[name],
                                      freq.frequency_column(name)[rows])
    np.testing.assert_array_equal(columns.population_freq, view.allele_frequencies())
    assert len(np.unique(columns.contig_index)) == 2


@pytest.mark.parametrize("params", [
    {"MinAF": 0.05, "MaxAF": 1.0, "SamplingDistance": 1000},
    {"MinAF": 0.05, "MaxAF": 1.0, "SamplingDistance": 20000, "LociiCount": 30},
    {"MinAF": 0.2, "MaxAF": 0.6, "SamplingDistance": 0, "LowerWindow": 300000,
     "UpperWindow": 1500000},
], ids=["thinned", "capped", "window"])
@pytest.mark.parametrize("super_population", ["ALL", *SUPER])
def test_selected_loci_equal_the_reference(columns, params, super_population):
    analysis = _analysis(**params)
    loci, af = analysis.selected_loci(columns, super_population)
    want = reference.select_loci(
        columns.offsets, columns.contig_index, columns.is_snp,
        columns.frequencies[super_population], params["MinAF"], params["MaxAF"],
        params["SamplingDistance"], params.get("LociiCount", 2**62),
        params.get("LowerWindow", 0), params.get("UpperWindow", 2**62))
    np.testing.assert_array_equal(loci, want)
    np.testing.assert_array_equal(af, columns.frequencies[super_population][want])
    assert len(loci) > 10
    if "LociiCount" in params:  # the cap holds on each contig
        assert [int((columns.contig_index[loci] == c).sum()) for c in (0, 1)] == [30, 30]


@pytest.fixture
def small_blocks(monkeypatch):
    """Blocks of 48 loci and grid chunks of 5 points at 40 genomes."""
    monkeypatch.setattr(inb, "_BLOCK_ELEMENTS", 40 * 48)
    monkeypatch.setattr(inb, "_GRID_CHUNK_ELEMENTS", 40 * 48 * 5)
    assert inb.loci_block(40) == 48


@pytest.mark.parametrize("super_population", ["ALL", *SUPER])
def test_estimators_within_tolerance_of_the_reference(columns, small_blocks, super_population):
    analysis = _analysis(MinAF=0.05, SamplingDistance=500)
    est = analysis.estimate(columns, super_population)
    L = len(est.loci)
    assert est.algorithms == list(reference.ESTIMATORS) and est.f.shape == (40, 4)
    assert L > 10 * inb.loci_block(40)  # many blocks of loci
    want = reference.estimators(columns.codes, est.loci, est.minor_freq).numpy()
    for k, name in enumerate(reference.ESTIMATORS):
        gap = np.abs(est.f[:, k].astype(np.float64) - want[:, k]).max()
        assert gap <= TOLERANCE[name], (name, gap)
    assert np.ptp(want[:, 0]) > 0.1  # the genomes' F differ


def test_one_algorithm_and_the_blocks_give_the_whole_result(columns, monkeypatch):
    """An estimate of one algorithm equals its column of ALL, and the blocks
    change no count: Simple and RitlandLocus within float32 rounding."""
    whole = _analysis(MinAF=0.05).estimate(columns, "EUR")
    for k, name in enumerate(reference.ESTIMATORS):
        one = _analysis(MinAF=0.05, Algorithm=name).estimate(columns, "EUR")
        np.testing.assert_array_equal(one.f[:, 0], whole.f[:, k])
    monkeypatch.setattr(inb, "_BLOCK_ELEMENTS", 40 * 7)
    blocked = _analysis(MinAF=0.05).estimate(columns, "EUR")
    np.testing.assert_allclose(blocked.f, whole.f, rtol=0, atol=1e-6)


def test_loglikelihood_in_float32_fails_its_tolerance(columns):
    """The tolerances tell the precision apart: the reference's Loglikelihood
    objective in float32 lies past 1e-4 of float64's, the other three
    estimators unmoved."""
    loci, af = _analysis(MinAF=0.05).selected_loci(columns, "ALL")
    exact = reference.estimators(columns.codes, loci, af).numpy()
    low = reference.estimators(columns.codes, loci, af, loglik_dtype=torch.float32).numpy()
    gaps = np.abs(low - exact).max(0)
    assert gaps[3] > TOLERANCE["Loglikelihood"], gaps
    assert (gaps[:3] == 0).all()
    port = _analysis(MinAF=0.05).estimate(columns, "ALL").f[:, 3]
    assert np.abs(port - exact[:, 3]).max() <= TOLERANCE["Loglikelihood"]


def test_columns_handed_in_directly_estimate_as_the_population(columns):
    handed = InbreedColumns.on_device(
        columns.codes.numpy(), columns.offsets, columns.contig_index, columns.is_snp,
        columns.genome_ids, {"af": columns.frequencies["ALL"], "eas": columns.frequencies["EAS"]},
        "cpu")
    analysis = _analysis(MinAF=0.05, SamplingDistance=1000)
    for name in ("ALL", "EAS"):
        a, b = analysis.estimate(columns, name), analysis.estimate(handed, name)
        np.testing.assert_array_equal(a.loci, b.loci)
        np.testing.assert_array_equal(a.f, b.f)
    # no column for AFR: the population's own frequencies, as from a population
    # whose INFO lacks it
    own = analysis.estimate(handed, "AFR")
    np.testing.assert_array_equal(
        own.loci, analysis.selected_loci(columns, "no-such-super-population")[0])
    with pytest.raises(ValueError):
        InbreedColumns.on_device(columns.codes, columns.offsets[:-1], columns.contig_index,
                                 columns.is_snp, columns.genome_ids, {}, "cpu")


def test_counters_and_spans_of_an_estimate(columns):
    analysis = _analysis(MinAF=0.05, SamplingDistance=1000)
    before = dict(inb.COUNTERS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        est = analysis.estimate(columns, "AFR")
    got = {k: n - before.get(k, 0) for k, n in inb.COUNTERS.items()}
    assert got["loci"] == len(est.loci)
    assert got["loglik_evaluations"] == 65 + 2 * 40
    assert got["hallme_stop_reads"] == math.ceil(got["hallme_steps"] / 8) + (
        got["hallme_steps"] % 8 == 0)
    names = {e.name for e in prof.events()}
    assert {"kgt.inbreed", "kgt.inbreed.select", "kgt.inbreed.upload", "kgt.inbreed.gather",
            "kgt.inbreed.ritland", "kgt.inbreed.simple", "kgt.inbreed.hallme",
            "kgt.inbreed.loglik", "kgt.inbreed.fetch"} <= names


def _old_csv_rows(population, analysis):
    """The F rows the analysis wrote before it ran in two stages: every
    variant of VariantMajorView under a (G, V) mask of the selected loci."""
    view = VariantMajorView(population)
    freq = FrequencyDatabaseRead(population.info_store).frequency_column(
        analysis.super_population)
    if freq is None:
        p = view.allele_frequencies()
    else:
        rows = np.array([population.arena.info_row(int(r)) for r in view.rows])
        p = np.where(rows >= 0, freq[np.clip(rows, 0, len(freq) - 1)], np.nan)
    p = np.nan_to_num(np.asarray(p, dtype=np.float64), nan=0.0)
    candidate = ((p >= analysis.min_af) & (p <= analysis.max_af)
                 & population.arena.is_snp_column()[view.rows] & (p > 0) & (p < 1))
    selected = analysis.select_loci(view.offsets, view.contig_index, candidate,
                                    analysis.lower_window, analysis.upper_window,
                                    analysis.sampling_distance, analysis.locii_count)
    data = inb.LocusData(view.zygosity, p, np.broadcast_to(selected, view.zygosity.shape).copy())
    f = {name: inb._estimate(name, data, "cpu") for name in analysis.algorithms}
    return view.genome_ids, f


@pytest.mark.parametrize("params,which", [
    ({}, "fixture"),
    ({"Algorithm": "Simple"}, "fixture"),
    ({}, "syn"),
    ({"Algorithm": "HallME", "MinAF": "0.05", "MaxAF": "0.6"}, "syn"),
    ({"Algorithm": "Loglikelihood", "SamplingDistance": "40", "LociiCount": "60",
      "LowerWindow": "100", "UpperWindow": "5000"}, "syn"),
    ({"Algorithm": "RitlandLocus", "SuperPopulation": "AFR"}, "syn"),
    ({"SuperPopulation": "EUR", "MinAF": "0.05", "SamplingDistance": "1000"}, "1kg"),
])
def test_inbreeding_csv_is_unchanged(tmp_path, population, params, which):
    """inbreeding.csv of file_read_analysis (prepare, estimate) against the F
    rows of the analysis's one-stage path over the same population: the
    genomes and the header exactly, F within the tolerances."""
    if which == "fixture":
        pop, _h, store = parse_vcf_population(write_vcf(str(tmp_path / "pop.vcf")), "cohort",
                                              "PF_DIPLOID", subscribed_info=["AF"])
        pop.info_store = store
    elif which == "syn":
        files = generate_population_files(str(tmp_path), n_samples=16, contig_len=6_000,
                                          n_genes=2, n_records=200, coding_len=300, seed=4,
                                          snp_only=False)
        pop, _h, store = parse_vcf_population(files.vcf, "syn", "PF_DIPLOID",
                                              subscribed_info=["AF"])
        pop.info_store = store
    else:
        pop = population
    analysis = InbreedAnalysis("cpu")
    block = ParameterMap("INBREED", {k: [v] for k, v in params.items()})
    assert analysis.initialize_analysis(str(tmp_path), [block], None)
    assert analysis.file_read_analysis(pop) and analysis.finalize_analysis()
    lines = (tmp_path / "inbreeding.csv").read_text().splitlines()
    algos = sorted(analysis.algorithms)
    assert lines[0] == "Genome," + ",".join(algos)
    genome_ids, f = _old_csv_rows(pop, analysis)
    assert [line.split(",")[0] for line in lines[1:]] == sorted(genome_ids)
    order = {g: i for i, g in enumerate(genome_ids)}
    for line in lines[1:]:
        gid, *values = line.split(",")
        for name, value in zip(algos, values):
            assert abs(float(value) - float(f"{f[name][order[gid]]:.6f}")) <= TOLERANCE[name]
