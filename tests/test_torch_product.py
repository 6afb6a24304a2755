"""The product path of the port (FASTA + GFF3 + VCF -> PopulationDB ->
capture -> SNP and SNP + indel steps -> one packed fetch -> records,
kgl_gene_tpu_torch.analysis.lib_seqmutation.MutateGenes.mutate_transcripts)
against the JAX package's MutateGenes on the CPU: every record field and
every MutateStats field equal, in both indel payload modes, under the
default filter (device routes) and the others (SNP device route, the rest
on the host engine), with capture buckets pinned and unpinned, and on the
host-exact route. Shapes: test_synthetic_e2e.py's (12 samples, two
300-base genes, with and without indels) and the fixture genes (GENE1:
two exons on '+'; GENE2: '-' strand) under populations that carry SNPs,
insertions and deletions."""

import sys

import numpy as np
import pytest

sys.path.insert(0, "tests")
from fixtures import CONTIG_1, CONTIG_2, build_contig1, build_contig2, make_genome_files  # noqa: E402

import kgl_gene_tpu.analysis.lib_seqmutation as j_lsm  # noqa: E402
import kgl_gene_tpu_torch.analysis.lib_seqmutation as t_lsm  # noqa: E402
from kgl_gene_tpu.genome.genome import GenomeReference as JGenome  # noqa: E402
from kgl_gene_tpu.io.synthetic import generate_population_files  # noqa: E402
from kgl_gene_tpu.io.vcf import parse_vcf_population as j_parse  # noqa: E402
from kgl_gene_tpu.mutation.sequence_filter import SeqVariantFilterType as JFilter  # noqa: E402
from kgl_gene_tpu_torch.genome.genome import GenomeReference as TGenome  # noqa: E402
from kgl_gene_tpu_torch.io.vcf import parse_vcf_population as t_parse  # noqa: E402
from kgl_gene_tpu_torch.mutation.sequence_filter import SeqVariantFilterType as TFilter  # noqa: E402

SYNTH = dict(n_samples=12, contig_len=24_000, n_genes=2, n_records=600, coding_len=300,
             seed=3)
STAT_FIELDS = ("total_genomes", "mutant_genomes", "total_variants", "total_snp",
               "total_frameshift", "duplicate_variants", "upstream_deleted",
               "valid_proteins", "invalid_proteins")


def assert_same_results(j_results, t_results):
    assert len(t_results) == len(j_results)
    for (j_recs, j_stats), (t_recs, t_stats) in zip(j_results, t_results):
        assert len(t_recs) == len(j_recs) > 0
        for a, b in zip(j_recs, t_recs):
            assert (b.genome_id, b.gene_id, b.transcript_id, b.variant_count,
                    b.modified_coding, b.validity.value, b.distance) == (
                a.genome_id, a.gene_id, a.transcript_id, a.variant_count,
                a.modified_coding, a.validity.value, a.distance), a.genome_id
        for f in STAT_FIELDS:
            assert getattr(t_stats, f) == getattr(j_stats, f), f


def run_both(monkeypatch, j_contig, t_contig, j_pop, t_pop, j_txs, t_txs, tail_only=False,
             filter_name="DEFAULT_SEQ_FILTER", use_device=True, info=(None, None), **buckets):
    """mutate_transcripts through both packages; tail_only picks the indel
    payload mode (the JAX package picks it from its link-rate probe)."""
    monkeypatch.setitem(j_lsm._JIT_HELPERS, "link_rate", 1.0 if tail_only else 1000.0)
    monkeypatch.setattr(t_lsm, "INDEL_TAIL_ONLY", tail_only)
    j = j_lsm.MutateGenes(j_contig, JFilter[filter_name], info_store=info[0],
                          use_device=use_device, **buckets)
    t = t_lsm.MutateGenes(t_contig, TFilter[filter_name], info_store=info[1],
                          use_device=use_device, device="cpu", **buckets)
    timings = {}
    t_results = t.mutate_transcripts(t_pop, t_txs, timings=timings)
    assert_same_results(j.mutate_transcripts(j_pop, j_txs), t_results)
    return t_results, timings


# --------------------------------------------------------------------------- #
# synthetic files (test_synthetic_e2e.py's shape)
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=[True, False], ids=["snp_only", "indels"])
def synthetic(request, tmp_path_factory):
    paths = generate_population_files(str(tmp_path_factory.mktemp("syn")),
                                      snp_only=request.param, **SYNTH)
    out = {}
    for side, genome_cls, parse in (("j", JGenome, j_parse), ("t", TGenome, t_parse)):
        genome = genome_cls.create_genome_database("syn", paths.fasta, paths.gff3)
        pop, _header, info = parse(paths.vcf, "pop", "PF_DIPLOID")
        contig = genome.get_contig(paths.contig_id)
        txs = [contig.get_transcription(paths.gene_id(g), paths.transcript_id(g))
               for g in range(paths.n_genes)]
        out[side] = (contig, pop, txs, info)
    return request.param, out


@pytest.mark.parametrize("tail_only", [False, True], ids=["packed", "tails"])
@pytest.mark.parametrize("buckets", [{}, {"k_bucket": 16, "b_bucket": 16}], ids=["free", "pinned"])
def test_synthetic_records_match_jax(synthetic, buckets, tail_only, monkeypatch):
    snp_only, s = synthetic
    (jc, jpop, jtxs, jinfo), (tc, tpop, ttxs, tinfo) = s["j"], s["t"]
    results, timings = run_both(monkeypatch, jc, tc, jpop, tpop, jtxs, ttxs,
                                tail_only=tail_only, info=(jinfo, tinfo), **buckets)
    assert timings["n_device_fetches"] == 1  # both transcripts, one fetch
    assert set(timings["launches"]) == ({"snp"} if snp_only else {"snp", "indel"})
    assert all(n == 0 for counts in timings["launches"].values() for n in counts.values())
    assert sum(len(recs) for recs, _stats in results) == 2 * SYNTH["n_samples"]


@pytest.mark.parametrize("filter_name", ["HIGHEST_FREQ_VARIANT", "FRAMESHIFT_ADJUSTED",
                                         "SNP_ADJUSTED"])
def test_synthetic_other_filters_match_jax(synthetic, filter_name, monkeypatch):
    _snp_only, s = synthetic
    (jc, jpop, jtxs, jinfo), (tc, tpop, ttxs, tinfo) = s["j"], s["t"]
    run_both(monkeypatch, jc, tc, jpop, tpop, jtxs, ttxs, filter_name=filter_name,
             info=(jinfo, tinfo))


def test_synthetic_host_route_matches_jax(synthetic, monkeypatch):
    _snp_only, s = synthetic
    (jc, jpop, jtxs, jinfo), (tc, tpop, ttxs, tinfo) = s["j"], s["t"]
    _results, timings = run_both(monkeypatch, jc, tc, jpop, tpop, jtxs, ttxs,
                                 use_device=False, info=(jinfo, tinfo))
    assert timings["n_device_fetches"] == 0


def test_synthetic_device_route_matches_host_route(synthetic):
    """Within the port: the device route's records equal the host-exact
    engine's (distance aside, which only the device route fills)."""
    _snp_only, s = synthetic
    tc, tpop, ttxs, tinfo = s["t"]
    dev = t_lsm.MutateGenes(tc, info_store=tinfo, k_bucket=16, b_bucket=16, device="cpu")
    host = t_lsm.MutateGenes(tc, info_store=tinfo, use_device=False)
    for (d_recs, d_stats), (h_recs, h_stats) in zip(dev.mutate_transcripts(tpop, ttxs),
                                                    host.mutate_transcripts(tpop, ttxs)):
        for a, b in zip(d_recs, h_recs):
            assert (a.genome_id, a.modified_coding, a.validity, a.variant_count) == (
                b.genome_id, b.modified_coding, b.validity, b.variant_count)
        assert d_stats == h_stats


def test_synthetic_pass_records_a_span_at_each_clocked_stage(synthetic):
    """Under a profiler the pass records kgt.mutate.capture, .dispatch,
    .fetch and .unpack, once each and in that order, beside its timings."""
    from torch.profiler import ProfilerActivity, profile

    _snp_only, s = synthetic
    tc, tpop, ttxs, tinfo = s["t"]
    timings = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t_lsm.MutateGenes(tc, info_store=tinfo, device="cpu").mutate_transcripts(
            tpop, ttxs, timings=timings)
    stages = sorted((ev.start_ns(), ev.name()) for ev in prof.profiler.kineto_results.events()
                    if ev.is_user_annotation() and ev.name().startswith("kgt.mutate."))
    assert [name for _t, name in stages] == [f"kgt.mutate.{s}" for s in
                                             ("capture", "dispatch", "fetch", "unpack")]
    assert timings["n_device_fetches"] == 1 and timings["fetch_s"] > 0


# --------------------------------------------------------------------------- #
# fixture genes with SNP / insertion / deletion populations
# --------------------------------------------------------------------------- #
def _population(pkg, contig_id, seed, n_genomes, window):
    """The same random SNP/1M3D/1M3I population in either package (pkg is
    'kgl_gene_tpu' or 'kgl_gene_tpu_torch'), over `window` of the contig."""
    import importlib

    seq_mod = importlib.import_module(f"{pkg}.sequence.sequence")
    db_mod = importlib.import_module(f"{pkg}.variant.db")
    var_mod = importlib.import_module(f"{pkg}.variant.variant")
    linear = seq_mod.DNA5SequenceLinear.from_string
    contig_seq = build_contig1() if contig_id == CONTIG_1 else build_contig2()
    rng = np.random.default_rng(seed)
    pop = db_mod.PopulationDB("synth", "PF_DIPLOID")
    lo, hi = window
    for g in range(n_genomes):
        gid = f"G{g:03d}"
        pop.get_create_genome(gid)
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(lo, hi))
            ref = contig_seq[p]
            roll = rng.random()
            if roll < 0.2 and p + 4 < hi:
                v_ref, v_alt = contig_seq[p : p + 4], ref  # 1M3D
            elif roll < 0.4:
                v_ref, v_alt = ref, ref + "".join(rng.choice(list("ACGT"), 3))  # 1M3I
            else:
                v_ref, v_alt = ref, str(rng.choice([b for b in "ACGT" if b != ref]))
            v = var_mod.Variant(
                contig_id=contig_id, offset=p, phase=var_mod.VariantPhase.UNPHASED,
                identifier="", ref=linear(v_ref), alt=linear(v_alt),
                format_data=var_mod.FormatData(),
            )
            pop.add_variant(v, [gid])
            if rng.random() < 0.3:
                pop.add_variant(v, [gid])
    return pop


@pytest.fixture(scope="module")
def fixture_genomes(tmp_path_factory):
    files = make_genome_files(tmp_path_factory.mktemp("g"))
    return (JGenome.create_genome_database("ref", files["fasta"], files["gff"]),
            TGenome.create_genome_database("ref", files["fasta"], files["gff"]))


GENES = {"GENE1": (CONTIG_1, "GENE1.1", (30, 140)), "GENE2": (CONTIG_2, "GENE2.1", (110, 185))}


@pytest.mark.parametrize("tail_only", [False, True], ids=["packed", "tails"])
@pytest.mark.parametrize("seed", [0, 5, 9])
@pytest.mark.parametrize("gene", ["GENE1", "GENE2"])
def test_fixture_gene_indels_match_jax(fixture_genomes, gene, seed, tail_only, monkeypatch):
    contig_id, tx_id, window = GENES[gene]
    jg, tg = fixture_genomes
    jc, tc = jg.get_contig(contig_id), tg.get_contig(contig_id)
    jtx, ttx = jc.get_transcription(gene, tx_id), tc.get_transcription(gene, tx_id)
    jpop = _population("kgl_gene_tpu", contig_id, seed, 24, window)
    tpop = _population("kgl_gene_tpu_torch", contig_id, seed, 24, window)
    _results, timings = run_both(monkeypatch, jc, tc, jpop, tpop, [jtx], [ttx],
                                 tail_only=tail_only)
    assert "indel" in timings["launches"], "the indel device route must engage"


@pytest.mark.parametrize("filter_name", ["DEFAULT_SEQ_FILTER", "HIGHEST_FREQ_VARIANT"])
def test_fixture_both_genes_one_pass(fixture_genomes, filter_name, monkeypatch):
    """GENE1 and GENE2 lie on two contigs: one MutateGenes each, every
    step of a contig in one pooled program, pinned buckets that the
    populations outgrow (capture grows them)."""
    jg, tg = fixture_genomes
    for gene, (contig_id, tx_id, window) in GENES.items():
        jc, tc = jg.get_contig(contig_id), tg.get_contig(contig_id)
        jpop = _population("kgl_gene_tpu", contig_id, 21, 40, window)
        tpop = _population("kgl_gene_tpu_torch", contig_id, 21, 40, window)
        run_both(monkeypatch, jc, tc, jpop, tpop, [jc.get_transcription(gene, tx_id)],
                 [tc.get_transcription(gene, tx_id)], filter_name=filter_name,
                 k_bucket=2, b_bucket=8)


def test_pooled_constants_cached_on_the_contig(synthetic):
    """A fresh MutateGenes each pass reuses the device constants the first
    one put on the contig."""
    _snp_only, s = synthetic
    tc, tpop, ttxs, tinfo = s["t"]
    t_lsm.MutateGenes(tc, info_store=tinfo, device="cpu").mutate_transcripts(tpop, ttxs)
    cache = dict(tc.__dict__["_pooled_step_cache"])
    t_lsm.MutateGenes(tc, info_store=tinfo, device="cpu").mutate_transcripts(tpop, ttxs)
    assert tc.__dict__["_pooled_step_cache"] == cache and cache
