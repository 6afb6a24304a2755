"""The port's loaders and capture (kgl_gene_tpu_torch/io, genome, variant,
mutation/capture.py) against the JAX package's on the same files: the
genome (contigs, genes, transcripts), the parsed PopulationDB (arena
columns, genome ids, incidence columns, INFO values) and the capture
tensors of every transcript. Zero tolerance: everything compared is an
integer, a code or a string.

The JAX package parses a VCF by its native record loop when its native
library is present and by the streaming Python loop otherwise; the port
parses by its own native record loop by default and by the streaming loop
when asked, and each is held against both of the JAX package's."""

import gzip
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, "tests")
from fixtures import CONTIG_1, CONTIG_2, make_genome_files, write_vcf  # noqa: E402

from kgl_gene_tpu.genome.genome import GenomeReference as JGenome  # noqa: E402
from kgl_gene_tpu.io.synthetic import generate_population_files as j_generate  # noqa: E402
from kgl_gene_tpu.io.vcf import parse_vcf_population as j_parse  # noqa: E402
from kgl_gene_tpu.mutation.capture import capture_population_split as j_split  # noqa: E402
from kgl_gene_tpu_torch.genome.genome import GenomeReference as TGenome  # noqa: E402
from kgl_gene_tpu_torch.io.synthetic import generate_population_files as t_generate  # noqa: E402
from kgl_gene_tpu_torch.io.vcf import parse_vcf_population as t_parse  # noqa: E402
from kgl_gene_tpu_torch.mutation.capture import capture_population_split as t_split  # noqa: E402

SYNTH = dict(n_samples=12, contig_len=24_000, n_genes=2, n_records=600, coding_len=300,
             seed=3)


def _transcripts(genome):
    for contig_id, contig in genome:
        for gene in contig.all_genes():
            for tx in contig.gene_transcripts(gene.feature_id).transcripts():
                yield contig_id, contig, tx


def assert_same_genome(j, t):
    assert t.contig_ids() == j.contig_ids()
    for contig_id in j.contig_ids():
        jc, tc = j.get_contig(contig_id), t.get_contig(contig_id)
        np.testing.assert_array_equal(tc.sequence.codes, jc.sequence.codes)
        assert tc.coding_table.name == jc.coding_table.name
        assert sorted(tc.genes) == sorted(jc.genes)
    j_tx = [(c, tx.transcript_id, tx.strand.name, tx.coding_type.name,
             tx.exon_arrays().tolist()) for c, _x, tx in _transcripts(j)]
    t_tx = [(c, tx.transcript_id, tx.strand.name, tx.coding_type.name,
             tx.exon_arrays().tolist()) for c, _x, tx in _transcripts(t)]
    assert t_tx == j_tx and t_tx
    for (_c, jcon, jtx), (_d, tcon, ttx) in zip(_transcripts(j), _transcripts(t)):
        assert tcon.coding_sequence(ttx).to_string() == jcon.coding_sequence(jtx).to_string()
        assert tcon.check_valid_transcript(ttx).value == jcon.check_valid_transcript(jtx).value


def assert_same_population(j, t):
    assert t.population_id == j.population_id
    assert t.genome_count() == j.genome_count()
    assert [g for g, _ in t] == [g for g, _ in j]
    ja, ta = j.arena, t.arena
    assert len(ta) == len(ja) > 0
    assert ta.contig_names == ja.contig_names
    for col in ("offsets", "contigs", "ref_lens", "alt_lens", "alt_first", "ref_first"):
        np.testing.assert_array_equal(getattr(ta, col), getattr(ja, col), err_msg=col)
    np.testing.assert_array_equal(ta.is_snp_column(), ja.is_snp_column())
    for row in range(len(ja)):
        np.testing.assert_array_equal(ta.ref_codes(row), ja.ref_codes(row))
        np.testing.assert_array_equal(ta.alt_codes(row), ja.alt_codes(row))
        assert ta.identifier(row) == ja.identifier(row)
        assert ta.info_row(row) == ja.info_row(row)
    for genome_id, jg in j:
        tg = t.get_genome(genome_id)
        assert [c for c, _ in tg] == [c for c, _ in jg]
        for contig_id, jcdb in jg:
            jcols = jcdb.columns()
            tcols = tg.get_contig(contig_id).columns()
            assert sorted(tcols) == sorted(jcols)
            for name in jcols:
                np.testing.assert_array_equal(tcols[name], jcols[name],
                                              err_msg=f"{genome_id} {contig_id} {name}")


def assert_same_capture(jb, tb):
    """A BatchCapture or IndelBatchCapture, field by field."""
    assert (tb is None) == (jb is None)
    if jb is None:
        return
    assert type(tb).__name__ == type(jb).__name__
    for name, jv in vars(jb).items():
        tv = getattr(tb, name)
        if isinstance(jv, np.ndarray):
            assert tv.dtype == jv.dtype, name
            np.testing.assert_array_equal(tv, jv, err_msg=name)
        else:
            assert tv == jv, name


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    base = tmp_path_factory.mktemp("fx")
    files = make_genome_files(base)
    files["vcf"] = write_vcf(str(base / "pop.vcf"))
    gz = str(base / "pop.vcf.gz")
    with open(files["vcf"], "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    files["vcf_gz"] = gz
    return files


@pytest.fixture(scope="module", params=[True, False], ids=["snp_only", "indels"])
def synthetic_files(request, tmp_path_factory):
    j_dir = tmp_path_factory.mktemp("jsyn")
    t_dir = tmp_path_factory.mktemp("tsyn")
    jp = j_generate(str(j_dir), snp_only=request.param, **SYNTH)
    tp = t_generate(str(t_dir), snp_only=request.param, **SYNTH)
    return jp, tp


def test_generator_writes_the_same_files(synthetic_files):
    jp, tp = synthetic_files
    for name in ("fasta", "gff3", "vcf"):
        with open(getattr(jp, name), "rb") as a, open(getattr(tp, name), "rb") as b:
            assert a.read() == b.read(), name
    assert (tp.contig_id, tp.n_samples, tp.n_genes) == (jp.contig_id, jp.n_samples, jp.n_genes)
    assert [tp.gene_id(g) for g in range(tp.n_genes)] == [jp.gene_id(g) for g in range(jp.n_genes)]


def test_fixture_genome_equal(fixture_files):
    j = JGenome.create_genome_database("ref", fixture_files["fasta"], fixture_files["gff"])
    t = TGenome.create_genome_database("ref", fixture_files["fasta"], fixture_files["gff"])
    assert_same_genome(j, t)
    assert {c for c, _x, _t in _transcripts(t)} == {CONTIG_1, CONTIG_2}


def test_gaf_path_raises(fixture_files):
    """A GAF path fills gene_ontology as the JAX package does."""
    j = JGenome.create_genome_database("ref", fixture_files["fasta"], fixture_files["gff"],
                                       gaf_file=fixture_files["gaf"])
    t = TGenome.create_genome_database("ref", fixture_files["fasta"], fixture_files["gff"],
                                       gaf_file=fixture_files["gaf"])
    assert t.gene_ontology == j.gene_ontology
    assert t.gene_ontology == {"GENE1": ["GO:0000001", "GO:0000002"], "GENE2": ["GO:0000001"]}


@pytest.mark.parametrize("which", ["vcf", "vcf_gz"])
@pytest.mark.parametrize("j_native", [None, False], ids=["jax_default", "jax_streaming"])
@pytest.mark.parametrize("t_native", [True, False], ids=["port_native", "port_streaming"])
def test_fixture_population_equal(fixture_files, which, j_native, t_native):
    jpop, jhead, jinfo = j_parse(fixture_files[which], "pop", "PF_DIPLOID", use_native=j_native)
    tpop, thead, tinfo = t_parse(fixture_files[which], "pop", "PF_DIPLOID", use_native=t_native)
    assert_same_population(jpop, tpop)
    assert thead.genome_names == jhead.genome_names
    assert sorted(thead.info_fields) == sorted(jhead.info_fields)
    assert tinfo.count == jinfo.count
    for fid in sorted(jinfo.subscribed):
        for row in range(jinfo.count):
            jv, tv = jinfo.value(fid, row), tinfo.value(fid, row)
            if isinstance(jv, float) and np.isnan(jv):
                assert np.isnan(tv), (fid, row)
            else:
                assert tv == jv, (fid, row)


@pytest.mark.parametrize("parser, kwargs, error", [
    ("GNOMAD_DIPLOID", {"use_native": True}, ValueError),  # no native mode
    # A checkpoint in a directory that does not exist: the first snapshot
    # raises, as the JAX package's does.
    ("PF_DIPLOID", {"checkpoint_path": "no_such_dir/ck", "checkpoint_every": 1},
     FileNotFoundError),
], ids=["kwargs0", "kwargs1"])
def test_native_and_checkpoint_requests_raise(fixture_files, parser, kwargs, error):
    if "checkpoint_path" in kwargs:
        base = os.path.dirname(fixture_files["vcf"])
        kwargs = dict(kwargs, checkpoint_path=os.path.join(base, kwargs["checkpoint_path"]))
        with pytest.raises(error):
            j_parse(fixture_files["vcf"], "pop", parser, **kwargs)
    with pytest.raises(error):
        t_parse(fixture_files["vcf"], "pop", parser, **kwargs)


def test_fixture_capture_equal(fixture_files):
    jg = JGenome.create_genome_database("ref", fixture_files["fasta"], fixture_files["gff"])
    tg = TGenome.create_genome_database("ref", fixture_files["fasta"], fixture_files["gff"])
    jpop, _h, _i = j_parse(fixture_files["vcf"], "pop", "PF_DIPLOID")
    tpop, _h, _i = t_parse(fixture_files["vcf"], "pop", "PF_DIPLOID")
    n = 0
    for (cid, _jc, jtx), (_d, _tc, ttx) in zip(_transcripts(jg), _transcripts(tg)):
        j_snp, j_indel = j_split(jpop, cid, jtx.interval, region_start=jtx.start)
        t_snp, t_indel = t_split(tpop, cid, ttx.interval, region_start=ttx.start)
        assert_same_capture(j_snp, t_snp)
        assert_same_capture(j_indel, t_indel)
        n += j_indel is not None
    assert n, "the fixture VCF's indels must reach the indel capture"


@pytest.mark.parametrize("j_native", [None, False], ids=["jax_default", "jax_streaming"])
@pytest.mark.parametrize("t_native", [True, False], ids=["port_native", "port_streaming"])
def test_synthetic_genome_and_population_equal(synthetic_files, j_native, t_native):
    jp, tp = synthetic_files
    assert_same_genome(JGenome.create_genome_database("syn", jp.fasta, jp.gff3),
                       TGenome.create_genome_database("syn", tp.fasta, tp.gff3))
    jpop, _h, _i = j_parse(jp.vcf, "pop", "PF_DIPLOID", use_native=j_native)
    tpop, _h, _i = t_parse(tp.vcf, "pop", "PF_DIPLOID", use_native=t_native)
    assert_same_population(jpop, tpop)


@pytest.mark.parametrize("buckets", [{}, {"k_bucket": 16, "b_bucket": 16}])
def test_synthetic_capture_equal(synthetic_files, buckets):
    jp, tp = synthetic_files
    jg = JGenome.create_genome_database("syn", jp.fasta, jp.gff3)
    tg = TGenome.create_genome_database("syn", tp.fasta, tp.gff3)
    jpop, _h, _i = j_parse(jp.vcf, "pop", "PF_DIPLOID")
    tpop, _h, _i = t_parse(tp.vcf, "pop", "PF_DIPLOID")
    for g in range(jp.n_genes):
        jtx = jg.get_contig(jp.contig_id).get_transcription(jp.gene_id(g), jp.transcript_id(g))
        ttx = tg.get_contig(tp.contig_id).get_transcription(tp.gene_id(g), tp.transcript_id(g))
        j_snp, j_indel = j_split(jpop, jp.contig_id, jtx.interval, region_start=jtx.start,
                                 **buckets)
        t_snp, t_indel = t_split(tpop, tp.contig_id, ttx.interval, region_start=ttx.start,
                                 **buckets)
        assert_same_capture(j_snp, t_snp)
        assert_same_capture(j_indel, t_indel)


@pytest.mark.parametrize("motif", ["TATAWAW", "ATG", "GGN", "RYK"])
def test_motif_search_equal(fixture_files, motif):
    """The copied motif search (sequence/motif.py over utils/search.py) on
    every fixture contig, the promoter window before each gene included."""
    from kgl_gene_tpu.sequence.motif import find_motifs as j_find
    from kgl_gene_tpu.sequence.motif import find_promoter_motifs as j_promoter
    from kgl_gene_tpu_torch.sequence.motif import find_motifs as t_find
    from kgl_gene_tpu_torch.sequence.motif import find_promoter_motifs as t_promoter

    def spans(intervals):
        return [(iv.lower, iv.upper) for iv in intervals]

    j = JGenome.create_genome_database("ref", fixture_files["fasta"], fixture_files["gff"])
    t = TGenome.create_genome_database("ref", fixture_files["fasta"], fixture_files["gff"])
    for contig_id in j.contig_ids():
        jc, tc = j.get_contig(contig_id), t.get_contig(contig_id)
        assert spans(t_find(tc.sequence, motif)) == spans(j_find(jc.sequence, motif))
        for gene in jc.all_genes():
            start = gene.interval.lower
            assert spans(t_promoter(tc.sequence, start, 100, motif)) == \
                spans(j_promoter(jc.sequence, start, 100, motif))
