"""The port's GO ontology stack and GAF annotation against the JAX
package's: parsers (OBO, OBO-XML on ElementTree, OboGraphs JSON), the CSR
DAG and its closures, annotation, information content (blocked), term and
set similarity, shared information, the cache, enrichment, distributions,
the ontology database and the genome's GAF loading. Same files and records
into both; every value equal unless a tolerance is stated."""

import dataclasses
import os
import sys

import numpy as np
import pytest

from kgl_gene_tpu.genome.genome import GenomeReference as JGenome
from kgl_gene_tpu.io import gaf as jgaf
from kgl_gene_tpu.ontology import annotation as jann
from kgl_gene_tpu.ontology import cache as jcache
from kgl_gene_tpu.ontology import database as jdb
from kgl_gene_tpu.ontology import enrichment as jenr
from kgl_gene_tpu.ontology import go_xml as jxml
from kgl_gene_tpu.ontology import graph as jgraph
from kgl_gene_tpu.ontology import information as jinfo
from kgl_gene_tpu.ontology import obo as jobo
from kgl_gene_tpu.ontology import obographs as jjson
from kgl_gene_tpu.ontology import set_similarity as jset
from kgl_gene_tpu.ontology import shared_information as jshared
from kgl_gene_tpu.ontology import similarity as jsim
from kgl_gene_tpu.utils import distributions as jdist
from kgl_gene_tpu_torch.genome.genome import GenomeReference as TGenome
from kgl_gene_tpu_torch.io import gaf as tgaf
from kgl_gene_tpu_torch.ontology import annotation as tann
from kgl_gene_tpu_torch.ontology import cache as tcache
from kgl_gene_tpu_torch.ontology import database as tdb
from kgl_gene_tpu_torch.ontology import enrichment as tenr
from kgl_gene_tpu_torch.ontology import go_xml as txml
from kgl_gene_tpu_torch.ontology import graph as tgraph
from kgl_gene_tpu_torch.ontology import information as tinfo
from kgl_gene_tpu_torch.ontology import obo as tobo
from kgl_gene_tpu_torch.ontology import obographs as tjson
from kgl_gene_tpu_torch.ontology import set_similarity as tset
from kgl_gene_tpu_torch.ontology import shared_information as tshared
from kgl_gene_tpu_torch.ontology import similarity as tsim
from kgl_gene_tpu_torch.utils import distributions as tdist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the GO-shaped generator of phase 3f)
from fixtures import make_genome_files  # noqa: E402
from test_frozen_ontology import OBO as FROZEN_OBO  # noqa: E402
from test_frozen_ontology import (  # noqa: E402
    A, B, BMA_LIN, C, D, E, JC_CE, LIN_CD, LIN_CE, LIN_DB, PS_CD, R, REL_CE, RESNIK_CD, SIMDIC,
    SIMGIC,
)
from test_ontology import OBO_TEXT, _gaf, _write_obo_xml, _write_obographs  # noqa: E402

MEASURES = ("SimilarityResnik", "SimilarityLin", "SimilarityJiangConrath", "SimilarityRelevance")
SHARED = ("InformationAncestorMean", "InformationCoutoGraSM", "InformationCoutoGraSMAdjusted",
          "InformationFrontier", "InformationExclusiveInherited")
MINI_TERMS = ["GO:0000002", "GO:0000003", "GO:0000004", "GO:0000005", "GO:0000006"]


def _key(records):
    return [(r.term_id, r.name, r.namespace, r.definition, tuple(r.alt_ids),
             tuple(r.relations), r.obsolete) for r in records]


def _port_records(records):
    return [tgaf.GafRecord(**dataclasses.asdict(r)) for r in records]


def _mini_gaf():
    return [_gaf("geneA", "GO:0000004"), _gaf("geneB", "GO:0000005"),
            _gaf("geneC", "GO:0000006"), _gaf("geneD", "GO:0000002"),
            _gaf("geneE", "GO:0000003")]


def _frozen_gaf():
    return [jgaf.GafRecord(db="X", gene_id=g, gene_symbol=g, qualifier="", go_term=t,
                           evidence_code="EXP", aspect="P", taxon="taxon:1")
            for g, t in [("g4", A), ("g5", B), ("g6", B), ("g1", C), ("g2", D), ("g3", E)]]


def _stacks(path, gaf_records):
    """(JAX, port) tuples of (graph, annotation, information) from one OBO
    file and one list of the JAX package's GAF records."""
    jg = jgraph.GoGraph(jobo.parse_go_obo(str(path)))
    tg = tgraph.GoGraph(tobo.parse_go_obo(str(path)))
    ja = jann.TermAnnotation(gaf_records, graph=jg)
    ta = tann.TermAnnotation(_port_records(gaf_records), graph=tg)
    return (jg, ja, jinfo.InformationContent(jg, ja)), (tg, ta, tinfo.InformationContent(tg, ta))


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    path = tmp_path_factory.mktemp("obo") / "mini.obo"
    path.write_text(OBO_TEXT)
    return (path,) + _stacks(path, _mini_gaf())


@pytest.fixture(scope="module")
def frozen(tmp_path_factory):
    path = tmp_path_factory.mktemp("obo") / "frozen.obo"
    path.write_text(FROZEN_OBO)
    return (path,) + _stacks(path, _frozen_gaf())


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """A seeded ~2,000-term DAG of GO's shape (chip_smoke's generator at
    1/20 of its sizes) with ~900 annotations, JAX and port stacks, the
    port's blocked IC built with tiny blocks."""
    base = tmp_path_factory.mktemp("go")
    sizes = chip_smoke.GO_NAMESPACES, chip_smoke.GO_GENES
    chip_smoke.GO_NAMESPACES = tuple((ns, root, size // 20, aspect)
                                     for ns, root, size, aspect in sizes[0])
    chip_smoke.GO_GENES = 150
    try:
        terms = chip_smoke.write_go_obo(str(base / "go.obo"))
        chip_smoke.write_go_gaf(str(base / "go.gaf"), terms)
    finally:
        chip_smoke.GO_NAMESPACES, chip_smoke.GO_GENES = sizes
    records = jgaf.read_gaf_records(str(base / "go.gaf"))
    block = tinfo.BLOCK_BYTES
    tinfo.BLOCK_BYTES = 8192
    try:
        stacks = _stacks(base / "go.obo", records)
    finally:
        tinfo.BLOCK_BYTES = block
    return (base,) + stacks


# --------------------------------------------------------------------- parsers
class TestParsers:
    def test_obo_records(self, mini, frozen):
        for path, *_ in (mini, frozen):
            assert _key(tobo.parse_go_obo(str(path))) == _key(jobo.parse_go_obo(str(path)))

    @pytest.mark.parametrize("namespaced", [False, True])
    def test_obo_xml_on_elementtree(self, tmp_path, namespaced):
        path = _write_obo_xml(tmp_path / "go.xml", namespaced=namespaced)
        want = jxml.parse_go_xml(path)
        assert len(want) == 7
        assert _key(txml.parse_go_xml(path)) == _key(want)

    def test_obo_xml_variants(self, tmp_path):
        """def/defstr, the godatabase definition and part_of shorthand, an
        accession in place of id, rdf:resource targets, a comment."""
        path = tmp_path / "variants.obo-xml"
        path.write_text(
            "<?xml version='1.0'?>\n"
            '<go:go xmlns:go="http://www.geneontology.org/dtds/go.dtd#" '
            'xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#">\n'
            "<!-- a comment -->\n"
            "<go:term><go:accession>GO:0008150</go:accession><go:name>bp</go:name>"
            "<go:definition>root def</go:definition></go:term>\n"
            "<go:term><go:id>GO:0000002</go:id><go:namespace>biological_process</go:namespace>"
            "<go:def><go:defstr>nested def</go:defstr></go:def>"
            '<go:is_a rdf:resource="http://purl.obolibrary.org/obo/GO_0008150"/>'
            '<go:part_of rdf:resource="http://x/obo#GO:0008150"/>'
            "<go:is_obsolete>true</go:is_obsolete></go:term>\n"
            "<go:term><go:id>GO:0000003</go:id><go:def>inline def</go:def>"
            "<go:alt_id>GO:0000033</go:alt_id>"
            "<go:relationship><go:type>regulates</go:type><go:to>GO:0000002</go:to>"
            "</go:relationship></go:term>\n"
            "<go:term><go:name>no id</go:name></go:term>\n"
            "</go:go>\n")
        want = jxml.parse_go_xml(str(path))
        assert len(want) == 3
        assert _key(txml.parse_go_xml(str(path))) == _key(want)

    def test_obo_xml_malformed(self, tmp_path):
        path = tmp_path / "bad.xml"
        path.write_text("<obo><term><id>GO:1</id></obo>")
        assert jxml.parse_go_xml(str(path)) == [] == txml.parse_go_xml(str(path))
        assert txml.parse_go_xml(str(tmp_path / "missing.xml")) == []

    def test_obographs(self, tmp_path):
        path = _write_obographs(tmp_path / "go.json")
        assert _key(tjson.parse_go_obographs(path)) == _key(jjson.parse_go_obographs(path))
        bad = tmp_path / "bad.json"
        bad.write_text("{")
        assert tjson.parse_go_obographs(str(bad)) == [] == jjson.parse_go_obographs(str(bad))

    def test_parse_go_file_dispatch(self, tmp_path):
        obo = tmp_path / "mini.obo"
        obo.write_text(OBO_TEXT)
        for path in (str(obo), _write_obo_xml(tmp_path / "mini.xml"),
                     _write_obographs(tmp_path / "mini.json")):
            assert _key(tobo.parse_go_file(path)) == _key(jobo.parse_go_file(path))


class TestGaf:
    def test_records_and_gene_map(self, tmp_path):
        path = make_genome_files(tmp_path)["gaf"]
        with open(path, "a") as f:
            f.write("TESTDB\tSHORT\tline\n")
        want = jgaf.read_gaf_records(path)
        got = tgaf.read_gaf_records(path)
        assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
        assert tgaf.read_gaf(path) == jgaf.read_gaf(path) == {
            "GENE1": ["GO:0000001", "GO:0000002"], "GENE2": ["GO:0000001"]}

    def test_create_genome_database_reads_gaf(self, tmp_path):
        files = make_genome_files(tmp_path)
        want = JGenome.create_genome_database("Pf", files["fasta"], files["gff"],
                                              gaf_file=files["gaf"])
        got = TGenome.create_genome_database("Pf", files["fasta"], files["gff"],
                                             gaf_file=files["gaf"])
        assert got.gene_ontology == want.gene_ontology
        assert got.gene_ontology  # the GAF path no longer raises and fills it
        assert set(got.contigs) == set(want.contigs)


# ---------------------------------------------------------- graph, annotation
def _graph_state(g):
    return (g.term_ids, g.index, g.names, g.namespaces, g.namespace_code.tolist(),
            g._parent_offsets.tolist(), g._parent_targets.tolist(),
            g._child_offsets.tolist(), g._child_targets.tolist(), g._topo.tolist(),
            g.roots(), g.depth_map().tolist())


@pytest.mark.parametrize("which", ["mini", "frozen", "synthetic"])
def test_graph_equals_reference(which, request):
    _path, (jg, _ja, _ji), (tg, _ta, _ti) = request.getfixturevalue(which)
    assert _graph_state(tg) == _graph_state(jg)
    np.testing.assert_array_equal(tg.ancestor_bitsets(), jg.ancestor_bitsets())
    np.testing.assert_array_equal(tg.descendant_bitsets(), jg.descendant_bitsets())
    for ns in ("biological_process", "molecular_function", "cellular_component", "x"):
        assert tg.root_index(ns) == jg.root_index(ns)
    sample = jg.term_ids[:: max(1, len(jg) // 40)] + ["GO:9999999"]
    for t in sample:
        assert tg.get_self_ancestor_terms(t) == jg.get_self_ancestor_terms(t)
        assert tg.get_descendant_terms(t) == jg.get_descendant_terms(t)
        assert tg.term_ontology(t) == jg.term_ontology(t)
    assert tg.get_extended_term_set(sample) == jg.get_extended_term_set(sample)


def test_graph_drops_unknown_edges_and_orders_a_cycle(tmp_path):
    path = tmp_path / "cycle.obo"
    path.write_text("[Term]\nid: GO:1\nnamespace: biological_process\nis_a: GO:2\n\n"
                    "[Term]\nid: GO:2\nnamespace: biological_process\nis_a: GO:1\n"
                    "is_a: GO:404\n\n[Typedef]\nid: part_of\n")
    jg = jgraph.GoGraph(jobo.parse_go_obo(str(path)))
    tg = tgraph.GoGraph(tobo.parse_go_obo(str(path)))
    assert _graph_state(tg) == _graph_state(jg)


@pytest.mark.parametrize("which", ["mini", "frozen", "synthetic"])
def test_annotation_equals_reference(which, request):
    _path, (jg, ja, _ji), (tg, ta, _ti) = request.getfixturevalue(which)
    assert ta.gene_terms == ja.gene_terms
    assert ta.term_genes == ja.term_genes
    assert ta.term_namespace == ja.term_namespace
    assert ta.all_genes() == ja.all_genes()
    for ns in (None, "biological_process", "molecular_function", "cellular_component"):
        assert ta.all_terms(ns) == ja.all_terms(ns)
    np.testing.assert_array_equal(ta.annotation_count_vector(tg), ja.annotation_count_vector(jg))
    for gene in ja.all_genes()[:20]:
        assert ta.go_terms_for_gene_by_namespace(gene, "biological_process") == \
            ja.go_terms_for_gene_by_namespace(gene, "biological_process")


def test_annotation_evidence_not_and_file(tmp_path, mini):
    path, (jg, _ja, _ji), (tg, _ta, _ti) = mini
    gaf = tmp_path / "a.gaf"
    rows = [("T", "g1", "g1", "", "GO:0000004", "r", "EXP", "", "P"),
            ("T", "g1", "g1", "NOT|contributes_to", "GO:0000005", "r", "EXP", "", "P"),
            ("T", "g2", "g2", "", "GO:0000044", "r", "IEA", "", "P"),
            ("T", "g3", "g3", "", "GO:0001111", "r", "EXP", "", "P")]
    gaf.write_text("!gaf-version: 2.1\n" + "".join(
        "\t".join(r + ("", "", "protein", "taxon:1", "20240101", "T")) + "\n" for r in rows))
    for policy in (None, {"EXP"}):
        for with_graph in (False, True):
            want = jann.TermAnnotation.from_gaf_file(
                str(gaf), evidence_policy=policy, graph=jg if with_graph else None)
            got = tann.TermAnnotation.from_gaf_file(
                str(gaf), evidence_policy=policy, graph=tg if with_graph else None)
            assert (got.gene_terms, got.term_genes, got.term_namespace) == \
                (want.gene_terms, want.term_genes, want.term_namespace)


# ---------------------------------------------------------- information content
@pytest.mark.parametrize("which", ["mini", "frozen", "synthetic"])
def test_information_content_bit_for_bit(which, request):
    _path, (jg, _ja, ji), (tg, _ta, ti) = request.getfixturevalue(which)
    for name in ("cumulative_counts", "root_counts", "ic", "max_ic"):
        np.testing.assert_array_equal(getattr(ti, name), getattr(ji, name), err_msg=name)
    sample = jg.term_ids[:: max(1, len(jg) // 30)] + ["GO:9999999"]
    for a in sample:
        assert ti.term_information(a) == ji.term_information(a)
        assert ti.max_information_content(a) == ji.max_information_content(a)
        for b in sample[:8]:
            assert ti.validate_terms(a, b) == ji.validate_terms(a, b)
            assert ti.shared_information(a, b) == ji.shared_information(a, b)


@pytest.mark.parametrize("block_bytes", [64, 8192, tinfo.BLOCK_BYTES])
def test_mica_matrix_blocked_bit_for_bit(synthetic, monkeypatch, block_bytes):
    """The blocked host MICA equals the reference's dense one whatever the
    block sizes; the smallest ones run many blocks on both axes."""
    _base, (jg, ja, ji), (tg, _ta, ti) = synthetic
    monkeypatch.setattr(tinfo, "BLOCK_BYTES", block_bytes)
    terms = ja.all_terms()[:: max(1, len(ja.all_terms()) // 120)]
    idxs = [jg.term_index(t) for t in terms] + [0]
    np.testing.assert_array_equal(ti.mica_matrix(idxs), ji.mica_matrix(idxs))
    np.testing.assert_array_equal(ti.mica_matrix([]), ji.mica_matrix([]))


def test_information_content_stays_blocked(synthetic, monkeypatch):
    """No temporary of the blocked IC and MICA exceeds a few BLOCK_BYTES:
    np.unpackbits over more rows than a block would take raises here."""
    _base, (_jg, ja, _ji), (tg, ta, ti) = synthetic
    limit = 4096
    monkeypatch.setattr(tinfo, "BLOCK_BYTES", limit)
    real = np.unpackbits

    def bounded(a, *args, **kwargs):
        out = real(a, *args, **kwargs)
        assert out.nbytes <= 8 * limit + 8 * len(tg), out.shape
        return out

    monkeypatch.setattr(tinfo.np, "unpackbits", bounded)
    again = tinfo.InformationContent(tg, ta)
    np.testing.assert_array_equal(again.ic, ti.ic)
    idxs = [tg.term_index(t) for t in ja.all_terms()[:60]]
    again.mica_matrix(idxs)


# ----------------------------------------------------------- term similarity
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("which", ["mini", "frozen", "synthetic"])
def test_term_similarity_bit_for_bit(which, measure, request, monkeypatch):
    _path, (jg, ja, ji), (_tg, _ta, ti) = request.getfixturevalue(which)
    monkeypatch.setattr(tinfo, "BLOCK_BYTES", 8192)
    terms = ja.all_terms()
    terms = terms[:: max(1, len(terms) // 100)] + ["GO:9999999"]
    jm, tm = getattr(jsim, measure)(ji), getattr(tsim, measure)(ti)
    np.testing.assert_array_equal(tm.similarity_matrix(terms), jm.similarity_matrix(terms))
    for a in terms[:12]:
        for b in terms[:12]:
            assert tm.calculate_term_similarity(a, b) == jm.calculate_term_similarity(a, b)


@pytest.mark.parametrize("which", ["mini", "frozen", "synthetic"])
def test_pekar_staab(which, request):
    _path, (jg, ja, _ji), (tg, _ta, _ti) = request.getfixturevalue(which)
    jm, tm = jsim.SimilarityPekarStaab(jg), tsim.SimilarityPekarStaab(tg)
    terms = ja.all_terms()[:15] + ["GO:9999999"]
    for a in terms:
        for b in terms:
            assert tm.calculate_term_similarity(a, b) == jm.calculate_term_similarity(a, b)


def test_frozen_literals(frozen):
    """The port against the hand-derived literals of test_frozen_ontology."""
    _path, _j, (tg, _ta, ti) = frozen
    assert ti.shared_information(C, D) == pytest.approx(0.4054651081, abs=1e-9)
    assert tsim.SimilarityResnik(ti).calculate_term_similarity(C, D) == pytest.approx(RESNIK_CD,
                                                                                      abs=1e-9)
    lin = tsim.SimilarityLin(ti)
    assert lin.calculate_term_similarity(C, D) == pytest.approx(LIN_CD, abs=1e-9)
    assert lin.calculate_term_similarity(C, E) == pytest.approx(LIN_CE, abs=1e-9)
    assert lin.calculate_term_similarity(D, B) == pytest.approx(LIN_DB, abs=1e-9)
    m = lin.similarity_matrix([C, D, E, B])
    assert m[0, 1] == pytest.approx(LIN_CD, abs=1e-7) and m[1, 3] == pytest.approx(LIN_DB,
                                                                                    abs=1e-7)
    assert tsim.SimilarityJiangConrath(ti).calculate_term_similarity(C, E) == pytest.approx(
        JC_CE, abs=1e-9)
    assert tsim.SimilarityRelevance(ti).calculate_term_similarity(C, E) == pytest.approx(
        REL_CE, abs=1e-9)
    assert tsim.SimilarityPekarStaab(tg).calculate_term_similarity(C, D) == pytest.approx(
        PS_CD, abs=1e-9)
    assert tset.SetSimilarityPesquitaSimGIC(tg, ti).calculate_similarity({C, D}, {B, E}) == \
        pytest.approx(SIMGIC, abs=1e-9)
    assert tset.SetSimilarityMazanduSimDIC(tg, ti).calculate_similarity({C, D}, {B, E}) == \
        pytest.approx(SIMDIC, abs=1e-9)
    assert tset.SetSimilarityBestMatchAverage(lin).calculate_similarity({C, D}, {B, E}) == \
        pytest.approx(BMA_LIN, abs=1e-9)
    assert ti.term_information(R) == 0.0


# -------------------------------------------------------- shared information
@pytest.mark.parametrize("calculator", SHARED)
@pytest.mark.parametrize("which", ["mini", "frozen"])
def test_shared_information(which, calculator, request):
    _path, (jg, ja, ji), (tg, _ta, ti) = request.getfixturevalue(which)
    jc, tc = getattr(jshared, calculator)(jg, ji), getattr(tshared, calculator)(tg, ti)
    terms = jg.term_ids
    for a in terms:
        for b in terms:
            assert tc.common_disjoint_ancestors(a, b) == jc.common_disjoint_ancestors(a, b)
            assert tc.shared_information(a, b) == jc.shared_information(a, b)
    a, b = terms[-1], terms[-2]
    assert tsim.SimilarityLin(tc).calculate_term_similarity(a, b) == \
        jsim.SimilarityLin(jc).calculate_term_similarity(a, b)


# ------------------------------------------------------------ set similarity
@pytest.mark.parametrize("which", ["mini", "frozen", "synthetic"])
def test_set_similarity(which, request):
    _path, (jg, ja, ji), (tg, ta, ti) = request.getfixturevalue(which)
    genes = ja.all_genes()[:6]
    sets = [ja.gene_terms[g] for g in genes] + [set()]
    pairs = [(s, t) for s in sets for t in sets]
    jl, tl = jsim.SimilarityLin(ji), tsim.SimilarityLin(ti)
    measures = [(jset.SetSimilarityJaccard(), tset.SetSimilarityJaccard())]
    for name in ("SetSimilarityGentlemanSimUI", "SetSimilarityPesquitaSimGIC",
                 "SetSimilarityMazanduSimDIC", "SetSimilarityMazanduSimUIC"):
        measures.append((getattr(jset, name)(jg, ji), getattr(tset, name)(tg, ti)))
    for name in ("SetSimilarityAllPairsMax", "SetSimilarityAllPairsAverage",
                 "SetSimilarityBestMatchAverage", "SetSimilarityAverageBestMatch"):
        measures.append((getattr(jset, name)(jl), getattr(tset, name)(tl)))
    for jm, tm in measures:
        for s, t in pairs:
            assert tm.calculate_similarity(s, t) == jm.calculate_similarity(s, t), type(tm)


# ----------------------------------------------------------------- the cache
@pytest.mark.parametrize("which", ["mini", "synthetic"])
def test_cache(which, request, tmp_path):
    _path, (jg, ja, ji), (tg, ta, ti) = request.getfixturevalue(which)
    ns = "biological_process"
    jc = jcache.TermSimilarityCache(jsim.SimilarityLin(ji), ja, ns)
    tc = tcache.TermSimilarityCache(tsim.SimilarityLin(ti), ta, ns)
    assert tc.terms == jc.terms and tc.term_count() == jc.term_count()
    np.testing.assert_array_equal(tc.matrix, jc.matrix)
    genes = ja.all_genes()[:12]
    for measure in ("BMA", "ABM", "MAX"):
        np.testing.assert_array_equal(tc.gene_similarity_matrix(ta, genes, measure),
                                      jc.gene_similarity_matrix(ja, genes, measure))
    a, b = set(jc.terms[:3]), set(jc.terms[2:6]) | {"GO:9999999"}
    for fn in ("best_match_average", "average_best_match", "all_pairs_max"):
        assert getattr(tc, fn)(a, b) == getattr(jc, fn)(a, b)
        assert getattr(tc, fn)(set(), b) == getattr(jc, fn)(set(), b)
    assert tc.calculate_term_similarity(jc.terms[0], "GO:9999999") == 0.0
    jpath, tpath = str(tmp_path / "j.tsv"), str(tmp_path / "t.tsv")
    jcache.write_similarity_matrix(jpath, jc.terms, jc.matrix)
    tcache.write_similarity_matrix(tpath, tc.terms, tc.matrix)
    assert open(tpath).read() == open(jpath).read()
    t_terms, t_matrix = tcache.read_similarity_matrix(tpath)
    j_terms, j_matrix = jcache.read_similarity_matrix(jpath)
    assert t_terms == j_terms
    np.testing.assert_array_equal(t_matrix, j_matrix)
    empty = tcache.TermSimilarityCache(tsim.SimilarityLin(ti), ta, "no_namespace")
    assert empty.matrix.shape == (0, 0)


def test_asymmetric_cache(mini):
    _path, (jg, ja, ji), (tg, ta, ti) = mini
    cols = MINI_TERMS[:3] + ["GO:0008150"]
    jc = jcache.TermSimilarityCacheAsymmetric(jsim.SimilarityResnik(ji), ja,
                                              "biological_process", column_terms=cols)
    tc = tcache.TermSimilarityCacheAsymmetric(tsim.SimilarityResnik(ti), ta,
                                              "biological_process", column_terms=cols)
    np.testing.assert_array_equal(tc.matrix, jc.matrix)
    assert tc.calculate_term_similarity(MINI_TERMS[0], cols[-1]) == \
        jc.calculate_term_similarity(MINI_TERMS[0], cols[-1])


# ------------------------------------------------- enrichment, distributions
@pytest.mark.parametrize("which", ["mini", "synthetic"])
def test_enrichment(which, request):
    _path, (jg, ja, _ji), (tg, ta, _ti) = request.getfixturevalue(which)
    genes = set(ja.all_genes()[:5])
    for term in ja.all_terms()[:10] + [jg.term_ids[0]]:
        assert tenr.descendant_genes(tg, ta, term) == jenr.descendant_genes(jg, ja, term)
        assert tenr.enrichment_significance(tg, ta, genes, term) == \
            jenr.enrichment_significance(jg, ja, genes, term)


@pytest.mark.parametrize("name,args,points", [
    ("HypergeometricDistribution", (40, 10, 100), (0, 3, 7)),
    ("NormalDistribution", (1.5, 2.0), (-1.0, 0.3, 4.0)),
    ("StdNormalDistribution", (), (-1.0, 0.0, 2.5)),
    ("LogNormalDistribution", (0.2, 0.7), (0.5, 1.0, 3.0)),
    ("GammaDistribution", (2.0, 1.5), (0.5, 2.0, 6.0)),
    ("BetaDistribution", (2.0, 5.0), (0.1, 0.4, 0.9)),
    ("BinomialDistribution", (20, 0.3), (0, 5, 12)),
    ("NegativeBinomialDistribution", (4.0, 0.4), (0, 3, 9)),
    ("PoissonDistribution", (3.5,), (0, 2, 8)),
])
def test_distributions(name, args, points):
    jd, td = getattr(jdist, name)(*args), getattr(tdist, name)(*args)
    for method in ("pdf", "cdf", "quantile", "upper_tail"):
        if hasattr(jd, method):
            for x in points if method != "quantile" else (0.1, 0.5, 0.9):
                assert getattr(td, method)(x) == getattr(jd, method)(x)
    if hasattr(jd, "random"):
        assert td.random(np.random.default_rng(3)) == jd.random(np.random.default_rng(3))


def test_distribution_sources_and_uniforms():
    for name, args in (("UniformUnitDistribution", ()), ("UniformRealDistribution", (2.0, -1.0)),
                       ("UniformIntegerDistribution", (3, 9))):
        assert getattr(tdist, name)(*args).random(tdist.DeterministicSource(5).generator()) == \
            getattr(jdist, name)(*args).random(jdist.DeterministicSource(5).generator())
    assert isinstance(tdist.RandomEntropySource().generator(), np.random.Generator)


# ------------------------------------------------------ the ontology database
@pytest.mark.parametrize("fmt", ["obo", "xml", "json"])
def test_ontology_database(tmp_path, fmt):
    obo = tmp_path / "mini.obo"
    obo.write_text(OBO_TEXT)
    go = {"obo": str(obo), "xml": _write_obo_xml(tmp_path / "mini.xml"),
          "json": _write_obographs(tmp_path / "mini.json")}[fmt]
    gaf = tmp_path / "mini.gaf"
    gaf.write_text("!gaf-version: 2.1\n" + "".join(
        "\t".join([r.db, r.gene_id, r.gene_symbol, r.qualifier, r.go_term, "ref",
                   r.evidence_code, "", r.aspect, "", "", "protein", r.taxon, "20240101",
                   "T"]) + "\n" for r in _mini_gaf()))
    jd = jdb.OntologyDatabase("mini", go, str(gaf))
    td = tdb.OntologyDatabase("mini", go, str(gaf))
    assert td.self_test() is jd.self_test() is True
    genes = jd.annotation.all_genes()
    for measure in ("Resnik", "Lin", "JiangConrath", "Relevance"):
        np.testing.assert_array_equal(
            td.gene_similarity_matrix(genes, measure=measure, set_measure="ABM"),
            jd.gene_similarity_matrix(genes, measure=measure, set_measure="ABM"))
    assert td.similarity_cache("biological_process") is td.similarity_cache("biological_process")
    np.testing.assert_array_equal(td.information.ic, jd.information.ic)
    empty = tmp_path / "empty.gaf"
    empty.write_text("!gaf-version: 2.1\n")
    assert tdb.OntologyDatabase("e", go, str(empty)).self_test() is \
        jdb.OntologyDatabase("e", go, str(empty)).self_test() is False
