"""The port's application shell (kgl_gene_tpu_torch/app, io/data_source,
square_parser, json_parser, resource_parsers, rest_api, literature/)
against the JAX package's on the same inputs: tests/test_app_shell.py's
runtime XML run by both exec_envs into two work directories (the port's
as `python -m kgl_gene_tpu_torch.app.exec_env --device cpu`), every output
file compared (integers and strings exactly, the inbreeding F columns
within PERF.md section 2's tolerances, the JAX package's Loglikelihood
with x64 enabled as tests/test_torch_stats.py runs it), and the shell's
parts one by one
on the oracles of test_app_shell.py, test_other_parsers.py,
test_literature.py and test_aux_subsystems.py. No test opens a connection.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import kgl_gene_tpu.analysis  # noqa: F401 - registers the JAX package's analyses
from kgl_gene_tpu.app import analysis as j_analysis
from kgl_gene_tpu.app import exec_env as j_exec_env
from kgl_gene_tpu.app import package as j_package
from kgl_gene_tpu.app import resources as j_resources
from kgl_gene_tpu.app import runtime as j_runtime
from kgl_gene_tpu.io import data_source as j_data_source
from kgl_gene_tpu.io import json_parser as j_json
from kgl_gene_tpu.io import resource_parsers as j_parsers
from kgl_gene_tpu.io import rest_api as j_rest
from kgl_gene_tpu.io import square_parser as j_square
from kgl_gene_tpu.literature import publication as j_publication
from kgl_gene_tpu.literature import pubmed as j_pubmed
from kgl_gene_tpu.stats import inbreeding as j_inbreeding

import kgl_gene_tpu_torch.analysis.registered  # noqa: F401 - registers the port's analyses
from kgl_gene_tpu_torch.app import analysis as t_analysis
from kgl_gene_tpu_torch.app import package as t_package
from kgl_gene_tpu_torch.app import resources as t_resources
from kgl_gene_tpu_torch.app import runtime as t_runtime
from kgl_gene_tpu_torch.io import data_source as t_data_source
from kgl_gene_tpu_torch.io import json_parser as t_json
from kgl_gene_tpu_torch.io import resource_parsers as t_parsers
from kgl_gene_tpu_torch.io import rest_api as t_rest
from kgl_gene_tpu_torch.io import square_parser as t_square
from kgl_gene_tpu_torch.literature import publication as t_publication
from kgl_gene_tpu_torch.literature import pubmed as t_pubmed

from fixtures import CONTIG_1, make_genome_files, write_vcf
from test_app_shell import _write_runtime_xml
from test_literature import EFETCH_XML, ELINK_XML
from test_other_parsers import _write_aggregate_vcf, _write_gnomad_vcf, _write_phased_vcf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# PERF.md section 2: the port's F values against the JAX package's.
F_ATOL = {"Simple": 1e-5, "RitlandLocus": 1e-5, "HallME": 1e-3, "Loglikelihood": 1e-4}
SHELL_FILES = ("inbreeding.csv", "info_field_stats.csv", "interval_density.csv",
               "sequence_GENE1_GENE1.1.csv", "sequence_GENE1_GENE1.1.nwk")


@contextlib.contextmanager
def jax_loglikelihood_x64():
    """While the block runs, the JAX package's Loglikelihood estimator runs
    with x64 enabled: its float32 objective lies up to ~5e-4 from the exact
    maximum, which the port's float64 objective reaches (tests/
    test_torch_stats.py holds the two within 1e-4 so)."""
    orig = j_inbreeding._estimate

    def estimate(algorithm, data):
        if algorithm == "Loglikelihood":
            with jax.enable_x64(True):
                return orig(algorithm, data)
        return orig(algorithm, data)

    j_inbreeding._estimate = estimate
    try:
        yield
    finally:
        j_inbreeding._estimate = orig


def same_output_file(got_path, want_path, atol=F_ATOL):
    """Two output files equal: text byte for byte, except that a CSV
    column named in `atol` holds floats within that tolerance."""
    with open(got_path) as f:
        got = f.read().splitlines()
    with open(want_path) as f:
        want = f.read().splitlines()
    assert len(got) == len(want), (got_path, len(got), len(want))
    if not got or not any(name in got[0].split(",") for name in atol):
        assert got == want, got_path
        return
    assert got[0] == want[0]
    header = got[0].split(",")
    for g_line, w_line in zip(got[1:], want[1:]):
        g_row, w_row = g_line.split(","), w_line.split(",")
        assert len(g_row) == len(w_row) == len(header)
        for name, g, w in zip(header, g_row, w_row):
            if name in atol:
                assert abs(float(g) - float(w)) <= atol[name], (got_path, name, g, w)
            else:
                assert g == w, (got_path, name, g, w)


@pytest.fixture(scope="module")
def shell_runs(tmp_path_factory):
    """test_app_shell.py's XML run by the JAX package's run_application and
    by the port's `python -m kgl_gene_tpu_torch.app.exec_env --device cpu`."""
    base = tmp_path_factory.mktemp("shell")
    files = make_genome_files(base)
    vcf = write_vcf(str(base / "pop.vcf"))
    xml = _write_runtime_xml(str(base / "runtime.xml"), files, vcf, str(base / "work"))
    jax_dir, port_dir = str(base / "work_jax"), str(base / "work_port")
    with jax_loglikelihood_x64():
        assert j_exec_env.run_application(
            j_exec_env.GeneExecEnv, ["--optionFile", xml, "--workDirectory", jax_dir]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "kgl_gene_tpu_torch.app.exec_env", "--optionFile", xml,
         "--workDirectory", port_dir, "--device", "cpu"],
        cwd=str(base), env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr
    return xml, jax_dir, port_dir, proc.stdout + proc.stderr


def test_exec_env_writes_the_jax_packages_files(shell_runs):
    _xml, jax_dir, port_dir, log = shell_runs
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == sorted(SHELL_FILES)
    assert "package testPackage complete" in log and "dropped" not in log


@pytest.mark.parametrize("name", SHELL_FILES)
def test_exec_env_output_equals_jax(shell_runs, name):
    _xml, jax_dir, port_dir, _log = shell_runs
    same_output_file(os.path.join(port_dir, name), os.path.join(jax_dir, name))


def test_runtime_properties_equal_jax(shell_runs):
    xml = shell_runs[0]
    got, want = (m.RuntimeProperties.read_properties(xml) for m in (t_runtime, j_runtime))
    assert got.work_directory == want.work_directory
    assert got.active_packages == want.active_packages == ["testPackage"]
    for attr in ("packages", "analyses", "parameter_blocks", "data_files", "resources"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert list(g) == list(w)
        assert [dataclasses.asdict(v) for v in g.values()] == \
            [dataclasses.asdict(v) for v in w.values()]
        assert [type(v).__name__ for v in g.values()] == [type(v).__name__ for v in w.values()]
    assert got.evidence_map == want.evidence_map
    assert got.contig_alias.lookup("chr1_alias") == want.contig_alias.lookup("chr1_alias") \
        == CONTIG_1
    assert got.contig_alias.contig_type(CONTIG_1).value == \
        want.contig_alias.contig_type(CONTIG_1).value
    assert [p.parameters for p in got.analysis_parameters("PfSEQUENCE")] == \
        [p.parameters for p in want.analysis_parameters("PfSEQUENCE")]


def test_execute_package_takes_the_card_unless_asked(shell_runs, monkeypatch):
    """The device is explicit: ExecutePackage resolves it as every entry
    point does, so with no card and no --device it raises, and with
    device='cpu' every analysis gets the CPU."""
    props = t_runtime.RuntimeProperties.read_properties(shell_runs[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_package.ExecutePackage(props, work_directory=shell_runs[2])
    executor = t_package.ExecutePackage(props, work_directory=shell_runs[2], device="cpu")
    assert executor.device == torch.device("cpu")
    pa = t_analysis.PackageAnalysis(".", props, device=executor.device)
    pa.initialize(["NULL", "INTERVAL", "INBREED"], t_resources.AnalysisResources())
    assert [a.device for a in pa.active] == [torch.device("cpu")] * 3


def test_factory_and_dropped_analyses_as_jax():
    """test_app_shell's plugin isolation: an analysis that raises is
    dropped, the rest go on; the port also records what it dropped."""
    for module in (j_analysis, t_analysis):
        assert module.analysis_factory("NULL") is not None
        assert module.analysis_factory("NO_SUCH") is None

        class FailingAnalysis(module.VirtualAnalysis):
            ANALYSIS_IDENT = "FAIL_TEST_PORT"

            def file_read_analysis(self, data_object):
                raise RuntimeError("boom")

        module.register_analysis(FailingAnalysis)
        pa = module.PackageAnalysis(".", None)
        pa.initialize(["FAIL_TEST_PORT", "NULL", "NO_SUCH"], None)
        assert len(pa.active) == 2
        pa.file_read_analysis(object())
        assert [a.ANALYSIS_IDENT for a in pa.active] == ["NULL"]
    assert pa.dropped == [("NO_SUCH", "factory"), ("FAIL_TEST_PORT", "file_read_analysis")]
    assert set(t_analysis.registered_analysis_idents()) >= {
        "NULL", "INTERVAL", "INFO_FILTER", "PARSEJSON", "INBREED", "PfSEQUENCE", "PfEMP",
        "MUTATION", "LITERATURE"}


def test_data_source_table_equals_jax():
    assert [c.source_text for c in t_data_source.DATA_CHARACTERISTICS] == \
        [c.source_text for c in j_data_source.DATA_CHARACTERISTICS]
    for c in j_data_source.DATA_CHARACTERISTICS:
        got = t_data_source.find_characteristic(c.source_text.lower())
        assert (got.data_source.value, got.parser_type.value, got.data_structure.value,
                got.data_organism.value) == (c.data_source.value, c.parser_type.value,
                                             c.data_structure.value, c.data_organism.value)
        assert t_data_source.find_characteristic(
            t_data_source.DataSource(c.data_source.value)).source_text == c.source_text
    assert t_data_source.find_characteristic("nope") is None


def _population_summary(pop):
    return sorted(
        (gid, contig_id, v.offset, v.phase.name, v.hgvs())
        for gid, genome in pop for contig_id, contig in genome for v in contig)


@pytest.mark.parametrize("parser,writer", [
    ("Falciparum", lambda p: write_vcf(p)),
    ("PF_DIPLOID", lambda p: write_vcf(p)),
    ("PHASED_DIPLOID", _write_phased_vcf),
    ("Genome1000", _write_phased_vcf),
    ("GNOMAD_DIPLOID", _write_gnomad_vcf),
    ("MONO_GENOME", _write_aggregate_vcf),
])
def test_parser_selection_equals_jax(tmp_path, parser, writer):
    """ParserSelection's dispatch through the characteristics table and
    the parser-type names (test_app_shell's named source, the VCF kinds of
    test_other_parsers) gives the JAX package's population."""
    path = writer(str(tmp_path / "data.vcf"))
    pops = []
    for runtime, package, resources in ((t_runtime, t_package, t_resources),
                                        (j_runtime, j_package, j_resources)):
        props = runtime.RuntimeProperties()
        info = runtime.RuntimeVCFFileInfo("data", path, parser, "")
        pops.append(package.ParserSelection.parse_data(info, props, resources.AnalysisResources()))
    assert pops[0].genome_count() == pops[1].genome_count() > 0
    assert _population_summary(pops[0]) == _population_summary(pops[1])


def test_json_parser_and_dispatch_equal_jax(tmp_path):
    path = tmp_path / "dbsnp.json"
    path.write_text('{"refsnp_id": "0", "citations": [111, 222]}\n'
                    'not json\n'
                    '{"refsnp_id": "7", "citations": []}\n'
                    '{"citations": [5]}\n'
                    '{"refsnp_id": "9", "citations": ["333"]}\n')
    got, want = t_json.parse_dbsnp_json(str(path)), j_json.parse_dbsnp_json(str(path))
    assert got.citation_map == want.citation_map == {"rs0": {"111", "222"}, "rs9": {"333"}}
    assert len(got) == len(want) and got.pmids_for("rs0") == want.pmids_for("rs0")
    info = t_runtime.BaseFileInfo("js", str(path), "JSON_DBSNP")
    parsed = t_package.ParserSelection.parse_data(info, t_runtime.RuntimeProperties(),
                                                  t_resources.AnalysisResources())
    assert parsed.citation_map == want.citation_map


def test_square_parser_equals_jax(tmp_path):
    path = tmp_path / "square.tsv"
    path.write_text("# comment\nA\tB\tC\n1\t2\t3\n\n4\t5\n")
    for header in (False, True):
        got = t_square.parse_square_text(str(path), header=header)
        want = j_square.parse_square_text(str(path), header=header)
        assert got.rows == want.rows
        assert got.verify_field_count(3) == want.verify_field_count(3) is False
    csv = tmp_path / "square.csv"
    csv.write_text("a,b\nc,d\n")
    got = t_square.parse_square_text(str(csv), delimiter=t_square.COMMA)
    assert got.rows == j_square.parse_square_text(str(csv), delimiter=j_square.COMMA).rows
    assert got.verify_field_count(2)


def test_rest_gating_equals_jax():
    """test_aux_subsystems.TestRestGating: with the network off both
    return None and open nothing."""
    for module in (t_rest, j_rest):
        api = module.RestAPI("http://example.invalid", allow_network=False)
        assert api.synchronous_request("x", {"a": "1"}) is None
        assert api.post_request("x", b"data") is None
        assert api._url("p", {"q": "a b"}) == "http://example.invalid/p?q=a+b"


def _resource_files(base):
    """The files of test_aux_subsystems.TestResourceParsers and
    test_mutation_analysis, plus Pf7 distance, Pf3k COI and Entrez."""
    files = {}

    def write(name, text):
        files[name] = str(base / name)
        (base / name).write_text(text)

    header = "\t".join(["Sample", "Study", "Country", "Site", "clat", "clon", "lat", "lon",
                        "Year", "ENA", "All", "Population", "Callable", "QC pass",
                        "Fail reason", "Type", "InPf6"])
    write("samples.tsv", header + "\n" + "\n".join([
        "\t".join(["S1", "st", "Ghana", "Accra", "8", "-1", "5.55", "-0.2", "2019", "E1", "T",
                   "WAF", "0.9", "True", "", "WGS", "F"]),
        "\t".join(["S2", "st", "Kenya", "Kilifi", "0", "38", "-3.63", "39.85", "2019", "E2",
                   "T", "EAF", "0.9", "False", "low", "WGS", "F"]),
        "\t".join(["S3", "st", "Mali", "Bamako", "17", "-4", "12.6", "-8.0", "2018"]),
    ]) + "\n")
    write("fws.tsv", "Sample\tFWS\nS1\t0.99\nS2\t0.5\nS3\tx\n")
    write("ped.tsv", "Family\tInd\tPat\tMat\tSex\tPheno\tPop\tPopDesc\n"
                     "F1\tI1\t0\t0\t1\t0\tGBR\tBritish\nF1\tI2\t0\t0\t2\t0\tACB\n")
    write("aux.tsv", "Ind\tSex\tPop\tDesc\tSuperPop\tSuperDesc\n"
                     "I1\t1\tGBR\tBritish\tEUR\tEuropean\nI2\t2\tACB\n")
    write("nom.tsv", "Symbol\tHGNC\tEnsembl\nBRCA2\tHGNC:1101\tENSG00000139618\nX\t\t\n")
    write("pmid.tsv", "123\tDisease\tD001\n456\tGene\t675\n789\tGene\t675\nbad\n")
    write("entrez.tsv", "Symbol\tEntrez\nBRCA2\t675\nTP53\n")
    write("citations.tsv", "rs0\t111\nrs0\t222\nrs9\t333\n")
    write("coi.tsv", "Sample\tCOI\nS1\t2\nS2\tx\n")
    write("dist_ids.tsv", "S1\nS2\nS3\n")
    write("dist.tsv", "0\t0.25\tnan\n0.25\t0\t0.5\nNA\t0.5\t0\n")
    return files


def _resource_state(obj):
    """A resource's contents as plain data (records as dicts)."""
    out = {}
    for key, value in vars(obj).items():
        if isinstance(value, np.ndarray):
            out[key] = np.where(np.isnan(value), -1.0, value).tolist()
        elif isinstance(value, dict):
            out[key] = {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
                        for k, v in value.items()}
        else:
            out[key] = value
    return out


RESOURCE_DEFS = {
    "Pf7Sample": {"file": "samples.tsv"},
    "Pf7Fws": {"file": "fws.tsv"},
    "Pf7Distance": {"matrixFile": "dist.tsv", "sampleFile": "dist_ids.tsv"},
    "Pf3kCOI": {"file": "coi.tsv"},
    "Genealogy": {"file": "ped.tsv"},
    "GenomeAux": {"file": "aux.tsv"},
    "GeneNomenclature": {"file": "nom.tsv"},
    "Entrez": {"file": "entrez.tsv"},
    "Citation": {"file": "citations.tsv"},
    "BioPMID": {"file": "pmid.tsv"},
}


@pytest.mark.parametrize("resource_type", sorted(RESOURCE_DEFS))
def test_resource_loaders_equal_jax(tmp_path, resource_type):
    """Every tabular loader of RESOURCE_LOADERS through load_resource, on
    test_aux_subsystems.TestResourceParsers' files: the same contents."""
    files = _resource_files(tmp_path)
    params = {k: files[v] for k, v in RESOURCE_DEFS[resource_type].items()}
    got = []
    for runtime, resources in ((t_runtime, t_resources), (j_runtime, j_resources)):
        container = resources.AnalysisResources()
        assert resources.load_resource(
            runtime.ResourceDefinition(resource_type, "r1", params), container)
        got.append(container.get_resource(resource_type, "r1"))
    assert type(got[0]).__name__ == type(got[1]).__name__
    assert _resource_state(got[0]) == _resource_state(got[1])


def test_resource_parsers_behave_as_jax(tmp_path):
    """test_aux_subsystems.TestResourceParsers' assertions, on both."""
    files = _resource_files(tmp_path)
    for m in (t_parsers, j_parsers):
        samples = m.parse_pf7_sample(files["samples.tsv"])
        assert samples.qc_pass_samples() == {"S1"}
        assert 4000 < m.Pf7PhysicalDistance(samples).sample_distance_km("S1", "S2") < 6000
        assert m.Pf7PhysicalDistance(samples).sample_distance_km("S1", "S9") is None
        fws = m.parse_pf7_fws(files["fws.tsv"])
        assert fws.monoclonal_samples() == {"S1"} and fws.get("S2") == 0.5
        dist = m.parse_pf7_distance(files["dist.tsv"], files["dist_ids.tsv"])
        assert dist.distance("S1", "S2") == 0.25 and dist.distance("S1", "S3") is None
        assert m.parse_ped_genealogy(files["ped.tsv"]).population_of("I1") == "GBR"
        assert m.parse_genome_aux(files["aux.tsv"]).super_population_of("I1") == "EUR"
        nom = m.parse_uniprot_nomenclature(files["nom.tsv"])
        assert nom.ensembl_to_symbol["ENSG00000139618"] == "BRCA2"
        bio = m.parse_bio_pmid(files["pmid.tsv"])
        assert bio.entrez_pmids("675") == {"456", "789"} and bio.disease_pmids("D001") == {"123"}
        assert m.parse_entrez(files["entrez.tsv"]).entrez_id("BRCA2") == "675"
        assert m.parse_pf3k_coi(files["coi.tsv"]).coi("S1") == 2


def test_resource_loader_registry_equals_jax(tmp_path):
    """The same thirteen resource types; a missing file or parameter is
    refused by both, an unknown type too."""
    assert sorted(t_resources.RESOURCE_LOADERS) == sorted(j_resources.RESOURCE_LOADERS)
    assert len(t_resources.RESOURCE_LOADERS) == 13
    for runtime, resources in ((t_runtime, t_resources), (j_runtime, j_resources)):
        container = resources.AnalysisResources()
        assert not resources.load_resource(runtime.ResourceDefinition(
            "Pf7Fws", "x", {"file": str(tmp_path / "missing.tsv")}), container)
        assert not resources.load_resource(runtime.ResourceDefinition("Citation", "y", {}),
                                           container)
        assert not resources.load_resource(runtime.ResourceDefinition("NoSuch", "z", {}),
                                           container)
        assert container.get_resource("Pf7Fws") is None


def test_genome_and_ontology_resources_equal_jax(tmp_path):
    """_load_genome and _load_ontology (the port's OntologyDatabase) on the
    fixture genome and a two-term OBO with the fixture's GAF."""
    files = make_genome_files(tmp_path)
    obo = tmp_path / "go.obo"
    obo.write_text("[Term]\nid: GO:0000001\nnamespace: biological_process\n\n"
                   "[Term]\nid: GO:0000002\nnamespace: molecular_function\n\n"
                   "[Term]\nid: GO:0000003\nnamespace: biological_process\n"
                   "is_a: GO:0000001\n")
    got = []
    for runtime, resources in ((t_runtime, t_resources), (j_runtime, j_resources)):
        container = resources.AnalysisResources()
        assert resources.load_resource(runtime.ResourceDefinition(
            "GenomeDatabase", "g", {"fastaFile": files["fasta"], "gffFile": files["gff"],
                                    "gafFile": files["gaf"]}), container)
        assert resources.load_resource(runtime.ResourceDefinition(
            "OntologyDatabase", "o", {"goFile": str(obo), "annotationFile": files["gaf"]}),
            container)
        genome = container.get_resource("GenomeDatabase")
        onto = container.get_resource("OntologyDatabase", "o")
        got.append((sorted(cid for cid, _ in genome), genome.gene_ontology,
                    onto.ontology_ident, sorted(onto.annotation.all_terms("biological_process"))))
    assert got[0] == got[1]


def _publications_state(pubs):
    return {k: dataclasses.asdict(v) for k, v in pubs.items()}


def test_pubmed_xml_on_elementtree_equals_lxml():
    """parse_pubmed_article_xml / parse_elink_citation_xml on ElementTree
    against the JAX package's lxml parse: test_literature's replies, a
    second article with a missing title and no date, and bad XML."""
    second = EFETCH_XML.replace("<PMID Version=\"1\">12345</PMID>", "<PMID>777</PMID>") \
        .replace("<ArticleTitle>Var gene diversity in P. falciparum.</ArticleTitle>", "") \
        .replace("<PubDate><Year>2021</Year><Month>Mar</Month></PubDate>", "<PubDate/>")
    for xml in (EFETCH_XML, second):
        got, want = t_pubmed.parse_pubmed_article_xml(xml), j_pubmed.parse_pubmed_article_xml(xml)
        assert got and _publications_state(got) == _publications_state(want)
    assert t_pubmed.parse_elink_citation_xml(ELINK_XML) == \
        j_pubmed.parse_elink_citation_xml(ELINK_XML) == {"12345": {"111", "222"}}
    for bad in ("<not-closed", "garbage"):
        assert t_pubmed.parse_pubmed_article_xml(bad) == {}
        assert t_pubmed.parse_elink_citation_xml(bad) == {}


def test_pubmed_cache_round_trip_equals_jax(tmp_path, monkeypatch):
    """test_literature's cache round trip: a prior run's cache serves
    every lookup, and nothing asks the network."""
    def refuse(*args, **kwargs):
        raise AssertionError("a request left the process")

    monkeypatch.setattr("urllib.request.urlopen", refuse)
    results = []
    for module in (t_pubmed, j_pubmed):
        cache = tmp_path / module.__name__
        cache.mkdir()
        writer = module.PubmedRequester("pm", cache_directory=str(cache))
        writer._append_cache(module.PUBLICATION_CACHE, EFETCH_XML)
        writer._append_cache(module.CITATION_CACHE, ELINK_XML)
        reader = module.PubmedRequester("pm", cache_directory=str(cache))
        pubs = reader.get_publications(["12345", "99999"])
        assert pubs["12345"].citation_count() == 2
        results.append((_publications_state(pubs), reader.get_citations(["12345", "5"])))
    assert results[0] == results[1]


def _citation_collection(module):
    return {
        "base": module.PublicationSummary(
            pmid="base", publication_date="2015-01-10", journal="J1", authors=[("Ada", "L")],
            cited_by={"c1", "c2", "c3", "missing"}),
        "c1": module.PublicationSummary(pmid="c1", publication_date="2015-04"),
        "c2": module.PublicationSummary(pmid="c2", publication_date="2016-01",
                                        authors=[("Ada", "L"), ("Bo", "")]),
        "c3": module.PublicationSummary(pmid="c3", publication_date="2016-01", journal="J1"),
        "late": module.PublicationSummary(pmid="late", publication_date="2026-01"),
        "undated": module.PublicationSummary(pmid="undated", cited_by={"c1"}),
    }


def test_publication_maps_equal_jax():
    """test_literature.TestAnalysisMaps on both: the derived maps, citation
    period, variance, quartiles and histogram."""
    maps = [m.LiteratureAnalysis(_citation_collection(m)) for m in (t_publication, j_publication)]

    def pmids(by):
        return {k: sorted(p.pmid for p in v) for k, v in by.items()}

    got, want = maps
    assert pmids(got.by_author()) == pmids(want.by_author())
    assert pmids(got.by_year()) == pmids(want.by_year())
    assert pmids(got.by_journal()) == pmids(want.by_journal())
    assert [p.pmid for p in got.by_citation_count()] == [p.pmid for p in want.by_citation_count()]
    assert got.citation_period() == want.citation_period() == {3: 1, 12: 2}
    assert got.citation_variance(24) == want.citation_variance(24)
    assert got.publication_citations("base") == want.publication_citations("base")
    for months in (0, 120):
        assert got.citation_distribution(months) == want.citation_distribution(months)
        q_got, q_want = got.citation_quartiles(months), want.citation_quartiles(months)
        assert len(q_got) == len(q_want)
        for fraction in (0.0, 0.25, 0.5, 0.9, 1.0):
            a, b = q_got.percentile(fraction), q_want.percentile(fraction)
            assert (a[0], a[1].pmid) == (b[0], b[1].pmid)
    assert got.most_recent_publication().pmid == want.most_recent_publication().pmid == "late"


def test_pubmed_cache_reads_every_record_where_jax_reads_the_first(tmp_path):
    """A cache of replies that carry an XML declaration, as NCBI's do: the
    reference parses each record with the newline its writer puts after
    the marker, so every record but the first fails; the port strips the
    record first and serves all of them (ROADMAP.md section C)."""
    second = EFETCH_XML.replace('<PMID Version="1">12345</PMID>', "<PMID>67890</PMID>")
    got = {}
    for module in (t_pubmed, j_pubmed):
        cache = tmp_path / module.__name__
        cache.mkdir()
        writer = module.PubmedRequester("pm", cache_directory=str(cache))
        for xml in (EFETCH_XML, second):
            writer._append_cache(module.PUBLICATION_CACHE, xml)
        reader = module.PubmedRequester("pm", cache_directory=str(cache))
        got[module] = sorted(reader.get_publications(["12345", "67890"]))
    assert got[t_pubmed] == ["12345", "67890"]
    assert got[j_pubmed] == ["12345"]
