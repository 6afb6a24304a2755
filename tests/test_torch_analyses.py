"""The port's nine registered analyses (kgl_gene_tpu_torch/analysis/
{null, sequence, info, inbreed, pfemp, mutation, literature}_analysis.py)
against the JAX package's on the same inputs, each analysis driven through
its four lifecycle calls by both packages (the port's with device="cpu")
into two work directories whose files are compared: integers and strings
exactly, the inbreeding F columns within PERF.md section 2's tolerances
(the JAX package's Loglikelihood with x64 enabled, as tests/
test_torch_stats.py runs it).
The oracles are test_app_shell.py's fixture run and test_mutation_analysis.py's
cohort, Clinvar and resources; the last test runs chip_smoke.py phase 3h's
XML (the nine analyses in two packages) at a small size through both
exec_envs. No test opens a connection.
"""

import contextlib
import os
import shutil

import numpy as np
import pytest

import kgl_gene_tpu.analysis  # noqa: F401 - registers the JAX package's analyses
from kgl_gene_tpu.app import analysis as j_analysis
from kgl_gene_tpu.app import exec_env as j_exec_env
from kgl_gene_tpu.app import resources as j_resources
from kgl_gene_tpu.app import runtime as j_runtime
from kgl_gene_tpu.genome.genome import GenomeReference as JGenome
from kgl_gene_tpu.io import json_parser as j_json
from kgl_gene_tpu.io import resource_parsers as j_parsers
from kgl_gene_tpu.io.vcf import parse_vcf_population as j_parse_vcf
from kgl_gene_tpu.literature import pubmed as j_pubmed

import kgl_gene_tpu_torch.analysis.registered  # noqa: F401 - registers the port's analyses
from kgl_gene_tpu_torch.app import analysis as t_analysis
from kgl_gene_tpu_torch.app import exec_env as t_exec_env
from kgl_gene_tpu_torch.app import resources as t_resources
from kgl_gene_tpu_torch.app import runtime as t_runtime
from kgl_gene_tpu_torch.genome.genome import GenomeReference as TGenome
from kgl_gene_tpu_torch.io import json_parser as t_json
from kgl_gene_tpu_torch.io import resource_parsers as t_parsers
from kgl_gene_tpu_torch.io.synthetic import generate_population_files
from kgl_gene_tpu_torch.io.vcf import parse_vcf_population as t_parse_vcf
from kgl_gene_tpu_torch.literature import pubmed as t_pubmed

from fixtures import make_genome_files, write_vcf
from test_literature import EFETCH_XML, ELINK_XML
from test_mutation_analysis import _write_clinvar_vcf
from test_torch_app import jax_loglikelihood_x64, same_output_file

JAX = dict(analysis=j_analysis, resources=j_resources, runtime=j_runtime, genome=JGenome,
           json=j_json, parsers=j_parsers, parse_vcf=j_parse_vcf, pubmed=j_pubmed)
PORT = dict(analysis=t_analysis, resources=t_resources, runtime=t_runtime, genome=TGenome,
            json=t_json, parsers=t_parsers, parse_vcf=t_parse_vcf, pubmed=t_pubmed)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The fixture genome (GENE1 described as a rifin, so PfEMP has a
    family), its VCF, a Clinvar VCF, a small synthetic population (16
    samples, 2 genes of 300 coding bases, 200 records with indels) and the
    resource files of test_mutation_analysis and PfEMP."""
    base = tmp_path_factory.mktemp("analyses")
    files = make_genome_files(base)
    with open(files["gff"]) as f:
        gff = f.read().replace("ID=GENE1;Name=gene_one", "ID=GENE1;Name=gene_one;description=rifin")
    files["gff_family"] = str(base / "family.gff3")
    with open(files["gff_family"], "w") as f:
        f.write(gff)
    files["vcf"] = write_vcf(str(base / "pop.vcf"))
    files["clinvar"] = _write_clinvar_vcf(str(base / "clinvar.vcf"))
    syn_dir = base / "syn"
    syn_dir.mkdir()
    files["syn"] = generate_population_files(str(syn_dir), n_samples=16, contig_len=6_000,
                                             n_genes=2, n_records=200, coding_len=300, seed=4,
                                             snp_only=False)

    def write(name, text):
        files[name] = str(base / name)
        with open(files[name], "w") as f:
            f.write(text)

    samples = ("S1", "S2", "S3", "S4")
    write("ped.tsv", "Family\tIndividual\tPaternal\tMaternal\tSex\tPheno\tPopulation\tPopDesc\n"
          "F1\tS1\t0\t0\t1\t0\tACB\td\nF1\tS2\t0\t0\t2\t0\tACB\td\n"
          "F2\tS3\t0\t0\t1\t0\tGBR\td\nF2\tS4\t0\t0\t2\t0\tCHB\td\n")
    write("aux.tsv", "Individual\tSex\tPopulation\tPopDesc\tSuperPopulation\tSuperDesc\n"
          "S1\tmale\tACB\td\tAFR\td\nS2\tfemale\tACB\td\tAFR\td\n"
          "S3\tmale\tGBR\td\tEUR\td\nS4\tfemale\tCHB\td\tEAS\td\n")
    write("citations.tsv", "rs0\t111\nrs0\t222\nrs9\t333\n")
    write("samples.tsv", "Sample\tStudy\tCountry\tSite\tclat\tclon\tlat\tlon\tYear\tENA\tAll\t"
          "Population\tCallable\tQC pass\tFail reason\tType\tInPf6\n" + "".join(
              f"{s}\tst\tGhana\tAccra\t8\t-1\t{5 + i}\t{-0.2 + 3 * i}\t2019\tE\tT\tWAF\t0.9\t"
              f"{'False' if s == 'S3' else 'True'}\t\tWGS\tF\n" for i, s in enumerate(samples)))
    write("fws.tsv", "Sample\tFWS\nS1\t0.99\nS2\t0.97\nS3\t0.99\nS4\t0.5\n")
    write("dist_ids.tsv", "S1\nS2\nS3\nS4\n")
    write("dist.tsv", "0\t0.1\t0.2\t0.3\n0.1\t0\t0.4\tnan\n0.2\t0.4\t0\t0.5\n0.3\tnan\t0.5\t0\n")
    write("entrez.tsv", "Symbol\tEntrez\nGENE1\t675\nGENE2\t676\n")
    write("pmid.tsv", "12345\tGene\t675\n67890\tGene\t675\n12345\tGene\t676\n9\tDisease\tD1\n")
    write("dbsnp.json", '{"refsnp_id": "0", "citations": [12345, 67890]}\n'
                        '{"refsnp_id": "2", "citations": [12345]}\n')
    cache = base / "pubmed"
    cache.mkdir()
    # Records without the XML declaration: the JAX package's cache reader
    # reads a declared record only first (ROADMAP.md section C).
    second = EFETCH_XML.replace('<PMID Version="1">12345</PMID>', "<PMID>67890</PMID>") \
        .replace("<Year>2021</Year>", "<Year>2011</Year>").split("?>", 1)[1]
    with open(cache / "pubmed_publication_cache.xml", "w") as f:
        f.write(EFETCH_XML + "\n<!--CACHE-RECORD-->\n" + second + "\n<!--CACHE-RECORD-->\n")
    with open(cache / "pubmed_citation_cache.xml", "w") as f:
        f.write(ELINK_XML + "\n<!--CACHE-RECORD-->\n")
    files["pubmed"] = str(cache)
    return files


def _resources(pkg, files, genome_gff="gff", with_genome=True):
    container = pkg["resources"].AnalysisResources()
    if with_genome:
        container.add_resource("GenomeDatabase", "g", pkg["genome"].create_genome_database(
            "g", files["fasta"], files[genome_gff], files["gaf"]))
    p = pkg["parsers"]
    container.add_resource("Genealogy", "ped", p.parse_ped_genealogy(files["ped.tsv"]))
    container.add_resource("GenomeAux", "aux", p.parse_genome_aux(files["aux.tsv"]))
    container.add_resource("Citation", "cit", p.parse_citations(files["citations.tsv"]))
    container.add_resource("Pf7Sample", "s", p.parse_pf7_sample(files["samples.tsv"]))
    container.add_resource("Pf7Fws", "f", p.parse_pf7_fws(files["fws.tsv"]))
    container.add_resource("Pf7Distance", "d", p.parse_pf7_distance(files["dist.tsv"],
                                                                     files["dist_ids.tsv"]))
    container.add_resource("Entrez", "e", p.parse_entrez(files["entrez.tsv"]))
    container.add_resource("BioPMID", "b", p.parse_bio_pmid(files["pmid.tsv"]))
    container.add_resource("PubmedAPI", "pm", pkg["pubmed"].PubmedRequester(
        "pm", cache_directory=files["pubmed"]))
    return container


def _population(pkg, path, ident="cohort", kind="PF_DIPLOID", info=("AF", "DP", "VALIDATED"),
                **kwargs):
    pop, _header, store = pkg["parse_vcf"](path, ident, kind, subscribed_info=list(info),
                                           **kwargs)
    pop.info_store = store
    return pop


def _run_both(tmp_path, ident, files, params=None, data=("vcf",), **res_kwargs):
    """Both packages' `ident` analysis through its lifecycle on the same
    inputs; returns the two work directories and the two analyses."""
    out = []
    for name, pkg in (("port", PORT), ("jax", JAX)):
        work = tmp_path / name
        work.mkdir()
        analysis = pkg["analysis"].analysis_factory(ident)
        if name == "port":
            analysis.device = "cpu"
        blocks = [pkg["runtime"].ParameterMap("p", {k: [v] for k, v in (params or {}).items()})]
        ok = analysis.initialize_analysis(str(work), blocks, _resources(pkg, files, **res_kwargs))
        if not ok:
            out.append((str(work), analysis, False))
            continue
        with contextlib.ExitStack() as stack:
            if name == "jax":
                stack.enter_context(jax_loglikelihood_x64())
            _drive(pkg, analysis, files, data)
        out.append((str(work), analysis, True))
    return out


def _drive(pkg, analysis, files, data):
    """file_read_analysis on each of `data`, then iteration and finalize."""
    for item in data:
        if item == "json":
            obj = pkg["json"].parse_dbsnp_json(files["dbsnp.json"])
        elif item == "clinvar":
            obj = _population(pkg, files["clinvar"], "clinvarDB", "MONO_GENOME",
                              ("CLNSIG", "CLNDN"), genome_name="clinvar")
        elif item == "syn":
            obj = _population(pkg, files["syn"].vcf, "syn", info=("AF",))
        else:
            obj = _population(pkg, files["vcf"])
        assert analysis.file_read_analysis(obj)
    assert analysis.iteration_analysis()
    assert analysis.finalize_analysis()


def _same_dirs(runs):
    (port_dir, _p, _), (jax_dir, _j, _) = runs
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    for name in names:
        same_output_file(os.path.join(port_dir, name), os.path.join(jax_dir, name))
    return names


def test_null_counts_as_jax(tmp_path, inputs):
    runs = _run_both(tmp_path, "NULL", inputs, data=("vcf", "json"))
    (_, port, _), (_, jax, _) = runs
    assert (port.file_count, port.iteration_count, port.finalized) == \
        (jax.file_count, jax.iteration_count, jax.finalized) == (2, 1, True)
    assert _same_dirs(runs) == []


@pytest.mark.parametrize("size,with_genome", [("100", True), ("37", True), ("50", False)])
def test_interval_equals_jax(tmp_path, inputs, size, with_genome):
    runs = _run_both(tmp_path, "INTERVAL", inputs, {"IntervalSize": size},
                     with_genome=with_genome)
    assert _same_dirs(runs) == ["interval_density.csv"]


def test_interval_on_synthetic_population_equals_jax(tmp_path, inputs):
    runs = _run_both(tmp_path, "INTERVAL", inputs, {"IntervalSize": "500"}, data=("syn",),
                     with_genome=False)
    assert _same_dirs(runs) == ["interval_density.csv"]


@pytest.mark.parametrize("data", [("vcf",), ("vcf", "syn"), ("json",)])
def test_info_filter_equals_jax(tmp_path, inputs, data):
    runs = _run_both(tmp_path, "INFO_FILTER", inputs, data=data)
    assert _same_dirs(runs) == ["info_field_stats.csv"]


def test_parsejson_equals_jax(tmp_path, inputs):
    runs = _run_both(tmp_path, "PARSEJSON", inputs, data=("json", "vcf", "json"))
    assert _same_dirs(runs) == ["allele_citations.csv"]


@pytest.mark.parametrize("params,data", [
    ({}, ("vcf",)),
    ({"Algorithm": "Simple"}, ("vcf",)),
    ({}, ("syn",)),
    ({"Algorithm": "HallME", "MinAF": "0.05", "MaxAF": "0.6"}, ("syn",)),
    ({"Algorithm": "Loglikelihood", "SamplingDistance": "40", "LociiCount": "60",
      "LowerWindow": "100", "UpperWindow": "5000"}, ("syn",)),
    ({"Algorithm": "RitlandLocus", "SuperPopulation": "AFR"}, ("syn",)),
    ({"AnalysisType": "Synthetic"}, ("syn",)),
], ids=["all-fixture", "simple-fixture", "all-syn", "hallme-af-window", "loglik-spacing",
        "ritland", "synthetic"])
def test_inbreed_equals_jax(tmp_path, inputs, params, data):
    runs = _run_both(tmp_path, "INBREED", inputs, params, data=data, with_genome=False)
    names = _same_dirs(runs)
    assert names == ["inbreeding_synthetic.csv" if params.get("AnalysisType") else
                     "inbreeding.csv"]


@pytest.mark.parametrize("params", [{"Algorithm": "NoSuch"}, {"AnalysisType": "Other"}])
def test_inbreed_refuses_as_jax(tmp_path, inputs, params):
    runs = _run_both(tmp_path, "INBREED", inputs, params, with_genome=False)
    assert [ok for _d, _a, ok in runs] == [False, False]


@pytest.mark.parametrize("params", [
    {"GeneList": "GENE1"},
    {},
    {"DistanceMetric": "LOCAL"},
    {"FilterType": "SNP_ADJUSTED", "GeneList": "GENE1,GENE2"},
    {"FilterType": "frameshift_adjusted"},
], ids=["gene1", "all-genes", "local", "snp-adjusted", "frameshift"])
def test_sequence_equals_jax(tmp_path, inputs, params):
    runs = _run_both(tmp_path, "PfSEQUENCE", inputs, params)
    names = _same_dirs(runs)
    assert "sequence_GENE1_GENE1.1.csv" in names and "sequence_GENE1_GENE1.1.nwk" in names


def test_sequence_on_synthetic_population_equals_jax(tmp_path, inputs):
    """Sixteen genomes with SNPs and indels over two 300-base genes: the
    SNP and the SNP + indel steps and the family trees."""
    syn = inputs["syn"]
    files = dict(inputs, fasta=syn.fasta, gff=syn.gff3)
    runs = _run_both(tmp_path, "PfSEQUENCE", files, data=("syn",))
    assert _same_dirs(runs) == ["sequence_G0_G0.1.csv", "sequence_G0_G0.1.nwk",
                                "sequence_G1_G1.1.csv", "sequence_G1_G1.1.nwk"]


def test_sequence_needs_a_genome_as_jax(tmp_path, inputs):
    runs = _run_both(tmp_path, "PfSEQUENCE", inputs, with_genome=False)
    assert [ok for _d, _a, ok in runs] == [False, False]


def test_pfemp_equals_jax(tmp_path, inputs):
    """QC pass (S3 fails) and monoclonal (S4's FWS 0.5) filters, het/hom,
    FWS, the rifin family's report and the distance comparison."""
    runs = _run_both(tmp_path, "PfEMP", inputs, genome_gff="gff_family")
    assert _same_dirs(runs) == ["pfemp_RIFIN_GENE1.1.csv", "pfemp_distance_compare.csv",
                                "pfemp_fws.csv", "pfemp_zygosity.csv"]
    with open(os.path.join(runs[0][0], "pfemp_zygosity.csv")) as f:
        assert [line.split(",")[0] for line in f.read().split()[1:]] == ["S1", "S2"]


@pytest.mark.parametrize("data", [("vcf", "clinvar"), ("vcf",), ("clinvar", "vcf", "json")],
                         ids=["with-clinvar", "without-clinvar", "clinvar-first"])
def test_mutation_equals_jax(tmp_path, inputs, data):
    """test_mutation_analysis' cohort, Clinvar population, genealogy,
    genome-aux and citation resources, with the GAF's GO terms."""
    runs = _run_both(tmp_path, "MUTATION", inputs, data=data)
    assert _same_dirs(runs) == ["gene_allele.csv", "gene_mutation.csv"]
    with open(os.path.join(runs[0][0], "gene_mutation.csv")) as f:
        header, *rows = f.read().splitlines()
    row = dict(zip(header.split(","), next(r for r in rows if r.startswith("GENE1,")).split(",")))
    assert row["ClinvarAlleles"] == ("1" if "clinvar" in data else "0")


@pytest.mark.parametrize("params,data", [
    ({"GeneList": "GENE1,GENE2,NOPE"}, ("vcf",)),
    ({}, ("json",)),
    ({"GeneList": "GENE2"}, ("json", "json")),
], ids=["genes", "dbsnp-citations", "both"])
def test_literature_equals_jax(tmp_path, inputs, params, data, monkeypatch):
    """Gene -> Entrez -> bioPMID and dbSNP citations, publications from
    the PubMed cache only (urlopen refuses), and the publication maps."""
    def refuse(*args, **kwargs):
        raise AssertionError("a request left the process")

    monkeypatch.setattr("urllib.request.urlopen", refuse)
    runs = _run_both(tmp_path, "LITERATURE", inputs, params, data=data)
    names = _same_dirs(runs)
    assert "gene_literature.csv" in names and "literature_authors.csv" in names


def test_nine_analyses_package_equals_jax(tmp_path):
    """chip_smoke.py phase 3h's runtime XML and inputs (two packages, the
    nine analyses, every resource, a PubMed cache) at a small size: both
    exec_envs' run_application write the same files."""
    import chip_smoke

    data = tmp_path / "data"
    data.mkdir()
    paths = generate_population_files(str(data), n_samples=24, contig_len=9_000, n_genes=3,
                                      n_records=240, coding_len=300, seed=6, snp_only=False)
    files = chip_smoke.write_package_inputs(str(data), paths)
    dirs = {}
    for name, exec_env, extra in (("jax", j_exec_env, []), ("port", t_exec_env,
                                                            ["--device", "cpu"])):
        dirs[name] = str(tmp_path / f"work_{name}")
        xml = chip_smoke.write_package_xml(str(tmp_path / f"{name}.xml"), files, dirs[name])
        with chip_smoke.NoNetwork() as net, (jax_loglikelihood_x64() if name == "jax"
                                              else contextlib.nullcontext()):
            assert exec_env.run_application(
                exec_env.GeneExecEnv, ["--optionFile", xml, "--workDirectory", dirs[name]]
                + extra) == 0
        assert net.requests == 0
    names = sorted(os.listdir(dirs["jax"]))
    assert sorted(os.listdir(dirs["port"])) == names
    assert {"pfemp_RIFIN_G1.1.csv", "pfemp_STEVOR_G2.1.csv", "gene_literature.csv",
            "allele_citations.csv", "inbreeding.csv", "gene_mutation.csv"} <= set(names)
    for name in names:
        same_output_file(os.path.join(dirs["port"], name), os.path.join(dirs["jax"], name))
    shutil.rmtree(str(data))
