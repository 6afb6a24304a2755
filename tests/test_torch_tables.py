"""The port's copied tables and its isolation from JAX and the JAX
package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kgl_gene_tpu.sequence import alphabet as jalpha
from kgl_gene_tpu.sequence.tables import TABLE_NAMES, amino_translation_table as jtable
from kgl_gene_tpu_torch.sequence import alphabet as talpha
from kgl_gene_tpu_torch.sequence.tables import amino_translation_table as ttable
from kgl_gene_tpu_torch.sequence.tables import tables_from_numpy

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "kgl_gene_tpu_torch"


@pytest.mark.parametrize("name", TABLE_NAMES + ("no_such_table",))
def test_copied_tables_equal_reference(name):
    j, t = jtable(name), ttable(name)
    assert t.name == j.name
    np.testing.assert_array_equal(t.amino_lut, j.amino_lut)
    np.testing.assert_array_equal(t.start_lut, j.start_lut)
    np.testing.assert_array_equal(t.start_codes(), np.unique(j.amino_lut[j.start_lut]))


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_tables_from_numpy_carries_reference_arrays(name):
    j = jtable(name)
    t = tables_from_numpy(j.amino_lut, j.start_lut)
    np.testing.assert_array_equal(t.amino_lut, j.amino_lut)
    np.testing.assert_array_equal(t.start_lut, j.start_lut)
    assert t.amino_lut.dtype == np.uint8 and t.start_lut.dtype == bool


def test_tables_from_numpy_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tables_from_numpy(np.zeros(64, np.uint8), np.zeros(65, bool))


def test_alphabet_codes_equal_reference():
    np.testing.assert_array_equal(talpha.DNA5.COMPLEMENT, jalpha.DNA5.COMPLEMENT)
    assert talpha.DNA5.LETTERS == jalpha.DNA5.LETTERS
    assert talpha.AminoAcid.STOP == jalpha.AminoAcid.STOP
    assert talpha.AminoAcid.UNKNOWN == jalpha.AminoAcid.UNKNOWN
    np.testing.assert_array_equal(talpha.AminoAcid.CHAR_TO_CODE,
                                  jalpha.AminoAcid.CHAR_TO_CODE)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "kgl_gene_tpu"), (path, mod)


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kgl_gene_tpu'] = None\n"
        "import kgl_gene_tpu_torch.ops.traceback\n"
        "from kgl_gene_tpu_torch.app import exec_env\n"
        "import kgl_gene_tpu_torch.analysis.registered\n"
        "import kgl_gene_tpu_torch.io.rest_api, kgl_gene_tpu_torch.io.json_parser\n"
        "import kgl_gene_tpu_torch.io.data_source, kgl_gene_tpu_torch.literature.pubmed\n"
        "from kgl_gene_tpu_torch.entry import entry\n"
        "from kgl_gene_tpu_torch.analysis import lib_seqmutation as fam\n"
        "from kgl_gene_tpu_torch.genome.features import CodingSequenceValidity as V\n"
        "import kgl_gene_tpu_torch.ops.banded, kgl_gene_tpu_torch.ops.traceback\n"
        "import kgl_gene_tpu_torch.native, kgl_gene_tpu_torch.variant.columnar\n"
        "import kgl_gene_tpu_torch.variant.sort, kgl_gene_tpu_torch.stats.fws\n"
        "import kgl_gene_tpu_torch.stats.frequency\n"
        "from kgl_gene_tpu_torch.stats import inbreeding as inb\n"
        "from kgl_gene_tpu_torch.parallel import mesh\n"
        "import random\n"
        "import numpy as np\n"
        "from kgl_gene_tpu_torch.phylo import strom, partition, summary, codon\n"
        "from kgl_gene_tpu_torch.phylo import mcmc, tree as ptree, vmapped\n"
        "d = inb.synthetic_diploid_population(3, 200, [0.0, 0.5, 0.9], seed=1)\n"
        "assert inb.inbreeding_all(d, device='cpu')['Simple'].shape == (3,)\n"
        "assert mesh.sharded_allele_counts(d.zygosity, 'cpu').shape == (200,)\n"
        "tr = ptree.random_tree(['a', 'b', 'c', 'd'], random.Random(1))\n"
        "aln = np.random.default_rng(1).integers(0, 4, (4, 30)).astype(np.uint8)\n"
        "s = mcmc.MCMCSampler(aln, mcmc.ChainState(tr, mcmc.SubstitutionModel()),\n"
        "                     n_chains=2, device='cpu')\n"
        "assert len(s.run(4, sample_freq=2)) == 2\n"
        "assert vmapped.VmappedChains(tr, aln, 2, device='cpu').run(3).shape == (3,)\n"
        "step, args = entry(device='cpu')\n"
        "out = step(*args)\n"
        "assert out.distance.shape == (8,)\n"
        "recs = [fam.TranscriptMutateRecord(g, 'G', 'T', 0, s, V.VALID_PROTEIN)\n"
        "        for g, s in (('g1', 'ATGGCGTAA'), ('g2', 'ATGCATAA'))]\n"
        "a = fam.TranscriptFamilyAnalysis(recs, 'ATGGCATAA', device='cpu')\n"
        "assert a.reference_cigars() == {'ATGGCGTAA': '5M1X3M', 'ATGCATAA': '2M1D6M'}\n"
        "assert a.distance_tree_newick() == '(g2:1,g1:1):0;'\n"
        "import kgl_gene_tpu_torch.ontology.obographs, kgl_gene_tpu_torch.ontology.go_xml\n"
        "import kgl_gene_tpu_torch.ontology.set_similarity, kgl_gene_tpu_torch.ontology.enrichment\n"
        "import kgl_gene_tpu_torch.ontology.shared_information, kgl_gene_tpu_torch.io.gaf\n"
        "from kgl_gene_tpu_torch.ontology.database import OntologyDatabase\n"
        "from kgl_gene_tpu_torch.ontology.information import InformationContent\n"
        "from kgl_gene_tpu_torch.ops.similarity import lin_matrix_device\n"
        "import tempfile, os\n"
        "obo = os.path.join(tempfile.mkdtemp(), 'go.obo')\n"
        "open(obo, 'w').write('[Term]\\nid: GO:0008150\\nnamespace: biological_process\\n\\n'\n"
        "    '[Term]\\nid: GO:2\\nnamespace: biological_process\\nis_a: GO:0008150\\n')\n"
        "gaf = obo + '.gaf'\n"
        "open(gaf, 'w').write(''.join('\\t'.join(['D', g, g, '', go, 'r', 'IEA', '', 'P']\n"
        "                                           + [''] * 8) + '\\n'\n"
        "                              for g, go in (('g1', 'GO:2'), ('g2', 'GO:0008150'))))\n"
        "db = OntologyDatabase('t', obo, gaf)\n"
        "assert db.self_test()\n"
        "lin = lin_matrix_device(db.information, ['GO:2', 'GO:0008150'], device='cpu')\n"
        "assert lin.shape == (2, 2) and lin[0, 0] == 1.0\n"
        "import kgl_gene_tpu_torch.sequence.complexity, kgl_gene_tpu_torch.variant.vep\n"
        "import kgl_gene_tpu_torch.utils.date_time, kgl_gene_tpu_torch.utils.memory\n"
        "import kgl_gene_tpu_torch.utils.optimize, kgl_gene_tpu_torch.utils.percentile\n"
        "import kgl_gene_tpu_torch.utils.utility, kgl_gene_tpu_torch.utils.string_hash\n"
        "import kgl_gene_tpu_torch.io.checkpoint, kgl_gene_tpu_torch.ops.local\n"
        "from kgl_gene_tpu_torch.analysis.legacy import GenomicMutation, PloidyAnalysis\n"
        "from kgl_gene_tpu_torch.analysis.legacy import RNAAnalysis\n"
        "from kgl_gene_tpu_torch.classify import distance as dist\n"
        "from kgl_gene_tpu_torch.variant import filter as vfilter\n"
        "from kgl_gene_tpu_torch.variant.columnar import VariantMajorView\n"
        "from kgl_gene_tpu_torch.io.vcf import parse_vcf_population\n"
        "from kgl_gene_tpu_torch.io.synthetic import generate_population_files\n"
        "a = [np.array([0, 1, 2, 3, 0, 1], np.uint8), np.array([2, 3], np.uint8)]\n"
        "b = [np.array([1, 2, 3, 0], np.uint8), np.array([0, 2, 3, 1], np.uint8)]\n"
        "assert dist.batched_metric(dist.levenshtein_local_coding, a, b, device='cpu').tolist()"
        " == [0, 0]\n"
        "assert dist.batched_metric(dist.levenshtein_global_coding, a, b, device='cpu').tolist()"
        " == [2, 2]\n"
        "d = tempfile.mkdtemp()\n"
        "paths = generate_population_files(d, n_samples=4, contig_len=12_000, n_genes=1,\n"
        "                                  n_records=60, coding_len=300, seed=2, snp_only=False)\n"
        "ck = os.path.join(d, 'ck.json')\n"
        "pop, _, info = parse_vcf_population(paths.vcf, 'p', checkpoint_path=ck,\n"
        "                                    checkpoint_every=7)\n"
        "assert pop.variant_count() == parse_vcf_population(paths.vcf, 'p')[0].variant_count()\n"
        "assert not os.path.exists(ck) and not os.path.exists(ck + '.pop')\n"
        "snps = pop.view_filter(vfilter.SNPFilter() & vfilter.PassFilter())\n"
        "assert 0 < snps.variant_count() < pop.variant_count()\n"
        "ploidy = PloidyAnalysis()\n"
        "ploidy.add_population(VariantMajorView(pop))\n"
        "assert len(ploidy.genome_data) == pop.genome_count()\n"
        "xml = os.path.join(d, 'runtime.xml')\n"
        "open(xml, 'w').write(\n"
        "    '<runTime><executeList><active>p</active></executeList><packageList><package>'\n"
        "    '<packageIdent>p</packageIdent><resourceList><resourceIdent>g</resourceIdent>'\n"
        "    '</resourceList><iterationList><iteration><fileIdent>v</fileIdent></iteration>'\n"
        "    '</iterationList><analysisList><analysisIdent>NULL</analysisIdent>'\n"
        "    '<analysisIdent>INTERVAL</analysisIdent></analysisList></package></packageList>'\n"
        "    '<dataFileList><dataFile><fileIdent>v</fileIdent><fileName>' + paths.vcf +\n"
        "    '</fileName><parser>PF_DIPLOID</parser></dataFile></dataFileList><resourceList>'\n"
        "    '<resource><resourceType>GenomeDatabase</resourceType><resourceIdent>g'\n"
        "    '</resourceIdent><fastaFile>' + paths.fasta + '</fastaFile><gffFile>' +\n"
        "    paths.gff3 + '</gffFile></resource></resourceList></runTime>')\n"
        "work = os.path.join(d, 'work')\n"
        "assert exec_env.run_application(exec_env.GeneExecEnv, ['--optionFile', xml,\n"
        "    '--workDirectory', work, '--device', 'cpu']) == 0\n"
        "assert os.listdir(work) == ['interval_density.csv']\n"
        "assert len(open(os.path.join(work, 'interval_density.csv')).readlines()) == 1 + 12\n"
        "from kgl_gene_tpu_torch.parallel.dist import SampleMesh, run_ranks\n"
        "from kgl_gene_tpu_torch.parallel.mesh import sharded_pairwise_distances\n"
        "from kgl_gene_tpu_torch.ops.pipeline import make_multichip_step\n"
        "from kgl_gene_tpu_torch.ops.sharded_wavefront import sharded_levenshtein\n"
        "from kgl_gene_tpu_torch.entry import dryrun_multichip\n"
        "one = SampleMesh.single('cpu')\n"
        "assert sharded_levenshtein(np.array([[0, 1, 2, 3]]), [4], np.array([[0, 2, 3]]), [3],\n"
        "                           one, halo=2).tolist() == [1]\n"
        "assert sharded_pairwise_distances(np.array([[0, 1], [1, 1]]), [2, 2], one)[0, 1] == 1\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
