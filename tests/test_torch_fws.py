"""The PfEMP statistics over resident codes (stats/fws.py fws_statistics,
analysis/pfemp_analysis.py prepare and statistics) on the CPU, at a small
size of the Pf7 shape: 44 genomes (4 failing QC, 20 monoclonal) x 3,000
records over 3 contigs, held against the port's host CalcFWS, the JAX
package's CalcFWS (numpy, on the same view) and the benchmark's float64
reference (port_bench/reference/fws.py), for both subsets the analysis
takes: QC pass, and QC pass and monoclonal.

Designed records put a variant's AF exactly on the bin edges 0.05, 0.5 and
1.0 in a subset, give one genome nothing but a variant at AF 1 (hs_sum 0,
FWS 1), and leave variants that neither subset carries. Counts (per
variant, per genome, per bin) are exact; FWS lies within 1e-12 of each,
the hs sums being float64 taken in another order.

Kernels `fws_variants` and `fws_genomes` (csrc/fws.cu) cannot run here:
their passes are mirrored in numpy (fws_kernel_mirror) and held against
the plain versions. Change the mirror with the kernels.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kgl_gene_tpu.stats.fws import CalcFWS as JFws
from kgl_gene_tpu_torch.analysis import inbreed_analysis
from kgl_gene_tpu_torch.analysis.inbreed_analysis import InbreedAnalysis, InbreedColumns
from kgl_gene_tpu_torch.analysis.pfemp_analysis import FwsColumns, PfEMPAnalysis
from kgl_gene_tpu_torch.app.resources import AnalysisResources, ResourceType
from kgl_gene_tpu_torch.app.runtime import ParameterMap
from kgl_gene_tpu_torch.genome.genome import GenomeReference
from kgl_gene_tpu_torch.io.resource_parsers import (
    Pf7FwsResource, Pf7SampleRecord, Pf7SampleResource,
)
from kgl_gene_tpu_torch.io.vcf import parse_vcf_population
from kgl_gene_tpu_torch.stats import fws
from kgl_gene_tpu_torch.variant import columnar
from kgl_gene_tpu_torch.variant.columnar import ROW_ALIGN, VariantMajorCSR, VariantMajorView
from port_bench.reference import fws as reference

G, QC_FAIL, MONO = 44, range(40, 44), range(0, 20)
ZERO_HS = 38  # carries only the variant at AF 1
CONTIGS = ("Pf3D7_01_v3", "Pf3D7_02_v3", "Pf3D7_03_v3")
PER_CONTIG = 1000
ATOL = 1e-12
SOURCE = Path(fws.__file__).resolve().parent.parent / "csrc" / "fws.cu"
IDS = [f"S{g:02d}" for g in range(G)]


def _codes(seed=3):
    """(V, G) codes 0/1/2 of the records: drawn rows (AF ** 3 of a uniform,
    monoclonal genomes homozygous but for a 2% error, ZERO_HS none), then
    the designed rows over the first six."""
    rng = np.random.default_rng(seed)
    V = PER_CONTIG * len(CONTIGS)
    p = rng.random(V)[:, None] ** 3
    first = rng.random((V, G)) < p
    second = rng.random((V, G)) < p
    mono = np.zeros(G, bool)
    mono[list(MONO)] = True
    second = np.where(mono, first, second)
    z = first.astype(np.uint8) + second
    z[(z == 2) & mono & (rng.random((V, G)) < 0.02)] = 1
    z[:, ZERO_HS] = 0
    z[:6] = 0
    z[0, [20, 21]] = 2                         # QC: 4 of 80 alleles, AF 0.05; monoclonal: none
    z[1, :38] = 1
    z[1, 39] = 2                               # QC: 40 of 80, AF 0.5; monoclonal: 20 of 40, 0.5
    z[2, :] = 2                                # AF 1 in both: hs 0
    z[3, [0, 1]] = 1                           # monoclonal: 2 of 40, AF 0.05
    z[4, 41] = 2                               # carried by a genome failing QC alone
    z[5, [25, 26, 27]] = 1                     # QC: 3 of 80; not monoclonal
    return z


def _write_vcf(path, z):
    gts = np.array(["0|0", "0|1", "1|1"])
    with open(path, "w") as out:
        out.write("##fileformat=VCFv4.2\n")
        for contig in CONTIGS:
            out.write(f"##contig=<ID={contig},length=3000000>\n")
        out.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="gt">\n')
        out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  + "\t".join(IDS) + "\n")
        for c, contig in enumerate(CONTIGS):
            for k in range(PER_CONTIG):
                row = z[c * PER_CONTIG + k]
                out.write(f"{contig}\t{100 + 7 * k}\t.\tA\tG\t50\tPASS\t.\tGT\t"
                          + "\t".join(gts[row]) + "\n")
    return path


@pytest.fixture(scope="module")
def population(tmp_path_factory):
    path = _write_vcf(str(tmp_path_factory.mktemp("pf7") / "pop.vcf"), _codes())
    pop, _header, _store = parse_vcf_population(path, "pf7", "PHASED_DIPLOID")
    return pop


def _resources(monoclonal):
    samples = Pf7SampleResource("Pf7Sample", [
        Pf7SampleRecord(gid, qc_pass="False" if g in QC_FAIL else "True")
        for g, gid in enumerate(IDS)])
    res = AnalysisResources()
    res.add_resource(ResourceType.GENOME_DATABASE, "Pf3D7", GenomeReference("Pf3D7"))
    res.add_resource(ResourceType.PF7_SAMPLE, "Pf7Sample", samples)
    if monoclonal:
        res.add_resource(ResourceType.PF7_FWS, "Pf7Fws", Pf7FwsResource("Pf7Fws", {
            gid: 0.99 if g in MONO or g == 40 else 0.5 for g, gid in enumerate(IDS)}))
    return res


def _analysis(work, monoclonal):
    analysis = PfEMPAnalysis("cpu")
    assert analysis.initialize_analysis(str(work), [], _resources(monoclonal))
    return analysis


@pytest.fixture(scope="module")
def columns(population):
    return PfEMPAnalysis("cpu").prepare(population)


SUBSETS = [False, True]


@pytest.mark.parametrize("monoclonal", SUBSETS, ids=["qc", "qc_monoclonal"])
def test_device_path_equals_calcfws_jax_and_the_reference(population, columns, monoclonal,
                                                          tmp_path):
    analysis = _analysis(tmp_path, monoclonal)
    got = analysis.statistics(columns)
    ids = [columns.genome_ids[g] for g in got.index]
    view = VariantMajorView(analysis._qc_filter(population))
    assert ids == view.genome_ids and len(ids) == (20 if monoclonal else 40)
    carried = got.carried()
    assert len(carried) == view.variant_count < columns.codes.shape[0]
    host, jax_calc = fws.CalcFWS(view), JFws(view)
    for calc in (host, jax_calc):
        results = [calc.genome_map[gid] for gid in ids]
        np.testing.assert_array_equal(
            got.het_bins, [[b.heterozygous for b in r.bins] for r in results])
        np.testing.assert_array_equal(
            got.hom_bins, [[b.homozygous for b in r.bins] for r in results])
        np.testing.assert_allclose(got.fws, [r.fws for r in results], rtol=0, atol=ATOL)
    het, hom = view.het_hom_by_genome()
    np.testing.assert_array_equal(got.het, het)
    np.testing.assert_array_equal(got.hom, hom)
    np.testing.assert_array_equal(got.variant_counts[:, carried],
                                  [host.variant_het, host.variant_hom])
    assert {k: vars(v) for k, v in host.variant_map.items()} == {
        k: vars(v) for k, v in jax_calc.variant_map.items()}

    want = reference.statistics(columns.codes, got.index)
    np.testing.assert_array_equal(got.variant_counts,
                                  torch.stack([want["variant_het"], want["variant_hom"]]))
    for name in ("het_bins", "hom_bins", "het", "hom"):
        np.testing.assert_array_equal(getattr(got, name), want[name].numpy(), err_msg=name)
    np.testing.assert_allclose(got.hs_sum, want["hs_sum"], rtol=1e-14, atol=0)
    np.testing.assert_allclose(got.fws, want["fws"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("monoclonal", SUBSETS, ids=["qc", "qc_monoclonal"])
def test_the_designed_edges_zero_hs_and_uncarried_variants(columns, monoclonal, tmp_path):
    got = _analysis(tmp_path, monoclonal).statistics(columns)
    want = reference.statistics(columns.codes, got.index)
    af = want["af"].numpy()
    # the designed records are the first six resident variants (each carried by someone)
    edges = {0: 0.05, 1: 0.5, 2: 1.0} if not monoclonal else {1: 0.5, 2: 1.0, 3: 0.05}
    for v, edge in edges.items():
        assert af[v] == edge
        assert want["bins"][v] == min(int(round(edge / 0.05)), 10)  # lo <= AF: the upper bin
    assert got.variant_counts[:, 4].tolist() == [0, 0]  # a genome failing QC alone
    if monoclonal:
        assert got.variant_counts[:, 0].tolist() == [0, 0]
        assert got.variant_counts[:, 5].tolist() == [0, 0]
    assert 4 not in got.carried()
    holders = got.het_bins.sum(0) + got.hom_bins.sum(0)
    assert holders[1] and holders[10]  # the 0.05 and 0.5 edges' variants counted in the upper bins
    if not monoclonal:
        g = list(got.index).index(ZERO_HS)
        assert got.hs_sum[g] == 0.0 and got.fws[g] == 1.0 and got.het[g] == 0
        assert got.hom[g] == 1


def test_a_bin_edge_taken_as_at_or_below_moves_counts(columns, tmp_path, monkeypatch):
    analysis = _analysis(tmp_path, False)
    right = analysis.statistics(columns)
    edges = torch.tensor(fws._LOWER_EDGES, dtype=torch.float64)
    monkeypatch.setattr(fws, "frequency_bins", lambda af: torch.bucketize(af, edges))
    wrong = analysis.statistics(columns)
    assert (wrong.het_bins != right.het_bins).any() or (wrong.hom_bins != right.hom_bins).any()


def test_file_read_analysis_writes_the_csvs_as_before_without_a_view(population, tmp_path,
                                                                     monkeypatch):
    """The two CSVs as the analysis wrote them through VariantMajorView and
    CalcFWS, byte for byte, with no view built."""
    before, after = tmp_path / "before", tmp_path / "after"
    before.mkdir()
    after.mkdir()
    analysis = _analysis(before, True)
    view = VariantMajorView(analysis._qc_filter(population))
    het, hom = view.het_hom_by_genome()
    with open(before / "pfemp_zygosity.csv", "w") as f:
        f.write("Genome,Heterozygous,Homozygous\n")
        for i, genome_id in enumerate(view.genome_ids):
            f.write(f"{genome_id},{int(het[i])},{int(hom[i])}\n")
    fws.CalcFWS(view).write_genome_results(str(before / "pfemp_fws.csv"),
                                           fws_resource=analysis.pf7_fws.fws_map)

    def no_view(*_args, **_kwargs):
        raise AssertionError("the statistics stage built a VariantMajorView")

    monkeypatch.setattr(columnar.VariantMajorView, "__init__", no_view)
    assert _analysis(after, True).file_read_analysis(population)
    for name in ("pfemp_zygosity.csv", "pfemp_fws.csv"):
        assert (after / name).read_bytes() == (before / name).read_bytes(), name


@pytest.mark.parametrize("monoclonal", SUBSETS, ids=["qc", "qc_monoclonal"])
def test_file_read_analysis_holds_only_the_kept_genomes(population, tmp_path, monoclonal):
    """file_read_analysis prepares the filtered population: the genomes
    resident on the device are those the Pf7 filters keep, the same set as
    _qc_filter's view and genome_index's over every genome."""
    analysis = _analysis(tmp_path, monoclonal)
    prepared = []
    prepare = analysis.prepare
    analysis.prepare = lambda pop: prepared.append(prepare(pop)) or prepared[-1]
    assert analysis.file_read_analysis(population)
    (held,) = prepared
    kept = sorted(analysis._qc_filter(population).genome_map)
    assert held.genome_ids == kept and held.codes.shape[1] == len(kept)
    assert len(kept) == (20 if monoclonal else 40)
    everyone = sorted(population.genome_map)
    assert [everyone[g] for g in analysis.genome_index(everyone)] == kept


def test_columns_handed_in_directly_give_the_same_statistics(columns, tmp_path):
    analysis = _analysis(tmp_path, True)
    dense = columns.codes.contiguous().numpy()  # rows not ROW_ALIGN apart: copied
    handed = analysis.prepare_columns(dense, columns.genome_ids)
    assert handed.codes.stride(0) % ROW_ALIGN == 0
    a, b = analysis.statistics(columns), analysis.statistics(handed)
    for name in ("index", "het_bins", "hom_bins", "hs_sum", "fws", "variant_counts"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    with pytest.raises(ValueError):
        FwsColumns.on_device(dense, columns.genome_ids[:-1], "cpu")


def test_counters_and_spans_of_a_call(columns, tmp_path):
    analysis = _analysis(tmp_path, True)
    before = dict(fws.COUNTERS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = analysis.statistics(columns)
    counted = {k: n - before.get(k, 0) for k, n in fws.COUNTERS.items()}
    V, G_all = columns.codes.shape
    assert counted == {"genomes": len(got.index), "variants": V, "passes": 2,
                       "code_bytes": 2 * V * G_all}
    names = {e.name for e in prof.events()}
    assert {"kgt.fws", "kgt.fws.upload", "kgt.fws.variants", "kgt.fws.genomes",
            "kgt.fws.fetch"} <= names


def test_the_reference_in_float32_misses_the_fws_limit_and_keeps_the_counts(columns):
    index = np.arange(40)
    exact = reference.statistics(columns.codes, index)
    low = reference.statistics(columns.codes, index, dtype=torch.float32)
    for name in ("variant_het", "variant_hom", "het_bins", "hom_bins", "bins"):
        assert torch.equal(exact[name], low[name]), name
    gap = (exact["fws"] - low["fws"].double()).abs().max().item()
    assert gap > 1e-11  # the cell's fws_gap limit


def test_an_empty_subset_and_an_empty_population(columns, tmp_path, population):
    got = fws.fws_statistics(columns.codes, np.zeros(0, dtype=np.int64))
    assert got.fws.shape == (0,) and not got.variant_counts.any() and not len(got.carried())
    empty = population.view_filter(type("NoGenome", (), {
        "apply_population": lambda self, pop: type(pop)(pop.population_id, pop.data_source,
                                                        pop.arena)})())
    analysis = _analysis(tmp_path, False)
    assert analysis.prepare(empty) is None
    assert analysis.file_read_analysis(empty)
    assert (tmp_path / "pfemp_zygosity.csv").read_text() == "Genome,Heterozygous,Homozygous\n"
    assert not (tmp_path / "pfemp_fws.csv").exists()


# --------------------------------------------------------------------------- #
# The kernels' passes, mirrored
# --------------------------------------------------------------------------- #
def _constants():
    return {k: int(v) for k, v in re.findall(r"constexpr int (F[VG]_\w+) = ([\w *]+?);",
                                             SOURCE.read_text()) if v.isdigit()}


def fws_kernel_mirror(codes, mask, order, hs, bounds, width):
    """Kernel `fws_variants`' counts (2, V) and `fws_genomes`' partials of
    csrc/fws.cu: a row's 16-byte chunks of codes ANDed with the mask's and
    counted by popcount over the two class bits; a segment's rows taken in
    batches of FG_BATCH, a genome's codes 1 and 2 counted in byte lanes of a
    word across a batch and widened after it, its hs added in row order."""
    k = _constants()
    V, G = codes.shape
    chunks = -(-G // 16)
    rows = np.zeros((V, chunks * 16), dtype=np.uint8)
    rows[:, :G] = codes
    m = np.zeros(chunks * 16, dtype=np.uint8)
    m[:len(mask)] = mask[:chunks * 16]
    words = rows.view("<u4")
    mw = m.view("<u4")
    b0, b1 = words & mw, (words >> 1) & mw
    popc = np.vectorize(lambda x: bin(int(x)).count("1"), otypes=[np.int64])
    counts = np.stack([popc(b0 & ~b1).sum(1), popc(b1 & ~b0).sum(1)]).astype(np.int32)

    S = len(bounds) - 1
    het = np.zeros((S, width), dtype=np.int32)
    hom = np.zeros((S, width), dtype=np.int32)
    acc = np.zeros((S, width), dtype=np.float64)
    padded = np.zeros((V, width), dtype=np.uint8)
    padded[:, :G] = codes
    for s in range(S):
        for b in range(bounds[s], bounds[s + 1], k["FG_BATCH"]):
            batch = order[b:min(b + k["FG_BATCH"], bounds[s + 1])]
            w = padded[batch].view("<u4")  # (n, width / 4): byte lanes
            one = (w & 0x01010101) & ~((w >> 1) & 0x01010101)
            two = ((w >> 1) & 0x01010101) & ~(w & 0x01010101)
            lanes_one = one.sum(0, dtype=np.uint32)  # under 256 a lane: no carry
            lanes_two = two.sum(0, dtype=np.uint32)
            het[s] += lanes_one.view(np.uint8).astype(np.int32)
            hom[s] += lanes_two.view(np.uint8).astype(np.int32)
            carried = (padded[batch] == 1) | (padded[batch] == 2)
            for i, r in enumerate(range(b, b + len(batch))):
                acc[s] = np.where(carried[i], acc[s] + hs[r], acc[s])
    return counts, het, hom, acc


def test_the_kernel_constants_match_the_python_side():
    k = _constants()
    assert k["FG_THREADS"] * k["FG_VEC"] == fws.GENOME_TILE
    assert k["FG_BATCH"] < 256 and k["FG_BATCH"] % k["FG_ROWS"] == 0


@pytest.mark.parametrize("genomes,variants", [(44, 3000), (17, 1), (1, 900), (40, 9000)])
def test_the_kernel_mirror_equals_the_plain_versions(genomes, variants):
    rng = np.random.default_rng(genomes * 7 + variants)
    z = rng.choice(4, size=(variants, genomes), p=[0.6, 0.2, 0.15, 0.05]).astype(np.uint8)
    codes = columnar.resident_codes(variants, genomes, "cpu")
    codes[:] = torch.from_numpy(z)
    width = -(-genomes // fws.GENOME_TILE) * fws.GENOME_TILE
    keep = rng.random(genomes) < 0.6
    mask = torch.zeros(width, dtype=torch.uint8)
    mask[:genomes] = torch.from_numpy(keep.astype(np.uint8))
    counts = fws._variant_counts(codes, mask)
    af = (counts[0] + 2 * counts[1].long()).double() / max(2 * int(keep.sum()), 1)
    hs = 2.0 * af * (1.0 - af)
    order, bounds, _bins = fws.segment_bounds(fws.frequency_bins(af))
    het, hom, acc = fws._genome_partials(codes, order, hs[order], bounds, width)
    m_counts, m_het, m_hom, m_acc = fws_kernel_mirror(
        z, mask.numpy(), order.numpy(), hs[order].numpy(), bounds.tolist(), width)
    np.testing.assert_array_equal(counts.numpy(), m_counts)
    np.testing.assert_array_equal(het.numpy()[:, :genomes], m_het[:, :genomes])
    np.testing.assert_array_equal(hom.numpy()[:, :genomes], m_hom[:, :genomes])
    np.testing.assert_allclose(acc.numpy()[:, :genomes], m_acc[:, :genomes], rtol=1e-13, atol=0)


def test_segments_lie_inside_one_bin_each():
    rng = np.random.default_rng(1)
    for V in (0, 1, 5000, 3 * fws.SEGMENT_ROWS + 7):
        bins = torch.from_numpy(rng.integers(0, fws.N_BINS, V))
        order, bounds, seg_bins = fws.segment_bounds(bins)
        b = bounds.tolist()
        assert b[0] == 0 and b[-1] == V and b == sorted(b)
        assert len(b) - 1 == max(1, min(fws.SEGMENTS, V // fws.SEGMENT_ROWS)) + fws.N_BINS - 1
        sorted_bins = bins[order]
        for s in range(len(b) - 1):
            assert (sorted_bins[b[s]:b[s + 1]] == seg_bins[s]).all()


# --------------------------------------------------------------------------- #
# INBREED through the shared VariantMajorCSR.device_codes
# --------------------------------------------------------------------------- #
def test_inbreed_resident_codes_and_f_are_as_before(population, monkeypatch):
    """VariantMajorCSR.device_codes, shared with PfEMP, gives INBREED the
    codes its own block loop gave (a contiguous (V, G) tensor) and the same
    F, bit for bit."""
    monkeypatch.setattr(inbreed_analysis, "PREPARE_BLOCK_VARIANTS", 256)
    columns = InbreedColumns.from_population(population, "cpu")
    csr = VariantMajorCSR(population)
    V, G_all = csr.variant_count, csr.genome_count
    before = torch.empty((V, G_all), dtype=torch.uint8)
    for v_lo in range(0, V, 256):
        v_hi = min(v_lo + 256, V)
        before[v_lo:v_hi] = torch.from_numpy(csr.dense_block_t(v_lo, v_hi))
    assert torch.equal(columns.codes, before)
    assert columns.codes.stride(0) % ROW_ALIGN == 0
    old = InbreedColumns.on_device(before, columns.offsets, columns.contig_index,
                                   columns.is_snp, columns.genome_ids, {}, "cpu")
    analysis = InbreedAnalysis("cpu")
    block = ParameterMap("INBREED", {"MinAF": ["0.05"], "SamplingDistance": ["20"]})
    assert analysis.initialize_analysis(".", [block], None)
    a, b = analysis.estimate(columns, "ALL"), analysis.estimate(old, "ALL")
    np.testing.assert_array_equal(a.loci, b.loci)
    np.testing.assert_array_equal(a.f, b.f)
    assert len(a.loci) > 100
