"""The port's native ingest (kgl_gene_tpu_torch/native, io/vcf.py's C++
record loop, io/streams.py's whole-file inflate) against the JAX package's
and against the port's own streaming Python record loop: populations
(incidence columns resolved through the arena, phases, FORMAT evidence),
INFO stores and BGZF bytes must be equal, for every parser type that has a
native mode, chunked and whole, plain and BGZF. Also the native library's
other functions against their numpy plain versions, and its build: into
the port's _build directory, by several processes at once, and raising
when the compiler fails."""

import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, "tests")
from fixtures import CONTIG_1, CONTIG_2, build_contig1, write_vcf  # noqa: E402

import kgl_gene_tpu.native as j_native  # noqa: E402
from kgl_gene_tpu.io.vcf import parse_vcf_population as j_parse  # noqa: E402
import kgl_gene_tpu_torch.native as t_native  # noqa: E402
from kgl_gene_tpu_torch.io.streams import BGZFReader, open_text_stream, write_bgzf  # noqa: E402
from kgl_gene_tpu_torch.io.synthetic import generate_scale_vcf  # noqa: E402
from kgl_gene_tpu_torch.io.vcf import parse_vcf_population as t_parse  # noqa: E402
from kgl_gene_tpu_torch.variant import columnar  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _population_snapshot(pop):
    """Per-(genome, contig) incidence tuples resolved through the arena, so
    two populations with different arenas compare equal (as
    tests/test_native_ingest.py builds them)."""
    out = {}
    arena = pop.arena
    for gid, genome in pop:
        for cid, contig in genome:
            cols = contig.columns()
            out[(gid, cid)] = [(
                arena.contig_name(arena.contigs[int(cols["row"][i])]),
                int(cols["offset"][i]),
                arena.ref_codes(int(cols["row"][i])).tobytes(),
                arena.alt_codes(int(cols["row"][i])).tobytes(),
                arena.identifier(int(cols["row"][i])),
                arena.info_row(int(cols["row"][i])),
                int(cols["phase"][i]),
                int(cols["ref_count"][i]),
                int(cols["alt_count"][i]),
                int(cols["dp_count"][i]),
                float(cols["gq_value"][i]),
                float(cols["quality"][i]),
                bool(cols["pass"][i]),
            ) for i in range(len(cols["row"]))]
    return out


def _same_info(got, want):
    assert got.count == want.count
    for fid in sorted(want.subscribed):
        assert got.has_field(fid) == want.has_field(fid), fid
        for r in range(want.count):
            a, b = got.value(fid, r), want.value(fid, r)
            if isinstance(b, float) and np.isnan(b):
                assert np.isnan(a), (fid, r)
            else:
                assert a == b, (fid, r, a, b)
        assert got.is_object_field(fid) == want.is_object_field(fid), fid


def _assert_parity(path, parser_type, subscribed=None, genome_name=None):
    """The port's native parse against its streaming parse and against the
    JAX package's native and streaming parses. Returns the port's native
    result."""
    kw = dict(subscribed_info=subscribed, genome_name=genome_name)
    native = t_parse(path, "pop", parser_type, use_native=True, **kw)
    snap = _population_snapshot(native[0])
    others = [t_parse(path, "pop", parser_type, use_native=False, **kw),
              j_parse(path, "pop", parser_type, use_native=True, **kw),
              j_parse(path, "pop", parser_type, use_native=False, **kw)]
    for pop, header, info in others:
        assert list(native[0].genome_map) == list(pop.genome_map)
        assert _population_snapshot(pop) == snap
        assert native[1].genome_names == header.genome_names
        _same_info(native[2], info)
    return native


def _edge_vcf(path):
    c1 = build_contig1()
    alt = "A" if c1[20] != "A" else "G"
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={CONTIG_1},length=400>\n")
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="g">\n')
        f.write('##FORMAT=<ID=AD,Number=R,Type=Integer,Description="d">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                "S1\tS2\tS3\tS4\tS5\n")
        f.write(f"{CONTIG_1}\t21\t.\t{c1[20]}\t{alt}\t50\tPASS\t.\tGT:AD\t"
                "1:5,5\t./.:9,0\t1/.:4,6\t1/1/1:2,8\t.|1:3,7\n")
        f.write(f"{CONTIG_1}\t31\t.\t{c1[30]}\t{alt},*\t50\tPASS\t.\tGT:AD\t"
                "1/2:5,5,2\t0/1:0,0,0\t2/2:5,0,4\t0/0:9,0,0\t1/1:0,8,0\n")
        f.write(f"{CONTIG_1}\t41\t.\t{c1[40]}\t{alt}\t.\t.\t.\tGT:AD\t"
                "x/1:5,5\t1/:3,3\t0|1:2,2\t.:4,0\t1|0:1,9\n")
        f.write("short\tline\n")
        f.write(f"{CONTIG_1}\tNOTANUMBER\t.\t{c1[20]}\t{alt}\t1\tPASS\t.\tGT:AD\t"
                "0/1:1,1\t0/1:1,1\t0/1:1,1\t0/1:1,1\t0/1:1,1\n")
    return path


def _phased_vcf(path):
    c1 = build_contig1()
    alt = "A" if c1[20] != "A" else "G"
    alt2 = "C" if c1[30] != "C" else "G"
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={CONTIG_1},length=400>\n")
        f.write('##INFO=<ID=AF,Number=A,Type=Float,Description="af">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tP1\tP2\tP3\n")
        f.write(f"{CONTIG_1}\t21\trs0\t{c1[20]}\t{alt}\t60\tPASS\tAF=0.5\tGT\t"
                "0|1\t1|1\t1|0\n")
        f.write(f"{CONTIG_1}\t31\trs1\t{c1[30]}\t{alt2}\t60\tPASS\tAF=0.2\tGT\t"
                "0/1\t.|1\t1\n")
        f.write(f"{CONTIG_1}\t41\trs2\t{c1[40]}\t{alt},*\t60\tq10\tAF=0.1,0.3\tGT\t"
                "1|2\t2|2\t0|0\n")
        f.write(f"{CONTIG_1}\t51\t.\t{c1[50]}\t{alt}\t9\tPASS\t.\tGT\t1\t0\t0|0\n")
    return path


def _mono_vcf(path):
    c1 = build_contig1()
    alts = [a for a in "ACGT" if a != c1[10]][:2]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={CONTIG_1},length=400>\n")
        f.write(f"##contig=<ID={CONTIG_2},length=300>\n")
        f.write('##INFO=<ID=AF,Number=A,Type=Float,Description="af">\n')
        f.write('##INFO=<ID=AC,Number=A,Type=Integer,Description="ac">\n')
        f.write('##INFO=<ID=AN,Number=1,Type=Integer,Description="an">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        f.write(f"{CONTIG_1}\t11\trs0\t{c1[10]}\t{','.join(alts)}\t99\tPASS\t"
                "AF=0.25,0.5;AC=3,6;AN=12\n")
        f.write(f"{CONTIG_1}\t16\trs1\t{c1[15]}\t{alts[0]},*\t50\tlow\t"
                "AF=0.2,0.1;AC=5,2;AN=.\n")
        f.write(f"{CONTIG_2}\t5\trs2\tACGT\tA\t12\tPASS\tAN=8\n")
    return path


def _vep_vcf(path, n_records=40):
    """gnomAD-style string and array INFO fields (CSQ-like vep, CLNSIG,
    per-allele AF and AC), some records without them."""
    rng = np.random.default_rng(5)
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write("##contig=<ID=chr21,length=100000>\n")
        f.write('##INFO=<ID=AF,Number=A,Type=Float,Description="af">\n')
        f.write('##INFO=<ID=AC,Number=A,Type=Integer,Description="ac">\n')
        f.write('##INFO=<ID=CLNSIG,Number=.,Type=String,Description="clinsig">\n')
        f.write('##INFO=<ID=vep,Number=.,Type=String,Description="VEP. Format: '
                'Allele|Consequence|IMPACT|Gene">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for r in range(n_records):
            info = []
            if r % 5 != 0:
                info.append(f"AF={rng.random():.4f},{rng.random():.4f}")
            if r % 3 != 0:
                info.append(f"AC={int(rng.integers(1, 50))},{int(rng.integers(1, 50))}")
            if r % 4 == 0:
                info.append("CLNSIG=Pathogenic,Benign")
            if r % 2 == 0:
                info.append(f"vep=A|missense_variant|MODERATE|GENE{r},"
                            f"A|intron_variant|LOW|GENE{r}")
            f.write(f"chr21\t{100 + r * 7}\trs{r}\tA\tG,T\t50\tPASS\t"
                    + (";".join(info) if info else ".") + "\n")
    return path


def _bgz(path):
    out = path + ".bgz"
    with open(path, "rb") as f:
        write_bgzf(out, f.read())
    return out


CASES = {
    # name: (writer, parser type, subscribed INFO, genome name)
    "pf_fixture": (lambda p: write_vcf(p), "PF_DIPLOID", ["AF", "DP", "VALIDATED"], None),
    "pf_edge_genotypes": (_edge_vcf, "PF_DIPLOID", None, None),
    "pf_scale": (lambda p: generate_scale_vcf(p, n_records=150, n_samples=16), "PF_DIPLOID",
                 ["AF"], None),
    "phased": (_phased_vcf, "PHASED_DIPLOID", ["AF"], None),
    "mono": (_mono_vcf, "MONO_GENOME", ["AF", "AC", "AN"], "gnomad_stats"),
    "mono_string_array_info": (_vep_vcf, "MONO_GENOME", ["AF", "AC", "CLNSIG", "vep"], None),
}


@pytest.mark.parametrize("container", ["plain", "bgzf"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_equals_streaming_and_jax(tmp_path, case, container):
    writer, parser_type, subscribed, genome_name = CASES[case]
    path = writer(str(tmp_path / f"{case}.vcf"))
    if container == "bgzf":
        path = _bgz(path)
    pop, _header, info = _assert_parity(path, parser_type, subscribed, genome_name)
    assert pop.variant_count() > 0
    assert info.count > 0


@pytest.mark.parametrize("chunk_bytes", ["16", "64", "200"])
@pytest.mark.parametrize("case", ["pf_fixture", "phased", "mono_string_array_info"])
def test_chunked_ingest_equals_whole(tmp_path, monkeypatch, case, chunk_bytes):
    """Chunks smaller than a record line or the header: carry, merge and
    record rebasing give the whole-file result and the JAX package's
    chunked result."""
    writer, parser_type, subscribed, genome_name = CASES[case]
    path = writer(str(tmp_path / f"{case}.vcf"))
    kw = dict(subscribed_info=subscribed, genome_name=genome_name, use_native=True)
    whole = t_parse(path, "pop", parser_type, **kw)
    monkeypatch.setenv("KGT_NATIVE_INGEST_CHUNK_BYTES", chunk_bytes)
    chunked = t_parse(path, "pop", parser_type, **kw)
    j_chunked = j_parse(path, "pop", parser_type, **kw)
    for pop, header, info in (chunked, j_chunked):
        assert _population_snapshot(pop) == _population_snapshot(whole[0])
        assert header.genome_names == whole[1].genome_names
        _same_info(info, whole[2])


def test_default_route_is_native_and_env_turns_it_off(tmp_path, monkeypatch):
    """use_native=None takes the C++ loop for a native parser type (its log
    line says so) and the streaming loop under KGT_DISABLE_NATIVE_INGEST."""
    import kgl_gene_tpu_torch.io.vcf as t_vcf

    path = write_vcf(str(tmp_path / "pf.vcf"))
    calls = []
    real = t_vcf._native_parse_population
    monkeypatch.setattr(t_vcf, "_native_parse_population",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    t_parse(path, "pop", "PF_DIPLOID")
    assert len(calls) == 1
    t_parse(path, "pop", "GNOMAD_DIPLOID")  # no native mode: the streaming loop
    monkeypatch.setenv("KGT_DISABLE_NATIVE_INGEST", "1")
    t_parse(path, "pop", "PF_DIPLOID")
    assert len(calls) == 1


def test_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        t_parse(str(tmp_path / "none.vcf.bgz"), "pop", "PF_DIPLOID", use_native=True)


def _bgzf_lines(tmp_path, n_lines):
    data = b"".join(
        f"chr{1 + i % 3}\t{100 + i}\trs{i}\tA\tG\t50\tPASS\tAF=0.{i % 10}\n".encode()
        for i in range(n_lines))
    path = str(tmp_path / "s.vcf.bgz")
    write_bgzf(path, data)
    return path, data


@pytest.mark.parametrize("slab_bytes", [2048, 4096, 24 << 20])
def test_bgzf_stream_equals_python_reader(tmp_path, slab_bytes):
    path, data = _bgzf_lines(tmp_path, 20000)
    with t_native.NativeBGZFStream(path, slab_bytes=slab_bytes, verify=True) as s:
        out = s.read(-1)
    with BGZFReader(path) as r:
        assert r.read(-1) == out == data
    with j_native.NativeBGZFStream(path, slab_bytes=slab_bytes) as s:
        assert s.read(-1) == data
    buf, got = bytearray(1009), bytearray()  # odd size: spans slab boundaries
    with t_native.NativeBGZFStream(path, slab_bytes=slab_bytes) as s:
        while n := s.readinto(buf):
            got += buf[:n]
    assert bytes(got) == data


def test_bgzf_whole_file_inflate(tmp_path):
    path, data = _bgzf_lines(tmp_path, 5000)
    assert t_native.bgzf_decompress(path) == data == j_native.bgzf_decompress(path)
    with open_text_stream(path) as text:
        assert text.read() == data.decode()


def test_corrupt_bgzf_raises(tmp_path):
    path, _data = _bgzf_lines(tmp_path, 4000)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    bad = str(tmp_path / "bad.bgz")
    with open(bad, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(OSError):
        with t_native.NativeBGZFStream(bad, slab_bytes=4096) as s:
            s.read(-1)
    with pytest.raises(OSError):
        t_native.bgzf_decompress(bad)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_parse_genotypes_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n, n_alleles = 50, 2
    cells = []
    for _ in range(n):
        a, b = rng.integers(-1, n_alleles + 1, 2)
        gt = f"{'.' if a < 0 else a}{'|' if rng.random() < 0.3 else '/'}{'.' if b < 0 else b}"
        ad = ",".join(str(int(x)) for x in rng.integers(0, 30, n_alleles + 1))
        cells.append(f"{gt}:{ad}:{int(rng.integers(0, 90))}:{rng.random() * 99:.2f}")
    text = "\t".join(cells).encode()
    got = t_native.parse_genotypes(text, n, n_alleles, 0, 1, 2, 3)
    want = j_native.parse_genotypes(text, n, n_alleles, 0, 1, 2, 3)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


def _populations(tmp_path):
    """Two port populations with many (genome, contig) parts: the fixture
    VCF and a synthetic scale VCF."""
    return [t_parse(write_vcf(str(tmp_path / "pop.vcf")), "pop", "PF_DIPLOID")[0],
            t_parse(generate_scale_vcf(str(tmp_path / "s.vcf"), n_records=300, n_samples=24),
                    "s", "PF_DIPLOID")[0]]


def _parts(pop):
    genome_ids = sorted(pop.genome_map)
    return [(g, np.ascontiguousarray(c.incidence_rows(), np.int32))
            for g, gid in enumerate(genome_ids)
            for c in pop.genome_map[gid].contig_map.values() if len(c.incidence_rows())]


def test_mark_presence_and_csr_build_equal_plain(tmp_path):
    for pop in _populations(tmp_path):
        parts = _parts(pop)
        arena = pop.arena
        present = t_native.mark_presence(parts, len(arena))
        np.testing.assert_array_equal(present, columnar.presence_plain(parts, len(arena)))
        rows = np.nonzero(present)[0]
        rows = rows[np.lexsort((arena.offsets[rows], arena.contigs[rows]))]
        rank = np.zeros(len(arena), np.int32)
        rank[rows] = np.arange(len(rows), dtype=np.int32)
        n_g = len(pop.genome_map)
        total = sum(len(r) for _g, r in parts)
        got = t_native.csr_build(parts, rank, n_g, len(rows) * n_g, total)
        want = columnar.csr_triples_plain(parts, rank, n_g, len(rows) * n_g, total)
        j_got = j_native.csr_build(parts, rank, n_g, len(rows) * n_g, total)
        for g, w, j in zip(got, want, j_got, strict=True):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, j)


@pytest.mark.parametrize("n_parts", [1, 7, 300])
def test_csr_build_radix_passes_equal_plain(n_parts):
    """Keys whose high bytes are constant (the radix pass skip) and keys
    that fill every byte, over one part and many (one worker's share of a
    bucket below n, the sum over workers equal to n)."""
    rng = np.random.default_rng(n_parts)
    for n_v, n_g in ((50, 3), (40_000, 3_000)):
        parts = [(int(rng.integers(0, n_g)),
                  rng.integers(0, n_v, int(rng.integers(1, 400))).astype(np.int32))
                 for _ in range(n_parts)]
        rank = rng.permutation(n_v).astype(np.int32)
        total = sum(len(r) for _g, r in parts)
        got = t_native.csr_build(parts, rank, n_g, n_v * n_g, total)
        want = columnar.csr_triples_plain(parts, rank, n_g, n_v * n_g, total)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)


def test_mark_presence_rejects_rows_outside_the_arena():
    with pytest.raises(ValueError):
        t_native.mark_presence([(0, np.array([0, 5], np.int32))], 5)


def test_library_builds_into_the_port_build_dir():
    t_native.library()
    assert t_native.LIB_PATH.parent.name == "_build"
    assert t_native.LIB_PATH.parent.parent.name == "kgl_gene_tpu_torch"
    assert t_native.LIB_PATH.stat().st_mtime >= t_native.SOURCE.stat().st_mtime
    assert t_native.native_available()


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(t_native, "LIB_PATH", tmp_path / "libkgt_native.so")
    monkeypatch.setattr(t_native, "CXX", ("sh", "-c", "echo no compiler here >&2; exit 1", "cxx"))
    monkeypatch.setattr(t_native, "_lib", None)
    with pytest.raises(RuntimeError, match="no compiler here"):
        t_native.build()
    with pytest.raises(RuntimeError, match="no compiler here"):
        t_parse(write_vcf(str(tmp_path / "pop.vcf")), "pop", "PF_DIPLOID")
    assert not os.path.exists(tmp_path / "libkgt_native.so")
    assert os.listdir(tmp_path) == ["pop.vcf"]  # no temporary left behind


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    """Processes that build into one empty directory at the same moment
    each load a library: the build writes a name of its own and renames."""
    code = (
        "import sys, ctypes, pathlib\n"
        "import kgl_gene_tpu_torch.native as n\n"
        "n.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "n.LIB_PATH = n.BUILD_DIR / 'libkgt_native.so'\n"
        "lib = n.library()\n"
        "print(lib.kgt_count_lines(b'a\\nb\\n', 4))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        assert out.strip() == "2"
    assert sorted(os.listdir(tmp_path)) == ["libkgt_native.so"]
