"""The ingest checkpoints of the port (kgl_gene_tpu_torch/utils/
string_hash.py, io/checkpoint.py and the cursor of io/vcf.py) against the
JAX package's: hash equality, the cursor's and the snapshot's round trips,
an interrupted ingest resumed to the identical population and InfoStore
(the oracle is tests/test_aux_subsystems.py::TestIngestResume), a
fingerprint mismatch that restarts, a snapshot written by the JAX package
refused (with the JAX package unimportable too) and the ingest restarted,
and the cursor equal to the JAX package's, field by field, after the same
records of the same VCF."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, "tests")
from fixtures import write_vcf  # noqa: E402
from test_torch_ingest import assert_same_population  # noqa: E402

import kgl_gene_tpu.variant.db as jdb  # noqa: E402
import kgl_gene_tpu_torch.variant.db as tdb  # noqa: E402
from kgl_gene_tpu.io import checkpoint as jck  # noqa: E402
from kgl_gene_tpu.io.vcf import parse_vcf_population as j_parse  # noqa: E402
from kgl_gene_tpu.utils.string_hash import combine_hash as j_combine  # noqa: E402
from kgl_gene_tpu.utils.string_hash import string_hash as j_hash  # noqa: E402
from kgl_gene_tpu_torch.io import checkpoint as tck  # noqa: E402
from kgl_gene_tpu_torch.io.synthetic import generate_population_files  # noqa: E402
from kgl_gene_tpu_torch.io.vcf import parse_vcf_population as t_parse  # noqa: E402
from kgl_gene_tpu_torch.utils.string_hash import combine_hash, string_hash  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def assert_same_info(j, t):
    assert t.count == j.count
    assert t.subscribed == j.subscribed
    for fid in sorted(j.subscribed):
        for row in range(j.count):
            jv, tv = j.value(fid, row), t.value(fid, row)
            if isinstance(jv, float) and np.isnan(jv):
                assert np.isnan(tv), (fid, row)
            else:
                assert tv == jv, (fid, row)


class Crash:
    """Makes a package's ContigDB.add_incidence raise after `after` calls,
    as a parser that fails mid-file."""

    def __init__(self, monkeypatch, db_module, after):
        real = db_module.ContigDB.add_incidence
        calls = {"n": 0}

        def crashing(self_, *args, **kwargs):
            calls["n"] += 1
            if calls["n"] > after:
                raise RuntimeError("simulated ingest crash")
            return real(self_, *args, **kwargs)

        self.undo = lambda: monkeypatch.setattr(db_module.ContigDB, "add_incidence", real)
        monkeypatch.setattr(db_module.ContigDB, "add_incidence", crashing)


@pytest.fixture(scope="module")
def vcf(tmp_path_factory):
    return write_vcf(str(tmp_path_factory.mktemp("ck") / "pop.vcf"))


@pytest.fixture(scope="module")
def synthetic_vcf(tmp_path_factory):
    return generate_population_files(
        str(tmp_path_factory.mktemp("cks")), n_samples=12, contig_len=24_000, n_genes=2,
        n_records=600, coding_len=300, seed=3, snp_only=False).vcf


@pytest.mark.parametrize("text", ["", "GENE1", "GENE2", "chr1:100:A:T:0/1", "x" * 1000,
                                  "Pf3D7_01_v3:12345:ACGT:A,AC:0/0\t1/1", "é中"])
def test_string_hash_equal(text):
    assert string_hash(text) == j_hash(text)
    assert 0 <= string_hash(text) < 2 ** 32


def test_combine_hash_equal():
    rng = np.random.default_rng(0)
    seed_j = seed_t = 0
    for v in rng.integers(0, 2 ** 32, 500, dtype=np.uint64):
        seed_j, seed_t = j_combine(seed_j, int(v)), combine_hash(seed_t, int(v))
        assert seed_t == seed_j
    assert combine_hash(string_hash("a"), string_hash("b")) != combine_hash(
        string_hash("b"), string_hash("a"))


def test_cursor_round_trip(tmp_path):
    cursor, jcursor = tck.IngestCursor("pop.vcf"), jck.IngestCursor("pop.vcf")
    for key, n in (("chr1:100", 3), ("chr1:200", 2)):
        cursor.advance(key, n)
        jcursor.advance(key, n)
    path, jpath = str(tmp_path / "c.json"), str(tmp_path / "j.json")
    cursor.save(path)
    jcursor.save(jpath)
    assert json.load(open(path)) == json.load(open(jpath))
    loaded = tck.IngestCursor.load(path)
    assert loaded == cursor
    assert loaded.should_skip(2) and not loaded.should_skip(3)
    assert tck.IngestCursor.load(jpath) == cursor  # the JAX package's cursor file reads
    assert tck.IngestCursor.load(str(tmp_path / "none.json")) is None
    (tmp_path / "bad.json").write_text("{not json")
    assert tck.IngestCursor.load(str(tmp_path / "bad.json")) is None


def test_population_snapshot_round_trip(vcf, synthetic_vcf, tmp_path):
    for path in (vcf, synthetic_vcf):
        pop, _, _ = t_parse(path, "pop", "PF_DIPLOID")
        snap = str(tmp_path / "pop.pkl")
        tck.save_population(pop, snap)
        restored = tck.load_population(snap)
        assert_same_population(pop, restored)
        assert restored.data_source == pop.data_source
        orig = sorted(v.hgvs_phase() for _, g in pop for _, c in g for v in c)
        back = sorted(v.hgvs_phase() for _, g in restored for _, c in g for v in c)
        assert orig == back


@pytest.mark.parametrize("every,after", [(1, 5), (2, 7), (3, 1)])
def test_crash_and_resume_identical(vcf, tmp_path, monkeypatch, every, after):
    jpop, _, jinfo = j_parse(vcf, "pop", "PF_DIPLOID", subscribed_info=["AF"], use_native=False)
    oracle, _, oracle_info = t_parse(vcf, "pop", "PF_DIPLOID", subscribed_info=["AF"],
                                     use_native=False)
    ckpt = str(tmp_path / "cursor.json")
    crash = Crash(monkeypatch, tdb, after)
    with pytest.raises(RuntimeError, match="simulated"):
        t_parse(vcf, "pop", "PF_DIPLOID", subscribed_info=["AF"], checkpoint_path=ckpt,
                checkpoint_every=every)
    crash.undo()
    resumed, _, resumed_info = t_parse(vcf, "pop", "PF_DIPLOID", subscribed_info=["AF"],
                                       checkpoint_path=ckpt, checkpoint_every=every)
    assert_same_population(oracle, resumed)
    assert_same_population(jpop, resumed)
    assert_same_info(oracle_info, resumed_info)
    assert_same_info(jinfo, resumed_info)
    for suffix in ("", ".pop", ".info"):
        assert not os.path.exists(ckpt + suffix)


def test_resume_at_size_equals_native_ingest(synthetic_vcf, tmp_path, monkeypatch):
    """600 records with indels, snapshots every 50, a crash near record
    170, resumed: the population and the InfoStore equal the native
    ingest's and the JAX package's checkpointed ingest."""
    native, _, native_info = t_parse(synthetic_vcf, "pop", "PF_DIPLOID")
    ckpt = str(tmp_path / "c.json")
    crash = Crash(monkeypatch, tdb, 170 * 4)
    with pytest.raises(RuntimeError):
        t_parse(synthetic_vcf, "pop", "PF_DIPLOID", checkpoint_path=ckpt, checkpoint_every=50)
    crash.undo()
    cursor = tck.IngestCursor.load(ckpt)
    assert cursor.record_count > 0 and cursor.record_count % 50 == 0
    resumed, _, info = t_parse(synthetic_vcf, "pop", "PF_DIPLOID", checkpoint_path=ckpt,
                               checkpoint_every=50)
    assert_same_population(native, resumed)
    assert_same_info(native_info, info)
    jpop, _, jinfo = j_parse(synthetic_vcf, "pop", "PF_DIPLOID",
                             checkpoint_path=str(tmp_path / "j.json"), checkpoint_every=50)
    assert_same_population(jpop, resumed)
    assert_same_info(jinfo, info)
    assert sorted(os.listdir(tmp_path)) == []


def test_fingerprint_mismatch_restarts(vcf, tmp_path):
    ckpt = str(tmp_path / "cursor.json")
    tck.IngestCursor(file_path=vcf, line_number=15, record_count=2, fingerprint=12345).save(ckpt)
    pop2, _, _ = t_parse(vcf, "pop2", "PF_DIPLOID", use_native=False)
    tck.save_population(pop2, ckpt + ".pop")
    restarted, _, _ = t_parse(vcf, "pop", "PF_DIPLOID", checkpoint_path=ckpt)
    oracle, _, _ = t_parse(vcf, "pop", "PF_DIPLOID", use_native=False)
    assert_same_population(oracle, restarted)


def test_another_file_restarts(vcf, synthetic_vcf, tmp_path):
    ckpt = str(tmp_path / "cursor.json")
    tck.IngestCursor(file_path=synthetic_vcf, record_count=1).save(ckpt)
    tck.save_population(t_parse(synthetic_vcf, "x", "PF_DIPLOID")[0], ckpt + ".pop")
    got, _, _ = t_parse(vcf, "pop", "PF_DIPLOID", checkpoint_path=ckpt)
    assert_same_population(t_parse(vcf, "pop", "PF_DIPLOID")[0], got)


def _prefix_cursor(module, vcf, n):
    """A cursor of `module` over the first n records, as the ingest
    leaves it: fingerprint, record count, line number."""
    from kgl_gene_tpu_torch.io.vcf import _record_key, read_vcf

    cursor = module.IngestCursor(file_path=vcf)
    _, records = read_vcf(vcf)
    for rec in list(records)[:n]:
        cursor.fingerprint = combine_hash(cursor.fingerprint, string_hash(_record_key(rec)))
        cursor.record_count += 1
        cursor.line_number = rec.line_number
    return cursor


class LogRecorder:
    """Stands in for the port's logger in io/vcf.py: keeps the messages."""

    def __init__(self):
        self.messages = []

    def warn(self, msg, *args):
        self.messages.append(msg.format(*args))

    info = error = warn


def test_jax_snapshot_is_refused_and_ingest_restarts(vcf, tmp_path, monkeypatch):
    """A .pop written by the JAX package names kgl_gene_tpu classes: the
    port's unpickler refuses it before importing anything, warns, and
    ingests afresh."""
    ckpt = str(tmp_path / "cursor.json")
    _prefix_cursor(tck, vcf, 2).save(ckpt)
    jck.save_population(j_parse(vcf, "pop", "PF_DIPLOID", use_native=False)[0], ckpt + ".pop")
    with pytest.raises(tck.UnusableCheckpoint, match="kgl_gene_tpu.variant"):
        tck.load_population(ckpt + ".pop")
    import kgl_gene_tpu_torch.io.vcf as tvcf

    recorder = LogRecorder()
    monkeypatch.setattr(tvcf, "log", lambda: recorder)
    got, _, info = t_parse(vcf, "pop", "PF_DIPLOID", subscribed_info=["AF"],
                           checkpoint_path=ckpt)
    monkeypatch.undo()
    oracle, _, oracle_info = t_parse(vcf, "pop", "PF_DIPLOID", subscribed_info=["AF"])
    assert_same_population(oracle, got)
    assert_same_info(oracle_info, info)
    assert any("outside this package; restarting ingest" in m for m in recorder.messages)
    assert not os.path.exists(ckpt + ".pop")


def test_jax_info_snapshot_is_refused(vcf, tmp_path):
    """A port .pop beside a JAX .info: the InfoStore snapshot is refused as
    well, and the ingest restarts."""
    import pickle

    ckpt = str(tmp_path / "cursor.json")
    _prefix_cursor(tck, vcf, 2).save(ckpt)
    tck.save_population(t_parse(vcf, "pop", "PF_DIPLOID", use_native=False)[0], ckpt + ".pop")
    with open(ckpt + ".info", "wb") as f:
        pickle.dump(j_parse(vcf, "pop", "PF_DIPLOID", use_native=False)[2], f)
    got, _, _ = t_parse(vcf, "pop", "PF_DIPLOID", checkpoint_path=ckpt)
    assert_same_population(t_parse(vcf, "pop", "PF_DIPLOID")[0], got)


def test_damaged_snapshot_restarts(vcf, tmp_path):
    ckpt = str(tmp_path / "cursor.json")
    _prefix_cursor(tck, vcf, 2).save(ckpt)
    Path(ckpt + ".pop").write_bytes(b"\x80\x05not a pickle")
    with pytest.raises(tck.UnusableCheckpoint):
        tck.load_snapshot(ckpt + ".pop")
    got, _, _ = t_parse(vcf, "pop", "PF_DIPLOID", checkpoint_path=ckpt)
    assert_same_population(t_parse(vcf, "pop", "PF_DIPLOID")[0], got)


def test_jax_snapshot_refused_with_the_jax_package_blocked(vcf, tmp_path):
    ckpt = str(tmp_path / "cursor.json")
    _prefix_cursor(tck, vcf, 2).save(ckpt)
    jck.save_population(j_parse(vcf, "pop", "PF_DIPLOID", use_native=False)[0], ckpt + ".pop")
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kgl_gene_tpu'] = None\n"
        "from kgl_gene_tpu_torch.io.vcf import parse_vcf_population as p\n"
        f"pop, _, _ = p({vcf!r}, 'pop', 'PF_DIPLOID', checkpoint_path={ckpt!r})\n"
        "assert pop.variant_count() == p({vcf!r}, 'pop', 'PF_DIPLOID')[0].variant_count()\n"
        "print('ok')\n"
    ).replace("{vcf!r}", repr(vcf))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    assert "outside this package; restarting ingest" in proc.stdout


@pytest.mark.parametrize("which,after,every", [("vcf", 4, 1), ("vcf", 7, 1), ("vcf", 9, 1),
                                                ("synthetic_vcf", 700, 25)])
def test_cursor_equals_jax_after_the_same_records(request, tmp_path, monkeypatch, which, after,
                                                   every):
    """Both packages interrupted at the same incidence with snapshots every
    `every` records: the two cursor files agree field by field."""
    vcf = request.getfixturevalue(which)
    paths = {}
    for name, db_module, parse in (("jax", jdb, j_parse), ("port", tdb, t_parse)):
        ckpt = str(tmp_path / f"{name}.json")
        crash = Crash(monkeypatch, db_module, after)
        with pytest.raises(RuntimeError, match="simulated"):
            parse(vcf, "pop", "PF_DIPLOID", checkpoint_path=ckpt, checkpoint_every=every)
        crash.undo()
        paths[name] = ckpt
    jcur, tcur = (json.load(open(paths[k])) for k in ("jax", "port"))
    assert tcur == jcur
    assert tcur["record_count"] > 0 and tcur["fingerprint"] != 0
    replay = vars(_prefix_cursor(tck, vcf, tcur["record_count"]))
    assert {k: v for k, v in tcur.items() if k != "variant_count"} == {
        k: v for k, v in replay.items() if k != "variant_count"}
