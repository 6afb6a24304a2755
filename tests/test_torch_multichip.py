"""The port's multi-device forms (parallel/dist.py, parallel/mesh.py,
make_multichip_step / make_multichip_indel_step, entry.dryrun_multichip)
against the JAX package's on the conftest's 8-device CPU mesh.

The port runs in gloo ranks on the CPU (run_ranks, spawn, each spawn with
its own deadline) at worlds 2 and 4, its rank bodies in tests/torch_ranks.py
so that no rank imports JAX; the JAX package runs here, in the test
process. The cases mirror tests/test_multichip.py's seeds and shapes.
Integer outputs are held exactly; F values within the JAX tests'
tolerances, and the streamed inbreeding bit for bit against the port's
one-rank run.
"""

import multiprocessing
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_ranks  # noqa: E402
from kgl_gene_tpu.ops import pipeline as j_pipe  # noqa: E402
from kgl_gene_tpu.ops.edit_distance import levenshtein_numpy  # noqa: E402
from kgl_gene_tpu.parallel import mesh as j_mesh  # noqa: E402
from kgl_gene_tpu.stats import inbreeding as j_inb  # noqa: E402
from kgl_gene_tpu_torch.entry import dryrun_multichip, example_batch  # noqa: E402
from kgl_gene_tpu_torch.ops import pipeline as t_pipe  # noqa: E402
from kgl_gene_tpu_torch.ops.edit_distance import pairwise_distance_matrix  # noqa: E402
from kgl_gene_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from kgl_gene_tpu_torch.parallel.dist import SampleMesh, run_ranks  # noqa: E402

WORLDS = (2, 4)
RANK_TIMEOUT_S = 90.0
# tests/test_torch_stats.py's tolerances against the JAX package
ESTIMATOR_ATOL = {"Simple": 1e-5, "RitlandLocus": 1e-5, "HallME": 1e-3, "Loglikelihood": 1e-4}
STEP_CASES = ("forward", "reverse", "ragged", "ragged_odd", "banded_768")


def _geometry(seed=0, L=240):
    rng = np.random.default_rng(seed)
    region = rng.integers(0, 4, size=L).astype(np.uint8)
    return region, np.array([[20, 80], [120, 180]], dtype=np.int64)


def _indel_case():
    rng = np.random.default_rng(4)
    L, B, K, A = 384, 16, 6, 4
    region = rng.integers(0, 4, size=L).astype(np.uint8)
    exons = np.array([[40, 160], [200, 320]], dtype=np.int64)
    pos = np.sort(rng.integers(0, 40, size=(B, K)).astype(np.int32), axis=1) * 8
    kind = rng.integers(0, 3, size=(B, K)).astype(np.int8)
    del_len = np.where(kind == 1, rng.integers(1, 3, size=(B, K)), 0).astype(np.int32)
    ins_len = np.where(kind == 2, rng.integers(1, A, size=(B, K)), 0).astype(np.int32)
    ins_codes = rng.integers(0, 4, size=(B, K, A)).astype(np.uint8)
    alt_code = rng.integers(0, 4, size=(B, K)).astype(np.uint8)
    valid = rng.random((B, K)) < 0.7
    return region, exons, K * A, 63, (pos, kind, del_len, ins_codes, ins_len, alt_code, valid)


def _allpairs_banded():
    rng = np.random.default_rng(11)
    n, S = 12, 640
    base = rng.integers(0, 4, size=S).astype(np.uint8)
    seqs = np.tile(base, (n, 1))
    for i in range(n):  # a bounded-edit family (fits the band)
        for p in rng.choice(S, size=rng.integers(0, 10), replace=False):
            seqs[i, p] = (seqs[i, p] + 1) % 4
    return seqs, np.full(n, S, dtype=np.int32), 63


def _allpairs_overflow():
    rng = np.random.default_rng(12)
    seqs = rng.integers(0, 4, size=(6, 640)).astype(np.uint8)  # ~random: d >> 63
    return seqs, np.full(6, 640, dtype=np.int32), 63


def _build_cases():
    steps = {}
    for name, reverse in (("forward", False), ("reverse", True)):
        region, exons = _geometry()
        positions, alt, valid = example_batch(32, 6, len(region))
        zyg = (np.random.default_rng(2).random((32, 16)) * 3).astype(np.uint8)
        steps[name] = (region, exons, reverse, positions, alt, valid, zyg)
    region, exons = _geometry(seed=3)
    for name, B in (("ragged", 12), ("ragged_odd", 11)):  # 12 pads on 8 devices, 11 on 2 and 4
        positions, alt, valid = example_batch(B, 4, len(region), seed=4)
        steps[name] = (region, exons, False, positions, alt, valid, np.zeros((B, 8), np.uint8))
    region, _ = _geometry(seed=7, L=768)
    positions, alt, valid = example_batch(16, 6, len(region), seed=8)
    steps["banded_768"] = (region, np.array([[0, 768]], dtype=np.int64), False, positions,
                           alt, valid, np.zeros((16, 8), np.uint8))
    data = j_inb.synthetic_diploid_population(
        n_genomes=12, n_loci=700, inbreeding=np.linspace(0.0, 0.4, 12), seed=3)
    window_p = data.minor_freq.copy()
    window_p[::13] = 0.0  # invalid loci, excluded by the functions' own mask
    return {
        "steps": steps,
        "indel": _indel_case(),
        "allpairs": {"banded": _allpairs_banded(), "overflow": _allpairs_overflow()},
        "streamed": (np.asarray(data.zygosity, np.uint8), np.asarray(data.minor_freq), 256),
        "window": (np.asarray(data.zygosity, np.uint8), window_p),
        "data": data,
    }


CASES = _build_cases()


def _rank_cases():
    return {k: v for k, v in CASES.items() if k != "data"}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request):
    """Every rank's results of torch_ranks.multichip_checks at one world
    size; one spawn for all the checks of the world."""
    world = request.param
    out = run_ranks(torch_ranks.multichip_checks, world, device="cpu",
                    timeout_s=RANK_TIMEOUT_S, args=(_rank_cases(),))
    assert [o["rank"] for o in out] == list(range(world))
    assert {o["backend"] for o in out} == {"gloo"} and {o["device"] for o in out} == {"cpu"}
    return world, out


def _jax_step(name):
    region, exons, reverse, positions, alt, valid, zyg = CASES["steps"][name]
    mesh = j_mesh.sample_mesh(8)
    step = j_pipe.make_multichip_step(mesh, region, exons, region_start=0,
                                      reverse_strand=reverse,
                                      use_pallas=name == "banded_768")
    dist, counts, pop_ac = step(*(j_mesh.shard_samples(x, mesh)
                                  for x in (positions, alt, valid, zyg)))
    return np.asarray(dist), np.asarray(counts), np.asarray(pop_ac)


def _port_single(name):
    region, exons, reverse, positions, alt, valid, _zyg = CASES["steps"][name]
    step = t_pipe.make_forward_step(region, exons, 0, reverse_strand=reverse, device="cpu")
    return step(positions, alt, valid)


@pytest.mark.parametrize("name", STEP_CASES)
def test_step_equals_jax_and_single_device(ranks, name):
    """Step parity on both strands, the ragged batches (padded genomes give
    distance 0) and the banded route at 768 coding bases: every rank's
    gathered distances, its allele counts and pop AC equal JAX's
    multichip step, the port's one-device step and numpy's column sums."""
    _world, out = ranks
    B = CASES["steps"][name][3].shape[0]
    zyg = CASES["steps"][name][6]
    j_dist, j_counts, j_pop = _jax_step(name)
    single = _port_single(name)
    for o in out:
        dist, counts, pop_ac = o[f"step/{name}"]
        np.testing.assert_array_equal(dist[:B], j_dist[:B])
        np.testing.assert_array_equal(dist[:B], single.distance.numpy())
        np.testing.assert_array_equal(dist[B:], 0)
        np.testing.assert_array_equal(counts, j_counts)
        np.testing.assert_array_equal(counts, single.allele_counts.numpy())
        assert counts.dtype == np.int32 and pop_ac.dtype == np.int32
        np.testing.assert_array_equal(pop_ac, j_pop)
        np.testing.assert_array_equal(pop_ac, zyg.astype(np.int64).sum(axis=0))


def test_indel_step_equals_jax_and_single_device(ranks):
    _world, out = ranks
    region, exons, pad, band, slots = CASES["indel"]
    B = slots[0].shape[0]
    single = t_pipe.make_indel_forward_step(region, exons, 0, pad_coding=pad, band_k=band,
                                            device="cpu")(*slots)
    mesh = j_mesh.sample_mesh(4)
    jstep = j_pipe.make_multichip_indel_step(mesh, region, exons, region_start=0,
                                             pad_coding=pad, band_k=band, use_pallas=False)
    want = [np.asarray(x)[:B] for x in jstep(*(j_mesh.shard_samples(x, mesh) for x in slots))]
    for o in out:
        for got, j_want, t_want in zip(o["indel"], want, (single.coding_len, single.distance,
                                                          single.validity_code)):
            np.testing.assert_array_equal(got[:B], j_want)
            np.testing.assert_array_equal(got[:B], t_want.numpy())


@pytest.mark.parametrize("name", ("banded", "overflow"))
def test_sharded_allpairs_equal_jax_and_oracle(ranks, name):
    """The sharded banded all-pairs, in the band and past it (the overflow
    pairs re-run exactly): every rank's matrix equals JAX's, the port's
    one-device matrix and the numpy DP."""
    _world, out = ranks
    seqs, lens, band = CASES["allpairs"][name]
    want = j_mesh.sharded_pairwise_distances(seqs, lens, j_mesh.sample_mesh(8), band_k=band)
    np.testing.assert_array_equal(
        pairwise_distance_matrix(seqs, lens, band_k=band, device="cpu"), want)
    n = len(seqs)
    for i in range(n):
        for j in range(i + 1, n):
            assert want[i, j] == levenshtein_numpy(seqs[i], seqs[j]), (i, j)
    for o in out:
        np.testing.assert_array_equal(o[f"allpairs/{name}"], want)


def test_streamed_inbreeding_equals_single_shot_and_one_rank(ranks):
    """Streamed at this world against the single-shot estimators and JAX's
    streamed form on a mesh of the same size (rtol 1e-5, atol 1e-6, as
    tests/test_multichip.py), and bit for bit against the port's one-rank
    run: the row slabs are sized from the whole population's G."""
    world, out = ranks
    data = CASES["data"]
    z, p, block = CASES["streamed"]
    csr = torch_ranks.DenseCSR(z)
    one = t_mesh.streamed_inbreeding(csr, p, "cpu", block_variants=block)
    jax_out = j_mesh.streamed_inbreeding(csr, p, j_mesh.sample_mesh(world), block_variants=block)
    for o in out:
        got = o["streamed"]
        for name, single in (("Simple", j_inb.simple_f(data)),
                             ("RitlandLocus", j_inb.ritland_f(data))):
            np.testing.assert_allclose(got[name], single, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got[name], jax_out[name], rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(got[name], one[name])
    assert abs(float(out[0]["streamed"]["Simple"][-1]) - 0.4) < 0.15


def test_streamed_inbreeding_one_rank_equals_single_shot():
    """World 1: the one-rank mesh and the device form are one path."""
    data = CASES["data"]
    z, p, block = CASES["streamed"]
    csr = torch_ranks.DenseCSR(z)
    got = t_mesh.streamed_inbreeding(csr, p, SampleMesh.single("cpu"), block_variants=block)
    one = t_mesh.streamed_inbreeding(csr, p, "cpu", block_variants=block)
    want = j_mesh.streamed_inbreeding(csr, p, j_mesh.sample_mesh(1), block_variants=block)
    np.testing.assert_allclose(got["Simple"], j_inb.simple_f(data), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["RitlandLocus"], j_inb.ritland_f(data), rtol=1e-5, atol=1e-6)
    for name in ("Simple", "RitlandLocus"):
        np.testing.assert_array_equal(got[name], one[name])
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-6)


def test_non_decomposable_raises(ranks):
    _world, out = ranks
    for o in out:
        assert o["non_decomposable"] and "HallME" in o["non_decomposable"]
    with pytest.raises(ValueError):
        j_mesh.streamed_inbreeding(torch_ranks.DenseCSR(np.zeros((4, 64), np.uint8)),
                                   np.full(64, 0.3), j_mesh.sample_mesh(2), block_variants=64,
                                   algorithms=("HallME",))


def test_allele_counts_and_het_hom_equal_jax(ranks):
    _world, out = ranks
    z, _p = CASES["window"]
    mesh = j_mesh.sample_mesh(8)
    j_het, j_hom = j_mesh.sharded_het_hom(z, mesh)
    for o in out:
        np.testing.assert_array_equal(o["allele_counts"], j_mesh.sharded_allele_counts(z, mesh))
        np.testing.assert_array_equal(o["allele_counts"], t_mesh.sharded_allele_counts(z, "cpu"))
        np.testing.assert_array_equal(o["het_hom"][0], j_het)
        np.testing.assert_array_equal(o["het_hom"][1], j_hom)
        assert o["het_hom"][0].dtype == np.int32


@pytest.mark.parametrize("algorithm", sorted(ESTIMATOR_ATOL))
def test_sharded_inbreeding_equals_jax_and_one_device(ranks, algorithm):
    """The four estimators sharded over the ranks against JAX's sharded
    form (HallME: JAX's unsharded estimator, as its shard_map form does
    not trace; Loglikelihood: JAX with x64, as tests/test_torch_stats.py)
    and the port's one-device form."""
    _world, out = ranks
    z, p = CASES["window"]
    if algorithm == "HallME":
        valid = (p.astype(np.float32) > 0) & (p.astype(np.float32) < 1)
        want = j_inb._estimate(algorithm, j_inb.LocusData(
            z, p, np.broadcast_to(valid, z.shape).copy()))
    elif algorithm == "Loglikelihood":
        with jax.enable_x64(True):
            want = j_mesh.sharded_inbreeding(z, p, j_mesh.sample_mesh(8), algorithm)
    else:
        want = j_mesh.sharded_inbreeding(z, p, j_mesh.sample_mesh(8), algorithm)
    one = t_mesh.sharded_inbreeding(z, p, "cpu", algorithm)
    for o in out:
        got = o["inbreeding"][algorithm]
        assert got.shape == (z.shape[0],)
        np.testing.assert_allclose(got, want, rtol=0, atol=ESTIMATOR_ATOL[algorithm])
        np.testing.assert_allclose(got, one, rtol=0, atol=1e-6)


def test_dryrun_multichip_two_ranks():
    """entry.dryrun_multichip(2) on the CPU: both ranks report, agree, and
    their outputs equal the port's one-device forms on the same inputs."""
    out = dryrun_multichip(2, device="cpu", timeout_s=RANK_TIMEOUT_S)
    assert [o["rank"] for o in out] == [0, 1]
    assert {o["backend"] for o in out} == {"gloo"} and {o["device"] for o in out} == {"cpu"}
    rng = np.random.default_rng(0)
    region = rng.integers(0, 4, size=4800).astype(np.uint8)
    exons = np.array([[400, 1900], [2400, 3900]], dtype=np.int64)
    positions, alt, valid = example_batch(64, 48, len(region))
    zygosity = (np.random.default_rng(2).random((64, 16)) * 3).astype(np.uint8)
    want = t_pipe.make_forward_step(region, exons, 0, device="cpu")(positions, alt, valid)
    for o in out:
        np.testing.assert_array_equal(o["distance"], want.distance.numpy())
        np.testing.assert_array_equal(o["pop_ac"], zygosity.astype(np.int64).sum(0))
        np.testing.assert_array_equal(o["matrix"], out[0]["matrix"])
        assert np.isfinite(o["log_like"]) and o["log_like"] == out[0]["log_like"]
        assert o["F"]["Simple"].shape == (64,) and o["launches"] == {}


def test_collectives_at_world_four():
    """psum, gather_rows and ring_shift over four gloo ranks on the CPU."""
    out = run_ranks(torch_ranks.collective_checks, 4, device="cpu", timeout_s=RANK_TIMEOUT_S)
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["psum"], np.full((2, 3), 6))
        np.testing.assert_array_equal(o["gather"], np.repeat(np.arange(4), 2)[:, None]
                                      * np.ones((1, 3), np.int32))
        np.testing.assert_array_equal(o["ring"], np.full((2, 3), (r - 1) % 4))
        assert o["host_copies"] == {}  # CPU tensors never go through the host
        assert o["joined"] == (r, 4, "gloo", "cpu")


def test_launcher_raises_with_the_failing_rank():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank one gives up"):
        run_ranks(torch_ranks.raises_on_rank_one, 2, device="cpu", timeout_s=RANK_TIMEOUT_S)
    assert time.monotonic() - t0 < RANK_TIMEOUT_S
    assert not multiprocessing.active_children()


def test_launcher_kills_ranks_past_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 5.0 s"):
        run_ranks(torch_ranks.sleeps, 2, device="cpu", timeout_s=5.0, args=(600,))
    assert time.monotonic() - t0 < 30
    assert not multiprocessing.active_children()


def test_nccl_needs_a_card_a_rank_and_meshes_do_not_widen():
    with pytest.raises(ValueError, match="NCCL needs a card a rank"):
        run_ranks(torch_ranks.sleeps, 2, backend="nccl", device="cpu", args=(0,))
    assert t_mesh.sample_mesh(device="cpu").world_size == 1
    with pytest.raises(ValueError):
        t_mesh.sample_mesh(2, device="cpu")
