"""Kernel `hallme` (csrc/hallme.cu) on the CPU: a mirror of its passes in
numpy, held against the port's plain version (stats/inbreeding.py
_hall_me_rows_plain, eager float32) and against the benchmark's float64
reference (port_bench/reference/inbreed.py hall_me).

The mirror does what the kernel does, step by step: genomes in tiles of
HALLME_TILE, padded with genomes that never run; a cell's term f / (f +
(1 - f) a) in float32, each product, sum and quotient rounded once; a
chunk's rows taken by HALLME_WARPS warps in turn, each warp's float32 sum
over its rows in order (a thread's HALLME_VEC genomes of a row are its
4-byte load, the next HALLME_ROWS rows in flight: neither changes a sum's
order), the warps' sums added in warp order in float64, the chunks' in
chunk order; the last block's update (prev, f and the step count of a
running genome, the stop test from the stored state); a tile with no
running genome skips the pass. The first step counts each genome's valid
loci in the same pass. Change it with the kernel.

Tolerance 1e-3 in F (reference.TOLERANCE["HallME"]): the stop test may
fall a step earlier or later in float32 than in float64, and a step there
moves f by up to ~1e-4.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kgl_gene_tpu_torch import kernels
from kgl_gene_tpu_torch.stats import inbreeding as inb
from port_bench.reference import inbreed as reference

ATOL = reference.TOLERANCE["HallME"]
SOURCE = Path(inb.__file__).resolve().parent.parent / "csrc" / "hallme.cu"
TOL = np.float32(inb._EM_TOL)
# How near 1e-4 (relative) a stop test may lie before float32 and float64
# may take it on different steps.
NEAR = 1e-3


def hallme_kernel_mirror(codes, af, mask, mask_t, chunk_loci):
    """(F (G,) float32, steps (G,), steps run, tile passes skipped, the
    nearest any of a genome's stop tests came to 1e-4 (G,), relative) of
    kernel `hallme`'s passes: codes (L, G) uint8, af (L,) float32, mask 0,
    1 or 2 and mask_t None, (L,) or (L, G) bool (inb._mask_form), chunks of
    chunk_loci loci (a multiple of HALLME_WARPS)."""
    L, G = codes.shape
    tile, warps = inb.HALLME_TILE, inb.HALLME_WARPS
    assert chunk_loci % warps == 0
    tiles = math.ceil(G / tile)
    Gp = tiles * tile
    chunks = max(1, math.ceil(L / chunk_loci))
    Lp = chunks * chunk_loci
    c = np.ones((Lp, Gp), dtype=np.uint8)  # pad rows and genomes: heterozygous, never valid
    c[:L, :G] = codes
    ok = np.zeros((Lp, Gp), dtype=bool)
    ok[:L, :G] = True if mask == 0 else (mask_t[:, None] if mask == 1 else mask_t)
    if mask == 1:
        ok[:L, G:] = mask_t[:, None]  # a pad genome counts a locus's mask, as the kernel
    p = np.full(Lp, 0.5, dtype=np.float32)
    p[:L] = af.astype(np.float32)
    q = np.float32(1.0) - p
    a = np.where(c == 0, q[:, None], p[:, None])
    hom = ((c & 0xFD) == 0) & ok
    n = np.full(Gp, np.float32(L)) if mask == 0 else ok.sum(0).astype(np.float32)
    live = np.arange(Gp) < G

    f = np.full(Gp, np.float32(0.25))
    prev = np.ones(Gp, dtype=np.float32)
    steps = np.zeros(Gp, dtype=np.float32)
    near = np.full(Gp, np.inf)
    running = np.ones(tiles, dtype=bool)
    ran, skipped = 0, 0
    for step in range(inb._EM_MAX_ITER):
        if step and step % inb._EM_CHECK_EVERY == 0 and not running.any():
            break
        if step:
            skipped += int((~running).sum())
        omf = np.float32(1.0) - f
        den = f + omf * a
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(hom & (den != 0), f / den, np.float32(0.0))
        rows = t.reshape(chunks, chunk_loci // warps, warps, Gp)
        acc = np.zeros((chunks, warps, Gp), dtype=np.float32)
        for i in range(chunk_loci // warps):  # a warp's rows in order
            acc = acc + rows[:, i]
        block = np.zeros((chunks, Gp))
        for w in range(warps):
            block = block + acc[:, w].astype(np.float64)
        term = np.zeros(Gp)
        for ch in range(chunks):
            term = term + block[ch]
        with np.errstate(divide="ignore", invalid="ignore"):
            new_f = np.where(n > 0, term.astype(np.float32) / n, np.float32(0.0))
        tile_runs = np.repeat(running, tile)
        if step == 0:
            active = live
        else:
            active = live & tile_runs & (np.abs(f - prev) > TOL) & (steps < inb._EM_MAX_ITER)
        prev = np.where(active, f, prev)
        f = np.where(active, new_f, f)
        steps = steps + active
        moved = np.abs(f - prev)
        near = np.where(active, np.minimum(near, np.abs(moved / TOL - 1.0)), near)
        runs = live & (moved > TOL) & (steps < inb._EM_MAX_ITER)
        running = runs.reshape(tiles, tile).any(1)
        ran += 1
    return f[:G], steps[:G].astype(np.int64), ran, skipped, near[:G]


def mirror(z, p, valid, chunk_loci):
    """The mirror on run_estimators' tensors, the mask as the kernel takes it."""
    mask, mask_t = inb._mask_form(valid)
    return hallme_kernel_mirror(z.numpy(), p.numpy(), mask,
                                None if mask_t is None else mask_t.numpy(), chunk_loci)


def plain(z, p, valid):
    """(F, steps run) of the plain version."""
    before = inb.COUNTERS["hallme_steps"]
    f = inb._hall_me_rows_plain(z, p, valid).numpy()
    return f, inb.COUNTERS["hallme_steps"] - before


def reference_f(z, p, valid):
    """(F, steps) of the reference on the cells the mask keeps: a locus
    left out is not one of the genome's loci, as in the port (a genome at
    a time where the mask is a genome's)."""
    codes = z.numpy()
    L, G = codes.shape
    af = p.numpy().astype(np.float64)
    keep = np.ones((L, G), dtype=bool)
    if valid is not None:
        keep = np.broadcast_to(valid.numpy().reshape(L, -1), (L, G))
    if (keep == keep[:, :1]).all():
        loci = np.flatnonzero(keep[:, 0]) if G else np.arange(L)
        f, k = reference.hall_me(torch.as_tensor(codes), loci, af[loci])
        return f.numpy(), k.numpy()
    out = [reference.hall_me(torch.as_tensor(codes[:, g:g + 1].copy()), np.flatnonzero(keep[:, g]),
                             af[keep[:, g]]) for g in range(G)]
    return np.concatenate([o[0].numpy() for o in out]), np.concatenate([o[1].numpy() for o in out])


def population(G, L, seed, other_codes=False):
    """(z (L, G) uint8, p (L,) float32): genomes drawn at F spread over
    [0, 0.8]; genome 0 all homozygous (f tends to 1), genome 1 all
    heterozygous (term 0: f = 0 after a step); other_codes puts codes 3 and
    255 in a few cells."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.05, 0.5, L).astype(np.float32)
    f = np.linspace(0.0, 0.8, G)
    ibd = rng.random((L, G)) < f
    one = rng.random((L, G)) < p[:, None]
    z = (one.astype(np.uint8) + np.where(ibd, one, rng.random((L, G)) < p[:, None]))
    z[:, 0] = np.where(rng.random(L) < p, 2, 0)
    if G > 1:
        z[:, 1] = 1
    if other_codes:
        z[rng.integers(0, L, 7), rng.integers(0, G, 7)] = 3
        z[rng.integers(0, L, 7), rng.integers(0, G, 7)] = 255
    return torch.as_tensor(z.astype(np.uint8)), torch.as_tensor(p)


def mask_of(form, z, seed):
    """valid as run_estimators takes it: None, per locus (L, 1) or its
    stride-0 broadcast (L, G), or per genome (L, G) with every cell of the
    last genome left out (n = 0)."""
    L, G = z.shape
    rng = np.random.default_rng(seed + 1)
    if form == "none":
        return None
    if form in ("locus", "broadcast"):
        locus = torch.as_tensor(rng.random(L) < 0.8)[:, None]
        return locus if form == "locus" else locus.expand(L, G)
    v = rng.random((L, G)) < 0.8
    v[:, -1] = False
    return torch.as_tensor(v)


@pytest.fixture
def small_blocks(monkeypatch):
    """The plain version's blocks of 50 loci, so that L = 260 spans six."""
    def use(G):
        monkeypatch.setattr(inb, "_BLOCK_ELEMENTS", 50 * G)
    return use


def same_steps(got, want, near):
    """Per-genome step counts equal where no stop test came near 1e-4."""
    far = near > NEAR
    np.testing.assert_array_equal(got[far], want[far])


@pytest.mark.parametrize("L", (37, 260))
@pytest.mark.parametrize("form", ("none", "locus", "broadcast", "genome"))
@pytest.mark.parametrize("G", (1, 11, 33, inb.HALLME_TILE + 1))
def test_mirror_equals_the_plain_version_and_the_reference(G, L, form, small_blocks):
    small_blocks(G)
    z, p = population(G, L, seed=G * 1000 + L)
    valid = mask_of(form, z, seed=G + L)
    want, plain_steps = plain(z, p, valid)
    ref, ref_steps = reference_f(z, p, valid)
    np.testing.assert_allclose(want, ref, rtol=0, atol=ATOL)
    for chunk_loci in (inb.HALLME_WARPS, 3 * inb.HALLME_WARPS, inb.HALLME_WARPS * inb.HALLME_ROWS):
        got, steps, ran, _skipped, near = mirror(z, p, valid, chunk_loci)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
        same_steps(steps, ref_steps, near)
        if (near > NEAR).all():
            assert ran == plain_steps
    if G > 1:
        assert want[1] == 0.0  # all heterozygous
    if form == "genome":
        assert want[-1] == 0.0  # no valid locus


def test_a_stopped_tile_skips_its_pass(small_blocks):
    """Two tiles: the second holds one all-heterozygous genome, which stops
    after two steps; its tile skips every later pass (and the first tile
    the passes between its own stop and the next read), and F is the same."""
    G = inb.HALLME_TILE + 1
    small_blocks(G)
    z, p = population(G, 260, seed=5)
    z[:, -1] = 1
    want, plain_steps = plain(z, p, None)
    got, _steps, ran, skipped, _near = mirror(z, p, None, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert ran == plain_steps and ran - 2 <= skipped < ran - 2 + inb._EM_CHECK_EVERY
    assert got[-1] == 0.0


def test_the_card_geometry_on_the_mirror():
    """The chunk hallme_geometry gives at the cell's card, 132 SMs at 4
    blocks an SM, on 33 genomes x 700 and 3,000 loci (one tile)."""
    for L in (700, 3000):
        z, p = population(33, L, seed=L)
        _tiles, chunk_loci = inb.hallme_geometry(33, L, 132, 4)
        want, _ = plain(z, p, None)
        got, *_ = mirror(z, p, None, chunk_loci)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_codes_past_two_count_in_n_and_are_not_homozygous():
    z, p = population(11, 300, seed=4, other_codes=True)
    want, _ = plain(z, p, None)
    got, steps, _ran, _skipped, near = mirror(z, p, None, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    ref, ref_steps = reference_f(z, p, None)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    same_steps(steps, ref_steps, near)


def test_a_zero_denominator_adds_nothing():
    """Loci at p = 0 and p = 1: once a genome's f is 0 (the all-heterozygous
    genome after a step), its denominator at a homozygous code whose a is 0
    is 0, and the cell adds 0 (the reference's 0 / 0 reads NaN there)."""
    z, p = population(11, 200, seed=6)
    p[:3], p[3:6] = 0.0, 1.0
    z[:3, 1], z[3:6, 1] = 2, 0  # a = 0: p for code 2, 1 - p for code 0
    want, plain_steps = plain(z, p, None)
    got, _steps, ran, _skipped, _near = mirror(z, p, None, 64)
    assert want[1] == got[1] and np.isfinite(got).all() and ran == plain_steps
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    ref, _ = reference_f(z, p, None)
    np.testing.assert_allclose(got[2:], ref[2:], rtol=0, atol=ATOL)


def test_a_genome_at_the_step_cap():
    """499 loci monomorphic (a = 1: the term is f) and one at a = 1e-3: f
    creeps towards 1 by ~1e-3 of the gap a step and is still moving by more
    than 1e-4 after 1,000 steps; the cap stops it there."""
    L, G = 500, 1
    z, p = population(G, L, seed=7)
    p[:-1] = 0.0
    z[:-1, 0] = 0
    p[-1] = 1e-3
    z[-1, 0] = 2
    want, plain_steps = plain(z, p, None)
    got, steps, ran, _skipped, _near = mirror(z, p, None, 64)
    ref, ref_steps = reference_f(z, p, None)
    assert plain_steps == ran == inb._EM_MAX_ITER
    assert steps[0] == ref_steps[0] == inb._EM_MAX_ITER
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_the_plain_version_counts_steps_and_reads(small_blocks):
    """A step is a pass over the blocks; the stop test is read at steps 0,
    8, 16, ...; the kernel's counters do not move on the CPU."""
    G, L = 11, 260
    small_blocks(G)
    z, p = population(G, L, seed=3)
    before = dict(inb.COUNTERS)
    inb._hall_me_rows(z, p, None)
    got = {k: n - before.get(k, 0) for k, n in inb.COUNTERS.items()}
    assert got["hallme_steps"] > 0 and got["hallme_steps"] % inb._EM_CHECK_EVERY == 0
    assert got["hallme_stop_reads"] == got["hallme_steps"] // inb._EM_CHECK_EVERY + 1
    assert got.get("hallme_passes", 0) == 0 and got.get("hallme_tiles_skipped", 0) == 0


@pytest.mark.parametrize("G, L, sms, blocks", [
    (2504, 25000, 132, 4), (11, 100, 132, 4), (1, 1, 132, 4), (1, 0, 132, 4),
    (129, 37, 132, 3), (100_000, 25_000, 132, 4), (2504, 10, 132, 4), (2504, 25000, 132, 8),
])
def test_geometry_fills_the_card_in_one_wave(G, L, sms, blocks):
    tiles, chunk_loci = inb.hallme_geometry(G, L, sms, blocks)
    assert tiles * inb.HALLME_TILE >= G > (tiles - 1) * inb.HALLME_TILE
    unit = inb.HALLME_WARPS * inb.HALLME_ROWS
    chunks = max(1, math.ceil(L / chunk_loci))
    assert chunk_loci % unit == 0 and chunks * chunk_loci >= L
    assert tiles * chunks <= max(tiles, sms * blocks)  # one wave, or a chunk a tile
    if (G, L, blocks) == (2504, 25000, 4):
        assert (tiles, chunk_loci, chunks) == (20, 992, 26)


def test_the_kernel_constants_are_the_wrappers():
    src = SOURCE.read_text()
    ints = {k: int(v) for k, v in re.findall(r"constexpr int (HM_\w+) = (\d+);", src)}
    reals = {k: float(v) for k, v in re.findall(r"constexpr float (HM_\w+) = ([\d.e-]+)f;", src)}
    assert (ints["HM_WARPS"], ints["HM_VEC"], ints["HM_TILE"], ints["HM_ROWS"],
            ints["HM_MAX_STEPS"]) == (
        inb.HALLME_WARPS, inb.HALLME_VEC, inb.HALLME_TILE, inb.HALLME_ROWS, inb._EM_MAX_ITER)
    assert ints["HM_THREADS"] == 32 * inb.HALLME_WARPS and inb.HALLME_TILE == 32 * inb.HALLME_VEC
    assert reals == {"HM_TOL": inb._EM_TOL, "HM_START": 0.25}
    assert "torch.full((G,), 0.25," in Path(inb.__file__).read_text()
    assert {"kgt_hallme_step", "kgt_hallme_blocks"} <= set(kernels._SIGNATURES)
    # the IEEE float32 operations, no fast division
    assert "__fdiv_rn(f[k], den)" in src and "__fdividef" not in src
    assert "fast_math" not in " ".join(kernels.NVCC_FLAGS).replace("-", "_")


def test_a_tensor_off_the_cpu_never_takes_the_plain_version(monkeypatch):
    """Any tensor but a CPU one goes to the kernel's wrapper, which raises
    off the card: no fallback to the eager version."""
    def plain_version(*_a):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(inb, "_hall_me_rows_plain", plain_version)
    z = torch.zeros((40, 5), dtype=torch.uint8, device="meta")
    p = torch.zeros(40, dtype=torch.float32, device="meta")
    for valid in (None, torch.ones((40, 1), dtype=torch.bool, device="meta")):
        with pytest.raises(ValueError, match="on the card"):
            inb._hall_me_rows(z, p, valid)
