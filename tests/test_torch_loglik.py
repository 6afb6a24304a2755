"""Kernel `loglik` (csrc/loglik.cu) on the CPU: a mirror of its passes in
numpy, held against the port's plain version (stats/inbreeding.py
_loglik_rows_plain, eager float64) and against the benchmark's float64
reference (port_bench/reference/inbreed.py _max_loglik).

The mirror does what the kernel does, pass by pass: per-locus class terms
(D, S), a cell's probability fma(f, D, S) clamped to [1e-10, 1], a masked
cell as class 4 (probability 1); the grid from a table of log-probabilities
(locus, class, point) that the cells' codes select, summed over a chunk of
loci and then over the chunks in order; the first best point and its
bracket; each golden-section step's two points in one pass, LOGLIK_GROUP
probabilities multiplied before one log, per chunk, the chunks' sums in
order. (The kernel multiplies a group unclamped when every factor lies in
[2^-32, 1), where the clamp is the identity, so the product is the one
below.) Change it with the kernel.

Tolerance 1e-4 in F (reference.TOLERANCE["Loglikelihood"]): the three
compute the same float64 objective with sums in other orders and the
products' rounding, which moves F by ~1e-8 at most.
"""

import math
import re
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from kgl_gene_tpu_torch import kernels
from kgl_gene_tpu_torch.stats import inbreeding as inb
from port_bench.reference import inbreed as reference

ATOL = reference.TOLERANCE["Loglikelihood"]
SOURCE = Path(inb.__file__).resolve().parent.parent / "csrc" / "loglik.cu"
GOLDEN = 0.618033988749895  # the plain version's and the kernel's constant
HALF_WIDTH = 0.04


def class_terms(p: np.ndarray):
    """(D, S) (L, 5) float64: class c's probability at f is f D + S (codes
    0, 1, 2, any other code, masked out)."""
    q = 1.0 - p
    S = np.stack([q * q, 2.0 * p * q, p * p, 2.0 * p * p, np.ones_like(p)], axis=1)
    D = np.stack([q - q * q, -2.0 * p * q, p - p * p, -2.0 * p * p, np.zeros_like(p)], axis=1)
    return D, S


def _prob(f, D, S):
    return np.clip(f * D + S, inb._SMALL_PROB, 1.0)


def loglik_kernel_mirror(codes, af, valid, grid_loci, step_loci):
    """F (G,) float32 of kernel `loglik`'s passes: codes (L, G) uint8, af
    (L,) float32, valid None, (L,) or (L, G) bool as the kernel takes it
    (inb._mask_form), grid and step chunks of grid_loci and step_loci loci."""
    L, G = codes.shape
    D, S = class_terms(af.astype(np.float32).astype(np.float64))
    cls = np.minimum(codes, 3).astype(np.int64)
    if valid is not None and valid.ndim == 1:
        D[~valid], S[~valid] = 0.0, 1.0  # a masked locus: every class probability 1
    elif valid is not None:
        cls = np.where(valid, cls, 4)
    rows = np.arange(L)[:, None]
    Dc, Sc = D[rows, cls], S[rows, cls]  # (L, G): each cell's terms

    grid = -1.0 + np.arange(inb._GRID_POINTS) * (2.0 / (inb._GRID_POINTS - 1))
    table = np.log(_prob(grid[None, None, :], D[:, :, None], S[:, :, None]))  # (L, 5, 65)
    vals = np.zeros((inb._GRID_POINTS, G))
    for l0 in range(0, max(L, 1), grid_loci):
        chunk = np.zeros((inb._GRID_POINTS, G))
        for l in range(l0, min(L, l0 + grid_loci)):  # a thread's adds, locus by locus
            chunk += table[l, cls[l]].T
        vals += chunk
    k = np.argmax(vals, axis=0)  # the first best point
    lo = np.clip(grid[k] - HALF_WIDTH, -1.0, 1.0)
    hi = np.clip(grid[k] + HALF_WIDTH, -1.0, 1.0)

    for _ in range(inb._GOLDEN_STEPS):
        w = GOLDEN * (hi - lo)
        a, b = hi - w, lo + w
        la, lb = np.zeros(G), np.zeros(G)
        for l0 in range(0, max(L, 1), step_loci):
            l1 = min(L, l0 + step_loci)
            sa, sb = np.zeros(G), np.zeros(G)
            for s in range(l0, l1, inb.LOGLIK_GROUP):
                e = min(l1, s + inb.LOGLIK_GROUP)
                sa += np.log(np.prod(_prob(a, Dc[s:e], Sc[s:e]), axis=0))
                sb += np.log(np.prod(_prob(b, Dc[s:e], Sc[s:e]), axis=0))
            la, lb = la + sa, lb + sb
        b_better = la < lb
        lo, hi = np.where(b_better, a, lo), np.where(b_better, hi, b)
    return ((lo + hi) / 2.0).astype(np.float32)


def mirror(z, p, valid, geometry):
    """The mirror on run_estimators' tensors, the mask as the kernel takes it."""
    _mask, mask_t = inb._mask_form(valid)
    return loglik_kernel_mirror(z.numpy(), p.numpy(), None if mask_t is None else mask_t.numpy(),
                                *geometry)


def reference_f(z, p, valid):
    """The reference's grid and steps on the cells the mask keeps: a masked
    cell is in no class, so it adds nothing, as in the port."""
    codes = z.numpy()
    keep = np.ones(codes.shape, dtype=bool)
    if valid is not None:
        keep = np.broadcast_to(valid.numpy().reshape(codes.shape[0], -1), codes.shape)
    hom_ref, het, hom_alt = (torch.as_tensor(((codes == c) & keep).astype(np.float64))
                             for c in (0, 1, 2))
    p64 = torch.as_tensor(p.numpy().astype(np.float64))[:, None]
    return reference._max_loglik(hom_ref, het, hom_alt, p64).numpy()


def population(G, L, seed, other_codes=False):
    """(z (L, G) uint8, p (L,) float32): genomes drawn at F spread over
    [0, 0.8], genome 0 all homozygous (its optimum at f = 1), genome 1 with
    one heterozygous locus (the het clamp binds at the grid's last point);
    other_codes puts codes 3 and 255 in a few cells."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.05, 0.5, L).astype(np.float32)
    f = np.linspace(0.0, 0.8, G)
    ibd = rng.random((L, G)) < f
    one = rng.random((L, G)) < p[:, None]
    z = (one.astype(np.uint8) + np.where(ibd, one, rng.random((L, G)) < p[:, None]))
    z[:, 0] = np.where(rng.random(L) < p, 2, 0)
    if G > 1:
        z[:, 1] = np.where(rng.random(L) < p, 2, 0)
        z[L // 2, 1] = 1
    if other_codes:
        z[rng.integers(0, L, 5), rng.integers(0, G, 5)] = 3
        z[rng.integers(0, L, 5), rng.integers(0, G, 5)] = 255
    return torch.as_tensor(z.astype(np.uint8)), torch.as_tensor(p)


def mask_of(form, z, p, seed):
    """valid as run_estimators takes it: None, per locus (L, 1) or per
    genome (L, G), with every cell of the last genome left out."""
    L, G = z.shape
    rng = np.random.default_rng(seed + 1)
    if form == "none":
        return None
    if form == "locus":
        return torch.as_tensor(rng.random(L) < 0.8)[:, None]
    v = rng.random((L, G)) < 0.8
    v[:, -1] = False  # a genome with no valid locus: every point ties
    return torch.as_tensor(v)


@pytest.fixture
def small_blocks(monkeypatch):
    """The plain version's blocks of 50 loci, so that L = 260 spans six."""
    def use(G):
        monkeypatch.setattr(inb, "_BLOCK_ELEMENTS", 50 * G)
    return use


@pytest.mark.parametrize("L", (37, 260))
@pytest.mark.parametrize("form", ("none", "locus", "genome"))
@pytest.mark.parametrize("G", (1, 11, 33))
def test_mirror_equals_the_plain_version_and_the_reference(G, L, form, small_blocks):
    small_blocks(G)
    z, p = population(G, L, seed=G * 1000 + L)
    valid = mask_of(form, z, p, seed=G + L)
    plain = inb._loglik_rows_plain(z, p, valid).numpy()
    want = reference_f(z, p, valid)
    np.testing.assert_allclose(plain, want, rtol=0, atol=ATOL)
    for geometry in ((8, 16), (24, 48), (inb.LOGLIK_TABLE_LOCI, 3 * inb.LOGLIK_GROUP)):
        got = mirror(z, p, valid, geometry)
        np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if form == "genome":
        assert plain[-1] < -0.999  # no valid locus: the first point, f = -1
    if form != "genome" or G > 1:
        assert plain[0] > 0.99  # all homozygous: the optimum at f = 1


def test_the_card_geometry_on_the_mirror():
    """The chunks loglik_geometry gives at the cell's card, 132 SMs, on a
    population of 33 genomes x 700 loci (one tile), and at 1,000 loci."""
    for L in (700, 1000):
        z, p = population(33, L, seed=L)
        _tiles, grid_loci, step_loci = inb.loglik_geometry(33, L, 132, 1, 8)
        plain = inb._loglik_rows_plain(z, p, None).numpy()
        np.testing.assert_allclose(mirror(z, p, None, (grid_loci, step_loci)), plain,
                                   rtol=0, atol=ATOL)


def test_codes_past_two_as_the_plain_version():
    """Codes 3 and 255 take the plain version's het term 2 (1 - f) p^2."""
    z, p = population(11, 300, seed=4, other_codes=True)
    np.testing.assert_allclose(mirror(z, p, None, (16, 32)),
                               inb._loglik_rows_plain(z, p, None).numpy(), rtol=0, atol=ATOL)


def test_a_grid_tie_takes_the_first_point():
    """Every locus masked: the objective is 0 at every point, the first
    (f = -1) is taken, and the steps all keep [lo, b]: F tends to -1."""
    z, p = population(11, 100, seed=9)
    valid = torch.zeros((100, 1), dtype=torch.bool)
    plain = inb._loglik_rows_plain(z, p, valid).numpy()
    got = mirror(z, p, valid, (8, 16))
    np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL)
    np.testing.assert_allclose(reference_f(z, p, valid), plain, rtol=0, atol=ATOL)
    assert (got < -0.999).all() and (plain < -0.999).all()


def test_the_plain_version_counts_evaluations_and_passes(small_blocks):
    """145 evaluations a call; a pass a block of loci an evaluation call:
    the grid's chunks of points, then two a step."""
    G, L = 11, 260
    small_blocks(G)
    z, p = population(G, L, seed=3)
    before = dict(inb.COUNTERS)
    inb._loglik_rows_plain(z, p, None)
    got = {k: n - before.get(k, 0) for k, n in inb.COUNTERS.items()}
    blocks = math.ceil(L / inb.loci_block(G))
    chunk = max(1, min(inb._GRID_POINTS, inb._GRID_CHUNK_ELEMENTS // (G * inb.loci_block(G))))
    assert got["loglik_evaluations"] == 65 + 2 * 40
    assert got["loglik_passes"] == blocks * (math.ceil(65 / chunk) + 2 * 40)


@pytest.mark.parametrize("G, L, sms, grid_blocks, step_blocks", [
    (2504, 25000, 132, 1, 8), (11, 100, 132, 1, 8), (1, 1, 132, 1, 8), (1, 0, 132, 1, 8),
    (33, 37, 132, 2, 6), (100_000, 25_000, 132, 1, 8), (2504, 10, 132, 1, 8),
])
def test_geometry_fills_the_card_in_one_wave(G, L, sms, grid_blocks, step_blocks):
    tiles, grid_loci, step_loci = inb.loglik_geometry(G, L, sms, grid_blocks, step_blocks)
    assert tiles * inb.LOGLIK_THREADS >= G > (tiles - 1) * inb.LOGLIK_THREADS
    for loci, unit, blocks, per_chunk in (
            (grid_loci, inb.LOGLIK_TABLE_LOCI, grid_blocks, inb.LOGLIK_POINT_GROUPS),
            (step_loci, inb.LOGLIK_GROUP, step_blocks, 1)):
        chunks = max(1, math.ceil(L / loci))
        assert loci % unit == 0 and chunks * loci >= L
        # one wave, or a chunk a tile
        assert tiles * chunks * per_chunk <= max(tiles * per_chunk, sms * blocks)
    if (G, L) == (2504, 25000):
        assert (tiles, grid_loci, step_loci) == (10, 6256, 240)


def test_the_kernel_constants_are_the_wrappers():
    src = SOURCE.read_text()
    ints = dict(re.findall(r"constexpr int (LL_\w+) = (\d+);", src))
    reals = dict(re.findall(r"constexpr double (LL_\w+) = ([\d.e-]+);", src))
    assert (int(ints["LL_THREADS"]), int(ints["LL_POINT_GROUPS"]), int(ints["LL_TABLE_LOCI"]),
            int(ints["LL_GROUP"]), int(ints["LL_POINTS"]), int(ints["LL_CLASSES"])) == (
        inb.LOGLIK_THREADS, inb.LOGLIK_POINT_GROUPS, inb.LOGLIK_TABLE_LOCI, inb.LOGLIK_GROUP,
        inb._GRID_POINTS, 5)
    groups, pairs = int(ints["LL_POINT_GROUPS"]), int(ints["LL_GROUP_PAIRS"])
    assert 2 * pairs == inb.LOGLIK_GROUP_POINTS
    assert groups * 2 * pairs >= inb._GRID_POINTS > (groups - 1) * 2 * pairs
    assert (float(reals["LL_SMALL"]), float(reals["LL_HALF_WIDTH"]),
            float(reals["LL_GOLDEN"])) == (inb._SMALL_PROB, HALF_WIDTH, GOLDEN)
    assert f"gr = {GOLDEN!r}" in Path(inb.__file__).read_text()
    assert {"kgt_loglik_grid", "kgt_loglik_step", "kgt_loglik_blocks"} <= set(kernels._SIGNATURES)


def _high_word(x: float) -> int:
    return struct.unpack(">I", struct.pack(">d", x)[:4])[0]


def test_the_steps_skip_the_clamp_only_inside_it():
    """A step multiplies a group's factors unclamped when every factor's
    high word lies in [LL_SAFE_LOW, LL_SAFE_LOW + LL_SAFE_SPAN): those are
    the doubles in [2^-32, 1), inside [1e-10, 1], where the clamp is the
    identity; a power-of-two span lets one OR of the offsets test them all."""
    src = SOURCE.read_text()
    low = int(re.search(r"LL_SAFE_LOW = (0x[0-9A-Fa-f]+)u", src).group(1), 16)
    span = _high_word(1.0) - low
    assert low == _high_word(2.0 ** -32) and f"LL_SAFE_SPAN = 0x3FF00000u - LL_SAFE_LOW" in src
    assert span & (span - 1) == 0 and 2.0 ** -32 > inb._SMALL_PROB
    offset = lambda x: (_high_word(x) - low) % 2 ** 32  # noqa: E731
    for x in (2.0 ** -32, 1e-9, 0.5, np.nextafter(1.0, 0.0)):
        assert offset(x) < span
    for x in (1.0, 1.5, np.nextafter(2.0 ** -32, 0.0), 1e-10, 0.0, -0.0, -1e-300, -0.5):
        assert offset(x) >= span


def test_mask_forms():
    L, G = 6, 4
    per_locus = torch.tensor([True, False, True, True, False, True])
    per_genome = torch.rand(L, G) < 0.5
    assert inb._mask_form(None) == (0, None)
    for given in (per_locus, per_locus[:, None], per_locus[:, None].expand(L, G),
                  per_locus.expand(G, L).t()):
        mask, t = inb._mask_form(given)
        assert mask == 1 and t.shape == (L,) and t.is_contiguous()
        assert torch.equal(t, per_locus)
    mask, t = inb._mask_form(per_genome)
    assert mask == 2 and torch.equal(t, per_genome) and t.is_contiguous()
    mask, t = inb._mask_form(per_genome.t().contiguous().t())
    assert mask == 2 and torch.equal(t, per_genome) and t.is_contiguous()


def test_a_tensor_off_the_cpu_never_takes_the_plain_version(monkeypatch):
    """Any tensor but a CPU one goes to the kernel's wrapper, which raises
    off the card: no fallback to the eager version."""
    def plain(*_a):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(inb, "_loglik_rows_plain", plain)
    z = torch.zeros((40, 5), dtype=torch.uint8, device="meta")
    p = torch.zeros(40, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="on the card"):
        inb._loglik_rows(z, p, None)
