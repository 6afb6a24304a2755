"""Inbreeding-coefficient estimation, batched over genomes on the device.

Counterpart of kgl_gene_tpu/stats/inbreeding.py, in PyTorch. Capability
parity with the reference inbreeding plugin's four algorithms
(kga_analytic/kga_inbreed/kga_analysis_inbreed_calc.h:72,113-118 and
.cpp:94-432): Ritland multi-locus, Simple (F = 1 - obs/exp heterozygosity),
Hall expectation-maximisation, and maximum log-likelihood. The genomes'
codes at the selected loci are one locus-major (L, G) uint8 tensor, put on
the device once for all the estimators of a call (run_estimators), and
each estimator works on all genomes at once, in float32 (the JAX
package's default precision), over blocks of loci: a block holds
loci_block(G) loci, so every temporary is bounded by _BLOCK_ELEMENTS cells
and not by L; per-genome sums accumulate over the blocks.

  - HallME iterates every genome until its own stop test holds (|f -
    prev| <= 1e-4, or 1,000 steps); a genome that stopped is frozen while
    the others run on, as JAX's while_loop under vmap does. The host reads
    "any genome still running" every _EM_CHECK_EVERY steps. On the card a
    step is kernel `hallme` (csrc/hallme.cu): one launch, one pass over the
    codes, the update in the same launch, and a tile of genomes that has
    all stopped reads no code. A CPU tensor takes the plain version,
    _hall_me_rows_plain: a step is a pass over the blocks, in eager float32.
  - Loglikelihood scans a 65-point grid of f, takes the first best point,
    then refines by 40 golden-section steps, the objective in float64. On
    the card it is kernel `loglik` (csrc/loglik.cu): 41 passes over the
    codes, one launch each, the grid from a table of per-locus
    log-probabilities and both points of a step in one pass. A CPU tensor
    takes the plain version, _loglik_rows_plain: the same search in eager
    float64 over the blocks, the grid in chunks of points sized from the
    block (_GRID_CHUNK_ELEMENTS cells of (points, loci, genomes) at most).

COUNTERS counts, over the process, the loci estimated (a call's L), the
HallME steps run and the host reads of its stop test (the first, at step
0, holds with no read on the card: every genome starts running), the
kernel's HallME passes (a launch a step; none in the plain version) and
the tile passes its stopped tiles saved (read once a call), the log-likelihood
evaluations (one f point for every genome: 145 a call) and the
log-likelihood passes over the codes (a block of the plain version's
evaluations, or a launch of the kernel); spans (tracing.span) name each
estimator's stage, kgt.inbreed.ritland, .simple, .hallme and .loglik.

Locus classes (kga_analysis_inbreed_freq.cpp:426-515): for each biallelic
SNP locus with minor allele frequency p (q = 1-p), a diploid genome is
MAJOR_HOMOZYGOUS (no minor allele, first-allele freq q), MAJOR_HETEROZYGOUS
(one minor, freqs p and q), or MINOR_HOMOZYGOUS (two minor, freq p).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import kernels, resolve_device
from ..tracing import span

__all__ = [
    "COUNTERS",
    "ESTIMATOR_SPANS",
    "LocusData",
    "loci_block",
    "loglik_geometry",
    "ritland_f",
    "simple_f",
    "hall_me_f",
    "hallme_geometry",
    "loglikelihood_f",
    "inbreeding_all",
    "run_estimator",
    "run_estimators",
    "synthetic_diploid_population",
]

_SMALL_PROB = 1e-10
_MIN_RITLAND_FREQ = 0.001  # rare-homozygote guard (processRitlandLocus)
_EM_TOL = 1e-4
_EM_MAX_ITER = 1000
_EM_CHECK_EVERY = 8        # steps between host reads of "any row still running"
_GRID_POINTS = 65
_GOLDEN_STEPS = 40
# Cells (loci x genomes) of a block: a float64 temporary of a block is 256 MB.
_BLOCK_ELEMENTS = 1 << 25
# Cells (grid points x loci x genomes) of one chunk of the Loglikelihood grid.
_GRID_CHUNK_ELEMENTS = 1 << 25
# Kernel `loglik` (csrc/loglik.cu, LL_*): genomes a block (a tile), grid
# blocks a tile and chunk (each a third of the points), loci a grid block
# stages the log table of at a time, probabilities multiplied before one log.
LOGLIK_THREADS = 256
LOGLIK_POINT_GROUPS = 3
LOGLIK_GROUP_POINTS = 22  # a grid block's points, 66 with the pad
LOGLIK_TABLE_LOCI = 16
LOGLIK_GROUP = 16
# Kernel `hallme` (csrc/hallme.cu, HM_*): warps a block (each takes a
# chunk's rows in turn), genomes a thread (one 4-byte load a row), genomes
# a tile (a warp's width), rows of a warp in flight.
HALLME_WARPS = 8
HALLME_VEC = 4
HALLME_TILE = 128
HALLME_ROWS = 4

# Work counted over the process (as kernels.LAUNCHES counts launches).
COUNTERS: collections.Counter = collections.Counter()

ESTIMATOR_SPANS = {
    "RitlandLocus": "kgt.inbreed.ritland",
    "Simple": "kgt.inbreed.simple",
    "HallME": "kgt.inbreed.hallme",
    "Loglikelihood": "kgt.inbreed.loglik",
}


@dataclass
class LocusData:
    """Per-genome locus classification arrays.

    zygosity: (G, L) uint8 in {0 = major hom, 1 = het, 2 = minor hom};
    minor_freq: (L,) minor allele frequency p from the super-population;
    valid: (G, L) bool mask of usable loci (frequency known, biallelic).
    """

    zygosity: np.ndarray
    minor_freq: np.ndarray
    valid: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.valid is None:
            ok = (self.minor_freq > 0.0) & (self.minor_freq < 1.0)
            self.valid = np.broadcast_to(ok, self.zygosity.shape).copy()

    @classmethod
    def from_variant_view(cls, view, minor_freq: np.ndarray) -> "LocusData":
        return cls(zygosity=np.asarray(view.zygosity), minor_freq=np.asarray(minor_freq))


def loci_block(genomes: int) -> int:
    """Loci a block of the estimators holds for `genomes` genomes."""
    return max(1, _BLOCK_ELEMENTS // max(genomes, 1))


def _blocks(z, p, valid, loci: Optional[int] = None):
    """(codes, p, valid) of each block of loci: z (L, G), p as (Lb, 1), and
    valid None (every locus), (Lb, 1) or (Lb, G)."""
    L, G = z.shape
    step = loci or loci_block(G)
    for l0 in range(0, L, step):
        vb = None if valid is None else valid[l0:l0 + step]
        yield z[l0:l0 + step], p[l0:l0 + step, None], vb


def _valid_loci(z, valid) -> torch.Tensor:
    """Valid loci of each genome (G,)."""
    L, G = z.shape
    if valid is None:
        return torch.full((G,), L, dtype=torch.int64, device=z.device)
    return valid.sum(0).expand(G)


def _first_allele_freq(z: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """First-allele frequency per class: hom-major -> q, het -> p, hom-minor -> p."""
    return torch.where(z == 0, 1.0 - p, p)


def _masked(mask, valid):
    return mask if valid is None else mask & valid


# --------------------------------------------------------------------------- #
# estimators: each maps (zygosity (L, G) locus-major, p (L,), valid None,
# (L, 1) or (L, G)) -> F (G,)
# --------------------------------------------------------------------------- #
def _ritland_rows(z, p, valid):
    G = z.shape[1]
    total = torch.zeros(G, dtype=p.dtype, device=z.device)
    count = torch.zeros(G, dtype=torch.int64, device=z.device)
    for zb, pb, vb in _blocks(z, p, valid):
        first = _first_allele_freq(zb, pb)
        hom_ok = _masked(((zb == 0) | (zb == 2)) & (first > _MIN_RITLAND_FREQ), vb)
        het_ok = _masked(zb == 1, vb)
        contrib = torch.where(hom_ok, 1.0 / torch.where(hom_ok, first, 1.0) - 1.0, 0.0)
        total = total + (contrib - het_ok.to(contrib.dtype)).sum(0)
        count = count + hom_ok.sum(0) + het_ok.sum(0)
    return torch.where(count > 0, total / count, 0.0)


def _simple_rows(z, p, valid):
    G = z.shape[1]
    obs_hom = torch.zeros(G, dtype=torch.int64, device=z.device)
    exp_hom = torch.zeros(1, dtype=p.dtype, device=z.device)
    for zb, pb, vb in _blocks(z, p, valid):
        obs_hom = obs_hom + _masked((zb == 0) | (zb == 2), vb).sum(0)
        pq = pb * pb + (1.0 - pb) * (1.0 - pb)
        exp_hom = exp_hom + (pq if vb is None else torch.where(vb, pq, 0.0)).sum(0)
    denom = _valid_loci(z, valid) - exp_hom
    return torch.where(denom != 0, (obs_hom - exp_hom) / denom, 0.0)


def _hall_me_rows_plain(z, p, valid):
    G = z.shape[1]
    n = _valid_loci(z, valid)
    f = torch.full((G,), 0.25, dtype=p.dtype, device=z.device)
    prev = torch.full((G,), 1.0, dtype=p.dtype, device=z.device)
    it = torch.zeros(G, dtype=torch.int32, device=z.device)
    active = torch.ones(G, dtype=torch.bool, device=z.device)
    for step in range(_EM_MAX_ITER):
        if step % _EM_CHECK_EVERY == 0:
            COUNTERS["hallme_stop_reads"] += 1
            if not bool(active.any()):
                break
        COUNTERS["hallme_steps"] += 1
        term = torch.zeros(G, dtype=p.dtype, device=z.device)
        for zb, pb, vb in _blocks(z, p, valid):
            first = _first_allele_freq(zb, pb)
            is_hom = _masked((zb == 0) | (zb == 2), vb)
            denom = f + (1.0 - f) * first
            term = term + torch.where(is_hom & (denom != 0), f / denom, 0.0).sum(0)
        new_f = torch.where(n > 0, term / n, 0.0)
        # a row whose stop test holds keeps its f: frozen rows do not move
        prev = torch.where(active, f, prev)
        f = torch.where(active, new_f, f)
        it = it + active.to(torch.int32)
        active = ((f - prev).abs() > _EM_TOL) & (it < _EM_MAX_ITER)
    return f


def _loglik(f, z, p, valid, loci: Optional[int] = None):
    """Log-likelihood of f (G,) for each genome, or of f (C, G) at C points
    for each genome, in the dtype of f, summed over blocks of `loci` loci."""
    COUNTERS["loglik_evaluations"] += 1 if f.dim() == 1 else f.shape[0]
    total = torch.zeros_like(f)
    fb = f[:, None, :] if f.dim() == 2 else f  # (C, 1, G): the points on a leading axis
    for zb, pb, vb in _blocks(z, p.to(f.dtype), valid, loci):
        COUNTERS["loglik_passes"] += 1
        first = _first_allele_freq(zb, pb)
        second = torch.where(zb == 1, 1.0 - pb, first)
        is_hom = (zb == 0) | (zb == 2)
        hom_prob = fb * first + (1.0 - fb) * first * first
        het_prob = 2.0 * (1.0 - fb) * first * second
        logp = torch.log(torch.where(is_hom, hom_prob, het_prob).clamp(_SMALL_PROB, 1.0))
        if vb is not None:
            logp = torch.where(vb, logp, 0.0)
        total = total + logp.sum(-2)
    return total


def _loglik_rows_plain(z, p, valid):
    """MLE of f in [-1, 1]: coarse grid then golden-section refinement
    (replaces the nlopt LN_NELDERMEAD call, kga_analysis_inbreed_calc.cpp:131).

    The objective is evaluated in float64. In float32 a sum of L log terms
    (about -0.6 L) carries rounding of order 1e-4 to 1e-3 at L in the
    thousands, while within a few 1e-4 of the optimum the function changes
    by less than that: two float32 sums in different orders (the JAX
    package's XLA reduction, PyTorch's on the CPU or on the card) then stop
    at points up to about 5e-4 apart. The JAX package's float32 result lies
    that far from the exact maximum itself; with x64 enabled it agrees with
    this one. Returns float32, as the other estimators."""
    L, G = z.shape
    grid = torch.linspace(-1.0, 1.0, _GRID_POINTS, dtype=torch.float64, device=z.device)
    block = min(max(L, 1), loci_block(G))
    chunk = max(1, min(_GRID_POINTS, _GRID_CHUNK_ELEMENTS // (G * block)))
    vals = torch.cat([
        _loglik(grid[c0:c0 + chunk, None].expand(-1, G), z, p, valid, block)
        for c0 in range(0, _GRID_POINTS, chunk)
    ], dim=0)
    k = torch.argmax(vals, dim=0)  # ties: the first index, as jnp.argmax
    lo = (grid[k] - 0.04).clamp(-1.0, 1.0)
    hi = (grid[k] + 0.04).clamp(-1.0, 1.0)
    gr = 0.618033988749895
    for _ in range(_GOLDEN_STEPS):
        a = hi - gr * (hi - lo)
        b = lo + gr * (hi - lo)
        b_better = _loglik(a, z, p, valid) < _loglik(b, z, p, valid)
        lo, hi = torch.where(b_better, a, lo), torch.where(b_better, hi, b)
    return ((lo + hi) / 2.0).to(torch.float32)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def loglik_geometry(G: int, L: int, sms: int, grid_blocks: int,
                    step_blocks: int) -> tuple[int, int, int]:
    """(tiles, grid chunk loci, step chunk loci) of kernel `loglik` for G
    genomes and L loci on a card of `sms` SMs that holds grid_blocks blocks
    of the grid pass and step_blocks of a step an SM: a tile is
    LOGLIK_THREADS genomes, and a tile's loci are cut into as many chunks as
    keep every block of a pass on the card at once (one wave; the grid has
    LOGLIK_POINT_GROUPS blocks a tile and chunk), a grid chunk a multiple of
    LOGLIK_TABLE_LOCI loci and a step chunk of LOGLIK_GROUP."""
    tiles = _ceil_div(G, LOGLIK_THREADS)

    def chunk_loci(blocks_an_sm: int, per_chunk: int, unit: int) -> int:
        chunks = max(1, sms * blocks_an_sm // (tiles * per_chunk))
        return max(unit, _ceil_div(_ceil_div(L, chunks), unit) * unit)

    return (tiles, chunk_loci(grid_blocks, LOGLIK_POINT_GROUPS, LOGLIK_TABLE_LOCI),
            chunk_loci(step_blocks, 1, LOGLIK_GROUP))


def _mask_form(valid):
    """(mask, bool tensor) as kernels `loglik` and `hallme` take a mask: 0
    and None where every cell counts, 1 and (L,) where the mask is a locus's
    (given as (L,), (L, 1) or broadcast over the genomes with stride 0), 2
    and (L, G)."""
    if valid is None:
        return 0, None
    if valid.dim() == 2 and valid.shape[1] > 1 and valid.stride(1) != 0:
        return 2, valid.to(torch.bool).contiguous()
    return 1, (valid if valid.dim() == 1 else valid[:, 0]).to(torch.bool).contiguous()


# (device index, mask) -> (SMs, blocks of the grid pass an SM, of a step)
_BLOCKS_AN_SM: Dict[tuple, tuple] = {}


def _loglik_rows_kernel(z, p, valid):
    """_loglik_rows_plain's result from kernel `loglik`: the grid pass, then
    40 step passes, each counted as a pass and its points as evaluations.
    z (L, G) codes (taken as uint8), p (L,) AF (taken as float32), valid as
    run_estimators passes it. Raises unless the tensors lie on the card."""
    L, G = z.shape
    out = torch.empty(G, dtype=torch.float32, device=z.device)
    codes = z if z.dtype == torch.uint8 else z.to(torch.uint8)
    codes, af = codes.contiguous(), p.to(torch.float32).contiguous()
    mask, mask_t = _mask_form(valid)
    kernels.check_args(torch.uint8, codes=codes)
    kernels.check_args(torch.float32, af=af)
    if G == 0:
        return out
    dev = z.device
    key = (dev.index, mask)
    if key not in _BLOCKS_AN_SM:
        with torch.cuda.device(dev):
            lib = kernels.library()
            _BLOCKS_AN_SM[key] = (torch.cuda.get_device_properties(dev).multi_processor_count,
                                  lib.kgt_loglik_blocks(0, mask), lib.kgt_loglik_blocks(1, mask))
    tiles, grid_loci, step_loci = loglik_geometry(G, L, *_BLOCKS_AN_SM[key])
    grid_chunks, step_chunks = (max(1, _ceil_div(L, n)) for n in (grid_loci, step_loci))
    terms = torch.empty((L, 5, 2), dtype=torch.float64, device=dev)
    logs = torch.empty((L, 4, LOGLIK_POINT_GROUPS * LOGLIK_GROUP_POINTS), dtype=torch.float64,
                       device=dev)
    partial = torch.empty(max(grid_chunks * _GRID_POINTS, step_chunks * 2) * G,
                          dtype=torch.float64, device=dev)
    bracket = torch.empty((2, G), dtype=torch.float64, device=dev)
    tickets = torch.zeros(tiles, dtype=torch.int32, device=dev)
    valid_ptr = None if mask_t is None else mask_t.data_ptr()
    kernels.launch("loglik", "kgt_loglik_grid", dev, codes.data_ptr(), G, L, af.data_ptr(),
                   valid_ptr, mask, grid_loci, terms.data_ptr(), logs.data_ptr(),
                   partial.data_ptr(), tickets.data_ptr(), bracket[0].data_ptr(),
                   bracket[1].data_ptr())
    COUNTERS["loglik_evaluations"] += _GRID_POINTS
    COUNTERS["loglik_passes"] += 1
    for step in range(_GOLDEN_STEPS):
        kernels.launch("loglik", "kgt_loglik_step", dev, codes.data_ptr(), G, L, valid_ptr,
                       mask, step_loci, terms.data_ptr(), partial.data_ptr(), tickets.data_ptr(),
                       bracket[0].data_ptr(), bracket[1].data_ptr(),
                       out.data_ptr() if step == _GOLDEN_STEPS - 1 else None)
        COUNTERS["loglik_evaluations"] += 2
        COUNTERS["loglik_passes"] += 1
    return out


def _loglik_rows(z, p, valid):
    """The Loglikelihood estimator: the plain version for a CPU tensor,
    kernel `loglik` for any other (which raises off the card)."""
    if z.device.type == "cpu":
        return _loglik_rows_plain(z, p, valid)
    return _loglik_rows_kernel(z, p, valid)


def hallme_geometry(G: int, L: int, sms: int, blocks_an_sm: int) -> tuple[int, int]:
    """(tiles, chunk loci) of kernel `hallme` for G genomes and L loci on a
    card of `sms` SMs that holds blocks_an_sm blocks of a step an SM: a
    tile is HALLME_TILE genomes, and a tile's loci are cut into as many
    chunks as keep every block of a step on the card at once (one wave),
    a chunk a multiple of HALLME_WARPS x HALLME_ROWS loci (each warp's rows
    whole groups in flight)."""
    tiles = _ceil_div(G, HALLME_TILE)
    unit = HALLME_WARPS * HALLME_ROWS
    chunks = max(1, sms * blocks_an_sm // tiles)
    return tiles, max(unit, _ceil_div(_ceil_div(L, chunks), unit) * unit)


# (device index, mask, wide) -> (SMs, blocks of a HallME step an SM)
_HALLME_BLOCKS: Dict[tuple, tuple] = {}


def _hall_me_rows_kernel(z, p, valid):
    """_hall_me_rows_plain's result from kernel `hallme`: a launch a step,
    each counted as a step and a pass; every _EM_CHECK_EVERY steps one read
    of each tile's running genomes (and the tiles skipped so far), which
    waits for the steps before it. z (L, G) codes (taken as uint8), p (L,)
    AF (taken as float32), valid as run_estimators passes it. Raises
    unless the tensors lie on the card."""
    L, G = z.shape
    codes = z if z.dtype == torch.uint8 else z.to(torch.uint8)
    codes, af = codes.contiguous(), p.to(torch.float32).contiguous()
    mask, mask_t = _mask_form(valid)
    kernels.check_args(torch.uint8, codes=codes)
    kernels.check_args(torch.float32, af=af)
    dev = z.device
    if G == 0:
        COUNTERS["hallme_stop_reads"] += 1  # no genome runs
        return torch.empty(0, dtype=torch.float32, device=dev)
    valid_ptr = None if mask_t is None else mask_t.data_ptr()
    wide = G % HALLME_VEC == 0 and codes.data_ptr() % 4 == 0 and (
        mask != 2 or valid_ptr % 4 == 0)
    key = (dev.index, mask, wide)
    if key not in _HALLME_BLOCKS:
        with torch.cuda.device(dev):
            _HALLME_BLOCKS[key] = (torch.cuda.get_device_properties(dev).multi_processor_count,
                                   kernels.library().kgt_hallme_blocks(mask, int(wide)))
    tiles, chunk_loci = hallme_geometry(G, L, *_HALLME_BLOCKS[key])
    chunks = max(1, _ceil_div(L, chunk_loci))
    padded = tiles * HALLME_TILE
    state = torch.empty((4, padded), dtype=torch.float32, device=dev)  # f, prev, n, steps
    partial = torch.empty(chunks * 2 * padded, dtype=torch.float64, device=dev)
    # tickets (tiles), then each tile's running genomes (tiles) and the tiles skipped
    ints = torch.zeros(2 * tiles + 1, dtype=torch.int32, device=dev)
    tickets, read = ints[:tiles], ints[tiles:]
    args = (codes.data_ptr(), G, L, af.data_ptr(), valid_ptr, mask, int(wide), chunk_loci)
    tail = (state.data_ptr(), partial.data_ptr(), tickets.data_ptr(), read.data_ptr(),
            read[tiles:].data_ptr())
    for step in range(_EM_MAX_ITER):
        if step % _EM_CHECK_EVERY == 0:
            COUNTERS["hallme_stop_reads"] += 1
            if step:
                counts = read.cpu().numpy()
                if not counts[:tiles].any():
                    break
        kernels.launch("hallme", "kgt_hallme_step", dev, *args, int(step == 0), *tail)
        COUNTERS["hallme_steps"] += 1
        COUNTERS["hallme_passes"] += 1
    else:
        counts = read.cpu().numpy()  # the cap: the last steps ran past the last read
    COUNTERS["hallme_tiles_skipped"] += int(counts[tiles])
    return state[0, :G]


def _hall_me_rows(z, p, valid):
    """The HallME estimator: the plain version for a CPU tensor, kernel
    `hallme` for any other (which raises off the card)."""
    if z.device.type == "cpu":
        return _hall_me_rows_plain(z, p, valid)
    return _hall_me_rows_kernel(z, p, valid)


_ESTIMATORS = {
    "RitlandLocus": _ritland_rows,
    "Simple": _simple_rows,
    "HallME": _hall_me_rows,
    "Loglikelihood": _loglik_rows,
}


def run_estimators(algorithms: Sequence[str], zygosity: torch.Tensor, minor_freq: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F (G, len(algorithms)) float32, a column an estimator in the order
    given, from device tensors of the selected loci: zygosity (L, G) codes
    (locus-major: a genome a column), minor_freq (L,) float32, valid None
    (every locus), a per-locus (L,) mask or a per-genome (L, G) mask."""
    if valid is not None and valid.dim() == 1:
        valid = valid[:, None]
    COUNTERS["loci"] += zygosity.shape[0]
    with torch.no_grad():
        columns = []
        for name in algorithms:
            with span(ESTIMATOR_SPANS[name]):
                columns.append(_ESTIMATORS[name](zygosity, minor_freq, valid).to(torch.float32))
        return torch.stack(columns, dim=1)


def run_estimator(algorithm: str, zygosity: torch.Tensor, minor_freq: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """F per genome (G,) float32 from device tensors: zygosity (G, L) int32,
    minor_freq (L,) float32, valid (G, L) bool."""
    return run_estimators([algorithm], zygosity.t(), minor_freq, valid.t())[:, 0]


def _estimate_all(algorithms: Sequence[str], data: LocusData, device=None) -> np.ndarray:
    """(G, len(algorithms)) F from one upload of the locus data: the codes
    as uint8, locus-major; a mask the same for every genome as one (L,)
    mask, and none where every locus is valid."""
    dev = resolve_device(device)
    z = np.asarray(data.zygosity)
    valid = np.asarray(data.valid, dtype=bool)
    if valid.shape[0] == 0 or (valid == valid[:1]).all():
        per_locus = valid[0] if valid.shape[0] else np.ones(z.shape[1], dtype=bool)
        valid_t = None if per_locus.all() else torch.as_tensor(per_locus, device=dev)
    else:
        valid_t = torch.as_tensor(np.ascontiguousarray(valid.T), device=dev)
    codes = torch.as_tensor(np.ascontiguousarray(z.T, dtype=np.uint8), device=dev)
    p = torch.as_tensor(np.asarray(data.minor_freq, dtype=np.float32), device=dev)
    return run_estimators(algorithms, codes, p, valid_t).cpu().numpy()


def _estimate(algorithm: str, data: LocusData, device=None) -> np.ndarray:
    return _estimate_all([algorithm], data, device)[:, 0]


def ritland_f(data: LocusData, device=None) -> np.ndarray:
    return _estimate("RitlandLocus", data, device)


def simple_f(data: LocusData, device=None) -> np.ndarray:
    return _estimate("Simple", data, device)


def hall_me_f(data: LocusData, device=None) -> np.ndarray:
    return _estimate("HallME", data, device)


def loglikelihood_f(data: LocusData, device=None) -> np.ndarray:
    return _estimate("Loglikelihood", data, device)


def inbreeding_all(data: LocusData, device=None) -> Dict[str, np.ndarray]:
    """All four estimators per genome (the reference's algoMap), from one
    upload of the locus data."""
    f = _estimate_all(list(_ESTIMATORS), data, device)
    return {name: f[:, k] for k, name in enumerate(_ESTIMATORS)}


# --------------------------------------------------------------------------- #
# synthetic validation data (InbreedSynthetic analogue,
# kga_analysis_inbreed_synthetic.h:56)
# --------------------------------------------------------------------------- #
def synthetic_diploid_population(
    n_genomes: int,
    n_loci: int,
    inbreeding: np.ndarray,
    seed: int = 0,
    freq_low: float = 0.05,
    freq_high: float = 0.45,
) -> LocusData:
    """Generate diploid genotypes with known per-genome inbreeding
    coefficients: with probability f the genome is IBD at a locus (genotype
    drawn as one allele), else HWE."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(freq_low, freq_high, size=n_loci)
    inbreeding = np.asarray(inbreeding, dtype=np.float64)
    z = np.zeros((n_genomes, n_loci), dtype=np.uint8)
    for g in range(n_genomes):
        f = inbreeding[g]
        ibd = rng.random(n_loci) < f
        one_draw = rng.random(n_loci) < p
        a1 = np.where(ibd, one_draw, rng.random(n_loci) < p)
        a2 = np.where(ibd, one_draw, rng.random(n_loci) < p)
        z[g] = a1.astype(np.uint8) + a2.astype(np.uint8)
    return LocusData(zygosity=z, minor_freq=p)
