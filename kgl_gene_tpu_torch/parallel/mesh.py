"""Population reductions on one device: allele counts, het/hom counts,
per-genome inbreeding, and inbreeding streamed over a population too large
to densify.

Counterpart of the single-device forms of kgl_gene_tpu/parallel/mesh.py.
The JAX functions shard the genomes x variants zygosity matrix over a mesh
and merge per-shard partials with collectives; with one device each is one
reduction, so these take a torch device (resolved by resolve_device: the
card unless the caller asks for the CPU) instead of a mesh. The forms over
several devices wait for torch.distributed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..stats.inbreeding import _MIN_RITLAND_FREQ, run_estimator

__all__ = [
    "pad_to_multiple",
    "sharded_allele_counts",
    "sharded_het_hom",
    "sharded_inbreeding",
    "streamed_inbreeding",
]

# Elements of a (rows, G) slab that _inbreed_moments works on at a time:
# eager PyTorch materialises every temporary of the slab (the lane's codes,
# the first-allele frequencies, masks and contributions), about 12 bytes an
# element, so a slab of 2^24 elements keeps them near 200 MB.
SLAB_ELEMENTS = 1 << 24


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0,
                    fill=0) -> np.ndarray:
    """Pad an axis up to a multiple (static-shape sharding requirement)."""
    size = array.shape[axis]
    target = ((size + multiple - 1) // multiple) * multiple
    if target == size:
        return array
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, target - size)
    return np.pad(array, pad, constant_values=fill)


def _zygosity_on(zygosity: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(zygosity, dtype=np.uint8), device=dev)


def sharded_allele_counts(zygosity: np.ndarray, device=None) -> np.ndarray:
    """AC per variant: the zygosity codes summed over genomes (int32).

    Replaces the mutex-guarded merge of PopulationDB::addVariant counts
    (kgl_variant_db_population.h:106-110)."""
    z = _zygosity_on(zygosity, resolve_device(device))
    return z.sum(0, dtype=torch.int32).cpu().numpy()


def sharded_het_hom(zygosity: np.ndarray, device=None) -> tuple:
    """(het, hom) counts per variant (int32)."""
    z = _zygosity_on(zygosity, resolve_device(device))
    het = (z == 1).sum(0, dtype=torch.int32)
    hom = (z == 2).sum(0, dtype=torch.int32)
    return het.cpu().numpy(), hom.cpu().numpy()


def sharded_inbreeding(
    zygosity: np.ndarray,
    minor_freq: np.ndarray,
    device=None,
    algorithm: str = "Simple",
) -> np.ndarray:
    """Per-genome inbreeding F, every genome a row of one batched estimator
    (the reference's thread-per-genome pool, kga_analysis_inbreed: one F
    per sample). A locus is valid where 0 < p < 1."""
    dev = resolve_device(device)
    z = _zygosity_on(zygosity, dev).to(torch.int32)
    p = torch.as_tensor(np.asarray(minor_freq, dtype=np.float32), device=dev)
    valid = ((p > 0.0) & (p < 1.0)).expand(z.shape)
    return run_estimator(algorithm, z, p, valid).cpu().numpy()


def _inbreed_moments(packed: torch.Tensor, p_block: torch.Tensor,
                     acc: torch.Tensor) -> torch.Tensor:
    """Accumulate per-genome inbreeding moment partials for one 2-bit
    packed zygosity chunk: packed (W/4, G) uint8 carries 4 loci a byte in
    variant-major orientation (the host's densify streams sequentially only
    in this layout, see dense_block_t); p_block (W,) float32; acc (G, 5)
    float32 holds (Ritland contributions, Ritland count, observed
    homozygotes, expected homozygotes, valid loci). Returns acc + this
    chunk's partials.

    The four 2-bit lanes are passed over in order (j = 0..3, loci 4r + j),
    each in slabs of packed rows of at most SLAB_ELEMENTS elements, so the
    temporaries stay bounded at any chunk size."""
    rows, G = packed.shape
    slab = max(1, SLAB_ELEMENTS // max(G, 1))
    r_contrib = torch.zeros(G, dtype=torch.float32, device=packed.device)
    r_count = torch.zeros(G, dtype=torch.float32, device=packed.device)
    s_obs = torch.zeros(G, dtype=torch.float32, device=packed.device)
    s_exp = torch.zeros((), dtype=torch.float32, device=packed.device)
    s_n = torch.zeros((), dtype=torch.float32, device=packed.device)
    for j, s in enumerate((0, 2, 4, 6)):
        p_lane = p_block[j::4].to(torch.float32)                # (W/4,)
        valid_lane = (p_lane > 0.0) & (p_lane < 1.0)
        q_lane = 1.0 - p_lane
        s_exp = s_exp + torch.where(valid_lane, p_lane * p_lane + q_lane * q_lane, 0.0).sum()
        s_n = s_n + valid_lane.sum().to(torch.float32)
        for r0 in range(0, rows, slab):
            z = (packed[r0:r0 + slab] >> s) & 3                 # (slab, G) uint8
            p = p_lane[r0:r0 + slab, None]
            valid = valid_lane[r0:r0 + slab, None]
            first = torch.where(z == 0, q_lane[r0:r0 + slab, None], p)
            is_hom = (z == 0) | (z == 2)
            hom_ok = is_hom & (first > _MIN_RITLAND_FREQ) & valid
            het_ok = (z == 1) & valid
            r_contrib = r_contrib + (
                torch.where(hom_ok, 1.0 / torch.where(hom_ok, first, 1.0) - 1.0, 0.0)
                - het_ok.to(torch.float32)
            ).sum(0)
            r_count = r_count + (hom_ok | het_ok).sum(0).to(torch.float32)
            s_obs = s_obs + (is_hom & valid).sum(0).to(torch.float32)
    upd = torch.stack([r_contrib, r_count, s_obs, s_exp.expand(G), s_n.expand(G)], dim=1)
    return acc + upd


def pack_block(block: np.ndarray) -> np.ndarray:
    """(W, G) uint8 codes in {0, 1, 2}, W a multiple of 4 -> (W/4, G) uint8,
    four loci a byte: locus 4r + j in bits 2j, 2j + 1 of row r."""
    return (block[0::4] | (block[1::4] << 2) | (block[2::4] << 4) | (block[3::4] << 6))


def streamed_inbreeding(
    csr,
    minor_freq: np.ndarray,
    device=None,
    block_variants: Optional[int] = None,
    algorithms: Sequence[str] = ("Simple", "RitlandLocus"),
) -> dict:
    """Per-genome inbreeding over ALL variants of a population too large to
    densify at once: VariantMajorCSR dense blocks, 2-bit packed, stream to
    the device as uint8 (through pinned memory on the card) and per-genome
    moment partials accumulate in a (G, 5) float32 tensor that stays on the
    device; the host fetches it once at the end.

    Simple (F = (obs_hom - exp_hom)/(n - exp_hom)) and Ritland multi-locus
    (mean of per-locus hom/het contributions, kga_analysis_inbreed_calc.cpp)
    are exact sums of per-locus terms, so chunk accumulation reproduces the
    single-shot estimators up to float32 summation order. Blocks default to
    the JAX package's size (about 4 GB of zygosity, variants rounded up to
    a multiple of 131,072); each is reduced in row slabs of at most
    SLAB_ELEMENTS elements."""
    dev = resolve_device(device)
    G = csr.genome_count
    if block_variants is None:
        mem_cols = max(131072, int(4e9) // max(G, 1))
        v_cols = ((max(csr.variant_count, 1) + 131071) // 131072) * 131072
        block_variants = min(mem_cols, v_cols)
    block_variants = ((block_variants + 3) // 4) * 4  # 2-bit pack granularity
    V = csr.variant_count
    minor_freq = np.asarray(minor_freq, dtype=np.float32)
    acc = torch.zeros((G, 5), dtype=torch.float32, device=dev)
    pin = dev.type == "cuda"
    for v_lo in range(0, V, block_variants):
        v_hi = min(v_lo + block_variants, V)
        block = csr.dense_block_t(v_lo, v_hi)  # (width, G) uint8
        if v_hi - v_lo < block_variants:
            block = np.pad(block, ((0, block_variants - (v_hi - v_lo)), (0, 0)))
        # pad with p = 0: invalid loci, excluded from every sum
        p_blk = np.zeros(block_variants, np.float32)
        p_blk[: v_hi - v_lo] = minor_freq[v_lo:v_hi]
        packed = torch.from_numpy(pack_block(block))
        p_host = torch.from_numpy(p_blk)
        if pin:
            packed, p_host = packed.pin_memory(), p_host.pin_memory()
        acc = _inbreed_moments(packed.to(dev, non_blocking=True),
                               p_host.to(dev, non_blocking=True), acc)
    a = acc.cpu().numpy()
    r_contrib, r_count, s_obs, s_exp, s_n = (a[:, i] for i in range(5))
    out = {}
    for name in algorithms:
        if name == "Simple":
            denom = s_n - s_exp
            out[name] = np.where(denom != 0, (s_obs - s_exp) / denom, 0.0)
        elif name == "RitlandLocus":
            out[name] = np.where(r_count > 0, r_contrib / np.maximum(r_count, 1.0), 0.0)
        else:
            raise ValueError(
                f"{name} is not chunk-decomposable; use sharded_inbreeding "
                "on a dense window for HallME/Loglikelihood"
            )
    return out
