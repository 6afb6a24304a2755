"""Population reductions over a mesh of ranks or on one device: allele
counts, het/hom counts, per-genome inbreeding, inbreeding streamed over a
population too large to densify, and the all-pairs distance matrix (ops/
edit_distance.pairwise_distance_matrix over the mesh).

Counterpart of kgl_gene_tpu/parallel/mesh.py. The JAX functions shard the
genomes x variants zygosity matrix (or the all-pairs pair list) over a
jax.sharding.Mesh and merge per-shard partials with collectives under
shard_map. Here the mesh is a parallel.dist.SampleMesh, one process a
rank: shard_samples cuts this rank's rows, each rank reduces its rows on
its own device, and psum / gather_rows merge. Every function takes either
a SampleMesh (the sharded form) or a torch device in the same place (one
reduction on that device, resolved by resolve_device: the card unless the
caller asks for the CPU), so the one-device calls stay as they were.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.edit_distance import pairwise_distance_matrix
from ..stats.inbreeding import _MIN_RITLAND_FREQ, run_estimator
from .dist import SampleMesh, gather_rows, mesh_of, pad_to_multiple, psum, rank_rows

__all__ = [
    "pad_to_multiple",
    "sample_mesh",
    "shard_samples",
    "sharded_allele_counts",
    "sharded_het_hom",
    "sharded_inbreeding",
    "sharded_pairwise_distances",
    "streamed_inbreeding",
]

# Elements of a (rows, G) slab that _inbreed_moments works on at a time:
# eager PyTorch materialises every temporary of the slab (the lane's codes,
# the first-allele frequencies, masks and contributions), about 12 bytes an
# element, so a slab of 2^24 elements keeps them near 200 MB.
SLAB_ELEMENTS = 1 << 24


def slab_rows_for(genomes: int) -> int:
    """Packed rows a slab of _inbreed_moments takes in a population of
    `genomes`: the largest power of two whose slab holds at most
    SLAB_ELEMENTS elements (at least one row). A power of two leaves
    _column_sums nothing to pad but a block's last slab."""
    return 1 << (max(1, SLAB_ELEMENTS // max(genomes, 1)).bit_length() - 1)


def sample_mesh(n_devices: Optional[int] = None, device=None) -> SampleMesh:
    """This process's 1-D mesh over the sample (genome) axis: its rank of
    the default process group when one is joined (run_ranks), else a world
    of one rank on `device` (the card unless 'cpu'). n_devices, when
    given, must be the world's size: a process cannot widen its group."""
    if dist.is_available() and dist.is_initialized():
        mesh = SampleMesh.joined(device)
    else:
        mesh = SampleMesh.single(device)
    if n_devices is not None and n_devices != mesh.world_size:
        raise ValueError(f"a mesh of {n_devices} ranks asked for in a world of "
                         f"{mesh.world_size}; start the ranks with run_ranks")
    return mesh


def shard_samples(array: np.ndarray, mesh: SampleMesh) -> torch.Tensor:
    """This rank's rows of `array` on its device: axis 0 padded with zeros
    to a multiple of the world size, then cut into world-size equal
    blocks, block r for rank r."""
    return torch.as_tensor(rank_rows(array, mesh), device=mesh.device)


def _zygosity_rows(zygosity: np.ndarray, mesh: SampleMesh) -> torch.Tensor:
    return shard_samples(np.asarray(zygosity, dtype=np.uint8), mesh)


def sharded_allele_counts(zygosity: np.ndarray, device=None) -> np.ndarray:
    """AC per variant: the zygosity codes summed over genomes (int32),
    each rank's genomes on its device and the partial sums summed over the
    ranks when `device` is a SampleMesh.

    Replaces the mutex-guarded merge of PopulationDB::addVariant counts
    (kgl_variant_db_population.h:106-110)."""
    mesh = mesh_of(device)
    z = _zygosity_rows(zygosity, mesh)
    return psum(z.sum(0, dtype=torch.int32), mesh).cpu().numpy()


def sharded_het_hom(zygosity: np.ndarray, device=None) -> tuple:
    """(het, hom) counts per variant (int32), summed over the ranks of a
    SampleMesh."""
    mesh = mesh_of(device)
    z = _zygosity_rows(zygosity, mesh)
    counts = torch.stack([(z == 1).sum(0, dtype=torch.int32),
                          (z == 2).sum(0, dtype=torch.int32)])
    het, hom = psum(counts, mesh).cpu().numpy()
    return het, hom


def sharded_inbreeding(
    zygosity: np.ndarray,
    minor_freq: np.ndarray,
    device=None,
    algorithm: str = "Simple",
) -> np.ndarray:
    """Per-genome inbreeding F, every genome a row of one batched estimator
    (the reference's thread-per-genome pool, kga_analysis_inbreed: one F
    per sample); over a SampleMesh each rank estimates its own genomes and
    the rows are gathered. A locus is valid where 0 < p < 1. Every
    estimator runs sharded, HallME too (the JAX package's does not trace
    under shard_map)."""
    mesh = mesh_of(device)
    n_genomes = np.asarray(zygosity).shape[0]
    z = _zygosity_rows(zygosity, mesh).to(torch.int32)
    p = torch.as_tensor(np.asarray(minor_freq, dtype=np.float32), device=mesh.device)
    valid = ((p > 0.0) & (p < 1.0)).expand(z.shape)
    f = gather_rows(run_estimator(algorithm, z, p, valid), mesh)
    return f.cpu().numpy()[:n_genomes]


def _column_sums(x: torch.Tensor) -> torch.Tensor:
    """(rows, G) float -> (G,): each column summed by a pairwise tree over
    the rows padded with zeros to a power of two (row i + h onto row i,
    halving h). The order of the additions depends on the row count alone,
    so a column sums to the same bits whatever else the tensor holds: on
    any number of ranks and on either device, where a library reduction's
    order may follow the tensor's width."""
    rows = x.shape[0]
    if rows == 0:
        return x.new_zeros(x.shape[1:])
    x = torch.nn.functional.pad(x, (0, 0, 0, (1 << (rows - 1).bit_length()) - rows))
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


def _inbreed_moments(packed: torch.Tensor, p_block: torch.Tensor,
                     acc: torch.Tensor, slab_rows: int) -> torch.Tensor:
    """Accumulate per-genome inbreeding moment partials for one 2-bit
    packed zygosity chunk: packed (W/4, G) uint8 carries 4 loci a byte in
    variant-major orientation (the host's densify streams sequentially only
    in this layout, see dense_block_t); p_block (W,) float32; acc (G, 5)
    float32 holds (Ritland contributions, Ritland count, observed
    homozygotes, expected homozygotes, valid loci). Returns acc + this
    chunk's partials.

    The four 2-bit lanes are passed over in order (j = 0..3, loci 4r + j),
    each in slabs of slab_rows packed rows, so the temporaries stay bounded
    at any chunk size. The Ritland contributions, the one sum that rounds
    (the counts are whole numbers below 2^24), go through _column_sums.
    streamed_inbreeding sizes the slab from the whole population
    (slab_rows_for), so that a rank's columns sum in the order one device
    sums them."""
    rows, G = packed.shape
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
        for r0 in range(0, rows, slab_rows):
            z = (packed[r0:r0 + slab_rows] >> s) & 3  # (slab_rows, G) uint8
            p = p_lane[r0:r0 + slab_rows, None]
            valid = valid_lane[r0:r0 + slab_rows, None]
            first = torch.where(z == 0, q_lane[r0:r0 + slab_rows, None], p)
            is_hom = (z == 0) | (z == 2)
            hom_ok = is_hom & (first > _MIN_RITLAND_FREQ) & valid
            het_ok = (z == 1) & valid
            r_contrib = r_contrib + _column_sums(
                torch.where(hom_ok, 1.0 / torch.where(hom_ok, first, 1.0) - 1.0, 0.0)
                - het_ok.to(torch.float32))
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
    device; the host fetches it once at the end. Over a SampleMesh the
    genomes are split over the ranks (each rank packs and reduces its own
    columns of every block) and the rows of the partials are gathered at
    the end; every rank returns the whole result.

    Simple (F = (obs_hom - exp_hom)/(n - exp_hom)) and Ritland multi-locus
    (mean of per-locus hom/het contributions, kga_analysis_inbreed_calc.cpp)
    are exact sums of per-locus terms, so chunk accumulation reproduces the
    single-shot estimators up to float32 summation order. Blocks default to
    the JAX package's size (about 4 GB of zygosity, variants rounded up to
    a multiple of 131,072); each is reduced in row slabs of at most
    SLAB_ELEMENTS elements of the whole population's G, whatever a rank
    holds, so the rows sum in one order on any number of ranks."""
    mesh = mesh_of(device)
    dev = mesh.device
    G = csr.genome_count
    for name in algorithms:
        if name not in ("Simple", "RitlandLocus"):
            raise ValueError(
                f"{name} is not chunk-decomposable; use sharded_inbreeding "
                "on a dense window for HallME/Loglikelihood"
            )
    if block_variants is None:
        mem_cols = max(131072, int(4e9) // max(G, 1))
        v_cols = ((max(csr.variant_count, 1) + 131071) // 131072) * 131072
        block_variants = min(mem_cols, v_cols)
    block_variants = ((block_variants + 3) // 4) * 4  # 2-bit pack granularity
    slab_rows = slab_rows_for(G)
    Gl = -(-G // mesh.world_size)  # genome columns a rank holds, the last padded
    c_lo, c_hi = mesh.rank * Gl, (mesh.rank + 1) * Gl
    V = csr.variant_count
    minor_freq = np.asarray(minor_freq, dtype=np.float32)
    acc = torch.zeros((Gl, 5), dtype=torch.float32, device=dev)
    pin = dev.type == "cuda"
    for v_lo in range(0, V, block_variants):
        v_hi = min(v_lo + block_variants, V)
        block = csr.dense_block_t(v_lo, v_hi)  # (width, G) uint8
        # this rank's columns; padded genomes read 0 and are cut at the end
        cols = block[:, c_lo:c_hi]
        block = np.pad(cols, ((0, block_variants - cols.shape[0]), (0, Gl - cols.shape[1])))
        # pad with p = 0: invalid loci, excluded from every sum
        p_blk = np.zeros(block_variants, np.float32)
        p_blk[: v_hi - v_lo] = minor_freq[v_lo:v_hi]
        packed = torch.from_numpy(pack_block(block))
        p_host = torch.from_numpy(p_blk)
        if pin:
            packed, p_host = packed.pin_memory(), p_host.pin_memory()
        acc = _inbreed_moments(packed.to(dev, non_blocking=True),
                               p_host.to(dev, non_blocking=True), acc, slab_rows=slab_rows)
    a = gather_rows(acc, mesh).cpu().numpy()[:G]
    r_contrib, r_count, s_obs, s_exp, s_n = (a[:, i] for i in range(5))
    out = {}
    for name in algorithms:
        if name == "Simple":
            denom = s_n - s_exp
            out[name] = np.where(denom != 0, (s_obs - s_exp) / denom, 0.0)
        else:
            out[name] = np.where(r_count > 0, r_contrib / np.maximum(r_count, 1.0), 0.0)
    return out


def sharded_pairwise_distances(seqs: np.ndarray, lens: np.ndarray, mesh,
                               band_k: Optional[int] = None) -> np.ndarray:
    """All-pairs Levenshtein matrix with the upper triangle's pairs split
    over the ranks of `mesh` (or on a device, one rank on it): the (n, n)
    symmetric float64 matrix on every rank. The classification scale-out,
    ops.edit_distance.pairwise_distance_matrix with the mesh as its device:
    kernel B1's pair pool at the smallest Myers band >= band_k, the pairs
    outside the band's contract re-run exactly after the gather on every
    rank, as the JAX function routes them host-side (kernel B3 when band_k
    is None)."""
    return pairwise_distance_matrix(seqs, lens, band_k=band_k, device=mesh)
