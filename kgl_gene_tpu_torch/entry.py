"""The port's entry points: the forward step at a small example shape,
and a dry run of every multi-device form over n ranks.

Counterpart of __graft_entry__.entry (and its _example_geometry and
_example_batch: a 240 bp region whose two exons splice to 120 coding
bases, 8 genomes and 6 SNP slots each) and __graft_entry__.
dryrun_multichip.
"""

from __future__ import annotations

import numpy as np

from . import resolve_device
from .ops.pipeline import make_forward_step

__all__ = ["dryrun_multichip", "entry", "example_batch", "example_geometry"]

DRYRUN_TIMEOUT_S = 300.0  # the ranks' deadline, builds excluded


def example_geometry():
    """Tiny deterministic transcript geometry: (region codes, exon intervals)."""
    rng = np.random.default_rng(0)
    region = rng.integers(0, 4, size=240).astype(np.uint8)
    exon_intervals = np.array([[20, 80], [120, 180]], dtype=np.int64)
    return region, exon_intervals


def example_batch(batch: int, n_snps: int, L: int, seed: int = 1):
    """(positions, alt_codes, valid) for `batch` genomes with `n_snps`
    slots each, 70% of them valid."""
    rng = np.random.default_rng(seed)
    positions = rng.integers(0, L, size=(batch, n_snps)).astype(np.int32)
    alt_codes = rng.integers(0, 4, size=(batch, n_snps)).astype(np.uint8)
    valid = rng.random((batch, n_snps)) < 0.7
    return positions, alt_codes, valid


def entry(device=None):
    """(step, example_args): the forward step and its example inputs, on
    the card unless device='cpu'."""
    region, exons = example_geometry()
    step = make_forward_step(region, exons, region_start=0, reverse_strand=False,
                             device=device)
    return step, example_batch(8, 6, len(region))


def _dryrun_rank(mesh) -> dict:
    """One rank of dryrun_multichip; returns what it checked and the
    kernel launches it made."""
    import random

    from . import kernels
    from .ops.pipeline import make_multichip_indel_step, make_multichip_step
    from .parallel.dist import gather_rows
    from .parallel.mesh import (shard_samples, sharded_allele_counts,
                                sharded_pairwise_distances, streamed_inbreeding)
    from .phylo.mcmc import ChainState, MCMCSampler
    from .phylo.model import SubstitutionModel
    from .phylo.tree import random_tree

    kernels.reset_launches()
    n = mesh.world_size
    # Bench-scale geometry (bench.py bench_forward_step): a 4,800 bp
    # region, two exons -> 3,000 coding bases.
    rng = np.random.default_rng(0)
    region = rng.integers(0, 4, size=4800).astype(np.uint8)
    exons = np.array([[400, 1900], [2400, 3900]], dtype=np.int64)
    step = make_multichip_step(mesh, region, exons, region_start=0)
    batch = max(8 * n, 64)
    positions, alt_codes, valid = example_batch(batch, 48, len(region))
    zygosity = (np.random.default_rng(2).random((batch, 16)) * 3).astype(np.uint8)
    distance, _allele_counts, pop_ac = step(*(shard_samples(x, mesh) for x in
                                              (positions, alt_codes, valid, zygosity)))
    distance = gather_rows(distance, mesh)
    if distance.shape[0] < batch or tuple(pop_ac.shape) != (16,):
        raise AssertionError(f"step shapes {tuple(distance.shape)}, {tuple(pop_ac.shape)}")

    # The SNP + indel step on the same mesh at band 63.
    istep = make_multichip_indel_step(mesh, region, exons, region_start=0,
                                      pad_coding=8 * 4, band_k=63)
    rng2 = np.random.default_rng(5)
    K, A = 8, 4
    ipos = np.sort(rng2.integers(0, 500, size=(batch, K)), axis=1).astype(np.int32) * 8
    kind = rng2.integers(0, 3, size=(batch, K)).astype(np.int8)
    dl = np.where(kind == 1, rng2.integers(1, 3, size=(batch, K)), 0).astype(np.int32)
    il = np.where(kind == 2, rng2.integers(1, A, size=(batch, K)), 0).astype(np.int32)
    ic = rng2.integers(0, 4, size=(batch, K, A)).astype(np.uint8)
    ac = rng2.integers(0, 4, size=(batch, K)).astype(np.uint8)
    iv = rng2.random((batch, K)) < 0.7
    coding_len, _idist, _ivalid = istep(*(shard_samples(x, mesh) for x in
                                          (ipos, kind, dl, ic, il, ac, iv)))
    if gather_rows(coding_len, mesh).shape[0] < batch:
        raise AssertionError("indel step lost rows")

    # The sharded banded all-pairs over 2n mutants of 640 bases.
    fam = np.tile(region[:640][None, :], (2 * n, 1)).astype(np.uint8)
    for i in range(fam.shape[0]):
        for p in rng.choice(640, size=int(rng.integers(0, 8)), replace=False):
            fam[i, p] = (fam[i, p] + 1) % 4
    matrix = sharded_pairwise_distances(fam, np.full(2 * n, 640, np.int32), mesh, band_k=63)
    if matrix.shape != (2 * n, 2 * n):
        raise AssertionError(f"matrix shape {matrix.shape}")

    # Sharded allele counts and inbreeding streamed over a mini CSR.
    zyg = (np.random.default_rng(7).random((batch, 24)) * 3).astype(np.uint8)
    counts = sharded_allele_counts(zyg, mesh)

    class _MiniCSR:
        genome_count = batch
        variant_count = 24

        def dense_block_t(self, v_lo, v_hi):
            return np.ascontiguousarray(zyg[:, v_lo:v_hi].T)

    af = counts / (2.0 * batch)
    f_all = streamed_inbreeding(_MiniCSR(), np.minimum(af, 1 - af), mesh, block_variants=8)
    if f_all["Simple"].shape != (batch,):
        raise AssertionError("streamed inbreeding shape")

    # One run of the device phylo product sampler on this rank's device.
    taxa = [f"T{i}" for i in range(6)]
    ptree = random_tree(taxa, random.Random(5))
    aln = np.random.default_rng(3).integers(0, 4, size=(6, 96)).astype(np.uint8)
    pmodel = SubstitutionModel(np.ones(6), np.full(4, 0.25), 1.0, 1, 0.0)
    np.random.seed(4)
    sampler = MCMCSampler(aln, ChainState(ptree, pmodel), n_chains=1, seed=6,
                          backend="device", device=mesh.device)
    sampler.run(2)
    log_like = float(sampler.cold_chain.state.log_like)
    if not np.isfinite(log_like):
        raise AssertionError(f"log-likelihood {log_like}")
    return {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend,
            "host_copies": dict(mesh.host_copies), "launches": dict(kernels.LAUNCHES),
            "distance": distance.cpu().numpy(), "pop_ac": pop_ac.cpu().numpy(),
            "matrix": matrix, "allele_counts": counts, "F": f_all, "log_like": log_like}


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = DRYRUN_TIMEOUT_S) -> list:
    """Run every multi-device form once over n_devices ranks: the SNP step
    at the bench shape (3 kb coding from a 4.8 kb two-exon region, K = 48,
    B = max(8n, 64)), the SNP + indel step at band 63, the sharded banded
    all-pairs of 2n mutants of 640 bases, sharded allele counts and
    inbreeding streamed over a mini CSR, and one run of the device phylo
    sampler. The ranks run on the card unless device='cpu' (NCCL with a
    card a rank, gloo when they share one: parallel.dist.choose_backend).
    Returns each rank's report (device, backend, host copies, launches by
    kernel, and the outputs); raises if a rank fails or times out."""
    from .parallel.dist import run_ranks

    dev = resolve_device(device)
    if dev.type == "cuda":
        from . import kernels

        kernels.library()  # built once here; the ranks load it
    return run_ranks(_dryrun_rank, n_devices, device=dev.type, timeout_s=timeout_s)
