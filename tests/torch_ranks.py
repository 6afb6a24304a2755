"""Rank bodies of the port's multi-process tests.

run_ranks spawns each rank, and a spawned rank imports the module that
holds its function: this one imports torch, numpy and the port only, so no
rank imports JAX. Each body runs a group of checks in one spawn and
returns plain numpy results for the test to hold against the JAX package.
"""

import time

import numpy as np
import torch

from kgl_gene_tpu_torch.ops.pipeline import make_multichip_indel_step, make_multichip_step
from kgl_gene_tpu_torch.ops.sharded_wavefront import sharded_levenshtein
from kgl_gene_tpu_torch.parallel.dist import gather_rows, psum, ring_shift
from kgl_gene_tpu_torch.parallel.mesh import (
    sample_mesh,
    shard_samples,
    sharded_allele_counts,
    sharded_het_hom,
    sharded_inbreeding,
    sharded_pairwise_distances,
    streamed_inbreeding,
)


class DenseCSR:
    """The genome-count / variant-count / dense_block_t face of a
    VariantMajorCSR over a dense zygosity matrix."""

    def __init__(self, z):
        self._z = z
        self.genome_count, self.variant_count = z.shape

    def dense_block_t(self, lo, hi):
        return np.ascontiguousarray(self._z[:, lo:hi].T)


def _numpy(x):
    return x.cpu().numpy()


def multichip_checks(mesh, cases: dict) -> dict:
    """Every sharded form of the port on `cases` (built by
    tests/test_torch_multichip.py), gathered: the test holds them against
    the JAX package and the port's one-device forms."""
    out = {"rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device)}
    for name, (region, exons, reverse, positions, alt, valid, zyg) in cases["steps"].items():
        step = make_multichip_step(mesh, region, exons, 0, reverse_strand=reverse)
        dist, counts, pop_ac = step(*(shard_samples(x, mesh)
                                      for x in (positions, alt, valid, zyg)))
        out[f"step/{name}"] = (_numpy(gather_rows(dist, mesh)), _numpy(counts), _numpy(pop_ac))
    region, exons, pad, band, slots = cases["indel"]
    istep = make_multichip_indel_step(mesh, region, exons, 0, pad_coding=pad, band_k=band)
    got = istep(*(shard_samples(x, mesh) for x in slots))
    out["indel"] = tuple(_numpy(gather_rows(x, mesh)) for x in got)
    for name, (seqs, lens, band) in cases["allpairs"].items():
        out[f"allpairs/{name}"] = sharded_pairwise_distances(seqs, lens, mesh, band_k=band)
    z, p, block = cases["streamed"]
    out["streamed"] = streamed_inbreeding(DenseCSR(z), p, mesh, block_variants=block)
    try:
        streamed_inbreeding(DenseCSR(z[:4, :64]), np.full(64, 0.3), mesh, block_variants=64,
                            algorithms=("HallME",))
        out["non_decomposable"] = None
    except ValueError as exc:
        out["non_decomposable"] = str(exc)
    z, p = cases["window"]
    out["allele_counts"] = sharded_allele_counts(z, mesh)
    out["het_hom"] = sharded_het_hom(z, mesh)
    out["inbreeding"] = {name: sharded_inbreeding(z, p, mesh, name)
                         for name in ("Simple", "RitlandLocus", "HallME", "Loglikelihood")}
    return out


def wavefront_checks(mesh, cases: list) -> list:
    """sharded_levenshtein over the ranks on each (seq_a, len_a, seq_b,
    len_b, halo) case."""
    return [sharded_levenshtein(a, la, b, lb, mesh, halo=h) for a, la, b, lb, h in cases]


def collective_checks(mesh) -> dict:
    """psum, gather_rows and ring_shift on small tensors tagged by rank."""
    r = mesh.rank
    mine = torch.full((2, 3), r, dtype=torch.int32, device=mesh.device)
    joined = sample_mesh(device="cpu")  # this rank of the group run_ranks joined
    return {"psum": _numpy(psum(mine, mesh)), "gather": _numpy(gather_rows(mine, mesh)),
            "ring": _numpy(ring_shift(mine, mesh)), "mine": _numpy(mine),
            "host_copies": dict(mesh.host_copies),
            "joined": (joined.rank, joined.world_size, joined.backend, str(joined.device))}


def raises_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one gives up")
    return mesh.rank


def sleeps(mesh, seconds):
    time.sleep(seconds)
    return mesh.rank
