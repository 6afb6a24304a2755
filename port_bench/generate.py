"""The benchmark's one generator: a gene and its cell's inputs from a seed
and the parameters of a configuration and a traffic file.

A traffic file names its generator ("snp_sets" or "haplotype_sets") and
fixes every amount of work: the genomes and SNP slots of a step, or the
haplotypes of a family, and the number of input sets a run cycles through.
The seed picks positions, alleles, bases and which slots hold a SNP only.
"""

from __future__ import annotations

import numpy as np

__all__ = ["STOP_CODONS", "coding_of", "gene_region", "haplotype_sets", "inputs", "rng_for",
           "snp_sets"]

# Codon numbers are b0 * 16 + b1 * 4 + b2 over the codes A=0, C=1, G=2, T=3.
START_CODON = 14            # ATG
STOP_CODONS = (48, 50, 56)  # TAA, TAG, TGA
END_CODON = 48              # TAA


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of the run's seed (any int, 64 bits kept)."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def _relative_exons(config: dict) -> np.ndarray:
    """The exons as (lo, hi) offsets into the region, 0-based, half-open."""
    return np.asarray(config["exons"], dtype=np.int64) - int(config.get("region_start", 0))


def _reverse_complement(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[..., ::-1]).astype(codes.dtype)


def gene_region(rng: np.random.Generator, config: dict) -> np.ndarray:
    """(region_len,) uint8 codes whose exons splice, read on the gene's
    strand, to an open reading frame: ATG, random sense codons, TAA. SNPs
    then reach every validity outcome. The bases outside the exons are
    random."""
    region_len = int(config["region_len"])
    exons = _relative_exons(config)
    n_coding = int((exons[:, 1] - exons[:, 0]).sum())
    if n_coding % 3:
        raise ValueError(f"exons splice to {n_coding} bases, not whole codons")
    region = rng.integers(0, 4, size=region_len).astype(np.uint8)
    sense = np.array([c for c in range(64) if c not in STOP_CODONS])
    codons = np.concatenate([[START_CODON], rng.choice(sense, n_coding // 3 - 2), [END_CODON]])
    coding = np.stack([codons // 16, codons // 4 % 4, codons % 4], 1).reshape(-1).astype(np.uint8)
    spliced = coding if config.get("strand", "+") == "+" else _reverse_complement(coding)
    at = 0
    for lo, hi in exons:
        region[lo:hi] = spliced[at : at + hi - lo]
        at += hi - lo
    return region


def coding_of(region: np.ndarray, config: dict) -> np.ndarray:
    """The gene's coding bases: the exons spliced, read on its strand."""
    spliced = np.concatenate([region[lo:hi] for lo, hi in _relative_exons(config)])
    return spliced if config.get("strand", "+") == "+" else _reverse_complement(spliced)


def snp_sets(rng: np.random.Generator, traffic: dict, region_len: int):
    """traffic["sets"] tuples (positions (B, K) int32 uniform over the
    region, alt codes (B, K) uint8, valid (B, K) bool at traffic["valid_p"]),
    B = traffic["genomes"], K = traffic["slots"]."""
    B, K = int(traffic["genomes"]), int(traffic["slots"])
    out = []
    for _ in range(int(traffic["sets"])):
        positions = rng.integers(0, region_len, size=(B, K), dtype=np.int32)
        alt = rng.integers(0, 4, size=(B, K), dtype=np.uint8)
        valid = rng.random((B, K)) < float(traffic["valid_p"])
        out.append((positions, alt, valid))
    return out


def haplotype_sets(rng: np.random.Generator, traffic: dict, coding: np.ndarray):
    """traffic["sets"] arrays (n, S) int32 of n = traffic["haplotypes"]
    distinct haplotypes, each what a genome of the step's traffic makes of
    the coding sequence: traffic["slots"] SNP slots, each valid at
    traffic["valid_p"], at distinct sites, each changing its base."""
    n, k, p = int(traffic["haplotypes"]), int(traffic["slots"]), float(traffic["valid_p"])
    S = coding.shape[0]
    out = []
    for _ in range(int(traffic["sets"])):
        haps = np.empty((n, S), dtype=np.int32)
        todo = np.arange(n)
        while todo.size:
            rows = np.repeat(coding[None, :].astype(np.int32), todo.size, 0)
            sites = rng.random((todo.size, S)).argpartition(k, axis=1)[:, :k]
            shift = rng.integers(1, 4, size=(todo.size, k)) * (rng.random((todo.size, k)) < p)
            np.put_along_axis(rows, sites, (np.take_along_axis(rows, sites, 1) + shift) % 4, 1)
            haps[todo] = rows
            _, first = np.unique(haps, axis=0, return_index=True)
            todo = np.setdiff1d(np.arange(n), first)  # a repeated row is drawn again
        out.append(haps)
    return out


def inputs(seed: int, config: dict, traffic: dict):
    """(region, sets): the gene from the seed's first stream, the input sets
    of the traffic's generator from its second."""
    region = gene_region(rng_for(seed, 0), config)
    rng = rng_for(seed, 1)
    kind = traffic["generator"]
    if kind == "snp_sets":
        return region, snp_sets(rng, traffic, region.shape[0])
    if kind == "haplotype_sets":
        return region, haplotype_sets(rng, traffic, coding_of(region, config))
    raise ValueError(f"unknown generator {kind!r}")
