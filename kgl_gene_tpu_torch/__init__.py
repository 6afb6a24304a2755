"""PyTorch/CUDA port of kgl_gene_tpu for NVIDIA Hopper (H100).

The JAX package kgl_gene_tpu stays the reference; this package imports
torch and numpy only, never jax and nothing of kgl_gene_tpu. Its entry
points run on the card unless the caller passes device="cpu"; with no
card and no such request they raise.

Slices in place: the population x transcript forward step
(ops/pipeline.py make_forward_step), the transcript-family analysis
(analysis/lib_seqmutation.py TranscriptFamilyAnalysis: distances, CIGARs,
the all-pairs UPGMA tree) and the product path (FASTA + GFF3 + VCF through
io/, variant/ and mutation/capture.py to the SNP and SNP + indel steps
and records, analysis/lib_seqmutation.py MutateGenes) with the native C++
VCF ingest (native/, built by g++ on first use), and the population
statistics (variant/columnar.py, stats/, parallel/mesh.py: allele
frequencies, FWS, the inbreeding estimators on the device and inbreeding
streamed over a population too large to densify), the Bayesian
phylogenetics application (phylo/: the pruning likelihoods of the product
sampler and of the vmapped heated chains on the device, the kpl app
phylo/strom.py), and the GO ontology (io/gaf.py, ontology/: parsers, the
DAG, annotation, information content, term and set similarity, the cache
and the database on the host; ops/similarity.py: the all-pairs MICA and
Lin matrices on the device), the checkpointed VCF ingest (io/checkpoint.py
and the cursor of io/vcf.py), the typed distance metrics (classify/
distance.py) with the local (infix) metric on the device (ops/local.py),
the host remainder of the genomics core (analysis/legacy.py,
sequence/complexity.py, variant/filter.py, variant/vep.py, utils/), and
the application shell (app/: python -m kgl_gene_tpu_torch.app.exec_env
runs the packages of a runtime XML, its --device going to every analysis)
with its resource parsers (io/, literature/) and the nine registered
analyses (analysis/*_analysis.py, registered by analysis/registered.py), with
hand-written CUDA kernels for codon translation, exact Levenshtein by
full-width bit vectors and the local distance by the same body, banded
Myers, the banded row DP with its traceback codes, the walk over those
codes and the all-pairs MICA (csrc/, built by kernels/).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["int32_on", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card by default, the CPU only
    when the caller asks for it. Raises when no card is present and the
    caller did not ask for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return torch.device("cuda")


def int32_on(device, *arrays):
    """Each array as a contiguous int32 tensor on `device` (one tensor for
    one array): how the numpy-in entry points hand data to the kernels."""
    out = tuple(torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32), device=device)
                for x in arrays)
    return out[0] if len(out) == 1 else out
