"""Spans of the port's stages, for a profiler's trace.

span(name) is torch.profiler.record_function(name) while a profiler
records: the range lands in the profiler's trace on the clock of the
card's events, so a stretch in which the card sat idle can be put down to
the stage the host was in, and the kernels a stage launched to that stage.
A span's parent is the span that encloses it on the same thread. With no
profiler recording, span(name) returns one shared null context: a stage
pays one check of the profiler's state and allocates nothing.

Names start with `kgt.`, the prefix of the port's C entry points:
  kgt.step (.upload, .apply, .translate, .distance, .checks): the forward
      step (ops/pipeline.py);
  kgt.pairs (.index, .upload, .gather, .distance, .fetch, .gather_ranks,
      .rerun, .assemble): the all-pairs matrix of either metric
      (ops/edit_distance.py pairwise_distance_matrix and gathered_pairs);
  kgt.mutate (.capture, .dispatch, .fetch, .unpack): the product pass
      (analysis/lib_seqmutation.py MutateGenes.mutate_transcripts);
  kgt.inbreed (.select, .upload, .gather, .ritland, .simple, .hallme,
      .loglik, .fetch): one INBREED estimate, and kgt.inbreed.prepare, a
      population put on the device once (analysis/inbreed_analysis.py,
      the estimators' stages in stats/inbreeding.py run_estimators);
  kgt.fws (.upload, .variants, .genomes, .fetch): one PfEMP statistics
      call over a genome subset, and kgt.fws.prepare, a population put on
      the device once (analysis/pfemp_analysis.py, the stages in
      stats/fws.py fws_statistics).
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager over one stage: a profiler range named `name`
    while a profiler records, else the shared null context."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _OFF
