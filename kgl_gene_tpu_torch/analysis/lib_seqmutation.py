"""Population x transcript mutation driver and per-transcript statistics.

Counterpart of kgl_gene_tpu/analysis/lib_seqmutation.py: MutateStats,
TranscriptMutateRecord, MutateGenes (the reference's MutateGenes,
kga_analysis_lib_seqmutation.h:39, thread-per-genome pool at
.cpp:116-140) and TranscriptFamilyAnalysis (kga_analysis_lib_seq_stats.cpp:
290-456).

MutateGenes.mutate_transcripts is the product path: per transcript the
capture splits the population into SNP-only genomes (the SNP step,
ops/pipeline.forward), canonical-indel genomes (the SNP + indel step,
ops/pipeline.forward_indel) and host-exact genomes (the AdjustedSequence
engine). Every transcript's device steps run back to back on one stream,
their outputs are packed on the card (three base-5 codes a byte and an
8-byte tail) and concatenated, and the host fetches them with one copy.
Then records materialise per transcript.

Each device step of TranscriptFamilyAnalysis runs on the card unless the
analysis was made with device='cpu':

  - reference_distances: global metric on the exact wavefront (kernel
    B3), local (infix) metric on kernel `local`, the reference one row
    read by every pair;
  - distance_tree_newick: the all-pairs matrix (ops/edit_distance.
    pairwise_distance_matrix; global: on the card, kernel B1's pair pool
    at band 127 with its exact overflow re-run, on the CPU the exact
    route; local: kernel `local`), then UPGMA and Newick on the host;
  - reference_cigars: the banded traceback (kernel B4, ops/traceback).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import kernels, resolve_device
from ..classify.upgma import newick, upgma_tree
from ..genome.contig import ContigReference
from ..genome.features import (
    CodingSequenceValidity,
    TranscriptionSequence,
    TranscriptionSequenceType,
)
from ..mutation.capture import BatchCapture, capture_population_batch, capture_population_split
from ..mutation.sequence_filter import SeqVariantFilterType
from ..mutation.transcript import SequenceTranscript
from ..ops.edit_distance import pairwise_distance_matrix
from ..ops.local import local_levenshtein
from ..ops.pipeline import (
    forward,
    forward_indel,
    indel_band_for,
    pad_coding_for,
    reconstruct_indel_coding_host,
)
from ..ops.traceback import batched_cigar
from ..ops.wavefront import wavefront_levenshtein
from ..parallel.host_pipeline import WorkflowThreads
from ..sequence.alphabet import DNA5, AminoAcid
from ..sequence.sequence import StrandSense
from ..sequence.tables import amino_translation_table
from ..tracing import span
from ..variant.db import PopulationDB

__all__ = ["MutateGenes", "MutateStats", "TranscriptFamilyAnalysis", "TranscriptMutateRecord"]

DEVICE_BAND = 127  # the all-pairs band on the card, as on the TPU

# Device validity code -> enum (ops/pipeline.py validity_code; 4 = the
# indel step's per-genome NOT_MOD3).
_VALIDITY_BY_CODE = (
    CodingSequenceValidity.VALID_PROTEIN,
    CodingSequenceValidity.NO_STOP_CODON,
    CodingSequenceValidity.NONSENSE_MUTATION,
    CodingSequenceValidity.NO_START_CODON,
    CodingSequenceValidity.NOT_MOD3,
)

# The indel steps' payload: False ships the packed coding sequences (a
# byte per three bases); True ships 8-byte tails and replays the apply on
# the host (reconstruct_indel_coding_host) while the fetch is in flight.
# The JAX package picks between them by a probe of its device link; here
# the link is PCIe to a local card, so the packed sequences go.
INDEL_TAIL_ONLY = False

# byte value -> its three base-5 digits (codes 0..4); digits beyond a valid
# packed byte (>= 125) never occur.
_BASE5_LUT = np.stack(
    [
        np.arange(256, dtype=np.uint8) % 5,
        (np.arange(256, dtype=np.uint8) // 5) % 5,
        (np.arange(256, dtype=np.uint8) // 25) % 5,
    ],
    axis=1,
)

_STAT_FIELDS = (
    "mutant_genomes", "total_variants", "total_snp", "total_frameshift",
    "duplicate_variants", "upstream_deleted", "valid_proteins", "invalid_proteins",
)


def _pack_outputs(coding: torch.Tensor, distance: torch.Tensor, validity_code: torch.Tensor,
                 coding_len: torch.Tensor, tail_only: bool = False) -> torch.Tensor:
    """One step's outputs as one (B, W) uint8 tensor on their device: three
    base-5 coding codes a byte, then an 8-byte tail (distance LE32, validity
    code, coding length LE24). tail_only leaves the sequence bytes out."""
    d = distance.to(torch.int64)
    cl = coding_len.to(torch.int64)
    tail = torch.stack(
        [d & 255, (d >> 8) & 255, (d >> 16) & 255, (d >> 24) & 255,
         validity_code.to(torch.int64), cl & 255, (cl >> 8) & 255, (cl >> 16) & 255],
        1,
    ).to(torch.uint8)
    if tail_only:
        return tail
    c = coding.to(torch.uint8)
    S = c.shape[1]
    if S % 3:
        c = torch.nn.functional.pad(c, (0, 3 - S % 3))
    nib = c[:, 0::3] + 5 * c[:, 1::3] + 25 * c[:, 2::3]
    return torch.cat([nib, tail], 1)


def _unpack_tail(tail: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(distance, coding length) int64 columns of fetched 8-byte tails."""
    t = tail.astype(np.int64)
    distance = t[:, 0] | (t[:, 1] << 8) | (t[:, 2] << 16) | (t[:, 3] << 24)
    lens = t[:, 5] | (t[:, 6] << 8) | (t[:, 7] << 16)
    return distance, lens


@dataclass
class MutateStats:
    """Aggregate mutation statistics (MutateAnalysis counters)."""

    total_genomes: int = 0
    mutant_genomes: int = 0
    total_variants: int = 0
    total_snp: int = 0
    total_frameshift: int = 0
    duplicate_variants: int = 0
    upstream_deleted: int = 0
    valid_proteins: int = 0
    invalid_proteins: int = 0


@dataclass
class TranscriptMutateRecord:
    """One genome x transcript mutation outcome."""

    genome_id: str
    gene_id: str
    transcript_id: str
    variant_count: int
    modified_coding: str
    validity: CodingSequenceValidity
    distance: Optional[int] = None  # Levenshtein vs reference coding


def _region_relative_exons(transcript: TranscriptionSequence) -> np.ndarray:
    return np.asarray(transcript.exon_arrays(), np.int64) - transcript.start


class MutateGenes:
    """Mutate transcripts across every genome of a population
    (MutateGenes::mutatePopulation).

    Device routing: genomes whose selected variant set is SNP-only run as
    one batch of the SNP step, genomes with canonical indels (under the
    default filter) as one batch of the SNP + indel step, and the rest
    (other indels, allele conflicts, other filters' indels) keep the
    byte-exact AdjustedSequence host engine. The device steps run on the
    card unless device='cpu'; use_device=False takes the host engine for
    every genome and needs no device.
    """

    def __init__(self, contig_ref: ContigReference,
                 filter_type: SeqVariantFilterType = SeqVariantFilterType.DEFAULT_SEQ_FILTER,
                 info_store=None, use_device: bool = True,
                 k_bucket: Optional[int] = None, b_bucket: Optional[int] = None,
                 device=None):
        self.contig_ref = contig_ref
        self.filter_type = filter_type
        self.info_store = info_store
        self.use_device = use_device
        # Minimum capture-tensor buckets: pinned, repeated batches keep one
        # shape (they grow to the next power of two if a batch exceeds them).
        self.k_bucket = k_bucket
        self.b_bucket = b_bucket
        self.device = device

    # ------------------------------------------------------------------ #
    def _host_mutate(
        self, genome_id: str, contig_db, transcript: TranscriptionSequence,
        stats: MutateStats,
    ) -> TranscriptMutateRecord:
        """Exact host engine for one genome (indel-correct path)."""
        st = SequenceTranscript(
            contig_db, self.contig_ref, transcript, self.filter_type,
            self.info_store,
        )
        n_variants = st.variant_count()
        stats.total_variants += n_variants
        stats.total_snp += st.stats.total_snp_variants
        stats.total_frameshift += st.stats.total_frame_shift
        stats.duplicate_variants += st.stats.non_unique_count
        stats.upstream_deleted += st.stats.upstream_deleted
        if n_variants:
            stats.mutant_genomes += 1
        validity = st.modified_validity()
        if CodingSequenceValidity.valid_sequence(validity):
            stats.valid_proteins += 1
        else:
            stats.invalid_proteins += 1
        return TranscriptMutateRecord(
            genome_id, transcript.gene.feature_id, transcript.transcript_id,
            n_variants, st.modified_coding().to_string(), validity,
        )

    def _pooled_program(self, specs, transcripts):
        """One function running every transcript's SNP / indel step back to
        back on the device's stream, packing each step's outputs and
        concatenating them there: fn(flat_inputs, launches) -> (Bmax,
        sum(widths)) uint8 tensor on the device, which the caller fetches
        with one copy. launches (a dict) gathers each kind of step's kernel
        launches.

        specs: tuple of ("snp" | "indel", transcript_key, geometry...), the
        cache key; transcripts: the parallel TranscriptionSequences, read
        only on a cache miss. The per-transcript constants (region, exon
        layout, LUTs) go to the device once and are cached ON the contig
        object, so a fresh MutateGenes each pass reuses them."""
        dev = resolve_device(self.device)
        cache = self.contig_ref.__dict__.setdefault("_pooled_step_cache", {})
        key = ("pooled", str(dev), self.contig_ref.coding_table.name, specs)
        hit = cache.get(key)
        if hit is not None:
            return hit
        table = amino_translation_table(self.contig_ref.coding_table.name)
        amino_lut = torch.as_tensor(table.amino_lut, dtype=torch.uint8, device=dev)
        start_codes = torch.as_tensor(table.start_codes(), dtype=torch.uint8, device=dev)

        consts = []
        for spec, transcript in zip(specs, transcripts):
            region = torch.as_tensor(
                self.contig_ref.subsequence(transcript.interval).codes, dtype=torch.uint8,
                device=dev,
            )
            exon_bounds = _region_relative_exons(transcript)
            reverse = transcript.strand is StrandSense.REVERSE
            consts.append((region, exon_bounds, reverse))

        def program(flat, launches):
            packed = []
            it = iter(flat)
            for spec, (region, exon_bounds, reverse) in zip(specs, consts):
                before = dict(kernels.LAUNCHES)
                if spec[0] == "snp":
                    pos, alt, valid = (torch.as_tensor(next(it), device=dev) for _ in range(3))
                    out = forward(
                        region, exon_bounds[:, 0].tolist(),
                        (exon_bounds[:, 1] - exon_bounds[:, 0]).tolist(), reverse,
                        pos, alt, valid, amino_lut, AminoAcid.STOP, start_codes,
                    )
                    cl = torch.full(out.distance.shape, out.mutated_coding.shape[1],
                                    dtype=torch.int32, device=dev)
                    # SNP steps ship tails only; the strings rebuild on the
                    # host (_reconstruct_snp_codes).
                    packed.append(_pack_outputs(out.mutated_coding, out.distance,
                                               out.validity_code, cl, tail_only=True))
                else:
                    pad_coding, band_k, tail_only = spec[4:]
                    args = [torch.as_tensor(next(it), device=dev) for _ in range(7)]
                    out = forward_indel(region, exon_bounds, reverse, *args, amino_lut,
                                        AminoAcid.STOP, start_codes, pad_coding, band_k)
                    packed.append(_pack_outputs(out.mutated_coding, out.distance,
                                               out.validity_code, out.coding_len,
                                               tail_only=tail_only))
                counts = launches.setdefault(spec[0], {})
                for name, n in kernels.LAUNCHES.items():
                    if n != before.get(name, 0):
                        counts[name] = counts.get(name, 0) + n - before.get(name, 0)
            bmax = max(p.shape[0] for p in packed)
            return torch.cat(
                [torch.nn.functional.pad(p, (0, 0, 0, bmax - p.shape[0])) for p in packed], 1)

        cache[key] = program
        return program

    def _reconstruct_snp_codes(
        self, batch: BatchCapture, transcript: TranscriptionSequence,
    ) -> np.ndarray:
        """Host-side coding codes for the SNP step: the device sends only
        the 8-byte tails; the mutant sequences re-derive from the reference
        coding plus the capture tensors (region-relative SNP positions
        mapped through the exon layout / strand), byte-exact with the
        device scatter + splice (apply -> splice -> complement)."""
        n_dev = len(batch.genome_ids)
        ref_codes = self.contig_ref.coding_sequence(transcript).codes
        S = len(ref_codes)
        reverse = transcript.strand is StrandSense.REVERSE
        L = transcript.end - transcript.start
        cmap = np.full(L, -1, np.int64)
        cs = 0
        for lo, hi in np.asarray(transcript.exon_arrays(), np.int64):
            lo_r, hi_r = int(lo - transcript.start), int(hi - transcript.start)
            cmap[lo_r:hi_r] = cs + np.arange(hi_r - lo_r)
            cs += hi_r - lo_r
        pos = batch.positions[:n_dev].astype(np.int64)
        alt = batch.alt_codes[:n_dev]
        ok = batch.valid[:n_dev] & (pos >= 0) & (pos < L)
        cpos = np.where(ok, cmap[np.clip(pos, 0, L - 1)], -1)
        ok &= cpos >= 0
        codes_v = alt
        if reverse:
            cpos = np.where(ok, S - 1 - cpos, -1)
            codes_v = DNA5.COMPLEMENT[alt]
        out = np.repeat(ref_codes[None, :], n_dev, axis=0)
        b_idx, k_idx = np.nonzero(ok)
        out[b_idx, cpos[b_idx, k_idx]] = codes_v[b_idx, k_idx]
        return out

    def _device_collect(
        self, packed: np.ndarray, batch: BatchCapture,
        transcript: TranscriptionSequence, coding_len: int,
        stats: MutateStats,
    ) -> List[TranscriptMutateRecord]:
        """Unpack one transcript's fetched SNP-step outputs into records
        (vectorized strings + validity). Tail-only payloads (8 columns)
        rebuild the coding strings on the host."""
        n_dev = len(batch.genome_ids)
        S = coding_len
        packed = packed[:n_dev]
        if packed.shape[1] == 8:
            codes = self._reconstruct_snp_codes(batch, transcript)
        else:
            nib = packed[:, : (S + 2) // 3]
            # base-5 unpack via one (256, 3) LUT gather.
            codes = _BASE5_LUT[nib].reshape(n_dev, -1)[:, :S]
        tail = packed[:, -8:]
        distance, _lens = _unpack_tail(tail)
        if transcript.coding_type is TranscriptionSequenceType.NCRNA:
            validities = [CodingSequenceValidity.NCRNA] * n_dev
        elif S % 3 != 0:
            validities = [CodingSequenceValidity.NOT_MOD3] * n_dev
        else:
            validities = [_VALIDITY_BY_CODE[c] for c in tail[:, 4]]

        # Vectorized stats (sum semantics identical to the per-genome loop).
        k_counts = batch.k_counts[:n_dev]
        stats.total_variants += int(k_counts.sum())
        stats.total_snp += int(batch.hetero_counts[:n_dev].sum())
        stats.mutant_genomes += int(np.count_nonzero(k_counts))
        n_valid = sum(
            1 for v in validities if CodingSequenceValidity.valid_sequence(v)
        )
        stats.valid_proteins += n_valid
        stats.invalid_proteins += n_dev - n_valid

        # Vectorized coding strings: one LUT pass + slice per record.
        char_buf = DNA5.CODE_TO_CHAR[codes].tobytes()
        gene_id = transcript.gene.feature_id
        tx_id = transcript.transcript_id
        return [
            TranscriptMutateRecord(
                genome_id, gene_id, tx_id, int(k_counts[i]),
                char_buf[i * S : (i + 1) * S].decode("ascii"),
                validities[i], distance=int(distance[i]),
            )
            for i, genome_id in enumerate(batch.genome_ids)
        ]

    def _reconstruct_indel_codes(
        self, batch, transcript: TranscriptionSequence,
    ) -> np.ndarray:
        """Host replay of the device indel apply for tail-only payloads
        (ops/pipeline.py reconstruct_indel_coding_host)."""
        n_dev = len(batch.genome_ids)
        region = self.contig_ref.subsequence(transcript.interval).codes
        K = batch.pos.shape[1]
        A = batch.ins_codes.shape[2]
        codes, _lens = reconstruct_indel_coding_host(
            region, _region_relative_exons(transcript),
            transcript.strand is StrandSense.REVERSE,
            batch.pos[:n_dev], batch.kind[:n_dev],
            batch.del_len[:n_dev], batch.ins_codes[:n_dev],
            batch.ins_len[:n_dev], batch.alt_code[:n_dev],
            batch.valid[:n_dev], pad_coding=K * A,
        )
        return codes

    def _device_collect_indel(
        self, packed: np.ndarray, batch, transcript: TranscriptionSequence,
        stats: MutateStats, recon: Optional[np.ndarray] = None,
    ) -> List[TranscriptMutateRecord]:
        """Unpack the SNP + indel step's outputs (per-genome coding
        lengths)."""
        n_dev = len(batch.genome_ids)
        packed = packed[:n_dev]
        if packed.shape[1] == 8:
            codes = recon if recon is not None \
                else self._reconstruct_indel_codes(batch, transcript)
        else:
            nib = packed[:, :-8]
            codes = _BASE5_LUT[nib].reshape(n_dev, -1)
        W = codes.shape[1]
        tail = packed[:, -8:]
        distance, lens = _unpack_tail(tail)
        if transcript.coding_type is TranscriptionSequenceType.NCRNA:
            validities = [CodingSequenceValidity.NCRNA] * n_dev
        else:
            validities = [_VALIDITY_BY_CODE[c] for c in tail[:, 4]]

        k_counts = batch.k_counts[:n_dev]
        stats.total_variants += int(k_counts.sum())
        stats.total_snp += int(batch.hetero_counts[:n_dev].sum())
        stats.total_frameshift += int(batch.frameshift_counts[:n_dev].sum())
        stats.mutant_genomes += int(np.count_nonzero(k_counts))
        n_valid = sum(
            1 for v in validities if CodingSequenceValidity.valid_sequence(v)
        )
        stats.valid_proteins += n_valid
        stats.invalid_proteins += n_dev - n_valid

        char_buf = DNA5.CODE_TO_CHAR[codes].tobytes()
        gene_id = transcript.gene.feature_id
        tx_id = transcript.transcript_id
        return [
            TranscriptMutateRecord(
                genome_id, gene_id, tx_id, int(k_counts[i]),
                char_buf[i * W : i * W + int(lens[i])].decode("ascii"),
                validities[i], distance=int(distance[i]),
            )
            for i, genome_id in enumerate(batch.genome_ids)
        ]

    def _capture(
        self, population: PopulationDB, transcript: TranscriptionSequence,
        use_device: bool,
    ):
        """Capture split for one transcript: (snp batch | None,
        indel batch | None, empty ids, host ids). The indel device route
        applies only under the DEFAULT filter (other filter types change
        indel selection; indel genomes then take the host engine)."""
        contig_id = self.contig_ref.contig_id
        if use_device:
            default_filter = (
                self.filter_type is SeqVariantFilterType.DEFAULT_SEQ_FILTER
            )
            buckets = {"k_bucket": self.k_bucket, "b_bucket": self.b_bucket}
            for attempt in (buckets, {}):  # a bucket too small: grow to a power of two
                try:
                    if default_filter:
                        snp_batch, indel_batch = capture_population_split(
                            population, contig_id, transcript.interval,
                            region_start=transcript.start, **attempt,
                        )
                    else:
                        snp_batch = capture_population_batch(
                            population, contig_id, transcript.interval,
                            region_start=transcript.start, **attempt,
                        )
                        indel_batch = None
                    break
                except ValueError:
                    if not attempt:
                        raise
            return (snp_batch, indel_batch, snp_batch.empty_genome_ids,
                    snp_batch.host_genome_ids)
        empty_ids, host_ids = [], []
        for genome_id, genome in population:
            contig_db = genome.get_contig(contig_id)
            if contig_db is None or contig_db.variant_count() == 0:
                empty_ids.append(genome_id)
            else:
                host_ids.append(genome_id)
        return None, None, empty_ids, host_ids

    def mutate_transcripts(
        self, population: PopulationDB,
        transcripts: List[TranscriptionSequence],
        use_device: Optional[bool] = None,
        timings: Optional[Dict[str, float]] = None,
    ) -> List[Tuple[List[TranscriptMutateRecord], MutateStats]]:
        """Mutate several transcripts with one device round trip: every
        transcript's SNP / indel step runs in one pooled program whose
        packed outputs cross to the host as one copy, then records
        materialise per transcript (the reference loops transcripts
        serially around its thread pool, kga_analysis_lib_seqmutation.cpp:
        26-55).

        timings (optional dict) accumulates per-stage wall seconds
        (capture_s, dispatch_s, fetch_s, unpack_s), n_device_fetches, and
        under "launches" the kernel launches of each kind of step
        ({"snp": {kernel: n}, "indel": {...}}).
        """
        if use_device is None:
            use_device = self.use_device
        if timings is None:
            timings = {}
        for name in ("capture_s", "dispatch_s", "fetch_s", "unpack_s"):
            timings.setdefault(name, 0.0)
        timings.setdefault("n_device_fetches", 0)
        launches = timings.setdefault("launches", {})
        t0 = time.perf_counter()
        with span("kgt.mutate.capture"):
            contig_id = self.contig_ref.contig_id
            preps = []
            steps = []  # (prep_index, which, transcript, batch)
            for transcript in transcripts:
                dev = use_device and transcript.coding_nucleotides() >= 3
                snp_batch, indel_batch, empty_ids, host_ids = self._capture(
                    population, transcript, dev
                )
                stats = MutateStats()
                stats.total_genomes = population.genome_count()
                i = len(preps)
                if snp_batch is not None and snp_batch.genome_ids:
                    steps.append((i, "snp", transcript, snp_batch))
                if indel_batch is not None and indel_batch.genome_ids:
                    steps.append((i, "indel", transcript, indel_batch))
                preps.append(
                    (transcript, snp_batch, indel_batch, empty_ids, host_ids, stats)
                )
        timings["capture_s"] += time.perf_counter() - t0

        # ONE pooled program for every step, ONE fetch (see _pooled_program).
        t0 = time.perf_counter()
        fetched: Dict[Tuple[int, str], np.ndarray] = {}
        recon: Dict[int, np.ndarray] = {}
        if steps:
            with span("kgt.mutate.dispatch"):
                specs, flat_inputs, widths = [], [], []
                for _i, which, tx, b in steps:
                    if which == "snp":
                        specs.append(("snp", tx.transcript_id, tx.start, tx.end))
                        flat_inputs += [b.positions, b.alt_codes, b.valid]
                        widths.append(8)  # tail-only: strings rebuild host-side
                    else:
                        K, A = b.pos.shape[1], b.ins_codes.shape[2]
                        pad_c = pad_coding_for(K * A)
                        specs.append(("indel", tx.transcript_id, tx.start, tx.end,
                                      pad_c, indel_band_for(b.edit_bound), INDEL_TAIL_ONLY))
                        flat_inputs += [b.pos, b.kind, b.del_len, b.ins_codes,
                                        b.ins_len, b.alt_code, b.valid]
                        if INDEL_TAIL_ONLY:
                            widths.append(8)
                        else:
                            s_pad = ((tx.coding_nucleotides() + pad_c + 2) // 3) * 3
                            widths.append(s_pad // 3 + 8)
                program = self._pooled_program(tuple(specs), [tx for _i, _w, tx, _b in steps])
                handle = program(flat_inputs, launches)
            t1 = time.perf_counter()
            timings["dispatch_s"] += t1 - t0
            with span("kgt.mutate.fetch"):
                # Tail-only indel steps: start the coding-string replay on host
                # threads now, so it runs while the fetch below waits.
                recon_jobs = [(i, tx, b) for i, which, tx, b in steps
                              if which == "indel" and INDEL_TAIL_ONLY]
                rpool = None
                futs = {}
                if recon_jobs:
                    rpool = WorkflowThreads(WorkflowThreads.default_threads(len(recon_jobs)))
                    futs = {i: rpool.enqueue_future(self._reconstruct_indel_codes, b, tx)
                            for i, tx, b in recon_jobs}
                fused = handle.cpu().numpy()
            timings["fetch_s"] += time.perf_counter() - t1
            timings["n_device_fetches"] += 1
            recon = {i: f.result() for i, f in futs.items()}
            if rpool is not None:
                rpool.shutdown()
            if fused.shape[1] != sum(widths):
                raise RuntimeError(f"packed width {fused.shape[1]} != {sum(widths)}")
            offsets = np.cumsum([0] + widths)
            for j, (i, which, _tx, _b) in enumerate(steps):
                fetched[(i, which)] = fused[:, offsets[j] : offsets[j + 1]]
        else:
            timings["dispatch_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        with span("kgt.mutate.unpack"):
            # One pool shared by every transcript's host-exact batch (the
            # reference's thread-per-genome pool, kga_analysis_lib_seqmutation.
            # cpp:116-140), started on the first transcript that needs it.
            pool = None
            results = []
            for i, (transcript, snp_batch, indel_batch, empty_ids, host_ids,
                    stats) in enumerate(preps):
                by_id: Dict[str, TranscriptMutateRecord] = {}
                reference_coding = self.contig_ref.coding_sequence(transcript).to_string()
                ref_validity = self.contig_ref.check_valid_transcript(transcript)
                for genome_id in empty_ids:
                    by_id[genome_id] = TranscriptMutateRecord(
                        genome_id, transcript.gene.feature_id,
                        transcript.transcript_id, 0, reference_coding, ref_validity,
                    )
                if len(host_ids) >= 8:
                    # Each task gets a private MutateStats, reduced below.
                    if pool is None:
                        pool = WorkflowThreads(WorkflowThreads.default_threads(len(host_ids)))
                    futures = []
                    for genome_id in host_ids:
                        contig_db = population.get_genome(genome_id).get_contig(contig_id)
                        local = MutateStats()
                        futures.append((genome_id, local, pool.enqueue_future(
                            self._host_mutate, genome_id, contig_db, transcript, local,
                        )))
                    for genome_id, local, fut in futures:
                        by_id[genome_id] = fut.result()
                        for f in _STAT_FIELDS:
                            setattr(stats, f, getattr(stats, f) + getattr(local, f))
                else:
                    for genome_id in host_ids:
                        contig_db = population.get_genome(genome_id).get_contig(contig_id)
                        by_id[genome_id] = self._host_mutate(
                            genome_id, contig_db, transcript, stats
                        )
                if (i, "snp") in fetched:
                    for rec in self._device_collect(
                        fetched[(i, "snp")], snp_batch, transcript,
                        transcript.coding_nucleotides(), stats,
                    ):
                        by_id[rec.genome_id] = rec
                if (i, "indel") in fetched:
                    for rec in self._device_collect_indel(
                        fetched[(i, "indel")], indel_batch, transcript, stats,
                        recon=recon.get(i),
                    ):
                        by_id[rec.genome_id] = rec
                results.append(([by_id[g] for g in sorted(by_id)], stats))
            if pool is not None:
                pool.shutdown()
        timings["unpack_s"] += time.perf_counter() - t0
        return results

    def mutate_transcript(
        self, population: PopulationDB, transcript: TranscriptionSequence,
        use_device: Optional[bool] = None,
    ) -> Tuple[List[TranscriptMutateRecord], MutateStats]:
        return self.mutate_transcripts(
            population, [transcript], use_device=use_device
        )[0]


class TranscriptFamilyAnalysis:
    """Per-transcript-family distance statistics and UPGMA trees.

    metric: "global" (NW, the default) or "local" (infix, edlib HW mode,
    the Pf gene-family metric)."""

    def __init__(self, records: List[TranscriptMutateRecord], reference_coding: str,
                 metric: str = "global", device=None):
        self.records = records
        self.reference_coding = reference_coding
        self.metric = metric
        self.device = resolve_device(device)

    def distinct_sequences(self) -> Dict[str, List[str]]:
        """Modified sequence -> genomes carrying it, in first-seen order."""
        out: Dict[str, List[str]] = {}
        for rec in self.records:
            out.setdefault(rec.modified_coding, []).append(rec.genome_id)
        return out

    def _padded_codes(self, sequences: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        width = max((len(s) for s in sequences), default=1)
        seqs = np.zeros((len(sequences), width), dtype=np.uint8)
        lens = np.zeros(len(sequences), dtype=np.int32)
        for i, s in enumerate(sequences):
            codes = DNA5.from_string(s) if s else np.empty(0, np.uint8)
            seqs[i, : len(codes)] = codes
            lens[i] = len(codes)
        return seqs, lens

    def reference_distances(self) -> Dict[str, int]:
        """Distance of each distinct mutant to the reference coding
        sequence (global NW or local infix, per self.metric)."""
        distinct = list(self.distinct_sequences())
        if not distinct:
            return {}
        seqs, lens = self._padded_codes(distinct + [self.reference_coding])
        n = len(distinct)
        ref_len = np.repeat(lens[-1:], n)
        # One reference row shared by every pair.
        route = local_levenshtein if self.metric == "local" else wavefront_levenshtein
        distances = route(seqs[:n], lens[:n], seqs[-1:], ref_len, device=self.device)
        return dict(zip(distinct, distances.tolist()))

    def distance_tree_newick(self, max_leaves: int = 256) -> str:
        """All-pairs distance over distinct sequences -> UPGMA -> Newick."""
        distinct = self.distinct_sequences()
        labels = []
        sequences = []
        for seq, genomes in list(distinct.items())[:max_leaves]:
            labels.append(genomes[0] if len(genomes) == 1 else f"{genomes[0]}+{len(genomes) - 1}")
            sequences.append(seq)
        if len(sequences) < 2:
            return f"({labels[0] if labels else 'reference'}:0);"
        seqs, lens = self._padded_codes(sequences)
        # As in reference_distances, any metric but "local" is global.
        # Family members differ by few edits, so the card takes the banded
        # pool for the global metric; overflow pairs re-run exactly, so this
        # is a routing choice and the matrix is the same either way.
        metric = "local" if self.metric == "local" else "global"
        band_k = DEVICE_BAND if self.device.type == "cuda" and metric == "global" else None
        matrix = pairwise_distance_matrix(seqs, lens, band_k=band_k, device=self.device,
                                          metric=metric)
        return newick(upgma_tree(matrix, labels))

    def reference_cigars(self, band_k: int = 127) -> Dict[str, str]:
        """CIGAR of each distinct mutant against the reference coding
        sequence by the banded traceback; pairs outside every band fall
        back to the exact host DP."""
        distinct = list(self.distinct_sequences())
        if not distinct:
            return {}
        seqs, lens = self._padded_codes([self.reference_coding] + distinct)
        n = len(distinct)
        ref_seq = np.repeat(seqs[:1], n, axis=0)
        ref_len = np.repeat(lens[:1], n)
        cigars = batched_cigar(ref_seq, ref_len, seqs[1:], lens[1:], band_k=band_k,
                               device=self.device)
        return dict(zip(distinct, cigars))

    def write_report(self, path: str, distances: Optional[Dict[str, int]] = None,
                     cigars: bool = False) -> None:
        distances = distances or self.reference_distances()
        cigar_map = self.reference_cigars() if cigars else {}
        with open(path, "w") as f:
            header = "Genome,Gene,Transcript,Variants,Validity,Distance,CodingLength"
            f.write(header + (",Cigar\n" if cigars else "\n"))
            for rec in self.records:
                distance = distances.get(rec.modified_coding, "")
                f.write(
                    f"{rec.genome_id},{rec.gene_id},{rec.transcript_id},"
                    f"{rec.variant_count},{rec.validity.value},{distance},"
                    f"{len(rec.modified_coding)}"
                    + (f",{cigar_map.get(rec.modified_coding, '')}\n" if cigars else "\n")
                )
