#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels under kgl_gene_tpu_torch/csrc (nvcc) and the native
host library kgl_gene_tpu_torch/native/kgt_native.cpp (g++), holds each
kernel against its plain PyTorch version on the card (exact equality),
and drives ten paths, each with the launch counts set to 0 just before
and read just after where it launches a kernel:

  1. the forward step (kgl_gene_tpu_torch.ops.pipeline.make_forward_step)
     in five configurations, every output held against the plain forward
     on the CPU;
  2. the transcript-family analysis (kgl_gene_tpu_torch.analysis.
     lib_seqmutation.TranscriptFamilyAnalysis) over 256 mutants of 3,000
     bases from configuration (a): reference distances, the all-pairs
     UPGMA tree (32,640 pairs at band 127), CIGARs and the report, each
     held against the same analysis on the CPU; then the B5 band doubling
     over the same pairs and batched_cigar on wide edits;
  3. the product path (kgl_gene_tpu_torch.analysis.lib_seqmutation.
     MutateGenes.mutate_transcripts) at bench.py's end-to-end shape:
     synthetic FASTA/GFF3/VCF of 256 samples, four genes of 3,000 coding
     bases and 3,000 records with indels, parsed by the port's loaders
     (the VCF by the native C++ record loop), then the SNP step and the
     SNP + indel step of every gene in one pooled program and one fetch.
     It fails unless B2 and B1 launch in both kinds of step, the 1,024
     records and their MutateStats equal the host-exact route's, every
     distance equals B3's exact one (the widest 16 also the numpy DP's),
     both indel payloads give the same records, the streaming Python parse
     of the same VCF and the native parse of its BGZF copy give the same
     population, and the streaming parse's population the same records.
     It prints genomes/s and the stage split (median of 5 passes after a
     warm one) and each step's time host-inclusive and on the device (a
     CUDA graph), then runs the indel step alone at bands 0, 31, 63 and
     127 and on the reverse strand (B = 256, S = 3,000), each against its
     CPU run entry by entry, band 0 launching B3;
  4. population scale (bench.py's bench_scale with 2 x 10^5 records of
     1,000 samples, about 2.6 GB): native ingest, VariantMajorCSR, allele
     frequencies and het/hom by genome, inbreeding streamed through the
     card (parallel/mesh.py streamed_inbreeding, Simple and RitlandLocus)
     and the four estimators on a dense window of 1,000 genomes x 10,000
     loci. It fails unless the incidences equal what numpy counts from the
     generator's seed and every F value on the card equals the CPU run of
     the same function within tests/test_torch_stats.py's tolerances. It
     prints each stage's seconds, the ingest rate, peak host RSS and
     device memory, and each device function's time beside its byte
     bound. These functions are plain PyTorch (no Pallas kernel stands
     behind them in the JAX package);
  5. the Bayesian phylogenetics path (phase 3e, bench.py's bench_phylo
     shapes): the vmapped heated chains (kgl_gene_tpu_torch.phylo.vmapped,
     4 chains x 16 taxa x 100,000 sites) against the host Chain, and the
     product sampler (phylo.mcmc.MCMCSampler, the fused full iteration of
     phylo.likelihood.CachedPartialsLikelihood, 16 taxa x 300,000 sites)
     with one chain and with four pipelined heated chains. It fails unless
     the card's log-likelihoods hold within PHYLO_REL of the port's CPU run
     and of the float64 host log_likelihood on the initial and final states,
     the path update within PHYLO_PATH_REL of a full recompute, and one run
     of each device program (the vmapped iteration, the sweep, the fused
     dispatch) makes no host synchronisation: the sync debug mode reports
     none and a sleep kernel enqueued before it is still running when it
     returns. It
     prints the rates with their spread, launches a likelihood and an
     iteration, and each device function's time beside its byte bound
     (plain PyTorch too: the JAX package runs lax.scan programs there);
  6. the ontology (phase 3f): the MICA kernel (csrc/mica.cu) against
     mica_plain on seeded ancestor lists (K = 64 and 192 ascending, K = 100
     in IC order, n = 1 and 257, two row sets, K = 1,000, empty rows,
     lengths from 0 to 256 mixed in one set, compact rows built on the
     host through mica_rows), then a seeded
     OBO of GO's size (write_go_obo: 43,000 terms in GO's three namespaces,
     depth >= 15; a synthetic shape, not checked against a GO release) and
     a GAF of 5,300 genes (write_go_gaf) through
     parse_go_file, GoGraph, TermAnnotation.from_gaf_file,
     InformationContent, ancestor_lists and lin_matrix_device /
     mica_matrix_device (rows from ancestor_rows, one pass over the
     ancestor bitsets) over the annotated biological_process terms (at
     most 8,192; K >= 192). It fails unless the kernel launched, its matrix
     equals mica_plain's on the card bit for bit (a 2,048-row block when
     the whole would take the plain version over 60 s), lin_matrix_device
     on 128 terms equals its CPU run and lies within 1e-6 of the host
     SimilarityLin, and OntologyDatabase on the full OBO with the GAF cut
     to 300 genes passes self_test and gives a 32-gene matrix. It prints
     the host stages, the kernel's time (CUDA events and a graph replay) on
     the path's compact rows and through the padded wrapper in the same
     windows, beside the byte and merge issue bounds (the
     merge steps each pair's two real lists need, counted by mica_work, at
     MICA_STEP_OPS instructions at the rate an SM dispatches instructions)
     and the design's own count (the warp rounds' lane slots at the merge
     loop's MICA_MERGE_OPS, at the same rate), its tile, shared memory and
     blocks an SM, the plain version's seconds, peak
     device memory and the generated ontology's shape (edges by relation,
     depth, ancestors a term, annotated BP terms);
  7. the checkpointed ingest and the local metric (phase 3g): phase 3c's
     VCF parsed by the streaming loop with an ingest cursor every
     CHECKPOINT_EVERY records, interrupted by a parser that raises after
     CHECKPOINT_INTERRUPT records and resumed; it fails unless the cursor
     stopped at the last snapshot, the resumed population and INFO equal
     the native ingest's, the checkpoint files are gone, and PassFilter,
     SNPFilter and PloidyAnalysis give the same on both. Then
     TranscriptFamilyAnalysis(metric="local") over phase 3b's 256 mutants
     (reference_distances and the 32,640-pair distance_tree_newick) on
     the card, counts from 0: it fails unless only kernel `local`
     (csrc/wavefront.cu, kgt_local) launched, the reference distances and
     the all-pairs matrix equal the cell-level plain version on the card
     (the matrix in chunks, every pair unless LOCAL_PLAIN_LIMIT_S stops it
     first: the line says how many were held), a few entries equal the
     numpy DP, and batched_metric's local and global coding metrics over
     the same pairs equal the matrix and B3. It prints the checkpointed
     streaming seconds beside the native ingest's;
  8. the application shell (phase 3h): run_application(GeneExecEnv,
     ["--optionFile", runtime.xml, "--device", "cuda"]), what
     `python -m kgl_gene_tpu_torch.app.exec_env` runs, on one runtime XML
     with the nine registered analyses in two packages (NULL, INTERVAL,
     INFO_FILTER, INBREED, PfSEQUENCE, PfEMP and MUTATION over phase 3c's
     VCF; NULL, PARSEJSON and LITERATURE over a dbSNP JSON) with every
     resource kind they read (genome with GAF, ontology, genealogy,
     genome aux, citations, Pf7 samples, FWS and distance, bioPMID,
     Entrez, and a PubMed cache the phase writes), counts from 0. It
     fails unless the run returns 0, no analysis is dropped, B1 and B2
     launch, no request leaves the machine (urlopen refuses and counts),
     every publication comes from the cache, and every file of the port's
     CPU run of the same XML, whose PfSEQUENCE names one gene
     (PACKAGE_CPU_GENES) and whose all-pairs tree takes the card's exact
     route at band 127 (BandedCpuTree), equals the card run's file
     (inbreeding.csv's F within ESTIMATOR_ATOL). It prints the seconds of
     each analysis on both runs, the files and the launches;
  9. the multi-device forms (phase 3i): kernel wavefront_chunk
     (csrc/sharded_wavefront.cu, one chunk of the sharded long-pair
     wavefront a launch, or a few past 512 diagonals) against chunk_plain
     on ragged pairs to 4,000 bases, halos 32, 128, 600 and 1,024, worlds
     1 and 2 simulated in this process, and at world 1 its cooperative
     route (kgt_wavefront_chunks: a run of chunks in one launch, a grid
     barrier between two) bit for bit against the launches a chunk;
     then parallel.dist.run_ranks at world 1 on NCCL and at world 2 on
     gloo with both ranks on cuda:0 (NCCL refuses two ranks on one card),
     counts from 0 in each rank: make_multichip_step at B = 4,096, K = 48,
     S = 3,000 and make_multichip_indel_step at B = 256, bands 63 and 0
     (B1, B3), each gathered and equal to the one-card step (pop_ac to
     numpy's column sums), sharded_levenshtein on a 32,768-base pair
     equal to B3 (launched after the counts are read) and on a
     49,152-base pair (past B3's MAX_KERNEL_LEN), both equal to the numpy
     DP; at world 2 also sharded_pairwise_distances over phase 3b's 256
     mutants (32,640 pairs, band 127) equal to phase 3b's matrix, sharded
     allele counts, het/hom and the four estimators on a 1,000 x 10,000
     window (within ESTIMATOR_ATOL of the one-device forms) and streamed
     inbreeding over a seeded 1,000 x 2^18 CSR bit for bit equal to the
     one-rank run. It fails unless every rank ran on cuda over its
     backend and launched B1, B2, B3 and the chunk kernel, the rank of
     world 1 by the cooperative route alone and the ranks of world 2 by
     the launches a chunk alone, within its deadline. It prints each
     rank's device, backend, copies through the host and launches, the
     step over the mesh beside the one-card step in turns, the
     32,768-base pair beside B3, and the phase's seconds;
 10. kernel loglik (phase 3j, csrc/loglik.cu): the Loglikelihood
     estimator against its plain version (stats/inbreeding.py
     _loglik_rows_plain, eager float64) on the card, on ragged shapes with
     every mask form, codes past 2 and the int32 view run_estimator hands
     on, then at the INBREED cell's 2,504 genomes x 25,000 loci drawn from
     a seed; then one InbreedAnalysis.estimate, counts from 0. It fails
     unless every F lies within 1e-4 of the plain version's, a call
     launches loglik 41 times and nothing else, and the estimate counts
     145 evaluations and 41 passes. It prints the kernel's time beside its
     bound and the plain version's, and a {"loglik": {...}} line;
 11. kernel hallme (phase 3k, csrc/hallme.cu): the HallME estimator against
     its plain version (stats/inbreeding.py _hall_me_rows_plain, eager
     float32) and the benchmark's float64 reference (port_bench/reference/
     inbreed.py hall_me) on the card, on ragged shapes (both load widths)
     with every mask form, codes past 2 and the int32 view, then at the
     INBREED cell's 2,504 x 25,000 shape; then one InbreedAnalysis.estimate,
     counts from 0. It fails unless every F lies within 1e-3 of the plain
     version's and of the reference's, a call launches hallme once a step
     and nothing else (the profiler's kernels a call: hallme's and at most
     the one fill of its counters), and the estimate counts a pass a step.
     It prints the time a step and a call beside the byte bound and the
     plain version's, and a {"hallme": {...}} line;
 12. kernels fws_variants and fws_genomes (phase 3l, csrc/fws.cu): the
     PfEMP statistics' two passes against their plain versions
     (stats/fws.py _variant_counts_plain, _genome_partials_plain) on the
     card, each pair on the same codes, mask and variant order, on ragged
     shapes with codes 0..3 and random subsets and then at the Pf7 cell's
     whole population (16,203 genomes x 2,000,000 variants, 32.4 GB) for
     every genome and for a 65% subset, where fws_statistics on the card is
     also held against the benchmark's float64 reference
     (port_bench/reference/fws.py), and at small shapes against the same
     call on the CPU; then one PfEMPAnalysis.statistics, counts from 0. It fails unless every count is exact, the hs sums lie
     within 1e-12 (relative) of the plain version's, every FWS within 1e-11,
     and the call launches each kernel once and counts two passes. It
     prints each kernel's time beside its byte bound and the plain
     versions', and a {"fws": {...}} line.

B1 (banded Myers), B4 (traceback codes) and B5 (banded distance) each
have two bodies that their launchers choose between from the shapes
alone; each body is held against the plain version at every band, the
script prints which body each shape takes, and it fails unless the
forward step's shapes take B1's group body, a launch of 9,000 pairs at
band 511 its thread body, the family's band B4's warp body, and B5 its
warp body up to band 255 and its block body above. The walk over B4's
codes (csrc/walk.cu) is held against its plain PyTorch loop at the
family's shape and on the wide-edit pairs. The local kernel is held
against its word-level and cell-level plain versions on ragged pairs in
both orders, a shared row, codes negative and >= 32, lq == lt, pads that
copy the query, the 64-row block and 2,048-row slot edges, queries of one
and several 4,096-row stripes up to 5,000 rows and 12,300-wide rows, and
the pad rows ahead of a query (lq = 1, 63, 65 and multiples of 64 to
12,288, codes outside 0..31). The local rows are timed in turns with B3 on
the same pairs. The walk's row also carries latency bounds: each pair's
live steps at the L2 hit latency where the step reads a line new to its
warp and at the L1 hit latency otherwise, its trips after the end at two
stores a cycle each, the longest pair's sum (warm, the codes in the L2 as
back-to-back walks find them); and the same with the new lines outside the
last 50 MB that B4 wrote at the device-memory hop (cold, each walk right
after a fresh B4, as reference_cigars runs it); the latencies come from a
pointer chase of one thread (csrc/chase.cu) over 16 KB, 8 MB and 1 GB.
The walk is timed warm and cold.

Then it times the step, the family path and each kernel; the family
path's kernels (B5, B1's pool, B4, the walk) and B3 are first held against
their plain versions at the shapes they are timed at. Kernels are timed
two ways: host-inclusive (back-to-back calls between two events, which
reads the host's rate of issuing them when the kernel is short) and on the
device alone (the calls captured into one CUDA graph, events around a
replay); B1, B4 and B5 with the body they replaced beside the new one. Each
row of the kernels line carries bound_ms (integer operations set against
the card's float32 rate, as every earlier run computed it) and
issue_bound_ms (the same operations against the rate the card issues
integer operations at). It imports nothing of JAX or of the JAX package.

Output: progress lines, then one JSON line {"device_functions": [...]}
(phases 3d's and 3e's device functions: time, launches, byte bound), one
{"scale": {...}} (phase 3d's stages and checks), one {"phylo": {...}}
(phase 3e's rates and checks), one {"ontology": {...}} (phase 3f's stages,
sizes, checks and the MICA kernel's times and bounds), one
{"checkpoint_local": {...}} (phase 3g's seconds and checks), one
{"package": {...}} (phase 3h's seconds by analysis, files and launches),
one {"multidevice": {...}} (phase 3i's checks, ranks and times), one
{"loglik": {...}} (phase 3j's checks), one {"hallme": {...}} (phase 3k's
checks and times), one {"fws": {...}} (phase 3l's checks and times), one
{"kernels": [...]} of seventeen
rows (`local` at B = 256 against the shared reference and `local_pool` over the 32,640 pairs, each at 3,000 and at
2,181 bases with the layout the rule took in `geometry`, are the local
kernel's; the rows of
B1, B2 and B3 also carry their launches
in the product path's SNP and indel steps and in the band-0 indel step;
the mica row's bound_ms is the larger of its byte floor and its merge
issue floor, and it carries design_issue_ms; the walk's carries
cold_ms, latency_bound_ms and cold_latency_bound_ms; wavefront_chunk's
carries dispatch_bound_ms beside issue_bound_ms and holds the middle
chunk of the 32,768-base pair from its DP state; wavefront_chunks,
the cooperative route, times 8 chunks of that pair in one launch and
carries the whole pair's wall split into the launch's device time and the
host's rest; loglik's bound_ms is the larger of its byte and float64
floors, beside each in bytes_bound_ms and fp64_bound_ms; hallme's row
times a call at the cell's shape, its bound the codes read once a step;
fws's row times both passes at the Pf7 cell's shape over every genome, its
bound the codes read once a pass),
the
card's name and power limit from nvidia-smi, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, with no result, when there
is no CUDA device, when the port is missing, or when any phase fails.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import math
import multiprocessing
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

SEED = 0
REGION_LEN = 4800
EXONS = np.array([[400, 1900], [2400, 3900]], dtype=np.int64)  # 3,000 coding bases
S = 3000
LOCAL_GENE_BASES = 2181  # kelch13's coding bases: the local rows' second width
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# H100 SXM peak rates list no int32 rate outside the tensor cores; the
# float32 rate (67 T/s) stands in, which makes every bound of an integer
# kernel a floor (Hopper issues int32 at half that rate).
OPS_PER_S = 67e12
INT_LANES_PER_SM = 64  # an H100 SM issues 64 int32 operations a cycle, no fused pair
# An H100 SM's four schedulers dispatch one warp instruction a cycle each:
# 128 lanes a cycle, whatever pipes the instructions go to.
DISPATCH_LANES_PER_SM = 128
MYERS_OPS_PER_BLOCK_COLUMN = 34  # 17 word ops of 64 bits, two int32 ops each
WAVEFRONT_OPS_PER_CELL = 6       # compare, 2 adds, 2 mins, store select
# Banded row DP per cell: compare, two adds and a min for base, an add and
# a min for the insertion chain, two selects (j == 0, out of band); the
# codes add two compares, three selects and the run's min and add.
BANDED_OPS_PER_CELL = 8
BANDED_CHOICES_OPS_PER_CELL = 15
# The walk's latency bound: the pointer chase that reads the L1 and L2 hit
# latencies (a cycle of 128-byte lines over these bytes), and the two tape
# stores a trip after a pair's end.
CHASE_L1_BYTES = 16 << 10
CHASE_L2_BYTES = 8 << 20
CHASE_HOPS = 100_000
# A third footprint, 20x the L2, for the device-memory hop: a line of a
# random cycle over it is in the L2 about one time in twenty.
CHASE_DRAM_BYTES = 1 << 30
CHASE_DRAM_HOPS = 20_000
WALK_STORES_PER_TRIP = 2
L2_BYTES = 50 << 20  # the H100's L2: the last codes B4 wrote that it can hold
WALK_COLD_REPS = 15  # walks timed each right after a fresh B4
FAMILY_LOCAL_RECORDS = 16  # the local metric's plain CPU run is slow at 3 kb
# The product path at bench.py's end-to-end shape (bench.py:139-142 and
# :152): 256 samples, four single-exon genes of 3,000 coding bases on a
# 120 kb contig, 3,000 VCF records of which about 10% are indels.
PRODUCT = dict(n_samples=256, contig_len=120_000, n_genes=4, n_records=3_000,
               coding_len=3_000, snp_only=False)
PRODUCT_BUCKETS = dict(k_bucket=32, b_bucket=256)
PRODUCT_PASSES = 5
PRODUCT_ORACLE_RECORDS = 16  # distances also held against the numpy DP
STAGES = ("parse_s", "capture_s", "dispatch_s", "fetch_s", "unpack_s", "total_s")
# The indel step alone, at the forward step's geometry (S = 3,000), B = 256:
# (band, reverse strand, slots K, insert width A), K * A <= band, so every
# genome's edits fit the band as capture's edit bound guarantees.
INDEL_ALONE = ((0, False, 16, 8), (31, False, 5, 6), (63, False, 10, 6), (127, False, 20, 6),
               (63, True, 10, 6))
# Population scale at bench.py's bench_scale shape (bench.py:282-408): a
# Pf-diploid VCF of 1,000 samples from generate_scale_vcf (seed 11, chunks
# of 20,000 records), cut from 10^6 to 2 x 10^5 records to fit the script's
# time: about 2.6 GB and 2 x 10^8 genotype cells.
SCALE = dict(n_records=200_000, n_samples=1_000)
SCALE_SEED, SCALE_CHUNK_ROWS = 11, 20_000  # generate_scale_vcf's defaults, replayed below
SCALE_WINDOW = 10_000  # loci of the dense window the four estimators run on
# Tolerances of tests/test_torch_stats.py: the card against the CPU.
ESTIMATOR_ATOL = {"Simple": 1e-5, "RitlandLocus": 1e-5, "HallME": 1e-3, "Loglikelihood": 1e-4}
# The phylogenetics path at bench.py's bench_phylo shapes (bench.py:201-279):
# 16 taxa; the vmapped chains on 100,000 sites (4 chains, run(200) twice to
# warm, then three timed windows, the host Chain over 8 iterations as the
# denominator); the product sampler on 300,000 sites (seed 3, run(3) to warm,
# three windows of run(12)), once with one chain and once with 4 pipelined
# heated chains. Its one cut: no 300,000-site host denominator (minutes).
PHYLO = dict(n_taxa=16, vm_sites=100_000, vm_chains=4, vm_iters=200, host_iters=8,
             prod_sites=300_000, prod_warm=3, prod_iters=12, heated_chains=4, windows=3)
# Log-likelihoods of -2e6 to -1e7 on these random alignments, in float32
# (spacing 0.25 to 1): the card against the port's CPU run and against the
# float64 host log_likelihood, relative; the path update against a full
# recompute.
PHYLO_REL = 1e-5
PHYLO_PATH_REL = 1e-6
SYNC_PROBE_CYCLES = 2_000_000_000  # about a second at the H100's 1.98 GHz
# Phase 3f, a synthetic ontology of GO's size: GO's three root ids and
# 43,000 terms (28,000 BP, 11,000 MF, 4,000 CC; about GO's active term
# count, not checked against a GO release), annotated for the ~5,300 genes
# of P. falciparum 3D7 (Gardner et al., Nature 419:498-511, 2002). The
# shape has no source: neither a go-basic.obo nor a Pf3D7 GAF is in the
# repository to measure it from. GO_PARENTS, GO_RECENT and GO_PART_OF
# follow the outline of 1-3 parents among a namespace's earlier terms,
# drawn towards the recent ones, about a fifth of the edges part_of, with
# values chosen so that the DAG reaches depth 15 and a list longer than
# 128 ancestors; GO_ASPECTS, GO_ZIPF, GO_NOT and the 1-12 annotations a
# gene are chosen likewise. They set the ancestor lists' lengths and the
# number of annotated BP terms, so the times of this phase are those of
# this shape, not of GO's.
GO_NAMESPACES = (("biological_process", "GO:0008150", 28_000, "P"),
                 ("molecular_function", "GO:0003674", 11_000, "F"),
                 ("cellular_component", "GO:0005575", 4_000, "C"))
GO_PARENTS = (0.8, 0.15, 0.05)  # P(1, 2 or 3 parents)
GO_RECENT = 1.3  # a parent lies floor(t * u ** GO_RECENT) terms before term t
GO_PART_OF = 0.5  # share of second and third parents that are part_of: ~1/5 of edges
GO_GENES = 5_300
GO_ASPECTS = (0.5, 0.3, 0.2)  # an annotation's namespace: BP, MF, CC
GO_ZIPF = 0.7  # term rank exponent of the annotations inside a namespace
GO_NOT = 0.02
GO_MAX_TERMS = 8_192  # annotated BP terms the device matrix covers
GO_HOST_TERMS = 128
GO_DB_GENES = 300  # the one cut: OntologyDatabase's host cache is O(n^2 terms) numpy
GO_DB_MATRIX = 32
MICA_PLAIN_LIMIT_S = 60.0  # above it the plain version holds a 2,048-row block
# The fewest instructions a merge step needs (two loads, a compare, two
# advances, the max-min): the price of a step in the mica bound, at the
# dispatch rate (DISPATCH_LANES_PER_SM).
MICA_STEP_OPS = 6
# Instructions a merge step of the kernel's loop issues: half of the 39 of
# one trip of two steps (each two predicated 8-byte shared loads, five
# compares, the pointer adds and their selects, the predicated max-min,
# register moves) with its test of the heads and branch, as ptxas compiled
# mica_rows_kernel for sm_90a (cuobjdump -sass of the library,
# scripts/torch_kernel_bodies.py --sass): the price of a lane slot in the
# design's own count, at the same rate.
MICA_MERGE_OPS = 19.5
MICA_TILE = 64  # csrc/mica.cu's tile of rows at phase 3f's shape


# Phase 3g: the checkpointed ingest of phase 3c's VCF and the local metric
# over phase 3b's 256 mutants.
CHECKPOINT_EVERY = 500
CHECKPOINT_INTERRUPT = 1_700  # records the interrupted parser takes before it raises
LOCAL_PLAIN_CHUNK = 4_096  # pairs a call of the cell-level plain version takes
LOCAL_PLAIN_LIMIT_S = 60.0  # past it the plain version holds the pairs done so far
LOCAL_ORACLE_PAIRS = 6  # all-pairs entries also held against the numpy DP


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sm_max_clock_hz():
    """The SM clock's maximum, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def issue_rate(lanes=INT_LANES_PER_SM):
    """Operations a second the card can issue at `lanes` lanes an SM (64:
    the int32 pipe; DISPATCH_LANES_PER_SM: any mix of pipes), the SM count
    from the device properties, the SM clock's maximum. The float32 rate
    behind bound_ms counts 128 lanes and a fused multiply-add as two, so it
    is 4x the int32 rate."""
    import torch

    return lanes * torch.cuda.get_device_properties(0).multi_processor_count * sm_max_clock_hz()


def time_cuda_turns(fns, iters, windows=5, warm=True):
    """For each fn of `fns` the median over `windows` of the mean ms per
    call, CUDA events around `iters` back-to-back calls. The fns take
    turns window by window, so that a host whose speed shifts during the
    run treats them alike. Host-inclusive: when a call is shorter on the
    card than on the host, this reads the host's rate of issuing it."""
    import torch

    if warm:
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    per = [[] for _ in fns]
    for _ in range(windows):
        for fn, times in zip(fns, per):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / iters)
    return [statistics.median(times) for times in per]


def time_cuda(fn, iters, windows=5, warm=True):
    """Median over `windows` of the mean ms per call, CUDA events."""
    return time_cuda_turns([fn], iters, windows, warm)[0]


def time_device(fns, launches, windows=5):
    """Median over `windows` of the mean device ms per call: `launches`
    calls, taken in turn from the list `fns`, are captured into one CUDA
    graph and events go around one replay, so the host's rate of issuing
    calls is not in the reading (the card's own gap between two graph
    nodes is). Calls on different buffers whose total exceeds the 50 MB L2
    make every call read device memory, as the bound assumes."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / launches)
    return statistics.median(per)


def gene_region(rng):
    """A random region whose exons splice to an open reading frame: ATG,
    998 random sense codons, TAA. SNPs then give every validity code."""
    region = rng.integers(0, 4, size=REGION_LEN).astype(np.uint8)
    stops = {48, 50, 56}  # TAA, TAG, TGA
    sense = np.array([c for c in range(64) if c not in stops])
    codons = np.concatenate([[14], rng.choice(sense, S // 3 - 2), [48]])  # ATG ... TAA
    coding = np.stack([codons // 16, codons // 4 % 4, codons % 4], 1).reshape(-1)
    at = 0
    for lo, hi in EXONS:
        region[lo:hi] = coding[at : at + hi - lo]
        at += hi - lo
    return region.astype(np.uint8)


def snp_batch(rng, B, K, L):
    positions = rng.integers(0, L, size=(B, K)).astype(np.int32)
    alt = rng.integers(0, 4, size=(B, K)).astype(np.uint8)
    valid = rng.random((B, K)) < 0.8
    return positions, alt, valid


def exact(name, got, want):
    """max |got - want| over integer tensors; raises unless 0."""
    import torch

    got = got.cpu().to(torch.int64)
    want = want.cpu().to(torch.int64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got - want).abs().max()) if got.numel() else 0
    if err:
        bad = int((got != want).sum())
        raise AssertionError(f"{name}: {bad} entries differ, max abs err {err}")
    log(f"  {name}: exact ({got.numel()} values)")
    return err


def phase_kernels(dev, errs):
    """Each kernel against its plain version on the card."""
    import torch

    from kgl_gene_tpu_torch.ops.edit_distance import batched_levenshtein, levenshtein_numpy
    from kgl_gene_tpu_torch.ops.myers import (
        MYERS_BANDS, myers_distance_padded, myers_kernel_body, myers_plain,
    )
    from kgl_gene_tpu_torch.ops.variant_apply import (
        translate_batch, translate_batch_kernel, translate_kernel_body,
    )
    from kgl_gene_tpu_torch.ops.wavefront import (
        MAX_KERNEL_LEN, batched_levenshtein_kernel, bitvector_plain,
    )
    from kgl_gene_tpu_torch.sequence.ncbi_table_data import NCBI_TABLES
    from kgl_gene_tpu_torch.sequence.tables import amino_translation_table

    rng = np.random.default_rng(SEED + 1)

    # B2: every NCBI table at the step's shape, then the shapes that reach
    # each body of the kernel: S % 3 != 0 and a misaligned view (scalar),
    # a ragged end of the codon stream, B = 1, k = 0. Codons holding N
    # are present throughout.
    def codes(B, width):
        x = rng.integers(0, 4, size=(B, width)).astype(np.uint8)
        x[rng.random(x.shape) < 0.01] = 4
        return torch.as_tensor(x, device=dev)

    coding_t = codes(256, S)
    luts = {name: torch.as_tensor(amino_translation_table(name).amino_lut, device=dev)
            for name in sorted(NCBI_TABLES)}
    for name, lut in luts.items():
        errs["translate"] = max(errs["translate"], exact(
            f"B2 translate {name} (256, {S})",
            translate_batch_kernel(coding_t, lut), translate_batch(coding_t, lut)))
    flat = codes(1, 256 * S + 1).reshape(-1)
    cases = {
        f"(4096, {S})": codes(4096, S), "(8, 120)": codes(8, 120),
        f"(256, {S + 1})": codes(256, S + 1), f"(256, {S + 2})": codes(256, S + 2),
        f"(1, {S})": codes(1, S), "(7, 33), ragged end": codes(7, 33),
        "(5, 2), k = 0": codes(5, 2),
        f"(256, {S}) view one byte off alignment": flat[1:].view(256, S),
    }
    bodies = {f"(256, {S})": translate_kernel_body(coding_t)}
    lut = luts["NCBI_TABLE_1"]
    for name, x in cases.items():
        bodies[name] = translate_kernel_body(x)
        errs["translate"] = max(errs["translate"], exact(
            f"B2 translate {name}", translate_batch_kernel(x, lut), translate_batch(x, lut)))
    log(f"  B2 bodies: {bodies}")
    for name in (f"(256, {S})", f"(4096, {S})", "(8, 120)"):
        if bodies[name] != "vector":
            raise AssertionError(f"B2 took the {bodies[name]} body at the step's shape {name}")
    for name in (f"(256, {S + 1})", f"(256, {S + 2})", f"(256, {S}) view one byte off alignment"):
        if bodies[name] != "scalar":
            raise AssertionError(f"B2 took the {bodies[name]} body at {name}")

    # B1, every band, one shared text and per-pair texts, in each body a
    # launch can take: the launcher's rule gives these pair counts the
    # group body; the thread body, which the rule keeps for launches that
    # fill the card, is named here and reached by the rule further down.
    # Ragged la and lb, la = 0, lb = 0, |la - lb| beyond every band,
    # unrelated pairs, la on block edges, B = 1 and B = 257 (not a multiple
    # of the 10, 6 or 3 pairs a warp holds).
    B = 257
    ref = rng.integers(0, 5, size=S).astype(np.int32)
    a = np.tile(ref, (B, 1))
    for i in range(B):
        n = int(rng.integers(0, 140))
        pos = rng.choice(S, n, replace=False)
        a[i, pos] = (a[i, pos] + 1 + rng.integers(0, 4, n)) % 5
    a[:8] = rng.integers(0, 5, size=(8, S))  # unrelated: distance >> band
    la = np.full(B, S, np.int32) - rng.integers(0, 200, B).astype(np.int32)
    lb = np.full(B, S, np.int32) - rng.integers(0, 200, B).astype(np.int32)
    la[8], lb[9], la[10], lb[10] = 0, 0, 0, 0
    lb[11] = S - 500  # |la - lb| beyond every band
    la[12:16] = (63, 64, 65, 128)
    lb[12:16] = (60, 70, 65, 140)
    a_t, la_t, lb_t = (torch.as_tensor(x, device=dev) for x in (a, la, lb))
    ref_t = torch.as_tensor(ref[None, :], device=dev)
    per_pair = torch.as_tensor(np.roll(a, 1, axis=0), device=dev)
    taken = {}
    single = {(63, "shared"), (127, "per-pair"), (511, "shared")}  # also run at B = 1
    for k in MYERS_BANDS:
        for text, mode in ((ref_t, "shared"), (per_pair, "per-pair")):
            for n in (B, 1) if (k, mode) in single else (B,):
                args = (a_t[:n], la_t[:n], text[:n] if mode == "per-pair" else text, lb_t[:n])
                want = myers_plain(*args, k)
                taken[f"B={n} k={k}"] = myers_kernel_body(n, S, S, k)
                for body in (None, "thread"):
                    errs["myers"] = max(errs["myers"], exact(
                        f"B1 myers {mode} text k={k} (B={n}, S={S}), "
                        f"{body or 'the rule: ' + taken[f'B={n} k={k}']} body",
                        myers_distance_padded(*args, band_k=k, _body=body), want))
    # Peq words above 48 KB of dynamic shared memory: 12,300 rows, 10 pairs
    # a warp at band 63 (92 KB).
    long_ref = rng.integers(0, 4, size=12300).astype(np.int32)
    long_a = np.stack([indel_mutant(rng, long_ref, 40, 4)[:12280] for _ in range(8)])
    args = [torch.as_tensor(x, device=dev) for x in (
        long_a, np.full(8, 12280, np.int32), long_ref[None, :], np.full(8, 12300, np.int32))]
    errs["myers"] = max(errs["myers"], exact(
        "B1 myers shared text k=63 (B=8, Wa=12280, Wt=12300), group body above 48 KB",
        myers_distance_padded(*args, band_k=63), myers_plain(*args, 63)))
    taken["B=8 k=63 Wa=12280"] = myers_kernel_body(8, 12280, 12300, 63)
    for n, k in ((256, 63), (4096, 63)):
        taken[f"B={n} k={k}"] = myers_kernel_body(n, S, S, k)
        if taken[f"B={n} k={k}"] != "group":
            raise AssertionError(f"B1 takes the thread body at the step's shape B={n}, k={k}")
    # A launch the rule gives the thread body (band 511 above 8,192 pairs),
    # against the group body named, which is held against the plain version
    # at this band above.
    n = 9000
    reps = -(-n // B)
    big = [x.repeat(reps, 1)[:n].contiguous() for x in (a_t, per_pair)] + [
        x.repeat(reps)[:n].contiguous() for x in (la_t, lb_t)]
    taken[f"B={n} k=511"] = myers_kernel_body(n, S, S, 511)
    errs["myers"] = max(errs["myers"], exact(
        f"B1 myers per-pair text k=511 (B={n}, S={S}), the rule: {taken[f'B={n} k=511']} body, "
        "vs the group body",
        myers_distance_padded(big[0], big[2], big[1], big[3], band_k=511),
        myers_distance_padded(big[0], big[2], big[1], big[3], band_k=511, _body="group")))
    del big
    log(f"  B1 bodies: {taken}")
    if taken[f"B={n} k=511"] != "thread":
        raise AssertionError("B1's rule does not reach the thread body")

    # B3: the entry() shape (S = 120, shared reference) and S = 3000,
    # B = 64, ragged per-pair lengths.
    e_ref = rng.integers(0, 4, size=(1, 120)).astype(np.int32)
    e_a = np.tile(e_ref, (8, 1))
    e_a[rng.random(e_a.shape) < 0.05] = 2
    e_l = np.full(8, 120, np.int32)
    args = [torch.as_tensor(x, device=dev) for x in (e_a, e_l, e_ref, e_l)]
    errs["wavefront"] = max(errs["wavefront"], exact(
        "B3 wavefront entry shape (B=8, S=120)",
        batched_levenshtein_kernel(*args), batched_levenshtein(*args)))
    wa = torch.as_tensor(a[:64], device=dev)
    wb = torch.as_tensor(np.roll(a, 3, axis=0)[:64], device=dev)
    args = [wa, la_t[:64].contiguous(), wb, lb_t[:64].contiguous()]
    errs["wavefront"] = max(errs["wavefront"], exact(
        f"B3 wavefront ragged (B=64, S={S})",
        batched_levenshtein_kernel(*args), batched_levenshtein(*args)))

    # B3 with one shared b row and ragged lengths on both sides (la = 0,
    # lb = 0 among them), then empty widths and an empty batch.
    args = [a_t, la_t, ref_t, lb_t]
    errs["wavefront"] = max(errs["wavefront"], exact(
        f"B3 wavefront shared b, ragged la and lb (B={B}, S={S})",
        batched_levenshtein_kernel(*args), batched_levenshtein(*args)))
    for name, rows, wa, wb in (("Ma = 0", 3, 0, 7), ("Mb = 0", 3, 7, 0), ("B = 0", 0, 7, 7)):
        args = [torch.as_tensor(rng.integers(0, 4, size=(rows, wa)).astype(np.int32), device=dev),
                torch.full((rows,), wa, dtype=torch.int32, device=dev),
                torch.as_tensor(rng.integers(0, 4, size=(rows, wb)).astype(np.int32), device=dev),
                torch.full((rows,), wb, dtype=torch.int32, device=dev)]
        errs["wavefront"] = max(errs["wavefront"], exact(
            f"B3 wavefront {name}", batched_levenshtein_kernel(*args), batched_levenshtein(*args)))

    # B3 on the ragged set B5 is held on below: indels, la = 0, lb = 0,
    # unrelated pairs, length gaps of 600, per-pair b.
    args = [torch.as_tensor(x, device=dev)
            for x in banded_case(np.random.default_rng(SEED + 2), 256)]
    errs["wavefront"] = max(errs["wavefront"], exact(
        f"B3 wavefront (B=256, S={S}, ragged, indels, la=0, lb=0, unrelated, gaps of 600)",
        batched_levenshtein_kernel(*args), batched_levenshtein(*args)))

    # Codes outside 0..31 and negative (the match word built on the spot),
    # Ma != Mb, la on block edges: against the word-level plain version and
    # the cell-level one.
    pool = np.array([-7, -1, 0, 3, 31, 32, 33, 1000, 2 ** 31 - 1, -(2 ** 31)])
    o_ref = rng.choice(pool, 330)
    o_a = np.tile(o_ref[:300], (64, 1))
    hit = rng.random(o_a.shape) < 0.08
    o_a[hit] = rng.choice(pool, int(hit.sum()))
    o_b = np.tile(o_ref, (64, 1))
    o_b[:4] = rng.choice(pool, (4, 330))
    o_la = rng.integers(0, 301, 64)
    o_la[:8] = (63, 64, 65, 127, 128, 129, 192, 300)
    o_lb = rng.integers(200, 331, 64)
    args = [torch.as_tensor(np.asarray(x, dtype=np.int32), device=dev)
            for x in (o_a, o_la, o_b, o_lb)]
    got = batched_levenshtein_kernel(*args)
    errs["wavefront"] = max(
        errs["wavefront"],
        exact("B3 wavefront vs its word-level plain version, codes negative and >= 32 "
              "(B=64, Ma=300, Mb=330)", got, bitvector_plain(*args)),
        exact("B3 wavefront vs the cell-level plain version, same pairs",
              got, batched_levenshtein(*args)))

    # Several stripes of 32 blocks (M = 4,200: 66 blocks) and dynamic
    # shared memory above 48 KB (M = 12,300: 193 blocks, 55 KB).
    for M, B in ((4200, 8), (12300, 4)):
        w_ref = rng.integers(0, 4, size=M).astype(np.int32)
        rows_a = [w_ref[: M - int(rng.integers(0, 300))] for _ in range(B)]
        rows_b = [indel_mutant(rng, w_ref, int(rng.integers(0, 200)), 6)[:M] for _ in range(B)]
        rows_b[0] = rng.integers(0, 4, size=M - 100).astype(np.int32)  # unrelated
        w_a, w_la = pack_pairs(rows_a)
        w_b, w_lb = pack_pairs(rows_b)
        args = [torch.as_tensor(x, device=dev) for x in (w_a, w_la, w_b, w_lb)]
        errs["wavefront"] = max(errs["wavefront"], exact(
            f"B3 wavefront (B={B}, M={M}, ragged, indels, one unrelated pair)",
            batched_levenshtein_kernel(*args), batched_levenshtein(*args)))
    # The widest shape the kernel's shared memory holds (all 227 KB, ten
    # stripes of 64 blocks), against the numpy oracle: the plain version
    # would take minutes. 2,000 text columns keep the oracle short.
    M = MAX_KERNEL_LEN
    w_a = rng.integers(0, 4, size=(1, M)).astype(np.int32)
    w_b = np.roll(w_a, -20000, axis=1)  # the text: 2,000 bases from mid-pattern
    pos = rng.choice(2000, 100, replace=False)
    w_b[0, pos] = (w_b[0, pos] + 1) % 4
    w_la, w_lb = np.array([M], np.int32), np.array([2000], np.int32)
    got = batched_levenshtein_kernel(
        *(torch.as_tensor(x, device=dev) for x in (w_a, w_la, w_b, w_lb)))
    want = levenshtein_numpy(w_a[0, : w_la[0]], w_b[0, : w_lb[0]])
    errs["wavefront"] = max(errs["wavefront"], exact(
        f"B3 wavefront at MAX_KERNEL_LEN (B=1, Ma=Mb={M}, lb=2000) vs the numpy oracle",
        got, torch.as_tensor([want])))
    torch.cuda.synchronize()


def main_path_configs(rng, region):
    """name -> (make_forward_step kwargs, inputs, kernels expected)."""
    from kgl_gene_tpu_torch.entry import example_batch, example_geometry

    e_region, e_exons = example_geometry()
    gene = dict(region_codes=region, exon_intervals=EXONS, region_start=0)
    return {
        "a bench B=256 K=48": (dict(gene), snp_batch(rng, 256, 48, REGION_LEN), "myers"),
        "b population B=4096 K=48": (dict(gene), snp_batch(rng, 4096, 48, REGION_LEN), "myers"),
        "c reverse strand B=4096 K=48": (dict(gene, reverse_strand=True),
                                         snp_batch(rng, 4096, 48, REGION_LEN), "myers"),
        "d wavefront B=256 K=160": (dict(gene), snp_batch(rng, 256, 160, REGION_LEN), "wavefront"),
        "e entry()": (dict(region_codes=e_region, exon_intervals=e_exons, region_start=0),
                      example_batch(8, 6, len(e_region)), "wavefront"),
    }


def phase_main_path(dev, configs):
    """Drive every configuration on the card with the launch counts set to
    0 just before and read just after; then hold each against the plain
    forward on the CPU. Returns the counts of the whole run."""
    import torch

    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.ops.pipeline import make_forward_step

    steps = {name: make_forward_step(**kw, device=dev) for name, (kw, _i, _k) in configs.items()}
    inputs = {name: tuple(torch.as_tensor(x, device=dev) for x in inp)
              for name, (_kw, inp, _k) in configs.items()}
    torch.cuda.synchronize()
    outs, per_config = {}, {}
    kernels.reset_launches()
    before = {}
    for name in configs:
        out = steps[name](*inputs[name])
        torch.cuda.synchronize()
        now = dict(kernels.LAUNCHES)
        per_config[name] = {k: now.get(k, 0) - before.get(k, 0) for k in ("translate", "myers", "wavefront")}
        before = now
        outs[name] = out
    total = dict(kernels.LAUNCHES)

    for name, (kw, inp, dist_kernel) in configs.items():
        counts = per_config[name]
        log(f"  {name}: launches {counts}")
        other = "wavefront" if dist_kernel == "myers" else "myers"
        if counts["translate"] < 1 or counts[dist_kernel] < 1 or counts[other]:
            raise AssertionError(f"{name}: expected translate and {dist_kernel}, got {counts}")
        t0 = time.perf_counter()
        plain = make_forward_step(**kw, device="cpu")(*inp)
        log(f"    plain CPU forward {time.perf_counter() - t0:.1f} s")
        got = outs[name]
        for field in got._fields:
            g, p = getattr(got, field), getattr(plain, field)
            if g.dtype != p.dtype:
                raise AssertionError(f"{name}.{field}: dtype {g.dtype} != {p.dtype}")
            exact(f"{name}.{field}", g, p)
        n_valid = torch.as_tensor(inp[2]).sum(1)
        if bool((got.distance.cpu().to(torch.int64) > n_valid).any()):
            raise AssertionError(f"{name}: a distance exceeds its number of valid SNPs")
        if not bool((got.distance >= 0).all()):
            raise AssertionError(f"{name}: negative distance")
    return total, steps, inputs


def phase_times(dev, steps, inputs, configs, errs):
    import torch

    from kgl_gene_tpu_torch.ops.edit_distance import batched_levenshtein
    from kgl_gene_tpu_torch.ops.myers import myers_distance_padded, myers_kernel_body, myers_plain
    from kgl_gene_tpu_torch.ops.variant_apply import (
        _codon_index, translate_batch, translate_batch_kernel, translate_kernel_body,
    )
    from kgl_gene_tpu_torch.ops.wavefront import batched_levenshtein_kernel
    from kgl_gene_tpu_torch.sequence.tables import amino_translation_table

    for name in ("a bench B=256 K=48", "b population B=4096 K=48"):
        step, inp = steps[name], inputs[name]
        for _ in range(3):
            step(*inp)
        torch.cuda.synchronize()
        per = []
        for _ in range(20):
            t0 = time.perf_counter()
            step(*inp)
            torch.cuda.synchronize()
            per.append(time.perf_counter() - t0)
        med = statistics.median(per)
        B = inp[0].shape[0]
        log(f"  step {name}: median {med * 1e3:.4f} ms over 20, {B / med:.1f} genomes/s")

    # Kernel inputs at the main path's shapes: (a) for B2 and B1, (d) for B3.
    out_a = steps["a bench B=256 K=48"](*inputs["a bench B=256 K=48"])
    coding = out_a.mutated_coding
    region = configs["a bench B=256 K=48"][0]["region_codes"]
    ref = np.concatenate([region[lo:hi] for lo, hi in EXONS]).astype(np.int32)
    ref_t = torch.as_tensor(ref[None, :], device=dev)
    lut = torch.as_tensor(amino_translation_table().amino_lut, device=dev)
    B = coding.shape[0]
    a32 = coding.to(torch.int32)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    coding_d = steps["d wavefront B=256 K=160"](*inputs["d wavefront B=256 K=160"]).mutated_coding
    d32 = coding_d.to(torch.int32)
    lens_d = torch.full((d32.shape[0],), S, dtype=torch.int32, device=dev)
    idx = _codon_index(coding)
    torch.cuda.synchronize()

    # B2 beside lut[idx], at the step's two batch sizes, timed both ways.
    # lut[idx] is the nearest single PyTorch call, not the same function:
    # it reads a ready int64 index (8 bytes a codon) and leaves out the
    # codon indexing that B2 does.
    k = S // 3
    rows = []
    coding_b = steps["b population B=4096 K=48"](*inputs["b population B=4096 K=48"]).mutated_coding
    for cod in (coding, coding_b):
        n = cod.shape[0]
        cod_idx = idx if cod is coding else _codon_index(cod)
        if translate_kernel_body(cod) != "vector":
            raise AssertionError(f"B2 does not take the vector body on the step's ({n}, {S}) coding")
        errs["translate"] = max(errs["translate"], exact(
            f"B2 translate on the step's coding ({n}, {S})",
            translate_batch_kernel(cod, lut), translate_batch(cod, lut)))
        # Copies to rotate over, so that a call finds its input in device
        # memory and not in L2: 64 MB of inputs, or 64 copies.
        copies = min(64, (64 << 20) // cod.numel() + 1)
        cods = [cod.clone() for _ in range(copies)]
        idxs = [cod_idx.clone() for _ in range(min(copies, (64 << 20) // (8 * cod_idx.numel()) + 1))]
        kern_calls = [functools.partial(translate_batch_kernel, c, lut) for c in cods]
        lib_calls = [functools.partial(lut.__getitem__, i) for i in idxs]
        ms, library_ms = time_cuda_turns([kern_calls[0], lib_calls[0]], 200, windows=9)
        t = dict(
            ms=ms,
            device_ms=time_device(kern_calls, 2 * copies),
            device_warm_ms=time_device(kern_calls[:1], 50),
            plain_ms=time_cuda(lambda: translate_batch(cod, lut), 50),
            library_ms=library_ms,
            library_device_ms=time_device(lib_calls, 2 * len(lib_calls)),
            library_device_warm_ms=time_device(lib_calls[:1], 50),
            bound_ms=bound(n * k * 8, n * S + n * k + 65)[0])
        del cods, idxs, kern_calls, lib_calls
        log(f"  B2 translate ({n}, {S}): host-inclusive {t['ms']:.6f} ms; device {t['device_ms']:.6f} ms "
            f"over {copies} rotating inputs, {t['device_warm_ms']:.6f} ms on one input (in L2); bound "
            f"{t['bound_ms']:.6f} ms (bytes), device/bound {t['device_ms'] / t['bound_ms']:.2f}")
        log(f"  lut[idx] ({n}, {S // 3}) int64 index: host-inclusive {t['library_ms']:.6f} ms; device "
            f"{t['library_device_ms']:.6f} ms rotating, {t['library_device_warm_ms']:.6f} ms in L2; "
            f"B2's plain version {t['plain_ms']:.6f} ms")
        if cod is coding:
            rows.append(dict(
                name="translate", route="cuda", source="kgl_gene_tpu_torch/csrc/translate.cu",
                replaces="kgl_gene_tpu/ops/variant_apply.py:95", shape=f"({n}, {S}) uint8",
                bound_by="bytes", **t))

    # B1 with the shared reference at the step's two batch sizes, the
    # group body (the rule's) beside the thread body it replaced there,
    # host-inclusive and on the device alone.
    NB = 3  # band 63
    b32 = coding_b.to(torch.int32)
    for m32 in (a32, b32):
        n = m32.shape[0]
        ln = torch.full((n,), S, dtype=torch.int32, device=dev)
        if myers_kernel_body(n, S, S, 63) != "group":
            raise AssertionError(f"B1 takes the thread body at the step's B={n}")
        call = functools.partial(myers_distance_padded, m32, ln, ref_t, ln, band_k=63)
        old_call = functools.partial(call, _body="thread")
        want = myers_plain(m32, ln, ref_t, ln, 63) if n == B else old_call()
        errs["myers"] = max(errs["myers"], exact(
            f"B1 myers on the step's coding (B={n}, S={S}, k=63) vs "
            f"{'its plain version' if n == B else 'the thread body'}", call(), want))
        m_ms, old_ms = time_cuda_turns([call, old_call], 20)
        md_ms, old_d_ms = time_device([call], 5), time_device([old_call], 5)
        ops = n * S * NB * MYERS_OPS_PER_BLOCK_COLUMN
        b_ms, by = bound(ops, n * S * 4 + S * 4 + 3 * n * 4)
        log(f"  B1 myers shared text B={n} S={S} k=63: group body {m_ms:.6f} ms host-inclusive, "
            f"{md_ms:.6f} ms device; thread body (the earlier design) {old_ms:.6f} ms, "
            f"{old_d_ms:.6f} ms device; bound {b_ms:.6f} ms ({by})")
        if n == B:
            mp_ms = time_cuda(lambda: myers_plain(a32, lens, ref_t, lens, 63), 1, windows=1)
            rows.append(dict(
                name="myers", route="cuda", source="kgl_gene_tpu_torch/csrc/myers.cu",
                replaces="kgl_gene_tpu/ops/pallas_myers.py:74",
                shape=f"B={B} S={S} k=63 shared text", ms=m_ms, device_ms=md_ms,
                thread_body_ms=old_ms, thread_body_device_ms=old_d_ms, plain_ms=mp_ms,
                library_ms=None, bound_ms=b_ms, bound_by=by, int_ops=ops))
        else:
            rows[-1].update(ms_b4096=m_ms, device_ms_b4096=md_ms, thread_body_ms_b4096=old_ms,
                            thread_body_device_ms_b4096=old_d_ms, bound_ms_b4096=b_ms)

    Bd = d32.shape[0]
    w_ms, wp_ms = checked_times(
        f"B3 wavefront (B={Bd}, S={S}, configuration (d)'s mutants vs the shared reference)",
        "wavefront", errs, lambda: batched_levenshtein_kernel(d32, lens_d, ref_t, lens_d),
        lambda: batched_levenshtein(d32, lens_d, ref_t, lens_d), 10)
    wd_ms = time_device([lambda: batched_levenshtein_kernel(d32, lens_d, ref_t, lens_d)], 5)
    # The kernel's work is block steps (64 rows of one column each); the
    # cell count is what the anti-diagonal kernel before it was set against.
    w_ops = Bd * -(-S // 64) * S * MYERS_OPS_PER_BLOCK_COLUMN
    b_ms, by = bound(w_ops, Bd * S * 4 + S * 4 + 3 * Bd * 4)
    cell_ms = Bd * S * S * WAVEFRONT_OPS_PER_CELL / OPS_PER_S * 1e3
    log(f"  B3 wavefront: device {wd_ms:.6f} ms; bound by block steps {b_ms:.6f} ms, "
        f"by cells (the earlier kernel's) {cell_ms:.6f} ms")
    rows.append(dict(
        name="wavefront", route="cuda", source="kgl_gene_tpu_torch/csrc/wavefront.cu",
        replaces="kgl_gene_tpu/ops/pallas_edit_distance.py:36", shape=f"B={Bd} S={S} shared reference",
        ms=w_ms, device_ms=wd_ms, plain_ms=wp_ms, library_ms=None, bound_ms=b_ms, bound_by=by,
        int_ops=w_ops))
    for r in rows:
        log(f"  kernel {r['name']} at {r['shape']}: {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), library {r['library_ms']}")
    return rows


def indel_mutant(rng, ref, n_sub, n_indel):
    """ref with n_sub substitutions and n_indel 1-3 base insertions or
    deletions at random places."""
    s = ref.copy()
    pos = rng.choice(len(s), n_sub, replace=False)
    s[pos] = (s[pos] + 1 + rng.integers(0, 3, n_sub)) % 4
    for _ in range(n_indel):
        p = int(rng.integers(0, len(s)))
        if rng.random() < 0.5:
            s = np.delete(s, slice(p, p + int(rng.integers(1, 4))))
        else:
            s = np.insert(s, p, rng.integers(0, 4, int(rng.integers(1, 4))))
    return s


def pack_pairs(seqs):
    """(B, W) int32 rows and (B,) lengths of a list of code arrays."""
    W = max(max(len(x) for x in seqs), 1)
    out = np.zeros((len(seqs), W), np.int32)
    for i, x in enumerate(seqs):
        out[i, : len(x)] = x
    return out, np.array([len(x) for x in seqs], np.int32)


def banded_case(rng, B):
    """B ragged pairs at S = 3,000: reference prefixes against mutants with
    0-140 substitutions and a few indels, unrelated pairs, la = 0, lb = 0,
    and length gaps of 600 (beyond every band)."""
    ref = rng.integers(0, 4, size=S).astype(np.int32)
    a_rows, b_rows = [], []
    for i in range(B):
        a_rows.append(ref[: S - int(rng.integers(0, 200))])
        b_rows.append(indel_mutant(rng, ref, int(rng.integers(0, 140)), int(rng.integers(0, 6))))
    for i in range(4):  # unrelated
        b_rows[i] = rng.integers(0, 4, size=S - 50 * i).astype(np.int32)
    a_rows[4], b_rows[5] = a_rows[4][:0], b_rows[5][:0]
    a_rows[6], b_rows[6] = a_rows[6][:0], b_rows[6][:0]
    b_rows[7] = b_rows[7][: len(a_rows[7]) - 600]
    a, la = pack_pairs(a_rows)
    b, lb = pack_pairs(b_rows)
    return a, la, b, lb


def local_pair_set(rng, lengths, alphabet=4):
    """Pairs (q-ish row, t-ish row) for the local kernel: each length pair
    (la, lb) gets a row a and a mutant b that carries a near copy of a's
    middle, so the infix distances are small and their minima lie inside
    the rows; the pad of each row past its length repeats the other row's
    start (a minimum taken past lt would read it)."""
    a_rows, b_rows = [], []
    for la, lb in lengths:
        a = rng.integers(0, alphabet, size=la).astype(np.int32)
        b = rng.integers(0, alphabet, size=lb).astype(np.int32)
        n = min(la, lb) // 2
        if n:
            at = int(rng.integers(0, lb - n + 1))
            piece = indel_mutant(rng, a[(la - n) // 2: (la - n) // 2 + n], n // 40, n // 200)
            b[at: at + min(len(piece), lb - at)] = piece[: lb - at]
        a_rows.append(a)
        b_rows.append(b)
    a, la_ = pack_pairs(a_rows)
    b, lb_ = pack_pairs(b_rows)
    for i in range(len(a_rows)):  # pads that copy the other row
        a[i, la_[i]:] = np.resize(b[i], a.shape[1] - la_[i])
        b[i, lb_[i]:] = np.resize(a[i], b.shape[1] - lb_[i])
    return a, la_, b, lb_


def local_kernel_cases(dev, errs):
    """Kernel `local` (csrc/wavefront.cu, kgt_local) against its
    word-level plain version (ops/local.bitvector_local_plain) and the
    cell-level row DP (ops/edit_distance.batched_levenshtein_local) on the
    card: ragged pairs in both orders with codes up to 40, a shared row,
    lq == lt, codes negative and >= 32, pads past lt that copy the query,
    the 64-row block edges, the 2,048-row slot edge, queries of one and
    several 4,096-row stripes up to 5,000 rows, dynamic shared memory
    above 48 KB, and empty widths and batches; every case in the layout the
    rule takes and again in each group layout that holds its widths in one
    stripe. Then a kelch13-sized family's 32,640 pairs of 2,181 bases (the
    rule's group layout) and 2,053 pairs of mixed lengths at that width,
    against both plain versions."""
    import torch

    from kgl_gene_tpu_torch.ops.edit_distance import batched_levenshtein_local
    from kgl_gene_tpu_torch.ops.local import (
        LOCAL_LAYOUTS, batched_levenshtein_local_kernel, bitvector_local_plain, local_layout,
    )

    rng = np.random.default_rng(SEED + 11)

    def held(name, a, la, b, lb, cell=True):
        args = [torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32), device=dev)
                for x in (a, la, b, lb)]
        B, Wp = args[0].shape[0], min(args[0].shape[1], args[2].shape[1])
        want = bitvector_local_plain(*args)
        got = batched_levenshtein_local_kernel(*args)
        rule = local_layout(B, args[0].shape[1], args[2].shape[1])
        errs["local"] = max(errs["local"], exact(
            f"local {name}, layout {rule} (the rule's) vs the word-level plain version", got, want))
        if cell:
            errs["local"] = max(errs["local"], exact(
                f"local {name} vs the cell-level plain version", got,
                batched_levenshtein_local(*args)))
        for G, K in LOCAL_LAYOUTS:
            if G < 32 and G * K * 64 >= Wp and (G, K) != rule:
                errs["local"] = max(errs["local"], exact(
                    f"local {name}, layout {(G, K)} vs the word-level plain version",
                    batched_levenshtein_local_kernel(*args, _layout=(G, K)), want))

    B, Ma, Mb = 64, 300, 330
    a = rng.integers(0, 41, (B, Ma)).astype(np.int32)
    b = rng.integers(0, 41, (B, Mb)).astype(np.int32)
    b[:, 10:250] = a[:, 20:260]
    b[rng.random(b.shape) < 0.1] = 40
    la = rng.integers(0, Ma + 1, B).astype(np.int32)
    lb = rng.integers(0, Mb + 1, B).astype(np.int32)
    la[:9] = (63, 64, 65, 127, 128, 129, 192, 300, 0)
    lb[:9] = (330, 64, 1, 200, 128, 330, 0, 299, 17)
    held("ragged, codes 0..40, la on block edges, lq == lt (B=64, Ma=300, Mb=330)", a, la, b, lb)
    held("the same pairs in the other order (Ma=330, Mb=300)", b, lb, a, la)
    ref = b[:1]
    ref_l = np.full(B, 280, np.int32)
    held("one shared row (1, 330) read with stride 0, B=64", a, la, ref, ref_l)

    pool = np.array([-7, -1, 0, 3, 31, 32, 33, 1000, 2 ** 31 - 1, -(2 ** 31)])
    o_a = rng.choice(pool, (32, 200))
    o_b = rng.choice(pool, (32, 260))
    o_b[:, 30:180] = o_a[:, 25:175]
    o_la = rng.integers(1, 201, 32)
    o_lb = rng.integers(1, 261, 32)
    held("codes negative and >= 32 (B=32, Ma=200, Mb=260)", o_a, o_la, o_b, o_lb)

    # Lengths to 5,000: the slot edge at 2,048 rows (32 blocks, lane 31's
    # first slot), one stripe of 64 blocks at 4,096 rows, two above it;
    # both orders and lq == lt.
    lengths = [(1, 5000), (2047, 2100), (2048, 2048), (2049, 4000), (4095, 4095),
               (4096, 4500), (4097, 4097), (5000, 4990), (4100, 1), (3000, 4999)]
    a, la, b, lb = local_pair_set(rng, lengths)
    held("lengths 1-5,000 (B=10, W=5,000: two slots a lane, stripes of 4,096 rows)", a, la, b, lb)
    held("the same, the other order", b, lb, a, la)
    a, la, b, lb = local_pair_set(rng, [(2048, 5000), (2000, 4800), (64, 5000), (1, 3)])
    held("a narrow pattern width (Ma=2,048: one slot) against a wide text (Mb=5,000)",
         a, la, b, lb)
    held("the same, the other order", b, lb, a, la)
    # Dynamic shared memory above 48 KB: 193 blocks of match words.
    a, la, b, lb = local_pair_set(rng, [(12300, 12290), (12000, 12300)])
    held("M=12,300 (dynamic shared memory above 48 KB, three stripes)", a, la, b, lb)
    # The pad rows ahead of the query (pad = -lq mod 64): queries of 1, 63
    # and 65 rows and multiples of 64, in one stripe and in several (to
    # 12,300 rows), with a tenth of the codes outside 0..31 (match words
    # built on the spot, pad bits included), both orders.
    lengths = [(1, 90), (63, 400), (65, 65), (64, 300), (128, 129), (640, 700), (1984, 2100),
               (4032, 4100), (8192, 8300), (12288, 12300), (12289, 12300), (1, 1)]
    a, la, b, lb = local_pair_set(rng, lengths)
    for x in (a, b):
        odd = rng.random(x.shape) < 0.1
        x[odd] = rng.choice(pool, int(odd.sum()))
    held("pad rows: lq = 1, 63, 65 and multiples of 64 to 12,288, odd codes", a, la, b, lb,
         cell=False)
    held("the same, the other order", b, lb, a, la, cell=False)
    small = la < 700
    held("the queries to 640 rows against the cell-level version too", a[small][:, :700],
         la[small], b[small][:, :700], lb[small])
    for name, rows, wa, wb in (("Ma = 0", 3, 0, 7), ("Mb = 0", 3, 7, 0), ("B = 0", 0, 7, 7)):
        held(name, rng.integers(0, 4, (rows, wa)), np.full(rows, wa), rng.integers(0, 4, (rows, wb)),
             np.full(rows, wb))
    # Warps of mixed lengths at kelch13's width: lengths 0 to 2,181 (empty
    # queries, one-row queries, pairs that end long before their warp's
    # longest), 2,053 pairs (the last warp part full), both orders.
    W = LOCAL_GENE_BASES
    lengths = [(int(x), int(y)) for x, y in rng.integers(0, W + 1, (2053, 2))]
    lengths[:6] = [(0, W), (W, W), (1, W), (W, 0), (W // 7, W // 4), (W, 1)]
    a, la, b, lb = local_pair_set(rng, lengths)
    a, b = np.pad(a, ((0, 0), (0, W - a.shape[1]))), np.pad(b, ((0, 0), (0, W - b.shape[1])))
    held(f"2,053 pairs of mixed lengths at W={W}", a, la, b, lb)
    held("the same, the other order", b, lb, a, la, cell=False)
    # A kelch13-sized family: 256 haplotypes of 2,181 bases, each the gene
    # with 8 SNP slots valid at p = 0.5; its 32,640 pairs gathered on the
    # card, in the rule's layout, against both plain versions (in chunks).
    gene = rng.integers(0, 4, W)
    haps = np.repeat(gene[None, :], 256, 0).astype(np.int32)
    for h in haps:
        at = rng.choice(W, 8, replace=False)[rng.random(8) < 0.5]
        h[at] = (h[at] + rng.integers(1, 4, len(at))) % 4
    pool = torch.as_tensor(haps, device=dev)
    plens = torch.full((256,), W, dtype=torch.int32, device=dev)
    iu, ju = (torch.as_tensor(x, device=dev) for x in np.triu_indices(256, k=1))
    args = (pool.index_select(0, iu), plens.index_select(0, iu), pool.index_select(0, ju),
            plens.index_select(0, ju))
    got = batched_levenshtein_local_kernel(*args)
    rule = local_layout(len(iu), W, W)
    for name, plain in (("word-level", bitvector_local_plain),
                        ("cell-level", batched_levenshtein_local)):
        want = torch.cat([plain(*(x[i:i + LOCAL_PLAIN_CHUNK] for x in args))
                          for i in range(0, len(iu), LOCAL_PLAIN_CHUNK)])
        errs["local_pool"] = max(errs["local_pool"], exact(
            f"local pool (P={len(iu)}, W={W}, layout {rule}) vs the {name} plain version",
            got, want))
    del args, want
    torch.cuda.empty_cache()


def phase_banded_kernels(dev, errs):
    """B5, B4 and B1's per-pair mode at wide bands against their plain
    versions on the card."""
    import torch

    from kgl_gene_tpu_torch.ops.banded import (
        banded_choices, banded_choices_kernel_body, banded_choices_plain, banded_distance,
        banded_kernel_body, banded_plain,
    )
    from kgl_gene_tpu_torch.ops.myers import myers_distance_padded, myers_plain

    rng = np.random.default_rng(SEED + 2)
    a, la, b, lb = (torch.as_tensor(x, device=dev) for x in banded_case(rng, 256))
    B = a.shape[0]
    # B5 in each body a launch can take: the warp body by the rule up to
    # band 255, the block body named at band 127 and by the rule at 511;
    # at B = 256, 255 and 1. The plain version is per pair, so its first n
    # results are those of the first n pairs.
    taken = {}
    for k in (0, 15, 63, 127, 255, 511):
        want = banded_plain(a, la, b, lb, k)
        taken[k] = banded_kernel_body(k)
        runs = [(n, None) for n in (B, B - 1, 1)] + ([(B, "block")] if k == 127 else [])
        for n, body in runs:
            how = f"the rule: {taken[k]}" if body is None else body
            errs["banded"] = max(errs["banded"], exact(
                f"B5 banded k={k} (B={n}, S={S}, ragged, indels, la=0, lb=0, gaps > k), {how} body",
                banded_distance(a[:n], la[:n], b[:n], lb[:n], band_k=k, _body=body), want[:n]))
    log(f"  B5 bodies by band: {taken}")
    if any(body != ("warp" if k <= 255 else "block") for k, body in taken.items()):
        raise AssertionError("B5 does not take the warp body up to band 255 and the block body above")
    # B4 over the whole tensor in each body a launch can take: the warp
    # body up to band 255 (the block body named beside it), the block body
    # at 511. Ragged lengths, indels, la = 0, lb = 0, unrelated pairs and
    # length gaps beyond the band; B = 64 and B = 1.
    a64, la64, b64, lb64 = (x[:64].contiguous() for x in (a, la, b, lb))
    taken = {}
    for k in (31, 127, 511):
        taken[f"k={k}"] = banded_choices_kernel_body(k)
        for n in (64, 1):
            args = (a64[:n], la64[:n], b64[:n], lb64[:n])
            want = banded_choices_plain(*args, k, max(a64.shape[1], 1))
            for body in (None, "block") if taken[f"k={k}"] == "warp" else (None,):
                errs["banded_choices"] = max(errs["banded_choices"], exact(
                    f"B4 banded_choices codes k={k} (B={n}, S={S}, ragged, indels), "
                    f"{body or 'the rule: ' + taken[f'k={k}']} body",
                    banded_choices(*args, band_k=k, _body=body), want))
    log(f"  B4 bodies: {taken}")
    if taken != {"k=31": "warp", "k=127": "warp", "k=511": "block"}:
        raise AssertionError("B4 does not take the warp body at the family's band, "
                             "or the block body at band 511")
    for k in (255, 511):
        errs["myers_pool"] = max(errs["myers_pool"], exact(
            f"B1 myers per-pair text k={k} (B={B}, S={S})",
            myers_distance_padded(a, la, b, lb, band_k=k), myers_plain(a, la, b, lb, k)))
    torch.cuda.synchronize()


class HostDPCounter:
    """Counts the batched traceback's host-DP reroutes: wraps the port's
    legacy.compare_sequences while the block runs."""

    def __enter__(self):
        from kgl_gene_tpu_torch.analysis import legacy

        self.calls = 0
        self._legacy, self._orig = legacy, legacy.compare_sequences

        def counting(*args):
            self.calls += 1
            return self._orig(*args)

        legacy.compare_sequences = counting
        return self

    def __exit__(self, *exc):
        self._legacy.compare_sequences = self._orig


class ResultCapture:
    """Keeps what lib_seqmutation's function `name` returns while the block
    runs (the family analysis' all-pairs matrices)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        from kgl_gene_tpu_torch.analysis import lib_seqmutation

        self.results = []
        self._mod, self._orig = lib_seqmutation, getattr(lib_seqmutation, self.name)

        def capturing(*args, **kwargs):
            self.results.append(self._orig(*args, **kwargs))
            return self.results[-1]

        setattr(lib_seqmutation, self.name, capturing)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self.name, self._orig)


def family_records(out, inputs, region):
    """TranscriptMutateRecords of a forward step's outputs, and the
    reference coding string."""
    from kgl_gene_tpu_torch.analysis.lib_seqmutation import TranscriptMutateRecord
    from kgl_gene_tpu_torch.genome.features import CodingSequenceValidity as V
    from kgl_gene_tpu_torch.sequence.alphabet import DNA5

    by_code = (V.VALID_PROTEIN, V.NO_STOP_CODON, V.NONSENSE_MUTATION, V.NO_START_CODON)
    coding = out.mutated_coding.cpu().numpy()
    validity = out.validity_code.cpu().numpy()
    n_var = np.asarray(inputs[2]).sum(1)
    recs = [TranscriptMutateRecord(f"g{i:04d}", "GENE1", "GENE1.1", int(n_var[i]),
                                   DNA5.to_string(coding[i]), by_code[int(validity[i])])
            for i in range(coding.shape[0])]
    ref = np.concatenate([region[lo:hi] for lo, hi in EXONS])
    return recs, DNA5.to_string(ref)


def config_a_records(dev):
    """Phase 3b's records and reference: configuration (a)'s forward step on
    the card, from the same seed as main(); for running phase 3g alone."""
    import torch

    from kgl_gene_tpu_torch.ops.pipeline import make_forward_step

    rng = np.random.default_rng(SEED)
    region = gene_region(rng)
    kw, inp, _kernel = main_path_configs(rng, region)["a bench B=256 K=48"]
    out = make_forward_step(**kw, device=dev)(*(torch.as_tensor(x, device=dev) for x in inp))
    return family_records(out, inp, region)


def walk_steps(ref_len, lens, k):
    """The tape length reference_cigars gives the walk
    (ops/traceback.banded_traceback_ops)."""
    M = max(ref_len, int(lens.max()), 1)
    return int(min(ref_len + int(lens.max()), 2 * k + 1 + (M + 252) // 253 + 8))


def family_walk_case(dev, k=127):
    """Phase 4's walk inputs, for timing the walk alone
    (scripts/torch_kernel_bodies.py): (choices, rl, plens, k, steps), where
    choices() runs B4 over phase 3b's distinct mutants against their
    reference and returns fresh codes."""
    import torch

    from kgl_gene_tpu_torch.analysis.lib_seqmutation import TranscriptFamilyAnalysis
    from kgl_gene_tpu_torch.ops.banded import banded_choices
    from kgl_gene_tpu_torch.sequence.alphabet import DNA5

    records, ref = config_a_records(dev)
    fam = TranscriptFamilyAnalysis(records, ref, device=dev)
    seqs, lens = fam._padded_codes(list(fam.distinct_sequences()))
    n = seqs.shape[0]
    pool = torch.as_tensor(seqs.astype(np.int32), device=dev)
    plens = torch.as_tensor(lens, device=dev)
    ref_t = torch.as_tensor(np.tile(DNA5.from_string(ref).astype(np.int32), (n, 1)), device=dev)
    rl = torch.full((n,), len(ref), dtype=torch.int32, device=dev)
    choices = functools.partial(banded_choices, ref_t, rl, pool, plens, band_k=k)
    return choices, rl, plens, k, walk_steps(len(ref), lens, k)


def cigar_lengths(cigar):
    import re

    runs = re.findall(r"(\d+)([MXDI])", cigar)
    return (sum(int(n) for n, op in runs if op in "MXD"),
            sum(int(n) for n, op in runs if op in "MXI"))


def same(name, got, want):
    if got != want:
        raise AssertionError(f"{name}: the card's result differs from the CPU's")
    log(f"  {name}: equal to the CPU run")


def phase_family(dev, records, ref, workdir):
    """The transcript-family path on the card, counts from 0, then every
    result against the same analysis on the CPU. Returns the launch counts
    of the path, the all-pairs inputs and the CPU matrix."""
    import torch

    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.analysis.lib_seqmutation import TranscriptFamilyAnalysis
    from kgl_gene_tpu_torch.classify.upgma import newick, upgma_tree
    from kgl_gene_tpu_torch.ops.edit_distance import (
        levenshtein_local_numpy, levenshtein_numpy, pairwise_distance_matrix,
    )

    fam = TranscriptFamilyAnalysis(records, ref, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with HostDPCounter() as host_dp, ResultCapture("pairwise_distance_matrix") as captured:
        dist = fam.reference_distances()
        tree = fam.distance_tree_newick()
        cigars = fam.reference_cigars()
        fam.write_report(f"{workdir}/family_card.csv", cigars=True)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    log(f"  family path launches: {counts}; host-DP reroutes {host_dp.calls}")
    expected = ("myers", "wavefront", "banded_choices", "walk")
    if any(counts.get(name, 0) < 1 for name in expected) or any(
            n for name, n in counts.items() if name not in expected):
        raise AssertionError(f"expected launches of {expected} only on the family path, got {counts}")
    if len(captured.results) != 1:
        raise AssertionError(f"expected one all-pairs matrix, got {len(captured.results)}")
    if host_dp.calls:
        raise AssertionError(f"{host_dp.calls} pairs took the host DP; distances are <= 96 < 127")

    distinct = list(fam.distinct_sequences())
    log(f"  {len(records)} records, {len(distinct)} distinct mutants, "
        f"{len(distinct) * (len(distinct) - 1) // 2} pairs")
    seqs, lens = fam._padded_codes(distinct)
    ref_codes = fam._padded_codes([ref])[0][0]
    for i in range(3):  # the numpy oracle on a few entries
        if dist[distinct[i]] != levenshtein_numpy(seqs[i][: lens[i]], ref_codes):
            raise AssertionError("reference distance differs from the numpy oracle")
    for c in cigars.values():
        if cigar_lengths(c) != (S, S):
            raise AssertionError(f"CIGAR {c[:40]}... does not span both sequences")

    cpu = TranscriptFamilyAnalysis(records, ref, device="cpu")
    t0 = time.perf_counter()
    dist_cpu = cpu.reference_distances()
    same("reference_distances (global, B3)", dist, dist_cpu)
    cig_cpu = cpu.reference_cigars()
    same("reference_cigars (B4 + the walk kernel)", cigars, cig_cpu)
    cpu.write_report(f"{workdir}/family_cpu.csv", distances=dist_cpu, cigars=True)
    with open(f"{workdir}/family_card.csv", "rb") as f1, open(f"{workdir}/family_cpu.csv", "rb") as f2:
        same("write_report(cigars=True) bytes", f1.read(), f2.read())
    # The CPU's own tree route (the exact wavefront over 32,640 pairs of
    # 3 kb) would take hours there; the CPU reference takes the plain
    # Myers pool at band 127 with its exact re-run, another exact route.
    matrix = pairwise_distance_matrix(seqs, lens, band_k=127, device="cpu")
    exact("the tree's all-pairs matrix (B1 pool k=127 + re-run) vs the CPU's, every entry",
          torch.as_tensor(captured.results[0]), torch.as_tensor(matrix))
    labels = [g[0] if len(g) == 1 else f"{g[0]}+{len(g) - 1}" for g in fam.distinct_sequences().values()]
    same("distance_tree_newick (B1 pool, UPGMA)", tree, newick(upgma_tree(matrix, labels)))
    if matrix[0, 1] != levenshtein_numpy(seqs[0][: lens[0]], seqs[1][: lens[1]]):
        raise AssertionError("all-pairs entry differs from the numpy oracle")
    log(f"    CPU reference runs {time.perf_counter() - t0:.1f} s")

    n = FAMILY_LOCAL_RECORDS
    loc = TranscriptFamilyAnalysis(records[:n], ref, metric="local", device=dev)
    loc_cpu = TranscriptFamilyAnalysis(records[:n], ref, metric="local", device="cpu")
    loc_dist = loc.reference_distances()
    same(f"local reference_distances ({n} records)", loc_dist, loc_cpu.reference_distances())
    same(f"local distance_tree_newick ({n} records)", loc.distance_tree_newick(),
         loc_cpu.distance_tree_newick())
    if loc_dist[distinct[0]] != levenshtein_local_numpy(seqs[0][: lens[0]], ref_codes):
        raise AssertionError("local distance differs from the numpy oracle")
    return counts, seqs, lens, matrix


def phase_band_doubling(dev, seqs, lens, matrix):
    """adaptive_banded_levenshtein (kernel B5) over the all-pairs pairs,
    counts from 0: from band 31 it must double until the widest pair
    distance fits (the family's mutants differ by well under 127), each
    band one launch, and equal the matrix."""
    import torch

    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.ops.banded import adaptive_banded_levenshtein

    start_k = 31
    iu, ju = np.triu_indices(seqs.shape[0], k=1)
    widest = int(max(matrix.max(), np.abs(lens[iu] - lens[ju]).max()))
    bands = [start_k]
    while bands[-1] < widest:
        bands.append(2 * bands[-1] + 1)
    torch.cuda.synchronize()
    kernels.reset_launches()
    d = adaptive_banded_levenshtein(seqs[iu], lens[iu], seqs[ju], lens[ju], start_k=start_k,
                                    device=dev)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    log(f"  band doubling over {len(iu)} pairs from band {start_k}: launches {counts}, widest "
        f"distance {widest}, {int((d > start_k).sum())} pairs beyond band {start_k}")
    if len(bands) < 2 or counts.get("banded", 0) != len(bands) or counts.get("wavefront", 0):
        raise AssertionError(f"expected B5 at bands {bands} only, got {counts}")
    exact("adaptive_banded_levenshtein vs the all-pairs matrix",
          torch.as_tensor(d), torch.as_tensor(matrix[iu, ju].astype(np.int64)))
    return counts


def phase_wide_cigars(dev, errs):
    """batched_cigar at band 31 on pairs with 3-150 substitutions plus
    indels and one unrelated pair, on the card and on the CPU."""
    from kgl_gene_tpu_torch import int32_on, kernels
    from kgl_gene_tpu_torch.ops.banded import banded_choices
    from kgl_gene_tpu_torch.ops.traceback import batched_cigar, tb_walk, tb_walk_plain

    rng = np.random.default_rng(SEED + 3)
    ref = rng.integers(0, 4, size=S).astype(np.int32)
    muts = [indel_mutant(rng, ref, n, 4) for n in (3, 10, 20, 31, 40, 63, 80, 100, 127, 150, 5)]
    muts.append(rng.integers(0, 4, size=S).astype(np.int32))  # beyond band 511
    b, lb = pack_pairs(muts)
    a = np.tile(ref, (len(muts), 1))
    la = np.full(len(muts), S, np.int32)
    # The walk kernel against its plain version on these pairs' codes, at
    # the first band and the widest, paths that leave the band included.
    for k in (31, 511):
        t = int32_on(dev, a, la, b, lb)
        codes = banded_choices(*t, band_k=k)
        steps = 2 * k + 1 + (S + 252) // 253 + 8
        got = tb_walk(codes, t[1], t[3], band_k=k, max_steps=steps)
        want = tb_walk_plain(codes, t[1], t[3], band_k=k, max_steps=steps)
        errs["walk"] = max(errs["walk"],
                           exact(f"walk ops, wide edits k={k} ({len(muts)} pairs, {steps} steps)",
                                 got[0], want[0]),
                           exact(f"walk counts, wide edits k={k}", got[1], want[1]))
        del codes
    kernels.reset_launches()
    runs = {}
    for where in (dev, "cpu"):
        with HostDPCounter() as host_dp:
            runs[str(where)] = (batched_cigar(a, la, b, lb, band_k=31, device=where), host_dp.calls)
    log(f"  batched_cigar launches: {dict(kernels.LAUNCHES)}")
    if kernels.LAUNCHES["walk"] != kernels.LAUNCHES["banded_choices"] or not kernels.LAUNCHES["walk"]:
        raise AssertionError("batched_cigar: every B4 launch is followed by one walk launch")
    got, want = runs[str(dev)], runs["cpu"]
    log(f"  batched_cigar band 31, {len(muts)} pairs: host-DP reroutes card {got[1]}, CPU {want[1]}")
    same("batched_cigar (3-150 substitutions + indels) and its reroute count", got, want)
    if got[1] != 1:
        raise AssertionError("expected exactly the unrelated pair on the host DP")
    for c, m in zip(got[0], muts):
        if cigar_lengths(c) != (S, len(m)):
            raise AssertionError("a CIGAR does not span both sequences")


def load_latency_ns(dev, windows=3):
    """{"l1_ns", "l2_ns", "dram_ns"}: the ns of one dependent load, a hop
    of kernel kgt_chase (csrc/chase.cu): one thread from word 0 around a
    cycle of 128-byte lines, CHASE_L1_BYTES in random order with loads
    that cache in the L1, CHASE_L2_BYTES in random order with loads that
    skip it (.cg), and CHASE_DRAM_BYTES with .cg loads for the hop to
    device memory. The median over `windows` of the difference between
    2 * h and h hops, over h, so the launch drops out.

    The device-memory cycle is built anew on the card before each timed
    run, so no run finds the lines of the one before in the L2, and it
    visits the lines of one 2 MB page in random order before it moves to
    another page (pages in random order): the hop then prices a line's
    trip to device memory, not a miss of the address translation, as a
    walk's pair stays in its own 765 KB of codes."""
    import torch

    from kgl_gene_tpu_torch import kernels

    rng = np.random.default_rng(SEED)
    out = torch.zeros(1, dtype=torch.int32, device=dev)

    def random_cycle(words):
        lines = torch.as_tensor(np.r_[0, rng.permutation(np.arange(1, words // 32))] * 32,
                                device=dev)
        nxt = torch.zeros(words, dtype=torch.int32, device=dev)
        nxt[lines] = lines.roll(-1).to(torch.int32)
        return nxt

    page_lines = (2 << 20) // 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    dram = torch.zeros(CHASE_DRAM_BYTES // 4, dtype=torch.int32, device=dev)

    def page_cycle(_words):
        pages = CHASE_DRAM_BYTES // (2 << 20)
        local = torch.rand((pages, page_lines), generator=gen, device=dev).argsort(1)
        order = torch.randperm(pages, generator=gen, device=dev)
        lines = (order[:, None] * page_lines + local[order]).flatten()
        lines = lines.roll(-int((lines == 0).nonzero()[0])) * 32  # start at word 0
        dram[lines] = lines.roll(-1).to(torch.int32)
        return dram

    got = {}
    for key, nbytes, l2_only, hops, build, fresh in (
            ("l1_ns", CHASE_L1_BYTES, 0, CHASE_HOPS, random_cycle, False),
            ("l2_ns", CHASE_L2_BYTES, 1, CHASE_HOPS, random_cycle, False),
            ("dram_ns", CHASE_DRAM_BYTES, 1, CHASE_DRAM_HOPS, page_cycle, True)):
        nxt_t = build(nbytes // 4)

        def chase(h):
            kernels.launch("chase", "kgt_chase", nxt_t.device, nxt_t.data_ptr(), h, l2_only,
                           out.data_ptr())

        chase(2 * hops)
        torch.cuda.synchronize()
        per = []
        for _ in range(windows):
            ms = []
            for h in (hops, 2 * hops):
                if fresh:
                    nxt_t = build(nbytes // 4)
                    torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                chase(h)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            per.append((ms[1] - ms[0]) / hops * 1e6)
        got[key] = statistics.median(per)
        del nxt_t
    del dram
    return got


def time_after(prep, fns, reps):
    """For each fn of `fns` the median ms on the card of fn(prep()) over
    `reps` calls, CUDA events around the fn alone, each call right after a
    fresh prep() (the fns take turns), so fn finds the card as prep left
    it: its L2 holding the end of what prep wrote."""
    import torch

    marks = [[] for _ in fns]
    for _ in range(reps):
        for fn, mine in zip(fns, marks):
            arg = prep()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(arg)
            end.record()
            mine.append((start, end))
            del arg
    torch.cuda.synchronize()
    return [statistics.median(s.elapsed_time(e) for s, e in mine) for mine in marks]


def walk_latency_bounds(codes, la, lb, band_k, ops, counts, steps, lat):
    """(warm_ms, cold_ms, pair, new, live) of the walk's latency bound:
    each pair's live steps priced as dependent loads (walk_new_lines), the
    longest pair's sum, as pairs run side by side. Warm (the codes already
    in the L2, as back-to-back walks find them): a step to a line new to
    its warp pays the L2 hit latency, any other the L1's. Cold (right
    after B4 wrote them, as reference_cigars runs the walk): a new line
    that lies outside the last L2_BYTES B4 wrote (B4 writes every pair's
    rows in order, so the rows at or above M - L2_BYTES / (B * W)) pays
    the device-memory hop instead. The trips after a pair's end store its
    two tape entries, at one instruction a cycle, in both."""
    M, B, W = codes.shape
    new, live, new_dram = walk_new_lines(codes, la, lb, band_k, ops, counts,
                                         cached_rows=L2_BYTES // (B * W))
    tail_ms = (steps - live) * WALK_STORES_PER_TRIP / sm_max_clock_hz() * 1e3
    warm = (new * lat["l2_ns"] + (live - new) * lat["l1_ns"]) * 1e-6 + tail_ms
    cold = warm + new_dram * (lat["dram_ns"] - lat["l2_ns"]) * 1e-6
    pair = int(warm.argmax())
    return float(warm.max()), float(cold.max()), pair, new, live


def walk_new_lines(codes, la, lb, band_k, ops, counts, cached_rows=None):
    """(new, live): for each pair of a walk (csrc/walk.cu's arithmetic,
    replayed from its tapes), its live steps, and those whose code byte
    lies on a 128-byte line that no pair of its warp (32 pairs) read at an
    earlier step, as numpy arrays. With `cached_rows`, also the count of
    those new lines on a row below the last `cached_rows` rows:
    (new, live, new_below)."""
    M, B, W = codes.shape
    rs, ps = codes.stride(0), codes.stride(1)
    ops, counts = ops.cpu().numpy(), counts.cpu().numpy()
    i = np.maximum(la.cpu().numpy().astype(np.int64), 0)
    j = np.maximum(lb.cpu().numpy().astype(np.int64), 0)
    pair = np.arange(B)
    keys, steps, rows = [], [], []
    for s in range(ops.shape[1]):
        live = ops[:, s] != 0
        c = np.clip(j - i + band_k, 0, W - 1)
        row = np.clip(i - 1, 0, M - 1)
        line = (codes.data_ptr() + row * rs + pair * ps + c) // 128
        keys.append(np.where(live, (pair // 32) * (1 << 48) + line, -1))
        steps.append(np.full(B, s))
        rows.append(row)
        cnt = counts[:, s].astype(np.int64)
        i = i - np.where(live & (ops[:, s] != 4), cnt, 0)  # every op but left moves up
        j = j - np.where(live & (ops[:, s] != 3), cnt, 0)  # every op but up moves left
    if ((i != 0) | (j != 0))[ops[:, -1] == 0].any():
        raise AssertionError("the replay of the walk's tapes ends away from (0, 0)")
    keys, steps = np.stack(keys, 1), np.stack(steps, 1)
    live = keys >= 0
    _uniq, inv = np.unique(keys[live], return_inverse=True)
    first = np.full(len(_uniq), ops.shape[1])
    np.minimum.at(first, inv, steps[live])
    new = np.zeros_like(live)
    new[live] = first[inv] == steps[live]
    if cached_rows is None:
        return new.sum(1), live.sum(1)
    below = new & (np.stack(rows, 1) < M - cached_rows)
    return new.sum(1), live.sum(1), below.sum(1)


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the operation and byte floors."""
    t_ops, t_bytes = ops / OPS_PER_S, nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def wall(fn, reps=3):
    """Median host seconds of fn() over reps calls (each ends on the host)."""
    per = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        per.append(time.perf_counter() - t0)
    return statistics.median(per)


def checked_times(name, key, errs, kern, plain, iters):
    """Holds kern() against plain() (exact), then (kernel ms, plain ms):
    the plain version's first call gives the compared output and warms it,
    a second call is timed."""
    want = plain()
    errs[key] = max(errs[key], exact(name, kern(), want))
    del want
    ms = time_cuda(kern, iters, windows=3)
    return ms, time_cuda(plain, 1, windows=1, warm=False)


def phase_family_times(dev, records, ref, seqs, lens, matrix, errs):
    """Times of the family path's kernels at its shapes, each first held
    against its plain version there, of tb_walk, and the path's wall
    times."""
    import torch

    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.analysis.lib_seqmutation import TranscriptFamilyAnalysis
    from kgl_gene_tpu_torch.ops.banded import (
        banded_choices, banded_choices_plain, banded_distance, banded_kernel_body, banded_plain,
    )
    from kgl_gene_tpu_torch.ops.edit_distance import pairwise_distance_matrix
    from kgl_gene_tpu_torch.ops.myers import (
        myers_distance_padded, myers_kernel_body, myers_layout, myers_plain,
    )
    from kgl_gene_tpu_torch.ops.traceback import tb_walk, tb_walk_plain
    from kgl_gene_tpu_torch.ops.wavefront import batched_levenshtein_kernel
    from kgl_gene_tpu_torch.sequence.alphabet import DNA5

    iu, ju = np.triu_indices(seqs.shape[0], k=1)
    P = len(iu)
    pool = torch.as_tensor(seqs.astype(np.int32), device=dev)
    plens = torch.as_tensor(lens, device=dev)
    iu_t, ju_t = torch.as_tensor(iu, device=dev), torch.as_tensor(ju, device=dev)
    pa, pb = pool.index_select(0, iu_t), pool.index_select(0, ju_t)
    pla, plb = plens.index_select(0, iu_t), plens.index_select(0, ju_t)
    sum_la = int(lens[iu].astype(np.int64).sum())
    sum_lb = int(lens[ju].astype(np.int64).sum())
    in_bytes = 2 * pa.numel() * 4 + 3 * P * 4
    rows = []

    k = 127
    banded = functools.partial(banded_distance, pa, pla, pb, plb, band_k=k)
    old_banded = functools.partial(banded, _body="block")
    body = banded_kernel_body(k)
    plain = functools.partial(banded_plain, pa, pla, pb, plb, k)
    want = plain()
    for name, fn in ((f"the rule: {body}", banded), ("block", old_banded)):
        errs["banded"] = max(errs["banded"], exact(
            f"B5 banded k={k} (P={P} all pairs, S={S}), {name} body", fn(), want))
    del want
    p_ms = time_cuda(plain, 1, windows=1, warm=False)
    ms, old_ms = time_cuda_turns([banded, old_banded], 2, windows=3)
    d_ms, old_d_ms = time_device([banded], 2), time_device([old_banded], 2)
    ops = BANDED_OPS_PER_CELL * sum_la * (2 * k + 1)
    b_ms, by = bound(ops, in_bytes)
    log(f"  B5 banded: {body} body (the rule's) {ms:.6f} ms host-inclusive, {d_ms:.6f} ms device; "
        f"block body (the earlier design) {old_ms:.6f} ms, {old_d_ms:.6f} ms device")
    rows.append(dict(name="banded", source="kgl_gene_tpu_torch/csrc/banded.cu",
                     replaces="kgl_gene_tpu/ops/pallas_banded.py:76",
                     shape=f"P={P} all pairs, S={S}, k={k}, {body} body", ms=ms, device_ms=d_ms,
                     block_body_ms=old_ms, block_body_device_ms=old_d_ms, plain_ms=p_ms,
                     bound_ms=b_ms, bound_by=by, int_ops=ops))

    NB = myers_layout(k)[1]
    pool_body = myers_kernel_body(P, S, S, k)
    ms, p_ms = checked_times(
        f"B1 myers pool per-pair text k={k}, NB={NB}, {pool_body} body (P={P} all pairs, S={S})",
        "myers_pool", errs, lambda: myers_distance_padded(pa, pla, pb, plb, band_k=k),
        lambda: myers_plain(pa, pla, pb, plb, k), 2)
    ops = MYERS_OPS_PER_BLOCK_COLUMN * NB * sum_lb
    b_ms, by = bound(ops, in_bytes)
    other = "thread" if pool_body == "group" else "group"
    errs["myers_pool"] = max(errs["myers_pool"], exact(
        f"B1 myers pool, the {other} body vs the {pool_body} body",
        myers_distance_padded(pa, pla, pb, plb, band_k=k, _body=other),
        myers_distance_padded(pa, pla, pb, plb, band_k=k)))
    ms, other_ms = time_cuda_turns(
        [lambda: myers_distance_padded(pa, pla, pb, plb, band_k=k),
         lambda: myers_distance_padded(pa, pla, pb, plb, band_k=k, _body=other)], 3)
    log(f"  B1 myers pool: {pool_body} body (the rule's) {ms:.6f} ms, {other} body {other_ms:.6f} ms")
    rows.append(dict(name="myers_pool", source="kgl_gene_tpu_torch/csrc/myers.cu",
                     replaces="kgl_gene_tpu/ops/pallas_myers.py:74",
                     shape=f"P={P} all pairs, S={S}, k={k}, per-pair text, {pool_body} body", ms=ms,
                     **{f"{other}_body_ms": other_ms}, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                     int_ops=ops))

    # B3 over the same pairs: the all-pairs route when no band is given.
    # Held against the matrix the family phase holds exact, not the
    # cell-level plain version, which would take minutes at this size.
    want = torch.as_tensor(matrix[iu, ju].astype(np.int64))
    errs["wavefront"] = max(errs["wavefront"], exact(
        f"B3 wavefront (P={P} all pairs, S={S}) vs the family's all-pairs matrix",
        batched_levenshtein_kernel(pa, pla, pb, plb), want))
    ms = time_cuda(lambda: batched_levenshtein_kernel(pa, pla, pb, plb), 3, windows=3)
    steps_sum = int((-(-lens[iu].astype(np.int64) // 64) * lens[ju].astype(np.int64)).sum())
    b_ms, by = bound(MYERS_OPS_PER_BLOCK_COLUMN * steps_sum, in_bytes)
    log(f"  B3 wavefront at P={P} all pairs, S={S}: {ms:.6f} ms, bound {b_ms:.6f} ms ({by}), "
        f"{ms / b_ms:.1f}x")
    if b_ms > ms:
        raise AssertionError("B3's bound reads above its time")
    del pa, pb
    kernels.reset_launches()
    exact_matrix = pairwise_distance_matrix(seqs, lens, band_k=None, device=dev)
    if dict(kernels.LAUNCHES) != {"wavefront": 1}:
        raise AssertionError(f"band_k=None route: expected one B3 launch, got {dict(kernels.LAUNCHES)}")
    exact("pairwise_distance_matrix(band_k=None) (B3 route) vs the family's matrix, every entry",
          torch.as_tensor(exact_matrix), torch.as_tensor(matrix))
    t_exact = wall(lambda: pairwise_distance_matrix(seqs, lens, band_k=None, device=dev))
    log(f"  all-pairs matrix (no band, B3): {t_exact * 1e3:.3f} ms for {P} pairs, "
        f"{P / t_exact:.1f} pairs/s")

    n = seqs.shape[0]
    ref_t = torch.as_tensor(np.tile(DNA5.from_string(ref).astype(np.int32), (n, 1)), device=dev)
    rl = torch.full((n,), len(ref), dtype=torch.int32, device=dev)
    ms, p_ms = checked_times(
        f"B4 banded_choices codes k={k} (B={n}, S={S}, the family's reference vs mutants)",
        "banded_choices", errs, lambda: banded_choices(ref_t, rl, pool, plens, band_k=k),
        lambda: banded_choices_plain(ref_t, rl, pool, plens, k, ref_t.shape[1]), 5)
    choices = functools.partial(banded_choices, ref_t, rl, pool, plens, band_k=k)
    old_choices = functools.partial(choices, _body="block")
    old_ms = time_cuda(old_choices, 5, windows=3)
    d_ms, old_d_ms = time_device([choices], 3), time_device([old_choices], 3)
    codes = choices()
    code_bytes = codes.numel()
    ops = BANDED_CHOICES_OPS_PER_CELL * len(ref) * n * (2 * k + 1)
    b_ms, by = bound(ops, code_bytes + 2 * n * S * 4 + 2 * n * 4)
    log(f"  B4 banded_choices: warp body {ms:.6f} ms host-inclusive, {d_ms:.6f} ms device; block "
        f"body (the earlier design) {old_ms:.6f} ms, {old_d_ms:.6f} ms device")
    rows.append(dict(name="banded_choices", source="kgl_gene_tpu_torch/csrc/banded.cu",
                     replaces="kgl_gene_tpu/ops/pallas_banded.py:185",
                     shape=f"B={n}, S={S}, k={k}, (M, B, 2k+1) uint8 codes", ms=ms, device_ms=d_ms,
                     block_body_ms=old_ms, block_body_device_ms=old_d_ms,
                     plain_ms=p_ms, bound_ms=b_ms, bound_by=by, int_ops=ops))

    # The walk over those codes, at the tape length reference_cigars gives
    # it. Its work depends on the data: the bound counts one 32-byte sector
    # read for each live step of each pair and the tapes written once.
    steps = walk_steps(len(ref), lens, k)
    walk = functools.partial(tb_walk, codes, rl, plens, band_k=k, max_steps=steps)
    walk_plain = functools.partial(tb_walk_plain, codes, rl, plens, band_k=k, max_steps=steps)
    got, want = walk(), walk_plain()
    errs["walk"] = max(errs["walk"],
                       exact(f"walk ops (B={n}, k={k}, {steps} steps, the family's codes)",
                             got[0], want[0]),
                       exact("walk counts, the same", got[1], want[1]))
    live = int((got[0] != 0).sum())
    ms = time_cuda(walk, 20, windows=3)
    d_ms = time_device([walk], 10)
    p_ms = time_cuda(walk_plain, 1, windows=3, warm=False)
    # As reference_cigars runs it: each walk right after a fresh B4 over
    # the same inputs, which leaves the L2 holding the last rows B4 wrote.
    cold_ms, = time_after(choices, [lambda c: tb_walk(c, rl, plens, band_k=k, max_steps=steps)],
                          WALK_COLD_REPS)
    b_ms, by = bound(20 * live, 32 * live + n * steps * 5 + 2 * n * 4)
    # Its latency bounds, from the card's load latencies (load_latency_ns):
    # each live step's byte is a load whose address the step before
    # computed (walk_latency_bounds).
    lat = load_latency_ns(dev)
    latency_ms, cold_latency_ms, worst, new_lines, live_p = walk_latency_bounds(
        codes, rl, plens, k, got[0], got[1], steps, lat)
    one = functools.partial(tb_walk, codes[:, worst:worst + 1], rl[worst:worst + 1],
                            plens[worst:worst + 1], band_k=k, max_steps=steps)
    exact("walk of the bound's pair alone, the same tapes", one()[0], got[0][worst:worst + 1])
    log(f"  walk kernel B={n}, k={k}, {steps} steps, {live} live steps ({live / n:.1f} a pair): "
        f"{ms:.6f} ms host-inclusive, {d_ms:.6f} ms device, {cold_ms:.6f} ms right after B4; "
        f"plain PyTorch loop {p_ms:.6f} ms; load latency L1 "
        f"{lat['l1_ns']:.2f} ns, L2 {lat['l2_ns']:.2f} ns, device memory {lat['dram_ns']:.2f} ns "
        f"(pointer chase); latency bound {latency_ms:.6f} ms warm ({latency_ms / d_ms:.1%} of the "
        f"device time), {cold_latency_ms:.6f} ms right after B4 ({cold_latency_ms / cold_ms:.1%});"
        f" pair {worst}: {int(live_p[worst])} live steps, {int(new_lines[worst])} of them to a "
        f"new line")
    rows.append(dict(name="walk", source="kgl_gene_tpu_torch/csrc/walk.cu",
                     replaces="kgl_gene_tpu/ops/traceback.py:45",
                     shape=f"B={n}, k={k}, {steps} steps, {live} live", ms=ms, device_ms=d_ms,
                     cold_ms=cold_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by, int_ops=20 * live,
                     latency_bound_ms=latency_ms, cold_latency_bound_ms=cold_latency_ms,
                     l1_latency_ns=lat["l1_ns"], l2_latency_ns=lat["l2_ns"],
                     dram_latency_ns=lat["dram_ns"],
                     latency_pair_live_steps=int(live_p[worst]),
                     latency_pair_new_lines=int(new_lines[worst])))
    del codes, got, want

    fam = TranscriptFamilyAnalysis(records, ref, device=dev)
    t_cig = wall(fam.reference_cigars)
    t_tree = wall(fam.distance_tree_newick)
    t_dist = wall(fam.reference_distances)
    t_mat = wall(lambda: pairwise_distance_matrix(seqs, lens, band_k=127, device=dev))
    log(f"  family wall: reference_cigars {t_cig * 1e3:.3f} ms, distance_tree_newick "
        f"{t_tree * 1e3:.3f} ms, reference_distances {t_dist * 1e3:.3f} ms (median of 3)")
    log(f"  all-pairs matrix (band 127): {t_mat * 1e3:.3f} ms for {P} pairs, "
        f"{P / t_mat:.1f} pairs/s")
    for r in rows:
        r.update(route="cuda", library_ms=None)
        log(f"  kernel {r['name']} at {r['shape']}: {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), library none")
    return rows



class IngestInterrupted(Exception):
    """Raised by interrupted_parser's parser."""


def interrupted_parser(after):
    """A PfDiploidParser that raises once it has taken `after` records."""
    from kgl_gene_tpu_torch.io.vcf import PfDiploidParser

    class Interrupted(PfDiploidParser):
        def parse(self, header, records):
            def cut():
                for i, rec in enumerate(records):
                    if i == after:
                        raise IngestInterrupted(f"ingest interrupted after {after} records")
                    yield rec
            return super().parse(header, cut())

    return Interrupted


def phase_checkpoint_local(dev, workdir, records, ref, errs):
    """Phase 3g: the checkpointed ingest of phase 3c's VCF, interrupted and
    resumed, against the uninterrupted native ingest (population, INFO,
    PassFilter / SNPFilter views, PloidyAnalysis); then the local metric
    (TranscriptFamilyAnalysis(metric="local")) over phase 3b's 256 mutants
    on the card, counts from 0: only kernel `local` may launch; its all-pairs
    matrix against the cell-level plain version on the card (every pair,
    or the pairs LOCAL_PLAIN_LIMIT_S allows), a few entries against the
    numpy DP, and batched_metric's local and global metrics over the same
    pairs against the matrix and B3. Returns the phase's figures, the
    launches of the local path and what phase 4 needs."""
    import torch

    import kgl_gene_tpu_torch.io.vcf as tvcf
    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.analysis.legacy import PloidyAnalysis
    from kgl_gene_tpu_torch.analysis.lib_seqmutation import TranscriptFamilyAnalysis
    from kgl_gene_tpu_torch.classify import distance as metrics
    from kgl_gene_tpu_torch.classify.upgma import newick, upgma_tree
    from kgl_gene_tpu_torch.io.synthetic import generate_population_files
    from kgl_gene_tpu_torch.ops.edit_distance import (
        batched_levenshtein_local, levenshtein_local_numpy,
    )
    from kgl_gene_tpu_torch.ops.wavefront import batched_levenshtein_kernel
    from kgl_gene_tpu_torch.variant import filter as vfilter
    from kgl_gene_tpu_torch.variant.columnar import VariantMajorView

    out = {}
    t0 = time.perf_counter()
    paths = generate_population_files(workdir, **PRODUCT)
    out["files_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = tvcf.parse_vcf_population(paths.vcf, "pop", "PF_DIPLOID")
    out["native_s"] = time.perf_counter() - t0

    ckpt = os.path.join(workdir, "ingest.cursor")
    saved = tvcf._PARSERS["PF_DIPLOID"]
    tvcf._PARSERS["PF_DIPLOID"] = interrupted_parser(CHECKPOINT_INTERRUPT)
    t0 = time.perf_counter()
    try:
        tvcf.parse_vcf_population(paths.vcf, "pop", "PF_DIPLOID", checkpoint_path=ckpt,
                                  checkpoint_every=CHECKPOINT_EVERY)
        raise AssertionError("the interrupted parser did not raise")
    except IngestInterrupted:
        pass
    finally:
        tvcf._PARSERS["PF_DIPLOID"] = saved
    out["interrupted_s"] = time.perf_counter() - t0
    with open(ckpt) as f:
        cursor = json.load(f)
    if cursor["record_count"] != CHECKPOINT_INTERRUPT // CHECKPOINT_EVERY * CHECKPOINT_EVERY:
        raise AssertionError(f"cursor at {cursor['record_count']} records")
    out["cursor_records"] = cursor["record_count"]
    t0 = time.perf_counter()
    resumed = tvcf.parse_vcf_population(paths.vcf, "pop", "PF_DIPLOID", checkpoint_path=ckpt,
                                        checkpoint_every=CHECKPOINT_EVERY)
    out["resumed_s"] = time.perf_counter() - t0
    log(f"  checkpointed streaming ingest: interrupted after {CHECKPOINT_INTERRUPT} records "
        f"{out['interrupted_s']:.3f} s (cursor at {cursor['record_count']}), resumed "
        f"{out['resumed_s']:.3f} s; native ingest {out['native_s']:.3f} s")
    same_population("resumed checkpointed ingest vs the native ingest", resumed, native)
    left = [name for name in os.listdir(workdir) if name.startswith("ingest.cursor")]
    if left:
        raise AssertionError(f"checkpoint files left after the ingest: {left}")
    for name, filt in (("PassFilter", vfilter.PassFilter()), ("SNPFilter", vfilter.SNPFilter()),
                       ("PassFilter & SNPFilter", vfilter.PassFilter() & vfilter.SNPFilter())):
        got, want = resumed[0].view_filter(filt), native[0].view_filter(filt)
        if population_snapshot(got) != population_snapshot(want):
            raise AssertionError(f"{name} differs on the resumed population")
        log(f"  {name}: equal ({got.variant_count()} of {native[0].variant_count()} incidences)")
    ploidy = []
    for pop in (resumed[0], native[0]):
        p = PloidyAnalysis()
        p.add_population(VariantMajorView(pop))
        ploidy.append({g: vars(d) for g, d in p.genome_data.items()})
    if ploidy[0] != ploidy[1] or len(ploidy[0]) != PRODUCT["n_samples"]:
        raise AssertionError("PloidyAnalysis differs on the resumed population")
    log(f"  PloidyAnalysis: equal ({sum(d['heterozygous'] for d in ploidy[0].values())} het, "
        f"{sum(d['homozygous'] for d in ploidy[0].values())} hom)")
    del native, resumed

    # The local metric at full width, counts from 0.
    fam = TranscriptFamilyAnalysis(records, ref, metric="local", device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with ResultCapture("pairwise_distance_matrix") as captured:
        dist = fam.reference_distances()
        t1 = time.perf_counter()
        n_ref = kernels.LAUNCHES["local"]
        tree = fam.distance_tree_newick()
    torch.cuda.synchronize()
    out["reference_distances_s"] = t1 - t0
    out["distance_tree_newick_s"] = time.perf_counter() - t1
    counts = dict(kernels.LAUNCHES)
    launches = {"local": n_ref, "local_pool": counts.get("local", 0) - n_ref}
    out["launches"] = launches
    log(f"  local family path launches: {counts} (reference_distances {launches['local']}, "
        f"distance_tree_newick {launches['local_pool']})")
    if min(launches.values()) < 1 or set(counts) != {"local"}:
        raise AssertionError(f"expected launches of the local kernel only, got {counts}")
    distinct = list(fam.distinct_sequences())
    seqs, lens = fam._padded_codes(distinct)
    n = len(distinct)
    iu, ju = np.triu_indices(n, k=1)
    P = len(iu)
    local_matrix = captured.results[0]
    d_kernel = local_matrix[iu, ju].astype(np.int32)
    log(f"  {n} distinct mutants, {P} pairs: reference_distances "
        f"{out['reference_distances_s'] * 1e3:.3f} ms, distance_tree_newick "
        f"{out['distance_tree_newick_s'] * 1e3:.3f} ms")

    # Reference distances: the cell-level plain version on the card.
    ref_codes, ref_len = fam._padded_codes([ref])
    pool = torch.as_tensor(seqs.astype(np.int32), device=dev)
    plens = torch.as_tensor(lens, device=dev)
    ref_t = torch.as_tensor(ref_codes.astype(np.int32), device=dev)
    rl = torch.full((n,), int(ref_len[0]), dtype=torch.int32, device=dev)
    want = batched_levenshtein_local(pool, plens, ref_t, rl)
    errs["local"] = max(errs["local"], exact(
        f"local reference_distances (B={n}, one shared row) vs the cell-level plain version",
        torch.as_tensor([dist[s] for s in distinct]), want))

    # The all-pairs matrix: the cell-level plain version over the pairs
    # gathered on the card, in chunks, for as long as the limit allows.
    iu_t, ju_t = torch.as_tensor(iu, device=dev), torch.as_tensor(ju, device=dev)
    parts, held = [], 0
    t0 = time.perf_counter()
    while held < P and time.perf_counter() - t0 < LOCAL_PLAIN_LIMIT_S:
        i, j = iu_t[held: held + LOCAL_PLAIN_CHUNK], ju_t[held: held + LOCAL_PLAIN_CHUNK]
        parts.append(batched_levenshtein_local(pool.index_select(0, i), plens.index_select(0, i),
                                               pool.index_select(0, j), plens.index_select(0, j)))
        held += len(i)
    torch.cuda.synchronize()
    out["plain_s"] = time.perf_counter() - t0
    out["plain_pairs"] = held
    cut = "" if held == P else f" (the plain version's {LOCAL_PLAIN_LIMIT_S:.0f} s limit)"
    errs["local_pool"] = max(errs["local_pool"], exact(
        f"local all-pairs matrix (P={P}, S={S}) vs the cell-level plain version on the card, "
        f"every entry of the first {held} pairs{cut}",
        torch.as_tensor(d_kernel[:held]), torch.cat(parts)))
    log(f"    the plain version: {out['plain_s']:.1f} s for {held} pairs"
        + ("" if held == P else f"; the other {P - held} pairs are not held"))
    del parts
    labels = [g[0] if len(g) == 1 else f"{g[0]}+{len(g) - 1}"
              for g in fam.distinct_sequences().values()]
    upper = np.triu(local_matrix, 1)
    errs["local_pool"] = max(errs["local_pool"], exact(
        "local all-pairs matrix vs its upper triangle mirrored (symmetric, zero diagonal)",
        torch.as_tensor(local_matrix), torch.as_tensor(upper + upper.T)))
    same("local distance_tree_newick vs UPGMA of its matrix", tree,
         newick(upgma_tree(local_matrix, labels)))
    rng = np.random.default_rng(SEED + 7)
    for k in rng.choice(P, LOCAL_ORACLE_PAIRS, replace=False):
        a, b = seqs[iu[k], : lens[iu[k]]], seqs[ju[k], : lens[ju[k]]]
        if d_kernel[k] != levenshtein_local_numpy(a, b):
            raise AssertionError(f"local pair {k} differs from the numpy DP")
    for s in distinct[:3]:
        if dist[s] != levenshtein_local_numpy(fam._padded_codes([s])[0][0], ref_codes[0]):
            raise AssertionError("local reference distance differs from the numpy DP")
    log(f"  {LOCAL_ORACLE_PAIRS} pairs and 3 reference distances: equal to the numpy DP")

    # batched_metric over the same pairs.
    a_list = [seqs[i, : lens[i]] for i in iu]
    b_list = [seqs[j, : lens[j]] for j in ju]
    t0 = time.perf_counter()
    by_metric = metrics.batched_metric(metrics.levenshtein_local_coding, a_list, b_list, device=dev)
    out["batched_metric_local_s"] = time.perf_counter() - t0
    errs["local_pool"] = max(errs["local_pool"], exact(
        f"batched_metric(levenshtein_local_coding) over the {P} pairs vs the tree's matrix",
        torch.as_tensor(by_metric), torch.as_tensor(d_kernel)))
    by_global = metrics.batched_metric(metrics.levenshtein_global_coding, a_list, b_list,
                                       device=dev)
    pa, pb = pool.index_select(0, iu_t), pool.index_select(0, ju_t)
    b3 = batched_levenshtein_kernel(pa, plens.index_select(0, iu_t), pb,
                                    plens.index_select(0, ju_t))
    errs["wavefront"] = max(errs["wavefront"], exact(
        f"batched_metric(levenshtein_global_coding) over the {P} pairs vs B3",
        torch.as_tensor(by_global), b3))
    if not (by_metric <= by_global).all():
        raise AssertionError("a local distance exceeds its global one")
    del pa, pb, b3, a_list, b_list
    torch.cuda.empty_cache()
    out["local_mean"] = float(np.mean(d_kernel))
    out["global_mean"] = float(np.mean(by_global))
    return out, launches, dict(seqs=seqs, lens=lens, d_kernel=d_kernel, ref=ref, fam=fam,
                               plain_pairs_s=(held, out["plain_s"]))


def phase_local_times(dev, state, errs):
    """The local kernel's rows at S = 3,000 (phase 3g's mutants) and 2,181
    (kelch13's width: the same rows cut): B = 256 against the shared
    reference (the reference_distances launch) and the 32,640 pairs of the
    tree, each held against phase 3g's results (at 2,181 against the layout
    of a pair a warp), timed host-inclusive and by a CUDA graph beside its
    bound, its plain version's time and B3 in the same windows, with the
    layout the rule took."""
    import torch

    from kgl_gene_tpu_torch.ops.edit_distance import batched_levenshtein_local
    from kgl_gene_tpu_torch.ops.local import batched_levenshtein_local_kernel, local_layout
    from kgl_gene_tpu_torch.ops.wavefront import batched_levenshtein_kernel

    fam = state["fam"]
    n = state["seqs"].shape[0]
    rows = []
    ref_codes, ref_len = fam._padded_codes([state["ref"]])

    def steps_of(la, lb):
        la, lb = la.astype(np.int64), lb.astype(np.int64)
        lq, lt = np.minimum(la, lb), np.maximum(la, lb)
        return int((-(-lq // 64) * lt).sum())

    for width in (S, LOCAL_GENE_BASES):
        cut = width != S
        seqs = state["seqs"][:, :width] if cut else state["seqs"]
        lens = np.minimum(state["lens"], width)
        pool = torch.as_tensor(seqs.astype(np.int32), device=dev)
        plens = torch.as_tensor(lens, device=dev)
        ref_t = torch.as_tensor(ref_codes[:, :width].astype(np.int32), device=dev)
        rl = torch.full((n,), min(int(ref_len[0]), width), dtype=torch.int32, device=dev)
        kern = functools.partial(batched_levenshtein_local_kernel, pool, plens, ref_t, rl)
        plain = functools.partial(batched_levenshtein_local, pool, plens, ref_t, rl)
        b3 = functools.partial(batched_levenshtein_kernel, pool, plens, ref_t, rl)
        layout = local_layout(n, pool.shape[1], ref_t.shape[1])
        _ms, p_ms = checked_times(f"local kernel (B={n}, S={width}, one shared reference row, "
                                  f"layout {layout})", "local", errs, kern, plain, 20)
        ms, b3_ms = time_cuda_turns([kern, b3], 20)
        d_ms, b3_d_ms = (time_device([fn], 20) for fn in (kern, b3))
        ops = MYERS_OPS_PER_BLOCK_COLUMN * steps_of(lens, np.full(n, int(rl[0])))
        b_ms, by = bound(ops, pool.numel() * 4 + ref_t.numel() * 4 + 3 * n * 4)
        log(f"  local kernel B={n} S={width} shared reference, layout {layout}: {ms:.6f} ms "
            f"host-inclusive, {d_ms:.6f} ms device (B3 at this shape in turns: {b3_ms:.6f} / "
            f"{b3_d_ms:.6f} ms); plain (cell-level) {p_ms:.3f} ms; bound {b_ms:.6f} ms ({by})")
        rows.append(dict(name="local", source="kgl_gene_tpu_torch/csrc/wavefront.cu",
                         replaces="kgl_gene_tpu/ops/edit_distance.py:89",
                         shape=f"B={n}, S={width}, one shared reference row", ms=ms,
                         device_ms=d_ms, b3_ms=b3_ms, b3_device_ms=b3_d_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=by, int_ops=ops, geometry=f"layout {layout}"))

        iu, ju = np.triu_indices(n, k=1)
        P = len(iu)
        iu_t, ju_t = torch.as_tensor(iu, device=dev), torch.as_tensor(ju, device=dev)
        pa, pb = pool.index_select(0, iu_t), pool.index_select(0, ju_t)
        pla, plb = plens.index_select(0, iu_t), plens.index_select(0, ju_t)
        kern = functools.partial(batched_levenshtein_local_kernel, pa, pla, pb, plb)
        b3 = functools.partial(batched_levenshtein_kernel, pa, pla, pb, plb)
        layout = local_layout(P, pa.shape[1], pb.shape[1])
        if cut:
            wide = (32, 1 if width <= 2048 else 2)
            want, against = kern(_layout=wide), f"the layout of a pair a warp {wide}"
        else:
            want, against = torch.as_tensor(state["d_kernel"]), "phase 3g's matrix"
        errs["local_pool"] = max(errs["local_pool"], exact(
            f"local kernel (P={P} all pairs, S={width}, layout {layout}) vs {against}", kern(),
            want))
        ms, b3_ms = time_cuda_turns([kern, b3], 3, windows=3)
        d_ms, b3_d_ms = (time_device([fn], 3) for fn in (kern, b3))
        ops = MYERS_OPS_PER_BLOCK_COLUMN * steps_of(lens[iu], lens[ju])
        b_ms, by = bound(ops, 2 * pa.numel() * 4 + 3 * P * 4)
        held, plain_s = state["plain_pairs_s"]
        log(f"  local kernel P={P} all pairs S={width}, layout {layout}: {ms:.6f} ms "
            f"host-inclusive, {d_ms:.6f} ms device (B3 over the same pairs in turns: {b3_ms:.6f} "
            f"/ {b3_d_ms:.6f} ms, local / B3 {ms / b3_ms:.3f}); bound {b_ms:.6f} ms ({by}); the "
            f"plain version {plain_s * 1e3:.3f} ms for {held} pairs at S={S}")
        rows.append(dict(name="local_pool", source="kgl_gene_tpu_torch/csrc/wavefront.cu",
                         replaces="kgl_gene_tpu/ops/edit_distance.py:89",
                         shape=f"P={P} all pairs, S={width}, per-pair rows", ms=ms, device_ms=d_ms,
                         b3_ms=b3_ms, b3_device_ms=b3_d_ms,
                         plain_ms=plain_s * 1e3, plain_pairs=held, bound_ms=b_ms, bound_by=by,
                         int_ops=ops, geometry=f"layout {layout}"))
        del pa, pb, want
        torch.cuda.empty_cache()
    for r in rows:
        r.update(route="cuda", library_ms=None)
    return rows



def indel_slots(rng, B, K, A, L):
    """Slot tensors of B genomes as tests/test_indel_device.py's
    _random_slots makes them: up to K SNPs, deletions of 1-5 bases and
    insertions of 1-A bases, spans that do not touch."""
    pos = np.zeros((B, K), np.int32)
    kind = np.zeros((B, K), np.int8)
    dlen = np.zeros((B, K), np.int32)
    icodes = np.zeros((B, K, A), np.uint8)
    ilen = np.zeros((B, K), np.int32)
    alt = np.zeros((B, K), np.uint8)
    valid = np.zeros((B, K), bool)
    for b in range(B):
        n = int(rng.integers(0, K + 1))
        used, s = [], 0
        for p in rng.permutation(L - 1)[: 3 * n]:
            if s >= n:
                break
            p = int(p)
            k = int(rng.integers(0, 3))
            d = int(rng.integers(1, 6)) if k == 1 else 0
            span = (p, min(p + d, L) + 1) if k == 1 else (p, p + 2)
            if any(span[0] < hi and span[1] > lo for lo, hi in used):
                continue
            used.append(span)
            pos[b, s], kind[b, s], dlen[b, s], valid[b, s] = p, k, d, True
            if k == 0:
                alt[b, s] = int(rng.integers(0, 4))
            elif k == 2:
                ilen[b, s] = int(rng.integers(1, A + 1))
                icodes[b, s] = rng.integers(0, 4, size=A)
            s += 1
    return pos, kind, dlen, icodes, ilen, alt, valid


def product_pass(paths, contig, txs, device):
    """One pass as bench.py's bench_end_to_end times it: parse the VCF by
    the native record loop (use_native=True: it raises rather than
    stream), then MutateGenes.mutate_transcripts over every gene; the
    clock ends when the records exist. Returns (results, stages,
    (population, header, info))."""
    from kgl_gene_tpu_torch.analysis.lib_seqmutation import MutateGenes
    from kgl_gene_tpu_torch.io.vcf import parse_vcf_population

    stages = {}
    t0 = time.perf_counter()
    pop, header, info = parse_vcf_population(paths.vcf, "pop", "PF_DIPLOID",
                                             use_native=True)
    stages["parse_s"] = time.perf_counter() - t0
    mutator = MutateGenes(contig, info_store=info, device=device, **PRODUCT_BUCKETS)
    results = mutator.mutate_transcripts(pop, txs, timings=stages)
    stages["total_s"] = time.perf_counter() - t0
    return results, stages, (pop, header, info)


def population_snapshot(pop):
    """Per-(genome, contig) incidence tuples resolved through the arena, as
    tests/test_native_ingest.py's _population_snapshot builds them: two
    populations with different arenas compare equal."""
    out = {}
    arena = pop.arena
    for gid, genome in pop:
        for cid, contig in genome:
            cols = contig.columns()
            out[(gid, cid)] = [(
                arena.contig_name(arena.contigs[row]), int(cols["offset"][i]),
                arena.ref_codes(row).tobytes(), arena.alt_codes(row).tobytes(),
                arena.identifier(row), arena.info_row(row), int(cols["phase"][i]),
                int(cols["ref_count"][i]), int(cols["alt_count"][i]), int(cols["dp_count"][i]),
                float(cols["gq_value"][i]), float(cols["quality"][i]), bool(cols["pass"][i]),
            ) for i, row in enumerate(int(r) for r in cols["row"])]
    return out


def same_population(name, got, want):
    """Two (population, header, info) parses: genomes in order, incidences,
    header sample names and every subscribed INFO value."""
    (g_pop, g_head, g_info), (w_pop, w_head, w_info) = got, want
    if list(g_pop.genome_map) != list(w_pop.genome_map) or g_head.genome_names != w_head.genome_names:
        raise AssertionError(f"{name}: genomes differ")
    if population_snapshot(g_pop) != population_snapshot(w_pop):
        raise AssertionError(f"{name}: incidences differ")
    if g_info.count != w_info.count:
        raise AssertionError(f"{name}: {g_info.count} INFO rows != {w_info.count}")
    for fid in sorted(w_info.subscribed):
        for r in range(w_info.count):
            a, b = g_info.value(fid, r), w_info.value(fid, r)
            if not (a == b or (isinstance(b, float) and np.isnan(b) and np.isnan(a))):
                raise AssertionError(f"{name}: INFO {fid} row {r}: {a} != {b}")
    log(f"  {name}: equal ({g_pop.genome_count()} genomes, {g_pop.variant_count()} incidences, "
        f"{g_info.count} INFO rows)")


def record_key(rec, distance=True):
    return (rec.genome_id, rec.gene_id, rec.transcript_id, rec.variant_count,
            rec.modified_coding, rec.validity.value) + ((rec.distance,) if distance else ())


def same_results(name, got, want, distance=True):
    """Records and MutateStats of two mutate_transcripts runs, field by field."""
    n = 0
    for (g_recs, g_stats), (w_recs, w_stats) in zip(got, want, strict=True):
        if [record_key(r, distance) for r in g_recs] != [record_key(r, distance) for r in w_recs]:
            raise AssertionError(f"{name}: records differ")
        if vars(g_stats) != vars(w_stats):
            raise AssertionError(f"{name}: stats differ: {vars(g_stats)} != {vars(w_stats)}")
        n += len(g_recs)
    log(f"  {name}: equal ({n} records and their stats)")


def step_inputs(mutator, pop, tx, dev):
    """The product pass's SNP and indel steps of one transcript, closed
    over device copies of their capture tensors: {kind: (fn, shape)}, the
    shape a string naming B, K (and A) and the distance band."""
    import torch

    from kgl_gene_tpu_torch.ops.myers import myers_band_for
    from kgl_gene_tpu_torch.ops.pipeline import (
        MIN_BANDED_LEN, indel_band_for, make_forward_step, make_indel_forward_step,
        pad_coding_for,
    )
    from kgl_gene_tpu_torch.sequence.sequence import StrandSense

    region = mutator.contig_ref.subsequence(tx.interval).codes
    exons = tx.exon_arrays()
    reverse = tx.strand is StrandSense.REVERSE
    snp, indel, _empty, _host = mutator._capture(pop, tx, True)
    out = {}
    if snp.genome_ids:
        step = make_forward_step(region, exons, tx.start, reverse, device=dev)
        args = [torch.as_tensor(x, device=dev) for x in (snp.positions, snp.alt_codes, snp.valid)]
        K = snp.positions.shape[1]
        band = myers_band_for(K, max_band=127)
        if tx.coding_nucleotides() < MIN_BANDED_LEN:
            band = None
        out["snp"] = (functools.partial(step, *args),
                      f"B={len(snp.positions)} K={K} band {band or 'none (B3)'}")
    if indel is not None and indel.genome_ids:
        K, A = indel.pos.shape[1], indel.ins_codes.shape[2]
        step = make_indel_forward_step(region, exons, tx.start, reverse,
                                       pad_coding=pad_coding_for(K * A),
                                       band_k=indel_band_for(indel.edit_bound), device=dev)
        args = [torch.as_tensor(x, device=dev) for x in (
            indel.pos, indel.kind, indel.del_len, indel.ins_codes, indel.ins_len,
            indel.alt_code, indel.valid)]
        out["indel"] = (functools.partial(step, *args),
                        f"B={len(indel.pos)} K={K} A={A} edit bound {indel.edit_bound} "
                        f"band {indel_band_for(indel.edit_bound) or '0 (B3)'}")
    return out


def phase_product(dev, workdir):
    """Phase 3c: the product path (synthetic FASTA/GFF3/VCF -> PopulationDB
    -> capture -> SNP and SNP + indel steps -> one packed fetch -> records)
    at bench.py's end-to-end shape. Returns the launches of each kind of
    step in the first pass, counted from 0, and of the band-0 indel step."""
    import torch

    import kgl_gene_tpu_torch.analysis.lib_seqmutation as lsm
    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.genome.genome import GenomeReference
    from kgl_gene_tpu_torch.io.synthetic import generate_population_files
    from kgl_gene_tpu_torch.ops.edit_distance import levenshtein_numpy
    from kgl_gene_tpu_torch.ops.pipeline import make_indel_forward_step
    from kgl_gene_tpu_torch.ops.wavefront import wavefront_levenshtein
    from kgl_gene_tpu_torch.sequence.alphabet import DNA5

    from kgl_gene_tpu_torch.io.streams import write_bgzf
    from kgl_gene_tpu_torch.io.vcf import parse_vcf_population

    t0 = time.perf_counter()
    paths = generate_population_files(workdir, **PRODUCT)
    genome = GenomeReference.create_genome_database("synthetic", paths.fasta, paths.gff3)
    contig = genome.get_contig(paths.contig_id)
    txs = [contig.get_transcription(paths.gene_id(g), paths.transcript_id(g))
           for g in range(paths.n_genes)]
    log(f"  files and genome: {time.perf_counter() - t0:.1f} s")

    # The first pass is the path's run: counts from 0, read just after.
    torch.cuda.synchronize()
    kernels.reset_launches()
    results, stages, parsed = product_pass(paths, contig, txs, dev)
    pop, _header, info = parsed
    total = dict(kernels.LAUNCHES)
    per_step = stages["launches"]
    log(f"  product path launches: {total}; by step {per_step}")
    for kind in ("snp", "indel"):
        for name in ("translate", "myers"):
            if per_step.get(kind, {}).get(name, 0) < 1:
                raise AssertionError(f"kernel {name} never launched in the {kind} step")
    for name, n in total.items():
        if n != sum(counts.get(name, 0) for counts in per_step.values()):
            raise AssertionError(f"{name}: launches outside the steps")
    n_records = sum(len(recs) for recs, _stats in results)
    capture = lsm.MutateGenes(contig, info_store=info, device=dev, **PRODUCT_BUCKETS)._capture
    n_host = sum(len(capture(pop, tx, True)[3]) for tx in txs)
    log(f"  {n_records} records, {n_host} of them from the host-exact engine")
    if n_records != paths.n_genes * paths.n_samples or stages["n_device_fetches"] != 1:
        raise AssertionError(f"{n_records} records in {stages['n_device_fetches']} fetches")

    # The streaming Python loop on the same VCF: the same population, and
    # the same records from it.
    t0 = time.perf_counter()
    streamed = parse_vcf_population(paths.vcf, "pop", "PF_DIPLOID", use_native=False)
    log(f"  streaming parse (one run): {(time.perf_counter() - t0) * 1e3:.3f} ms")
    same_population("native parse vs streaming parse", parsed, streamed)
    from_streamed = lsm.MutateGenes(contig, info_store=streamed[2], device=dev,
                                    **PRODUCT_BUCKETS).mutate_transcripts(streamed[0], txs)
    same_results("records from the streaming parse vs the native parse", from_streamed, results)
    # The BGZF route: the same VCF compressed by write_bgzf, parsed natively
    # through the native slab stream.
    bgz = paths.vcf + ".bgz"
    with open(paths.vcf, "rb") as f:
        write_bgzf(bgz, f.read())
    t0 = time.perf_counter()
    from_bgzf = parse_vcf_population(bgz, "pop", "PF_DIPLOID", use_native=True)
    log(f"  BGZF native parse (one run): {(time.perf_counter() - t0) * 1e3:.3f} ms")
    same_population("BGZF native parse vs streaming parse", from_bgzf, streamed)

    passes = [product_pass(paths, contig, txs, dev)[1] for _ in range(PRODUCT_PASSES)]
    med = {k: statistics.median(p[k] for p in passes) for k in STAGES}
    log(f"  product pass, median of {PRODUCT_PASSES} after one warm pass: "
        f"{med['total_s'] * 1e3:.3f} ms for {n_records} records, "
        f"{n_records / med['total_s']:.1f} genomes/s")
    log("  stages (median ms): " + ", ".join(f"{k} {med[k] * 1e3:.3f}" for k in STAGES)
        + "; per pass: " + "; ".join(
            ", ".join(f"{p[k] * 1e3:.3f}" for k in STAGES) for p in passes))

    # Records: the device route against the host-exact engine.
    mutator = lsm.MutateGenes(contig, info_store=info, device=dev, **PRODUCT_BUCKETS)
    t0 = time.perf_counter()
    host = lsm.MutateGenes(contig, info_store=info, use_device=False).mutate_transcripts(pop, txs)
    log(f"  host-exact route: {time.perf_counter() - t0:.1f} s")
    same_results("device route vs host-exact route", results, host, distance=False)

    # Distances: every one against kernel B3's exact distance, some against
    # the numpy DP.
    checked = []
    for tx, (recs, _stats) in zip(txs, results):
        ref = contig.coding_sequence(tx).codes
        width = max(len(r.modified_coding) for r in recs)
        seqs = np.zeros((len(recs), width), np.uint8)
        lens = np.array([len(r.modified_coding) for r in recs], np.int32)
        for i, r in enumerate(recs):
            seqs[i, : lens[i]] = DNA5.from_string(r.modified_coding)
        exact_d = wavefront_levenshtein(seqs, lens, ref[None, :],
                                        np.full(len(recs), len(ref), np.int32), device=dev)
        got = np.array([r.distance for r in recs])
        if not np.array_equal(got, exact_d):
            raise AssertionError(f"{tx.transcript_id}: {int((got != exact_d).sum())} distances "
                                 "differ from B3's")
        checked += [(int(d), seqs[i, : lens[i]], ref) for i, d in enumerate(got)]
    log(f"  distances: {len(checked)} equal to B3's exact distance, "
        f"widest {max(d for d, _a, _b in checked)}")
    for d, a, b in sorted(checked, key=lambda c: -c[0])[:PRODUCT_ORACLE_RECORDS]:
        if d != levenshtein_numpy(a, b):
            raise AssertionError("a distance differs from the numpy DP")
    log(f"  distances: the {PRODUCT_ORACLE_RECORDS} widest equal to the numpy DP")

    # The other indel payload: 8-byte tails, sequences replayed on the host.
    lsm.INDEL_TAIL_ONLY = True
    try:
        tails = lsm.MutateGenes(contig, info_store=info, device=dev,
                                **PRODUCT_BUCKETS).mutate_transcripts(pop, txs)
    finally:
        lsm.INDEL_TAIL_ONLY = False
    same_results("tail payload vs packed payload", tails, results)

    # Each step on its own: host-inclusive (events around back-to-back
    # calls) and on the device alone (the calls in one CUDA graph).
    step_rows = []
    for tx in txs:
        for kind, (fn, shape) in step_inputs(mutator, pop, tx, dev).items():
            ms = time_cuda(fn, 20)
            dev_ms = time_device([fn], 10)
            step_rows.append((tx.transcript_id, kind, shape, ms, dev_ms))
            log(f"  step {tx.transcript_id} {kind} {shape}: {ms:.4f} ms host-inclusive, "
                f"{dev_ms:.4f} ms on the device")
    for kind in ("snp", "indel"):
        rows = [r for r in step_rows if r[1] == kind]
        log(f"  {kind} steps of a pass: {sum(r[3] for r in rows):.4f} ms host-inclusive, "
            f"{sum(r[4] for r in rows):.4f} ms on the device ({len(rows)} steps)")

    # The indel step alone at each band and on the reverse strand, against
    # its CPU run entry by entry.
    rng = np.random.default_rng(SEED + 7)
    region = gene_region(rng)
    band0 = {}
    for band, reverse, K, A in INDEL_ALONE:
        args = indel_slots(rng, 256, K, A, REGION_LEN)
        kw = dict(reverse_strand=reverse, pad_coding=K * A, band_k=band)
        step = make_indel_forward_step(region, EXONS, 0, device=dev, **kw)
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = step(*args)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        dist_kernel = "myers" if band else "wavefront"
        other = "wavefront" if band else "myers"
        if counts.get("translate", 0) < 1 or counts.get(dist_kernel, 0) < 1 or counts.get(other):
            raise AssertionError(f"indel step band {band}: launches {counts}")
        if not band:
            band0 = counts
        t0 = time.perf_counter()
        want = make_indel_forward_step(region, EXONS, 0, device="cpu", **kw)(*args)
        log(f"  indel step band {band} reverse {reverse} K={K} A={A}: launches {counts}, "
            f"CPU run {time.perf_counter() - t0:.1f} s")
        for field in got._fields:
            exact(f"indel band {band} rev {reverse}.{field}", getattr(got, field),
                  getattr(want, field))
    return per_step, band0


def scale_cells(n_records, n_samples, seed=SCALE_SEED, chunk_rows=SCALE_CHUNK_ROWS):
    """(het cells, hom cells) of generate_scale_vcf's file, counted by numpy
    from the generator's seed alone: the same draws in the same order
    (allele frequencies, the cell draw, the AD/DP digit draws, which are
    drawn and dropped to keep the stream aligned), and the generator's
    thresholds, without writing a byte."""
    rng = np.random.default_rng(seed)
    het = hom = 0
    for start in range(0, n_records, chunk_rows):
        rows = min(chunk_rows, n_records - start)
        af = rng.beta(0.3, 6.0, rows)
        p_het, p_hom = 2.0 * af * (1.0 - af), af * af
        t1 = (255 * p_het).astype(np.uint8)[:, None]
        t2 = (255 * (p_het + p_hom)).astype(np.uint8)[:, None]
        u = rng.integers(0, 256, size=(rows, n_samples), dtype=np.uint16)
        het += int(np.count_nonzero(u < t1))
        hom += int(np.count_nonzero((u >= t1) & (u < t2)))
        rng.integers(0, 10, size=(rows, n_samples, 6), dtype=np.uint8)
        rng.integers(1, 10, size=(rows, n_samples, 3), dtype=np.uint8)
    return het, hom


def peak_rss_kb():
    """The process's peak resident set (VmHWM), in kB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1])
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


def phase_scale(dev, workdir):
    """Phase 3d: population scale (bench.py's bench_scale, records cut to
    2 x 10^5). Native ingest of the generated VCF, VariantMajorCSR, allele
    frequencies and het/hom by genome, inbreeding streamed through the card
    (Simple, RitlandLocus), and the four estimators on a dense window of
    1,000 genomes x 10,000 loci; the card's F values against the same
    functions on the CPU. Returns (the scale line's dict, the rows of the
    device functions)."""
    import torch

    import kgl_gene_tpu_torch.parallel.mesh as mesh
    from kgl_gene_tpu_torch.io.synthetic import generate_scale_vcf
    from kgl_gene_tpu_torch.io.vcf import parse_vcf_population
    from kgl_gene_tpu_torch.stats.inbreeding import run_estimator
    from kgl_gene_tpu_torch.variant.columnar import VariantMajorCSR

    n_records, n_samples = SCALE["n_records"], SCALE["n_samples"]
    path = os.path.join(workdir, "scale.vcf")
    out = {"records": n_records, "samples": n_samples}
    # Peak RSS of this phase alone: Linux resets the process's high-water
    # mark (VmHWM) on writing 5 to clear_refs; where that is refused the
    # peak read at the end is the whole process's.
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
        out["rss_peak_of"] = "phase 3d"
    except OSError:
        out["rss_peak_of"] = "the process"
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as pool:
        replay = pool.submit(scale_cells, n_records, n_samples)
        t0 = time.perf_counter()
        generate_scale_vcf(path, **SCALE)
        out["generate_s"] = time.perf_counter() - t0
        out["vcf_mb"] = os.path.getsize(path) / 1e6
        log(f"  generated {out['vcf_mb']:.1f} MB in {out['generate_s']:.1f} s")

        t0 = time.perf_counter()
        pop, _header, info = parse_vcf_population(path, "scale", "PF_DIPLOID",
                                                  subscribed_info=["AF"], use_native=True)
        out["ingest_s"] = time.perf_counter() - t0
        het_cells, hom_cells = replay.result()
    out["ingest_mb_per_s"] = out["vcf_mb"] / out["ingest_s"]
    out["ingest_cells_per_s"] = n_records * n_samples / out["ingest_s"]
    log(f"  native ingest: {out['ingest_s']:.3f} s, {out['ingest_mb_per_s']:.1f} MB/s, "
        f"{out['ingest_cells_per_s']:.4g} cells/s")
    if pop.genome_count() != n_samples or info.count != n_records:
        raise AssertionError(f"{pop.genome_count()} genomes, {info.count} INFO rows")
    out["incidences"] = pop.variant_count()
    if out["incidences"] != het_cells + 2 * hom_cells:
        raise AssertionError(f"{out['incidences']} incidences; the generator's seed gives "
                             f"{het_cells} het and {hom_cells} hom cells")
    log(f"  {out['incidences']} incidences = {het_cells} het + 2 x {hom_cells} hom cells, "
        "as numpy counts them from the generator's seed")

    t0 = time.perf_counter()
    csr = VariantMajorCSR(pop)
    out["csr_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    af = csr.allele_frequencies()
    het, hom = csr.het_hom_by_genome()
    out["af_s"] = time.perf_counter() - t0
    if (csr.genome_count, csr.nnz, int(het.sum()), int(hom.sum())) != (
            n_samples, het_cells + hom_cells, het_cells, hom_cells):
        raise AssertionError("the CSR's cells differ from the generator's")
    out["variants"], out["nnz"] = csr.variant_count, csr.nnz
    log(f"  CSR {out['csr_s']:.3f} s ({csr.variant_count} variants, {csr.nnz} cells), "
        f"allele frequencies and het/hom {out['af_s']:.3f} s")

    # Inbreeding streamed through the card: _inbreed_moments counted per
    # call, the accumulator fetched once.
    calls = []
    moments = mesh._inbreed_moments
    mesh._inbreed_moments = lambda *a, **k: calls.append(a[0].shape) or moments(*a, **k)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        f_card = mesh.streamed_inbreeding(csr, af, dev)
        out["inbreed_s"] = time.perf_counter() - t0
        out["cuda_max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        mesh._inbreed_moments = moments
    t0 = time.perf_counter()
    f_cpu = mesh.streamed_inbreeding(csr, af, "cpu")
    out["inbreed_cpu_s"] = time.perf_counter() - t0
    for name in f_card:
        err = float(np.abs(f_card[name] - f_cpu[name]).max())
        out[f"streamed_{name}_max_abs_err"] = err
        if not err <= ESTIMATOR_ATOL[name]:
            raise AssertionError(f"streamed {name}: card and CPU differ by {err}")
    out["mean_inbreeding_f"] = float(np.nanmean(f_card["Simple"]))
    log(f"  streamed inbreeding on the card {out['inbreed_s']:.3f} s ({len(calls)} blocks of "
        f"{calls[0]} packed bytes), on the CPU {out['inbreed_cpu_s']:.3f} s; card vs CPU "
        + ", ".join(f"{n} {out[f'streamed_{n}_max_abs_err']:.3g}" for n in f_card))

    # The four estimators on a dense window: every k-th variant with
    # 0 < p < 1, k chosen so the window holds SCALE_WINDOW loci.
    cand = np.nonzero((af > 0) & (af < 1))[0]
    stride = max(1, len(cand) // SCALE_WINDOW)
    sel = cand[::stride][:SCALE_WINDOW]
    z = np.ascontiguousarray(csr.dense_block_t(0, csr.variant_count)[sel].T)
    p = af[sel]
    out["window"] = {"genomes": z.shape[0], "loci": z.shape[1], "stride": stride}
    rows = []
    for name in ESTIMATOR_ATOL:
        t0 = time.perf_counter()
        got = mesh.sharded_inbreeding(z, p, dev, name)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = mesh.sharded_inbreeding(z, p, "cpu", name)
        cpu_s = time.perf_counter() - t0
        err = float(np.abs(got - want).max())
        out[f"{name}_max_abs_err"] = err
        log(f"  {name}: card {card_s:.3f} s, CPU {cpu_s:.3f} s, max |card - CPU| {err:.3g}")
        if not err <= ESTIMATOR_ATOL[name]:
            raise AssertionError(f"{name}: card and CPU differ by {err}")
        rows.append((name, cpu_s))

    # Each device function timed alone on the card (CUDA events around
    # back-to-back calls), beside its byte bound: every input read once,
    # every output written once.
    G = csr.genome_count
    table = []
    packed = torch.randint(0, 256, calls[0], dtype=torch.uint8, device=dev)
    p_blk = torch.as_tensor(np.resize(af.astype(np.float32), 4 * calls[0][0]), device=dev)
    acc = torch.zeros((G, 5), dtype=torch.float32, device=dev)
    ms = time_cuda(functools.partial(moments, packed, p_blk, acc, mesh.slab_rows_for(G)), 3,
                   windows=3)
    nbytes = packed.numel() + p_blk.numel() * 4 + acc.numel() * 4 * 2
    table.append({"name": "_inbreed_moments", "source": "kgl_gene_tpu_torch/parallel/mesh.py",
                  "replaces": "kgl_gene_tpu/parallel/mesh.py:148", "launches": len(calls),
                  "shape": f"packed {tuple(calls[0])} uint8", "ms": ms,
                  "cpu_ms": out["inbreed_cpu_s"] * 1e3 / len(calls),
                  "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3, "bound_by": "bytes"})
    z_dev = torch.as_tensor(z, device=dev).to(torch.int32)
    p_dev = torch.as_tensor(p.astype(np.float32), device=dev)
    v_dev = ((p_dev > 0) & (p_dev < 1)).expand(z_dev.shape)
    nbytes = z_dev.numel() * 4 + z_dev.numel() + p_dev.numel() * 4 + G * 4
    jax_rows = {"RitlandLocus": 77, "Simple": 88, "HallME": 97, "Loglikelihood": 128}
    for name, cpu_s in rows:
        fn = functools.partial(run_estimator, name, z_dev, p_dev, v_dev)
        table.append({"name": name, "source": "kgl_gene_tpu_torch/stats/inbreeding.py",
                      "replaces": f"kgl_gene_tpu/stats/inbreeding.py:{jax_rows[name]}",
                      "launches": 1, "shape": f"zygosity {tuple(z.shape)} int32",
                      "ms": time_cuda(fn, 1 if name in ("HallME", "Loglikelihood") else 5,
                                      windows=3),
                      "cpu_ms": cpu_s * 1e3,
                      "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3, "bound_by": "bytes"})
    for row in table:
        log(f"  {row['name']} {row['shape']}: {row['ms']:.4f} ms on the card "
            f"(bound {row['bound_ms']:.4f} ms by bytes), CPU {row['cpu_ms']:.3f} ms, "
            f"{row['launches']} on the path")
    out["rss_gb"] = peak_rss_kb() / 1e6
    return out, table


def count_launches(fn):
    """(fn's result, the aten operations it ran that launch work on the
    card: every operation with a CUDA output, not counting views and
    allocations)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    skip = {"aten.empty.memory_format", "aten.empty_strided.default",
            "aten._unsafe_view.default", "aten.lift_fresh.default"}

    class Counter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and str(func) not in skip and any(
                    isinstance(x, torch.Tensor) and x.is_cuda for x in tree_flatten(out)[0]):
                Counter.n += 1
            return out

    with Counter():
        result = fn()
    return result, Counter.n


def sync_free(label, fn):
    """fn() behind a sleep kernel of SYNC_PROBE_CYCLES and under
    torch.cuda.set_sync_debug_mode("error"): raises if fn synchronises (the
    debug mode's own error), or if the stream has drained by the time fn
    returns (the host waited for the card by a route the debug mode does
    not see)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(SYNC_PROBE_CYCLES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        result = fn()
        host_s = time.perf_counter() - t0
        pending = not torch.cuda.current_stream().query()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not pending:
        raise AssertionError(f"{label}: the stream drained while the host ran it")
    log(f"  {label}: no host synchronisation (sync debug mode 'error'; enqueued in "
        f"{host_s * 1e3:.2f} ms behind a sleep kernel still running)")
    return result


def median_spread(samples):
    """(median, (max - min) / median), bench.py's _median_spread."""
    med = statistics.median(samples)
    return med, (max(samples) - min(samples)) / med


def rel_gap(got, want):
    return abs(got - want) / abs(want)


def phase_phylo(dev):
    """Phase 3e: the Bayesian phylogenetics path at bench_phylo's shapes
    (PHYLO). The vmapped heated chains and the product sampler (the fused
    full iteration with Larget-Simon and polytomy on, one chain and four
    pipelined heated chains) on the card: rates with spread, launches a
    likelihood and an iteration, each device program once behind a sleep
    kernel under the sync debug mode (sync_free), the card's log-likelihoods against the port's CPU run and
    the float64 host log_likelihood on the initial and the final states, the
    path update against a full recompute at 300,000 sites, and each device
    function timed beside its byte bound. Returns (the phylo line's dict,
    the device-function rows)."""
    import random

    import torch

    from kgl_gene_tpu_torch.phylo.likelihood import (
        CachedPartialsLikelihood, _Topology, _edge_views, _prune, _root_loglike, _upload,
        log_likelihood)
    from kgl_gene_tpu_torch.phylo.mcmc import Chain, ChainState, MCMCSampler
    from kgl_gene_tpu_torch.phylo.model import SubstitutionModel
    from kgl_gene_tpu_torch.phylo.tree import random_tree
    from kgl_gene_tpu_torch.phylo.vmapped import VmappedChains

    out, rows = {}, []
    torch.cuda.reset_peak_memory_stats()
    n_taxa, windows = PHYLO["n_taxa"], PHYLO["windows"]
    rng = np.random.default_rng(7)
    taxa = [f"T{i}" for i in range(n_taxa)]
    tree = random_tree(taxa, random.Random(7))
    aln = rng.integers(0, 4, size=(n_taxa, PHYLO["vm_sites"])).astype(np.uint8)
    tip_bytes = n_taxa * PHYLO["vm_sites"] * 16

    # --- vmapped chains ----------------------------------------------------
    C, iters = PHYLO["vm_chains"], PHYLO["vm_iters"]
    chains = VmappedChains(tree, aln, n_chains=C, device=dev)
    cpu_chains = VmappedChains(tree, aln, n_chains=C, device="cpu")

    def vm_check(label):
        params = [x.cpu().numpy() for x in chains.params]
        card = chains._loglike(chains.params).cpu().numpy().astype(np.float64)
        cpu_chains.set_params(*params)
        cpu = cpu_chains._loglike(cpu_chains.params).numpy().astype(np.float64)
        host_tree = tree.copy()
        for e, length in zip(host_tree.edges(), params[0][0]):
            e.edge_length = float(length)
        host = log_likelihood(host_tree, aln, SubstitutionModel(
            params[2][0].astype(np.float64), params[1][0].astype(np.float64)))
        gap_cpu = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
        gap_host = rel_gap(card[0], host)
        out[f"vm_{label}"] = {"card": card.tolist(), "cpu": cpu.tolist(), "host_f64": host,
                              "rel_gap_cpu": gap_cpu, "rel_gap_f64": gap_host}
        log(f"  vmapped {label}: cold chain card {card[0]:.4f}, CPU {cpu[0]:.4f}, float64 "
            f"host {host:.4f}; relative gaps {gap_cpu:.3g} (CPU, all chains), {gap_host:.3g} "
            f"(float64); tolerance {PHYLO_REL}")
        if not (gap_cpu <= PHYLO_REL and gap_host <= PHYLO_REL):
            raise AssertionError(f"vmapped {label}: the card's log-likelihoods differ")

    vm_check("initial")
    _ll, out["vm_launches_loglike"] = count_launches(lambda: chains._loglike(chains.params))
    res, out["vm_launches_run1"] = count_launches(lambda: chains._run(chains.params, 1))
    sync_free("vmapped _run of one iteration", lambda: chains._run(chains.params, 1))[2].cpu()
    log(f"  vmapped launches: {out['vm_launches_loglike']} a likelihood, "
        f"{out['vm_launches_run1']} a _run of one iteration (its first likelihood and draws "
        "included)")
    t0 = time.perf_counter()
    chains.run(iters)
    chains.run(iters)
    out["vm_warm_s"] = time.perf_counter() - t0
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        trace = chains.run(iters)
        rates.append(iters / (time.perf_counter() - t0))
    if trace.shape != (iters,) or not np.isfinite(trace).all():
        raise AssertionError("the vmapped trace is not finite")
    out["vm_iters_per_s"], out["vm_spread"] = median_spread(rates)
    out["vm_windows_iters_per_s"] = rates
    vm_check("final")
    host_chain = Chain(aln, ChainState(tree.copy(), SubstitutionModel(
        np.ones(6), np.full(4, 0.25), 1.0, 1, 0.0)), rng=random.Random(1),
        updaters=("branch_length", "tree_length", "state_freq", "exchangeability"),
        fixed_topology=True)
    t0 = time.perf_counter()
    for _ in range(PHYLO["host_iters"]):
        host_chain.next_step()
    out["vm_host_iters_per_s"] = PHYLO["host_iters"] / (time.perf_counter() - t0)
    out["vm_speedup_vs_host"] = out["vm_iters_per_s"] / out["vm_host_iters_per_s"]
    log(f"  vmapped chains ({C} x {n_taxa} taxa x {PHYLO['vm_sites']} sites): "
        f"{out['vm_iters_per_s']:.2f} cold-chain iterations/s (windows "
        + ", ".join(f"{r:.2f}" for r in rates) + f"; spread {out['vm_spread']:.3f}); host "
        f"Chain {out['vm_host_iters_per_s']:.3f} iterations/s, x{out['vm_speedup_vs_host']:.1f}")

    fn = functools.partial(chains._loglike, chains.params)
    t0 = time.perf_counter()
    cpu_chains._loglike(cpu_chains.params)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    rows.append({"name": "VmappedChains._loglike", "source": "kgl_gene_tpu_torch/phylo/vmapped.py",
                 "replaces": "kgl_gene_tpu/phylo/vmapped.py:140 (scan :134)",
                 "launches": out["vm_launches_loglike"],
                 "shape": f"{C} chains x {n_taxa} taxa x {PHYLO['vm_sites']} sites",
                 "ms": time_cuda(fn, 10, windows=3),
                 "device_ms": time_device([fn], 10, windows=3), "cpu_ms": cpu_ms,
                 "bound_ms": tip_bytes / MEM_BYTES_PER_S * 1e3, "bound_by": "bytes"})
    rows.append({"name": "VmappedChains iteration", "source": "kgl_gene_tpu_torch/phylo/vmapped.py",
                 "replaces": "kgl_gene_tpu/phylo/vmapped.py:146 (scan :239)",
                 "launches": out["vm_launches_run1"] - out["vm_launches_loglike"],
                 "shape": rows[-1]["shape"], "ms": 1e3 / out["vm_iters_per_s"],
                 "device_ms": None, "cpu_ms": None,
                 "bound_ms": tip_bytes / MEM_BYTES_PER_S * 1e3, "bound_by": "bytes"})

    # --- product sampler ---------------------------------------------------
    S = PHYLO["prod_sites"]
    aln_p = rng.integers(0, 4, size=(n_taxa, S)).astype(np.uint8)
    tree_p = random_tree(taxa, random.Random(11))
    tip_bytes = n_taxa * S * 16

    def new_model():
        return SubstitutionModel(np.ones(6), np.full(4, 0.25), 1.0, 1, 0.0)

    np.random.seed(1)
    sampler = MCMCSampler(aln_p, ChainState(tree_p.copy(), new_model()), n_chains=1, seed=3,
                          backend="device", device=dev)
    chain = sampler.cold_chain
    tips = chain.backend.tips

    def prod_check(label):
        state = chain.state
        card = CachedPartialsLikelihood(aln_p, tips=tips).loglike(state.tree, state.model)
        cpu = CachedPartialsLikelihood(aln_p, device="cpu").loglike(state.tree, state.model)
        host = log_likelihood(state.tree, aln_p, state.model)
        gaps = {"rel_gap_cpu": rel_gap(card, cpu), "rel_gap_f64": rel_gap(card, host),
                "rel_gap_carried": rel_gap(state.log_like, card)}
        out[f"prod_{label}"] = {"card": card, "cpu": cpu, "host_f64": host,
                                "carried": state.log_like, **gaps}
        log(f"  product {label}: card {card:.4f}, CPU {cpu:.4f}, float64 host {host:.4f}, "
            f"carried by the sampler {state.log_like:.4f}; relative gaps "
            + ", ".join(f"{k[8:]} {v:.3g}" for k, v in gaps.items())
            + f"; tolerance {PHYLO_REL}")
        if not all(v <= PHYLO_REL for v in gaps.values()):
            raise AssertionError(f"product {label}: the card's log-likelihoods differ")

    prod_check("initial")
    # the path update against a full recompute, three edges at three depths
    state = chain.state.copy()
    topo = _Topology(state.tree)
    path_gaps = []
    for slot in (0, len(topo.slot) // 2, len(topo.slot) - 1):
        be = CachedPartialsLikelihood(aln_p, tips=tips)
        be.loglike(state.tree, state.model)
        be.on_accept()
        node = state.tree.edges()[slot]
        node.edge_length *= 1.7
        path = be.loglike(state.tree, state.model, changed_node_index=node.index)
        full = CachedPartialsLikelihood(aln_p, tips=tips).loglike(state.tree, state.model)
        path_gaps.append(rel_gap(path, full))
    out["path_rel_gaps"] = path_gaps
    log(f"  path update vs full recompute at {S} sites: relative gaps "
        + ", ".join(f"{g:.3g}" for g in path_gaps) + f"; tolerance {PHYLO_PATH_REL}")
    if max(path_gaps) > PHYLO_PATH_REL:
        raise AssertionError("the path update differs from a full recompute")

    backend = chain.backend
    model, E = chain.state.model, len(chain.state.tree.edges())
    draws = backend.draw_sweep(model, E)
    _f, out["launches_sweep"] = count_launches(
        lambda: backend._sweep_body(chain.state.tree, model, 1.0, draws))
    _f.wait()
    sync_free("param sweep body", lambda: backend._sweep_body(
        chain.state.tree, model, 1.0, draws)).wait()
    token, out["launches_fused_iteration"] = count_launches(chain.dispatch_full_iteration)
    chain.collect_full_iteration(token)
    chain.collect_full_iteration(sync_free("fused iteration dispatch",
                                           chain.dispatch_full_iteration))
    log(f"  product launches: {out['launches_sweep']} a sweep (5 likelihoods), "
        f"{out['launches_fused_iteration']} a fused iteration (8 likelihoods)")

    t0 = time.perf_counter()
    sampler.run(PHYLO["prod_warm"])
    out["prod_warm_s"] = time.perf_counter() - t0
    n = PHYLO["prod_iters"]
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        sampler.run(n)
        rates.append(n / (time.perf_counter() - t0))
    out["prod_iters_per_s"], out["prod_spread"] = median_spread(rates)
    out["prod_windows_iters_per_s"] = rates
    out["prod_acceptance"] = chain.acceptance_rates()
    log(f"  product sampler (1 chain, {n_taxa} taxa x {S} sites): {out['prod_iters_per_s']:.2f} "
        "iterations/s (windows " + ", ".join(f"{r:.2f}" for r in rates)
        + f"; spread {out['prod_spread']:.3f}); acceptance "
        + ", ".join(f"{k} {v:.2f}" for k, v in out["prod_acceptance"].items()))
    prod_check("final")

    H = PHYLO["heated_chains"]
    np.random.seed(1)
    heated = MCMCSampler(aln_p, ChainState(tree_p.copy(), new_model()), n_chains=H, seed=3,
                         backend="device", device=dev)
    heated.run(PHYLO["prod_warm"])
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        heated.run(n)
        rates.append(H * n / (time.perf_counter() - t0))
    out["heated_chain_iters_per_s"], out["heated_spread"] = median_spread(rates)
    out["heated_windows"] = rates
    if not all(np.isfinite(c.state.log_like) for c in heated.chains):
        raise AssertionError("a heated chain's log-likelihood is not finite")
    log(f"  product sampler ({H} pipelined heated chains): "
        f"{out['heated_chain_iters_per_s']:.2f} chain-iterations/s (windows "
        + ", ".join(f"{r:.2f}" for r in rates) + f"; spread {out['heated_spread']:.3f}); "
        f"swaps {heated.swap_accepts}/{heated.swap_attempts}")

    # device functions at 16 x 300,000, timed alone
    state = chain.state
    topo = _Topology(state.tree)
    P = _upload(state.model.transition_matrices(topo.edge_lengths), dev)
    P_of, TW_of = _edge_views(topo, P)
    pi = _upload(state.model.frequencies / state.model.frequencies.sum(), dev)
    rw = _upload(np.ones(1), dev)

    def full_pass():
        return _root_loglike(_prune(tips, topo, P_of, TW_of)[topo.root], pi, rw, 0.0, None)

    parts = _prune(tips, topo, P_of, TW_of)
    leaf = next(c for _node, ch in topo.steps for c in ch if c < n_taxa)
    children = dict(topo.steps)
    path_nodes, node = [], int(topo.parent[leaf])
    while node >= 0:
        path_nodes.append((node, children[node]))
        node = int(topo.parent[node])

    def path_pass():
        return _root_loglike(_prune(tips, topo, P_of, TW_of, list(parts), path_nodes)[topo.root],
                             pi, rw, 0.0, None)

    _r, launches_full = count_launches(full_pass)
    _r, launches_path = count_launches(path_pass)
    cpu_be = CachedPartialsLikelihood(aln_p, device="cpu")
    t0 = time.perf_counter()
    cpu_be.loglike(state.tree, state.model)
    cpu_full_ms = (time.perf_counter() - t0) * 1e3
    cpu_be.on_accept()
    t0 = time.perf_counter()
    cpu_be.loglike(state.tree, state.model, changed_node_index=leaf)
    cpu_path_ms = (time.perf_counter() - t0) * 1e3
    # the path's inputs: the partials (tip or cached, 16 bytes a site) of
    # its nodes' children that are not themselves on the path
    path_in = sum(16 * S for _n, ch in path_nodes for c in ch if c not in dict(path_nodes))
    rows.append({"name": "CachedPartialsLikelihood full", "source":
                 "kgl_gene_tpu_torch/phylo/likelihood.py",
                 "replaces": "kgl_gene_tpu/phylo/likelihood.py:270 (scan :305)",
                 "launches": launches_full, "shape": f"{n_taxa} taxa x {S} sites",
                 "ms": time_cuda(full_pass, 10, windows=3),
                 "device_ms": time_device([full_pass], 10, windows=3), "cpu_ms": cpu_full_ms,
                 "bound_ms": (tip_bytes + len(topo.steps) * S * 16) / MEM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes"})
    rows.append({"name": "CachedPartialsLikelihood path", "source":
                 "kgl_gene_tpu_torch/phylo/likelihood.py",
                 "replaces": "kgl_gene_tpu/phylo/likelihood.py:317 (scan :348)",
                 "launches": launches_path,
                 "shape": f"{n_taxa} taxa x {S} sites, a path of {len(path_nodes)} nodes",
                 "ms": time_cuda(path_pass, 10, windows=3),
                 "device_ms": time_device([path_pass], 10, windows=3), "cpu_ms": cpu_path_ms,
                 "bound_ms": (path_in + len(path_nodes) * S * 16) / MEM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes"})
    draws = backend.draw_sweep(state.model, len(state.tree.edges()))
    sweep = functools.partial(backend._sweep_body, state.tree, state.model, 1.0, draws)
    cpu_be = CachedPartialsLikelihood(aln_p, device="cpu")
    t0 = time.perf_counter()
    cpu_be._sweep_body(state.tree, state.model, 1.0, draws).wait()
    cpu_ms = (time.perf_counter() - t0) * 1e3
    rows.append({"name": "param_sweep body", "source": "kgl_gene_tpu_torch/phylo/likelihood.py",
                 "replaces": "kgl_gene_tpu/phylo/likelihood.py:493 (scan :558)",
                 "launches": out["launches_sweep"], "shape": f"{n_taxa} taxa x {S} sites",
                 "ms": time_cuda(sweep, 5, windows=3), "device_ms": None, "cpu_ms": cpu_ms,
                 "bound_ms": tip_bytes / MEM_BYTES_PER_S * 1e3, "bound_by": "bytes"})
    prep = chain._prepare_full_iteration()
    (p1, perm1, ls_slot, h1, u1, pa, permA, newA, vlenA, hpA, u2a, pb, permB, newB, vlenB,
     hpB, u2b, _ra, _rb) = prep
    fdraws = backend.draw_sweep(state.model, len(state.tree.edges()))
    fdraws.u = np.append(fdraws.u, u1)
    fargs = (state.tree, state.model, 1.0, fdraws, p1.tree, perm1, ls_slot, h1,
             pa[0].tree if pa else None, permA, newA, vlenA, hpA, u2a,
             pb[0].tree if pb else None, permB, newB, vlenB, hpB, u2b)
    t0 = time.perf_counter()
    cpu_be._fiter_body(*fargs)[0].wait()
    cpu_ms = (time.perf_counter() - t0) * 1e3
    rows.append({"name": "full_iteration body", "source": "kgl_gene_tpu_torch/phylo/likelihood.py",
                 "replaces": "kgl_gene_tpu/phylo/likelihood.py:794 (scan :866)",
                 "launches": out["launches_fused_iteration"], "shape": f"{n_taxa} taxa x {S} sites",
                 "ms": time_cuda(lambda: backend._fiter_body(*fargs), 5, windows=3),
                 "device_ms": None, "cpu_ms": cpu_ms,
                 "bound_ms": tip_bytes / MEM_BYTES_PER_S * 1e3, "bound_by": "bytes"})
    for row in rows:
        row["x_bound"] = row["ms"] / row["bound_ms"]
        dev_ms = "" if row["device_ms"] is None else f", device {row['device_ms']:.4f} ms"
        cpu = "" if row["cpu_ms"] is None else f", CPU {row['cpu_ms']:.3f} ms"
        log(f"  {row['name']} ({row['shape']}): {row['ms']:.4f} ms host-inclusive{dev_ms}, "
            f"{row['launches']} launches, bound {row['bound_ms']:.4f} ms (bytes), "
            f"x{row['x_bound']:.0f}{cpu}")
    out["cuda_max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  device memory at most {out['cuda_max_memory_gb']:.3f} GB")
    return out, rows


def write_go_obo(path, seed=SEED):
    """A seeded OBO of GO's size and namespaces (GO_NAMESPACES), of a
    synthetic shape (no source; see GO_PARENTS): each non-root term has
    1-3 parents (GO_PARENTS) among the earlier terms of its namespace,
    drawn towards the most recent ones (GO_RECENT), the first an is_a and
    each other a part_of with probability GO_PART_OF. Returns the term ids
    by namespace, the root first."""
    rng = np.random.default_rng(seed)
    lines = ["format-version: 1.2", "ontology: go", ""]
    terms = {}
    next_id = 10_000  # above every root id
    for namespace, root, size, _aspect in GO_NAMESPACES:
        ids = [root] + [f"GO:{next_id + k:07d}" for k in range(size - 1)]
        next_id += size - 1
        n_par = rng.choice(len(GO_PARENTS), size=size, p=GO_PARENTS) + 1
        for t, tid in enumerate(ids):
            lines += ["[Term]", f"id: {tid}", f"name: {namespace} term {t}",
                      f"namespace: {namespace}"]
            if t:
                back = np.floor(t * rng.random(min(int(n_par[t]), t)) ** GO_RECENT)
                parents = np.unique(t - 1 - np.minimum(back.astype(np.int64), t - 1))
                for m, p in enumerate(parents):
                    if m and rng.random() < GO_PART_OF:
                        lines.append(f"relationship: part_of {ids[p]} ! {namespace} term {p}")
                    else:
                        lines.append(f"is_a: {ids[p]} ! {namespace} term {p}")
            lines.append("")
        terms[namespace] = ids
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return terms


def write_go_gaf(path, terms, seed=SEED):
    """A seeded GAF 2.2 of GO_GENES genes over write_go_obo's terms: 1-12
    annotations a gene, the namespace by GO_ASPECTS, the term by a Zipf
    skew (GO_ZIPF) over a seeded order of the namespace's non-root terms,
    a share GO_NOT of them NOT-qualified. Returns the gene ids in order."""
    rng = np.random.default_rng(seed + 1)
    pools = []
    for namespace, _root, _size, aspect in GO_NAMESPACES:
        pool = np.array(terms[namespace][1:])
        rng.shuffle(pool)
        weight = 1.0 / np.arange(1, len(pool) + 1) ** GO_ZIPF
        pools.append((aspect, pool, weight / weight.sum()))
    per_gene = rng.integers(1, 13, size=GO_GENES)
    total = int(per_gene.sum())
    space = rng.choice(len(pools), size=total, p=GO_ASPECTS)
    picks = np.empty(total, dtype=object)
    for code, (_aspect, pool, weight) in enumerate(pools):
        sel = space == code
        picks[sel] = pool[rng.choice(len(pool), size=int(sel.sum()), p=weight)]
    negated = rng.random(total) < GO_NOT
    evidence = rng.choice(["IEA", "IDA", "ISS", "IBA", "TAS"], size=total)
    genes = [f"PF3D7_{g:07d}" for g in range(GO_GENES)]
    lines = ["!gaf-version: 2.2"]
    for k, g in enumerate(np.repeat(np.arange(GO_GENES), per_gene)):
        gene = genes[g]
        lines.append("\t".join([
            "PlasmoDB", gene, gene, "NOT" if negated[k] else "", picks[k], "GO_REF:0000002",
            evidence[k], "", pools[space[k]][0], f"{gene} protein", "", "protein",
            "taxon:36329", "20240101", "PlasmoDB", "", ""]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return genes


def same_floats(name, got, want):
    """max |got - want| over float tensors; raises unless every value is
    equal (a selection of inputs: bit for bit)."""
    got, want = got.cpu(), want.cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch_equal(got, want):
        raise AssertionError(f"{name}: {int((got != want).sum())} entries differ, max abs err {err}")
    log(f"  {name}: equal ({got.numel()} values)")
    return err


def torch_equal(a, b):
    import torch

    return bool(torch.equal(a, b))


def mica_cases(dev, errs):
    """The MICA kernel against mica_plain on seeded ancestor lists: sorted
    rows at K = 64 and 192, IC-ordered rows at K = 100, one row, 257 rows,
    two different row sets (K 64 and 192), K = 1,000 (a smaller tile),
    rows of length 0, and lengths from 0 to K in one set (the local order),
    through the padded wrapper (rows_on_card) and through mica_rows on
    compact rows built on the host."""
    import torch

    from kgl_gene_tpu_torch.ops.similarity import mica, mica_plain, mica_rows, row_set

    rng = np.random.default_rng(SEED + 10)

    def lists(n, K, ic_order=False, lengths=None):
        ids = np.full((n, K), -1, np.int32)
        ic = np.zeros((n, K), np.float32)
        for r in range(n):
            L = int(rng.integers(0, K + 1)) if lengths is None else int(lengths[r])
            row = rng.choice(3 * K, L, replace=False).astype(np.int32)
            val = (rng.random(L) * 8).astype(np.float32)
            order = np.argsort(val)[::-1] if ic_order else np.argsort(row)
            ids[r, :L], ic[r, :L] = row[order], val[order]
        return torch.as_tensor(ids, device=dev), torch.as_tensor(ic, device=dev)

    for label, n, K, ic_order in (("K = 64, sorted", 300, 64, False),
                                  ("K = 192, sorted", 300, 192, False),
                                  ("K = 100, IC order", 300, 100, True),
                                  ("n = 1", 1, 64, False), ("n = 257", 257, 192, False),
                                  ("K = 1,000", 40, 1000, True)):
        ids, ic = lists(n, K, ic_order)
        got = mica(ids, ic)
        torch.cuda.synchronize()
        errs["mica"] = max(errs["mica"], same_floats(f"mica {label}, n = {n}",
                                                     got, mica_plain(ids, ic, ids, ic)))
    ids_i, ic_i = lists(200, 64)
    ids_j, ic_j = lists(333, 192, ic_order=True)
    got = mica(ids_i, ic_i, ids_j, ic_j)
    torch.cuda.synchronize()
    errs["mica"] = max(errs["mica"], same_floats(
        "mica i != j (200 x 64 against 333 x 192)", got, mica_plain(ids_i, ic_i, ids_j, ic_j)))
    # Lengths that vary widely in every tile (0, 1-3 and 150-256 mixed,
    # so the local order moves rows), a tenth of the rows empty.
    lengths = np.where(rng.random(700) < 0.5, rng.integers(0, 4, 700), rng.integers(150, 257, 700))
    lengths[rng.random(700) < 0.1] = 0
    ids, ic = lists(700, 256, lengths=lengths)
    got = mica(ids, ic)
    torch.cuda.synchronize()
    errs["mica"] = max(errs["mica"], same_floats(
        "mica lengths 0-3 and 150-256 mixed, 10% empty (n = 700, K = 256)", got,
        mica_plain(ids, ic, ids, ic)))
    empty = torch.full((70, 64), -1, dtype=torch.int32, device=dev)
    errs["mica"] = max(errs["mica"], same_floats(
        "mica every row empty (n = 70)", mica(empty, torch.zeros_like(empty, dtype=torch.float32)),
        torch.zeros(70, 70)))
    # mica_rows on compact rows made on the host, one and two row sets.
    ids_np, ic_np = ids.cpu().numpy(), ic.cpu().numpy()
    order = np.argsort(np.where(ids_np < 0, np.iinfo(np.int32).max, ids_np), axis=1, kind="stable")
    srt, val = np.take_along_axis(ids_np, order, 1), np.take_along_axis(ic_np, order, 1)
    offsets = np.r_[0, np.cumsum((srt >= 0).sum(1))]
    rows = row_set(offsets, srt[srt >= 0], val[srt >= 0], dev)
    errs["mica"] = max(errs["mica"], same_floats(
        "mica_rows on host-built rows (n = 700)", mica_rows(rows), mica_plain(ids, ic, ids, ic)))
    half = row_set(offsets[:301], srt[:300][srt[:300] >= 0], val[:300][srt[:300] >= 0], dev)
    errs["mica"] = max(errs["mica"], same_floats(
        "mica_rows i != j (300 against 700 rows)", mica_rows(half, rows),
        mica_plain(ids[:300], ic[:300], ids, ic)))


def mica_work(ids, dev, tile=MICA_TILE, rows=1024):
    """(merge steps of the least work, lane slots of the kernel's merge)
    for ancestor_lists' ids (-1 pads, any order), counted on `dev` in
    blocks of `rows` rows. A merge of two id-sorted lists ends with the
    list whose last id m is smaller, so a pair takes #ids_i <= m + #ids_j
    <= m - |common| steps, a match moving both; the least work merges each
    unordered pair once. The kernel (csrc/mica.cu) runs the upper triangle
    of tile x tile blocks, orders each tile's rows by (length, row), and a
    warp runs rounds of 8 x 4 neighbouring pairs of that order (min(8,
    tile) x min(4, tile)), each round as long as its longest pair at two
    steps a loop trip (ceil(steps / 2) trips): the slots are 32 lanes x 2
    steps x those trips, summed."""
    import torch

    t = torch.as_tensor(ids, device=dev).long()
    n = t.shape[0]
    valid = t >= 0
    key = t.masked_fill(~valid, torch.iinfo(torch.int64).max).sort(1).values
    lens = valid.sum(1)
    top = key.gather(1, (lens - 1).clamp(min=0)[:, None])[:, 0].masked_fill(lens == 0, -1)
    uniq, col = torch.unique(t[valid], return_inverse=True)
    member = torch.zeros(n, len(uniq), device=dev)
    member[valid.nonzero()[:, 0], col] = 1.0
    nt = -(-n // tile)
    npad = nt * tile
    si, sj = min(8, tile), min(4, tile)
    # The kernel's local order: each tile's rows by (length, row), rows past
    # n of length 0; order[q] is the row at place q (>= n: no row).
    at = torch.arange(npad, device=dev)
    lens_p = torch.zeros(npad, dtype=torch.long, device=dev)
    lens_p[:n] = lens
    order = torch.sort((at // tile) * (npad + 1) * tile + lens_p * tile + at % tile).indices
    real = order < n
    cols = order.clamp(max=n - 1)
    tj = torch.arange(nt, device=dev)
    rows = max(tile, rows // tile * tile)
    least = slots = 0
    for i0 in range(0, n, rows):
        i1 = min(n, i0 + rows)
        m = torch.minimum(top[i0:i1, None], top[None, :])
        steps = (torch.searchsorted(key[i0:i1], m, right=True)
                 + torch.searchsorted(key, m.T.contiguous(), right=True).T
                 - (member[i0:i1] @ member.T).round().long())
        least += int(steps.masked_fill(torch.arange(n, device=dev)[None]
                                       < torch.arange(i0, i1, device=dev)[:, None], 0).sum())
    for q0 in range(0, npad, rows):
        q1 = min(npad, q0 + rows)
        ri, rmask = cols[q0:q1], real[q0:q1]
        m = torch.minimum(top[ri, None], top[None, cols])
        steps = (torch.searchsorted(key[ri], m, right=True)
                 + torch.searchsorted(key[cols], m.T.contiguous(), right=True).T
                 - (member[ri] @ member[cols].T).round().long())
        trips = ((steps + 1) // 2).masked_fill(~(rmask[:, None] & real[None, :]), 0)
        rnd = trips.view(-1, tile // si, si, nt, tile // sj, sj).amax(dim=(2, 5)).sum(dim=(1, 3))
        ti = torch.arange(q0 // tile, q0 // tile + len(rnd), device=dev)
        slots += 2 * 32 * int(rnd.masked_fill(tj[None] < ti[:, None], 0).sum())
    return float(least), float(slots)


def phase_ontology(dev, workdir, errs):
    """Phase 3f: GAF annotation, the GO stack and the device MICA / Lin at
    GO's term count, on write_go_obo's synthetic shape. Returns (the ontology line's dict, the mica kernel row, the
    kernel's launches on the path)."""
    import torch

    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.ontology.annotation import TermAnnotation
    from kgl_gene_tpu_torch.ontology.database import OntologyDatabase
    from kgl_gene_tpu_torch.ontology.graph import GoGraph
    from kgl_gene_tpu_torch.ontology.information import InformationContent
    from kgl_gene_tpu_torch.ontology.obo import parse_go_file
    from kgl_gene_tpu_torch.ontology.similarity import SimilarityLin
    from kgl_gene_tpu_torch.ops.similarity import (
        ancestor_lists, ancestor_rows, lin_matrix_device, mica, mica_matrix_device,
        mica_plain, mica_rows, mica_smem_bytes, mica_tile, row_set,
    )

    torch.cuda.reset_peak_memory_stats()
    mica_cases(dev, errs)
    out = {}
    obo = os.path.join(workdir, "go.obo")
    gaf = os.path.join(workdir, "pf3d7.gaf")
    t0 = time.perf_counter()
    terms = write_go_obo(obo)
    genes = write_go_gaf(gaf, terms)
    out["generate_s"] = time.perf_counter() - t0

    kernels.reset_launches()
    t0 = time.perf_counter()
    records = parse_go_file(obo)
    out["parse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = GoGraph(records)
    anc = graph.ancestor_bitsets()
    out["closure_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    annotation = TermAnnotation.from_gaf_file(gaf, graph=graph)
    out["annotation_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info = InformationContent(graph, annotation)
    out["ic_s"] = time.perf_counter() - t0
    bp = annotation.all_terms("biological_process")[:GO_MAX_TERMS]
    idxs = np.array([graph.term_index(t) for t in bp])
    t0 = time.perf_counter()
    ids, vals = ancestor_lists(info, idxs)
    out["ancestor_lists_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lin = lin_matrix_device(info, bp, device=dev)
    out["lin_matrix_device_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mica_d = mica_matrix_device(info, idxs, device=dev)
    out["mica_matrix_device_s"] = time.perf_counter() - t0
    path_launches = kernels.LAUNCHES["mica"]
    n, K = ids.shape
    lens = (ids >= 0).sum(1)
    anc_counts = np.array([int(np.unpackbits(r.view(np.uint8)).sum()) for r in anc])
    out.update(shape_source="synthetic (write_go_obo, write_go_gaf); not checked against a "
                            "GO release or a Pf3D7 GAF",
               terms=len(graph), edges=int(sum(len(r.relations) for r in records)),
               part_of=int(sum(rel == "part_of" for r in records for rel, _t in r.relations)),
               max_depth=int(graph.depth_map().max()),
               longest_ancestors_all=int(anc_counts.max()),
               mean_ancestors_all=float(anc_counts.mean()),
               genes=len(annotation.all_genes()), gaf_genes=len(genes),
               annotated_bp_terms=len(annotation.all_terms("biological_process")),
               n=n, K=K, mean_ancestors=float(lens.mean()), longest_ancestors=int(lens.max()),
               launches_mica=path_launches)
    log(f"  {out['terms']} terms ({out['edges']} edges, {out['part_of']} part_of, depth "
        f"{out['max_depth']}, {out['mean_ancestors_all']:.1f} ancestors a term, at most "
        f"{out['longest_ancestors_all']}), {out['genes']} annotated genes of {out['gaf_genes']}; "
        f"n = {n} BP terms of {out['annotated_bp_terms']}, K = {K} (longest list "
        f"{out['longest_ancestors']}, mean {out['mean_ancestors']:.1f}); mica launches "
        f"{path_launches}")
    for key in ("generate_s", "parse_s", "closure_s", "annotation_s", "ic_s",
                "ancestor_lists_s", "lin_matrix_device_s", "mica_matrix_device_s"):
        log(f"  {key} {out[key]:.3f}")
    if path_launches < 1:
        raise AssertionError("the mica kernel never launched on the ontology path")
    if out["max_depth"] < 15 or K < 192:
        raise AssertionError("the generated ontology is shallower or narrower than asked")
    if not (np.isfinite(lin).all() and lin.min() >= 0.0 and lin.max() <= 1.0
            and np.array_equal(lin, lin.T)):
        raise AssertionError("lin_matrix_device: values outside [0, 1] or not symmetric")

    # The kernel's matrix against mica_plain on the same card tensors.
    ids_t = torch.as_tensor(ids, device=dev)
    ic_t = torch.as_tensor(vals, device=dev)
    got = mica(ids_t, ic_t)
    if not np.array_equal(got.cpu().numpy().astype(np.float64), mica_d):
        raise AssertionError("mica_matrix_device differs from the kernel's matrix")
    block = min(n, 2048)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = mica_plain(ids_t[:block], ic_t[:block], ids_t, ic_t)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    errs["mica"] = max(errs["mica"], same_floats(
        f"mica at n = {n}, K = {K}, rows 0-{block - 1}", got[:block], want))
    del want
    rows_held = block
    if block < n and plain_s * n / block <= MICA_PLAIN_LIMIT_S:
        t0 = time.perf_counter()
        want = mica_plain(ids_t[block:], ic_t[block:], ids_t, ic_t)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        errs["mica"] = max(errs["mica"], same_floats(
            f"mica at n = {n}, K = {K}, rows {block}-{n - 1}", got[block:], want))
        del want
        rows_held = n
    out.update(plain_rows_held=rows_held, plain_s=plain_s)
    log(f"  mica_plain on the card: {rows_held} x {n} rows in {plain_s:.2f} s"
        + ("" if rows_held == n else f" (the whole matrix would take over "
           f"{MICA_PLAIN_LIMIT_S:.0f} s: the first {rows_held} rows held)"))
    del got

    # Against the CPU run and the host path on 128 terms.
    sub = bp[:GO_HOST_TERMS]
    card = lin_matrix_device(info, sub, device=dev)
    cpu = lin_matrix_device(info, sub, device="cpu")
    if not np.array_equal(card, cpu):
        raise AssertionError("lin_matrix_device: the card differs from the CPU run")
    t0 = time.perf_counter()
    host = SimilarityLin(info).similarity_matrix(sub)
    out["host_lin_128_s"] = time.perf_counter() - t0
    out["lin_vs_host_max_abs"] = float(np.abs(card - host).max())
    log(f"  lin_matrix_device on {len(sub)} terms: card = CPU run; host path in "
        f"{out['host_lin_128_s']:.3f} s, max |card - host| {out['lin_vs_host_max_abs']:.3e}")
    if out["lin_vs_host_max_abs"] > 1e-6:
        raise AssertionError("lin_matrix_device is more than 1e-6 from the host path")

    # OntologyDatabase on the full OBO with the GAF cut to GO_DB_GENES genes.
    keep = set(genes[:GO_DB_GENES])
    gaf_cut = os.path.join(workdir, "pf3d7_cut.gaf")
    with open(gaf) as src, open(gaf_cut, "w") as dst:
        for line in src:
            if line.startswith("!") or line.split("\t", 2)[1] in keep:
                dst.write(line)
    t0 = time.perf_counter()
    db = OntologyDatabase("Pf3D7", obo, gaf_cut)
    if not db.self_test():
        raise AssertionError("OntologyDatabase.self_test failed")
    sample = db.annotation.all_genes()[:GO_DB_MATRIX]
    gm = db.gene_similarity_matrix(sample)
    out["database_s"] = time.perf_counter() - t0
    out["database_cache_terms"] = db.similarity_cache("biological_process").term_count()
    if gm.shape != (len(sample), len(sample)) or not np.isfinite(gm).all() \
            or not np.allclose(gm, gm.T):
        raise AssertionError("gene_similarity_matrix: bad shape, values or symmetry")
    log(f"  OntologyDatabase ({GO_DB_GENES} genes, the one cut): self_test ok, "
        f"{len(sample)} x {len(sample)} gene matrix over a cache of "
        f"{out['database_cache_terms']} BP terms in {out['database_s']:.2f} s")

    # Times of the kernel at the path's shape: on the compact rows the path
    # builds (ancestor_rows), and through the padded wrapper (rows_on_card
    # first) in the same windows.
    t0 = time.perf_counter()
    offsets, r_ids, r_ic = ancestor_rows(info, idxs)
    out["ancestor_rows_s"] = time.perf_counter() - t0
    rows = row_set(offsets, r_ids, r_ic, dev)
    errs["mica"] = max(errs["mica"], same_floats(
        f"mica_rows on the path's rows vs the padded wrapper (n = {n})", mica_rows(rows),
        mica(ids_t, ic_t)))
    call = functools.partial(mica_rows, rows)
    padded = functools.partial(mica, ids_t, ic_t)
    ms, padded_ms = time_cuda_turns([call, padded], 5, windows=3)
    device_ms = time_device([call], 5, windows=3)
    least, slots = mica_work(ids, dev)
    # The step's instructions go to several pipes (shared loads, integer
    # compares and selects, a float min and max, moves), so both counts are
    # priced at the rate an SM dispatches instructions of any pipe.
    rate = issue_rate(DISPATCH_LANES_PER_SM)
    lib = kernels.library()
    tile, entries = mica_tile(offsets, offsets, True)
    byte_ms = (ids.nbytes + vals.nbytes + 4 * n * n) / MEM_BYTES_PER_S * 1e3
    issue_ms = least * MICA_STEP_OPS / rate * 1e3
    out.update(kernel_ms=ms, kernel_device_ms=device_ms, padded_wrapper_ms=padded_ms,
               plain_ms=plain_s * 1e3, bytes_bound_ms=byte_ms, merge_issue_bound_ms=issue_ms,
               merge_steps=least, design_merge_lane_slots=slots, lane_slot_ratio=slots / least,
               design_issue_ms=slots * MICA_MERGE_OPS / rate * 1e3,
               tile=tile, tile_entries=entries, smem_bytes=mica_smem_bytes(tile, entries),
               blocks_per_sm=lib.kgt_mica_occupancy(tile, entries),
               cuda_max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  mica kernel n = {n}, K = {K}: {ms:.4f} ms host-inclusive, device {device_ms:.4f} ms; "
        f"the padded wrapper {padded_ms:.4f} ms; bounds: bytes {byte_ms:.4f} ms, merge issue "
        f"{issue_ms:.4f} ms ({least:.4g} steps x {MICA_STEP_OPS} at {rate / 1e12:.3f} T/s, "
        f"{DISPATCH_LANES_PER_SM} lanes x SMs x max SM clock); the design's count "
        f"{out['design_issue_ms']:.4f} ms ({slots:.4g} lane slots, {slots / least:.3f} x the "
        f"steps, x {MICA_MERGE_OPS}); tile {tile}, {entries} entries, "
        f"{out['smem_bytes']} B of shared memory, {out['blocks_per_sm']} blocks an SM; device "
        f"memory at most "
        f"{out['cuda_max_memory_gb']:.3f} GB")
    # Rows out of id order at the same scale: lists cut to the top 64 by
    # IC, each cut row in descending IC order, sorted by the wrapper.
    cut_ids, cut_vals = ancestor_lists(info, idxs, max_ancestors=64)
    cut_t = (torch.as_tensor(cut_ids, device=dev), torch.as_tensor(cut_vals, device=dev))
    rows_cut = min(n, 1024)
    got = mica(*cut_t)
    errs["mica"] = max(errs["mica"], same_floats(
        f"mica truncated to 64 ancestors, rows 0-{rows_cut - 1}", got[:rows_cut],
        mica_plain(cut_t[0][:rows_cut], cut_t[1][:rows_cut], *cut_t)))
    del got
    _least, cut_slots = mica_work(cut_ids, dev)
    out.update(cut64_kernel_ms=time_cuda(functools.partial(mica, *cut_t), 5, windows=3),
               cut64_rows_out_of_order=int(((np.diff(cut_ids, axis=1) <= 0)
                                            & (cut_ids[:, 1:] >= 0)).any(1).sum()),
               cut64_design_issue_ms=cut_slots * MICA_MERGE_OPS / rate * 1e3)
    log(f"  mica kernel on the lists cut to 64 ({out['cut64_rows_out_of_order']} rows out of "
        f"id order): {out['cut64_kernel_ms']:.4f} ms host-inclusive, the design's count "
        f"{out['cut64_design_issue_ms']:.4f} ms")
    row = {"name": "mica", "route": "cuda", "source": "kgl_gene_tpu_torch/csrc/mica.cu",
           "replaces": "kgl_gene_tpu/ops/similarity.py:67 (_mica_tile; _mica_tile_chunked :77, "
                       "fori_loop :99)",
           "shape": f"n = {n}, K = {K}", "ms": ms, "device_ms": device_ms,
           "plain_ms": plain_s * 1e3, "plain_rows": rows_held,
           "bound_ms": max(byte_ms, issue_ms),
           "bound_by": "operations" if issue_ms >= byte_ms else "bytes",
           "library_ms": None, "issue_bound_ms": issue_ms,
           "design_issue_ms": out["design_issue_ms"], "lane_slot_ratio": slots / least,
           "blocks_per_sm": out["blocks_per_sm"], "padded_wrapper_ms": padded_ms}
    return out, row, path_launches



# --------------------------------------------------------------------------- #
# Phase 3h: the application shell, one runtime XML with the nine analyses
# --------------------------------------------------------------------------- #
# Gene descriptions that put two of phase 3c's genes into PfEMP's families
# (kgl_gene_tpu_torch/analysis/pfemp_analysis.py PF_GENE_FAMILIES).
PACKAGE_FAMILIES = {"G1": "rifin", "G2": "stevor"}
PACKAGE_PMIDS = 40           # publications in the generated bioPMID / dbSNP / PubMed cache
PACKAGE_CITED_EVERY = 10     # one record in ten has a dbSNP citation
PACKAGE_DISTANCE_SAMPLES = 32  # samples of the Pf7 distance matrix
PACKAGE_CPU_GENES = "G0"     # the CPU run's PfSEQUENCE GeneList
PACKAGE_ANALYSES = ("NULL", "INTERVAL", "INFO_FILTER", "INBREED", "PfSEQUENCE", "PfEMP",
                    "MUTATION", "PARSEJSON", "LITERATURE")
PACKAGE_GO = ("GO:0008150", "GO:0009987", "GO:0008152", "GO:0003674", "GO:0005488")


def _pubmed_efetch_xml(pmid, rng):
    year, month = 2000 + int(rng.integers(0, 24)), ("Jan", "Mar", "Jun", "Oct")[pmid % 4]
    authors = "".join(f"<Author><LastName>Author{int(a)}</LastName><Initials>A</Initials>"
                      "</Author>" for a in rng.choice(12, 2, replace=False))
    return (f'<PubmedArticleSet><PubmedArticle><MedlineCitation>'
            f'<PMID Version="1">{pmid}</PMID><Article><Journal><JournalIssue>'
            f'<Volume>{pmid % 50}</Volume><Issue>{pmid % 7}</Issue><PubDate><Year>{year}</Year>'
            f'<Month>{month}</Month></PubDate></JournalIssue><Title>Journal {pmid % 5}</Title>'
            f'</Journal><ArticleTitle>Synthetic study {pmid} of gene families.</ArticleTitle>'
            f'<AuthorList>{authors}</AuthorList></Article></MedlineCitation>'
            f'</PubmedArticle></PubmedArticleSet>\n')


def write_package_inputs(workdir, paths, seed=SEED):
    """Phase 3h's inputs beside a generate_population_files triple `paths`:
    the GFF3 with two genes described as PfEMP families, a GAF and a small
    OBO over its genes, a PED genealogy and a genome-aux table of its
    samples, allele citations and a dbSNP JSON over every
    PACKAGE_CITED_EVERY-th record, Pf7 sample metadata (about three in four
    QC pass), FWS values and a distance matrix over the first
    PACKAGE_DISTANCE_SAMPLES samples, bioPMID and Entrez tables for the
    genes, and a PubMed cache directory holding every publication these
    name and its citations, so that no lookup needs the network (records
    without an XML declaration, which the JAX package's cache reader reads
    past its first record only where they have none). Returns the paths by
    name."""
    from kgl_gene_tpu_torch.analysis.mutation_analysis import SUPER_POPS
    from kgl_gene_tpu_torch.literature.pubmed import CITATION_CACHE, PUBLICATION_CACHE

    rng = np.random.default_rng(seed)
    out = {"fasta": paths.fasta, "vcf": paths.vcf}
    samples = [f"S{i:04d}" for i in range(paths.n_samples)]
    genes = [f"G{g}" for g in range(paths.n_genes)]
    pmids = [30_000_001 + i for i in range(PACKAGE_PMIDS)]

    def write(name, text):
        out[name] = os.path.join(workdir, name)
        with open(out[name], "w") as f:
            f.write(text)

    with open(paths.gff3) as f:
        gff = []
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) == 9 and cols[2] == "gene":
                gid = cols[8].split("ID=")[1].split(";")[0]
                if gid in PACKAGE_FAMILIES:
                    cols[8] += f";description={PACKAGE_FAMILIES[gid]}"
            gff.append("\t".join(cols))
    write("package.gff3", "\n".join(gff) + "\n")
    write("package.obo", "".join(
        f"[Term]\nid: {go}\nnamespace: "
        f"{'molecular_function' if go in PACKAGE_GO[3:] else 'biological_process'}\n"
        + (f"is_a: {PACKAGE_GO[0 if i < 3 else 3]}\n" if i not in (0, 3) else "") + "\n"
        for i, go in enumerate(PACKAGE_GO)))
    write("package.gaf", "!gaf-version: 2.1\n" + "".join(
        "\t".join(["SYN", g, g, "", go, "PMID:1", "IEA", "", "F" if go in PACKAGE_GO[3:] else "P",
                   "", "", "protein", "taxon:5833", "20240101", "SYN"]) + "\n"
        for g in genes for go in rng.choice(PACKAGE_GO, 2, replace=False)))
    pops = rng.choice(SUPER_POPS, len(samples))
    sexes = rng.integers(1, 3, len(samples))
    write("genealogy.ped", "Family\tIndividual\tPaternal\tMaternal\tSex\tPheno\tPopulation\t"
          "PopDesc\n" + "".join(f"F{i // 4}\t{s}\t0\t0\t{sex}\t0\t{p}_sub\td\n"
                                for i, (s, sex, p) in enumerate(zip(samples, sexes, pops))))
    write("genome_aux.tsv", "Individual\tSex\tPopulation\tPopDesc\tSuperPopulation\tSuperDesc\n"
          + "".join(f"{s}\t{'male' if sex == 1 else 'female'}\t{p}_sub\td\t{p}\td\n"
                    for s, sex, p in zip(samples, sexes, pops)))
    cited = range(0, paths.n_records, PACKAGE_CITED_EVERY)
    cites = {r: sorted(rng.choice(pmids, int(rng.integers(1, 4)), replace=False).tolist())
             for r in cited}
    write("citations.tsv", "".join(f"rs{r}\t{p}\n" for r, ps in cites.items() for p in ps))
    write("dbsnp.json", "".join(json.dumps({"refsnp_id": str(r), "citations": ps}) + "\n"
                                for r, ps in cites.items()))
    qc = rng.random(len(samples)) < 0.75
    lat, lon = rng.uniform(-15, 15, len(samples)), rng.uniform(-15, 40, len(samples))
    write("pf7_samples.tsv", "Sample\tStudy\tCountry\tSite\tclat\tclon\tlat\tlon\tYear\tENA\t"
          "All\tPopulation\tCallable\tQC pass\tFail reason\tType\tInPf6\n" + "".join(
              f"{s}\tst\tC{i % 9}\tL{i % 17}\t0\t0\t{lat[i]:.4f}\t{lon[i]:.4f}\t2019\tE{i}\tT\t"
              f"AF\t0.9\t{'True' if qc[i] else 'False'}\t{'' if qc[i] else 'low'}\tWGS\tF\n"
              for i, s in enumerate(samples)))
    write("pf7_fws.tsv", "Sample\tFWS\n" + "".join(
        f"{s}\t{v:.4f}\n" for s, v in zip(samples, rng.uniform(0.5, 1.0, len(samples)))))
    m = PACKAGE_DISTANCE_SAMPLES
    dist = rng.uniform(0, 0.3, (m, m))
    dist = np.triu(dist, 1) + np.triu(dist, 1).T
    write("pf7_distance_ids.tsv", "".join(f"{s}\n" for s in samples[:m]))
    write("pf7_distance.tsv", "".join("\t".join(f"{v:.5f}" for v in row) + "\n" for row in dist))
    entrez = {g: str(7_000 + i) for i, g in enumerate(genes)}
    write("entrez.tsv", "Symbol\tEntrez\n" + "".join(f"{g}\t{e}\n" for g, e in entrez.items()))
    write("biopmid.tsv", "".join(
        f"{p}\tGene\t{entrez[g]}\n" for g in genes
        for p in rng.choice(pmids, 5, replace=False).tolist()) + f"{pmids[0]}\tDisease\tD001\n")
    cache = os.path.join(workdir, "pubmed_cache")
    os.makedirs(cache, exist_ok=True)
    out["pubmed_cache"] = cache
    with open(os.path.join(cache, PUBLICATION_CACHE), "w") as f:
        for p in pmids:
            f.write(_pubmed_efetch_xml(p, rng) + "\n<!--CACHE-RECORD-->\n")
    with open(os.path.join(cache, CITATION_CACHE), "w") as f:
        for p in pmids:
            cited_by = "".join(f"<Link><Id>{c}</Id></Link>"
                               for c in rng.choice(pmids, int(rng.integers(0, 6)), replace=False))
            f.write(f'<eLinkResult><LinkSet><IdList><Id>{p}</Id></IdList>'
                    f'<LinkSetDb><LinkName>pubmed_pubmed_citedin</LinkName>{cited_by}'
                    f'</LinkSetDb></LinkSet></eLinkResult>\n<!--CACHE-RECORD-->\n')
    out["genes"] = genes
    return out


def write_package_xml(path, inputs, work_dir, gene_list=None):
    """A runtime XML with the nine analyses in two packages: the VCF's
    (NULL, INTERVAL, INFO_FILTER, INBREED, PfSEQUENCE, PfEMP, MUTATION, on
    the genome, ontology, genealogy, genome-aux, citation and Pf7
    resources) and the dbSNP JSON's (NULL, PARSEJSON, LITERATURE, on the
    bioPMID, Entrez and PubMed resources). `gene_list` names PfSEQUENCE's
    genes (all protein-coding genes when None)."""
    from xml.sax.saxutils import escape

    def resource(rtype, ident, **params):
        return (f"<resource><resourceType>{rtype}</resourceType><resourceIdent>{ident}"
                f"</resourceIdent>" + "".join(f"<{k}>{escape(v)}</{k}>" for k, v in params.items())
                + "</resource>")

    def block(name, **params):
        return (f"<parameterBlock><blockName>{name}</blockName>" + "".join(
            f"<parameter><name>{k}</name><value>{escape(v)}</value></parameter>"
            for k, v in params.items()) + "</parameterBlock>")

    def package(ident, resources, files, analyses):
        return (f"<package><packageIdent>{ident}</packageIdent><resourceList>"
                + "".join(f"<resourceIdent>{r}</resourceIdent>" for r in resources)
                + "</resourceList><iterationList><iteration>"
                + "".join(f"<fileIdent>{f}</fileIdent>" for f in files)
                + "</iteration></iterationList><analysisList>"
                + "".join(f"<analysisIdent>{a}</analysisIdent>" for a in analyses)
                + "</analysisList></package>")

    seq = dict(DistanceMetric="GLOBAL", **({"GeneList": gene_list} if gene_list else {}))
    xml = (
        f'<?xml version="1.0"?>\n<runTime><workDirectory>{escape(work_dir)}</workDirectory>'
        "<executeList><active>vcfPackage</active><active>literaturePackage</active></executeList>"
        "<packageList>"
        + package("vcfPackage", ["genome", "ontology", "genealogy", "genomeAux", "citations",
                                 "pf7Sample", "pf7Fws", "pf7Distance"], ["popVCF"],
                  ["NULL", "INTERVAL", "INFO_FILTER", "INBREED", "PfSEQUENCE", "PfEMP",
                   "MUTATION"])
        + package("literaturePackage", ["bioPMID", "entrez", "pubmed"], ["dbsnpJSON"],
                  ["NULL", "PARSEJSON", "LITERATURE"])
        + "</packageList><analysisList>"
        + "".join(f"<analysis><analysisIdent>{a}</analysisIdent><parameterIdent>{b}"
                  "</parameterIdent></analysis>"
                  for a, b in (("INTERVAL", "intervalParams"), ("INBREED", "inbreedParams"),
                               ("PfSEQUENCE", "seqParams"), ("LITERATURE", "litParams")))
        + "</analysisList><parameterList>"
        + block("intervalParams", IntervalSize="1000")
        + block("inbreedParams", Algorithm="ALL", AnalysisType="Inbreed")
        + block("seqParams", **seq)
        + block("litParams", GeneList=",".join(inputs["genes"]))
        + "</parameterList><dataFileList>"
        + f"<dataFile><fileIdent>popVCF</fileIdent><fileName>{escape(inputs['vcf'])}</fileName>"
          "<parser>PF_DIPLOID</parser><evidenceIdent>vcfEvidence</evidenceIdent></dataFile>"
        + f"<dataFile><fileIdent>dbsnpJSON</fileIdent><fileName>{escape(inputs['dbsnp.json'])}"
          "</fileName><parser>JSON_DBSNP</parser></dataFile>"
        + "</dataFileList><resourceList>"
        + resource("GenomeDatabase", "genome", fastaFile=inputs["fasta"],
                   gffFile=inputs["package.gff3"], gafFile=inputs["package.gaf"])
        + resource("OntologyDatabase", "ontology", goFile=inputs["package.obo"],
                   annotationFile=inputs["package.gaf"])
        + resource("Genealogy", "genealogy", file=inputs["genealogy.ped"])
        + resource("GenomeAux", "genomeAux", file=inputs["genome_aux.tsv"])
        + resource("Citation", "citations", file=inputs["citations.tsv"])
        + resource("Pf7Sample", "pf7Sample", file=inputs["pf7_samples.tsv"])
        + resource("Pf7Fws", "pf7Fws", file=inputs["pf7_fws.tsv"])
        + resource("Pf7Distance", "pf7Distance", matrixFile=inputs["pf7_distance.tsv"],
                   sampleFile=inputs["pf7_distance_ids.tsv"])
        + resource("BioPMID", "bioPMID", file=inputs["biopmid.tsv"])
        + resource("Entrez", "entrez", file=inputs["entrez.tsv"])
        + resource("PubmedAPI", "pubmed", cacheDirectory=inputs["pubmed_cache"])
        + "</resourceList><evidenceList><evidence><evidenceIdent>vcfEvidence</evidenceIdent>"
          "<vcfInfoList><infoIdent>AF</infoIdent></vcfInfoList></evidence></evidenceList>"
          "</runTime>\n")
    with open(path, "w") as f:
        f.write(xml)
    return path


class AnalysisClock:
    """Host seconds of each registered analysis's four lifecycle calls, by
    ident, while the block runs (the classes' methods wrapped, then put
    back)."""

    METHODS = ("initialize_analysis", "file_read_analysis", "iteration_analysis",
               "finalize_analysis")

    def __enter__(self):
        from kgl_gene_tpu_torch.analysis import registered  # noqa: F401 - fills the registry
        from kgl_gene_tpu_torch.app import analysis as app_analysis

        self.seconds = {}
        self._saved = []
        for ident, cls in app_analysis._REGISTRY.items():
            for name in self.METHODS:
                own = vars(cls).get(name)
                self._saved.append((cls, name, own))

                def timed(*args, _fn=getattr(cls, name), _ident=ident, **kwargs):
                    t0 = time.perf_counter()
                    try:
                        return _fn(*args, **kwargs)
                    finally:
                        self.seconds[_ident] = (self.seconds.get(_ident, 0.0)
                                                + time.perf_counter() - t0)

                setattr(cls, name, timed)
        return self

    def __exit__(self, *exc):
        for cls, name, own in self._saved:
            if own is None:
                delattr(cls, name)
            else:
                setattr(cls, name, own)


class NoNetwork:
    """Counts and refuses every urllib request while the block runs."""

    def __enter__(self):
        import urllib.request

        self.requests = 0
        self._orig = urllib.request.urlopen

        def refuse(*args, **kwargs):
            self.requests += 1
            raise OSError("phase 3h: no request may leave the machine")

        urllib.request.urlopen = refuse
        return self

    def __exit__(self, *exc):
        import urllib.request

        urllib.request.urlopen = self._orig


class BandedCpuTree:
    """While the block runs, TranscriptFamilyAnalysis's all-pairs matrix on
    the CPU takes the card's exact route (B1's plain version at band 127
    and the exact re-run of the pairs outside it) instead of the plain
    exact wavefront, which takes tens of minutes over 32,640 pairs of
    3 kb there: both routes are exact, so the matrix and the tree are the
    same (lib_seqmutation.distance_tree_newick)."""

    def __enter__(self):
        from kgl_gene_tpu_torch.analysis import lib_seqmutation

        self._mod, self._orig = lib_seqmutation, lib_seqmutation.pairwise_distance_matrix
        self.calls = 0

        def banded(seqs, lens, band_k=None, device=None, metric="global"):
            self.calls += 1
            if band_k is None and metric == "global":
                band_k = 127
            return self._orig(seqs, lens, band_k=band_k, device=device, metric=metric)

        lib_seqmutation.pairwise_distance_matrix = banded
        return self

    def __exit__(self, *exc):
        self._mod.pairwise_distance_matrix = self._orig


def same_package_file(name, got_path, want_path):
    """One output file of the card run against the CPU run's: text byte for
    byte, the F columns of inbreeding.csv within ESTIMATOR_ATOL. Returns
    the largest F difference."""
    with open(got_path) as f:
        got = f.read().splitlines()
    with open(want_path) as f:
        want = f.read().splitlines()
    if name != "inbreeding.csv":
        if got != want:
            raise AssertionError(f"phase 3h: {name} differs between the card and the CPU run")
        return 0.0
    if len(got) != len(want) or got[:1] != want[:1]:
        raise AssertionError("phase 3h: inbreeding.csv differs in shape or header")
    header, worst = got[0].split(","), 0.0
    for g_line, w_line in zip(got[1:], want[1:]):
        for col, g, w in zip(header, g_line.split(","), w_line.split(",")):
            if col in ESTIMATOR_ATOL:
                diff = abs(float(g) - float(w))
                worst = max(worst, diff)
                if diff > ESTIMATOR_ATOL[col]:
                    raise AssertionError(f"phase 3h: {col} {g} vs {w} beyond "
                                         f"{ESTIMATOR_ATOL[col]}")
            elif g != w:
                raise AssertionError(f"phase 3h: inbreeding.csv {col} {g} vs {w}")
    return worst


def run_package(xml, work_dir, device):
    """run_application(GeneExecEnv, ...) on the XML; (return code, the
    executor, host seconds by analysis, wall seconds, requests)."""
    from kgl_gene_tpu_torch.app.exec_env import GeneExecEnv, run_application

    apps = []

    class Probe(GeneExecEnv):
        def __init__(self):
            super().__init__()
            apps.append(self)

    t0 = time.perf_counter()
    with AnalysisClock() as clock, NoNetwork() as net:
        rc = run_application(Probe, ["--optionFile", xml, "--workDirectory", work_dir,
                                     "--device", device])
    return rc, apps[0].executor, clock.seconds, time.perf_counter() - t0, net.requests


def phase_package(dev, workdir):
    """Phase 3h: the application shell as a user runs it,
    `python -m kgl_gene_tpu_torch.app.exec_env --optionFile runtime.xml
    --device cuda`, through run_application, on phase 3c's synthetic
    FASTA/GFF3/VCF (256 samples, four genes of 3,000 coding bases, 3,000
    records with indels) and write_package_inputs' resources: one XML with
    the nine analyses, counts from 0. It fails unless the run returns 0,
    no analysis is dropped, kernels B1 and B2 launch, no request leaves the
    machine, and every file of the port's CPU run of the same XML (its
    PfSEQUENCE naming PACKAGE_CPU_GENES, its tree through BandedCpuTree)
    equals the card's (inbreeding.csv's F within ESTIMATOR_ATOL). Returns
    the {"package": ...} record."""
    import torch

    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.io.synthetic import generate_population_files

    t0 = time.perf_counter()
    paths = generate_population_files(workdir, **PRODUCT)
    inputs = write_package_inputs(workdir, paths)
    card_dir, cpu_dir = os.path.join(workdir, "work_card"), os.path.join(workdir, "work_cpu")
    xml = write_package_xml(os.path.join(workdir, "runtime.xml"), inputs, card_dir)
    cpu_xml = write_package_xml(os.path.join(workdir, "runtime_cpu.xml"), inputs, cpu_dir,
                                gene_list=PACKAGE_CPU_GENES)
    inputs_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    kernels.reset_launches()
    rc, executor, seconds, wall_s, requests = run_package(xml, card_dir, "cuda")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"  package run on the card: rc {rc}, {wall_s:.2f} s, launches {launches}, "
        f"dropped {executor.dropped if executor else None}, requests {requests}")
    if rc != 0 or executor is None:
        raise AssertionError(f"phase 3h: run_application returned {rc}")
    if executor.dropped:
        raise AssertionError(f"phase 3h: analyses dropped: {executor.dropped}")
    if executor.device != dev:
        raise AssertionError(f"phase 3h: the package ran on {executor.device}")
    for name in ("myers", "translate"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"phase 3h: kernel {name} never launched")
    if requests:
        raise AssertionError(f"phase 3h: {requests} requests tried to leave the machine")
    if set(seconds) != set(PACKAGE_ANALYSES):
        raise AssertionError(f"phase 3h: analyses that ran: {sorted(seconds)}")
    card_files = sorted(os.listdir(card_dir))

    with BandedCpuTree() as tree:
        rc_cpu, cpu_exec, cpu_seconds, cpu_wall_s, cpu_requests = run_package(
            cpu_xml, cpu_dir, "cpu")
    if rc_cpu != 0 or cpu_exec.dropped or cpu_requests:
        raise AssertionError(f"phase 3h: the CPU run: rc {rc_cpu}, dropped {cpu_exec.dropped}, "
                             f"requests {cpu_requests}")
    cpu_files = sorted(os.listdir(cpu_dir))
    if not set(cpu_files) <= set(card_files):
        raise AssertionError(f"phase 3h: files only the CPU run wrote: "
                             f"{sorted(set(cpu_files) - set(card_files))}")
    worst_f = max(same_package_file(name, os.path.join(card_dir, name),
                                    os.path.join(cpu_dir, name)) for name in cpu_files)
    with open(os.path.join(card_dir, "gene_literature.csv")) as f:
        rows = f.read().splitlines()[1:]
    if not rows or any(not row.split(",", 3)[3] for row in rows):
        raise AssertionError("phase 3h: a publication was not served from the PubMed cache")
    expected = {"interval_density.csv", "info_field_stats.csv", "inbreeding.csv",
                "pfemp_zygosity.csv", "pfemp_fws.csv", "pfemp_distance_compare.csv",
                "gene_mutation.csv", "gene_allele.csv", "allele_citations.csv",
                "gene_literature.csv", "literature_authors.csv"}
    expected |= {f"sequence_{g}_{g}.1.{ext}" for g in inputs["genes"] for ext in ("csv", "nwk")}
    expected |= {f"pfemp_{fam.upper()}_{g}.1.csv" for g, fam in PACKAGE_FAMILIES.items()}
    if not expected <= set(card_files):
        raise AssertionError(f"phase 3h: missing outputs {sorted(expected - set(card_files))}")
    only_card = sorted(set(card_files) - set(cpu_files))
    log(f"  CPU run (PfSEQUENCE GeneList {PACKAGE_CPU_GENES}, its tree through band 127 on the "
        f"CPU, {tree.calls} matrices): {cpu_wall_s:.2f} s; {len(cpu_files)} of {len(card_files)} "
        f"files compared, every one equal (largest F difference {worst_f:.3g}); card only: "
        f"{only_card}")
    return {
        "xml_analyses": len(PACKAGE_ANALYSES), "packages": len(executor.runtime.active_packages),
        "device": str(executor.device), "wall_s": wall_s,
        "analysis_s": {k: round(v, 4) for k, v in sorted(seconds.items())},
        "files": len(card_files), "files_compared": len(cpu_files), "launches": launches,
        "cpu_genes": PACKAGE_CPU_GENES, "cpu_wall_s": cpu_wall_s,
        "cpu_analysis_s": {k: round(v, 4) for k, v in sorted(cpu_seconds.items())},
        "largest_f_difference": worst_f, "inputs_s": inputs_s, "requests": requests,
    }


# Phase 3i: the multi-device forms (parallel/dist.py, parallel/mesh.py,
# make_multichip_step / make_multichip_indel_step, ops/sharded_wavefront.py).
MULTI_STEP_B = 4_096
MULTI_STEP_K = 48
MULTI_INDEL = dict(B=256, K=12, A=4, band_k=63)
MULTI_WINDOW = (1_000, 10_000)       # genomes x loci of the sharded estimators
MULTI_STREAMED = (1_000, 1 << 18)    # genomes x variants of the streamed CSR
MULTI_STREAMED_BLOCK = 1 << 16       # variants a streamed block: four blocks
MULTI_LONG = (32_768, 49_152)        # the long pairs; 49,152 > B3's MAX_KERNEL_LEN
MULTI_LONG_EDITS = (300, 40)         # substitutions, deletions of the long pairs
MULTI_HALO = 128
MULTI_TIMEOUT_S = 600.0              # each spawn's deadline
MULTI_STEP_WINDOWS = 5               # timed windows of each step, in turns
MULTI_STEP_ITERS = 3                 # calls a window
# (lengths of a, lengths of b) of the chunk kernel's cases against its plain
# version: ragged pairs from empty to a few thousand bases.
CHUNK_CASES = (((257, 100, 31, 1, 0, 3_000, 2_500), (190, 211, 257, 0, 5, 2_990, 2_600)),
               ((4_000,), (3_993,)))
CHUNK_HALOS = (32, 128, 600, 1_024)  # 600 and 1,024: past one launch's 512 diagonals
CHUNK_RUN = 8                         # chunks of the cooperative route's timed launch


def long_pair(rng, n, n_sub, n_del):
    """A pair of n bases: b is a with n_sub substitutions and n_del
    deletions, both padded to width n."""
    a = rng.integers(0, 4, n)
    b = a.copy()
    idx = rng.choice(n, n_sub, replace=False)
    b[idx] = (b[idx] + 1 + rng.integers(0, 3, n_sub)) % 4
    b = np.delete(b, rng.choice(n, n_del, replace=False))
    seq = np.zeros((2, n), np.int32)
    seq[0], seq[1, : len(b)] = a, b
    return seq[:1], np.array([n], np.int32), seq[1:], np.array([len(b)], np.int32)


def simulate_ranks(seq_a, la, seq_b, lb, world, halo, dev, step):
    """sharded_levenshtein's ranks in this process, in lock step, the ring
    exchange by hand: (the summed result, the last rank lanes)."""
    import torch

    from kgl_gene_tpu_torch.ops import sharded_wavefront as sw

    states = [sw.rank_lanes(seq_a, la, seq_b, lb, r, world, halo, dev) for r in range(world)]
    for c in range(states[0].n_chunks):
        states = [sw.run_chunk(s, c, step) for s in states]
        if world > 1:
            sends = [sw.halo_lanes(s) for s in states]
            for r, s in enumerate(states):
                sw.refresh_halo(s, sends[(r - 1) % world])
    torch.cuda.synchronize()
    return sum(s.result for s in states), states


def chunk_kernel_cases(dev, errs):
    """Kernel wavefront_chunk against chunk_plain (exact) on ragged pairs
    up to a few thousand bases, halos 32 and 128 and the halos past one
    launch's 512 diagonals (600 and 1,024: two launches a chunk), worlds
    1 and 2 (the ranks simulated in this process): the distances, every
    rank's last lanes, and the numpy DP. At world 1 and halos to 512 the
    cooperative route too, in two runs of chunks, bit for bit against the
    launches a chunk."""
    import torch

    from kgl_gene_tpu_torch.ops import sharded_wavefront as sw
    from kgl_gene_tpu_torch.ops.edit_distance import levenshtein_numpy

    rng = np.random.default_rng(SEED + 14)
    for a_lens, b_lens in CHUNK_CASES:
        a_rows = [rng.integers(0, 4, n) for n in a_lens]
        b_rows = [rng.integers(0, 4, n) for n in b_lens]
        sa = np.zeros((len(a_rows), max(a_lens)), np.int32)
        sb = np.zeros((len(b_rows), max(b_lens)), np.int32)
        for i, (a, b) in enumerate(zip(a_rows, b_rows)):
            sa[i, : len(a)], sb[i, : len(b)] = a, b
        la, lb = np.array(a_lens, np.int32), np.array(b_lens, np.int32)
        want = torch.as_tensor([levenshtein_numpy(a, b) for a, b in zip(a_rows, b_rows)])
        for world in (1, 2):
            for halo in CHUNK_HALOS:
                tag = f"lengths to {max(a_lens)}, world {world}, halo {halo}"
                got, k_states = simulate_ranks(sa, la, sb, lb, world, halo, dev, sw.chunk)
                plain, p_states = simulate_ranks(sa, la, sb, lb, world, halo, dev,
                                                 sw.chunk_plain)
                err = exact(f"wavefront_chunk vs chunk_plain, distances ({tag})", got, plain)
                for r, (ks, ps) in enumerate(zip(k_states, p_states)):
                    err = max(err, exact(f"  rank {r}'s owned lanes", ks.p[:, ks.H:],
                                         ps.p[:, ps.H:]),
                              exact(f"  rank {r}'s lanes d - 2", ks.pp[:, ks.H:],
                                    ps.pp[:, ps.H:]))
                exact(f"  the same vs the numpy DP ({tag})", got, want)
                errs["wavefront_chunk"] = max(errs["wavefront_chunk"], err)
                if world > 1 or halo > sw.MAX_SUB_HALO:
                    continue
                s = sw.rank_lanes(sa, la, sb, lb, 0, 1, halo, dev)
                if not sw.one_launch_fits(s):
                    raise AssertionError(f"the cooperative route refuses {tag}")
                n = s.n_chunks // 3
                s = sw.run_chunks(sw.run_chunks(s, 0, n), n, s.n_chunks - n)
                torch.cuda.synchronize()
                errs["wavefront_chunks"] = max(
                    errs["wavefront_chunks"],
                    exact(f"wavefront_chunks ({n} + {s.n_chunks - n} chunks a launch) vs the "
                          f"launches a chunk, distances ({tag})", s.result, got),
                    exact("  owned lanes", s.p[:, s.H:], k_states[0].p[:, s.H:]),
                    exact("  lanes d - 2", s.pp[:, s.H:], k_states[0].pp[:, s.H:]))


class SeededCSR:
    """A VariantMajorCSR face over a seeded dense zygosity matrix, made a
    block at a time from (seed, block start): every rank and the one-rank
    run read the same codes without holding the whole."""

    def __init__(self, genomes, variants, block, seed):
        self.genome_count, self.variant_count = genomes, variants
        self.block, self.seed = block, seed

    def dense_block_t(self, v_lo, v_hi):
        if v_lo % self.block or v_hi - v_lo > self.block:
            raise ValueError("blocks must be the generator's")
        rng = np.random.default_rng((self.seed, v_lo))
        return rng.integers(0, 3, (v_hi - v_lo, self.genome_count), dtype=np.uint8)


def multidevice_inputs():
    """The seeded inputs of phase 3i."""
    from kgl_gene_tpu_torch.stats.inbreeding import synthetic_diploid_population

    rng = np.random.default_rng(SEED + 3)
    region = gene_region(rng)
    positions, alt, valid = snp_batch(rng, MULTI_STEP_B, MULTI_STEP_K, REGION_LEN)
    zygosity = rng.integers(0, 3, (MULTI_STEP_B, 16)).astype(np.uint8)
    m = MULTI_INDEL
    slots = indel_slots(rng, m["B"], m["K"], m["A"], REGION_LEN)
    G, L = MULTI_WINDOW
    window = synthetic_diploid_population(G, L, np.linspace(0.0, 0.5, G), seed=SEED + 4)
    p = np.asarray(window.minor_freq, np.float32).copy()
    p[::97] = 0.0  # invalid loci, excluded by the functions' own mask
    Gs, Vs = MULTI_STREAMED
    streamed_p = np.random.default_rng(SEED + 5).uniform(0.01, 0.5, Vs).astype(np.float32)
    longs = [long_pair(np.random.default_rng(SEED + 6 + i), n, *MULTI_LONG_EDITS)
             for i, n in enumerate(MULTI_LONG)]
    return {"region": region, "step": (positions, alt, valid, zygosity), "indel": slots,
            "window": (np.asarray(window.zygosity, np.uint8), p),
            "streamed": (Gs, Vs, MULTI_STREAMED_BLOCK, SEED + 7, streamed_p), "long": longs}


def _timed_turns(fns, mesh, windows=MULTI_STEP_WINDOWS, iters=MULTI_STEP_ITERS):
    """Median host ms a call of each fn of `fns`, each window ending in a
    synchronise, the fns in turns window by window; the ranks meet at a
    barrier before each window."""
    import torch
    import torch.distributed as dist

    per = [[] for _ in fns]
    for fn in fns:
        fn()
    for _ in range(windows):
        for fn, times in zip(fns, per):
            torch.cuda.synchronize()
            if mesh.group is not None:
                dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return [statistics.median(t) for t in per]


def multidevice_rank(mesh, inputs, full):
    """One rank of phase 3i: every multi-device form on this rank's card,
    launch counts from 0; then their times. full=False (the world-1 run)
    runs the steps (the indel step at bands 63 and 0) and the two long
    pairs only."""
    import torch

    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.ops import pipeline
    from kgl_gene_tpu_torch.ops.sharded_wavefront import sharded_levenshtein
    from kgl_gene_tpu_torch.ops.wavefront import batched_levenshtein_kernel
    from kgl_gene_tpu_torch.parallel import mesh as pm
    from kgl_gene_tpu_torch.parallel.dist import gather_rows

    def gathered(x):
        return gather_rows(x, mesh).cpu().numpy()

    t_rank = time.perf_counter()
    out = {"rank": mesh.rank, "world": mesh.world_size, "device": str(mesh.device),
           "device_type": mesh.device.type, "backend": mesh.backend}
    region = inputs["region"]
    positions, alt, valid, zygosity = inputs["step"]
    step = pipeline.make_multichip_step(mesh, region, EXONS, 0)
    shards = [pm.shard_samples(x, mesh) for x in (positions, alt, valid, zygosity)]
    m = MULTI_INDEL
    # the indel step at band 63 (B1) and at band 0 (B3: the route of B3 in
    # every rank at these shapes)
    isteps = [pipeline.make_multichip_indel_step(mesh, region, EXONS, 0,
                                                 pad_coding=m["K"] * m["A"], band_k=band)
              for band in (m["band_k"], 0)]
    ishards = [pm.shard_samples(x, mesh) for x in inputs["indel"]]
    (a32, la32, b32, lb32), long49 = inputs["long"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    distance, counts, pop_ac = step(*shards)
    out["step"] = (gathered(distance), counts.cpu().numpy(), pop_ac.cpu().numpy())
    out["indel"], out["indel0"] = (tuple(gathered(x) for x in istep(*ishards))
                                   for istep in isteps)
    t0 = time.perf_counter()
    out["long32"] = sharded_levenshtein(a32, la32, b32, lb32, mesh, halo=MULTI_HALO)
    out["long32_s"] = time.perf_counter() - t0
    if full:
        seqs, lens = inputs["family"]
        out["allpairs"] = pm.sharded_pairwise_distances(seqs, lens, mesh, band_k=127)
        z, p = inputs["window"]
        out["allele_counts"] = pm.sharded_allele_counts(z, mesh)
        out["het_hom"] = pm.sharded_het_hom(z, mesh)
        out["inbreeding"] = {name: pm.sharded_inbreeding(z, p, mesh, name)
                             for name in ESTIMATOR_ATOL}
        Gs, Vs, block, seed, sp = inputs["streamed"]
        t0 = time.perf_counter()
        out["streamed"] = pm.streamed_inbreeding(SeededCSR(Gs, Vs, block, seed), sp, mesh,
                                                 block_variants=block)
        out["streamed_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["long49"] = sharded_levenshtein(*long49, mesh, halo=MULTI_HALO)
    out["long49_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    out["launches"] = dict(kernels.LAUNCHES)
    out["host_copies"] = dict(mesh.host_copies)
    out["path_s"] = time.perf_counter() - t_rank

    # B3 on the 32,768-base pair, the oracle of the sharded form: after the
    # counts are read, so its launch is not one of the path's.
    b3_args = [torch.as_tensor(x, device=mesh.device) for x in (a32, la32, b32, lb32)]
    out["long32_b3"] = batched_levenshtein_kernel(*b3_args).cpu().numpy()

    # Times (not counted): the step over the mesh beside the one-card step
    # on the whole batch, in turns; the 32,768-base pair again beside B3.
    one = pipeline.make_forward_step(region, EXONS, 0, device=mesh.device)
    whole = [torch.as_tensor(x, device=mesh.device) for x in (positions, alt, valid)]
    out["step_ms"], out["one_card_step_ms"] = _timed_turns(
        [lambda: step(*shards), lambda: one(*whole)], mesh)
    t0 = time.perf_counter()
    sharded_levenshtein(a32, la32, b32, lb32, mesh, halo=MULTI_HALO)
    torch.cuda.synchronize()
    out["long32_again_s"] = time.perf_counter() - t0
    out["long32_b3_ms"] = time_cuda(lambda: batched_levenshtein_kernel(*b3_args), 1, windows=3)
    return out


def time_queued(prep, fn, reps=3, queued=True):
    """Median ms of fn between two events, each rep after prep (not timed).
    queued: the events and fn wait behind a sleep of the card (about a
    millisecond), so the host's time to issue fn is not in the reading;
    else the card waits for it (host-inclusive)."""
    import torch

    times = []
    for _ in range(reps):
        prep()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(2_000_000)
        else:
            torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def chunk_cells(s, d_lo, d_hi):
    """DP cells of the table on diagonals d_lo .. d_hi - 1."""
    d = np.arange(d_lo, d_hi)
    return int(np.clip(np.minimum(d, s.Ma) - np.maximum(0, d - s.Mb) + 1, 0, None).sum())


def chunk_bounds(s, cells, chunks):
    """(bound_ms, bound_by, int_ops, issue_ms, dispatch_ms, bytes_ms) of
    `chunks` chunks over `cells` DP cells: WAVEFRONT_OPS_PER_CELL operations
    a cell against the float32 rate, the issue rate and the dispatch rate;
    a_lane and the two diagonals read, two written, and the run of text the
    chunk's cells read (W + H codes a pair), a chunk."""
    ops = cells * WAVEFRONT_OPS_PER_CELL
    B, W = s.a_lane.shape
    nbytes = (6 * W + s.H) * 4 * B * chunks
    t_ops, t_bytes = ops / OPS_PER_S, nbytes / MEM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", ops,
            ops / issue_rate() * 1e3, ops / issue_rate(DISPATCH_LANES_PER_SM) * 1e3, t_bytes * 1e3)


def chunk_rows(dev, long32, errs):
    """The chunk kernel's two rows of the kernels line, on the 32,768-base
    pair at world 1. wavefront_chunk: one chunk (H = MULTI_HALO diagonals,
    the middle chunk, whose diagonals cross the whole table) from the pair's
    real DP state (the chunks before it run first), held against
    chunk_plain, host-inclusive and on the device. wavefront_chunks: the
    cooperative route over CHUNK_RUN chunks from the same state in one
    launch against run_chunks_plain, each launch from a fresh copy of the
    state; and the whole pair through sharded_levenshtein, its wall split
    into the one launch's device time and the rest. bound_ms sets the
    chunks' DP cells at WAVEFRONT_OPS_PER_CELL operations a cell against the
    float32 rate, as every other row; issue_bound_ms (64 lanes) and
    dispatch_bound_ms (DISPATCH_LANES_PER_SM) the same operations against
    the rates an SM issues them at."""
    import torch

    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.ops import sharded_wavefront as sw
    from kgl_gene_tpu_torch.parallel.dist import SampleMesh

    s = sw.rank_lanes(*long32, 0, 1, MULTI_HALO, dev)
    c = s.n_chunks // 2
    s = sw.run_chunks(s, 0, c)
    d0 = 2 + c * s.H
    B, W = s.a_lane.shape

    def fresh(x):
        return x._replace(out_pp=x.out_pp.clone(), out_p=x.out_p.clone(), result=x.result.clone())

    new_s, plain_s = fresh(s), fresh(s)
    kern = functools.partial(sw.chunk, new_s, d0)
    kern()
    sw.chunk_plain(plain_s, d0)
    torch.cuda.synchronize()
    tag = f"chunk {c} of {s.n_chunks} of the {MULTI_LONG[0]}-base pair, from its DP state"
    errs["wavefront_chunk"] = max(
        errs["wavefront_chunk"],
        exact(f"wavefront_chunk vs chunk_plain, lanes d - 1 ({tag})", new_s.out_p[:, s.H:],
              plain_s.out_p[:, s.H:]),
        exact(f"wavefront_chunk vs chunk_plain, lanes d - 2 ({tag})", new_s.out_pp[:, s.H:],
              plain_s.out_pp[:, s.H:]))
    ms = time_cuda(kern, 20, windows=5)
    turns = [time_device([kern], 20, windows=3) for _ in range(4)]
    device_ms = statistics.median(turns)
    plain_ms = time_cuda(lambda: sw.chunk_plain(plain_s, d0), 1, windows=3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    warps, T, tiles = sw.chunk_geometry(W - s.H, s.H, B, sms)
    with torch.cuda.device(dev):
        held = kernels.library().kgt_wavefront_chunks_blocks(warps, s.H)
    geometry = {"lanes_a_thread": sw.CHUNK_LANES_A_THREAD,
                "exchange_steps": sw.CHUNK_EXCHANGE_STEPS, "warps": warps, "owned_lanes": T,
                "tiles": tiles, "blocks_an_sm": held // sms}
    cells = chunk_cells(s, d0, d0 + s.H)
    b_ms, by, ops, issue_ms, dispatch_ms, bytes_ms = chunk_bounds(s, cells, 1)
    log(f"  wavefront_chunk (one chunk of {s.H} diagonals, {s.Ma + 1} lanes, {cells} cells; "
        f"{geometry}): {ms:.6f} ms host-inclusive, {device_ms:.6f} ms device (windows "
        f"{turns}); plain {plain_ms:.3f} ms; bound {b_ms:.6f} ms ({by}: cell operations at the float32 "
        f"rate, {bytes_ms:.6f} ms of bytes); at the issue rate {issue_ms:.6f} ms, at the "
        f"dispatch rate {dispatch_ms:.6f} ms")
    one = dict(name="wavefront_chunk", route="cuda",
               source="kgl_gene_tpu_torch/csrc/sharded_wavefront.cu",
               replaces="kgl_gene_tpu/ops/sharded_wavefront.py:42",
               shape=f"one chunk, H={s.H}, {s.Ma + 1} lanes, {cells} cells",
               ms=ms, device_ms=device_ms, plain_ms=plain_ms,
               library_ms=None, bound_ms=b_ms, bound_by=by, int_ops=ops,
               issue_bound_ms=issue_ms, dispatch_bound_ms=dispatch_ms, geometry=geometry)

    # The cooperative route: CHUNK_RUN chunks from the same state in one
    # launch, each timed launch from a fresh copy of the state (the launch
    # overwrites its input: the chunks alternate the two buffers).
    saved = (s.pp.clone(), s.p.clone())
    run_s = fresh(s)
    want = sw.run_chunks_plain(fresh(s)._replace(pp=saved[0].clone(), p=saved[1].clone()), c,
                               CHUNK_RUN)

    def restore():
        run_s.pp.copy_(saved[0])
        run_s.p.copy_(saved[1])

    restore()
    got = sw.run_chunks(run_s, c, CHUNK_RUN)
    torch.cuda.synchronize()
    tag = f"chunks {c} .. {c + CHUNK_RUN - 1} of the {MULTI_LONG[0]}-base pair in one launch"
    errs["wavefront_chunks"] = max(
        errs["wavefront_chunks"],
        exact(f"wavefront_chunks vs run_chunks_plain, lanes d - 1 ({tag})", got.p[:, s.H:],
              want.p[:, s.H:]),
        exact(f"wavefront_chunks vs run_chunks_plain, lanes d - 2 ({tag})", got.pp[:, s.H:],
              want.pp[:, s.H:]))
    run = functools.partial(sw.run_chunks, run_s, c, CHUNK_RUN)
    run_ms = time_queued(restore, run, reps=5, queued=False)
    run_device_ms = time_queued(restore, run, reps=5)
    run_plain_ms = time_cuda(lambda: sw.run_chunks_plain(fresh(want), c, CHUNK_RUN), 1,
                             windows=2)
    run_cells = chunk_cells(s, d0, d0 + CHUNK_RUN * s.H)
    rb_ms, rby, rops, rissue_ms, rdispatch_ms, _ = chunk_bounds(s, run_cells, CHUNK_RUN)

    # The whole pair as sharded_levenshtein runs it at world 1: its wall,
    # and the device time of its one launch on the same rank lanes.
    mesh = SampleMesh.single(dev)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sw.sharded_levenshtein(*long32, mesh, halo=MULTI_HALO)
        walls.append((time.perf_counter() - t0) * 1e3)
    pair = sw.rank_lanes(*long32, 0, 1, MULTI_HALO, dev)
    start = (pair.pp.clone(), pair.p.clone(), pair.result.clone())

    def reset():
        for x, y in zip((pair.pp, pair.p, pair.result), start):
            x.copy_(y)

    pair_device_ms = time_queued(reset, lambda: sw.run_chunks(pair, 0, pair.n_chunks))
    pair_wall_ms = statistics.median(walls)
    pair_cells = chunk_cells(pair, 2, 2 + pair.n_chunks * pair.H)
    pair_bound_ms = chunk_bounds(pair, pair_cells, pair.n_chunks)[0]
    log(f"  wavefront_chunks ({CHUNK_RUN} chunks in one launch, {run_cells} cells): "
        f"{run_ms:.6f} ms with the host's launch, {run_device_ms:.6f} ms device "
        f"({run_device_ms / CHUNK_RUN:.6f} a chunk); plain {run_plain_ms:.3f} ms; bound "
        f"{rb_ms:.6f} ms; the whole pair ({pair.n_chunks} chunks, one launch) "
        f"{pair_wall_ms:.4f} ms wall (runs {[round(w, 4) for w in walls]}), "
        f"{pair_device_ms:.4f} ms of it the launch on the device, "
        f"{pair_wall_ms - pair_device_ms:.4f} ms the host's rest; bound {pair_bound_ms:.6f} ms")
    many = dict(name="wavefront_chunks", route="cuda",
                source="kgl_gene_tpu_torch/csrc/sharded_wavefront.cu",
                replaces="kgl_gene_tpu/ops/sharded_wavefront.py:118",
                shape=f"{CHUNK_RUN} chunks of H={s.H} in one launch, {run_cells} cells",
                ms=run_ms, device_ms=run_device_ms, plain_ms=run_plain_ms, library_ms=None,
                bound_ms=rb_ms, bound_by=rby, int_ops=rops, issue_bound_ms=rissue_ms,
                dispatch_bound_ms=rdispatch_ms, pair_wall_ms=pair_wall_ms,
                pair_device_ms=pair_device_ms, pair_host_ms=pair_wall_ms - pair_device_ms,
                pair_bound_ms=pair_bound_ms, geometry=geometry)
    return [one, many]


def family_pool(dev):
    """Phase 3b's distinct mutants (padded codes, lengths) and their
    all-pairs matrix at band 127 on the card (phase 3b holds it equal to
    the CPU's): phase 3i's inputs when it runs alone."""
    from kgl_gene_tpu_torch.analysis.lib_seqmutation import TranscriptFamilyAnalysis
    from kgl_gene_tpu_torch.ops.edit_distance import pairwise_distance_matrix

    fam = TranscriptFamilyAnalysis(*config_a_records(dev), device=dev)
    seqs, lens = fam._padded_codes(list(fam.distinct_sequences()))
    return seqs, lens, pairwise_distance_matrix(seqs, lens, band_k=127, device=dev)


def phase_multidevice(dev, seqs, lens, matrix, errs):
    """Phase 3i: the chunk kernel against its plain version; then every
    multi-device form through run_ranks at world 1 (NCCL, cuda:0) and world
    2 (gloo, both ranks on cuda:0), each output held against the one-card
    form, and each rank's device, backend, host copies and launches.
    Returns (the multidevice line, the chunk kernel's two rows, their
    launches by route: world 1's by the cooperative route, world 2's by the
    launches a chunk)."""
    import torch

    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.ops import pipeline
    from kgl_gene_tpu_torch.ops.edit_distance import levenshtein_numpy
    from kgl_gene_tpu_torch.parallel import mesh as pm
    from kgl_gene_tpu_torch.parallel.dist import run_ranks

    t_phase = time.perf_counter()
    out = {"card": nvidia_smi_line()}
    kernels.library()  # built here once; the ranks load it
    chunk_kernel_cases(dev, errs)
    inputs = multidevice_inputs()
    inputs["family"] = (np.asarray(seqs), np.asarray(lens))
    longs = inputs["long"]
    # The numpy DP of the two long pairs runs beside the ranks.
    pool = concurrent.futures.ThreadPoolExecutor(1)
    oracles = pool.submit(lambda: [levenshtein_numpy(a[0, : la[0]], b[0, : lb[0]])
                                   for a, la, b, lb in longs])

    # The one-card references, in this process.
    region = inputs["region"]
    positions, alt, valid, zygosity = inputs["step"]
    ref = pipeline.make_forward_step(region, EXONS, 0, device=dev)(positions, alt, valid)
    m = MULTI_INDEL
    iref, iref0 = (pipeline.make_indel_forward_step(region, EXONS, 0,
                                                    pad_coding=m["K"] * m["A"], band_k=band,
                                                    device=dev)(*inputs["indel"])
                   for band in (m["band_k"], 0))
    z, p = inputs["window"]
    stats_ref = {"allele_counts": pm.sharded_allele_counts(z, dev),
                 "het_hom": pm.sharded_het_hom(z, dev),
                 "inbreeding": {n: pm.sharded_inbreeding(z, p, dev, n) for n in ESTIMATOR_ATOL}}
    Gs, Vs, block, seed, sp = inputs["streamed"]
    t0 = time.perf_counter()
    streamed_ref = pm.streamed_inbreeding(SeededCSR(Gs, Vs, block, seed), sp, dev,
                                          block_variants=block)
    out["streamed_one_rank_s"] = time.perf_counter() - t0

    def check_steps(tag, o):
        B = MULTI_STEP_B
        exact(f"{tag} rank {o['rank']}: the step's distances vs make_forward_step",
              torch.as_tensor(o["step"][0][:B]), ref.distance)
        exact(f"{tag} rank {o['rank']}: allele counts", torch.as_tensor(o["step"][1]),
              ref.allele_counts)
        exact(f"{tag} rank {o['rank']}: pop_ac vs numpy's column sums",
              torch.as_tensor(o["step"][2]), torch.as_tensor(zygosity.astype(np.int64).sum(0)))
        if o["step"][1].dtype != np.int32 or o["step"][2].dtype != np.int32:
            raise AssertionError("allele counts and pop_ac must stay int32")
        for key, band, want in (("indel", m["band_k"], iref), ("indel0", 0, iref0)):
            for name, got in zip(("coding_len", "distance", "validity_code"), o[key]):
                exact(f"{tag} rank {o['rank']}: the indel step's {name} at band {band} vs "
                      "make_indel_forward_step", torch.as_tensor(got[: m["B"]]),
                      getattr(want, name))
        exact(f"{tag} rank {o['rank']}: the {MULTI_LONG[0]}-base pair vs B3",
              torch.as_tensor(o["long32"]), torch.as_tensor(o["long32_b3"]))

    results = {}
    for world, backend, full in ((1, "nccl", False), (2, "gloo", True)):
        tag = f"world {world} ({backend})"
        log(f"  {tag}: run_ranks, deadline {MULTI_TIMEOUT_S:.0f} s")
        t0 = time.perf_counter()
        ranks = run_ranks(multidevice_rank, world, backend=backend, device="cuda",
                          timeout_s=MULTI_TIMEOUT_S, args=(inputs, full))
        out[f"world{world}_wall_s"] = time.perf_counter() - t0
        # world 1 runs its chunks in one cooperative launch, world 2 a
        # launch a chunk with the ring exchange between them
        route, other = (("wavefront_chunks", "wavefront_chunk") if world == 1
                        else ("wavefront_chunk", "wavefront_chunks"))
        expected = ("myers", "translate", "wavefront", route)
        for o in ranks:
            if o["device_type"] != "cuda" or o["backend"] != backend:
                raise AssertionError(f"{tag} rank {o['rank']} ran on {o['device']} "
                                     f"over {o['backend']}")
            missing = [k for k in expected if o["launches"].get(k, 0) < 1]
            if missing or o["launches"].get(other, 0):
                raise AssertionError(f"{tag} rank {o['rank']}: {missing} never launched or "
                                     f"{other} launched ({o['launches']})")
            check_steps(tag, o)
            log(f"  {tag} rank {o['rank']} on {o['device']}: launches {o['launches']}, "
                f"host copies {o['host_copies']}, path {o['path_s']:.1f} s")
            if not full:
                continue
            exact(f"{tag} rank {o['rank']}: sharded_pairwise_distances (band 127) vs "
                  "phase 3b's matrix, every entry", torch.as_tensor(o["allpairs"]),
                  torch.as_tensor(matrix))
            exact(f"{tag} rank {o['rank']}: sharded_allele_counts",
                  torch.as_tensor(o["allele_counts"]),
                  torch.as_tensor(stats_ref["allele_counts"]))
            for got, want in zip(o["het_hom"], stats_ref["het_hom"]):
                exact(f"{tag} rank {o['rank']}: sharded_het_hom", torch.as_tensor(got),
                      torch.as_tensor(want))
            for name, atol in ESTIMATOR_ATOL.items():
                err = float(np.abs(o["inbreeding"][name] - stats_ref["inbreeding"][name]).max())
                out[f"inbreeding_{name}_max_abs_err"] = max(
                    err, out.get(f"inbreeding_{name}_max_abs_err", 0.0))
                if not err <= atol:
                    raise AssertionError(f"{tag} sharded {name} differs by {err}")
            for name in streamed_ref:
                if not np.array_equal(o["streamed"][name], streamed_ref[name]):
                    raise AssertionError(f"{tag} streamed {name} differs from the one-rank run")
            log(f"  {tag} rank {o['rank']}: {len(ESTIMATOR_ATOL)} estimators within "
                "tolerance; streamed inbreeding bit for bit equal to the one-rank run "
                f"({Gs} genomes x {Vs} variants)")
        results[world] = ranks
    want32, want49 = oracles.result()
    pool.shutdown()
    for world, ranks in results.items():
        for o in ranks:
            pairs = [("long32", MULTI_LONG[0], want32)]
            if "long49" in o:
                pairs.append(("long49", MULTI_LONG[1], want49))
            for key, n, want in pairs:
                exact(f"world {world} rank {o['rank']}: sharded_levenshtein, {n}-base pair, "
                      "vs the numpy DP", torch.as_tensor(o[key]), torch.as_tensor([want]))
    out.update(long32_distance=want32, long49_distance=want49,
               streamed_shape=[Gs, Vs], window_shape=list(MULTI_WINDOW), step_B=MULTI_STEP_B)
    keep = ("rank", "device", "backend", "launches", "host_copies", "path_s", "step_ms",
            "one_card_step_ms", "long32_s", "long32_again_s", "long32_b3_ms", "long49_s",
            "streamed_s")
    out["worlds"] = {str(w): [{k: o[k] for k in keep if k in o} for o in ranks]
                     for w, ranks in results.items()}
    rows = chunk_rows(dev, longs[0], errs)
    launches = {name: sum(o["launches"].get(name, 0) for ranks in results.values()
                          for o in ranks)
                for name in ("wavefront_chunk", "wavefront_chunks")}
    out["phase_s"] = time.perf_counter() - t_phase
    for w, ranks in results.items():
        for o in ranks:
            log(f"  world {w} rank {o['rank']}: step {o['step_ms']:.3f} ms over the mesh, "
                f"{o['one_card_step_ms']:.3f} ms one card (B = {MULTI_STEP_B}); "
                f"{MULTI_LONG[0]}-base pair {o['long32_again_s']:.3f} s sharded, "
                f"B3 {o['long32_b3_ms']:.3f} ms")
    return out, rows, launches

# Phase 3j: kernel `loglik` (csrc/loglik.cu) at the INBREED cell's shape,
# 2,504 genomes x 25,000 loci (hs-1kg-chr22: LociiCount 25,000), codes
# drawn from LOGLIK_SEED at F from the cell's list; small shapes and every
# mask form first. Its bound: the codes read once a pass (41 passes) against
# the card's bytes a second, or the float64 instructions the design cannot
# do without (an add a cell and grid point, an fma and a multiply a cell and
# step point) at FP64_LANES_PER_SM lanes an SM a cycle, whichever is larger.
LOGLIK_SHAPE = (25_000, 2_504)
LOGLIK_SEED = 23
LOGLIK_LIMIT = 1e-4  # reference/inbreed.py TOLERANCE["Loglikelihood"]
LOGLIK_F = ((0.0, 0.7), (1 / 64, 0.1), (1 / 16, 0.1), (1 / 8, 0.05), (1 / 4, 0.03), (1 / 2, 0.02))
LOGLIK_PASSES, LOGLIK_GRID_POINTS, LOGLIK_STEP_POINTS = 41, 65, 80
FP64_LANES_PER_SM = 64
# The estimate path: InbreedAnalysis over LOGLIK_PATH_VARIANTS variants of
# LOGLIK_SHAPE's genomes, every LOGLIK_PATH_SPACING-th one kept.
LOGLIK_PATH_VARIANTS, LOGLIK_PATH_SPACING = 40_000, 4


def loglik_codes(L, G, seed, dev):
    """(codes (L, G) uint8, p (L,) float32) on the card from the seed: p
    uniform in [0.05, 0.5], each genome's F drawn from LOGLIK_F, a genotype
    two draws of the alternate allele, one draw twice with probability F."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    values = torch.tensor([v for v, _w in LOGLIK_F], dtype=torch.float32, device=dev)
    weights = torch.tensor([w for _v, w in LOGLIK_F], dtype=torch.float32, device=dev)
    f = values[torch.multinomial(weights, G, replacement=True, generator=gen)]
    p = 0.05 + 0.45 * torch.rand(L, generator=gen, device=dev)
    first = torch.rand((L, G), generator=gen, device=dev) < p[:, None]
    second = torch.where(torch.rand((L, G), generator=gen, device=dev) < f, first,
                         torch.rand((L, G), generator=gen, device=dev) < p[:, None])
    return (first.to(torch.uint8) + second.to(torch.uint8)), p


def loglik_cases(dev):
    """(name, z, p, valid) on the card: ragged genome and locus counts,
    every mask form run_estimators passes, codes past 2, and the int32
    transposed view run_estimator hands on."""
    import torch

    cases = []
    for L, G in ((1, 1), (37, 11), (260, 33), (3_000, 257), (5_003, 1)):
        z, p = loglik_codes(L, G, LOGLIK_SEED + L + G, dev)
        z[:, 0] = torch.where(torch.rand(L, device=dev) < p, 2, 0)  # all homozygous: f near 1
        locus = torch.rand(L, device=dev) < 0.8
        genome = torch.rand((L, G), device=dev) < 0.8
        genome[:, -1] = False  # a genome with no valid locus: a grid tie
        cases += [(f"{L}x{G} none", z, p, None),
                  (f"{L}x{G} per locus", z, p, locus[:, None]),
                  (f"{L}x{G} per locus, broadcast", z, p, locus[:, None].expand(L, G)),
                  (f"{L}x{G} per genome", z, p, genome)]
    z, p = loglik_codes(400, 40, LOGLIK_SEED, dev)
    z[::7, ::3] = 3
    z[::11, ::5] = 255
    cases.append(("400x40 codes past 2", z, p, None))
    z, p = loglik_codes(300, 20, LOGLIK_SEED + 1, dev)
    cases.append(("300x20 int32 transposed", z.t().to(torch.int32).contiguous().t(), p, None))
    return cases


def phase_loglik(dev, errs):
    """Kernel `loglik` against the plain version on the card (stats/
    inbreeding.py _loglik_rows_plain, eager float64): the cases of
    loglik_cases, then LOGLIK_SHAPE; its time beside its bound and the plain
    version's; then an INBREED estimate, counts from 0, which must launch
    `loglik` LOGLIK_PASSES times and nothing else, count 145 evaluations and
    LOGLIK_PASSES passes, and give the plain version's Loglikelihood F.
    Returns (the kernels row, launches on the estimate path, summary)."""
    import torch

    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.analysis.inbreed_analysis import InbreedAnalysis
    from kgl_gene_tpu_torch.app.runtime import ParameterMap
    from kgl_gene_tpu_torch.stats import inbreeding as inb

    def gap(name, got, want):
        d = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        if got.shape != want.shape or not d <= LOGLIK_LIMIT:
            raise AssertionError(f"loglik {name}: |dF| {d} over {LOGLIK_LIMIT}")
        return d

    worst, cases = 0.0, loglik_cases(dev)
    for name, z, p, valid in cases:
        worst = max(worst, gap(name, inb._loglik_rows(z, p, valid),
                               inb._loglik_rows_plain(z, p, valid)))
    torch.cuda.synchronize()
    log(f"  {len(cases)} small cases: largest |dF| {worst:.3e}")
    del cases

    L, G = LOGLIK_SHAPE
    z, p = loglik_codes(L, G, LOGLIK_SEED, dev)
    kernel = lambda: inb._loglik_rows(z, p, None)  # noqa: E731
    plain = lambda: inb._loglik_rows_plain(z, p, None)  # noqa: E731
    want = plain()
    full = gap(f"{L}x{G}", kernel(), want)
    errs["loglik"] = max(worst, full)
    kernels.reset_launches()
    kernel()
    launches_a_call = dict(kernels.LAUNCHES)
    if launches_a_call != {"loglik": LOGLIK_PASSES}:
        raise AssertionError(f"loglik: a call launched {launches_a_call}")
    ms = time_cuda(kernel, 10)
    try:
        device_ms = time_device([kernel], 4)
    except Exception as exc:  # noqa: BLE001 - the events' reading stands alone
        log(f"  loglik: no CUDA graph of a call ({type(exc).__name__}: {exc})")
        device_ms = None
    plain_ms = time_cuda(plain, 1, windows=2)
    bytes_read = LOGLIK_PASSES * G * L
    fp64 = (LOGLIK_GRID_POINTS + 2 * LOGLIK_STEP_POINTS) * G * L
    t_bytes = bytes_read / MEM_BYTES_PER_S * 1e3
    t_fp64 = fp64 / issue_rate(FP64_LANES_PER_SM) * 1e3
    bound_ms = max(t_bytes, t_fp64)
    log(f"  {L} loci x {G} genomes: |dF| {full:.3e}; kernel {ms:.4f} ms (device "
        f"{device_ms if device_ms is None else round(device_ms, 4)}), bound {bound_ms:.4f} ms "
        f"(bytes {t_bytes:.4f}, float64 {t_fp64:.4f}), plain {plain_ms:.2f} ms; "
        f"{LOGLIK_PASSES} launches a call")

    # The estimate path: INBREED's own stages over columns on the card.
    V = LOGLIK_PATH_VARIANTS
    codes, _p = loglik_codes(V, G, LOGLIK_SEED + 2, dev)
    af = codes.sum(1, dtype=torch.int64).cpu().numpy() / (2.0 * G)
    analysis = InbreedAnalysis(dev)
    params = {"Algorithm": "ALL", "MinAF": "0.05", "SamplingDistance": str(LOGLIK_PATH_SPACING)}
    if not analysis.initialize_analysis(".", [ParameterMap("INBREED", {
            k: [v] for k, v in params.items()})], None):
        raise AssertionError("loglik: INBREED refused its parameters")
    columns = analysis.prepare_columns(codes, np.arange(V, dtype=np.int64), np.zeros(V, np.int32),
                                       np.ones(V, bool), [f"G{g}" for g in range(G)], {"ALL": af})
    analysis.estimate(columns, "ALL")  # warm
    before = dict(inb.COUNTERS)
    kernels.reset_launches()
    est = analysis.estimate(columns, "ALL")
    torch.cuda.synchronize()
    path = {k: n for k, n in kernels.LAUNCHES.items() if k != "hallme"}  # phase 3k's
    counted = {k: inb.COUNTERS[k] - before.get(k, 0)
               for k in ("loglik_evaluations", "loglik_passes")}
    if path != {"loglik": LOGLIK_PASSES} or counted != {
            "loglik_evaluations": LOGLIK_GRID_POINTS + LOGLIK_STEP_POINTS,
            "loglik_passes": LOGLIK_PASSES}:
        raise AssertionError(f"loglik: the estimate launched {path}, counted {counted}")
    index = torch.as_tensor(est.loci, device=dev)
    p_sel = torch.as_tensor(est.minor_freq.astype(np.float32), device=dev)
    path_gap = gap("estimate path", torch.as_tensor(est.f[:, est.algorithms.index("Loglikelihood")]),
                   inb._loglik_rows_plain(codes.index_select(0, index), p_sel, None).cpu())
    log(f"  InbreedAnalysis.estimate over {len(est.loci)} loci: launches {path}, counters "
        f"{counted}, Loglikelihood |dF| against the plain version {path_gap:.3e}")
    row = {"name": "loglik", "route": "CUDA", "source": "kgl_gene_tpu_torch/csrc/loglik.cu",
           "replaces": "none (kgl_gene_tpu/stats/inbreeding.py:128 _loglik_row is XLA)",
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes" if t_bytes >= t_fp64 else "float64 operations",
           "library_ms": None, "bytes_bound_ms": t_bytes, "fp64_bound_ms": t_fp64,
           "issue_bound_ms": None, "max_abs_err_f": errs["loglik"], "shape": [L, G],
           **({"device_ms": device_ms} if device_ms is not None else {})}
    summary = {"small_cases_max_df": worst, "full_max_df": full, "estimate_loci": len(est.loci),
               "estimate_launches": path, "estimate_counters": counted,
               "estimate_max_df": path_gap}
    return row, path["loglik"], summary


# Phase 3k: kernel `hallme` (csrc/hallme.cu) at the INBREED cell's shape,
# LOGLIK_SHAPE's codes from the same seed; small shapes (G a multiple of 4
# and not, so both load widths) and every mask form first. Its bound: the
# codes read once a step against the card's bytes a second.
HALLME_LIMIT = 1e-3  # reference/inbreed.py TOLERANCE["HallME"]


def hallme_reference(z, p, valid):
    """The reference's F on the cells the mask keeps (a locus left out is
    not one of the genome's loci), a genome at a time where the mask is a
    genome's; on the card."""
    import torch

    from port_bench.reference import inbreed as reference

    L, G = z.shape
    codes = z.to(torch.uint8)
    if valid is None or valid.shape[1] == 1 or valid.stride(1) == 0:
        keep = torch.ones(L, dtype=torch.bool, device=z.device) if valid is None else valid[:, 0]
        loci = torch.nonzero(keep).flatten().cpu().numpy()
        return reference.hall_me(codes, loci, p.double().cpu().numpy()[loci])[0]
    out = []
    for g in range(G):
        loci = torch.nonzero(valid[:, g]).flatten().cpu().numpy()
        out.append(reference.hall_me(codes[:, g:g + 1], loci, p.double().cpu().numpy()[loci])[0])
    return torch.cat(out)


def hallme_cases(dev):
    """(name, z, p, valid) on the card: ragged genome and locus counts (a
    multiple of 4 genomes takes the 4-byte loads), every mask form
    run_estimators passes, codes past 2, and the int32 view run_estimator
    hands on."""
    import torch

    cases = []
    for L, G in ((1, 1), (37, 11), (260, 33), (3_000, 256), (3_000, 257), (5_003, 1)):
        z, p = loglik_codes(L, G, LOGLIK_SEED + 7 * L + G, dev)
        z[:, 0] = torch.where(torch.rand(L, device=dev) < p, 2, 0)  # all homozygous: f near 1
        if G > 2:
            z[:, 1] = 1  # all heterozygous: term 0
        locus = torch.rand(L, device=dev) < 0.8
        genome = torch.rand((L, G), device=dev) < 0.8
        genome[:, -1] = False  # no valid locus: n = 0
        cases += [(f"{L}x{G} none", z, p, None),
                  (f"{L}x{G} per locus", z, p, locus[:, None]),
                  (f"{L}x{G} per locus, broadcast", z, p, locus[:, None].expand(L, G)),
                  (f"{L}x{G} per genome", z, p, genome)]
    z, p = loglik_codes(400, 40, LOGLIK_SEED + 3, dev)
    z[::7, ::3] = 3
    z[::11, ::5] = 255
    cases.append(("400x40 codes past 2", z, p, None))
    z, p = loglik_codes(300, 20, LOGLIK_SEED + 4, dev)
    cases.append(("300x20 int32 transposed", z.t().to(torch.int32).contiguous().t(), p, None))
    return cases


def hallme_profile(fn):
    """(device ms of each hallme launch, names of the call's other device
    kernels) of one call of fn, from the profiler's CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    steps, other = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "hallme_step_kernel" in e.name:
            steps.append(e.device_time / 1e3)
        elif not e.name.startswith("Memcpy"):
            other.append(e.name)
    return steps, other


def phase_hallme(dev, errs):
    """Kernel `hallme` against the plain version (stats/inbreeding.py
    _hall_me_rows_plain, eager float32) and the float64 reference on the
    card: the cases of hallme_cases, then LOGLIK_SHAPE; its time a step and
    a call beside the byte bound and the plain version's; then an INBREED
    estimate, counts from 0, which must launch `hallme` once a step besides
    kernel `loglik`, count a pass a step and give the plain version's
    HallME F. Returns (the kernels row, launches on the estimate path,
    summary)."""
    import torch

    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.analysis.inbreed_analysis import InbreedAnalysis
    from kgl_gene_tpu_torch.app.runtime import ParameterMap
    from kgl_gene_tpu_torch.stats import inbreeding as inb

    def gap(name, got, want):
        d = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        if got.shape != want.shape or not d <= HALLME_LIMIT:
            raise AssertionError(f"hallme {name}: |dF| {d} over {HALLME_LIMIT}")
        return d

    def counted(fn):
        before = dict(inb.COUNTERS)
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(kernels.LAUNCHES), {
            k: inb.COUNTERS[k] - before.get(k, 0)
            for k in ("hallme_steps", "hallme_passes", "hallme_stop_reads",
                      "hallme_tiles_skipped")}

    worst = worst_ref = 0.0
    for name, z, p, valid in hallme_cases(dev):
        got, launches, counts = counted(lambda: inb._hall_me_rows(z, p, valid))
        if launches != {"hallme": counts["hallme_steps"]} or (
                counts["hallme_passes"] != counts["hallme_steps"]):
            raise AssertionError(f"hallme {name}: launched {launches}, counted {counts}")
        worst = max(worst, gap(name, got, inb._hall_me_rows_plain(z, p, valid)))
        worst_ref = max(worst_ref, gap(name + " (reference)", got, hallme_reference(z, p, valid)))
    log(f"  small cases: largest |dF| {worst:.3e} against the plain version, {worst_ref:.3e} "
        f"against the reference")

    L, G = LOGLIK_SHAPE
    z, p = loglik_codes(L, G, LOGLIK_SEED, dev)
    kernel = lambda: inb._hall_me_rows(z, p, None)  # noqa: E731
    plain = lambda: inb._hall_me_rows_plain(z, p, None)  # noqa: E731
    want = plain()
    got, launches, counts = counted(kernel)
    full = gap(f"{L}x{G}", got, want)
    full_ref = gap(f"{L}x{G} (reference)", got, hallme_reference(z, p, None))
    steps = counts["hallme_steps"]
    if launches != {"hallme": steps} or counts["hallme_passes"] != steps or (
            counts["hallme_stop_reads"] != steps // inb._EM_CHECK_EVERY + 1):
        raise AssertionError(f"hallme: a call launched {launches}, counted {counts}")
    errs["hallme"] = max(worst, worst_ref, full, full_ref)
    step_ms, other = hallme_profile(kernel)
    if len(step_ms) != steps or len(other) > 1:
        raise AssertionError(f"hallme: the profiler saw {len(step_ms)} hallme launches of "
                             f"{steps} steps and the kernels {other}")
    ms = time_cuda(kernel, 3)
    plain_ms = time_cuda(plain, 1, windows=2)
    step_bound_ms = G * L / MEM_BYTES_PER_S * 1e3
    bound_ms = steps * step_bound_ms
    device_ms = sum(step_ms)
    log(f"  {L} loci x {G} genomes: {steps} steps, |dF| {full:.3e} (reference {full_ref:.3e}); "
        f"a call {ms:.4f} ms (device {device_ms:.4f}), a step {statistics.median(step_ms):.4f} ms "
        f"on the device (first {step_ms[0]:.4f}, last {step_ms[-1]:.4f}), byte bound "
        f"{step_bound_ms:.4f} a step, {bound_ms:.4f} a call; plain {plain_ms:.2f} ms; "
        f"tiles skipped {counts['hallme_tiles_skipped']}; other kernels {other}")

    # The estimate path: INBREED's own stages over columns on the card.
    V = LOGLIK_PATH_VARIANTS
    codes, _p = loglik_codes(V, G, LOGLIK_SEED + 2, dev)
    af = codes.sum(1, dtype=torch.int64).cpu().numpy() / (2.0 * G)
    analysis = InbreedAnalysis(dev)
    params = {"Algorithm": "ALL", "MinAF": "0.05", "SamplingDistance": str(LOGLIK_PATH_SPACING)}
    if not analysis.initialize_analysis(".", [ParameterMap("INBREED", {
            k: [v] for k, v in params.items()})], None):
        raise AssertionError("hallme: INBREED refused its parameters")
    columns = analysis.prepare_columns(codes, np.arange(V, dtype=np.int64), np.zeros(V, np.int32),
                                       np.ones(V, bool), [f"G{g}" for g in range(G)], {"ALL": af})
    analysis.estimate(columns, "ALL")  # warm
    est, path, path_counts = counted(lambda: analysis.estimate(columns, "ALL"))
    if path != {"loglik": LOGLIK_PASSES, "hallme": path_counts["hallme_steps"]} or (
            path_counts["hallme_passes"] != path_counts["hallme_steps"]) or (
            path_counts["hallme_stop_reads"]
            != path_counts["hallme_steps"] // inb._EM_CHECK_EVERY + 1):
        raise AssertionError(f"hallme: the estimate launched {path}, counted {path_counts}")
    index = torch.as_tensor(est.loci, device=dev)
    p_sel = torch.as_tensor(est.minor_freq.astype(np.float32), device=dev)
    path_gap = gap("estimate path", torch.as_tensor(est.f[:, est.algorithms.index("HallME")]),
                   inb._hall_me_rows_plain(codes.index_select(0, index), p_sel, None).cpu())
    log(f"  InbreedAnalysis.estimate over {len(est.loci)} loci: launches {path}, counters "
        f"{path_counts}, HallME |dF| against the plain version {path_gap:.3e}")
    row = {"name": "hallme", "route": "CUDA", "source": "kgl_gene_tpu_torch/csrc/hallme.cu",
           "replaces": "none (kgl_gene_tpu/stats/inbreeding.py HallME is XLA, a while_loop)",
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
           "library_ms": None, "issue_bound_ms": None, "device_ms": device_ms,
           "step_device_ms": statistics.median(step_ms), "step_bound_ms": step_bound_ms,
           "max_abs_err_f": errs["hallme"], "shape": [L, G]}
    summary = {"small_cases_max_df": worst, "small_cases_max_df_reference": worst_ref,
               "full_max_df": full, "full_max_df_reference": full_ref, "full_steps": steps,
               "full_counters": counts, "full_other_kernels": other,
               "step_device_ms": statistics.median(step_ms), "step_bound_ms": step_bound_ms,
               "call_ms": ms, "call_device_ms": device_ms, "plain_ms": plain_ms,
               "estimate_loci": len(est.loci), "estimate_launches": path,
               "estimate_counters": path_counts, "estimate_max_df": path_gap}
    return row, path["hallme"], summary



# Phase 3l: kernels `fws_variants` and `fws_genomes` (csrc/fws.cu), the two
# passes of the PfEMP statistics, against their plain versions on the card:
# ragged shapes with codes 0..3 and random subsets, then FWS_SHAPE, the Pf7
# cell's whole population (16,203 genomes x 2,000,000 variants, 32.4 GB of
# codes) drawn from FWS_SEED, for the cell's two sets (every genome, and a
# 65% subset); then PfEMPAnalysis.statistics over those codes, counts from
# 0. Each kernel's bound: the codes read once, at the card's bytes a second.
FWS_SEED = 26
FWS_SHAPE = (2_000_000, 16_203)  # variants, genomes
FWS_SUBSET = 0.65  # the cell's qc_monoclonal share of genomes
FWS_LIMIT = 1e-11  # port_bench/drivers/pfemp_fws.py FWS_LIMIT


def fws_codes(V, G, seed, dev, codes_max=2):
    """Codes (V, G) uint8 in the resident layout on the card, from the seed:
    each variant's AF a uniform cubed, a code two draws at it (capped at
    codes_max, or 3 drawn at a few cells where codes_max is 3)."""
    import torch

    from kgl_gene_tpu_torch.variant.columnar import resident_codes

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    codes = resident_codes(V, G, dev)
    for v0 in range(0, V, 8192):
        v1 = min(V, v0 + 8192)
        p = torch.rand((v1 - v0, 1), generator=gen, device=dev) ** 3
        z = ((torch.rand((v1 - v0, G), generator=gen, device=dev) < p).to(torch.uint8)
             + (torch.rand((v1 - v0, G), generator=gen, device=dev) < p).to(torch.uint8))
        if codes_max == 3:
            z[torch.rand((v1 - v0, G), generator=gen, device=dev) < 0.02] = 3
        codes[v0:v1] = z
    return codes


def phase_fws(dev, errs):
    """Kernels `fws_variants` and `fws_genomes` against the plain versions
    (stats/fws.py _variant_counts_plain, _genome_partials_plain) on the card,
    each pair on the same codes, mask and variant order, and fws_statistics
    on the card against the same call on the CPU (small shapes) and against
    the benchmark's float64 reference; at FWS_SHAPE for both of the cell's
    sets, with the kernels' times there beside the byte bound and the plain
    versions'; then a PfEMPAnalysis.statistics call, counts from 0, which
    must launch each kernel once and count two passes. Returns (the kernels
    row, launches on the analysis's path, summary)."""
    import torch

    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.analysis.pfemp_analysis import PfEMPAnalysis
    from kgl_gene_tpu_torch.stats import fws
    from port_bench.reference import fws as reference

    def subset_mask(G, idx):
        mask = torch.zeros(-(-G // fws.GENOME_TILE) * fws.GENOME_TILE, dtype=torch.uint8,
                           device=dev)
        mask[torch.as_tensor(idx, device=dev)] = 1
        return mask

    def compare(name, codes, mask, n):
        """Both passes, kernel and plain, on the same codes, mask and order:
        counts exactly, hs sums within 1e-12 (relative). Returns (the
        largest relative gap, pass one's arguments, pass two's)."""
        G = codes.shape[1]
        counts = fws._variant_counts(codes, mask)
        if not torch.equal(counts, fws._variant_counts_plain(codes, mask)):
            raise AssertionError(f"fws {name}: variant counts differ from the plain version's")
        af = (counts[0] + 2 * counts[1].long()).double() / max(2 * n, 1)
        hs = 2.0 * af * (1.0 - af)
        order, bounds, _bins = fws.segment_bounds(fws.frequency_bins(af))
        args = (codes, order, hs[order], bounds, mask.shape[0])
        (h1, m1, a1), (h0, m0, a0) = fws._genome_partials(*args), fws._genome_partials_plain(*args)
        if not (torch.equal(h1[:, :G], h0[:, :G]) and torch.equal(m1[:, :G], m0[:, :G])):
            raise AssertionError(f"fws {name}: genome counts differ from the plain version's")
        rel = float(((a1 - a0).abs() / a0.abs().clamp_min(1e-300))[:, :G].max()) if G else 0.0
        if not rel <= 1e-12:
            raise AssertionError(f"fws {name}: hs sums {rel} from the plain version's")
        return rel, (codes, mask), args

    def call_against(name, codes, idx, host_codes=None):
        """fws_statistics on the card against the reference (and against the
        same call on host_codes, the CPU's, where given): counts exactly,
        the largest FWS gap returned."""
        got = fws.fws_statistics(codes, idx)
        want = reference.statistics(codes, idx)
        others = [{k: want[k].cpu().numpy() for k in ("het_bins", "hom_bins", "het", "hom")}]
        others[0]["variant_counts"] = torch.stack(
            [want["variant_het"], want["variant_hom"]]).cpu().numpy()
        fws_want = [want["fws"].cpu().numpy()]
        if host_codes is not None:
            host = fws.fws_statistics(host_codes, idx)
            others.append({k: getattr(host, k) for k in others[0]})
            fws_want.append(host.fws)
        for other in others:
            for field, value in other.items():
                if not np.array_equal(getattr(got, field), value):
                    raise AssertionError(f"fws {name}: {field} differs")
        gap = max(float(np.abs(got.fws - w).max(initial=0.0)) for w in fws_want)
        if not gap <= FWS_LIMIT:
            raise AssertionError(f"fws {name}: FWS {gap} from the reference's or the CPU's")
        return gap

    worst = 0.0
    gen = torch.Generator(device="cpu")
    gen.manual_seed(FWS_SEED)
    for V, G in ((1, 1), (37, 11), (3_000, 257), (5_003, 2_048), (9_000, 3_001)):
        codes = fws_codes(V, G, FWS_SEED + V + G, dev, codes_max=3)
        keep = np.flatnonzero(torch.rand(G, generator=gen).numpy() < 0.6)
        worst = max(worst, compare(f"{V}x{G}", codes, subset_mask(G, keep), len(keep))[0])
    call_gap = 0.0
    for V, G in ((37, 11), (9_000, 3_001)):
        codes = fws_codes(V, G, FWS_SEED + 2 * V + G, dev)
        idx = np.flatnonzero(np.random.default_rng(V).random(G) < 0.6)
        call_gap = max(call_gap, call_against(f"{V}x{G}", codes, idx, codes.cpu()))
    log(f"  small cases: counts exact, hs sums within {worst:.3e} (relative) of the plain "
        f"version, FWS within {call_gap:.3e} of the reference's and the CPU's")

    del codes
    torch.cuda.empty_cache()  # the codes below take 32.4 GB
    V, G = FWS_SHAPE
    codes = fws_codes(V, G, FWS_SEED, dev)
    index = np.sort(np.random.default_rng(FWS_SEED).choice(G, round(FWS_SUBSET * G),
                                                            replace=False))
    pass_bound_ms = V * G / MEM_BYTES_PER_S * 1e3
    times = {}
    for name, idx in (("all", np.arange(G)), ("subset", index)):
        rel, variants_args, genomes_args = compare(f"{V}x{G} {name}", codes,
                                                   subset_mask(G, idx), len(idx))
        worst = max(worst, rel)
        call_gap = max(call_gap, call_against(f"{V}x{G} {name}", codes, idx))
        variants_ms, genomes_ms = time_cuda_turns(
            [lambda: fws._variant_counts(*variants_args),
             lambda: fws._genome_partials(*genomes_args)], 5)
        plain_ms = time_cuda(lambda: (fws._variant_counts_plain(*variants_args),
                                      fws._genome_partials_plain(*genomes_args)), 1, windows=2)
        times[name] = {"genomes": len(idx), "variants_ms": variants_ms,
                       "genomes_ms": genomes_ms, "plain_ms": plain_ms}
        log(f"  {name} ({len(idx)} genomes) at {V} x {G}: counts exact and hs sums within "
            f"{rel:.3e} of the plain version, FWS within {call_gap:.3e} of the reference; "
            f"fws_variants {variants_ms:.4f} ms, fws_genomes {genomes_ms:.4f} ms, byte bound "
            f"{pass_bound_ms:.4f} ms a pass; plain {plain_ms:.2f} ms")
        del variants_args, genomes_args
    errs["fws"] = call_gap

    analysis = PfEMPAnalysis(dev)
    ids = [f"G{g:05d}" for g in range(G)]
    columns = analysis.prepare_columns(codes, ids)
    analysis.statistics(columns)  # warm
    before = dict(fws.COUNTERS)
    kernels.reset_launches()
    t0 = time.perf_counter()
    result = analysis.statistics(columns)
    call_s = time.perf_counter() - t0
    path = dict(kernels.LAUNCHES)
    counted = {k: fws.COUNTERS[k] - before.get(k, 0) for k in ("genomes", "passes")}
    if path != {"fws_variants": 1, "fws_genomes": 1} or counted != {"genomes": G, "passes": 2}:
        raise AssertionError(f"fws: the statistics launched {path}, counted {counted}")
    log(f"  PfEMPAnalysis.statistics over {G} genomes: launches {path}, counters {counted}, "
        f"{call_s * 1e3:.2f} ms host-timed, {int(result.het.sum())} heterozygous calls")
    peak = torch.cuda.max_memory_allocated(dev)
    whole = times["all"]
    row = {"name": "fws", "route": "CUDA", "source": "kgl_gene_tpu_torch/csrc/fws.cu",
           "replaces": "none (kgl_gene_tpu/stats/fws.py CalcFWS is numpy on the host)",
           "ms": whole["variants_ms"] + whole["genomes_ms"], "plain_ms": whole["plain_ms"],
           "bound_ms": 2 * pass_bound_ms, "bound_by": "bytes", "library_ms": None,
           "issue_bound_ms": None, "variants_ms": whole["variants_ms"],
           "genomes_ms": whole["genomes_ms"], "pass_bound_ms": pass_bound_ms,
           "subset_ms": times["subset"]["variants_ms"] + times["subset"]["genomes_ms"],
           "max_abs_err_f": call_gap, "shape": [V, G]}
    summary = {"shape": [V, G], "max_rel_hs": worst, "max_fws_gap": call_gap, "sets": times,
               "pass_bound_ms": pass_bound_ms, "statistics_launches": path,
               "statistics_counters": counted, "statistics_host_ms": call_s * 1e3,
               "memory_peak_bytes": peak}
    return row, 2, summary


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from kgl_gene_tpu_torch import kernels
    except ImportError as exc:
        print(f"chip_smoke: the port is missing ({exc})", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    card = nvidia_smi_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    errs = dict.fromkeys(("translate", "myers", "wavefront", "banded", "banded_choices",
                          "myers_pool", "walk", "mica", "local", "local_pool",
                          "wavefront_chunk", "wavefront_chunks", "loglik", "hallme", "fws"), 0)
    launches = {}  # kernel row -> launches on the path it belongs to
    phase = "build"
    t_start = time.perf_counter()
    try:
        log("phase 1: build")
        t0 = time.perf_counter()
        from kgl_gene_tpu_torch import native
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            native_build = pool.submit(native.library)  # g++ beside the nvcc processes
            kernels.library()
            native_build.result()
        log(f"  built and loaded in {time.perf_counter() - t0:.1f} s "
            f"(the CUDA kernels and {native.LIB_PATH.name})")
        for line in kernels.build_log.splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log("  " + line.strip())

        phase = "kernels against plain versions"
        log(f"phase 2: {phase}")
        t0 = time.perf_counter()
        phase_kernels(dev, errs)
        phase_banded_kernels(dev, errs)
        local_kernel_cases(dev, errs)
        log(f"  phase 2: {time.perf_counter() - t0:.1f} s")

        phase = "main path: forward step"
        log(f"phase 3a: {phase}")
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED)
        region = gene_region(rng)
        configs = main_path_configs(rng, region)
        forward, steps, inputs = phase_main_path(dev, configs)
        log(f"  forward path launches: {forward}")
        for name in ("translate", "myers", "wavefront"):
            if forward.get(name, 0) < 1:
                raise AssertionError(f"kernel {name} never launched on the forward path")
            launches[name] = forward[name]
        log(f"  phase 3a: {time.perf_counter() - t0:.1f} s")

        phase = "main path: transcript family"
        log(f"phase 3b: {phase}")
        t0 = time.perf_counter()
        cfg = "a bench B=256 K=48"
        records, ref = family_records(steps[cfg](*inputs[cfg]), configs[cfg][1], region)
        with tempfile.TemporaryDirectory() as workdir:
            family, seqs, lens, matrix = phase_family(dev, records, ref, workdir)
        launches["banded_choices"] = family["banded_choices"]
        launches["walk"] = family["walk"]
        launches["myers_pool"] = family["myers"]
        doubling = phase_band_doubling(dev, seqs, lens, matrix)
        launches["banded"] = doubling["banded"]
        phase_wide_cigars(dev, errs)
        log(f"  phase 3b: {time.perf_counter() - t0:.1f} s")

        phase = "main path: product path"
        log(f"phase 3c: {phase}")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as workdir:
            product, band0 = phase_product(dev, workdir)
        log(f"  phase 3c: {time.perf_counter() - t0:.1f} s")

        phase = "main path: population scale"
        log(f"phase 3d: {phase}")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as workdir:
            scale, device_functions = phase_scale(dev, workdir)
        scale["phase_s"] = time.perf_counter() - t0
        log(f"  phase 3d: {scale['phase_s']:.1f} s")

        phase = "main path: phylogenetics"
        log(f"phase 3e: {phase}")
        t0 = time.perf_counter()
        phylo, phylo_functions = phase_phylo(dev)
        phylo["phase_s"] = time.perf_counter() - t0
        device_functions += phylo_functions
        log(f"  phase 3e: {phylo['phase_s']:.1f} s")

        phase = "main path: ontology"
        log(f"phase 3f: {phase}")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as workdir:
            ontology, mica_row, launches["mica"] = phase_ontology(dev, workdir, errs)
        ontology["phase_s"] = time.perf_counter() - t0
        log(f"  phase 3f: {ontology['phase_s']:.1f} s")

        phase = "main path: checkpoint ingest and the local metric"
        log(f"phase 3g: {phase}")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as workdir:
            checkpoint_local, local_launches, local_state = phase_checkpoint_local(
                dev, workdir, records, ref, errs)
        launches.update(local_launches)
        checkpoint_local["phase_s"] = time.perf_counter() - t0
        log(f"  phase 3g: {checkpoint_local['phase_s']:.1f} s")

        phase = "main path: the application shell, nine analyses"
        log(f"phase 3h: {phase}")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as workdir:
            package = phase_package(dev, workdir)
        package["phase_s"] = time.perf_counter() - t0
        log(f"  phase 3h: {package['phase_s']:.1f} s")

        phase = "main path: the multi-device forms"
        log(f"phase 3i: {phase}")
        multidevice, chunk_kernel_rows, chunk_launches = phase_multidevice(
            dev, seqs, lens, matrix, errs)
        launches.update(chunk_launches)
        log(f"  phase 3i: {multidevice['phase_s']:.1f} s")

        phase = "kernel loglik: the INBREED estimators' Loglikelihood"
        log(f"phase 3j: {phase}")
        t0 = time.perf_counter()
        loglik_row, launches["loglik"], loglik = phase_loglik(dev, errs)
        loglik["phase_s"] = time.perf_counter() - t0
        log(f"  phase 3j: {loglik['phase_s']:.1f} s")

        phase = "kernel hallme: the INBREED estimators' HallME"
        log(f"phase 3k: {phase}")
        t0 = time.perf_counter()
        hallme_row, launches["hallme"], hallme = phase_hallme(dev, errs)
        hallme["phase_s"] = time.perf_counter() - t0
        log(f"  phase 3k: {hallme['phase_s']:.1f} s")

        phase = "kernels fws: the PfEMP statistics' two passes"
        log(f"phase 3l: {phase}")
        t0 = time.perf_counter()
        fws_row, launches["fws"], fws_summary = phase_fws(dev, errs)
        fws_summary["phase_s"] = time.perf_counter() - t0
        log(f"  phase 3l: {fws_summary['phase_s']:.1f} s")

        phase = "times"
        log(f"phase 4: {phase} (card: {card})")
        t0 = time.perf_counter()
        rows = phase_times(dev, steps, inputs, configs, errs)
        rows += phase_family_times(dev, records, ref, seqs, lens, matrix, errs)
        rows.append(mica_row)
        rows += phase_local_times(dev, local_state, errs)
        rows += chunk_kernel_rows
        rows.append(loglik_row)
        rows.append(hallme_row)
        rows.append(fws_row)
        log(f"  phase 4: {time.perf_counter() - t0:.1f} s")
    except Exception:  # noqa: BLE001 - report the failing phase and exit non-zero
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' failed", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")

    # bound_ms sets integer operations against the float32 rate, as every
    # earlier run did; issue_bound_ms sets the integer kernels' counts
    # against the rate the card issues integer operations at (mica's merge
    # steps, a mix of pipes, against the dispatch rate: its row brings its
    # own). No bound may read above a time.
    int_rate = issue_rate()
    log(f"integer issue rate: {int_rate / 1e12:.3f} T/s (64 lanes x SMs x max SM clock)")
    report = []
    for r in rows:
        issue_ms = r.get("issue_bound_ms",
                         r["int_ops"] / int_rate * 1e3 if "int_ops" in r else None)
        least = min(r["ms"], r.get("device_ms", r["ms"]))
        if (max(r["bound_ms"], issue_ms or 0.0, r.get("latency_bound_ms", 0.0)) > least
                or r.get("cold_latency_bound_ms", 0.0) > r.get("cold_ms", math.inf)):
            print(f"chip_smoke: a bound of {r['name']} reads above its time", file=sys.stderr)
            return 1
        report.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": launches[r["name"]],
            "max_abs_err": errs[r["name"]], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "issue_bound_ms": issue_ms,
            **({"launches_product": {kind: counts.get(r["name"], 0)
                                     for kind, counts in product.items()},
                "launches_indel_band0": band0.get(r["name"], 0)}
               if r["name"] in ("translate", "myers", "wavefront") else {}),
            **{key: val for key, val in r.items()
               if ("_ms" in key or key.startswith("ms_") or key.endswith("_ns")
                   or key.startswith("latency_")
               or key in ("plain_pairs", "geometry", "shape", "max_abs_err_f"))
               and key not in ("plain_ms", "bound_ms", "library_ms", "issue_bound_ms")},
        })
    print(json.dumps({"device_functions": device_functions}))
    print(json.dumps({"scale": scale}))
    print(json.dumps({"phylo": phylo}))
    print(json.dumps({"ontology": ontology}))
    print(json.dumps({"checkpoint_local": checkpoint_local}))
    print(json.dumps({"package": package}))
    print(json.dumps({"multidevice": multidevice}))
    print(json.dumps({"loglik": loglik}))
    print(json.dumps({"hallme": hallme}))
    print(json.dumps({"fws": fws_summary}))
    print(json.dumps({"kernels": report}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
