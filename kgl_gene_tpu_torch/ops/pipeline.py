"""The population x transcript forward steps: SNP only, and SNP + indel.

Counterpart of kgl_gene_tpu/ops/pipeline.py (ForwardOutputs, _forward,
make_forward_step; IndelForwardOutputs, _forward_indel,
make_indel_forward_step, reconstruct_indel_coding_host). For a batch of
sample genomes against one transcript the SNP step does:
  1. apply each sample's SNPs to the region,
  2. splice the exons and convert the strand,
  3. translate the codons (kernel B2),
  4. compute each mutant's edit distance to the reference coding sequence
     (kernel B1, banded Myers, when the SNP budget bounds the band and the
     transcript is long; kernel B3, the exact wavefront, otherwise),
  5. derive the validity code and the allele counts.

The SNP + indel step (forward_indel) applies SNP, deletion and insertion
cocktails under fixed shapes through prefix-summed length deltas, splices
the exons in modified coordinates by one gather, translates at the padded
width (B2) and measures each mutant against the reference coding sequence
with its own length: B1 in shared-text mode when the capture's edit bound
gives a band, B3 otherwise.

make_multichip_step and make_multichip_indel_step are the steps over a
mesh of ranks (parallel/dist.py SampleMesh, one process a rank): each rank
runs the same step body on its shard of the genomes, on its own device,
and the SNP step sums its allele counts over the ranks.

On the card every kernel launches; on the CPU each wrapper runs its plain
PyTorch version, which is how the tests hold the steps against the JAX
ones.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..parallel.dist import SampleMesh, psum
from ..sequence.alphabet import DNA5, AminoAcid
from ..sequence.tables import amino_translation_table
from ..tracing import span
from .myers import myers_band_for, myers_distance_padded
from .variant_apply import apply_snp_batch, complement_codes, translate_batch_kernel
from .wavefront import batched_levenshtein_kernel

__all__ = [
    "ForwardOutputs",
    "IndelForwardOutputs",
    "forward",
    "forward_indel",
    "indel_band_for",
    "make_forward_step",
    "make_indel_forward_step",
    "make_multichip_indel_step",
    "make_multichip_step",
    "pad_coding_for",
    "reconstruct_indel_coding_host",
    "reconstruct_indel_coding_plain",
]

# The banded distance pays off only on long transcripts.
MIN_BANDED_LEN = 512


class ForwardOutputs(NamedTuple):
    mutated_coding: torch.Tensor  # (B, S) uint8 spliced mutated coding codes
    amino: torch.Tensor           # (B, S//3) uint8 amino codes
    distance: torch.Tensor        # (B,) int32 edit distance mutant vs reference
    allele_counts: torch.Tensor   # (K,) int32 alt allele counts over the batch
    valid_protein: torch.Tensor   # (B,) bool: start, stop, no internal stop
    validity_code: torch.Tensor   # (B,) int32: 0 valid / 1 no-stop / 2 nonsense / 3 no-start


def _splice_slices(batch: torch.Tensor, exon_starts: Sequence[int],
                   exon_lens: Sequence[int]) -> torch.Tensor:
    """Contiguous-exon splice: a concat of slices. A start is clamped so
    its slice fits, as a dynamic slice clamps."""
    L = batch.shape[1]
    parts = []
    for s, n in zip(exon_starts, exon_lens):
        s = min(max(int(s), 0), L - n)
        parts.append(batch[:, s : s + n])
    return parts[0] if len(parts) == 1 else torch.cat(parts, 1)


def forward(
    region: torch.Tensor,          # (L,) uint8 reference region codes
    exon_starts: Sequence[int],    # region-relative exon starts
    exon_lens: Sequence[int],      # exon lengths (sum = S)
    reverse_strand: bool,
    positions: torch.Tensor,       # (B, K) region-relative SNP positions
    alt_codes: torch.Tensor,       # (B, K)
    valid: torch.Tensor,           # (B, K) bool
    amino_lut: torch.Tensor,       # (65,) uint8
    stop_code: int,
    start_codes: torch.Tensor,     # amino codes acceptable at position 0
) -> ForwardOutputs:
    with span("kgt.step.apply"):
        mutated = apply_snp_batch(region, positions, alt_codes, valid)
        coding = _splice_slices(mutated, exon_starts, exon_lens)
        ref_coding = _splice_slices(region[None, :], exon_starts, exon_lens)
        if reverse_strand:
            coding = complement_codes(torch.flip(coding, [1]))
            ref_coding = complement_codes(torch.flip(ref_coding, [1]))
        coding = coding.contiguous()
    with span("kgt.step.translate"):
        amino = translate_batch_kernel(coding, amino_lut)

    with span("kgt.step.distance"):
        B, S = coding.shape
        lens = torch.full((B,), S, dtype=torch.int32, device=coding.device)
        a = coding.to(torch.int32)
        b = ref_coding.to(torch.int32).contiguous()
        # Every variant is a substitution, so Levenshtein <= Hamming <= K and
        # the lengths are equal: a band >= K provably holds the distance.
        band_k = myers_band_for(positions.shape[1], max_band=127)
        if band_k and S >= MIN_BANDED_LEN:
            distance = myers_distance_padded(a, lens, b, lens, band_k=band_k)
        else:
            distance = batched_levenshtein_kernel(a, lens, b, lens)

    with span("kgt.step.checks"):
        # Validity: starts with a start amino, ends with stop, no internal stop.
        starts_ok = torch.isin(amino[:, 0], start_codes)
        ends_ok = amino[:, -1] == stop_code
        internal_stops = (amino[:, :-1] == stop_code).sum(1)
        valid_protein = starts_ok & ends_ok & (internal_stops == 0)
        # 0 VALID_PROTEIN, 1 NO_STOP_CODON, 2 NONSENSE_MUTATION, 3 NO_START_CODON,
        # the highest applicable code winning.
        validity_code = torch.maximum(
            torch.maximum((~ends_ok).to(torch.int32), 2 * (internal_stops > 0).to(torch.int32)),
            3 * (~starts_ok).to(torch.int32),
        )
        allele_counts = valid.to(torch.int32).sum(0, dtype=torch.int32)
    return ForwardOutputs(
        mutated_coding=coding, amino=amino, distance=distance,
        allele_counts=allele_counts, valid_protein=valid_protein,
        validity_code=validity_code,
    )


def make_forward_step(
    region_codes: np.ndarray,
    exon_intervals: np.ndarray,
    region_start: int,
    reverse_strand: bool = False,
    table_name: str = "NCBI_TABLE_1",
    device=None,
):
    """A forward step closed over one transcript's geometry.

    step(positions, alt_codes, valid) -> ForwardOutputs, with numpy arrays
    or tensors in and tensors on `device` out. The step runs on the card
    unless device='cpu'."""
    dev = resolve_device(device)
    table = amino_translation_table(table_name)
    exon_intervals = np.asarray(exon_intervals, dtype=np.int64)
    exon_starts = [int(lo - region_start) for lo, _hi in exon_intervals]
    exon_lens = [int(hi - lo) for lo, hi in exon_intervals]
    region = torch.as_tensor(np.asarray(region_codes, dtype=np.uint8), device=dev)
    amino_lut = torch.as_tensor(table.amino_lut, dtype=torch.uint8, device=dev)
    start_codes = torch.as_tensor(table.start_codes(), dtype=torch.uint8, device=dev)

    def step(positions, alt_codes, valid) -> ForwardOutputs:
        with span("kgt.step"):
            with span("kgt.step.upload"):
                positions = torch.as_tensor(positions, device=dev)
                alt_codes = torch.as_tensor(alt_codes, device=dev)
                valid = torch.as_tensor(valid, device=dev)
            return forward(region, exon_starts, exon_lens, reverse_strand, positions,
                           alt_codes, valid, amino_lut, AminoAcid.STOP, start_codes)

    return step


# --------------------------------------------------------------------------- #
# The SNP + indel step
# --------------------------------------------------------------------------- #
class IndelForwardOutputs(NamedTuple):
    mutated_coding: torch.Tensor  # (B, S_pad) uint8 coding codes, valid to coding_len
    coding_len: torch.Tensor      # (B,) int32 coding length per genome
    amino: torch.Tensor           # (B, S_pad//3) uint8 amino codes (garbage past len)
    distance: torch.Tensor        # (B,) int32 edit distance vs reference coding
    validity_code: torch.Tensor   # (B,) int32: 0 valid / 1 no-stop / 2 nonsense /
                                  # 3 no-start / 4 not mod 3


def pad_coding_for(pad_coding: int) -> int:
    """The coding slack the step allocates: at least 3, a multiple of 3."""
    return ((max(pad_coding, 3) + 2) // 3) * 3


def indel_band_for(edit_bound: int) -> int:
    """The Myers band that holds a batch whose genomes make at most
    edit_bound edits each (31, 63 or 127), or 0 for the exact wavefront."""
    return myers_band_for(edit_bound, max_band=127) or 0


def _scatter_dropped(buf: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
                     src: torch.Tensor, add: bool = False) -> torch.Tensor:
    """A JAX scatter with mode="drop" on (B, W) `buf`: the writes where `ok`
    holds and 0 <= idx < W land, the rest go to a spill column that is cut
    away again. add=True sums (the marker scatters), else the write is a
    set; the indices a set writes must be unique per row."""
    B, W = buf.shape
    idx = idx.to(torch.int64)
    idx = torch.where(ok & (idx >= 0) & (idx < W), idx, W)
    out = torch.cat([buf, buf.new_zeros(B, 1)], 1)
    if add:
        out.scatter_add_(1, idx, src.to(buf.dtype))
    else:
        out.scatter_(1, idx, src.to(buf.dtype))
    return out[:, :W]


def forward_indel(
    region: torch.Tensor,          # (L,) uint8 reference region codes
    exon_bounds: np.ndarray,       # (E, 2) region-relative exon [lo, hi)
    reverse_strand: bool,
    pos: torch.Tensor,             # (B, K) region-relative insert offsets
    kind: torch.Tensor,            # (B, K) 0 SNP / 1 DEL / 2 INS
    del_len: torch.Tensor,         # (B, K) deletion lengths (region-clamped)
    ins_codes: torch.Tensor,       # (B, K, A) inserted base codes
    ins_len: torch.Tensor,         # (B, K) inserted base counts
    alt_code: torch.Tensor,        # (B, K) SNP substitution codes
    valid: torch.Tensor,           # (B, K) bool slot validity
    amino_lut: torch.Tensor,       # (65,) uint8
    stop_code: int,
    start_codes: torch.Tensor,     # amino codes acceptable at position 0
    pad_coding: int,               # coding slack (>= K*A, a multiple of 3)
    band_k: int,                   # Myers band (31/63/127), or 0: exact wavefront
) -> IndelForwardOutputs:
    """The general variant-apply step: SNP/insert/delete cocktails under
    fixed shapes (reference semantics: AdjustedSequence + ModifiedOffsetMap,
    kgl_mutation/kgl_mutation_sequence.h:26, kgl_mutation_translate.h:72).

    Per genome unit[p] = bases inserted before p + kept(p); its exclusive
    prefix sum gives every base's output slot and the original -> modified
    coordinate map m(x) the exon splice reads. Capture's preconditions
    (non-overlapping indel spans, one insertion a position, insert
    positions in [0, L]) make every set-scatter's indices unique, so no
    write depends on the order the card does them in."""
    B, K = pos.shape
    A = ins_codes.shape[2]
    L = region.shape[0]
    dev = region.device
    exon_bounds = np.asarray(exon_bounds, dtype=np.int64)
    S_ref = int(sum(int(hi - lo) for lo, hi in exon_bounds))
    S_pad = ((S_ref + pad_coding + 2) // 3) * 3  # translation needs a mod-3 width
    W_out = L + pad_coding

    pos = pos.to(torch.int64)
    kind = kind.to(torch.int64)
    valid = valid.to(torch.bool)
    snp_m = valid & (kind == 0)
    del_m = valid & (kind == 1)
    ins_m = valid & (kind == 2)

    # 1. SNPs in place; the last valid slot at a position wins, as the JAX
    #    scatter does.
    base = apply_snp_batch(region, pos, alt_code, snp_m)

    # 2. Deletion mask by +-1 markers and a cumulative sum (no-overlap
    #    precondition enforced at capture): one scatter-add over the start
    #    and end slots.
    del_end = (pos + del_len.to(torch.int64)).clamp(max=L)
    marker = _scatter_dropped(
        torch.zeros(B, L + 1, dtype=torch.int32, device=dev),
        torch.cat([pos, del_end], 1), torch.cat([del_m, del_m], 1),
        torch.cat([torch.ones(B, K, dtype=torch.int32, device=dev),
                   torch.full((B, K), -1, dtype=torch.int32, device=dev)], 1),
        add=True,
    )
    keep = (torch.cumsum(marker[:, :L], 1, dtype=torch.int32) <= 0).to(torch.int32)

    # 3. Insertions: bases inserted BEFORE original position p (p == L
    #    appends at the region end).
    ins_at = _scatter_dropped(torch.zeros(B, L + 1, dtype=torch.int32, device=dev),
                              pos, ins_m, ins_len, add=True)
    unit = ins_at + torch.nn.functional.pad(keep, (0, 1))
    cum = torch.cumsum(unit, 1, dtype=torch.int32) - unit  # exclusive
    # m(x) for x in [0, L]: the output offset of original x after the
    # insertions at x; kept base p lands at m(p).
    m_map = cum + ins_at
    out = torch.full((B, W_out), 4, dtype=torch.uint8, device=dev)  # N padding
    out = _scatter_dropped(out, m_map[:, :L], keep > 0, base)
    # Inserted bases at cum[pos] + j, one scatter over the (K, A) slot grid.
    # An insert position outside [0, L] drops its bases, as the JAX gather
    # fills such a start with a value no write lands at.
    ins_ok_pos = ins_m & (pos >= 0) & (pos <= L)
    ins_start = torch.gather(cum, 1, torch.where(ins_ok_pos, pos, L))
    j_idx = torch.arange(A, device=dev)[None, None, :]
    ins_ok = ins_ok_pos[:, :, None] & (j_idx < ins_len.to(torch.int64)[:, :, None])
    out = _scatter_dropped(out, (ins_start[:, :, None] + j_idx).reshape(B, K * A),
                           ins_ok.reshape(B, K * A), ins_codes.reshape(B, K * A))

    # 4. Exon splice in modified coordinates: coding position c belongs to
    #    exon e when cs_e <= c < cs_e + le_e; one gather.
    c_idx = torch.arange(S_pad, dtype=torch.int32, device=dev)[None, :]
    gather_idx = torch.zeros(B, S_pad, dtype=torch.int32, device=dev)
    in_any = torch.zeros(B, S_pad, dtype=torch.bool, device=dev)
    cs = torch.zeros(B, 1, dtype=torch.int32, device=dev)
    for lo, hi in exon_bounds:
        mlo = m_map[:, int(lo)][:, None]
        le = m_map[:, int(hi)][:, None] - mlo
        sel = (c_idx >= cs) & (c_idx < cs + le)
        gather_idx = torch.where(sel, mlo + (c_idx - cs), gather_idx)
        in_any = in_any | sel
        cs = cs + le
    coding_len = cs[:, 0]
    coding = torch.gather(out, 1, gather_idx.clamp(0, W_out - 1).to(torch.int64))
    coding = torch.where(in_any, coding, 4)
    if reverse_strand:
        rev_idx = (coding_len[:, None] - 1 - c_idx).clamp(0, S_pad - 1)
        coding = torch.where(c_idx < coding_len[:, None],
                             complement_codes(torch.gather(coding, 1, rev_idx.to(torch.int64))),
                             4)
    coding = coding.to(torch.uint8).contiguous()

    # 5. Translation (kernel B2) and validity with per-genome lengths.
    amino = translate_batch_kernel(coding, amino_lut)
    n_amino = coding_len // 3
    M = amino.shape[1]
    a_idx = torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    starts_ok = torch.isin(amino[:, 0], start_codes) & (n_amino > 0)
    last_amino = torch.gather(amino, 1, (n_amino[:, None] - 1).clamp(0, M - 1).to(torch.int64))
    ends_ok = (last_amino[:, 0] == stop_code) & (n_amino > 0)
    internal_stops = ((amino == stop_code) & (a_idx < n_amino[:, None] - 1)).sum(1)
    validity_code = torch.maximum(
        torch.maximum((~ends_ok).to(torch.int32), 2 * (internal_stops > 0).to(torch.int32)),
        3 * (~starts_ok).to(torch.int32),
    )
    validity_code = torch.where(coding_len % 3 != 0, 4, validity_code)

    # 6. Distance against the reference coding sequence, one shared text.
    ref_coding = _splice_slices(region[None, :], exon_bounds[:, 0].tolist(),
                                (exon_bounds[:, 1] - exon_bounds[:, 0]).tolist())
    if reverse_strand:
        ref_coding = complement_codes(torch.flip(ref_coding, [1]))
    a = coding.to(torch.int32)
    b = ref_coding.to(torch.int32).contiguous()
    len_ref = torch.full((B,), S_ref, dtype=torch.int32, device=dev)
    if band_k > 0:
        distance = myers_distance_padded(a, coding_len, b, len_ref, band_k=band_k)
    else:
        distance = batched_levenshtein_kernel(a, coding_len, b, len_ref)
    return IndelForwardOutputs(
        mutated_coding=coding, coding_len=coding_len, amino=amino,
        distance=distance, validity_code=validity_code,
    )


def make_indel_forward_step(
    region_codes: np.ndarray,
    exon_intervals: np.ndarray,
    region_start: int,
    reverse_strand: bool = False,
    table_name: str = "NCBI_TABLE_1",
    pad_coding: int = 0,
    band_k: int = 0,
    device=None,
):
    """The SNP + indel step closed over one transcript's geometry.

    step(pos, kind, del_len, ins_codes, ins_len, alt_code, valid) ->
    IndelForwardOutputs, numpy arrays or tensors in, tensors on `device`
    out. pad_coding is the coding slack (rounded up to a multiple of 3);
    band_k > 0 takes kernel B1 at that band, which is exact while every
    genome makes at most band_k edits; 0 takes kernel B3. The step runs on
    the card unless device='cpu'."""
    dev = resolve_device(device)
    table = amino_translation_table(table_name)
    exon_intervals = np.asarray(exon_intervals, dtype=np.int64)
    exon_bounds = exon_intervals - region_start
    region = torch.as_tensor(np.asarray(region_codes, dtype=np.uint8), device=dev)
    amino_lut = torch.as_tensor(table.amino_lut, dtype=torch.uint8, device=dev)
    start_codes = torch.as_tensor(table.start_codes(), dtype=torch.uint8, device=dev)
    pad_coding = pad_coding_for(pad_coding)

    def step(pos, kind, del_len, ins_codes, ins_len, alt_code, valid) -> IndelForwardOutputs:
        return forward_indel(
            region, exon_bounds, reverse_strand,
            *(torch.as_tensor(x, device=dev)
              for x in (pos, kind, del_len, ins_codes, ins_len, alt_code, valid)),
            amino_lut, AminoAcid.STOP, start_codes, pad_coding, band_k,
        )

    return step


def make_multichip_step(
    mesh: SampleMesh,
    region_codes: np.ndarray,
    exon_intervals: np.ndarray,
    region_start: int,
    reverse_strand: bool = False,
    table_name: str = "NCBI_TABLE_1",
):
    """The SNP step over a mesh of ranks: samples sharded over the ranks,
    the transcript geometry on every rank, allele counts summed over them.

    step(positions, alt_codes, valid, zygosity) takes this rank's shard of
    each (parallel.dist.rank_rows: axis 0 padded with zeros to a
    multiple of the world size, so a padded genome has no valid SNP and
    distance 0) and returns (distance, allele_counts, pop_ac): this rank's
    (B_local,) int32 distances, and the (K,) allele counts and the
    (V,) zygosity column sums, both int32 and summed over the ranks. The
    body on each rank is forward on the rank's device, so kernels B1, B2
    and B3 run there as on one card (the plain versions on the CPU)."""
    one = make_forward_step(region_codes, exon_intervals, region_start,
                            reverse_strand, table_name, device=mesh.device)

    def step(positions, alt_codes, valid, zygosity):
        out = one(positions, alt_codes, valid)
        zyg = torch.as_tensor(zygosity, device=mesh.device)
        pop_ac = zyg.to(torch.int32).sum(0, dtype=torch.int32)
        return out.distance, psum(out.allele_counts, mesh), psum(pop_ac, mesh)

    return step


def make_multichip_indel_step(
    mesh: SampleMesh,
    region_codes: np.ndarray,
    exon_intervals: np.ndarray,
    region_start: int,
    reverse_strand: bool = False,
    table_name: str = "NCBI_TABLE_1",
    pad_coding: int = 0,
    band_k: int = 0,
):
    """The SNP + indel step over a mesh of ranks: samples sharded over the
    ranks, the transcript geometry on every rank (the reference's fan-out
    is the per-genome thread pool, kga_analysis_lib_seqmutation.cpp:
    116-140).

    step(pos, kind, del_len, ins_codes, ins_len, alt_code, valid) takes
    this rank's shard of each and returns this rank's (coding_len,
    distance, validity_code), each (B_local,) int32; the caller gathers
    them (parallel.dist.gather_rows). pad_coding and band_k as in
    make_indel_forward_step."""
    one = make_indel_forward_step(region_codes, exon_intervals, region_start,
                                  reverse_strand, table_name, pad_coding, band_k,
                                  device=mesh.device)

    def step(pos, kind, del_len, ins_codes, ins_len, alt_code, valid):
        out = one(pos, kind, del_len, ins_codes, ins_len, alt_code, valid)
        return out.coding_len, out.distance, out.validity_code

    return step


def reconstruct_indel_coding_host(
    region_codes: np.ndarray,     # (L,) reference region codes
    exon_bounds: np.ndarray,      # (E, 2) region-relative exon [lo, hi)
    reverse_strand: bool,
    pos: np.ndarray, kind: np.ndarray, del_len: np.ndarray,
    ins_codes: np.ndarray, ins_len: np.ndarray, alt_code: np.ndarray,
    valid: np.ndarray,
    pad_coding: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host replay of forward_indel steps 1-4 (SNP scatter, deletion
    mask, insertion prefix map, exon splice in modified coordinates,
    strand convert): (coding (B, S_pad) codes, coding_len (B,)).

    Lets the pooled device program ship 8-byte tails instead of packed
    sequences: the mutant strings re-derive on the host from the capture
    tensors the device consumed, by the same formulas. Runs the native
    single-pass replay (native/kgt_native.cpp kgt_indel_reconstruct);
    reconstruct_indel_coding_plain is its numpy plain version."""
    from ..native import indel_reconstruct

    exon_bounds = np.asarray(exon_bounds, np.int64)
    pad_coding = pad_coding_for(pad_coding)
    S_ref = int(sum(int(hi - lo) for lo, hi in exon_bounds))
    S_pad = ((S_ref + pad_coding + 2) // 3) * 3
    return indel_reconstruct(
        region_codes, exon_bounds, reverse_strand, pos, kind, del_len,
        ins_codes, ins_len, alt_code, valid, pad_coding, DNA5.COMPLEMENT,
        S_pad,
    )


def reconstruct_indel_coding_plain(
    region_codes: np.ndarray,
    exon_bounds: np.ndarray,
    reverse_strand: bool,
    pos: np.ndarray, kind: np.ndarray, del_len: np.ndarray,
    ins_codes: np.ndarray, ins_len: np.ndarray, alt_code: np.ndarray,
    valid: np.ndarray,
    pad_coding: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy replay that reconstruct_indel_coding_host's native form
    is held against: the same arguments, the same result."""
    B, K = pos.shape
    A = ins_codes.shape[2]
    L = int(region_codes.shape[0])
    exon_bounds = np.asarray(exon_bounds, np.int64)
    S_ref = int(sum(int(hi - lo) for lo, hi in exon_bounds))
    pad_coding = pad_coding_for(pad_coding)
    S_pad = ((S_ref + pad_coding + 2) // 3) * 3

    pos = pos.astype(np.int32)
    valid = valid.astype(bool)
    snp_m = valid & (kind == 0)
    del_m = valid & (kind == 1)
    ins_m = valid & (kind == 2)

    # 1. SNPs in place.
    base = np.repeat(region_codes[None, :].astype(np.uint8), B, axis=0)
    bi, ki = np.nonzero(snp_m & (pos >= 0) & (pos < L))
    base[bi, pos[bi, ki]] = alt_code[bi, ki].astype(np.uint8)

    # 2. Deletion mask via +-1 markers and a cumulative sum.
    marker = np.zeros((B, L + 1), np.int32)
    bi, ki = np.nonzero(del_m & (pos >= 0) & (pos <= L))
    np.add.at(marker, (bi, pos[bi, ki]), 1)
    ends = np.minimum(pos + del_len, L)
    np.add.at(marker, (bi, ends[bi, ki]), -1)
    deleted = np.cumsum(marker[:, :L], axis=1) > 0
    keep = (~deleted).astype(np.int32)

    # 3. Insertions before original position p.
    ins_at = np.zeros((B, L + 1), np.int32)
    bi, ki = np.nonzero(ins_m & (pos >= 0) & (pos <= L))
    np.add.at(ins_at, (bi, pos[bi, ki]), ins_len[bi, ki].astype(np.int32))
    unit = ins_at + np.pad(keep, ((0, 0), (0, 1)))
    cum = np.cumsum(unit, axis=1) - unit
    m_map = cum + ins_at
    W_out = L + pad_coding
    out = np.full((B, W_out), 4, np.uint8)
    kb, kp = np.nonzero(keep[:, :L] > 0)
    dst = m_map[kb, kp]
    ok = dst < W_out  # the device scatter drops out-of-buffer writes
    out[kb[ok], dst[ok]] = base[kb[ok], kp[ok]]
    ins_start = np.take_along_axis(cum, np.where(ins_m, pos, L), axis=1)
    for j in range(A):
        bi, ki = np.nonzero(ins_m & (j < ins_len) & (pos >= 0) & (pos <= L))
        dst = ins_start[bi, ki] + j
        ok = dst < W_out
        out[bi[ok], dst[ok]] = ins_codes[bi[ok], ki[ok], j].astype(np.uint8)

    # 4. Exon splice in modified coordinates (flat int32 gathers).
    c_idx = np.arange(S_pad, dtype=np.int32)[None, :]
    gather_idx = np.zeros((B, S_pad), np.int32)
    in_any = np.zeros((B, S_pad), bool)
    cs = np.zeros((B, 1), np.int32)
    for lo, hi in exon_bounds:
        mlo = m_map[:, int(lo)][:, None]
        mhi = m_map[:, int(hi)][:, None]
        le = mhi - mlo
        sel = (c_idx >= cs) & (c_idx < cs + le)
        gather_idx = np.where(sel, mlo + (c_idx - cs), gather_idx)
        in_any |= sel
        cs = cs + le
    coding_len = cs[:, 0]
    flat = (
        np.clip(gather_idx, 0, W_out - 1)
        + (np.arange(B, dtype=np.int64) * W_out)[:, None]
    )
    coding = out.reshape(-1)[flat]
    coding = np.where(in_any, coding, 4).astype(np.uint8)
    if reverse_strand:
        rev_idx = np.clip(coding_len[:, None] - 1 - c_idx, 0, S_pad - 1)
        flat = rev_idx + (np.arange(B, dtype=np.int64) * S_pad)[:, None]
        coding = np.where(
            c_idx < coding_len[:, None],
            DNA5.COMPLEMENT[coding.reshape(-1)[flat]],
            4,
        ).astype(np.uint8)
    return coding, coding_len
