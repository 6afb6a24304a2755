"""FWS within-host fixation statistics.

Capability parity with the PfEMP FWS analysis
(kga_analytic/kga_PfEMP/kga_analysis_PfEMP_FWS.h:15-52): per-genome
heterozygosity summaries binned by population allele frequency (the 11
AlleleFrequencyBins), per-variant het/hom summaries, and the FWS index
FWS = 1 - Hw/Hs (within-host vs population-level expected heterozygosity),
computed as vectorized reductions over the variant-major zygosity matrix.

Two forms of the same statistics:

  - CalcFWS, a copy of kgl_gene_tpu/stats/fws.py: numpy on the host over a
    VariantMajorView (a dense G x V matrix). The CPU tests hold the device
    form against it.
  - fws_statistics(codes, index): over a population's (V, G) uint8 codes
    resident on a device (variant/columnar.py resident_codes' layout) and a
    subset of its genomes given as an index. For each variant, over the
    subset: heterozygous and homozygous counts, AF = (het + 2 hom) /
    (2 G_sub) in float64, hs = 2p(1 - p) in float64, and its bin (lo <= AF
    < hi); for each genome of the subset: each bin's heterozygous and
    homozygous counts, their totals, hs_sum (float64) over the loci it
    carries, and FWS = 1 - het / hs_sum, 1 where hs_sum is 0. Two passes
    over the codes, no (G, V) temporary: pass one counts each variant over
    the subset; the variants are then ordered by bin and cut into segments
    of one bin each, and pass two sums each genome over each segment. On
    the card each pass is a kernel (csrc/fws.cu: `fws_variants`, a warp a
    row; `fws_genomes`, a thread eight genomes of a segment's rows); a CPU
    tensor takes the plain versions, _variant_counts_plain and
    _genome_partials_plain. Every count is exact; the hs sums differ from
    CalcFWS's only in the order of float64 additions.

COUNTERS counts, over the process, the genomes and variants of each call,
its passes over the codes and the bytes of codes they read. Spans
(tracing.span): kgt.fws.upload (the subset's index and mask), .variants
(pass one, AF, hs, bins and segments), .genomes (pass two and the per-genome
sums) and .fetch; the analysis opens kgt.fws around them
(analysis/pfemp_analysis.py).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..tracing import span
from ..variant.columnar import ROW_ALIGN, AlleleSummary, VariantMajorView

__all__ = ["COUNTERS", "FREQUENCY_BINS", "CalcFWS", "FwsResult", "fws_statistics",
           "frequency_bins", "segment_bounds", "write_genome_csv"]

# (lower, upper) AF bins — AlleleFrequencyBins PERCENT_0_5 .. PERCENT_50_100.
FREQUENCY_BINS: List[Tuple[float, float]] = [
    (0.00, 0.05), (0.05, 0.10), (0.10, 0.15), (0.15, 0.20), (0.20, 0.25),
    (0.25, 0.30), (0.30, 0.35), (0.35, 0.40), (0.40, 0.45), (0.45, 0.50),
    (0.50, 1.00001),
]
N_BINS = len(FREQUENCY_BINS)
# A variant's bin is the number of these lower edges at or below its AF
# (an AF lies in [0, 1], inside the first bin's lower and the last's upper edge).
_LOWER_EDGES = tuple(lo for lo, _hi in FREQUENCY_BINS[1:])
# Pass two's segments: the variants, ordered by bin, are cut into at most
# SEGMENTS pieces of SEGMENT_ROWS rows or more, and at each bin's end.
SEGMENTS = 512
SEGMENT_ROWS = 4096
# Kernel `fws_genomes` (csrc/fws.cu, FG_*): genomes a tile, the width its
# partial sums are written at.
GENOME_TILE = 1024
# Rows a block of the plain versions takes at a time.
_PLAIN_ROWS = 4096

# Work counted over the process (as kernels.LAUNCHES counts launches).
COUNTERS: collections.Counter = collections.Counter()


@dataclass
class GenomeFws:
    """Per-genome binned summaries + the FWS index."""

    bins: List[AlleleSummary] = field(default_factory=lambda: [AlleleSummary() for _ in FREQUENCY_BINS])
    fws: float = 0.0


class CalcFWS:
    """FWS statistics over a population (CalcFWS::calcFwsStatistics)."""

    def __init__(self, view: VariantMajorView, allele_freq: np.ndarray = None):
        self.view = view
        # Population allele frequency per variant: supplied (e.g. from the
        # Pf7 AF INFO field) or derived from the population itself.
        self.allele_freq = (
            np.asarray(allele_freq)
            if allele_freq is not None
            else view.allele_frequencies()
        )
        self.genome_map: Dict[str, GenomeFws] = {}
        self._variant_map: Optional[Dict[str, AlleleSummary]] = None
        self._calculate()

    def _calculate(self) -> None:
        z = self.view.zygosity  # (G, V)
        af = self.allele_freq
        het = z == 1
        hom = z == 2

        # Per-variant counts (updateVariantFWSMap); keyed by HGVS in variant_map.
        self.variant_het = het.sum(axis=0)
        self.variant_hom = hom.sum(axis=0)

        # Per-genome binned summaries (updateGenomeFWSMap).
        bin_masks = [
            (af >= lo) & (af < hi) for lo, hi in FREQUENCY_BINS
        ]
        # Population expected heterozygosity per variant: Hs = 2p(1-p).
        hs = 2.0 * af * (1.0 - af)

        for g, gid in enumerate(self.view.genome_ids):
            result = GenomeFws()
            hw_sum = 0.0
            hs_sum = 0.0
            for b, mask in enumerate(bin_masks):
                result.bins[b] = AlleleSummary(
                    heterozygous=int(np.sum(het[g] & mask)),
                    homozygous=int(np.sum(hom[g] & mask)),
                )
                # Within-host heterozygosity: fraction of this genome's
                # called loci in the bin that are heterozygous.
                called = het[g] | hom[g]
                n_called = np.sum(called & mask)
                if n_called > 0:
                    hw_sum += float(np.sum(het[g] & mask))
                    hs_sum += float(np.sum(np.where(called & mask, hs, 0.0)))
            result.fws = 1.0 - hw_sum / hs_sum if hs_sum > 0 else 1.0
            self.genome_map[gid] = result

    @property
    def variant_map(self) -> Dict[str, AlleleSummary]:
        """Each variant's het/hom counts keyed by its HGVS string, built on
        first use (a report's, not the statistics')."""
        if self._variant_map is None:
            self._variant_map = {
                hgvs: AlleleSummary(int(self.variant_het[i]), int(self.variant_hom[i]))
                for i, hgvs in enumerate(self.view.hgvs)}
        return self._variant_map

    # ------------------------------------------------------------------ #
    def fws_by_genome(self) -> Dict[str, float]:
        return {gid: r.fws for gid, r in self.genome_map.items()}

    def monoclonal_genomes(self, threshold: float = 0.95) -> List[str]:
        """Samples with FWS >= threshold are monoclonal (the 0.95 threshold
        of the Pf7 FWS resource, kgl_pf7_fws_parser.h:26-80)."""
        return [gid for gid, r in self.genome_map.items() if r.fws >= threshold]

    def write_genome_results(self, file_name: str, fws_resource=None) -> None:
        """CSV output (writeGenomeResults); optionally joins the published
        Pf7 FWS values for comparison."""
        results = list(self.genome_map.values())
        write_genome_csv(
            file_name, list(self.genome_map), [r.fws for r in results],
            [[b.heterozygous for b in r.bins] for r in results],
            [[b.homozygous for b in r.bins] for r in results], fws_resource)

    def write_variant_results(self, file_name: str) -> None:
        with open(file_name, "w") as f:
            f.write("Variant,Heterozygous,Homozygous\n")
            for hgvs, summary in sorted(self.variant_map.items()):
                f.write(f"{hgvs},{summary.heterozygous},{summary.homozygous}\n")


def write_genome_csv(file_name: str, genome_ids, fws, het_bins, hom_bins,
                     fws_resource=None) -> None:
    """The per-genome FWS CSV (writeGenomeResults), a row a genome in
    genome-id order: its FWS, the published Pf7 FWS where fws_resource (a
    dict) is given, and each bin's heterozygous and homozygous counts."""
    with open(file_name, "w") as f:
        headers = ["Genome", "FWS"]
        if fws_resource is not None:
            headers.append("Pf7_FWS")
        for lo, hi in FREQUENCY_BINS:
            headers += [f"Het_{lo:.2f}_{hi:.2f}", f"Hom_{lo:.2f}_{hi:.2f}"]
        f.write(",".join(headers) + "\n")
        for g in sorted(range(len(genome_ids)), key=genome_ids.__getitem__):
            gid = genome_ids[g]
            row = [gid, f"{float(fws[g]):.6f}"]
            if fws_resource is not None:
                row.append(str(fws_resource.get(gid, "")))
            for het, hom in zip(het_bins[g], hom_bins[g]):
                row += [str(int(het)), str(int(hom))]
            f.write(",".join(row) + "\n")


# --------------------------------------------------------------------------- #
# The statistics over codes resident on a device
# --------------------------------------------------------------------------- #
@dataclass
class FwsResult:
    """One subset's statistics on the host. index: the subset's genomes,
    rows of the resident codes' columns (G_sub,); het, hom: each genome's
    totals (G_sub,) int64; het_bins, hom_bins: each bin's counts (G_sub,
    11) int64; hs_sum, fws: (G_sub,) float64; variant_counts: (2, V) int32,
    each resident variant's heterozygous and homozygous counts over the
    subset (both 0 for a variant no genome of the subset carries)."""

    index: np.ndarray
    het: np.ndarray
    hom: np.ndarray
    het_bins: np.ndarray
    hom_bins: np.ndarray
    hs_sum: np.ndarray
    fws: np.ndarray
    variant_counts: np.ndarray

    def carried(self) -> np.ndarray:
        """The variants some genome of the subset carries, in resident order
        (the variants of a VariantMajorView of the subset)."""
        return np.flatnonzero(self.variant_counts.any(0))


def frequency_bins(af: torch.Tensor) -> torch.Tensor:
    """Each AF's bin (int64), lo <= AF < hi on the float64 AF."""
    edges = torch.tensor(_LOWER_EDGES, dtype=torch.float64, device=af.device)
    return torch.bucketize(af, edges, right=True)


def _variant_counts_plain(codes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pass one, plain: (2, V) int32, each variant's codes 1 and 2 over the
    genomes whose mask byte is 1, in blocks of rows."""
    V, G = codes.shape
    keep = mask[:G].bool()
    out = torch.empty((2, V), dtype=torch.int32, device=codes.device)
    for v0 in range(0, V, _PLAIN_ROWS):
        block = codes[v0:v0 + _PLAIN_ROWS]
        out[0, v0:v0 + _PLAIN_ROWS] = ((block == 1) & keep).sum(1)
        out[1, v0:v0 + _PLAIN_ROWS] = ((block == 2) & keep).sum(1)
    return out


def _variant_counts(codes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pass one: the plain version for a CPU tensor, kernel `fws_variants`
    for any other (which raises off the card)."""
    if codes.device.type == "cpu":
        return _variant_counts_plain(codes, mask)
    V, G = codes.shape
    _check_codes(codes)
    kernels.check_args(torch.uint8, mask=mask)
    counts = torch.empty((2, V), dtype=torch.int32, device=codes.device)
    if V:
        kernels.launch("fws_variants", "kgt_fws_variants", codes.device, codes.data_ptr(), V, G,
                       codes.stride(0), mask.data_ptr(), counts.data_ptr())
    return counts


def _genome_partials_plain(codes, order, hs, bounds, width):
    """Pass two, plain: (het, hom) (S, width) int32 and hs (S, width)
    float64, each genome's codes 1 and 2 and its summed hs over the rows
    order[bounds[s]:bounds[s + 1]] of each segment s; hs is of order's rows."""
    V, G = codes.shape
    S = bounds.shape[0] - 1
    dev = codes.device
    het = torch.zeros((S, width), dtype=torch.int32, device=dev)
    hom = torch.zeros((S, width), dtype=torch.int32, device=dev)
    hs_part = torch.zeros((S, width), dtype=torch.float64, device=dev)
    ends = bounds.tolist()
    for s in range(S):
        for r0 in range(ends[s], ends[s + 1], _PLAIN_ROWS):
            r1 = min(r0 + _PLAIN_ROWS, ends[s + 1])
            block = codes.index_select(0, order[r0:r1])
            one, two = block == 1, block == 2
            het[s, :G] += one.sum(0, dtype=torch.int32)
            hom[s, :G] += two.sum(0, dtype=torch.int32)
            hs_part[s, :G] += hs[r0:r1] @ (one | two).double()
    return het, hom, hs_part


def _genome_partials(codes, order, hs, bounds, width):
    """Pass two: the plain version for a CPU tensor, kernel `fws_genomes`
    for any other (which raises off the card)."""
    if codes.device.type == "cpu":
        return _genome_partials_plain(codes, order, hs, bounds, width)
    _check_codes(codes)
    G = codes.shape[1]
    S = bounds.shape[0] - 1
    order32 = order.to(torch.int32)
    kernels.check_args(torch.int32, order=order32)
    kernels.check_args(torch.float64, hs=hs)
    kernels.check_args(torch.int64, bounds=bounds)
    dev = codes.device
    counts = torch.empty((2, S, width), dtype=torch.int32, device=dev)
    hs_part = torch.empty((S, width), dtype=torch.float64, device=dev)
    kernels.launch("fws_genomes", "kgt_fws_genomes", dev, codes.data_ptr(), G, codes.stride(0),
                   order32.data_ptr(), hs.data_ptr(), bounds.data_ptr(), S, width,
                   counts[0].data_ptr(), counts[1].data_ptr(), hs_part.data_ptr())
    return counts[0], counts[1], hs_part


def _check_codes(codes: torch.Tensor) -> None:
    """Raise unless the kernels can read codes: uint8 on the card, rows of
    contiguous bytes starting ROW_ALIGN-aligned and ROW_ALIGN bytes apart,
    the storage holding each row's last 16-byte chunk whole."""
    V, G = codes.shape
    if not codes.is_cuda or codes.dtype is not torch.uint8:
        raise ValueError(f"codes must be uint8 on the card, got {codes.dtype} on {codes.device}")
    stride = codes.stride(0)
    chunk_end = -(-G // ROW_ALIGN) * ROW_ALIGN
    held = codes.untyped_storage().nbytes() - codes.storage_offset()
    if (codes.stride(1) != 1 or stride % ROW_ALIGN or codes.data_ptr() % ROW_ALIGN
            or stride < chunk_end or (V and held < (V - 1) * stride + chunk_end)):
        raise ValueError("codes must have rows ROW_ALIGN-aligned and ROW_ALIGN bytes apart "
                         "(variant/columnar.py resident_codes)")


def segment_bounds(bins: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(order, bounds, segment bins): the variants ordered by bin (stable),
    the (S + 1,) int64 bounds of S segments over that order, each inside one
    bin (the cuts of `segments` near-equal pieces and each bin's end), and
    each segment's bin. S depends on V alone."""
    V = bins.shape[0]
    dev = bins.device
    order = torch.sort(bins, stable=True).indices
    ends = torch.bincount(bins, minlength=N_BINS).cumsum(0)
    pieces = max(1, min(SEGMENTS, V // SEGMENT_ROWS))
    cuts = torch.arange(pieces + 1, dtype=torch.int64, device=dev) * V // pieces
    bounds = torch.sort(torch.cat([cuts, ends[:-1]])).values
    seg_bins = torch.bucketize(bounds[:-1], ends, right=True).clamp_(max=N_BINS - 1)
    return order, bounds, seg_bins


def _variant_stage(codes: torch.Tensor, mask: torch.Tensor, genomes: int):
    """Pass one and what follows from it: (counts (2, V) int32, hs (V,)
    float64, bins (V,) int64) over the `genomes` genomes of the mask."""
    counts = _variant_counts(codes, mask)
    af = (counts[0] + 2 * counts[1].to(torch.int64)).double() / float(max(2 * genomes, 1))
    hs = 2.0 * af * (1.0 - af)
    return counts, hs, frequency_bins(af)


def _segment_sums(het_part, hom_part, hs_part, seg_bins):
    """The segments' partial sums to each genome's bins (11, width) int64 and
    hs_sum (width,) float64, the segments added in their order."""
    width = het_part.shape[1]
    het_bins = torch.zeros((N_BINS, width), dtype=torch.int64, device=het_part.device)
    hom_bins = torch.zeros_like(het_bins)
    het_bins.index_add_(0, seg_bins, het_part.to(torch.int64))
    hom_bins.index_add_(0, seg_bins, hom_part.to(torch.int64))
    return het_bins, hom_bins, hs_part.sum(0)


def fws_statistics(codes: torch.Tensor, index: np.ndarray) -> FwsResult:
    """The FWS statistics of the genomes `index` (columns of codes, (G_sub,)
    int) over codes (V, G) uint8 resident on a device, every resident
    variant counted over them (see the module's docstring)."""
    V, G = codes.shape
    dev = codes.device
    g_sub = int(len(index))
    width = -(-max(G, 1) // GENOME_TILE) * GENOME_TILE
    with span("kgt.fws.upload"):
        idx = torch.as_tensor(np.asarray(index, dtype=np.int64), device=dev)
        mask = torch.zeros(width, dtype=torch.uint8, device=dev).index_fill_(0, idx, 1)
    with span("kgt.fws.variants"):
        counts, hs, bins = _variant_stage(codes, mask, g_sub)
        order, bounds, seg_bins = segment_bounds(bins)
    with span("kgt.fws.genomes"):
        het_part, hom_part, hs_part = _genome_partials(codes, order, hs[order], bounds, width)
        het_bins, hom_bins, hs_sum = _segment_sums(het_part, hom_part, hs_part, seg_bins)
        het_bins, hom_bins = het_bins[:, idx], hom_bins[:, idx]
        het, hom, hs_sum = het_bins.sum(0), hom_bins.sum(0), hs_sum[idx]
        fws = torch.where(hs_sum > 0, 1.0 - het / hs_sum, torch.ones_like(hs_sum))
        ints = torch.cat([het_bins, hom_bins, het[None], hom[None]])
        floats = torch.stack([hs_sum, fws])
    COUNTERS["genomes"] += g_sub
    COUNTERS["variants"] += V
    COUNTERS["passes"] += 2
    COUNTERS["code_bytes"] += 2 * V * G
    with span("kgt.fws.fetch"):
        ints, floats, counts = ints.cpu().numpy(), floats.cpu().numpy(), counts.cpu().numpy()
    return FwsResult(np.asarray(index, dtype=np.int64), ints[-2], ints[-1],
                     ints[:N_BINS].T, ints[N_BINS:2 * N_BINS].T, floats[0], floats[1], counts)
