"""INTERVAL, INFO_FILTER and PARSEJSON analyses.

Capability parity with:
  - IntervalAnalysis (kga_analytic/kga_info/kga_analysis_interval.h:69,135):
    fixed-width genome intervals with variant/SNP/transition density
    counts and empty-interval statistics written to CSV — computed here as
    vectorized histogram reductions over the columnar variant arrays.
  - InfoFilterAnalysis (kga_analysis_info_filter.h:23): INFO-field
    statistical filtering summaries.
  - JsonAnalysis (kga_analysis_json.h:22): bulk dbSNP JSON citation parse.

Copy of kgl_gene_tpu/analysis/info_analysis.py; host reductions only.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..app.analysis import VirtualAnalysis, register_analysis
from ..app.resources import AnalysisResources, ResourceType
from ..app.runtime import ParameterMap
from ..utils.logging import log
from ..variant.columnar import VariantMajorView

__all__ = ["IntervalAnalysis", "InfoFilterAnalysis", "JsonAnalysis"]


@register_analysis
class IntervalAnalysis(VirtualAnalysis):
    """Variant density over fixed-width contig intervals."""

    ANALYSIS_IDENT = "INTERVAL"

    def __init__(self, device=None):
        super().__init__(device)
        self.work_directory = "."
        self.interval_size = 1000
        self.genome_reference = None
        self.rows: List[str] = []

    def initialize_analysis(self, work_directory, parameters, resources) -> bool:
        self.work_directory = work_directory
        self.genome_reference = resources.get_resource(ResourceType.GENOME_DATABASE)
        for block in parameters:
            size = block.value("IntervalSize")
            if size and size.isdigit():
                self.interval_size = int(size)
        return True

    def file_read_analysis(self, population) -> bool:
        view = VariantMajorView(population)
        arena = population.arena
        snp_col = arena.is_snp_column()
        for contig_idx, contig_id in enumerate(arena.contig_names):
            mask = view.contig_index == contig_idx
            if not mask.any():
                continue
            offsets = view.offsets[mask]
            rows = view.rows[mask]
            snp = snp_col[rows]
            # Transition SNPs (A<->G / C<->T) for the Ti/Tv density column
            # (kga_analysis_interval.cpp:389-399: isTransition(alt0, ref0)).
            from ..sequence.alphabet import DNA5

            transition = snp & np.asarray(
                DNA5.is_transition(arena.alt_first[rows], arena.ref_first[rows]),
                dtype=bool,
            )
            contig_ref = (
                self.genome_reference.get_contig(contig_id)
                if self.genome_reference else None
            )
            length = len(contig_ref) if contig_ref else int(offsets.max()) + 1
            n_bins = (length + self.interval_size - 1) // self.interval_size
            bins = (offsets // self.interval_size).astype(np.int64)
            variant_counts = np.bincount(bins, minlength=n_bins)
            snp_counts = np.bincount(bins[snp], minlength=n_bins)
            ti_counts = np.bincount(bins[transition], minlength=n_bins)
            empty = int(np.sum(variant_counts == 0))
            log().info(
                "INTERVAL {}: {} bins of {} bp, {} empty, max density {}",
                contig_id, n_bins, self.interval_size, empty, int(variant_counts.max()),
            )
            for b in range(n_bins):
                ti = int(ti_counts[b])
                tv = int(snp_counts[b]) - ti
                # Ti/Tv ratio per interval (kga_analysis_interval.cpp:602-604).
                ti_tv = (ti / tv) if tv > 0 else 0.0
                self.rows.append(
                    f"{contig_id},{b * self.interval_size},"
                    f"{int(variant_counts[b])},{int(snp_counts[b])},"
                    f"{ti},{tv},{ti_tv:.6g}"
                )
        return True

    def finalize_analysis(self) -> bool:
        path = os.path.join(self.work_directory, "interval_density.csv")
        with open(path, "w") as f:
            f.write("Contig,Start,VariantCount,SNPCount,"
                    "TransitionCount,TransversionCount,TiTv\n")
            f.write("\n".join(self.rows) + ("\n" if self.rows else ""))
        return True


@register_analysis
class InfoFilterAnalysis(VirtualAnalysis):
    """INFO-field statistics: for each subscribed numeric field report
    count/mean/quantiles and the variant counts passing threshold filters."""

    ANALYSIS_IDENT = "INFO_FILTER"

    def __init__(self, device=None):
        super().__init__(device)
        self.work_directory = "."
        self.field_stats: Dict[str, Dict[str, float]] = {}

    def initialize_analysis(self, work_directory, parameters, resources) -> bool:
        self.work_directory = work_directory
        self.histogram_sums: Dict[str, np.ndarray] = {}
        return True

    def file_read_analysis(self, population) -> bool:
        info = getattr(population, "info_store", None)
        if info is None:
            log().warn("INFO_FILTER: population has no info store")
            return True
        # Histogram array fields (the gnomAD age_hist_het/age_hist_hom
        # matrices of InfoAgeAnalysis, kga_analysis_age.h:66): sum the bin
        # vectors across all variants.
        for fid in sorted(info.subscribed):
            if "hist" in fid.lower() and info.is_object_field(fid):
                for row in range(info.count):
                    value = info.object_value(fid, row)
                    if not value:
                        continue
                    bins = np.array(
                        [float(v) if v is not None else 0.0 for v in value]
                    )
                    acc = self.histogram_sums.get(fid)
                    if acc is None or len(acc) != len(bins):
                        self.histogram_sums[fid] = bins.copy()
                    else:
                        acc += bins
        for fid in sorted(info.subscribed):
            try:
                column = info.float_column(fid)
            except KeyError:
                continue
            valid = column[~np.isnan(column)]
            if len(valid) == 0:
                continue
            self.field_stats[fid] = {
                "count": float(len(valid)),
                "mean": float(valid.mean()),
                "min": float(valid.min()),
                "q25": float(np.quantile(valid, 0.25)),
                "median": float(np.quantile(valid, 0.5)),
                "q75": float(np.quantile(valid, 0.75)),
                "max": float(valid.max()),
            }
        return True

    def finalize_analysis(self) -> bool:
        path = os.path.join(self.work_directory, "info_field_stats.csv")
        with open(path, "w") as f:
            f.write("Field,Count,Mean,Min,Q25,Median,Q75,Max\n")
            for fid, stats in sorted(self.field_stats.items()):
                f.write(
                    f"{fid},{stats['count']:.0f},{stats['mean']:.6g},{stats['min']:.6g},"
                    f"{stats['q25']:.6g},{stats['median']:.6g},{stats['q75']:.6g},"
                    f"{stats['max']:.6g}\n"
                )
        if self.histogram_sums:
            hist_path = os.path.join(self.work_directory, "info_histograms.csv")
            with open(hist_path, "w") as f:
                f.write("Field,Bin,Sum\n")
                for fid, bins in sorted(self.histogram_sums.items()):
                    for b, value in enumerate(bins):
                        f.write(f"{fid},{b},{value:.6g}\n")
        return True


@register_analysis
class JsonAnalysis(VirtualAnalysis):
    """Accumulate dbSNP JSON citation files into one citation DB."""

    ANALYSIS_IDENT = "PARSEJSON"

    def __init__(self, device=None):
        super().__init__(device)
        self.work_directory = "."
        self.citations: Dict[str, set] = {}

    def initialize_analysis(self, work_directory, parameters, resources) -> bool:
        self.work_directory = work_directory
        return True

    def file_read_analysis(self, data_object) -> bool:
        citation_map = getattr(data_object, "citation_map", None)
        if citation_map is None:
            log().warn("PARSEJSON: data object is not a citation DB")
            return True
        for rsid, pmids in citation_map.items():
            self.citations.setdefault(rsid, set()).update(pmids)
        return True

    def finalize_analysis(self) -> bool:
        path = os.path.join(self.work_directory, "allele_citations.csv")
        with open(path, "w") as f:
            f.write("rsid,pmid\n")
            for rsid in sorted(self.citations):
                for pmid in sorted(self.citations[rsid]):
                    f.write(f"{rsid},{pmid}\n")
        log().info("PARSEJSON: {} cited alleles written", len(self.citations))
        return True
