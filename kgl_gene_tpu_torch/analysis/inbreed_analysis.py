"""INBREED analysis: per-sample inbreeding coefficients.

Capability parity with InbreedAnalysis (kga_analytic/kga_inbreed/, 3,835
LoC): allele-class frequencies from super-population AF, the four
estimation algorithms (Ritland locus, Simple, Hall EM, MLE), locus windows
by AF bins, synthetic validation, and column/CSV output. The estimators
themselves are the batched device reductions in
kgl_gene_tpu_torch.stats.inbreeding; this plugin assembles the locus data from
the population and writes the report.

Parameters (the XML argument surface of kga_analysis_inbreed_args.h:28-55):
Algorithm (RitlandLocus|Simple|HallME|Loglikelihood|ALL), SuperPopulation
(AF field dialect selector), MinAF/MaxAF (allele-frequency locus window),
LowerWindow/UpperWindow (contig offset range), SamplingDistance (minimum
spacing between selected loci, the LD-minimisation criterion of
kga_analysis_inbreed_locus.h:83-88), LociiCount (cap on selected loci),
and AnalysisType (Inbreed|Synthetic — Synthetic regenerates a diploid
population with known per-genome coefficients from the observed locus
frequencies and re-estimates them, kga_analysis_inbreed_synthetic.h:56).

Copy of kgl_gene_tpu/analysis/inbreed_analysis.py on the port's
stats/inbreeding.py: the four estimators run as PyTorch on the
analysis's device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..app.analysis import VirtualAnalysis, register_analysis
from ..stats.frequency import FrequencyDatabaseRead
from ..stats.inbreeding import LocusData, inbreeding_all, _ESTIMATORS
from ..utils.logging import log
from ..variant.columnar import VariantMajorView

__all__ = ["InbreedAnalysis"]


@register_analysis
class InbreedAnalysis(VirtualAnalysis):
    ANALYSIS_IDENT = "INBREED"

    def __init__(self, device=None):
        super().__init__(device)
        self.work_directory = "."
        self.algorithm = "ALL"
        self.analysis_type = "Inbreed"
        self.super_population = "ALL"
        self.min_af = 0.0
        self.max_af = 1.0
        self.lower_window = 0
        self.upper_window = 2**62
        self.sampling_distance = 0
        self.locii_count = 2**62
        self.results: Dict[str, Dict[str, float]] = {}  # genome -> algo -> F
        self.synthetic_rows: List[tuple] = []  # (label, expected, {algo: F})

    def initialize_analysis(self, work_directory, parameters, resources) -> bool:
        self.work_directory = work_directory
        for block in parameters:
            self.algorithm = block.value("Algorithm", self.algorithm)
            self.analysis_type = block.value("AnalysisType", self.analysis_type)
            self.super_population = block.value("SuperPopulation", self.super_population)
            self.min_af = float(block.value("MinAF", str(self.min_af)))
            self.max_af = float(block.value("MaxAF", str(self.max_af)))
            self.lower_window = int(block.value("LowerWindow", str(self.lower_window)))
            self.upper_window = int(block.value("UpperWindow", str(self.upper_window)))
            self.sampling_distance = int(
                block.value("SamplingDistance", str(self.sampling_distance))
            )
            self.locii_count = int(block.value("LociiCount", str(self.locii_count)))
        if self.algorithm != "ALL" and self.algorithm not in _ESTIMATORS:
            log().error("INBREED: unknown algorithm {}", self.algorithm)
            return False
        if self.analysis_type not in ("Inbreed", "Synthetic"):
            log().error("INBREED: unknown AnalysisType {}", self.analysis_type)
            return False
        return True

    @staticmethod
    def select_loci(
        offsets: np.ndarray, contigs: np.ndarray, candidate: np.ndarray,
        lower: int, upper: int, spacing: int, count: int,
    ) -> np.ndarray:
        """Locus-selection mask: offset window [lower, upper] (upper
        INCLUSIVE — the reference's getAllelesFromTo breaks only when
        offset > upperOffset(), kga_analysis_inbreed_locus.cpp), greedy
        minimum spacing per contig (linkage-disequilibrium minimisation),
        and the LociiCount cap applied PER CONTIG (getLocusList runs per
        ContigDB) — RetrieveLociiVector::getLociiFromTo/getLociiCount
        (kga_analysis_inbreed_locus.h:33-41). offsets are sorted within
        each contig run; candidate marks loci passing the AF window."""
        mask = candidate & (offsets >= lower) & (offsets <= upper)
        for c in np.unique(contigs):
            cmask = mask & (contigs == c)
            if spacing > 0:
                idx = np.nonzero(cmask)[0]
                offs = offsets[idx]
                thinned_idx = []
                pos = 0
                # searchsorted jumps: O(picks x log n) per contig.
                while pos < len(idx):
                    thinned_idx.append(idx[pos])
                    pos = int(np.searchsorted(offs, offs[pos] + spacing, side="left"))
                cmask = np.zeros_like(cmask)
                cmask[thinned_idx] = True
            picked = np.nonzero(cmask)[0]
            if len(picked) > count:
                cmask[picked[count:]] = False
            mask = np.where(contigs == c, cmask, mask)
        return mask

    def _locus_data(self, population) -> Optional[LocusData]:
        view = VariantMajorView(population)
        if view.variant_count == 0:
            return None
        info = getattr(population, "info_store", None)
        minor_freq = None
        if info is not None:
            freq_read = FrequencyDatabaseRead(info)
            info_rows = np.array(
                [population.arena.info_row(int(r)) for r in view.rows], dtype=np.int64
            )
            column = freq_read.frequency_column(self.super_population)
            if column is not None:
                safe = np.clip(info_rows, 0, len(column) - 1)
                minor_freq = np.where(info_rows >= 0, column[safe], np.nan)
        if minor_freq is None:
            # Fall back to frequencies from the population itself.
            minor_freq = view.allele_frequencies()
        minor_freq = np.nan_to_num(np.asarray(minor_freq, dtype=np.float64), nan=0.0)
        # Locus window by AF bin (locus selection, kga_analysis_inbreed_locus.h).
        window = (minor_freq >= self.min_af) & (minor_freq <= self.max_af)
        # Restrict to SNP loci (the estimators' model).
        snp = population.arena.is_snp_column()[view.rows]
        candidate = window & snp & (minor_freq > 0) & (minor_freq < 1)
        selected = self.select_loci(
            view.offsets, view.contig_index, candidate,
            self.lower_window, self.upper_window,
            self.sampling_distance, self.locii_count,
        )
        valid = np.broadcast_to(selected, view.zygosity.shape).copy()
        data = LocusData(zygosity=view.zygosity, minor_freq=minor_freq, valid=valid)
        data.genome_ids = view.genome_ids  # type: ignore[attr-defined]
        return data

    def _synthetic_analysis(self, data: LocusData) -> bool:
        """Regenerate a diploid population with KNOWN per-genome
        coefficients from the observed locus frequencies and re-estimate
        (ExecuteInbreedingAnalysis::processSynthetic,
        kga_analysis_inbreed_execute.h:44; generator
        kga_analysis_inbreed_syngen.h)."""
        from ..stats.inbreeding import synthetic_diploid_population

        expected = np.arange(0.0, 0.51, 0.05)
        loci_mask = data.valid[0] if data.valid is not None else None
        freqs = data.minor_freq[loci_mask] if loci_mask is not None else data.minor_freq
        n_loci = max(int(freqs.size), 100)
        syn = synthetic_diploid_population(
            n_genomes=len(expected), n_loci=n_loci, inbreeding=expected,
            freq_low=float(freqs.min()) if freqs.size else 0.05,
            freq_high=float(freqs.max()) if freqs.size else 0.45,
        )
        results = inbreeding_all(syn, device=self.device)
        for g, f_exp in enumerate(expected):
            self.synthetic_rows.append(
                (f"SYN_{f_exp:.2f}", float(f_exp),
                 {a: float(v[g]) for a, v in results.items()})
            )
        return True

    def file_read_analysis(self, population) -> bool:
        data = self._locus_data(population)
        if data is None:
            log().warn("INBREED: no variants in population")
            return True
        if self.analysis_type == "Synthetic":
            return self._synthetic_analysis(data)
        if self.algorithm == "ALL":
            results = inbreeding_all(data, device=self.device)
        else:
            from ..stats.inbreeding import _estimate

            results = {self.algorithm: _estimate(self.algorithm, data, self.device)}
        for g, genome_id in enumerate(data.genome_ids):  # type: ignore[attr-defined]
            row = self.results.setdefault(genome_id, {})
            for algo, values in results.items():
                row[algo] = float(values[g])
        return True

    def finalize_analysis(self) -> bool:
        if self.analysis_type == "Synthetic":
            path = os.path.join(self.work_directory, "inbreeding_synthetic.csv")
            algos = sorted(_ESTIMATORS)
            with open(path, "w") as f:
                f.write("Genome,Expected," + ",".join(algos) + "\n")
                for label, expected, row in self.synthetic_rows:
                    f.write(
                        f"{label},{expected:.6f},"
                        + ",".join(f"{row.get(a, 0.0):.6f}" for a in algos) + "\n"
                    )
            log().info(
                "INBREED synthetic: {} genomes written to {}",
                len(self.synthetic_rows), path,
            )
            return True
        path = os.path.join(self.work_directory, "inbreeding.csv")
        algos = sorted(_ESTIMATORS) if self.algorithm == "ALL" else [self.algorithm]
        with open(path, "w") as f:
            f.write("Genome," + ",".join(algos) + "\n")
            for genome_id in sorted(self.results):
                row = self.results[genome_id]
                f.write(
                    genome_id + ","
                    + ",".join(f"{row.get(a, 0.0):.6f}" for a in algos) + "\n"
                )
        log().info("INBREED: {} genomes written to {}", len(self.results), path)
        return True
