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
analysis's device, in two stages. prepare, once a population: its
per-variant columns (InbreedColumns), the genomes' codes put on the device
once, variant-major (V, G) uint8, built block by block through
VariantMajorCSR.device_codes (no G x V temporary on the host), or columns handed in
directly (InbreedColumns.on_device). estimate, once a parameter set: the
loci selected on the host from the (V,) columns, their index and AF
uploaded, their codes gathered on the device into one (L, G) block, the
requested estimators run on it, and (G, n) F fetched.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..app.analysis import VirtualAnalysis, register_analysis
from ..stats.frequency import SUPER_POPULATIONS, FrequencyDatabaseRead
from ..stats.inbreeding import _ESTIMATORS, inbreeding_all, run_estimators
from ..tracing import span
from ..utils.logging import log
from ..variant.columnar import BLOCK_VARIANTS, VariantMajorCSR

__all__ = ["InbreedAnalysis", "InbreedColumns", "InbreedEstimate"]

# Variants densified and uploaded at a time while a population is prepared.
PREPARE_BLOCK_VARIANTS = BLOCK_VARIANTS


@dataclass
class InbreedColumns:
    """A population as INBREED reads it, prepared once.

    codes: (V, G) uint8 zygosity codes {0, 1, 2} on the device, variant-major
    (VariantMajorCSR.dense_block_t's layout); offsets, contig_index, is_snp:
    (V,) host columns, variants sorted by (contig, offset); frequencies: AF
    columns (V,) float64 by super population (SUPER_POPULATIONS' names, ALL
    for the AF field), NaN where a variant has none; population_freq: the
    population's own AF (V,), read where no column names the super
    population."""

    codes: torch.Tensor
    offsets: np.ndarray
    contig_index: np.ndarray
    is_snp: np.ndarray
    genome_ids: List[str]
    frequencies: Dict[str, np.ndarray] = field(default_factory=dict)
    population_freq: Optional[np.ndarray] = None

    @property
    def variant_count(self) -> int:
        return int(self.codes.shape[0])

    @property
    def genome_count(self) -> int:
        return int(self.codes.shape[1])

    @classmethod
    def on_device(cls, codes, offsets, contig_index, is_snp, genome_ids,
                  frequencies: Dict[str, np.ndarray], device=None) -> "InbreedColumns":
        """Columns handed in directly: codes (V, G) uint8, a numpy array or a
        tensor (kept where it already is on the device), the rest (V,)."""
        dev = resolve_device(device)
        codes = torch.as_tensor(codes, device=dev)
        V, G = codes.shape
        if codes.dtype != torch.uint8:
            raise TypeError(f"codes must be uint8, not {codes.dtype}")
        host = [np.asarray(x) for x in (offsets, contig_index, is_snp)]
        host += [np.asarray(c, dtype=np.float64) for c in frequencies.values()]
        if any(x.shape != (V,) for x in host) or len(genome_ids) != G:
            raise ValueError(f"columns must hold {V} variants and {G} genomes")
        return cls(codes, host[0], host[1], host[2].astype(bool), list(genome_ids),
                   {k.upper(): c for k, c in zip(frequencies, host[3:])})

    @classmethod
    def from_population(cls, population, device=None,
                        super_populations=SUPER_POPULATIONS) -> Optional["InbreedColumns"]:
        """A PopulationDB's columns, None where it holds no variant. The codes
        go to the device a block of variants at a time from the CSR."""
        csr = VariantMajorCSR(population)
        if csr.variant_count == 0:
            return None
        codes = csr.device_codes(resolve_device(device), PREPARE_BLOCK_VARIANTS)
        arena = population.arena
        frequencies = {}
        info = getattr(population, "info_store", None)
        if info is not None:
            freq_read = FrequencyDatabaseRead(info)
            info_rows = np.array([arena.info_row(int(r)) for r in csr.rows], dtype=np.int64)
            for name in dict.fromkeys(s.upper() for s in super_populations):
                column = freq_read.frequency_column(name)
                if column is not None:
                    safe = np.clip(info_rows, 0, len(column) - 1)
                    frequencies[name] = np.where(info_rows >= 0, column[safe], np.nan)
        return cls(codes, csr.offsets, csr.contig_index, arena.is_snp_column()[csr.rows],
                   list(csr.genome_ids), frequencies, csr.allele_frequencies())

    def frequency(self, super_population: str) -> np.ndarray:
        """AF (V,) float64 the analysis reads for a super population: its
        column, else the population's own (NaN read as 0)."""
        column = self.frequencies.get(super_population.upper())
        if column is None:
            if self.population_freq is None:
                alt = self.codes.sum(1, dtype=torch.int64).cpu().numpy()
                self.population_freq = alt / (2 * self.genome_count)
            column = self.population_freq
        return np.nan_to_num(np.asarray(column, dtype=np.float64), nan=0.0)


@dataclass
class InbreedEstimate:
    """One estimate: F (G, len(algorithms)) float32, a column an estimator;
    loci, the selected variants' indices into the columns (L,); minor_freq,
    their AF (L,)."""

    algorithms: List[str]
    f: np.ndarray
    loci: np.ndarray
    minor_freq: np.ndarray


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

    @property
    def algorithms(self) -> List[str]:
        return list(_ESTIMATORS) if self.algorithm == "ALL" else [self.algorithm]

    def prepare(self, population) -> Optional[InbreedColumns]:
        """Stage one, once a population: its columns, the codes on the
        analysis's device. None where the population holds no variant."""
        with span("kgt.inbreed.prepare"):
            return InbreedColumns.from_population(
                population, self.device, SUPER_POPULATIONS + (self.super_population,))

    def prepare_columns(self, codes, offsets, contig_index, is_snp, genome_ids,
                        frequencies: Dict[str, np.ndarray]) -> InbreedColumns:
        """Stage one from columns handed in directly (InbreedColumns.on_device)."""
        with span("kgt.inbreed.prepare"):
            return InbreedColumns.on_device(codes, offsets, contig_index, is_snp, genome_ids,
                                            frequencies, self.device)

    def selected_loci(self, columns: InbreedColumns, super_population: Optional[str] = None):
        """(loci (L,) int64, their AF (L,) float64): the SNPs whose AF of the
        super population lies in [MinAF, MaxAF] and 0 < AF < 1, thinned by
        select_loci."""
        with span("kgt.inbreed.select"):
            af = columns.frequency(super_population or self.super_population)
            # Locus window by AF bin (locus selection, kga_analysis_inbreed_locus.h),
            # restricted to SNP loci (the estimators' model).
            candidate = ((af >= self.min_af) & (af <= self.max_af) & columns.is_snp
                         & (af > 0) & (af < 1))
            loci = np.nonzero(self.select_loci(
                columns.offsets, columns.contig_index, candidate,
                self.lower_window, self.upper_window,
                self.sampling_distance, self.locii_count,
            ))[0]
            return loci, af[loci]

    def estimate(self, columns: InbreedColumns,
                 super_population: Optional[str] = None) -> InbreedEstimate:
        """Stage two, once a parameter set: the selected loci's codes
        gathered on the device, the analysis's algorithms run on them."""
        with span("kgt.inbreed"):
            loci, minor_freq = self.selected_loci(columns, super_population)
            dev = columns.codes.device
            with span("kgt.inbreed.upload"):
                index = torch.as_tensor(loci, device=dev)
                p = torch.as_tensor(minor_freq.astype(np.float32), device=dev)
            with span("kgt.inbreed.gather"):
                codes = columns.codes.index_select(0, index)
            f = run_estimators(self.algorithms, codes, p)
            with span("kgt.inbreed.fetch"):
                f = f.cpu().numpy()
        return InbreedEstimate(self.algorithms, f, loci, minor_freq)

    def _synthetic_analysis(self, minor_freq: np.ndarray) -> bool:
        """Regenerate a diploid population with KNOWN per-genome
        coefficients from the observed locus frequencies and re-estimate
        (ExecuteInbreedingAnalysis::processSynthetic,
        kga_analysis_inbreed_execute.h:44; generator
        kga_analysis_inbreed_syngen.h)."""
        from ..stats.inbreeding import synthetic_diploid_population

        expected = np.arange(0.0, 0.51, 0.05)
        freqs = minor_freq
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
        columns = self.prepare(population)
        if columns is None:
            log().warn("INBREED: no variants in population")
            return True
        if self.analysis_type == "Synthetic":
            return self._synthetic_analysis(self.selected_loci(columns)[1])
        est = self.estimate(columns)
        for g, genome_id in enumerate(columns.genome_ids):
            row = self.results.setdefault(genome_id, {})
            for k, algo in enumerate(est.algorithms):
                row[algo] = float(est.f[g, k])
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
