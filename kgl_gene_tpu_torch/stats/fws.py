"""FWS within-host fixation statistics.

Capability parity with the PfEMP FWS analysis
(kga_analytic/kga_PfEMP/kga_analysis_PfEMP_FWS.h:15-52): per-genome
heterozygosity summaries binned by population allele frequency (the 11
AlleleFrequencyBins), per-variant het/hom summaries, and the FWS index
FWS = 1 - Hw/Hs (within-host vs population-level expected heterozygosity),
computed as vectorized reductions over the variant-major zygosity matrix.

Copy of kgl_gene_tpu/stats/fws.py: numpy on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..variant.columnar import AlleleSummary, VariantMajorView

__all__ = ["FREQUENCY_BINS", "CalcFWS"]

# (lower, upper) AF bins — AlleleFrequencyBins PERCENT_0_5 .. PERCENT_50_100.
FREQUENCY_BINS: List[Tuple[float, float]] = [
    (0.00, 0.05), (0.05, 0.10), (0.10, 0.15), (0.15, 0.20), (0.20, 0.25),
    (0.25, 0.30), (0.30, 0.35), (0.35, 0.40), (0.40, 0.45), (0.45, 0.50),
    (0.50, 1.00001),
]


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
        self.variant_map: Dict[str, AlleleSummary] = {}
        self._calculate()

    def _calculate(self) -> None:
        z = self.view.zygosity  # (G, V)
        af = self.allele_freq
        het = z == 1
        hom = z == 2

        # Per-variant summaries (updateVariantFWSMap).
        het_v = het.sum(axis=0)
        hom_v = hom.sum(axis=0)
        for i, hgvs in enumerate(self.view.hgvs):
            self.variant_map[hgvs] = AlleleSummary(int(het_v[i]), int(hom_v[i]))

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
        with open(file_name, "w") as f:
            headers = ["Genome", "FWS"]
            if fws_resource is not None:
                headers.append("Pf7_FWS")
            for lo, hi in FREQUENCY_BINS:
                headers += [f"Het_{lo:.2f}_{hi:.2f}", f"Hom_{lo:.2f}_{hi:.2f}"]
            f.write(",".join(headers) + "\n")
            for gid, result in sorted(self.genome_map.items()):
                row = [gid, f"{result.fws:.6f}"]
                if fws_resource is not None:
                    row.append(str(fws_resource.get(gid, "")))
                for summary in result.bins:
                    row += [str(summary.heterozygous), str(summary.homozygous)]
                f.write(",".join(row) + "\n")

    def write_variant_results(self, file_name: str) -> None:
        with open(file_name, "w") as f:
            f.write("Variant,Heterozygous,Homozygous\n")
            for hgvs, summary in sorted(self.variant_map.items()):
                f.write(f"{hgvs},{summary.heterozygous},{summary.homozygous}\n")
