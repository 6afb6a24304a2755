"""PfEMP analysis: P. falciparum antigenic gene families.

Capability parity with PfEMPAnalysis (kga_analytic/kga_PfEMP/
kga_analysis_PfEMP.h:25-115): Pf gene-family selection (var/PFEMP1, rifin,
stevor, surfin, RUF6 — by description/name match,
kga_analysis_lib_Pfgene.h), Pf7 QC + FWS monoclonal filtering
(kga_analysis_lib_PfFilter.h), per-sample het/hom zygosity
(kga_analysis_PfEMP_heterozygous.h:35,97), FWS from AF bins
(kga_analysis_PfEMP_FWS.h:15-52), transcript mutation reports and genetic
vs physical distance comparison (kga_analysis_PfEMP_distance.cpp).

Copy of kgl_gene_tpu/analysis/pfemp_analysis.py on the port's
stats/fws.py, MutateGenes and TranscriptFamilyAnalysis, the last two on
the analysis's device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..app.analysis import VirtualAnalysis, register_analysis
from ..app.resources import AnalysisResources, ResourceType
from ..stats.fws import CalcFWS
from ..utils.logging import log
from ..variant.columnar import VariantMajorView
from .lib_seqmutation import MutateGenes, TranscriptFamilyAnalysis

__all__ = ["PfEMPAnalysis", "PF_GENE_FAMILIES", "classify_gene_family"]

# Gene family name/description keywords (kga_analysis_lib_Pfgene.h).
PF_GENE_FAMILIES = {
    "PFEMP1": ("pfemp1", "erythrocyte membrane protein", "var "),
    "RIFIN": ("rifin",),
    "STEVOR": ("stevor",),
    "SURFIN": ("surfin",),
    "RUF6": ("ruf6", "rna of unknown function"),
}


def classify_gene_family(gene) -> Optional[str]:
    """Classify a gene feature into a Pf antigenic family by its
    name/description text."""
    text = (gene.description() + " " + gene.feature_id).lower()
    for family, keywords in PF_GENE_FAMILIES.items():
        if any(k in text for k in keywords):
            return family
    return None


@register_analysis
class PfEMPAnalysis(VirtualAnalysis):
    ANALYSIS_IDENT = "PfEMP"

    def __init__(self, device=None):
        super().__init__(device)
        self.work_directory = "."
        self.genome_reference = None
        self.pf7_samples = None
        self.pf7_fws = None
        self.pf7_distance = None
        self.family_reports: List[str] = []

    def initialize_analysis(self, work_directory, parameters, resources) -> bool:
        self.work_directory = work_directory
        self.genome_reference = resources.get_resource(ResourceType.GENOME_DATABASE)
        self.pf7_samples = resources.get_resource(ResourceType.PF7_SAMPLE)
        self.pf7_fws = resources.get_resource(ResourceType.PF7_FWS)
        self.pf7_distance = resources.get_resource(ResourceType.PF7_DISTANCE)
        if self.genome_reference is None:
            log().error("PfEMP requires a GenomeDatabase resource")
            return False
        return True

    # ------------------------------------------------------------------ #
    def _family_genes(self) -> Dict[str, List[Tuple[object, object]]]:
        families: Dict[str, List[Tuple[object, object]]] = {}
        for contig_id, contig in self.genome_reference:
            for gene in contig.all_genes():
                family = classify_gene_family(gene)
                if family:
                    families.setdefault(family, []).append((contig, gene))
        return families

    def _qc_filter(self, population):
        """Pf7 QC-pass + monoclonal filtering
        (kga_analysis_lib_PfFilter.h:61,98)."""
        filtered = population
        if self.pf7_samples is not None:
            filtered = self.pf7_samples.filter_pass_qc_genomes(filtered)
            log().info("PfEMP: QC pass filter: {} -> {} genomes",
                       population.genome_count(), filtered.genome_count())
        if self.pf7_fws is not None:
            filtered = self.pf7_fws.filter_monoclonal_genomes(filtered)
            log().info("PfEMP: monoclonal filter -> {} genomes",
                       filtered.genome_count())
        return filtered

    # ------------------------------------------------------------------ #
    def file_read_analysis(self, population) -> bool:
        filtered = self._qc_filter(population)
        view = VariantMajorView(filtered)

        # Het/hom zygosity per sample.
        het, hom = view.het_hom_by_genome()
        zyg_path = os.path.join(self.work_directory, "pfemp_zygosity.csv")
        with open(zyg_path, "w") as f:
            f.write("Genome,Heterozygous,Homozygous\n")
            for i, genome_id in enumerate(view.genome_ids):
                f.write(f"{genome_id},{int(het[i])},{int(hom[i])}\n")

        # FWS statistics.
        if view.variant_count:
            calc = CalcFWS(view)
            calc.write_genome_results(
                os.path.join(self.work_directory, "pfemp_fws.csv"),
                fws_resource=self.pf7_fws.fws_map if self.pf7_fws else None,
            )

        # Family transcript mutation.
        info_store = getattr(population, "info_store", None)
        for family, genes in self._family_genes().items():
            for contig, gene in genes:
                for transcript in contig.gene_transcripts(gene.feature_id).transcripts():
                    mutator = MutateGenes(contig, info_store=info_store, device=self.device)
                    records, stats = mutator.mutate_transcript(filtered, transcript)
                    analysis = TranscriptFamilyAnalysis(
                        records, contig.coding_sequence(transcript).to_string(),
                        device=self.device,
                    )
                    base = os.path.join(
                        self.work_directory,
                        f"pfemp_{family}_{transcript.transcript_id}".replace("/", "_"),
                    )
                    analysis.write_report(base + ".csv")
                    self.family_reports.append(base)
        return True

    def finalize_analysis(self) -> bool:
        # Genetic vs physical distance comparison
        # (kga_analysis_PfEMP_distance.cpp): for every sample pair present
        # in BOTH resources, emit published genetic distance alongside the
        # great-circle separation of the collection sites.
        if self.pf7_distance is not None and self.pf7_samples is not None:
            from ..io.resource_parsers import Pf7PhysicalDistance

            physical = Pf7PhysicalDistance(self.pf7_samples)
            shared = [
                s for s in self.pf7_distance.sample_ids
                if s in self.pf7_samples.sample_map
            ]
            path = os.path.join(self.work_directory, "pfemp_distance_compare.csv")
            with open(path, "w") as f:
                f.write("SampleA,SampleB,GeneticDistance,PhysicalKm\n")
                for i, sa in enumerate(shared):
                    for sb in shared[i + 1:]:
                        genetic = self.pf7_distance.distance(sa, sb)
                        km = physical.sample_distance_km(sa, sb)
                        if genetic is not None and km is not None:
                            f.write(f"{sa},{sb},{genetic:.6g},{km:.1f}\n")
            log().info("PfEMP: distance comparison written to {}", path)
        log().info("PfEMP complete: {} family transcript reports",
                   len(self.family_reports))
        return True
