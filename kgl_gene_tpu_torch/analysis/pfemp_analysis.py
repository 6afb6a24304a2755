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
stats/fws.py, MutateGenes and TranscriptFamilyAnalysis, all three on the
analysis's device. The statistics stage runs in two stages. prepare, once
a population: the genomes' codes put on the device once, variant-major
(V, G) uint8, built block by block through VariantMajorCSR.device_codes
(no G x V temporary on the host), or codes handed in directly
(prepare_columns), with the genome ids in their resident order (FwsColumns).
statistics, once a genome subset: the Pf7 QC and monoclonal filters as an
index into those genomes, then stats/fws.py fws_statistics over the
resident codes. file_read_analysis prepares the filtered population, so
only the genomes the filters keep are held on the device, and writes the
zygosity and FWS CSVs from the statistics' arrays.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..app.analysis import VirtualAnalysis, register_analysis
from ..app.resources import AnalysisResources, ResourceType
from ..stats.fws import FwsResult, fws_statistics, write_genome_csv
from ..tracing import span
from ..utils.logging import log
from ..variant.columnar import ROW_ALIGN, VariantMajorCSR, resident_codes
from ..variant.filter import GenomeListFilter
from .lib_seqmutation import MutateGenes, TranscriptFamilyAnalysis

__all__ = ["FwsColumns", "PfEMPAnalysis", "PF_GENE_FAMILIES", "classify_gene_family"]

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


@dataclass
class FwsColumns:
    """A population as the PfEMP statistics read it, prepared once: codes
    (V, G) uint8 {0, 1, 2} on the device, variant-major, rows ROW_ALIGN bytes
    apart (variant/columnar.py resident_codes); genome_ids, its columns'
    genomes in order."""

    codes: torch.Tensor
    genome_ids: List[str]

    @classmethod
    def on_device(cls, codes, genome_ids, device=None) -> "FwsColumns":
        """Codes handed in directly, a numpy array or a tensor: kept where
        they lie when they are on the device with aligned rows, else copied
        there into resident_codes' layout a block of variants at a time."""
        dev = resolve_device(device)
        codes = torch.as_tensor(codes)
        V, G = codes.shape
        if codes.dtype != torch.uint8:
            raise TypeError(f"codes must be uint8, not {codes.dtype}")
        if len(genome_ids) != G:
            raise ValueError(f"codes hold {G} genomes, not {len(genome_ids)}")
        there = codes.device.type == dev.type and dev.index in (None, codes.device.index)
        if not (there and codes.stride(1) == 1 and codes.stride(0) % ROW_ALIGN == 0
                and codes.data_ptr() % ROW_ALIGN == 0):
            codes = resident_codes(V, G, dev, lambda v_lo, v_hi: codes[v_lo:v_hi])
        return cls(codes, list(genome_ids))

    @classmethod
    def from_population(cls, population, device=None) -> Optional["FwsColumns"]:
        """A PopulationDB's codes on the device, None where it holds no variant."""
        csr = VariantMajorCSR(population)
        if csr.variant_count == 0:
            return None
        return cls(csr.device_codes(resolve_device(device)), list(csr.genome_ids))


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

    def _keep_samples(self) -> Optional[Set[str]]:
        """The genomes the Pf7 filters keep (kga_analysis_lib_PfFilter.h:61,98):
        QC pass where the sample resource is given, and monoclonal
        (published FWS >= 0.95) where the FWS resource is; None, every
        genome, where neither is."""
        keep = None
        if self.pf7_samples is not None:
            keep = self.pf7_samples.qc_pass_samples()
        if self.pf7_fws is not None:
            mono = self.pf7_fws.monoclonal_samples()
            keep = mono if keep is None else keep & mono
        return keep

    def _qc_filter(self, population):
        """Pf7 QC-pass + monoclonal filtering, a population view of the
        genomes _keep_samples keeps."""
        keep = self._keep_samples()
        if keep is None:
            return population
        filtered = population.view_filter(GenomeListFilter(keep))
        log().info("PfEMP: Pf7 QC pass and monoclonal filters: {} -> {} genomes",
                   population.genome_count(), filtered.genome_count())
        return filtered

    def genome_index(self, genome_ids: List[str]) -> np.ndarray:
        """The genomes _keep_samples keeps, as an index into genome_ids
        (int64, in their order)."""
        keep = self._keep_samples()
        if keep is None:
            return np.arange(len(genome_ids), dtype=np.int64)
        return np.fromiter((g for g, gid in enumerate(genome_ids) if gid in keep), np.int64)

    def prepare(self, population) -> Optional[FwsColumns]:
        """Stage one, once a population: its codes on the analysis's device.
        None where the population holds no variant."""
        with span("kgt.fws.prepare"):
            return FwsColumns.from_population(population, self.device)

    def prepare_columns(self, codes, genome_ids) -> FwsColumns:
        """Stage one from codes handed in directly (FwsColumns.on_device)."""
        with span("kgt.fws.prepare"):
            return FwsColumns.on_device(codes, genome_ids, self.device)

    def statistics(self, columns: FwsColumns) -> FwsResult:
        """Stage two, once a genome subset: the filtered genomes' zygosity and
        FWS statistics over the resident codes (stats/fws.py fws_statistics)."""
        with span("kgt.fws"):
            return fws_statistics(columns.codes, self.genome_index(columns.genome_ids))

    # ------------------------------------------------------------------ #
    def file_read_analysis(self, population) -> bool:
        filtered = self._qc_filter(population)
        columns = self.prepare(filtered)
        if columns is None:
            genome_ids = sorted(filtered.genome_map)
            het = hom = np.zeros(len(genome_ids), dtype=np.int64)
            result = None
        else:
            result = self.statistics(columns)
            genome_ids = [columns.genome_ids[g] for g in result.index]
            het, hom = result.het, result.hom

        # Het/hom zygosity per sample.
        zyg_path = os.path.join(self.work_directory, "pfemp_zygosity.csv")
        with open(zyg_path, "w") as f:
            f.write("Genome,Heterozygous,Homozygous\n")
            for i, genome_id in enumerate(genome_ids):
                f.write(f"{genome_id},{int(het[i])},{int(hom[i])}\n")

        # FWS statistics, where the filtered genomes carry a variant.
        if result is not None and len(result.carried()):
            write_genome_csv(
                os.path.join(self.work_directory, "pfemp_fws.csv"), genome_ids, result.fws,
                result.het_bins, result.hom_bins,
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
