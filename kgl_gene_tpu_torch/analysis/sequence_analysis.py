"""PfSEQUENCE analysis: population-wide transcript mutation, per-genome
modified vs reference coding sequences, Levenshtein reports and UPGMA
Newick trees per transcript.

Capability parity with SequenceAnalysis / AnalysisTranscriptFamily
(kga_analytic/kga_sequence_analysis/kga_analysis_sequence.h:26,
kga_analysis_library/kga_analysis_lib_seq_stats.h:26,65).

Parameters (parameter block): GeneList (comma list of gene idents; empty =
all protein-coding genes), FilterType (DEFAULT|FRAMESHIFT_ADJUSTED|
SNP_ADJUSTED|HIGHEST_FREQ).

Copy of kgl_gene_tpu/analysis/sequence_analysis.py on the port's
MutateGenes and TranscriptFamilyAnalysis, both on the analysis's device:
the SNP and indel steps (kernels B2, B1, and B3 on the exact fallback),
the all-pairs tree (B1's pool, or kernel `local` with DistanceMetric
LOCAL) and the reference distances (B3 or `local`).
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..app.analysis import VirtualAnalysis, register_analysis
from ..app.resources import AnalysisResources, ResourceType
from ..app.runtime import ParameterMap
from ..genome.features import TranscriptionSequenceType
from ..mutation.sequence_filter import SeqVariantFilterType
from ..utils.logging import log
from .lib_seqmutation import MutateGenes, TranscriptFamilyAnalysis

__all__ = ["SequenceAnalysis"]

_FILTER_TYPES = {
    "DEFAULT": SeqVariantFilterType.DEFAULT_SEQ_FILTER,
    "FRAMESHIFT_ADJUSTED": SeqVariantFilterType.FRAMESHIFT_ADJUSTED,
    "SNP_ADJUSTED": SeqVariantFilterType.SNP_ADJUSTED,
    "HIGHEST_FREQ": SeqVariantFilterType.HIGHEST_FREQ_VARIANT,
}


@register_analysis
class SequenceAnalysis(VirtualAnalysis):
    ANALYSIS_IDENT = "PfSEQUENCE"

    def __init__(self, device=None):
        super().__init__(device)
        self.work_directory = "."
        self.genome_reference = None
        self.gene_list: List[str] = []
        self.filter_type = SeqVariantFilterType.DEFAULT_SEQ_FILTER
        self.distance_metric = "global"  # GLOBAL (NW) | LOCAL (infix/HW)
        self.reports: List[str] = []

    def initialize_analysis(self, work_directory, parameters, resources) -> bool:
        self.work_directory = work_directory
        self.genome_reference = resources.get_resource(ResourceType.GENOME_DATABASE)
        if self.genome_reference is None:
            log().error("PfSEQUENCE requires a GenomeDatabase resource")
            return False
        for block in parameters:
            genes = block.value("GeneList")
            if genes:
                self.gene_list = [g.strip() for g in genes.split(",") if g.strip()]
            filter_name = block.value("FilterType")
            if filter_name and filter_name.upper() in _FILTER_TYPES:
                self.filter_type = _FILTER_TYPES[filter_name.upper()]
            metric = block.value("DistanceMetric")
            if metric and metric.upper() in ("GLOBAL", "LOCAL"):
                self.distance_metric = metric.lower()
        return True

    def _target_transcripts(self):
        for contig_id, contig in self.genome_reference:
            for gene in contig.all_genes():
                if self.gene_list and gene.feature_id not in self.gene_list:
                    continue
                for transcript in contig.gene_transcripts(gene.feature_id).transcripts():
                    if transcript.coding_type is TranscriptionSequenceType.PROTEIN:
                        yield contig, transcript

    def file_read_analysis(self, population) -> bool:
        info_store = getattr(population, "info_store", None)
        for contig, transcript in self._target_transcripts():
            mutator = MutateGenes(contig, self.filter_type, info_store, device=self.device)
            records, stats = mutator.mutate_transcript(population, transcript)
            log().info(
                "PfSEQUENCE {}: {}/{} mutant genomes, {} variants, {} valid proteins",
                transcript.transcript_id, stats.mutant_genomes, stats.total_genomes,
                stats.total_variants, stats.valid_proteins,
            )
            family = TranscriptFamilyAnalysis(
                records, contig.coding_sequence(transcript).to_string(),
                metric=self.distance_metric, device=self.device,
            )
            base = os.path.join(
                self.work_directory,
                f"sequence_{transcript.gene.feature_id}_{transcript.transcript_id}".replace("/", "_"),
            )
            family.write_report(base + ".csv")
            with open(base + ".nwk", "w") as f:
                f.write(family.distance_tree_newick() + "\n")
            self.reports.append(base)
        return True

    def finalize_analysis(self) -> bool:
        log().info("PfSEQUENCE complete: {} transcript reports", len(self.reports))
        return True
