"""Package executor: the top-level orchestration.

Capability parity with ExecutePackage (kgl_app/kgl_package.h:24-62,
kgl_package.cpp:17-106): for each active package — load its resources,
initialize its analyses, then for each iterative file list parse each data
file (ParserSelection dispatch) and drive fileReadAnalysis /
iterationAnalysis, finally finalizeAnalysis.

Copy of kgl_gene_tpu/app/package.py with the device made explicit:
ExecutePackage takes the device its analyses run on (resolve_device: the
card unless the caller asks for the CPU) and hands it to each package's
PackageAnalysis; `dropped` lists every analysis a package dropped, as
(package ident, analysis ident, phase).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from .. import resolve_device
from ..io.vcf import parse_vcf_population
from ..utils.logging import log
from .analysis import PackageAnalysis
from .resources import AnalysisResources, ResourceType, load_resource
from .runtime import BaseFileInfo, RuntimeProperties, RuntimeVCFFileInfo

__all__ = ["ExecutePackage", "ParserSelection"]


class ParserSelection:
    """Data-source -> parser dispatch (ParserSelection::parseData,
    kgl_parser/kgl_variant_factory_parsers.cpp:27-73). Parser type names
    follow the DataSourceEnum vocabulary."""

    VCF_PARSERS = {"PF_DIPLOID", "PF7_VCF", "PF3K_VCF",
                   "PHASED_DIPLOID", "GENOME1000_VCF", "GNOMAD_DIPLOID",
                   "MONO_GENOME", "GNOMAD_VCF", "GRCH_VCF", "CLINVAR_VCF",
                   "DBSNP_VCF"}

    @staticmethod
    def parse_data(file_info: BaseFileInfo, runtime: RuntimeProperties,
                   resources: AnalysisResources):
        # Resolve named data sources (Genome1000, Falciparum, Gnomad3_1, ...)
        # through the characteristics table first (kgl_data_file_type.h).
        from ..io.data_source import find_characteristic

        characteristic = find_characteristic(file_info.parser_type)
        if characteristic is not None:
            parser_type = characteristic.parser_type.value
        else:
            parser_type = file_info.parser_type.upper()
        if parser_type in ParserSelection.VCF_PARSERS:
            evidence_fields = None
            if isinstance(file_info, RuntimeVCFFileInfo) and file_info.evidence_ident:
                evidence_fields = runtime.evidence_fields(file_info.evidence_ident)
            vcf_kind = (
                "PF_DIPLOID" if parser_type in ("PF_DIPLOID", "PF7_VCF", "PF3K_VCF")
                else "PHASED_DIPLOID" if parser_type in ("PHASED_DIPLOID", "GENOME1000_VCF")
                else "GNOMAD_DIPLOID" if parser_type == "GNOMAD_DIPLOID"
                else "MONO_GENOME"
            )
            population, header, info_store = parse_vcf_population(
                file_info.file_name,
                population_id=file_info.file_ident,
                parser_type=vcf_kind,
                subscribed_info=evidence_fields,
                contig_alias=runtime.contig_alias,
            )
            genome = resources.get_resource(ResourceType.GENOME_DATABASE)
            if genome is not None:
                header.verify_contigs(genome, runtime.contig_alias)
            population.info_store = info_store  # attach for analyses
            return population
        if parser_type == "JSON_DBSNP":
            from ..io.json_parser import parse_dbsnp_json

            return parse_dbsnp_json(file_info.file_name)
        log().error("unknown parser type: {}", file_info.parser_type)
        return None


class ExecutePackage:
    """Execute the active packages of a runtime definition."""

    def __init__(self, runtime: RuntimeProperties, work_directory: Optional[str] = None,
                 device=None):
        self.runtime = runtime
        self.work_directory = work_directory or runtime.work_directory
        self.device = resolve_device(device)
        self.dropped: List[Tuple[str, str, str]] = []
        os.makedirs(self.work_directory, exist_ok=True)

    def execute_active(self) -> None:
        for package_ident in self.runtime.active_packages:
            package = self.runtime.get_package(package_ident)
            if package is None:
                log().error("active package '{}' not defined", package_ident)
                continue
            self.execute_package(package)

    def execute_package(self, package) -> None:
        log().info("executing package: {}", package.package_ident)
        resources = self.load_runtime_resources(package)

        analysis = PackageAnalysis(self.work_directory, self.runtime, device=self.device)
        analysis.initialize(package.analysis_idents, resources)

        for file_list in package.iteration_lists:
            for file_ident in file_list:
                file_info = self.runtime.data_files.get(file_ident)
                if file_info is None:
                    log().error("data file ident '{}' not defined", file_ident)
                    continue
                log().info("package {}: reading data file {} ({})",
                           package.package_ident, file_info.file_name,
                           file_info.parser_type)
                data = ParserSelection.parse_data(file_info, self.runtime, resources)
                if data is not None:
                    analysis.file_read_analysis(data)
            analysis.iteration_analysis()

        analysis.finalize_analysis()
        self.dropped += [(package.package_ident, ident, phase)
                         for ident, phase in analysis.dropped]
        log().info("package {} complete", package.package_ident)

    def load_runtime_resources(self, package) -> AnalysisResources:
        resources = AnalysisResources()
        for ident in package.resource_idents:
            defn = self.runtime.resources.get(ident)
            if defn is None:
                log().error("resource ident '{}' not defined", ident)
                continue
            if not load_resource(defn, resources):
                log().error("package {}: resource {} failed to load",
                            package.package_ident, ident)
        return resources
