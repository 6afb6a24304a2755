"""Runtime configuration model: the experiment-description vocabulary.

Capability parity with the reference's XML runtime definition
(kgl_app/kgl_runtime.h:33-306, kgl_properties.cpp:18-527,
kgl_properties_resource.h:39-120): the same vocabulary —
executeList (active packages), packageList (resources + iterative file
lists + analyses), analysisList (+ named parameter blocks), dataFileList
(ident -> path/parser/evidence), aliasList (contig aliasing), evidenceList
(subscribed INFO fields), resourceList — expressed as typed dataclasses
with BOTH an XML loader (same tag names, xml.etree instead of boost
property-tree) and direct Python construction.

Copy of kgl_gene_tpu/app/runtime.py.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.logging import log
from .alias import ContigAliasMap, ContigType

__all__ = [
    "RuntimeAnalysis", "RuntimePackage", "BaseFileInfo", "RuntimeVCFFileInfo",
    "ResourceDefinition", "RuntimeProperties", "ParameterMap",
]


@dataclass
class ParameterMap:
    """Named parameter block (ParameterMap/ActiveParameterList)."""

    name: str = ""
    parameters: Dict[str, List[str]] = field(default_factory=dict)

    def value(self, key: str, default: Optional[str] = None) -> Optional[str]:
        values = self.parameters.get(key)
        return values[0] if values else default

    def values(self, key: str) -> List[str]:
        return self.parameters.get(key, [])


@dataclass
class RuntimeAnalysis:
    """An analysis activation: ident + its named parameter blocks
    (RuntimeAnalysis, kgl_runtime.h:95)."""

    analysis_ident: str
    parameter_names: List[str] = field(default_factory=list)


@dataclass
class BaseFileInfo:
    """A data file declaration (BaseFileInfo, kgl_runtime.h:123)."""

    file_ident: str
    file_name: str
    parser_type: str  # DataSourceEnum name, e.g. PF_DIPLOID


@dataclass
class RuntimeVCFFileInfo(BaseFileInfo):
    """VCF file info: + evidence (INFO subscription) ident
    (kgl_runtime.h:155)."""

    evidence_ident: str = ""


@dataclass
class ResourceDefinition:
    """One resource declaration: type + ident + named file parameters
    (ResourceProperties vocabulary: genome, ontology, gene_nomenclature,
    genealogy, genome_aux, citation, entrez, Pf7Sample, Pf7Fws,
    Pf7Distance, bioPMID, PubmedAPI, Pf3kCOI)."""

    resource_type: str
    resource_ident: str
    parameters: Dict[str, str] = field(default_factory=dict)


@dataclass
class RuntimePackage:
    """A package: ordered resources, iterative file lists, analyses
    (RuntimePackage, kgl_runtime.h:56)."""

    package_ident: str
    resource_idents: List[str] = field(default_factory=list)
    iteration_lists: List[List[str]] = field(default_factory=list)
    analysis_idents: List[str] = field(default_factory=list)


class RuntimeProperties:
    """The full parsed runtime definition."""

    def __init__(self):
        self.work_directory: str = "."
        self.active_packages: List[str] = []
        self.packages: Dict[str, RuntimePackage] = {}
        self.analyses: Dict[str, RuntimeAnalysis] = {}
        self.parameter_blocks: Dict[str, ParameterMap] = {}
        self.data_files: Dict[str, BaseFileInfo] = {}
        self.resources: Dict[str, ResourceDefinition] = {}
        self.contig_alias = ContigAliasMap()
        self.evidence_map: Dict[str, List[str]] = {}  # ident -> INFO fields

    # ------------------------------------------------------------------ #
    @classmethod
    def read_properties(cls, xml_file: str) -> "RuntimeProperties":
        """Parse the runTime XML (RuntimeProperties::readProperties)."""
        props = cls()
        tree = ET.parse(xml_file)
        root = tree.getroot()
        if root.tag != "runTime":
            log().warn("runtime XML root is '{}', expected 'runTime'", root.tag)

        for node in root.findall("./executeList/active"):
            props.active_packages.append(node.text.strip())

        for pkg in root.findall("./packageList/package"):
            ident = pkg.findtext("packageIdent", "").strip()
            package = RuntimePackage(package_ident=ident)
            for res in pkg.findall("./resourceList/resourceIdent"):
                package.resource_idents.append(res.text.strip())
            for iteration in pkg.findall("./iterationList/iteration"):
                files = [n.text.strip() for n in iteration.findall("fileIdent")]
                package.iteration_lists.append(files)
            for ana in pkg.findall("./analysisList/analysisIdent"):
                package.analysis_idents.append(ana.text.strip())
            props.packages[ident] = package

        for ana in root.findall("./analysisList/analysis"):
            ident = ana.findtext("analysisIdent", "").strip()
            params = [n.text.strip() for n in ana.findall("parameterIdent")]
            props.analyses[ident] = RuntimeAnalysis(ident, params)

        for block in root.findall("./parameterList/parameterBlock"):
            name = block.findtext("blockName", "").strip()
            pmap = ParameterMap(name=name)
            for p in block.findall("parameter"):
                key = p.findtext("name", "").strip()
                values = [v.text.strip() for v in p.findall("value")]
                pmap.parameters[key] = values
            props.parameter_blocks[name] = pmap

        for df in root.findall("./dataFileList/dataFile"):
            ident = df.findtext("fileIdent", "").strip()
            file_name = df.findtext("fileName", "").strip()
            parser = df.findtext("parser", "").strip()
            evidence = df.findtext("evidenceIdent", "").strip()
            if evidence:
                props.data_files[ident] = RuntimeVCFFileInfo(ident, file_name, parser, evidence)
            else:
                props.data_files[ident] = BaseFileInfo(ident, file_name, parser)

        for res in root.findall("./resourceList/resource"):
            rtype = res.findtext("resourceType", "").strip()
            ident = res.findtext("resourceIdent", "").strip()
            params = {
                child.tag: (child.text or "").strip()
                for child in res
                if child.tag not in ("resourceType", "resourceIdent")
            }
            props.resources[ident] = ResourceDefinition(rtype, ident, params)

        for alias in root.findall("./aliasList/alias"):
            contig = alias.findtext("contigIdent", "").strip()
            ctype = alias.findtext("contigType", "AUTOSOME").strip()
            type_map = {
                "AUTOSOME": ContigType.AUTOSOMAL,
                "ALLOSOME_X": ContigType.ALLOSOME_X,
                "ALLOSOME_Y": ContigType.ALLOSOME_Y,
                "MITOCHONDRIA": ContigType.MITOCHONDRIA,
            }
            for name in alias.findall("aliasIdent"):
                props.contig_alias.set_alias(
                    name.text.strip(), contig, type_map.get(ctype, ContigType.AUTOSOMAL)
                )

        for ev in root.findall("./evidenceList/evidence"):
            ident = ev.findtext("evidenceIdent", "").strip()
            fields = [n.text.strip() for n in ev.findall("./vcfInfoList/infoIdent")]
            props.evidence_map[ident] = fields

        props.work_directory = root.findtext("workDirectory", ".").strip()
        return props

    # ------------------------------------------------------------------ #
    def get_package(self, ident: str) -> Optional[RuntimePackage]:
        return self.packages.get(ident)

    def evidence_fields(self, ident: str) -> List[str]:
        return self.evidence_map.get(ident, [])

    def analysis_parameters(self, analysis_ident: str) -> List[ParameterMap]:
        analysis = self.analyses.get(analysis_ident)
        if analysis is None:
            return []
        return [
            self.parameter_blocks[name]
            for name in analysis.parameter_names
            if name in self.parameter_blocks
        ]
