"""Typed resource container + loader registry.

Capability parity with ResourceBase/AnalysisResources
(kgl_app/kgl_runtime_resource.h:25-134) and the package resource loaders
(kgl_package_resource.cpp, _pf.cpp): 13 resource types loadable from a
ResourceDefinition, held in a typed container the analysis plugins query.

Copy of kgl_gene_tpu/app/resources.py, on the port's loaders (the
ontology resource is the port's OntologyDatabase).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..utils.logging import log
from .runtime import ResourceDefinition

__all__ = ["ResourceType", "AnalysisResources", "load_resource", "RESOURCE_LOADERS"]


class ResourceType:
    GENOME_DATABASE = "GenomeDatabase"
    ONTOLOGY_DATABASE = "OntologyDatabase"
    GENE_NOMENCLATURE = "GeneNomenclature"
    GENEALOGY = "Genealogy"
    GENOME_AUX = "GenomeAux"
    CITATION = "Citation"
    ENTREZ = "Entrez"
    PF7_SAMPLE = "Pf7Sample"
    PF7_FWS = "Pf7Fws"
    PF7_DISTANCE = "Pf7Distance"
    BIO_PMID = "BioPMID"
    PUBMED_API = "PubmedAPI"
    PF3K_COI = "Pf3kCOI"


class AnalysisResources:
    """Typed lookup: resource type -> ident -> resource object."""

    def __init__(self):
        self._resources: Dict[str, Dict[str, object]] = {}

    def add_resource(self, resource_type: str, ident: str, resource: object) -> None:
        self._resources.setdefault(resource_type, {})[ident] = resource

    def get_resource(self, resource_type: str, ident: str = "") -> Optional[object]:
        by_type = self._resources.get(resource_type, {})
        if ident:
            return by_type.get(ident)
        return next(iter(by_type.values()), None)

    def get_resources(self, resource_type: str) -> List[object]:
        return list(self._resources.get(resource_type, {}).values())

    def idents(self, resource_type: str) -> List[str]:
        return list(self._resources.get(resource_type, {}))


# --------------------------------------------------------------------------- #
# loaders
# --------------------------------------------------------------------------- #
def _load_genome(defn: ResourceDefinition):
    from ..genome.genome import GenomeReference

    return GenomeReference.create_genome_database(
        defn.resource_ident,
        fasta_file=defn.parameters["fastaFile"],
        gff_file=defn.parameters.get("gffFile"),
        gaf_file=defn.parameters.get("gafFile"),
        translation_table=defn.parameters.get("translationTable", "NCBI_TABLE_1"),
    )


def _load_ontology(defn: ResourceDefinition):
    from ..ontology.database import OntologyDatabase

    return OntologyDatabase(
        defn.resource_ident,
        go_obo_file=defn.parameters["goFile"],
        gaf_file=defn.parameters["annotationFile"],
    )


def _load_nomenclature(defn: ResourceDefinition):
    from ..io.resource_parsers import parse_uniprot_nomenclature

    return parse_uniprot_nomenclature(defn.parameters["file"], defn.resource_ident)


def _load_genealogy(defn: ResourceDefinition):
    from ..io.resource_parsers import parse_ped_genealogy

    return parse_ped_genealogy(defn.parameters["file"], defn.resource_ident)


def _load_genome_aux(defn: ResourceDefinition):
    from ..io.resource_parsers import parse_genome_aux

    return parse_genome_aux(defn.parameters["file"], defn.resource_ident)


def _load_citation(defn: ResourceDefinition):
    from ..io.resource_parsers import parse_citations

    return parse_citations(defn.parameters["file"], defn.resource_ident)


def _load_entrez(defn: ResourceDefinition):
    from ..io.resource_parsers import parse_entrez

    return parse_entrez(defn.parameters["file"], defn.resource_ident)


def _load_pf7_sample(defn: ResourceDefinition):
    from ..io.resource_parsers import parse_pf7_sample

    return parse_pf7_sample(defn.parameters["file"], defn.resource_ident)


def _load_pf7_fws(defn: ResourceDefinition):
    from ..io.resource_parsers import parse_pf7_fws

    return parse_pf7_fws(defn.parameters["file"], defn.resource_ident)


def _load_pf7_distance(defn: ResourceDefinition):
    from ..io.resource_parsers import parse_pf7_distance

    return parse_pf7_distance(
        defn.parameters["matrixFile"], defn.parameters["sampleFile"], defn.resource_ident
    )


def _load_bio_pmid(defn: ResourceDefinition):
    from ..io.resource_parsers import parse_bio_pmid

    return parse_bio_pmid(defn.parameters["file"], defn.resource_ident)


def _load_pubmed_api(defn: ResourceDefinition):
    from ..literature.pubmed import PubmedRequester

    return PubmedRequester(
        defn.resource_ident, cache_directory=defn.parameters.get("cacheDirectory", "")
    )


def _load_pf3k_coi(defn: ResourceDefinition):
    from ..io.resource_parsers import parse_pf3k_coi

    return parse_pf3k_coi(defn.parameters["file"], defn.resource_ident)


RESOURCE_LOADERS: Dict[str, Callable[[ResourceDefinition], object]] = {
    ResourceType.GENOME_DATABASE: _load_genome,
    ResourceType.ONTOLOGY_DATABASE: _load_ontology,
    ResourceType.GENE_NOMENCLATURE: _load_nomenclature,
    ResourceType.GENEALOGY: _load_genealogy,
    ResourceType.GENOME_AUX: _load_genome_aux,
    ResourceType.CITATION: _load_citation,
    ResourceType.ENTREZ: _load_entrez,
    ResourceType.PF7_SAMPLE: _load_pf7_sample,
    ResourceType.PF7_FWS: _load_pf7_fws,
    ResourceType.PF7_DISTANCE: _load_pf7_distance,
    ResourceType.BIO_PMID: _load_bio_pmid,
    ResourceType.PUBMED_API: _load_pubmed_api,
    ResourceType.PF3K_COI: _load_pf3k_coi,
}


def load_resource(defn: ResourceDefinition, container: AnalysisResources) -> bool:
    loader = RESOURCE_LOADERS.get(defn.resource_type)
    if loader is None:
        log().error("unknown resource type: {}", defn.resource_type)
        return False
    try:
        resource = loader(defn)
    except (OSError, KeyError) as exc:
        log().error("resource {} ({}) failed to load: {}",
                    defn.resource_ident, defn.resource_type, exc)
        return False
    container.add_resource(defn.resource_type, defn.resource_ident, resource)
    return True
