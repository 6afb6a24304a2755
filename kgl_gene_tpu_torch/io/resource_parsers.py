"""Auxiliary resource parsers: sample metadata, FWS, distance matrices,
genealogy, nomenclature, citations, Entrez, bio-concepts, COI.

Capability parity with the reference's tabular resource parsers
(kgl_parser/: kgl_pf7_sample_parser.h:22-86, kgl_pf7_fws_parser.h:26-80,
kgl_pf7_genetic_distance_parser.h, kgl_Pf7_physical_distance.h,
kgl_pf3k_coi.h, kgl_hsgenealogy_parser.h:22-151, kgl_hsgenome_aux.h,
kgl_uniprot_parser.h, kgl_ensembl_id_parser.h, kgl_entrez_parser.h,
kgl_citation_parser.h, kgl_bio_pmid_parser.h), all built on the square
text parser. Each parser yields a typed resource object registered with
the app resource container.

Copy of kgl_gene_tpu/io/resource_parsers.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..utils.logging import log
from .square_parser import COMMA, TAB, parse_square_text

__all__ = [
    "Pf7SampleRecord", "Pf7SampleResource", "parse_pf7_sample",
    "Pf7FwsResource", "parse_pf7_fws",
    "Pf7DistanceResource", "parse_pf7_distance",
    "Pf7PhysicalDistance",
    "Pf3kCOIResource", "parse_pf3k_coi",
    "GenealogyRecord", "GenealogyResource", "parse_ped_genealogy",
    "GenomeAuxRecord", "GenomeAuxResource", "parse_genome_aux",
    "NomenclatureResource", "parse_uniprot_nomenclature", "parse_ensembl_nomenclature",
    "EntrezResource", "parse_entrez",
    "CitationResource", "parse_citations",
    "BioPMIDResource", "parse_bio_pmid",
]


# --------------------------------------------------------------------------- #
# Pf7 sample metadata
# --------------------------------------------------------------------------- #
@dataclass
class Pf7SampleRecord:
    sample_id: str
    study: str = ""
    country: str = ""
    location1: str = ""
    country_latitude: str = ""
    country_longitude: str = ""
    location1_latitude: str = ""
    location1_longitude: str = ""
    year: str = ""
    ena: str = ""
    all_samples: str = ""
    population: str = ""
    callable_fraction: str = ""
    qc_pass: str = ""
    qc_fail_reason: str = ""
    sample_type: str = ""
    sample_in_pf6: str = ""

    def passes(self) -> bool:
        return self.qc_pass.upper() == "TRUE"


class Pf7SampleResource:
    """Sample metadata + QC filtering (Pf7SampleResource)."""

    def __init__(self, identifier: str, records: List[Pf7SampleRecord]):
        self.identifier = identifier
        self.sample_map: Dict[str, Pf7SampleRecord] = {r.sample_id: r for r in records}

    def qc_pass_samples(self) -> Set[str]:
        return {sid for sid, r in self.sample_map.items() if r.passes()}

    def filter_pass_qc_genomes(self, population):
        """Population view restricted to QC-pass samples
        (filterPassQCGenomes)."""
        from ..variant.filter import GenomeListFilter

        return population.view_filter(GenomeListFilter(self.qc_pass_samples()))

    def annotated_genome_map(self) -> Dict[str, str]:
        return {
            sid: f"{r.location1}|{r.country}" for sid, r in self.sample_map.items()
        }


def parse_pf7_sample(path: str, identifier: str = "Pf7Sample") -> Pf7SampleResource:
    rows = parse_square_text(path, TAB, header=True)
    records = []
    for row in rows:
        padded = row + [""] * (17 - len(row))
        records.append(Pf7SampleRecord(*padded[:17]))
    return Pf7SampleResource(identifier, records)


# --------------------------------------------------------------------------- #
# Pf7 FWS
# --------------------------------------------------------------------------- #
class Pf7FwsResource:
    """Published per-sample FWS values; monoclonal threshold 0.95
    (kgl_pf7_fws_parser.h:26-80)."""

    MONOCLONAL_FWS = 0.95

    def __init__(self, identifier: str, fws_map: Dict[str, float]):
        self.identifier = identifier
        self.fws_map = fws_map

    def get(self, sample_id: str, default=None):
        return self.fws_map.get(sample_id, default)

    def monoclonal_samples(self, threshold: float = MONOCLONAL_FWS) -> Set[str]:
        return {s for s, v in self.fws_map.items() if v >= threshold}

    def filter_monoclonal_genomes(self, population, threshold: float = MONOCLONAL_FWS):
        from ..variant.filter import GenomeListFilter

        return population.view_filter(GenomeListFilter(self.monoclonal_samples(threshold)))


def parse_pf7_fws(path: str, identifier: str = "Pf7FWS") -> Pf7FwsResource:
    rows = parse_square_text(path, TAB, header=True)
    fws_map: Dict[str, float] = {}
    for row in rows:
        if len(row) < 2:
            continue
        try:
            fws_map[row[0]] = float(row[1])
        except ValueError:
            log().warn("Pf7 FWS: non-numeric value for sample {}", row[0])
    return Pf7FwsResource(identifier, fws_map)


# --------------------------------------------------------------------------- #
# Pf7 pairwise genetic distance matrix
# --------------------------------------------------------------------------- #
class Pf7DistanceResource:
    def __init__(self, identifier: str, sample_ids: List[str], matrix: np.ndarray):
        self.identifier = identifier
        self.sample_ids = sample_ids
        self.index = {s: i for i, s in enumerate(sample_ids)}
        self.matrix = matrix

    def distance(self, sample_a: str, sample_b: str) -> Optional[float]:
        ia, ib = self.index.get(sample_a), self.index.get(sample_b)
        if ia is None or ib is None:
            return None
        value = self.matrix[ia, ib]
        return None if np.isnan(value) else float(value)


def parse_pf7_distance(matrix_path: str, sample_id_path: str,
                       identifier: str = "Pf7Distance") -> Pf7DistanceResource:
    ids = [row[0] for row in parse_square_text(sample_id_path, TAB)]
    rows = parse_square_text(matrix_path, TAB)
    matrix = np.array(
        [[float(v) if v not in ("", "nan", "NA") else np.nan for v in row] for row in rows]
    )
    return Pf7DistanceResource(identifier, ids, matrix)


# --------------------------------------------------------------------------- #
# Physical (great-circle) distance between sample sites
# --------------------------------------------------------------------------- #
class Pf7PhysicalDistance:
    """Great-circle sample separation from lat/long metadata
    (kgl_Pf7_physical_distance.h)."""

    EARTH_RADIUS_KM = 6371.0

    def __init__(self, sample_resource: Pf7SampleResource):
        self.samples = sample_resource

    @staticmethod
    def great_circle_km(lat1: float, lon1: float, lat2: float, lon2: float) -> float:
        p1, p2 = math.radians(lat1), math.radians(lat2)
        dp = math.radians(lat2 - lat1)
        dl = math.radians(lon2 - lon1)
        a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
        return 2 * Pf7PhysicalDistance.EARTH_RADIUS_KM * math.asin(math.sqrt(a))

    def sample_distance_km(self, sample_a: str, sample_b: str) -> Optional[float]:
        ra = self.samples.sample_map.get(sample_a)
        rb = self.samples.sample_map.get(sample_b)
        if ra is None or rb is None:
            return None
        try:
            return self.great_circle_km(
                float(ra.location1_latitude), float(ra.location1_longitude),
                float(rb.location1_latitude), float(rb.location1_longitude),
            )
        except ValueError:
            return None


# --------------------------------------------------------------------------- #
# Pf3k complexity of infection
# --------------------------------------------------------------------------- #
class Pf3kCOIResource:
    def __init__(self, identifier: str, coi_map: Dict[str, int]):
        self.identifier = identifier
        self.coi_map = coi_map

    def coi(self, sample_id: str) -> Optional[int]:
        return self.coi_map.get(sample_id)


def parse_pf3k_coi(path: str, identifier: str = "Pf3kCOI") -> Pf3kCOIResource:
    rows = parse_square_text(path, TAB, header=True)
    coi: Dict[str, int] = {}
    for row in rows:
        if len(row) >= 2 and row[1].isdigit():
            coi[row[0]] = int(row[1])
    return Pf3kCOIResource(identifier, coi)


# --------------------------------------------------------------------------- #
# human genealogy (PED)
# --------------------------------------------------------------------------- #
@dataclass
class GenealogyRecord:
    family_id: str
    individual_id: str
    paternal_id: str
    maternal_id: str
    sex: str
    phenotype: str
    population: str = ""
    population_description: str = ""
    gender: str = ""
    relationship: str = ""
    siblings: str = ""
    second_order: str = ""
    third_order: str = ""
    comments: str = ""


class GenealogyResource:
    """PED pedigree records (kgl_hsgenealogy_parser.h:22-151)."""

    def __init__(self, identifier: str, records: List[GenealogyRecord]):
        self.identifier = identifier
        self.map: Dict[str, GenealogyRecord] = {r.individual_id: r for r in records}

    def get(self, individual_id: str) -> Optional[GenealogyRecord]:
        return self.map.get(individual_id)

    def population_of(self, individual_id: str) -> str:
        rec = self.map.get(individual_id)
        return rec.population if rec else ""


def parse_ped_genealogy(path: str, identifier: str = "Genealogy") -> GenealogyResource:
    rows = parse_square_text(path, TAB, header=True)
    records = []
    for row in rows:
        padded = row + [""] * (14 - len(row))
        records.append(GenealogyRecord(*padded[:14]))
    return GenealogyResource(identifier, records)


# --------------------------------------------------------------------------- #
# genome aux (sample population info for aggregate VCFs)
# --------------------------------------------------------------------------- #
@dataclass
class GenomeAuxRecord:
    individual_id: str
    sex: str = ""
    population: str = ""
    population_description: str = ""
    super_population: str = ""
    super_description: str = ""


class GenomeAuxResource:
    def __init__(self, identifier: str, records: List[GenomeAuxRecord]):
        self.identifier = identifier
        self.map = {r.individual_id: r for r in records}

    def super_population_of(self, individual_id: str) -> str:
        rec = self.map.get(individual_id)
        return rec.super_population if rec else ""


def parse_genome_aux(path: str, identifier: str = "GenomeAux") -> GenomeAuxResource:
    rows = parse_square_text(path, TAB, header=True)
    records = []
    for row in rows:
        padded = row + [""] * (6 - len(row))
        records.append(GenomeAuxRecord(*padded[:6]))
    return GenomeAuxResource(identifier, records)


# --------------------------------------------------------------------------- #
# gene nomenclature (Uniprot / Ensembl id cross-maps)
# --------------------------------------------------------------------------- #
class NomenclatureResource:
    """Symbol <-> HGNC <-> Ensembl id maps."""

    def __init__(self, identifier: str, rows: List[Tuple[str, str, str]]):
        self.identifier = identifier
        self.symbol_to_ensembl: Dict[str, str] = {}
        self.ensembl_to_symbol: Dict[str, str] = {}
        self.hgnc_to_ensembl: Dict[str, str] = {}
        for symbol, hgnc, ensembl in rows:
            if symbol and ensembl:
                self.symbol_to_ensembl[symbol] = ensembl
                self.ensembl_to_symbol[ensembl] = symbol
            if hgnc and ensembl:
                self.hgnc_to_ensembl[hgnc] = ensembl


def parse_uniprot_nomenclature(path: str, identifier: str = "Uniprot") -> NomenclatureResource:
    rows = parse_square_text(path, TAB, header=True)
    triplets = [(r[0], r[1] if len(r) > 1 else "", r[2] if len(r) > 2 else "") for r in rows]
    return NomenclatureResource(identifier, triplets)


def parse_ensembl_nomenclature(path: str, identifier: str = "Ensembl") -> NomenclatureResource:
    return parse_uniprot_nomenclature(path, identifier)


# --------------------------------------------------------------------------- #
# Entrez gene ids
# --------------------------------------------------------------------------- #
class EntrezResource:
    def __init__(self, identifier: str, symbol_to_entrez: Dict[str, str]):
        self.identifier = identifier
        self.symbol_to_entrez = symbol_to_entrez

    def entrez_id(self, symbol: str) -> str:
        return self.symbol_to_entrez.get(symbol, "")


def parse_entrez(path: str, identifier: str = "Entrez") -> EntrezResource:
    rows = parse_square_text(path, TAB, header=True)
    return EntrezResource(identifier, {r[0]: r[1] for r in rows if len(r) >= 2})


# --------------------------------------------------------------------------- #
# allele citations (rsid -> PMIDs)
# --------------------------------------------------------------------------- #
class CitationResource:
    def __init__(self, identifier: str, citations: Dict[str, Set[str]]):
        self.identifier = identifier
        self.citation_map = citations

    def pmids_for(self, rsid: str) -> Set[str]:
        return self.citation_map.get(rsid, set())


def parse_citations(path: str, identifier: str = "Citations") -> CitationResource:
    rows = parse_square_text(path, TAB)
    citations: Dict[str, Set[str]] = {}
    for row in rows:
        if len(row) >= 2:
            citations.setdefault(row[0], set()).add(row[1])
    return CitationResource(identifier, citations)


# --------------------------------------------------------------------------- #
# PMID <-> bio-concept (disease/gene MeSH) records
# --------------------------------------------------------------------------- #
class BioPMIDResource:
    def __init__(self, identifier: str, disease_map: Dict[str, Set[str]],
                 entrez_map: Dict[str, Set[str]]):
        self.identifier = identifier
        self.disease_pmid_map = disease_map
        self.entrez_pmid_map = entrez_map

    def disease_pmids(self, mesh_id: str) -> Set[str]:
        return self.disease_pmid_map.get(mesh_id, set())

    def entrez_pmids(self, entrez_id: str) -> Set[str]:
        return self.entrez_pmid_map.get(entrez_id, set())


def parse_bio_pmid(path: str, identifier: str = "BioPMID") -> BioPMIDResource:
    """Format: pmid <tab> type(Disease|Gene) <tab> concept id."""
    rows = parse_square_text(path, TAB)
    disease: Dict[str, Set[str]] = {}
    entrez: Dict[str, Set[str]] = {}
    for row in rows:
        if len(row) < 3:
            continue
        pmid, concept_type, concept_id = row[0], row[1].lower(), row[2]
        if concept_type == "disease":
            disease.setdefault(concept_id, set()).add(pmid)
        elif concept_type == "gene":
            entrez.setdefault(concept_id, set()).add(pmid)
    return BioPMIDResource(identifier, disease, entrez)
