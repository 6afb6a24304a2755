"""Data-source characteristics table: the typed vocabulary connecting XML
data-file declarations to parsers and data structures.

Capability parity with DataSourceEnum / ParserTypeEnum / DataStructureEnum
/ DataCharacteristic / DataDB (kgl_parser/kgl_data_file_type.h:32-120):
every declared source maps to its parser, conceptual structure and host
organism; the package executor dispatches on this table.

Copy of kgl_gene_tpu/io/data_source.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional

__all__ = [
    "DataSource", "ParserType", "DataStructure", "DataOrganism",
    "DataCharacteristic", "find_characteristic", "DATA_CHARACTERISTICS",
]


class DataSource(Enum):
    Genome1000 = "Genome1000"
    GnomadGenome3_1 = "GnomadGenome3_1"
    Falciparum = "Falciparum"
    GnomadExomes3_1 = "GnomadExomes3_1"
    GnomadExomes2_1 = "GnomadExomes2_1"
    Gnomad3_1 = "Gnomad3_1"
    Gnomad3_0 = "Gnomad3_0"
    Gnomad2_1 = "Gnomad2_1"
    Clinvar = "Clinvar"
    dbSNP = "dbSNP"
    JSONdbSNP = "JSONdbSNP"
    BioPMID = "BioPMID"
    NotImplemented = "NotImplemented"


class ParserType(Enum):
    DiploidPhased = "PHASED_DIPLOID"
    DiploidFalciparum = "PF_DIPLOID"
    DiploidGnomad = "GNOMAD_DIPLOID"  # gnomAD per-sample genomes GT parser
    MonoGenomeUnphased = "MONO_GENOME"
    MonoDBSNPUnphased = "MONO_GENOME"
    MonoJSONdbSNPUnphased = "JSON_DBSNP"
    ParseBioPMID = "BIO_PMID"
    FilenameOnly = "FILENAME_ONLY"


class DataStructure(Enum):
    DiploidPhased = "DiploidPhased"
    DiploidUnphased = "DiploidUnphased"
    UnphasedMonoGenome = "UnphasedMonoGenome"
    CitationMap = "CitationMap"
    BioPMIDMap = "BioPMIDMap"
    NoStructure = "NoStructure"


class DataOrganism(Enum):
    HomoSapien = "HomoSapien"
    PlasmodiumFalciparum = "PlasmodiumFalciparum"
    NoOrganism = "NoOrganism"


@dataclass(frozen=True)
class DataCharacteristic:
    source_text: str
    data_source: DataSource
    parser_type: ParserType
    data_structure: DataStructure
    data_organism: DataOrganism


DATA_CHARACTERISTICS = [
    DataCharacteristic("Genome1000", DataSource.Genome1000, ParserType.DiploidPhased,
                       DataStructure.DiploidPhased, DataOrganism.HomoSapien),
    DataCharacteristic("GnomadGenome3_1", DataSource.GnomadGenome3_1,
                       ParserType.DiploidGnomad, DataStructure.DiploidUnphased,
                       DataOrganism.HomoSapien),
    DataCharacteristic("Falciparum", DataSource.Falciparum,
                       ParserType.DiploidFalciparum, DataStructure.DiploidUnphased,
                       DataOrganism.PlasmodiumFalciparum),
    DataCharacteristic("GnomadExomes3_1", DataSource.GnomadExomes3_1,
                       ParserType.MonoGenomeUnphased, DataStructure.UnphasedMonoGenome,
                       DataOrganism.HomoSapien),
    DataCharacteristic("GnomadExomes2_1", DataSource.GnomadExomes2_1,
                       ParserType.MonoGenomeUnphased, DataStructure.UnphasedMonoGenome,
                       DataOrganism.HomoSapien),
    DataCharacteristic("Gnomad3_1", DataSource.Gnomad3_1,
                       ParserType.MonoGenomeUnphased, DataStructure.UnphasedMonoGenome,
                       DataOrganism.HomoSapien),
    DataCharacteristic("Gnomad3_0", DataSource.Gnomad3_0,
                       ParserType.MonoGenomeUnphased, DataStructure.UnphasedMonoGenome,
                       DataOrganism.HomoSapien),
    DataCharacteristic("Gnomad2_1", DataSource.Gnomad2_1,
                       ParserType.MonoGenomeUnphased, DataStructure.UnphasedMonoGenome,
                       DataOrganism.HomoSapien),
    DataCharacteristic("Clinvar", DataSource.Clinvar,
                       ParserType.MonoGenomeUnphased, DataStructure.UnphasedMonoGenome,
                       DataOrganism.HomoSapien),
    DataCharacteristic("dbSNP", DataSource.dbSNP,
                       ParserType.MonoDBSNPUnphased, DataStructure.UnphasedMonoGenome,
                       DataOrganism.HomoSapien),
    DataCharacteristic("JSONdbSNP", DataSource.JSONdbSNP,
                       ParserType.MonoJSONdbSNPUnphased, DataStructure.CitationMap,
                       DataOrganism.HomoSapien),
    DataCharacteristic("BioPMID", DataSource.BioPMID, ParserType.ParseBioPMID,
                       DataStructure.BioPMIDMap, DataOrganism.NoOrganism),
]

_BY_TEXT = {c.source_text.upper(): c for c in DATA_CHARACTERISTICS}
_BY_SOURCE = {c.data_source: c for c in DATA_CHARACTERISTICS}


def find_characteristic(key) -> Optional[DataCharacteristic]:
    """Lookup by XML source text or DataSource enum (DataDB::findCharacteristic)."""
    if isinstance(key, DataSource):
        return _BY_SOURCE.get(key)
    return _BY_TEXT.get(str(key).upper())
