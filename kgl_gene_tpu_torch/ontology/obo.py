"""GO OBO parser.

Capability parity with ParserGoObo / GoTermRecord
(kol_ontology/kol_ParserGoObo.h, contrib/kol_GoGraphImpl.h GoTermRecord:25):
parses [Term] stanzas from go.obo / go-basic.obo into term records with
id/name/namespace/definition, is_a and typed relationship edges, alt_ids
and obsolete flags. Relationship filtering is applied by the graph builder
(PolicyRelationship analogue).

Copy of kgl_gene_tpu/ontology/obo.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ..io.streams import open_text_stream

__all__ = ["GoTermRecord", "parse_go_obo", "NAMESPACES"]

NAMESPACES = ("biological_process", "molecular_function", "cellular_component")


@dataclass
class GoTermRecord:
    term_id: str = ""
    name: str = ""
    namespace: str = ""
    definition: str = ""
    alt_ids: List[str] = field(default_factory=list)
    # (relation, target term): relation is "is_a", "part_of", ...
    relations: List[Tuple[str, str]] = field(default_factory=list)
    obsolete: bool = False


def parse_go_obo(path: str) -> List[GoTermRecord]:
    records: List[GoTermRecord] = []
    current: GoTermRecord | None = None
    in_term = False
    with open_text_stream(path) as stream:
        for line in stream:
            line = line.rstrip("\n")
            if line.startswith("["):
                if current is not None and in_term:
                    records.append(current)
                in_term = line == "[Term]"
                current = GoTermRecord() if in_term else None
                continue
            if not in_term or current is None or not line:
                continue
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            if key == "id":
                current.term_id = value
            elif key == "name":
                current.name = value
            elif key == "namespace":
                current.namespace = value
            elif key == "def":
                current.definition = value
            elif key == "alt_id":
                current.alt_ids.append(value)
            elif key == "is_a":
                target = value.split("!")[0].strip()
                current.relations.append(("is_a", target))
            elif key == "relationship":
                parts = value.split("!")[0].split()
                if len(parts) >= 2:
                    current.relations.append((parts[0], parts[1]))
            elif key == "is_obsolete":
                current.obsolete = value.lower() == "true"
    if current is not None and in_term:
        records.append(current)
    return records


def parse_go_file(path: str):
    """Format-dispatching GO parser factory (kol_ParserGoFactory.h parity):
    .obo -> OBO, .xml/.obo-xml -> OBO-XML (incl. godatabase namespaced
    variant), .json -> OboGraphs."""
    lower = path.lower()
    if lower.endswith(".json"):
        from .obographs import parse_go_obographs

        return parse_go_obographs(path)
    if lower.endswith((".xml", ".obo-xml", ".obo_xml")):
        from .go_xml import parse_go_xml

        return parse_go_xml(path)
    return parse_go_obo(path)
