"""OboGraphs JSON parser (go-basic.json, the modern GO distribution).

The reference predates OboGraphs but its parser factory
(kol_ontology/kol_ParserGoFactory.h) is the extension point this fills:
the JSON graph model (https://github.com/geneontology/obographs —
graphs[].nodes[] with CURIE/URI ids + meta, graphs[].edges[] with
sub/pred/obj) is converted into the same GoTermRecord stream the OBO and
OBO-XML parsers produce, so every downstream structure (CSR DAG, IC,
similarity) is format-agnostic.

Copy of kgl_gene_tpu/ontology/obographs.py.
"""

from __future__ import annotations

import json
from typing import Dict, List

from ..utils.logging import log
from .obo import GoTermRecord

__all__ = ["parse_go_obographs"]

# OboGraphs predicates -> OBO relation names (the DAG builder understands
# is_a / part_of / regulates family).
_PREDICATE_MAP = {
    "is_a": "is_a",
    "subClassOf": "is_a",
    "BFO:0000050": "part_of",
    "BFO_0000050": "part_of",
    "part_of": "part_of",
    "RO:0002211": "regulates",
    "RO_0002211": "regulates",
    "RO:0002212": "negatively_regulates",
    "RO_0002212": "negatively_regulates",
    "RO:0002213": "positively_regulates",
    "RO_0002213": "positively_regulates",
}

_NAMESPACE_MAP = {
    "biological_process": "biological_process",
    "molecular_function": "molecular_function",
    "cellular_component": "cellular_component",
}


def _curie(identifier: str) -> str:
    """URI or CURIE -> GO:XXXXXXX style id."""
    if not identifier:
        return ""
    for sep in ("#", "/"):
        if sep in identifier:
            identifier = identifier.rsplit(sep, 1)[1]
    return identifier.replace("GO_", "GO:")


def parse_go_obographs(path: str) -> List[GoTermRecord]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        log().error("OboGraphs JSON parse failed: {}", exc)
        return []
    records: Dict[str, GoTermRecord] = {}
    for graph in doc.get("graphs", []):
        for node in graph.get("nodes", []):
            term_id = _curie(node.get("id", ""))
            if not term_id.startswith("GO:"):
                continue
            record = records.get(term_id)
            if record is None:
                record = GoTermRecord()
                record.term_id = term_id
                records[term_id] = record
            record.name = node.get("lbl", record.name)
            meta = node.get("meta") or {}
            if meta.get("deprecated"):
                record.obsolete = True
            definition = meta.get("definition") or {}
            if definition.get("val"):
                record.definition = definition["val"]
            for prop in meta.get("basicPropertyValues", []):
                pred = _curie(prop.get("pred", ""))
                if pred in ("hasOBONamespace", "hasOboNamespace"):
                    record.namespace = _NAMESPACE_MAP.get(
                        prop.get("val", ""), prop.get("val", "")
                    )
                elif pred in ("hasAlternativeId", "hasAlternateId"):
                    alt = _curie(prop.get("val", ""))
                    if alt:
                        record.alt_ids.append(alt)
        for edge in graph.get("edges", []):
            sub = _curie(edge.get("sub", ""))
            obj = _curie(edge.get("obj", ""))
            pred = _curie(edge.get("pred", ""))
            relation = _PREDICATE_MAP.get(pred)
            if relation is None or not sub.startswith("GO:") or not obj.startswith("GO:"):
                continue
            record = records.get(sub)
            if record is None:
                record = GoTermRecord()
                record.term_id = sub
                records[sub] = record
            record.relations.append((relation, obj))
    return list(records.values())
