"""GO OBO-XML parser.

Capability parity with ParserGoXml/ParserGoRapidXml
(kol_ontology/kol_ParserGoXml.h, kol_ParserGoRapidXml.h): parses the
go_daily-termdb.obo-xml format (<obo><term>...</term></obo>) into the same
GoTermRecord stream the OBO parser produces, via the standard library's
ElementTree instead of rapidxml.
Schema variants handled: plain obo-xml, the namespaced godatabase variant
(<go:term> with go: prefixes), def text either nested in <defstr> or inline,
and is_a targets given as text or a `resource`/`rdf:resource` attribute.

Copy of kgl_gene_tpu/ontology/go_xml.py on xml.etree.ElementTree instead of
lxml (the card's machine has no lxml). ElementTree names a namespaced tag
or attribute `{uri}name`, as lxml does, and a comment's tag is a function,
so _local reads both parsers' trees alike.
"""

from __future__ import annotations

from typing import List, Optional

import xml.etree.ElementTree as ET

from ..utils.logging import log
from .obo import GoTermRecord

__all__ = ["parse_go_xml"]


def _local(tag) -> str:
    """Tag name without any XML namespace ({uri}name or prefix:name)."""
    if not isinstance(tag, str):
        return ""  # comments / processing instructions
    if tag.startswith("{"):
        return tag.rsplit("}", 1)[1]
    return tag.rsplit(":", 1)[-1]


def _find_text(term, name: str) -> str:
    for child in term:
        if _local(child.tag) == name:
            return (child.text or "").strip()
    return ""


def _iter_children(term, name: str):
    for child in term:
        if _local(child.tag) == name:
            yield child


def _target_of(elem) -> str:
    """Relation target: element text, or an rdf:resource-style attribute."""
    if elem.text and elem.text.strip():
        return elem.text.strip()
    for key, value in elem.attrib.items():
        if _local(key) in ("resource", "about", "rdf_resource"):
            value = value.strip()
            # URI form http://.../obo#GO:0008150 or .../GO_0008150
            for sep in ("#", "/"):
                if sep in value:
                    value = value.rsplit(sep, 1)[1]
            return value.replace("GO_", "GO:")
    return ""


def parse_go_xml(path: str) -> List[GoTermRecord]:
    records: List[GoTermRecord] = []
    try:
        tree = ET.parse(path)
    except (OSError, ET.ParseError) as exc:
        log().error("GO XML parse failed: {}", exc)
        return records
    for term in tree.iter():
        if _local(term.tag) != "term":
            continue
        record = GoTermRecord()
        record.term_id = _find_text(term, "id") or _find_text(term, "accession")
        record.name = _find_text(term, "name")
        record.namespace = _find_text(term, "namespace")
        for defn in _iter_children(term, "def"):
            nested = _find_text(defn, "defstr")
            record.definition = nested or (defn.text or "").strip()
        for definition in _iter_children(term, "definition"):  # godatabase
            if not record.definition:
                record.definition = (definition.text or "").strip()
        for alt in _iter_children(term, "alt_id"):
            if alt.text:
                record.alt_ids.append(alt.text.strip())
        for isa in _iter_children(term, "is_a"):
            target = _target_of(isa)
            if target:
                record.relations.append(("is_a", target))
        for rel in _iter_children(term, "relationship"):
            rel_type = _find_text(rel, "type")
            target = _find_text(rel, "to") or _target_of(rel)
            if rel_type and target:
                record.relations.append((rel_type, target))
        for part in _iter_children(term, "part_of"):  # godatabase shorthand
            target = _target_of(part)
            if target:
                record.relations.append(("part_of", target))
        obsolete = _find_text(term, "is_obsolete")
        record.obsolete = obsolete in ("1", "true")
        if record.term_id:
            records.append(record)
    return records
