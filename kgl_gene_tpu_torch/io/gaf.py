"""GAF 2.x parser: gene -> GO term annotation.

Capability parity with GeneOntology/ParserAnnotationGaf
(kgl_genomics/kgl_parser/kgl_gaf_parser.h:27 and
kol_ontology ParserAnnotationGaf): 17-column tab format, comment lines
skipped; returns gene id -> GO term ids (and optionally the full records
for the ontology annotation model, including evidence codes and the
BP/MF/CC aspect).

Copy of kgl_gene_tpu/io/gaf.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..utils.logging import log
from .streams import open_text_stream

__all__ = ["GafRecord", "read_gaf", "read_gaf_records"]


@dataclass
class GafRecord:
    db: str
    gene_id: str       # DB object ID (column 2)
    gene_symbol: str   # column 3
    qualifier: str     # column 4 (may contain NOT)
    go_term: str       # column 5
    evidence_code: str # column 7
    aspect: str        # column 9: P (BP), F (MF), C (CC)
    taxon: str         # column 13


def read_gaf_records(path: str) -> List[GafRecord]:
    records: List[GafRecord] = []
    with open_text_stream(path) as stream:
        for line_no, line in enumerate(stream, 1):
            line = line.rstrip("\n")
            if not line or line.startswith("!"):
                continue
            fields = line.split("\t")
            if len(fields) < 15:
                log().warn("GAF {}:{} expected >=15 fields, found {}", path, line_no, len(fields))
                continue
            records.append(
                GafRecord(
                    db=fields[0],
                    gene_id=fields[1],
                    gene_symbol=fields[2],
                    qualifier=fields[3],
                    go_term=fields[4],
                    evidence_code=fields[6],
                    aspect=fields[8],
                    taxon=fields[12],
                )
            )
    return records


def read_gaf(path: str) -> Dict[str, List[str]]:
    """gene id -> GO term list (NOT-qualified annotations excluded)."""
    gene_go: Dict[str, List[str]] = {}
    for rec in read_gaf_records(path):
        if "NOT" in rec.qualifier.split("|"):
            continue
        gene_go.setdefault(rec.gene_id, []).append(rec.go_term)
    return gene_go
