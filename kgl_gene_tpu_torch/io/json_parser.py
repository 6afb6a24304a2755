"""dbSNP JSON citation parser.

Capability parity with JSONInfoParser (kgl_parser/kgl_json_parser.h:59,
.cpp:98): dbSNP bulk JSON files are one JSON object per line; each record
yields rsid -> cited PMIDs. The reference streams with rapidjson; here the
stdlib json module parses per line (host-side, IO bound).

Copy of kgl_gene_tpu/io/json_parser.py.
"""

from __future__ import annotations

import json
from typing import Dict, Set

from ..utils.logging import log
from .streams import open_text_stream

__all__ = ["parse_dbsnp_json", "DBSnpCitations"]


class DBSnpCitations:
    def __init__(self, citation_map: Dict[str, Set[str]]):
        self.citation_map = citation_map

    def pmids_for(self, rsid: str) -> Set[str]:
        return self.citation_map.get(rsid, set())

    def __len__(self):
        return len(self.citation_map)


def parse_dbsnp_json(path: str) -> DBSnpCitations:
    citations: Dict[str, Set[str]] = {}
    parsed = skipped = 0
    with open_text_stream(path) as stream:
        for line_no, line in enumerate(stream, 1):
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            refsnp_id = record.get("refsnp_id")
            if not refsnp_id:
                skipped += 1
                continue
            rsid = f"rs{refsnp_id}"
            pmids = {str(p) for p in record.get("citations", [])}
            if pmids:
                citations.setdefault(rsid, set()).update(pmids)
            parsed += 1
    log().info("dbSNP JSON {}: {} records, {} skipped, {} cited rsids",
               path, parsed, skipped, len(citations))
    return DBSnpCitations(citations)
