"""Contig alias mapping (chr1 <-> 1 <-> CM000663 ...).

Capability parity with ContigAliasMap (kgl_app/kgl_runtime.h:33-306 alias
vocabulary): maps VCF contig names onto reference genome contig ids and
records the contig class (autosome / allosome / mitochondria).

Copy of kgl_gene_tpu/app/alias.py.
"""

from __future__ import annotations

from enum import Enum
from typing import Dict

__all__ = ["ContigType", "ContigAliasMap"]


class ContigType(Enum):
    AUTOSOMAL = "AUTOSOME"
    ALLOSOME_X = "ALLOSOME_X"
    ALLOSOME_Y = "ALLOSOME_Y"
    MITOCHONDRIA = "MITOCHONDRIA"


class ContigAliasMap:
    def __init__(self):
        self._alias: Dict[str, str] = {}
        self._type: Dict[str, ContigType] = {}

    def set_alias(self, alias: str, contig_id: str,
                  contig_type: ContigType = ContigType.AUTOSOMAL) -> None:
        self._alias[alias] = contig_id
        self._type[contig_id] = contig_type

    def lookup(self, alias: str) -> str:
        """Map an alias to the canonical contig id (identity if unknown)."""
        return self._alias.get(alias, alias)

    def contig_type(self, contig_id: str) -> ContigType:
        return self._type.get(contig_id, ContigType.AUTOSOMAL)

    def __len__(self):
        return len(self._alias)
