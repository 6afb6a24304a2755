"""VEP (Variant Effect Predictor) INFO sub-field access.

Capability parity with the evidence VEP module
(kgl_evidence/kgl_variant_factory_vcf_evidence_analysis_vep.h): the
VEP/CSQ INFO field packs per-transcript annotations as comma-separated
groups of pipe-separated sub-fields, with the sub-field names declared in
the header Description ("Format: Allele|Consequence|..."). This class
indexes the schema once and yields typed sub-field access per variant.

Copy of kgl_gene_tpu/variant/vep.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..utils.logging import log

__all__ = ["VEPSubFields"]


class VEPSubFields:
    FIELD_CANDIDATES = ("vep", "CSQ", "VEP")

    def __init__(self, info_store, field_id: Optional[str] = None):
        self.info = info_store
        self.field_id = field_id or next(
            (f for f in self.FIELD_CANDIDATES if info_store.has_field(f)), None
        )
        self.sub_fields: List[str] = []
        if self.field_id is not None:
            schema = info_store.schemas.get(self.field_id)
            if schema and "Format:" in schema.description:
                format_text = schema.description.split("Format:")[1].strip().strip('"')
                self.sub_fields = [f.strip() for f in format_text.split("|")]
        if self.field_id is None:
            log().warn("VEP: no vep/CSQ INFO field subscribed")

    def has_vep(self) -> bool:
        return self.field_id is not None and bool(self.sub_fields)

    def sub_field_index(self, name: str) -> Optional[int]:
        try:
            return self.sub_fields.index(name)
        except ValueError:
            return None

    def records(self, info_row: int) -> List[Dict[str, str]]:
        """All VEP transcript records for a variant as sub-field dicts."""
        if not self.has_vep():
            return []
        value = self.info.value(self.field_id, info_row)
        if value is None:
            return []
        groups = value if isinstance(value, list) else [value]
        out = []
        for group in groups:
            if group is None:
                continue
            parts = str(group).split("|")
            out.append({
                name: parts[i] if i < len(parts) else ""
                for i, name in enumerate(self.sub_fields)
            })
        return out

    def sub_field_values(self, info_row: int, name: str) -> List[str]:
        idx = self.sub_field_index(name)
        if idx is None:
            return []
        return [rec.get(name, "") for rec in self.records(info_row)]

    def contains_substring(self, info_row: int, name: str, substring: str) -> bool:
        """VEP substring filter predicate (kgl_variant_filter_info.h:86)."""
        return any(substring in v for v in self.sub_field_values(info_row, name))
