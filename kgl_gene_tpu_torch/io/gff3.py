"""GFF3 parser building the genome feature hierarchy.

Capability parity with GffRecord/ParseGff3
(kgl_genomics/kgl_genome_io/kgl_io_gff3.h:29,90) and the combined
ParseGffFasta facade (kgl_io_gff_fasta.h:25): tab-split records, 1-based
closed coordinates converted to 0-based right-open, attribute parsing
(ID/Parent wiring), and super/sub-feature linkage.

Copy of kgl_gene_tpu/io/gff3.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional
from urllib.parse import unquote

from ..genome.features import Feature
from ..sequence.sequence import StrandSense
from ..utils.intervals import OpenRightInterval
from ..utils.logging import log
from .streams import open_text_stream

__all__ = ["GffRecord", "parse_gff3", "parse_gff3_into"]


@dataclass
class GffRecord:
    """One parsed GFF3 line (kgl_io_gff3.h:29)."""

    contig_id: str
    source: str
    feature_type: str
    begin: int  # 0-based inclusive
    end: int    # 0-based exclusive
    score: Optional[float]
    strand: StrandSense
    phase: Optional[int]
    attributes: Dict[str, List[str]]

    def record_id(self) -> Optional[str]:
        ids = self.attributes.get("ID")
        return ids[0] if ids else None

    def parents(self) -> List[str]:
        return self.attributes.get("Parent", [])


def _parse_attributes(text: str) -> Dict[str, List[str]]:
    attrs: Dict[str, List[str]] = {}
    for item in text.split(";"):
        item = item.strip()
        if not item or "=" not in item:
            continue
        key, value = item.split("=", 1)
        attrs[key.strip()] = [unquote(v) for v in value.split(",")]
    return attrs


def parse_gff3(path: str) -> List[GffRecord]:
    records: List[GffRecord] = []
    with open_text_stream(path) as stream:
        for line_no, line in enumerate(stream, 1):
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                if line.startswith("##FASTA"):
                    break  # embedded FASTA section ends the feature table
                continue
            fields = line.split("\t")
            if len(fields) != 9:
                log().warn("GFF3 {}:{} expected 9 tab fields, found {}", path, line_no, len(fields))
                continue
            (contig, source, ftype, start, end, score, strand, phase, attr_text) = fields
            try:
                begin0 = int(start) - 1  # GFF3 is 1-based closed
                end0 = int(end)
            except ValueError:
                log().warn("GFF3 {}:{} non-integer coordinates", path, line_no)
                continue
            records.append(
                GffRecord(
                    contig_id=contig,
                    source=source,
                    feature_type=ftype.lower(),
                    begin=begin0,
                    end=end0,
                    score=None if score in (".", "") else float(score),
                    strand=StrandSense.REVERSE if strand == "-" else StrandSense.FORWARD,
                    phase=None if phase in (".", "") else int(phase),
                    attributes=_parse_attributes(attr_text),
                )
            )
    return records


def parse_gff3_into(path: str, genome) -> int:
    """Parse a GFF3 file and wire features into the genome's contigs.

    Multi-line features (CDS segments sharing an ID) become separate Feature
    objects with unique synthetic ids but are linked to the same parent, so
    transcript assembly groups them correctly.
    """
    records = parse_gff3(path)
    # First pass: create features.
    features: Dict[str, Feature] = {}  # primary id -> first feature
    all_features: List[tuple] = []  # (feature, parent_ids)
    id_counts: Dict[str, int] = {}
    for rec in records:
        contig = genome.get_contig(rec.contig_id)
        if contig is None:
            continue
        fid = rec.record_id()
        if fid is None:
            fid = f"{rec.feature_type}:{rec.contig_id}:{rec.begin}-{rec.end}"
        count = id_counts.get(fid, 0)
        id_counts[fid] = count + 1
        unique_id = fid if count == 0 else f"{fid}#{count}"
        feature = Feature(
            feature_id=unique_id,
            feature_type=rec.feature_type,
            contig_id=rec.contig_id,
            interval=OpenRightInterval(rec.begin, rec.end),
            strand=rec.strand,
            phase=rec.phase,
            attributes=rec.attributes,
        )
        if count == 0:
            features[fid] = feature
        all_features.append((feature, rec.parents()))
        contig.add_feature(feature)
    # Second pass: wire hierarchy (Parent attribute).
    unresolved = 0
    for feature, parent_ids in all_features:
        for pid in parent_ids:
            parent = features.get(pid)
            if parent is None:
                unresolved += 1
                continue
            feature.super_feature = parent
            parent.sub_features.append(feature)
    if unresolved:
        log().warn("GFF3 {}: {} unresolved Parent references", path, unresolved)
    return len(all_features)
