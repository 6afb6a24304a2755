"""Gene <-> GO term annotation from GAF records.

Capability parity with TermAnnotation / ParserAnnotationGaf
(kol_ontology/kol_TermAnnotation.h:38): gene->terms and term->genes maps
split by namespace (BP/MF/CC), with an evidence-code policy filter
(PolicyEvidence) and NOT-qualifier exclusion.

Copy of kgl_gene_tpu/ontology/annotation.py.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set

import numpy as np

from ..io.gaf import GafRecord, read_gaf_records
from .graph import GoGraph
from .obo import NAMESPACES

__all__ = ["TermAnnotation", "ASPECT_TO_NAMESPACE"]

ASPECT_TO_NAMESPACE = {
    "P": "biological_process",
    "F": "molecular_function",
    "C": "cellular_component",
}

# The reference's default evidence policy accepts all codes; a curated
# policy would restrict to e.g. experimental codes.
ALL_EVIDENCE: Optional[Set[str]] = None


class TermAnnotation:
    def __init__(self, records: Iterable[GafRecord],
                 evidence_policy: Optional[Set[str]] = ALL_EVIDENCE,
                 graph: Optional[GoGraph] = None):
        self.gene_terms: Dict[str, Set[str]] = {}
        self.term_genes: Dict[str, Set[str]] = {}
        self.term_namespace: Dict[str, str] = {}
        for rec in records:
            if "NOT" in rec.qualifier.split("|"):
                continue
            if evidence_policy is not None and rec.evidence_code not in evidence_policy:
                continue
            term = rec.go_term
            if graph is not None:
                idx = graph.term_index(term)
                if idx is None:
                    continue
                term = graph.term_ids[idx]  # canonicalise alt ids
            self.gene_terms.setdefault(rec.gene_id, set()).add(term)
            self.term_genes.setdefault(term, set()).add(rec.gene_id)
            ns = ASPECT_TO_NAMESPACE.get(rec.aspect)
            if ns:
                self.term_namespace[term] = ns

    @classmethod
    def from_gaf_file(cls, path: str, **kwargs) -> "TermAnnotation":
        return cls(read_gaf_records(path), **kwargs)

    # ------------------------------------------------------------------ #
    def num_annotations_for_term(self, term_id: str) -> int:
        """Annotation count (genes) for a term
        (getNumAnnotationsForGoTerm)."""
        return len(self.term_genes.get(term_id, ()))

    def go_terms_for_gene(self, gene_id: str) -> Set[str]:
        return self.gene_terms.get(gene_id, set())

    def go_terms_for_gene_by_namespace(self, gene_id: str, namespace: str) -> Set[str]:
        return {
            t for t in self.gene_terms.get(gene_id, set())
            if self.term_namespace.get(t) == namespace
        }

    def genes_for_term(self, term_id: str) -> Set[str]:
        return self.term_genes.get(term_id, set())

    def all_genes(self) -> List[str]:
        return sorted(self.gene_terms)

    def all_terms(self, namespace: Optional[str] = None) -> List[str]:
        if namespace is None:
            return sorted(self.term_genes)
        return sorted(
            t for t in self.term_genes if self.term_namespace.get(t) == namespace
        )

    def annotation_count_vector(self, graph: GoGraph) -> np.ndarray:
        """Per-term direct annotation counts aligned with graph indices."""
        counts = np.zeros(len(graph), dtype=np.float64)
        for term, genes in self.term_genes.items():
            idx = graph.term_index(term)
            if idx is not None:
                counts[idx] += len(genes)
        return counts
