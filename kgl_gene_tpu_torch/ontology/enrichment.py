"""GO term enrichment via the hypergeometric upper tail.

Capability parity with EnrichmentTools
(kol_ontology/kol_EnrichmentTools.h:23,58, .cpp:52-74): a term's gene set
is the union of genes annotated to the term or any descendant; the
enrichment p-value of a gene sample is P(X >= k) under the
hypergeometric(K = population genes with term, n = sample size,
N = all annotated genes) distribution.

Copy of kgl_gene_tpu/ontology/enrichment.py.
"""

from __future__ import annotations

from typing import Set

from ..utils.distributions import HypergeometricDistribution
from .annotation import TermAnnotation
from .graph import GoGraph

__all__ = ["descendant_genes", "enrichment_significance"]


def descendant_genes(graph: GoGraph, annotation: TermAnnotation, term: str) -> Set[str]:
    """Genes annotated to the term or any of its descendants."""
    genes: Set[str] = set()
    for descendant in graph.get_self_descendant_terms(term):
        genes |= annotation.genes_for_term(descendant)
    return genes


def enrichment_significance(
    graph: GoGraph, annotation: TermAnnotation, genes: Set[str], term: str
) -> float:
    term_genes = descendant_genes(graph, annotation, term)
    shared = genes & term_genes
    if not shared:
        return 1.0
    hyper = HypergeometricDistribution(
        K=len(term_genes), n=len(genes), N=len(annotation.all_genes())
    )
    return hyper.upper_tail(len(shared))
