"""GO ontology: OBO / OBO-XML / OboGraphs parsers, the CSR DAG with bitset
closures, GAF annotation, information content, term and set similarity,
the similarity cache and the ontology database (from
kgl_gene_tpu/ontology)."""
