"""Publications and the PubMed client (from kgl_gene_tpu/literature)."""
