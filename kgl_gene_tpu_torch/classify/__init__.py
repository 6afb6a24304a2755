"""Distance metrics and trees (copies of kgl_gene_tpu/classify)."""
