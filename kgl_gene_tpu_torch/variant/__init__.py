"""The variant model and population database (copies of kgl_gene_tpu/variant)."""
