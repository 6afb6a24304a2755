"""Host utilities (copies of kgl_gene_tpu/utils)."""
