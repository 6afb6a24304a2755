"""Host thread pools (copy of kgl_gene_tpu/parallel/host_pipeline.py)."""
