"""Genome feature types (copies of kgl_gene_tpu/genome, cut to what the
port reads)."""
