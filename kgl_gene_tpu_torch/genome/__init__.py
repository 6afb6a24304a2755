"""The genome model: features, contigs and the genome reference (copies of
kgl_gene_tpu/genome)."""
