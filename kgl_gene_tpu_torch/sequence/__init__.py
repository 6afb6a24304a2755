"""Alphabets, sequences and translation tables (copies of
kgl_gene_tpu/sequence)."""
