"""Per-genome mutation and capture into device tensors (copies of
kgl_gene_tpu/mutation)."""
