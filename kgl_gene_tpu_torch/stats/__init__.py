"""Population statistics: allele frequencies and FWS on the host (copies of
kgl_gene_tpu/stats), inbreeding in PyTorch on the device."""
