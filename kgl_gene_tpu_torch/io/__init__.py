"""File loaders: FASTA, GFF3, VCF and the synthetic population generator
(from kgl_gene_tpu/io)."""
