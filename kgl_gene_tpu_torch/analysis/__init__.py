"""Analyses over mutated transcripts (from kgl_gene_tpu/analysis)."""
