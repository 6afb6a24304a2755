"""The application shell: the XML runtime, resources, the analysis factory,
the package executor and the command line (from kgl_gene_tpu/app)."""
