"""Bayesian phylogenetics (the kpl application): trees, substitution models,
NEXUS IO, the pruning likelihood on the device and the MCMC sampler.

Counterpart of kgl_gene_tpu/phylo/.
"""
