"""The phylogenetics application: configuration, run loop and outputs.

Capability parity with Strom / PhyloExecEnv
(kpl_phylogenetic/kpl_strom.h:27-70, kpl_strom.cpp:64-90, kpl_main.cpp:12-18):
configuration (data file, tree file, model spec, chain count/heating,
iterations, sample frequency), NEXUS data/tree reading, chain
initialisation, the run loop with chain swapping, and sampled
parameter/tree output files.

Counterpart of kgl_gene_tpu/phylo/strom.py: the same application on the
port's sampler. The likelihood engine runs on the card unless --device cpu
is given (backend "device", the default), or on the host in numpy
(--backend host).

    python -m kgl_gene_tpu_torch.phylo.strom -d data.nex --niter 1000 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..utils.logging import log
from .mcmc import ChainState, MCMCSampler
from .model import SubstitutionModel
from .nexus import read_nexus, write_nexus_trees
from .tree import PhyloTree, parse_newick, random_tree

__all__ = ["StromConfig", "Strom"]


@dataclass
class StromConfig:
    data_file: str = ""
    tree_file: str = ""               # optional starting tree NEXUS/newick
    n_iterations: int = 1000
    sample_freq: int = 10
    print_freq: int = 100
    burn_in: int = 100
    n_chains: int = 1
    heat_factor: float = 0.5
    seed: int = 1
    # model
    n_rate_categories: int = 1
    gamma_shape: float = 1.0
    p_invariant: float = 0.0
    fixed_topology: bool = False
    output_prefix: str = "strom"
    # likelihood engine: "device" = CachedPartialsLikelihood (the
    # Beagle-equivalent device backend; kpl_strom.h:62-66 initialises
    # chains WITH Beagle instances — the product default mirrors that) on
    # `device` (None: the card), "host" = numpy.
    backend: str = "device"
    device: Optional[str] = None

    @classmethod
    def from_args(cls, argv: List[str]) -> "StromConfig":
        parser = argparse.ArgumentParser(prog="kpl", description="Bayesian phylogenetics MCMC")
        parser.add_argument("--datafile", "-d", required=True)
        parser.add_argument("--treefile", "-t", default="")
        parser.add_argument("--niter", type=int, default=1000)
        parser.add_argument("--samplefreq", type=int, default=10)
        parser.add_argument("--burnin", type=int, default=100)
        parser.add_argument("--nchains", type=int, default=1)
        parser.add_argument("--heatfactor", type=float, default=0.5)
        parser.add_argument("--seed", type=int, default=1)
        parser.add_argument("--ncateg", type=int, default=1)
        parser.add_argument("--shape", type=float, default=1.0)
        parser.add_argument("--pinvar", type=float, default=0.0)
        parser.add_argument("--fixedtree", action="store_true")
        parser.add_argument("--output", default="strom")
        parser.add_argument("--backend", default="device", choices=("device", "host"))
        parser.add_argument("--device", default=None,
                            help="torch device of the likelihood engine (default: the card)")
        ns = parser.parse_args(argv)
        return cls(
            data_file=ns.datafile, tree_file=ns.treefile, n_iterations=ns.niter,
            sample_freq=ns.samplefreq, burn_in=ns.burnin, n_chains=ns.nchains,
            heat_factor=ns.heatfactor, seed=ns.seed,
            n_rate_categories=ns.ncateg, gamma_shape=ns.shape,
            p_invariant=ns.pinvar, fixed_topology=ns.fixedtree,
            output_prefix=ns.output, backend=ns.backend, device=ns.device,
        )


class Strom:
    def __init__(self, config: StromConfig):
        self.config = config
        self.sampler: Optional[MCMCSampler] = None

    def execute_app(self) -> None:
        cfg = self.config
        data = read_nexus(cfg.data_file)
        log().info("strom: {} taxa, {} sites", data.n_taxa, data.n_sites)

        # starting tree
        tree: Optional[PhyloTree] = None
        if cfg.tree_file:
            if cfg.tree_file.endswith((".nex", ".nexus", ".tre")):
                tree_data = read_nexus(cfg.tree_file)
                tree = next(iter(tree_data.trees.values()), None)
            else:
                with open(cfg.tree_file) as f:
                    tree = parse_newick(f.read(), leaf_order=data.taxa)
        if tree is None:
            import random as _random

            tree = random_tree(data.taxa, _random.Random(cfg.seed))

        model = SubstitutionModel(
            gamma_shape=cfg.gamma_shape,
            n_rate_categories=cfg.n_rate_categories,
            p_invariant=cfg.p_invariant,
        )
        initial = ChainState(tree, model)
        self.sampler = MCMCSampler(
            data.alignment, initial, n_chains=cfg.n_chains,
            heat_factor=cfg.heat_factor, seed=cfg.seed,
            fixed_topology=cfg.fixed_topology, backend=cfg.backend,
            device=cfg.device,
        )
        engine = self.sampler.cold_chain.backend
        log().info(
            "strom: likelihood engine = {}",
            type(engine).__name__ if engine is not None else "host numpy",
        )
        self.sampler.run(
            cfg.n_iterations, sample_freq=cfg.sample_freq, burn_in=cfg.burn_in
        )
        self.sampler.write_params(cfg.output_prefix + ".p.tsv")
        trees = [
            (f"sample_{s['iteration']}", parse_newick(s["newick"]))
            for s in self.sampler.samples
        ]
        write_nexus_trees(cfg.output_prefix + ".t.nex", trees)
        cold = self.sampler.cold_chain
        log().info(
            "strom complete: {} samples, final logL {:.3f}, acceptance {}",
            len(self.sampler.samples), cold.state.log_like,
            {k: round(v, 2) for k, v in cold.acceptance_rates().items()},
        )


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    config = StromConfig.from_args(sys.argv[1:] if argv is None else argv)
    Strom(config).execute_app()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
