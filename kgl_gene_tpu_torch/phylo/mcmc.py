"""Bayesian MCMC over trees and model parameters with heated chains.

Capability parity with the kpl MCMC machinery
(kpl_phylogenetic/kpl_mcmc_chain.h:30-83 Chain with heated-chain parallel
tempering + swap at kpl_strom.h:61-68, and the Metropolis/updater family
kpl_mcmc_*.h): updaters for branch lengths (scaler), tree length (whole-
tree scaler), gamma shape, proportion invariant, state frequencies
(Dirichlet), GTR exchangeabilities (Dirichlet), and the Larget-Simon local
topology move; power-posterior chain heating with periodic swaps.

Counterpart of kgl_gene_tpu/phylo/mcmc.py: the chain logic is a copy, on
the port's device likelihood (likelihood.CachedPartialsLikelihood, PyTorch
on the card unless device="cpu") or the host numpy likelihood
(backend="host"). Where the reference has known faults the port follows
the intended semantics:
  - MCMCSampler.run: when a chain cannot dispatch the fused iteration, the
    chains already dispatched are collected and only the others take
    next_step(), so every chain advances one iteration (the reference runs
    next_step() on the collected chains too, advancing them two).
  - Chain._prepare_full_iteration draws each polytomy branch's accept
    uniform only when that branch has a proposal, as the sequential path
    does (the reference draws both always).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import resolve_device
from .likelihood import CachedPartialsLikelihood, _upload, leaf_partials, log_likelihood
from .model import SubstitutionModel
from .tree import PhyloNode, PhyloTree, parse_newick

__all__ = ["ChainState", "Chain", "MCMCSampler", "UPDATER_NAMES", "state_from_numpy"]

UPDATER_NAMES = (
    "branch_length", "tree_length", "gamma_shape", "p_invariant",
    "state_freq", "exchangeability", "larget_simon", "polytomy",
    "omega", "kappa",
)

# Branch-length prior rate shared by the scalers and the reversible-jump
# polytomy move (Exp(rate) as in the kpl branch prior).
_EDGE_PRIOR_RATE = 10.0


@dataclass
class ChainState:
    tree: PhyloTree
    model: SubstitutionModel
    log_like: float = -np.inf

    def copy(self) -> "ChainState":
        if hasattr(self.model, "exchangeabilities"):
            model = SubstitutionModel(
                self.model.exchangeabilities.copy(), self.model.frequencies.copy(),
                self.model.gamma_shape, self.model.n_rate_categories,
                self.model.p_invariant,
            )
        else:  # codon model
            import copy as _copy

            model = _copy.deepcopy(self.model)
        return ChainState(self.tree.copy(), model, self.log_like)


def state_from_numpy(newick: str, exchangeabilities, frequencies,
                     gamma_shape: float = 1.0, n_rate_categories: int = 1,
                     p_invariant: float = 0.0, leaf_order=None) -> ChainState:
    """A ChainState from another implementation's sampler state as a
    Newick string and numpy arrays (for example the JAX package's
    ChainState: tree.newick(), model.exchangeabilities, model.frequencies,
    ...); leaf_order pins the leaf numbering (tree.leaf_names)."""
    ex = np.array(exchangeabilities, dtype=np.float64)
    fr = np.array(frequencies, dtype=np.float64)
    if ex.shape != (6,) or fr.shape != (4,):
        raise ValueError(f"expected (6,) exchangeabilities and (4,) frequencies, "
                         f"got {ex.shape} and {fr.shape}")
    model = SubstitutionModel(ex, fr, float(gamma_shape), int(n_rate_categories),
                              float(p_invariant))
    return ChainState(parse_newick(newick, leaf_order=leaf_order), model)


class Chain:
    """One (possibly heated) MCMC chain."""

    def __init__(self, alignment: np.ndarray, state: ChainState,
                 heating_power: float = 1.0, rng: Optional[random.Random] = None,
                 updaters: Tuple[str, ...] = UPDATER_NAMES,
                 fixed_topology: bool = False,
                 likelihood_fn=None, backend=None, pooled_sweep: bool = True):
        self.alignment = alignment
        self.state = state
        self.heating_power = heating_power
        self.rng = rng or random.Random(0)
        # Custom likelihood (e.g. the codon model's 61-state pruning,
        # phylo/codon.py); defaults to the nucleotide likelihood.
        self.likelihood_fn = likelihood_fn or log_likelihood
        # Optional incremental device backend (CachedPartialsLikelihood):
        # branch-length proposals recompute only the changed node -> root
        # path from cached partials (the BeagleLib mechanism).
        self.backend = backend
        self.pooled_sweep = pooled_sweep
        self._hint: Optional[int] = None
        self.updaters = tuple(
            u for u in updaters
            if not (fixed_topology and u in ("larget_simon", "polytomy"))
        )
        self.polytomy_prior_c = 1.0
        self.accept_counts: Dict[str, int] = {u: 0 for u in self.updaters}
        self.try_counts: Dict[str, int] = {u: 0 for u in self.updaters}
        if backend is not None:
            self.state.log_like = backend.loglike(state.tree, state.model)
            backend.on_accept()
        else:
            self.state.log_like = self.likelihood_fn(state.tree, alignment, state.model)

    # --- proposal helpers -------------------------------------------------
    def _metropolis(self, name: str, proposal_state: ChainState,
                    log_hastings: float = 0.0, log_prior_ratio: float = 0.0) -> bool:
        """Accept/reject at the chain's heating power."""
        self.try_counts[name] += 1
        if self.backend is not None:
            proposal_state.log_like = self.backend.loglike(
                proposal_state.tree, proposal_state.model,
                changed_node_index=self._hint,
            )
        else:
            proposal_state.log_like = self.likelihood_fn(
                proposal_state.tree, self.alignment, proposal_state.model
            )
        self._hint = None
        log_ratio = (
            self.heating_power * (proposal_state.log_like - self.state.log_like)
            + log_prior_ratio + log_hastings
        )
        if math.log(self.rng.random() + 1e-300) < log_ratio:
            self.state = proposal_state
            self.accept_counts[name] += 1
            if self.backend is not None:
                self.backend.on_accept()
            return True
        if self.backend is not None:
            self.backend.on_reject()
        return False

    # --- updaters ---------------------------------------------------------
    def _update_branch_length(self) -> None:
        proposal = self.state.copy()
        edges = proposal.tree.edges()
        node = self.rng.choice(edges)
        lam = 0.5
        factor = math.exp(lam * (self.rng.random() - 0.5))
        node.edge_length = max(node.edge_length * factor, 1e-8)
        self._hint = node.index  # single-edge move: path update suffices
        # exponential(10) branch-length prior.
        prior = -10.0 * (proposal.tree.tree_length() - self.state.tree.tree_length())
        self._metropolis("branch_length", proposal, math.log(factor), prior)

    def _update_tree_length(self) -> None:
        proposal = self.state.copy()
        edges = proposal.tree.edges()
        lam = 0.3
        factor = math.exp(lam * (self.rng.random() - 0.5))
        for node in edges:
            node.edge_length = max(node.edge_length * factor, 1e-8)
        hastings = len(edges) * math.log(factor)
        prior = -10.0 * (proposal.tree.tree_length() - self.state.tree.tree_length())
        self._metropolis("tree_length", proposal, hastings, prior)

    def _update_gamma_shape(self) -> None:
        if getattr(self.state.model, "n_rate_categories", 1) <= 1:
            return
        proposal = self.state.copy()
        factor = math.exp(0.5 * (self.rng.random() - 0.5))
        proposal.model.gamma_shape = min(max(
            self.state.model.gamma_shape * factor, 0.05), 50.0)
        self._metropolis("gamma_shape", proposal, math.log(factor))

    def _update_p_invariant(self) -> None:
        if getattr(self.state.model, "p_invariant", 0.0) <= 0.0:
            return
        proposal = self.state.copy()
        delta = (self.rng.random() - 0.5) * 0.1
        proposal.model.p_invariant = min(max(
            self.state.model.p_invariant + delta, 0.0), 0.95)
        self._metropolis("p_invariant", proposal)

    def _dirichlet_proposal(self, values: np.ndarray, concentration: float = 500.0):
        alpha = np.maximum(values * concentration, 1e-3)
        new = np.random.dirichlet(alpha)
        # Hastings: q(old|new) / q(new|old) under Dirichlet kernels.
        from scipy.stats import dirichlet as _dir

        alpha_new = np.maximum(new * concentration, 1e-3)
        log_forward = _dir.logpdf(new / new.sum(), alpha)
        log_back = _dir.logpdf(values / values.sum(), alpha_new)
        return new, log_back - log_forward

    def _update_state_freq(self) -> None:
        proposal = self.state.copy()
        new, hastings = self._dirichlet_proposal(self.state.model.frequencies)
        proposal.model.frequencies = new
        self._metropolis("state_freq", proposal, hastings)

    def _update_exchangeability(self) -> None:
        if not hasattr(self.state.model, "exchangeabilities"):
            return
        proposal = self.state.copy()
        ex = self.state.model.exchangeabilities
        norm = ex / ex.sum()
        new, hastings = self._dirichlet_proposal(norm)
        proposal.model.exchangeabilities = new * ex.sum()
        self._metropolis("exchangeability", proposal, hastings)

    def _update_omega(self) -> None:
        """dN/dS scaler (kpl_mcmc_omega.h) — codon models only."""
        if not hasattr(self.state.model, "omega"):
            return
        proposal = self.state.copy()
        factor = math.exp(0.4 * (self.rng.random() - 0.5))
        proposal.model.omega = min(max(self.state.model.omega * factor, 1e-4), 20.0)
        self._metropolis("omega", proposal, math.log(factor))

    def _update_kappa(self) -> None:
        """Transition/transversion ratio scaler — codon/HKY models."""
        if not hasattr(self.state.model, "kappa"):
            return
        proposal = self.state.copy()
        factor = math.exp(0.4 * (self.rng.random() - 0.5))
        proposal.model.kappa = min(max(self.state.model.kappa * factor, 1e-3), 100.0)
        self._metropolis("kappa", proposal, math.log(factor))

    @staticmethod
    def _annotate_orig(tree) -> None:
        """Tag every node with its pre-edit index: state.copy() preserves
        indices (same topology, pinned leaf order), so _orig links a
        proposal tree's nodes back to base-tree edge slots even after
        structural edits + renumber() (the fused-iteration slot maps)."""
        for node in tree.nodes_postorder():
            node._orig = node.index

    def _propose_larget_simon(self, base_state: "ChainState", rng,
                              annotate: bool = False):
        """Draw one Larget-Simon LOCAL proposal from base_state using rng;
        returns (proposal_state, log_hastings, chosen_node) or None when
        no internal edge exists. Shared by the sequential host path and
        the pooled device topology paths."""
        proposal = base_state.copy()
        if annotate:
            self._annotate_orig(proposal.tree)
        internals = [
            n for n in proposal.tree.internal_nodes()
            if n.parent is not None and len(n.children) >= 2
        ]
        if not internals:
            return None
        node = rng.choice(internals)
        parent = node.parent
        lam = 0.2
        factor = math.exp(lam * (rng.random() - 0.5))
        node.edge_length = max(node.edge_length * factor, 1e-8)
        # Topology change: swap one child of `node` with a sibling of `node`.
        siblings = [c for c in parent.children if c is not node]
        if siblings and rng.random() < 0.5:
            sibling = rng.choice(siblings)
            child = rng.choice(node.children)
            # detach/attach
            node.children.remove(child)
            parent.children.remove(sibling)
            node.children.append(sibling)
            parent.children.append(child)
            sibling.parent = node
            child.parent = parent
            proposal.tree.renumber()
        return proposal, math.log(factor), node

    def _update_larget_simon(self) -> None:
        """Larget-Simon LOCAL move (kpl_mcmc_treeupdater.h): pick an
        internal edge, shrink/grow the 3-edge path and possibly swap a
        subtree across it."""
        prop = self._propose_larget_simon(self.state, self.rng)
        if prop is None:
            return
        proposal, hastings, _node = prop
        self._metropolis("larget_simon", proposal, hastings)

    # --- polytomy reversible jump (kpl_mcmc_polytomy.h) ---------------------
    @staticmethod
    def _polytomy_candidates(tree: PhyloTree):
        """(polytomies, deletable internal edges): a polytomy is an internal
        node with >= 3 children (add-edge targets); a deletable edge is any
        internal non-root node (collapsing it merges its children into the
        parent)."""
        nodes = tree.nodes_postorder()
        polys = [n for n in nodes if len(n.children) >= 3]
        dels = [n for n in nodes if n.parent is not None and not n.is_leaf()]
        return polys, dels

    @staticmethod
    def _n_subsets(k: int) -> int:
        """Ways to move a subset of 2..k-1 of a polytomy's k children under
        a new internal edge."""
        return (1 << k) - k - 2

    def _propose_polytomy(self, base_state: "ChainState", rng,
                          annotate: bool = False):
        """Draw one reversible-jump polytomy proposal from base_state with
        rng; returns (proposal_state, log_hastings, log_prior, new_node)
        or None when no candidate exists (new_node is the added internal
        for ADD moves, None for DELETE). NOTE: the drawn/deleted branch
        length's proposal-density term cancels exactly against its prior
        density in log_hastings + log_prior, so the SUM is
        branch-length-independent — the fused device iteration relies on
        this (the deleted edge's post-sweep length never reaches the
        host). Shared by the sequential host path and the pooled device
        topology paths."""
        rate = _EDGE_PRIOR_RATE
        log_c = math.log(getattr(self, "polytomy_prior_c", 1.0))
        proposal = base_state.copy()
        if annotate:
            self._annotate_orig(proposal.tree)
        polys, dels = self._polytomy_candidates(proposal.tree)
        if not polys and not dels:
            return None
        p_add = 0.5 if (polys and dels) else (1.0 if polys else 0.0)
        do_add = rng.random() < p_add

        if do_add:
            u = rng.choice(polys)
            k = len(u.children)
            # uniform subset with 2 <= |S| <= k-1 by rejection (k is small)
            while True:
                mask = rng.randrange(1 << k)
                size = bin(mask).count("1")
                if 2 <= size <= k - 1:
                    break
            subset = [c for i, c in enumerate(u.children) if mask & (1 << i)]
            v_len = rng.expovariate(rate)
            v = PhyloNode(index=-1, edge_length=v_len, parent=u)
            for child in subset:
                u.children.remove(child)
                child.parent = v
                v.children.append(child)
            u.children.append(v)
            proposal.tree.renumber()
            polys_new, dels_new = self._polytomy_candidates(proposal.tree)
            p_del_rev = 0.5 if (polys_new and dels_new) else 1.0
            log_g = math.log(rate) - rate * v_len  # proposal density of v_len
            log_forward = (
                math.log(p_add) - math.log(len(polys))
                - math.log(self._n_subsets(k)) + log_g
            )
            log_reverse = math.log(p_del_rev) - math.log(len(dels_new))
            # prior: new branch density x topology C ratio (one more internal)
            log_prior = (math.log(rate) - rate * v_len) + log_c
            return proposal, log_reverse - log_forward, log_prior, v
        else:
            c = rng.choice(dels)
            u = c.parent
            v_len = c.edge_length
            u.children.remove(c)
            for child in c.children:
                child.parent = u
                u.children.append(child)
            proposal.tree.renumber()
            polys_new, dels_new = self._polytomy_candidates(proposal.tree)
            k_rev = len(u.children)  # reverse add splits this polytomy
            p_add_rev = 0.5 if (polys_new and dels_new) else 1.0
            log_g = math.log(rate) - rate * v_len
            log_forward = math.log(1.0 - p_add) - math.log(len(dels))
            log_reverse = (
                math.log(p_add_rev) - math.log(len(polys_new))
                - math.log(self._n_subsets(k_rev)) + log_g
            )
            log_prior = -(math.log(rate) - rate * v_len) - log_c
            return proposal, log_reverse - log_forward, log_prior, None

    def _update_polytomy(self) -> None:
        """Lewis-Holder-Holsinger reversible-jump dimension move
        (kpl_mcmc_polytomy.h): ADD an internal edge by splitting a polytomy
        (new branch length drawn from the edge prior) or DELETE an internal
        edge, collapsing its child into a polytomy. The Hastings ratio
        accounts for the add/delete choice probabilities, the uniform
        polytomy/edge/subset choices and the new-edge proposal density; the
        prior ratio covers the new branch's density and the topology prior
        C^(n_internal) (polytomy_prior_c, default 1 = flat)."""
        prop = self._propose_polytomy(self.state, self.rng)
        if prop is None:
            return
        proposal, hastings, prior, _new = prop
        self._metropolis("polytomy", proposal, hastings, prior)

    @staticmethod
    def _edge_slot_map(tree):
        return {e.index: i for i, e in enumerate(tree.edges())}

    @staticmethod
    def _perm_of(proposal_tree, parent_slots):
        """(perm, new_slot): proposal edge slot -> parent-branch edge slot
        via the _orig tags; new_slot = slot of a freshly added edge (-1
        if none)."""
        edges = proposal_tree.edges()
        perm = np.zeros(len(edges), np.int32)
        new_slot = -1
        for t, e in enumerate(edges):
            orig = getattr(e, "_orig", None)
            if orig is None:
                new_slot = t
            else:
                perm[t] = parent_slots[orig]
        return perm, new_slot

    def _device_full_iteration(self) -> bool:
        """The whole iteration in ONE device program (backend
        full_iteration): four parameter moves + Larget-Simon + speculative
        polytomy pair, one fetch. Host draws every topology choice first
        (they are branch-length independent), maps proposal edge slots to
        the base slots via _orig tags, and replays the returned decisions
        onto its tree/model objects. Returns False to fall back."""
        prep = self._prepare_full_iteration()
        if prep is None:
            return False
        self._apply_token(self._dispatch_prepared(prep))
        return True

    def dispatch_full_iteration(self):
        """Pipelined form of _device_full_iteration: draw proposals and
        ENQUEUE the fused program without fetching; returns a token for
        collect_full_iteration, or None when the fused path is
        unavailable (caller falls back to next_step). Used by
        MCMCSampler.run to overlap C heated chains' round trips."""
        if not (
            self.pooled_sweep
            and self.backend is not None
            and hasattr(self.backend, "full_iteration")
            and hasattr(self.state.model, "exchangeabilities")
            and all(n in self.updaters for n in self._SWEEP_NAMES)
            and "larget_simon" in self.updaters
            and "polytomy" in self.updaters
        ):
            return None
        prep = self._prepare_full_iteration()
        if prep is None:
            return None
        return self._dispatch_prepared(prep)

    def _dispatch_prepared(self, prep):
        (proposal1, perm1, ls_slot, h1, u1, pa, permA, newA, vlenA, hpA,
         u2a, pb, permB, newB, vlenB, hpB, u2b, rng_a, rng_b) = prep
        fetch, sizes = self.backend.full_iteration(
            self.state.tree, self.state.model, self.heating_power,
            proposal1.tree, perm1, ls_slot, h1, u1,
            pa[0].tree if pa else None, permA, newA, vlenA, hpA, u2a,
            pb[0].tree if pb else None, permB, newB, vlenB, hpB, u2b,
            defer_fetch=True,
        )
        return (fetch, sizes, proposal1, pa, pb, rng_a, rng_b)

    def _apply_token(self, token) -> None:
        fetch, sizes, proposal1, pa, pb, rng_a, rng_b = token
        res = self.backend._unpack_iteration(fetch.wait(), sizes)
        self._apply_full_iteration(res, proposal1, pa, pb, rng_a, rng_b)

    def collect_full_iteration(self, token) -> None:
        self._apply_token(token)
        # remaining (inactive-by-default) updaters still get their turn
        for u in self.updaters:
            if u not in self._SWEEP_NAMES + ("larget_simon", "polytomy"):
                self._dispatch_table()[u]()

    def _dispatch_table(self):
        return {name: getattr(self, "_update_" + name)
                for name in UPDATER_NAMES}

    def _apply_full_iteration(self, res, proposal1, pa, pb, rng_a, rng_b):
        a1, a2, a3, a4, acc5, acc6 = (bool(x) for x in res["accepts"])
        for name, acc in zip(self._SWEEP_NAMES, (a1, a2, a3, a4)):
            self.try_counts[name] += 1
            self.accept_counts[name] += int(acc)
        self.try_counts["larget_simon"] += 1
        self.accept_counts["larget_simon"] += int(acc5)
        realized_poly = pa if acc5 else pb
        if realized_poly is not None:
            self.try_counts["polytomy"] += 1
            self.accept_counts["polytomy"] += int(acc6)

        # replay decisions onto host objects
        model = self.state.model
        model.frequencies = np.asarray(res["frequencies"], np.float64)
        ex_sum = float(np.sum(model.exchangeabilities))
        model.exchangeabilities = (
            np.asarray(res["exchangeabilities"], np.float64) * ex_sum
        )
        if acc6 and realized_poly is not None:
            final_state, bl_key = realized_poly[0], (
                "bl_a" if acc5 else "bl_b"
            )
        elif acc5:
            final_state, bl_key = proposal1, "bl_ls"
        else:
            final_state, bl_key = self.state, "bl_sweep"
        bl = res[bl_key]
        for i, e in enumerate(final_state.tree.edges()):
            e.edge_length = float(bl[i])
        final_state.model = model
        final_state.log_like = res["log_like"]
        self.state = final_state
        self.rng.setstate((rng_a if acc5 else rng_b).getstate())

    def _prepare_full_iteration(self):
        """Draw and slot-map the iteration's topology proposals (the
        host half of _device_full_iteration, shared with the pipelined
        dispatch path)."""
        prop1 = self._propose_larget_simon(self.state, self.rng,
                                           annotate=True)
        if prop1 is None:
            return None
        proposal1, h1, node1 = prop1
        u1 = self.rng.random()
        snapshot = self.rng.getstate()
        rng_a = random.Random()
        rng_a.setstate(snapshot)
        rng_b = random.Random()
        rng_b.setstate(snapshot)
        pa = self._propose_polytomy(proposal1, rng_a, annotate=True)
        pb = self._propose_polytomy(self.state, rng_b, annotate=True)
        # each branch's accept uniform only where it has a proposal, as the
        # sequential path draws it
        u2a = rng_a.random() if pa is not None else 0.0
        u2b = rng_b.random() if pb is not None else 0.0
        base_slots = self._edge_slot_map(self.state.tree)
        edges1 = proposal1.tree.edges()
        perm1 = np.zeros(len(edges1), np.int32)
        ls_slot = 0
        for t, e in enumerate(edges1):
            perm1[t] = base_slots[e._orig]
            if e is node1:
                ls_slot = t
        slots1 = self._edge_slot_map(proposal1.tree)
        if pa is not None:
            permA, newA = self._perm_of(pa[0].tree, slots1)
            vlenA = pa[0].tree.edges()[newA].edge_length if newA >= 0 else 0.0
            hpA = pa[1] + pa[2]
        else:
            permA, newA, vlenA, hpA = np.zeros(1, np.int32), -1, 0.0, 0.0
        if pb is not None:
            permB, newB = self._perm_of(pb[0].tree, base_slots)
            vlenB = pb[0].tree.edges()[newB].edge_length if newB >= 0 else 0.0
            hpB = pb[1] + pb[2]
        else:
            permB, newB, vlenB, hpB = np.zeros(1, np.int32), -1, 0.0, 0.0
        return (proposal1, perm1, ls_slot, h1, u1, pa, permA, newA, vlenA,
                hpA, u2a, pb, permB, newB, vlenB, hpB, u2b, rng_a, rng_b)

    # --- step -------------------------------------------------------------
    _SWEEP_NAMES = ("branch_length", "tree_length", "state_freq",
                    "exchangeability")

    def _device_param_sweep(self) -> None:
        """Pooled device execution of the four continuous-parameter moves
        (CachedPartialsLikelihood.param_sweep): one program + one packed
        fetch instead of four round trips. The updater kernels and priors
        are identical to the host forms above; the draws come from the
        backend's own generator."""
        res = self.backend.param_sweep(
            self.state.tree, self.state.model, self.heating_power
        )
        edges = self.state.tree.edges()
        for i, node in enumerate(edges):
            node.edge_length = float(res["edge_lengths"][i])
        model = self.state.model
        model.frequencies = np.asarray(res["frequencies"], np.float64)
        ex_sum = float(np.sum(model.exchangeabilities))
        model.exchangeabilities = (
            np.asarray(res["exchangeabilities"], np.float64) * ex_sum
        )
        self.state.log_like = res["log_like"]
        for name, acc in zip(self._SWEEP_NAMES, res["accepts"]):
            self.try_counts[name] += 1
            self.accept_counts[name] += int(bool(acc))

    def next_step(self) -> None:
        """One MCMC iteration: each updater fires once (Chain::nextStep)."""
        dispatch = {
            "branch_length": self._update_branch_length,
            "tree_length": self._update_tree_length,
            "gamma_shape": self._update_gamma_shape,
            "p_invariant": self._update_p_invariant,
            "state_freq": self._update_state_freq,
            "exchangeability": self._update_exchangeability,
            "larget_simon": self._update_larget_simon,
            "polytomy": self._update_polytomy,
            "omega": self._update_omega,
            "kappa": self._update_kappa,
        }
        updaters = self.updaters
        if (
            self.pooled_sweep
            and self.backend is not None
            and hasattr(self.backend, "param_sweep")
            and hasattr(self.state.model, "exchangeabilities")
            and all(n in updaters for n in self._SWEEP_NAMES)
        ):
            topo_pooled = (
                "larget_simon" in updaters and "polytomy" in updaters
            )
            done = False
            if topo_pooled and hasattr(self.backend, "full_iteration"):
                done = self._device_full_iteration()
            if done:
                updaters = tuple(
                    u for u in updaters
                    if u not in self._SWEEP_NAMES + (
                        "larget_simon", "polytomy",
                    )
                )
            else:
                # (no internal edge for Larget-Simon: the topology moves
                # run sequentially after the pooled sweep)
                self._device_param_sweep()
                updaters = tuple(
                    u for u in updaters if u not in self._SWEEP_NAMES
                )
        for updater in updaters:
            dispatch[updater]()

    def acceptance_rates(self) -> Dict[str, float]:
        return {
            u: self.accept_counts[u] / max(self.try_counts[u], 1)
            for u in self.updaters
        }


class MCMCSampler:
    """Heated-chain sampler with periodic swaps (Strom::swapChains).

    backend: "device" (the default: CachedPartialsLikelihood, the
    Beagle-equivalent cached-partials engine, kpl_likelihood.h:43-105, on
    the card unless device="cpu"; with no card and no such request it
    raises) or "host" (the numpy likelihood). Heated chains share ONE device
    copy of the tip partials (the reference gives every chain a Beagle
    instance over the same data, kpl_strom.h:62-66); chain c's pooled draws
    come from a host generator seeded with seed + c."""

    def __init__(self, alignment: np.ndarray, initial: ChainState,
                 n_chains: int = 1, heat_factor: float = 0.5,
                 seed: int = 0, fixed_topology: bool = False,
                 likelihood_fn=None, backend: Optional[str] = "device",
                 pooled_sweep: bool = True, device=None):
        if backend not in (None, "device", "host"):
            raise ValueError(f"unknown backend {backend!r}")
        use_device = likelihood_fn is None and backend == "device"
        shared_tips = None
        if use_device:
            shared_tips = _upload(leaf_partials(alignment), resolve_device(device))
        self.chains: List[Chain] = []
        for c in range(n_chains):
            power = 1.0 / (1.0 + heat_factor * c)
            chain_backend = None
            if use_device:
                chain_backend = CachedPartialsLikelihood(
                    alignment,
                    n_rate_categories=getattr(initial.model, "n_rate_categories", 1),
                    tips=shared_tips, seed=seed + c,
                )
            self.chains.append(
                Chain(alignment, initial.copy(), power,
                      random.Random(seed + c), fixed_topology=fixed_topology,
                      likelihood_fn=likelihood_fn, backend=chain_backend,
                      pooled_sweep=pooled_sweep)
            )
        self.rng = random.Random(seed + 1000)
        self.swap_attempts = 0
        self.swap_accepts = 0
        self.samples: List[Dict] = []

    @property
    def cold_chain(self) -> Chain:
        return next(c for c in self.chains if c.heating_power == 1.0)

    def swap_chains(self) -> None:
        if len(self.chains) < 2:
            return
        i, j = self.rng.sample(range(len(self.chains)), 2)
        ci, cj = self.chains[i], self.chains[j]
        self.swap_attempts += 1
        log_ratio = (ci.heating_power - cj.heating_power) * (
            cj.state.log_like - ci.state.log_like
        )
        if math.log(self.rng.random() + 1e-300) < log_ratio:
            ci.state, cj.state = cj.state, ci.state
            self.swap_accepts += 1

    def run(self, iterations: int, sample_freq: int = 10,
            swap_freq: int = 5, burn_in: int = 0) -> List[Dict]:
        for it in range(1, iterations + 1):
            # Pipelined heated chains: enqueue every chain's fused
            # iteration before collecting any, then wait once: the programs
            # and their packed copies share one stream, so the last one's
            # arrival means all have arrived. A chain that cannot dispatch,
            # and every chain after it, takes next_step() instead.
            tokens = []
            if len(self.chains) > 1:
                for chain in self.chains:
                    tok = chain.dispatch_full_iteration()
                    if tok is None:
                        break
                    tokens.append(tok)
            if tokens:
                tokens[-1][0].wait()
            for chain, tok in zip(self.chains, tokens):
                chain.collect_full_iteration(tok)
            for chain in self.chains[len(tokens):]:
                chain.next_step()
            if it % swap_freq == 0:
                self.swap_chains()
            if it > burn_in and it % sample_freq == 0:
                cold = self.cold_chain
                self.samples.append({
                    "iteration": it,
                    "log_like": cold.state.log_like,
                    "tree_length": cold.state.tree.tree_length(),
                    "gamma_shape": getattr(cold.state.model, "gamma_shape", 0.0),
                    "omega": getattr(cold.state.model, "omega", None),
                    "frequencies": np.asarray(cold.state.model.frequencies).copy(),
                    "newick": cold.state.tree.newick(),
                })
        return self.samples

    def write_params(self, path: str) -> None:
        """Parameter sample file (kpl_mcmc_output.h .p file analogue)."""
        with open(path, "w") as f:
            f.write("iteration\tlogL\tTL\talpha\tpiA\tpiC\tpiG\tpiT\n")
            for s in self.samples:
                pi = s["frequencies"]
                f.write(
                    f"{s['iteration']}\t{s['log_like']:.4f}\t{s['tree_length']:.4f}\t"
                    f"{s['gamma_shape']:.4f}\t"
                    + "\t".join(f"{p:.4f}" for p in pi) + "\n"
                )
