"""Heated MCMC chains advanced together on the device.

Counterpart of kgl_gene_tpu/phylo/vmapped.py, the device form of the
reference's chain-level parallelism (heated MCMC chains stepped and
swapped). Topology is FIXED; the continuous parameters (branch lengths,
state frequencies, exchangeabilities) of every chain sit in tensors with a
leading chain dimension, one pruning pass evaluates all chains at once, and
the Metropolis accepts and the parallel-tempering swap are vector ops. A
run enqueues every iteration's device work without a host synchronisation
and fetches the cold chain's trace once at the end.

Differences from the JAX program, none in what is computed:

  - The chains are an explicit leading dimension, not jax.vmap, and the
    run is a Python loop over iterations, not lax.scan.
  - Transition matrices come from transition_matrices (a Taylor polynomial
    with a fixed scaling and squaring in float64), not from _q_eigen's
    eigh: torch.linalg.eigh and torch.linalg.matrix_exp synchronise with
    the host on CUDA (matrix_exp reads the norms to choose its degree). The
    two give the same P to ~1e-7.
  - The random draws come from a torch.Generator on the device seeded by
    `seed` (the JAX program uses jax.random): _draws makes a whole run's
    uniforms, edge and swap indices, and the normals and uniforms of the
    Marsaglia-Tsang gamma candidates up front; each iteration turns its
    candidates into the Dirichlet frequency proposal (dirichlet_mt) with the
    alpha of its state, and _iteration, given those draws, is
    deterministic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from .likelihood import (_Topology, _dirichlet_logpdf, _edge_views, _prune, _root_loglike,
                         _upload, leaf_partials)
from .model import discrete_gamma_rates
from .tree import PhyloTree

__all__ = ["ChainParams", "VmappedChains", "transition_matrices", "dirichlet_mt"]

N_STATES = 4
# exp(A) = exp(A / 2^16)^(2^16): the Taylor polynomial's truncation stays
# below 1/13! ~ 1.6e-10 while |A|_1 <= 2^16 (t x rate x |Q|_1, far past
# saturation), and the squarings of a stochastic matrix amplify float64
# rounding at most 2^16 times, to ~1e-11 absolute.
_TAYLOR_DEGREE = 12
_SQUARINGS = 16
_GAMMA_CANDIDATES = 8    # Marsaglia-Tsang accepts >= 95% a candidate at alpha >= 1
# (i, j) of a 4x4 rate matrix -> index into the 6 exchangeabilities (AC, AG,
# AT, CG, CT, GT); the diagonal reads a 7th entry, 0.
_PAIR_OF_CELL = np.array([[6, 0, 1, 2], [0, 6, 3, 4], [1, 3, 6, 5], [2, 4, 5, 6]])


class ChainParams(NamedTuple):
    edge_lengths: torch.Tensor       # (C, E) float32
    frequencies: torch.Tensor        # (C, 4) (normalised)
    exchangeabilities: torch.Tensor  # (C, 6) (sum-normalised)


def _expm(A: torch.Tensor) -> torch.Tensor:
    """exp of a batch of rate-matrix multiples (..., 4, 4), float64: a
    degree-12 Taylor polynomial of A / 2^16 by Horner, squared 16 times.
    The same launches for every input: the host never reads a value."""
    shape = A.shape
    A = A.reshape(-1, N_STATES, N_STATES) * (0.5 ** _SQUARINGS)
    eye = torch.eye(N_STATES, dtype=A.dtype, device=A.device).expand_as(A)
    X = eye + A / _TAYLOR_DEGREE
    for k in range(_TAYLOR_DEGREE - 1, 0, -1):
        X = torch.baddbmm(eye, A, X, alpha=1.0 / k)
    for _ in range(_SQUARINGS):
        X = torch.bmm(X, X)
    return X.view(shape)


def q_matrices(exchangeabilities: torch.Tensor, frequencies: torch.Tensor,
               pair_of_cell: torch.Tensor) -> torch.Tensor:
    """Normalised GTR rate matrices (C, 4, 4), float64, as _q_eigen builds
    them: R * pi, rows summing to 0, scaled to one expected substitution a
    unit of time."""
    exch = exchangeabilities.double()
    pi = frequencies.double()
    pi = pi / pi.sum(-1, keepdim=True)
    padded = torch.cat([exch, exch.new_zeros(exch.shape[:-1] + (1,))], -1)
    R = padded.index_select(-1, pair_of_cell.view(-1)).view(*exch.shape[:-1], 4, 4)
    Q = R * pi[..., None, :]
    Q = Q - torch.diag_embed(Q.sum(-1))
    scale = -(pi * torch.diagonal(Q, dim1=-2, dim2=-1)).sum(-1)
    return Q / torch.clamp_min(scale, 1e-12)[..., None, None]


def transition_matrices(Q: torch.Tensor, edge_lengths: torch.Tensor,
                        rates: torch.Tensor) -> torch.Tensor:
    """P(t) = exp(Q t r) for chains' rate matrices Q (C, 4, 4), edge
    lengths (C, E) and rate categories (R,) -> (E, C, R, 4, 4) float32,
    edge slot first (the layout the pruning reads)."""
    t = edge_lengths.double().T[:, :, None] * rates[None, None, :]
    return _expm(Q[None, :, None] * t[..., None, None]).float()


def dirichlet_mt(alpha: torch.Tensor, normals: torch.Tensor, uniforms: torch.Tensor,
                 boost: torch.Tensor) -> torch.Tensor:
    """Dirichlet(alpha) draws (..., 4) from Marsaglia-Tsang gamma candidates:
    normals and uniforms (..., 4, K) give K candidates a component, the
    first accepted one is taken (d, the gamma's mode region, if none of the
    K is, which at K = 8 happens below 1e-10 a draw), and alpha < 1 is
    boosted from alpha + 1 by boost^(1/alpha) (boost (..., 4) uniform)."""
    small = alpha < 1.0
    a = torch.where(small, alpha + 1.0, alpha)
    d = (a - 1.0 / 3.0)[..., None]
    c = torch.rsqrt(9.0 * d)
    v = (1.0 + c * normals) ** 3
    ok = (v > 0) & (torch.log(uniforms) < 0.5 * normals * normals + d - d * v
                    + d * torch.log(torch.clamp_min(v, 1e-30)))
    first = ok.to(torch.float32).argmax(-1, keepdim=True)
    g = (d * v.gather(-1, first)).squeeze(-1)
    g = torch.where(ok.any(-1), g, d.squeeze(-1))
    g = torch.where(small, g * boost ** (1.0 / alpha), g)
    return g / g.sum(-1, keepdim=True)


class VmappedChains:
    def __init__(self, tree: PhyloTree, alignment_codes: np.ndarray,
                 n_chains: int = 4, heat_factor: float = 0.5,
                 gamma_shape: float = 1.0, n_rate_categories: int = 1,
                 seed: int = 0, device=None):
        self.device = dev = resolve_device(device)
        self.topo = _Topology(tree)
        self.n_leaves = tree.n_leaves
        self.n_chains = n_chains
        self.edges = tree.edges()
        self.n_edges = len(self.edges)
        self.tips = _upload(leaf_partials(alignment_codes), dev)
        self.n_sites = alignment_codes.shape[1]
        # Fixed gamma category rates (shape not sampled in the vmapped run).
        self.n_rates = n_rate_categories
        self.rates = _upload(discrete_gamma_rates(gamma_shape, n_rate_categories), dev,
                             np.float64)
        self.rate_weights = _upload(np.full(n_rate_categories, 1.0 / n_rate_categories), dev)
        self.powers = _upload([1.0 / (1.0 + heat_factor * c) for c in range(n_chains)], dev)
        self._pair_of_cell = _upload(_PAIR_OF_CELL, dev, np.int64)
        self._chain_index = torch.arange(n_chains, device=dev)
        init_edges = np.array([e.edge_length for e in self.edges])
        self.set_params(np.tile(init_edges[None, :], (n_chains, 1)),
                        np.full((n_chains, 4), 0.25), np.full((n_chains, 6), 1.0 / 6.0))
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self.loglike: Optional[np.ndarray] = None

    def set_params(self, edge_lengths, frequencies, exchangeabilities) -> None:
        """Every chain's parameters from numpy arrays (C, E), (C, 4),
        (C, 6), for example another implementation's state."""
        shapes = [np.shape(x) for x in (edge_lengths, frequencies, exchangeabilities)]
        want = [(self.n_chains, self.n_edges), (self.n_chains, 4), (self.n_chains, 6)]
        if shapes != want:
            raise ValueError(f"expected parameter shapes {want}, got {shapes}")
        self.params = ChainParams(*(_upload(x, self.device) for x in
                                    (edge_lengths, frequencies, exchangeabilities)))

    # ------------------------------------------------------------------ #
    def _loglike(self, params: ChainParams) -> torch.Tensor:
        """(C,) pruning log-likelihoods from the chains' parameter tensors."""
        Q = q_matrices(params.exchangeabilities, params.frequencies, self._pair_of_cell)
        P = transition_matrices(Q, params.edge_lengths, self.rates)
        parts = _prune(self.tips, self.topo, *_edge_views(self.topo, P))
        pi = params.frequencies / params.frequencies.sum(-1, keepdim=True)
        return _root_loglike(parts[self.topo.root], pi, self.rate_weights, 0.0, None)

    def _draws(self, n_iters: int) -> dict:
        """Every random draw of n_iters iterations, from the generator."""
        C, g, dev = self.n_chains, self.generator, self.device
        K = _GAMMA_CANDIDATES
        return {
            "edge": torch.randint(0, self.n_edges, (n_iters, C), generator=g, device=dev),
            "u": torch.rand((n_iters, C, 5), generator=g, device=dev),
            "swap": torch.randint(0, max(C - 1, 1), (n_iters,), generator=g, device=dev),
            "swap_u": torch.rand((n_iters,), generator=g, device=dev),
            "normals": torch.randn((n_iters, C, 4, K), generator=g, device=dev),
            "uniforms": torch.rand((n_iters, C, 4, K), generator=g, device=dev),
            "boost": torch.rand((n_iters, C, 4), generator=g, device=dev),
        }

    def _iteration(self, params: ChainParams, loglike: torch.Tensor, edge_idx, u,
                   new_freqs, swap_i, swap_u):
        """One deterministic iteration given its draws: edge_idx (C,) the
        scaled edge of each chain; u (C, 5) uniforms (edge factor, its
        accept, tree factor, its accept, frequency accept); new_freqs (C, 4)
        the Dirichlet proposals; swap_i (1,) the lower chain of the swap
        pair and swap_u (1,) its uniform. Returns (params, loglike)."""
        C, E = self.n_chains, self.n_edges
        ar = self._chain_index
        logu = torch.log(u)

        # --- branch-length scaler on a random edge per chain
        factor = torch.exp(0.5 * (u[:, 0] - 0.5))
        old = params.edge_lengths.gather(1, edge_idx[:, None])
        proposal = params.edge_lengths.scatter(1, edge_idx[:, None],
                                               torch.clamp_min(old * factor[:, None], 1e-8))
        prop_like = self._loglike(params._replace(edge_lengths=proposal))
        prior = -10.0 * (proposal.sum(1) - params.edge_lengths.sum(1))
        accept = logu[:, 1] < self.powers * (prop_like - loglike) + prior + torch.log(factor)
        params = params._replace(edge_lengths=torch.where(accept[:, None], proposal,
                                                          params.edge_lengths))
        loglike = torch.where(accept, prop_like, loglike)

        # --- whole-tree length scaler
        factor = torch.exp(0.3 * (u[:, 2] - 0.5))
        proposal = torch.clamp_min(params.edge_lengths * factor[:, None], 1e-8)
        prop_like = self._loglike(params._replace(edge_lengths=proposal))
        prior = -10.0 * (proposal.sum(1) - params.edge_lengths.sum(1))
        ratio = self.powers * (prop_like - loglike) + prior + E * torch.log(factor)
        accept = logu[:, 3] < ratio
        params = params._replace(edge_lengths=torch.where(accept[:, None], proposal,
                                                          params.edge_lengths))
        loglike = torch.where(accept, prop_like, loglike)

        # --- state frequencies (Dirichlet kernel)
        conc = 500.0
        alpha = torch.clamp_min(params.frequencies * conc, 1e-3)
        alpha_new = torch.clamp_min(new_freqs * conc, 1e-3)
        log_fwd = _dirichlet_logpdf(new_freqs, alpha)
        log_back = _dirichlet_logpdf(params.frequencies, alpha_new)
        prop_like = self._loglike(params._replace(frequencies=new_freqs))
        accept = logu[:, 4] < self.powers * (prop_like - loglike) + (log_back - log_fwd)
        params = params._replace(frequencies=torch.where(accept[:, None], new_freqs,
                                                         params.frequencies))
        loglike = torch.where(accept, prop_like, loglike)

        # --- tempering swap between a random adjacent pair
        if C > 1:
            i, j = swap_i, swap_i + 1
            log_ratio = ((self.powers.index_select(0, i) - self.powers.index_select(0, j))
                         * (loglike.index_select(0, j) - loglike.index_select(0, i)))
            do_swap = torch.log(swap_u) < log_ratio
            perm = torch.where(do_swap & (ar == i), j, torch.where(do_swap & (ar == j), i, ar))
            params = ChainParams(*(x.index_select(0, perm) for x in params))
            loglike = loglike.index_select(0, perm)
        return params, loglike

    def _run(self, params: ChainParams, n_iters: int):
        """Enqueue n_iters iterations; returns (params, loglike, the cold
        chain's trace), all on the device, with no host synchronisation."""
        loglike = self._loglike(params)
        draws = self._draws(n_iters)
        trace = []
        for it in range(n_iters):
            alpha = torch.clamp_min(params.frequencies * 500.0, 1e-3)
            new_freqs = dirichlet_mt(alpha, draws["normals"][it], draws["uniforms"][it],
                                     draws["boost"][it])
            params, loglike = self._iteration(params, loglike, draws["edge"][it],
                                              draws["u"][it], new_freqs,
                                              draws["swap"][it: it + 1],
                                              draws["swap_u"][it: it + 1])
            trace.append(loglike[0])
        return params, loglike, torch.stack(trace)

    def run(self, n_iters: int) -> np.ndarray:
        """Advance all chains n_iters iterations on the device; returns the
        cold chain's log-likelihood trace (one fetch)."""
        params, loglike, trace = self._run(self.params, n_iters)
        self.params = params
        self.loglike = loglike.cpu().numpy()
        return trace.cpu().numpy()
