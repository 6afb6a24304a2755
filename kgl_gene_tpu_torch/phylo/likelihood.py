"""Site likelihood via Felsenstein pruning, in PyTorch on the device.

Counterpart of kgl_gene_tpu/phylo/likelihood.py. Capability parity with the
kpl/BeagleLib likelihood (kpl_phylogenetic/kpl_likelihood.h:13,43-105):
conditional-likelihood partials propagated up the tree, each pruning step

    partial[parent] *= partial[child] @ P(t_child)^T

batched over (rate categories x sites); gamma rate mixing,
proportion-invariant sites and the log at the root.

The host half is a copy: leaf_partials, the numpy float64 reference
log_likelihood and the constant-site cache. The device half runs in float32,
as the JAX package does (no x64), so that Metropolis decisions agree:

  - TreeLikelihood: one full pruning pass for a tree and a model.
  - CachedPartialsLikelihood: per-node partials kept on the device; a
    one-edge proposal recomputes only the changed node -> root path
    (loglike, on_accept, on_reject); the four continuous-parameter moves in
    one device program (param_sweep); the Larget-Simon + polytomy pair
    (topo_pair); and the whole product iteration (full_iteration), each
    ending in one packed fetch.

Differences from the JAX programs, none in what is computed:

  - Eager PyTorch compiles nothing, so nothing is padded to static shapes:
    the pruning loops over the real internal nodes and children, which the
    host knows from traversal_arrays, and the packed outputs hold the real
    edge counts (_unpack_iteration reads them with the sizes).
  - The random draws of the sweep and the fused iteration depend only on
    the state at the start of the iteration, so they are drawn on the host
    from a generator seeded by the caller (SweepDraws) and uploaded with
    the other inputs; the deterministic bodies (_sweep_body, _fiter_body)
    take them as arguments. The JAX package draws them from jax.random
    under a key seeded from os.urandom.
  - The eigendecompositions of the GTR matrix are taken on the host in
    float64: the frequencies and exchangeabilities an iteration can reach
    are the start values and the two Dirichlet proposals, four pairs known
    before the iteration, and the device selects among them. There is no
    device eigh (torch.linalg.eigh synchronises with the host on CUDA).
  - Uploads go through pinned memory with non_blocking=True and the packed
    result comes back the same way, so a device program makes no host
    synchronisation until the caller waits for its result (_Fetch.wait).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .model import SubstitutionModel, discrete_gamma_rates
from .tree import PhyloTree

__all__ = [
    "leaf_partials",
    "log_likelihood",
    "TreeLikelihood",
    "CachedPartialsLikelihood",
    "SweepDraws",
]

N_STATES = 4
DTYPE = torch.float32
# DNA5 code -> observed-state likelihood row; N (code 4) = all ones.
_CODE_ROWS = np.vstack([np.eye(4), np.ones((1, 4))]).astype(np.float64)
# The proposal kernels of the pooled moves (mcmc.Chain's updaters).
_EDGE_LAMBDA, _TREE_LAMBDA, _DIRICHLET_CONC = 0.5, 0.3, 500.0
_EDGE_PRIOR_RATE = 10.0


def leaf_partials(alignment_codes: np.ndarray) -> np.ndarray:
    """(n_leaves, n_sites) uint8 codes -> (n_leaves, n_sites, 4) tip
    partials (ambiguity 'N' = uninformative)."""
    return _CODE_ROWS[np.clip(alignment_codes, 0, 4)]


def log_likelihood(
    tree: PhyloTree,
    alignment_codes: np.ndarray,
    model: SubstitutionModel,
    site_weights: Optional[np.ndarray] = None,
) -> float:
    """Felsenstein log likelihood of an alignment on a tree (host/numpy
    reference path; the device path is TreeLikelihood)."""
    arrays = tree.traversal_arrays()
    n_sites = alignment_codes.shape[1]
    rates = model.rate_categories
    n_rates = len(rates)
    tips = leaf_partials(alignment_codes)
    partials = np.ones((arrays["n_nodes"], n_rates, n_sites, N_STATES))
    partials[: tree.n_leaves] = tips[:, None, :, :]

    for k in range(arrays["n_internals"]):
        node = arrays["internal_index"][k]
        acc = np.ones((n_rates, n_sites, N_STATES))
        for c in range(arrays["child_index"].shape[1]):
            child = arrays["child_index"][k, c]
            if child < 0:
                continue
            P = model.transition_matrices(np.array([arrays["child_edge"][k, c]]))[0]
            # (rates, 4, 4) x (rates, sites, 4) -> (rates, sites, 4)
            acc = acc * np.einsum("rij,rsj->rsi", P, partials[child])
        partials[node] = acc

    pi = model.frequencies / model.frequencies.sum()
    root = partials[arrays["root_index"]]  # (rates, sites, 4)
    site_like = np.einsum("rsi,i->rs", root, pi).mean(axis=0)  # rate-average
    if model.p_invariant > 0:
        # Invariant-site mixture: constant sites get extra mass.
        constant = _constant_site_likelihood(alignment_codes, pi)
        site_like = (1.0 - model.p_invariant) * site_like + model.p_invariant * constant
    weights = site_weights if site_weights is not None else np.ones(n_sites)
    return float(np.sum(weights * np.log(np.maximum(site_like, 1e-300))))


_CONST_PATTERN_CACHE: dict = {}
_CONST_PATTERN_CACHE_MAX = 8


def _constant_site_pattern(codes: np.ndarray):
    """(constant_state, all_n) per site: constant_state = the single
    observed state (-1 if the column is variable), all_n = every row
    ambiguous. Depends only on the alignment — computed once and cached
    (a per-proposal Python loop over 10^5 sites once cost ~0.8 s/eval).

    The cache entry PINS the codes array: an id()-only key could be
    reused by a different array after the original is collected, silently
    corrupting log-likelihoods. Bounded FIFO so temporaries can't grow it."""
    key = id(codes)
    hit = _CONST_PATTERN_CACHE.get(key)
    if hit is not None and hit[0] is codes:
        return hit[1]
    masked = np.where(codes < 4, codes.astype(np.int16), -1)
    mx = masked.max(axis=0)
    observed_agree = ((masked == mx[None, :]) | (masked < 0)).all(axis=0)
    all_n = mx < 0
    const_state = np.where(observed_agree & ~all_n, mx, -1)
    result = (const_state, all_n)
    if len(_CONST_PATTERN_CACHE) >= _CONST_PATTERN_CACHE_MAX:
        _CONST_PATTERN_CACHE.pop(next(iter(_CONST_PATTERN_CACHE)))
    _CONST_PATTERN_CACHE[key] = (codes, result)
    return result


def _constant_site_likelihood(codes: np.ndarray, pi: np.ndarray) -> np.ndarray:
    """P(site | invariant): pi_x if all observed states agree (N wild)."""
    const_state, all_n = _constant_site_pattern(codes)
    out = np.zeros(codes.shape[1])
    ok = const_state >= 0
    out[ok] = np.asarray(pi)[const_state[ok]]
    out[all_n] = 1.0
    return out


# --------------------------------------------------------------------------- #
# host <-> device
# --------------------------------------------------------------------------- #
def _upload(array: np.ndarray, device: torch.device, dtype=np.float32) -> torch.Tensor:
    """A fresh host array on `device`: through pinned memory and a
    non-blocking copy on the card (no host synchronisation), as is on the
    CPU."""
    host = torch.from_numpy(np.array(array, dtype=dtype, copy=True))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


class _Fetch:
    """A packed device vector on its way to the host. On the card the copy
    goes to pinned memory behind an event, and wait() is the only point the
    host waits for the device; on the CPU the vector is already there."""

    def __init__(self, packed: torch.Tensor):
        if packed.is_cuda:
            self.host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = packed, None

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


# --------------------------------------------------------------------------- #
# pruning
# --------------------------------------------------------------------------- #
class _Topology:
    """What the host knows of a tree for one pruning pass: the postorder
    internal nodes with their children, each non-root node's edge slot
    (its position in tree.edges(), the order of every edge-length vector)
    and the parent of every node. traversal_arrays() renumbers the tree."""

    def __init__(self, tree: PhyloTree):
        arrays = tree.traversal_arrays()
        self.n_nodes = int(arrays["n_nodes"])
        self.root = int(arrays["root_index"])
        self.parent = arrays["parent_index"]
        ci = arrays["child_index"]
        self.steps = [
            (int(node), tuple(int(c) for c in row if c >= 0))
            for node, row in zip(arrays["internal_index"], ci)
        ]
        edges = tree.edges()
        self.slot = {e.index: i for i, e in enumerate(edges)}
        self.edge_lengths = np.array([e.edge_length for e in edges], dtype=np.float64)
        self.key = (ci.tobytes(), arrays["internal_index"].tobytes(), self.root)

    @property
    def n_edges(self) -> int:
        return len(self.edge_lengths)


def _tip_weights(P: torch.Tensor) -> torch.Tensor:
    """(E, *B, 4_i, 4_j) transition matrices -> (E, 4_j, *B, 4_i),
    contiguous, so that one edge's slice reshaped to (4, prod(B) * 4) lifts
    a (S, 4) tip in one matrix product."""
    return P.movedim(-1, 1).contiguous()


def _lift(tips: torch.Tensor, parts: List, child: int, P: torch.Tensor,
          TW: torch.Tensor) -> torch.Tensor:
    """partial[child] @ P^T, (*B, S, 4). A tip is (S, 4) and shared by the
    batch: one (S, 4) x (4, prod(B) * 4) product, viewed back to
    (*B, S, 4); an internal node is (*B, S, 4): a batched product."""
    if child < tips.shape[0]:
        batch = P.shape[:-2]
        out = tips[child] @ TW.reshape(N_STATES, -1)
        return out.view(out.shape[0], *batch, N_STATES).movedim(0, -2)
    return torch.matmul(parts[child], P.transpose(-1, -2))


def _node_partial(tips, parts, children, P_of, TW_of) -> torch.Tensor:
    """The product over an internal node's children of their lifted
    partials, in a fresh contiguous tensor."""
    lifted = [_lift(tips, parts, c, P_of[c], TW_of[c]) for c in children]
    if len(lifted) == 1:
        return lifted[0].contiguous()
    acc = torch.empty(lifted[0].shape, dtype=lifted[0].dtype, device=lifted[0].device)
    torch.mul(lifted[0], lifted[1], out=acc)
    for extra in lifted[2:]:
        acc.mul_(extra)
    return acc


def _prune(tips, topo: _Topology, P_of, TW_of, parts: Optional[List] = None,
           nodes: Optional[Sequence[Tuple[int, tuple]]] = None) -> List:
    """Fill `parts` (a list by node index; leaves stay None and read the
    tips) for `nodes` (default: every internal node, in postorder)."""
    if parts is None:
        parts = [None] * topo.n_nodes
    for node, children in (topo.steps if nodes is None else nodes):
        parts[node] = _node_partial(tips, parts, children, P_of, TW_of)
    return parts


def _edge_views(topo: _Topology, P: torch.Tensor) -> Tuple[List, List]:
    """Per-node lists (by node index) of P and tip-weight views of a
    (E, *B, 4, 4) tensor in slot order."""
    TW = _tip_weights(P)
    P_of: List = [None] * topo.n_nodes
    TW_of: List = [None] * topo.n_nodes
    for node, slot in topo.slot.items():
        P_of[node] = P[slot]
        TW_of[node] = TW[slot]
    return P_of, TW_of


def _host_P_pass(tips, topo: _Topology, model, device) -> Tuple[List, List, List]:
    """One pruning pass with every edge's transition matrices from the host
    (SubstitutionModel.transition_matrices, float64, one upload):
    (P_of, TW_of, parts)."""
    P = _upload(model.transition_matrices(topo.edge_lengths), device)
    P_of, TW_of = _edge_views(topo, P)
    return P_of, TW_of, _prune(tips, topo, P_of, TW_of)


def _root_loglike(root, frequencies, rate_weights, p_invariant: float,
                  constant_like) -> torch.Tensor:
    """sum over sites of log(sum_r w_r (root_r @ pi)), with the
    proportion-invariant mixture. root (*C, R, S, 4), frequencies (*C, 4)
    -> (*C). The clamp at 0 is JAX's max(site, 1e-300) in float32, where
    1e-300 rounds to 0."""
    site = torch.matmul(root, frequencies[..., None, :, None]).squeeze(-1)  # (*C, R, S)
    site = (site * rate_weights[:, None]).sum(-2)
    if p_invariant != 0.0:
        site = (1.0 - p_invariant) * site + p_invariant * constant_like
    return site.clamp_min(0.0).log().sum(-1)


def _eigen_table(pairs) -> np.ndarray:
    """(n, 36) float64 rows (lam (4), V (16), V^-1 (16)) of the normalised
    GTR matrices of (frequencies, exchangeabilities) pairs: the
    symmetric-similarity eigendecomposition of SubstitutionModel.eigen."""
    rows = []
    for freq, exch in pairs:
        lam, V, Vinv = SubstitutionModel(np.asarray(exch, np.float64),
                                         np.asarray(freq, np.float64)).eigen()
        rows.append(np.concatenate([lam, V.ravel(), Vinv.ravel()]))
    return np.stack(rows)


def _eigen_P(eig: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P = V diag(exp(lam t)) V^-1 for every entry of t (*T) -> (*T, 4, 4),
    from one (36,) eigen row."""
    lam, V, Vinv = eig[:4], eig[4:20].view(4, 4), eig[20:36].view(4, 4)
    e = torch.exp(lam * t[..., None])
    return (V * e[..., None, :]) @ Vinv


# --------------------------------------------------------------------------- #
# TreeLikelihood
# --------------------------------------------------------------------------- #
class TreeLikelihood:
    """Device likelihood for a fixed topology: branch lengths and model
    parameters vary. One pruning pass a call; the transition matrices come
    from the host (SubstitutionModel.transition_matrices, float64) in one
    upload."""

    def __init__(self, tree: PhyloTree, alignment_codes: np.ndarray,
                 n_rate_categories: int = 1, device=None):
        self.device = resolve_device(device)
        self.n_leaves = tree.n_leaves
        self.n_rates = n_rate_categories
        self.n_sites = alignment_codes.shape[1]
        self.tips = _upload(leaf_partials(alignment_codes), self.device)
        self._codes = alignment_codes

    def __call__(self, tree: PhyloTree, model: SubstitutionModel) -> float:
        topo = _Topology(tree)
        *_, parts = _host_P_pass(self.tips, topo, model, self.device)
        pi = model.frequencies / model.frequencies.sum()
        constant = (_upload(_constant_site_likelihood(self._codes, pi), self.device)
                    if model.p_invariant else None)
        ll = _root_loglike(parts[topo.root], _upload(pi, self.device),
                           _upload(np.full(self.n_rates, 1.0 / self.n_rates), self.device),
                           float(model.p_invariant), constant)
        return float(ll)


# --------------------------------------------------------------------------- #
# CachedPartialsLikelihood
# --------------------------------------------------------------------------- #
@dataclass
class SweepDraws:
    """The random draws of one pooled sweep or fused iteration, all fixed
    by the state at its start: e0 the edge slot of the single-edge scaler;
    u the uniforms (edge factor, its accept, tree factor, its accept,
    frequency accept, exchangeability accept, and for the fused iteration
    the Larget-Simon accept); nf and ne the Dirichlet proposals of the
    frequencies and of the normalised exchangeabilities."""

    e0: int
    u: np.ndarray
    nf: np.ndarray
    ne: np.ndarray


def _dirichlet_logpdf(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """jax.scipy.stats.dirichlet.logpdf over the last dimension (a row of
    chains at a time, as jax.vmap of it would): -inf off the simplex (an
    entry <= 0, or a sum more than 1e-6 from one)."""
    norm = torch.lgamma(alpha).sum(-1) - torch.lgamma(alpha.sum(-1))
    logp = torch.xlogy(alpha - 1.0, x).sum(-1) - norm
    simplex = (x > 0).all(-1) & ((x.sum(-1) - 1.0).abs() < 1e-6)
    return torch.where(simplex, logp, torch.full_like(logp, -torch.inf))


class CachedPartialsLikelihood:
    """Incremental (Beagle-style) device likelihood for the MCMC hot path:
    per-node partials are CACHED on the device and a branch-length proposal
    recomputes only the changed node -> root path; full recomputation
    happens only when the topology or the substitution-model parameters
    change (kpl_phylogenetic/kpl_likelihood.h:43-105, kpl_mcmc_chain.h:66-71).

    Usage (Chain wires this automatically when given as `backend`):
        ll = backend.loglike(tree, model, changed_node_index=i)  # proposal
        backend.on_accept() / backend.on_reject()

    `seed` seeds the host generator of the pooled programs' draws; `tips`
    may be shared by heated chains over the same alignment (one device copy
    of the (n_leaves, n_sites, 4) tip partials)."""

    def __init__(self, alignment_codes: np.ndarray, n_rate_categories: int = 1,
                 tips: Optional[torch.Tensor] = None, device=None, seed: int = 0):
        self.device = resolve_device(device) if tips is None else tips.device
        self._codes = alignment_codes
        self.n_rates = n_rate_categories
        self.n_sites = alignment_codes.shape[1]
        self.n_leaves = alignment_codes.shape[0]
        self.tips = _upload(leaf_partials(alignment_codes), self.device) if tips is None else tips
        self._committed: Optional[dict] = None
        self._pending: Optional[dict] = None
        self._const_cache: Dict[bytes, tuple] = {}
        self._const_index: Optional[tuple] = None
        self.rng = np.random.default_rng(seed)
        self.full_evals = 0
        self.path_evals = 0

    # -- keys ---------------------------------------------------------------
    @staticmethod
    def _model_key(model) -> Tuple:
        ex = getattr(model, "exchangeabilities", None)
        return (
            None if ex is None else np.asarray(ex).tobytes(),
            np.asarray(model.frequencies).tobytes(),
            float(getattr(model, "gamma_shape", 0.0)),
            int(getattr(model, "n_rate_categories", 1)),
            float(getattr(model, "p_invariant", 0.0)),
            float(getattr(model, "kappa", 0.0) or 0.0)
            if hasattr(model, "kappa") else 0.0,
        )

    def _device_consts(self, pi: np.ndarray, model):
        """(pi, rate weights, constant-site vector or None) on the device,
        cached by content: the constant-site vector is n_sites long and only
        needed with p_invariant > 0."""
        pinv = float(getattr(model, "p_invariant", 0.0))
        key = pi.tobytes() + bytes([pinv > 0])
        hit = self._const_cache.get(key)
        if hit is None:
            hit = (
                _upload(pi, self.device),
                _upload(np.full(self.n_rates, 1.0 / self.n_rates), self.device),
                _upload(_constant_site_likelihood(self._codes, pi), self.device)
                if pinv > 0 else None,
            )
            if len(self._const_cache) > 16:
                self._const_cache.pop(next(iter(self._const_cache)))
            self._const_cache[key] = hit
        return hit

    # -- API ----------------------------------------------------------------
    def loglike(self, tree: PhyloTree, model, changed_node_index=None) -> float:
        topo = _Topology(tree)
        model_key = self._model_key(model)
        pi = np.asarray(model.frequencies, dtype=np.float64)
        pi = pi / pi.sum()
        pi_d, rw_d, const_d = self._device_consts(pi, model)
        pinv = float(getattr(model, "p_invariant", 0.0))

        committed = self._committed
        if (committed is not None and committed["topo_key"] == topo.key
                and committed["model_key"] == model_key
                and changed_node_index in topo.slot):
            # one edge changed: refresh its P and rescan the path to the root
            child = int(changed_node_index)
            newP = _upload(model.transition_matrices(
                np.asarray([topo.edge_lengths[topo.slot[child]]]))[0], self.device)
            P_of, TW_of = list(committed["P_of"]), list(committed["TW_of"])
            P_of[child] = newP
            TW_of[child] = _tip_weights(newP[None])[0]
            children = dict(topo.steps)
            path = []
            node = int(topo.parent[child])
            while node >= 0:
                path.append((node, children[node]))
                node = int(topo.parent[node])
            parts = _prune(self.tips, topo, P_of, TW_of, list(committed["parts"]), path)
            ll = _root_loglike(parts[topo.root], pi_d, rw_d, pinv, const_d)
            self.path_evals += 1
            self._pending = dict(committed, parts=parts, P_of=P_of, TW_of=TW_of)
            return float(ll)

        # full recompute; every edge's P from one batched host call
        P_of, TW_of, parts = _host_P_pass(self.tips, topo, model, self.device)
        ll = _root_loglike(parts[topo.root], pi_d, rw_d, pinv, const_d)
        self.full_evals += 1
        self._pending = dict(topo_key=topo.key, model_key=model_key, parts=parts,
                             P_of=P_of, TW_of=TW_of)
        return float(ll)

    def on_accept(self) -> None:
        if self._pending is not None:
            self._committed = self._pending
        self._pending = None

    def on_reject(self) -> None:
        self._pending = None

    # -- the device likelihood of the pooled programs ------------------------
    def _rates(self, model) -> np.ndarray:
        shape = float(getattr(model, "gamma_shape", 1.0) or 1.0)
        return discrete_gamma_rates(shape, self.n_rates) if self.n_rates > 1 else np.ones(1)

    def _const_on_device(self, pi: torch.Tensor) -> torch.Tensor:
        """The constant-site vector for a device pi: pi[state] where every
        observed state agrees, 1 where all are N, else 0 (a gather from
        [pi, 0])."""
        if self._const_index is None:
            const_state, all_n = _constant_site_pattern(self._codes)
            idx = np.where(const_state >= 0, const_state, 4)
            self._const_index = (_upload(idx, self.device, np.int64),
                                 _upload(all_n, self.device, np.bool_))
        idx, all_n = self._const_index
        table = torch.cat([pi, pi.new_zeros(1)])
        return torch.where(all_n, 1.0, table.index_select(0, idx))

    def _device_loglike(self, topo: _Topology, bl: torch.Tensor, eig: torch.Tensor,
                        freq: torch.Tensor, ctx: dict) -> torch.Tensor:
        """0-d log-likelihood of `topo` with edge lengths `bl` (slot order)
        under the eigen row `eig` and frequencies `freq`, all on the device."""
        P = _eigen_P(eig, bl[:, None] * ctx["rates"][None, :])
        parts = _prune(self.tips, topo, *_edge_views(topo, P))
        pi = freq / freq.sum()
        const = self._const_on_device(pi) if ctx["pinv"] else None
        return _root_loglike(parts[topo.root], pi, ctx["rw"], ctx["pinv"], const)

    # -- pooled parameter sweep --------------------------------------------
    def draw_sweep(self, model, n_edges: int) -> SweepDraws:
        """The draws of one sweep from the backend's host generator: every
        one depends only on the state at the start (both Dirichlet alphas
        come from the input frequencies and exchangeabilities). The fused
        iteration appends the chain's Larget-Simon uniform."""
        freq = np.asarray(model.frequencies, np.float32).astype(np.float64)
        ex = np.asarray(model.exchangeabilities, np.float64)
        exn = (ex / ex.sum()).astype(np.float32).astype(np.float64)
        e0 = int(self.rng.integers(0, n_edges))
        u = self.rng.random(6)
        nf = self.rng.dirichlet(np.maximum(freq * _DIRICHLET_CONC, 1e-3))
        ne = self.rng.dirichlet(np.maximum(exn * _DIRICHLET_CONC, 1e-3))
        return SweepDraws(e0, u, nf, ne)

    def _sweep_inputs(self, topo: _Topology, model, draws: SweepDraws, extra=()):
        """One upload of everything the pooled programs read: the edge
        lengths, frequencies, normalised exchangeabilities, the draws, the
        eigen rows of the four (frequency, exchangeability) pairs and the
        rate categories, then `extra` (float32-exact integers); views of it
        on the device."""
        freq = np.asarray(model.frequencies, np.float32)
        ex = np.asarray(model.exchangeabilities, np.float64)
        exn = (ex / ex.sum()).astype(np.float32)
        nf = np.asarray(draws.nf, np.float32)
        ne = np.asarray(draws.ne, np.float32)
        eig = _eigen_table([(freq, exn), (nf, exn), (freq, ne), (nf, ne)])
        rates = self._rates(model)
        parts = [topo.edge_lengths, freq, exn, np.asarray(draws.u), nf, ne,
                 eig.ravel(), rates, *extra]
        flat = _upload(np.concatenate([np.ravel(p).astype(np.float64) for p in parts]),
                       self.device)
        views, off = [], 0
        for p in parts:
            views.append(flat[off: off + np.size(p)])
            off += np.size(p)
        bl, freq_d, exn_d, u, nf_d, ne_d, eig_d, rates_d, *extra_d = views
        ctx = dict(rates=rates_d, pinv=float(getattr(model, "p_invariant", 0.0)),
                   rw=torch.full((self.n_rates,), 1.0 / self.n_rates, dtype=DTYPE,
                                 device=self.device))
        return bl, freq_d, exn_d, u, nf_d, ne_d, eig_d.view(4, 36), ctx, extra_d

    def _sweep_moves(self, topo, bl, freq, exch, u, nf, ne, eig, ctx, e0: int,
                     heat: float):
        """The four continuous-parameter moves back to back (single-edge
        scaler, tree scaler, frequency Dirichlet, exchangeability
        Dirichlet), priors and kernels as in mcmc.Chain's updaters. Returns
        (bl, freq, exch, ll, accepts, eigen row of the final state)."""
        n_edges = topo.n_edges
        ll0 = self._device_loglike(topo, bl, eig[0], freq, ctx)
        logu = torch.log(u)

        # 1. single-edge scaler (exp(10) branch prior, lambda 0.5)
        f1 = torch.exp(_EDGE_LAMBDA * (u[0] - 0.5))
        bl1 = bl.clone()
        bl1[e0] = torch.clamp_min(bl[e0] * f1, 1e-8)
        ll1 = self._device_loglike(topo, bl1, eig[0], freq, ctx)
        prior = -_EDGE_PRIOR_RATE * (bl1.sum() - bl.sum())
        a1 = logu[1] < heat * (ll1 - ll0) + prior + torch.log(f1)
        bl = torch.where(a1, bl1, bl)
        ll0 = torch.where(a1, ll1, ll0)

        # 2. whole-tree scaler (lambda 0.3)
        f2 = torch.exp(_TREE_LAMBDA * (u[2] - 0.5))
        bl2 = torch.clamp_min(bl * f2, 1e-8)
        ll2 = self._device_loglike(topo, bl2, eig[0], freq, ctx)
        prior = -_EDGE_PRIOR_RATE * (bl2.sum() - bl.sum())
        a2 = logu[3] < heat * (ll2 - ll0) + prior + n_edges * torch.log(f2)
        bl = torch.where(a2, bl2, bl)
        ll0 = torch.where(a2, ll2, ll0)

        # 3. state frequencies (Dirichlet kernel, concentration 500)
        alpha = torch.clamp_min(freq * _DIRICHLET_CONC, 1e-3)
        alpha_new = torch.clamp_min(nf * _DIRICHLET_CONC, 1e-3)
        h3 = _dirichlet_logpdf(freq / freq.sum(), alpha_new) - _dirichlet_logpdf(nf, alpha)
        ll3 = self._device_loglike(topo, bl, eig[1], nf, ctx)
        a3 = logu[4] < heat * (ll3 - ll0) + h3
        freq = torch.where(a3, nf, freq)
        ll0 = torch.where(a3, ll3, ll0)

        # 4. exchangeabilities (Dirichlet on the normalised simplex)
        exn = exch / exch.sum()
        alpha = torch.clamp_min(exn * _DIRICHLET_CONC, 1e-3)
        alpha_new = torch.clamp_min(ne * _DIRICHLET_CONC, 1e-3)
        h4 = _dirichlet_logpdf(exn, alpha_new) - _dirichlet_logpdf(ne, alpha)
        eig_ne = torch.where(a3, eig[3], eig[2])
        ll4 = self._device_loglike(topo, bl, eig_ne, freq, ctx)
        a4 = logu[5] < heat * (ll4 - ll0) + h4
        exch = torch.where(a4, ne, exn)
        ll0 = torch.where(a4, ll4, ll0)
        eig_final = torch.where(a4, eig_ne, torch.where(a3, eig[1], eig[0]))
        return bl, freq, exch, ll0, (a1, a2, a3, a4), eig_final

    def _sweep_body(self, tree: PhyloTree, model, heating_power: float,
                    draws: SweepDraws) -> _Fetch:
        """The deterministic device program of param_sweep, given its draws:
        one upload, the four moves, one packed result [bl (E), freq (4),
        exch (6), ll, 4 accept flags] on its way to the host."""
        topo = _Topology(tree)
        bl, freq, exch, u, nf, ne, eig, ctx, _ = self._sweep_inputs(topo, model, draws)
        bl, freq, exch, ll, flags, _ = self._sweep_moves(
            topo, bl, freq, exch, u, nf, ne, eig, ctx, draws.e0, float(heating_power))
        return _Fetch(torch.cat([bl, freq, exch, ll[None],
                                 torch.stack(flags).to(DTYPE)]))

    def param_sweep(self, tree: PhyloTree, model, heating_power: float):
        """Run the pooled 4-move parameter sweep; returns a dict with the
        new edge lengths / frequencies / exchangeabilities (normalised),
        final log-likelihood and per-move accept flags. Invalidates the
        cached partials (the committed state no longer matches)."""
        n_edges = len(tree.edges())
        draws = self.draw_sweep(model, n_edges)
        packed = self._sweep_body(tree, model, heating_power, draws).wait()
        self._committed = None
        self._pending = None
        off = n_edges
        return {
            "edge_lengths": packed[:off],
            "frequencies": packed[off: off + 4],
            "exchangeabilities": packed[off + 4: off + 10],
            "log_like": float(packed[off + 10]),
            "accepts": packed[off + 11: off + 15] > 0.5,
        }

    # -- pooled speculative topology pair ----------------------------------
    def topo_pair(self, model, heating_power, ll0, t1, hp1, t2a, hp2a,
                  t2b, hp2b, u1, u2a, u2b):
        """Decide the pooled (Larget-Simon, polytomy) proposal pair on the
        device: the Larget-Simon proposal, then BOTH possible polytomy
        proposals (drawn from the accept and the reject state) and a select
        on the device, one fetch. t2a/t2b may be None (that branch's move
        unavailable: its likelihood is not computed). Returns (acc1, acc2,
        ll_final)."""
        pi = np.asarray(model.frequencies, np.float64)
        pi = pi / pi.sum()
        pi_d, rw_d, const_d = self._device_consts(pi, model)
        pinv = float(getattr(model, "p_invariant", 0.0))

        def full(tree):
            topo = _Topology(tree)
            *_, parts = _host_P_pass(self.tips, topo, model, self.device)
            return _root_loglike(parts[topo.root], pi_d, rw_d, pinv, const_d)

        ll1 = full(t1)
        acc1 = float(np.log(np.float32(u1))) < heating_power * (ll1 - float(ll0)) + hp1
        ll_base = torch.where(acc1, ll1, float(ll0))
        llA = full(t2a) if t2a is not None else ll_base
        llB = full(t2b) if t2b is not None else ll_base
        ll2 = torch.where(acc1, llA, llB)
        hp2 = torch.where(acc1, float(hp2a if t2a is not None else 0.0),
                          float(hp2b if t2b is not None else 0.0))
        ok2 = torch.where(acc1, t2a is not None, t2b is not None)
        logu2 = torch.where(acc1, float(np.log(np.float32(u2a))),
                            float(np.log(np.float32(u2b))))
        acc2 = ok2 & (logu2 < heating_power * (ll2 - ll_base) + hp2)
        ll_fin = torch.where(acc2, ll2, ll_base)
        out = _Fetch(torch.stack([acc1.to(DTYPE), acc2.to(DTYPE), ll_fin])).wait()
        # topology changed under the committed partials either way
        self._committed = None
        self._pending = None
        return bool(out[0] > 0.5), bool(out[1] > 0.5), float(out[2])

    # -- fused full iteration ------------------------------------------------
    def _fiter_body(self, tree, model, heating_power, draws: SweepDraws,
                    t1, perm1, ls_slot, hp1,
                    t2a, permA, newA, vlenA, hpA, u2a,
                    t2b, permB, newB, vlenB, hpB, u2b):
        """The deterministic device program of full_iteration, given its
        draws: the four moves, then the Larget-Simon proposal on the
        post-sweep parameters and BOTH speculative polytomy branches, seven
        Metropolis decisions, one packed result on its way to the host.
        Returns (the fetch, the packed sizes)."""
        topo0, topo1 = _Topology(tree), _Topology(t1)
        topoA = _Topology(t2a) if t2a is not None else None
        topoB = _Topology(t2b) if t2b is not None else None
        perms = [np.asarray(p, np.int64) for p in
                 (perm1, permA if topoA else (), permB if topoB else ())]
        bl, freq, exch, u, nf, ne, eig, ctx, (p1, pA, pB) = self._sweep_inputs(
            topo0, model, draws, extra=perms)
        heat = float(heating_power)
        bl, freq, exch, ll0, flags, eig_cur = self._sweep_moves(
            topo0, bl, freq, exch, u, nf, ne, eig, ctx, draws.e0, heat)

        # --- Larget-Simon on the post-sweep parameters
        bl1 = bl.index_select(0, p1.long())
        bl1[ls_slot] = torch.clamp_min(bl1[ls_slot] * float(np.exp(np.float32(hp1))), 1e-8)
        ll1 = self._device_loglike(topo1, bl1, eig_cur, freq, ctx)
        acc5 = torch.log(u[6]) < heat * (ll1 - ll0) + hp1
        llb = torch.where(acc5, ll1, ll0)

        # --- speculative polytomy branches (from the accept and the reject state)
        def branch(topo, base, perm, new, vlen):
            if topo is None:
                return llb, base[:0]
            blx = base.index_select(0, perm.long())
            if new >= 0:
                blx[new] = vlen
            return self._device_loglike(topo, blx, eig_cur, freq, ctx), blx

        llA, blA = branch(topoA, bl1, pA, newA, vlenA)
        llB, blB = branch(topoB, bl, pB, newB, vlenB)
        ll2 = torch.where(acc5, llA, llB)
        hp2 = torch.where(acc5, float(hpA), float(hpB))
        ok2 = torch.where(acc5, topoA is not None, topoB is not None)
        logu2 = torch.where(acc5, float(np.log(np.float32(u2a))),
                            float(np.log(np.float32(u2b))))
        acc6 = ok2 & (logu2 < heat * (ll2 - llb) + hp2)
        ll_fin = torch.where(acc6, ll2, llb)
        flags = torch.stack([*flags, acc5, acc6]).to(DTYPE)
        packed = torch.cat([bl, freq, exch, ll_fin[None], flags, bl1, blA, blB])
        sizes = (topo0.n_edges, topo1.n_edges, len(blA), len(blB))
        return _Fetch(packed), sizes

    def full_iteration(self, tree, model, heating_power,
                       t1, perm1, ls_slot, hp1, u1,
                       t2a, permA, newA, vlenA, hpA, u2a,
                       t2b, permB, newB, vlenB, hpB, u2b,
                       defer_fetch: bool = False):
        """Run one FULL product-sampler iteration on the device (see
        _fiter_body): four continuous-parameter moves + Larget-Simon +
        speculative polytomy pair, one upload, one packed fetch. t2a/t2b may
        be None (that branch's polytomy move unavailable). perm arrays map
        each proposal tree's edge slots to its parent branch's slots;
        new*/vlen* place a freshly drawn edge (ADD moves). `u1` is the
        Larget-Simon accept uniform, drawn on the host with the proposal
        (the JAX program takes it and decides on a device draw instead).
        Returns a dict of post-iteration state (or, with defer_fetch, the
        pending (fetch, sizes) for _unpack_iteration after fetch.wait()):
        the caller replays the decisions onto its tree/model objects."""
        draws = self.draw_sweep(model, len(tree.edges()))
        draws.u = np.append(draws.u, u1)
        fetch, sizes = self._fiter_body(
            tree, model, heating_power, draws, t1, perm1, ls_slot, hp1,
            t2a, permA, newA, vlenA, hpA, u2a, t2b, permB, newB, vlenB, hpB, u2b)
        self._committed = None
        self._pending = None
        if defer_fetch:
            # multi-chain pipelining: the caller waits once for every chain
            # (MCMCSampler.run)
            return fetch, sizes
        return self._unpack_iteration(fetch.wait(), sizes)

    @staticmethod
    def _unpack_iteration(packed: np.ndarray, sizes):
        """[bl (E0), freq (4), exch (6), ll, 6 flags, bl_ls (E1), bl_a (EA),
        bl_b (EB)] -> dict; sizes = (E0, E1, EA, EB)."""
        e0, e1, ea, eb = sizes
        off = e0
        ends = np.cumsum([off + 17, e1, ea, eb])
        return {
            "bl_sweep": packed[:e0],
            "frequencies": packed[off: off + 4],
            "exchangeabilities": packed[off + 4: off + 10],
            "log_like": float(packed[off + 10]),
            "accepts": packed[off + 11: off + 17] > 0.5,
            "bl_ls": packed[ends[0]: ends[1]],
            "bl_a": packed[ends[1]: ends[2]],
            "bl_b": packed[ends[2]: ends[3]],
        }
