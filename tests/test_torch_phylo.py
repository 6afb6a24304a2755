"""The port's Bayesian phylogenetics path (kgl_gene_tpu_torch/phylo/)
against the JAX package's (kgl_gene_tpu/phylo/) on the CPU, at 4-8 taxa and
30-300 sites, inputs from numpy and random seeds; the port runs with
device="cpu".

Tolerances:
  - Host modules exact: Newick round trip, traversal_arrays, random_tree,
    Q and P, gamma rates, NEXUS read and write, splits and consensus,
    partition_log_likelihood, the codon model, the numpy log_likelihood.
  - Single device likelihoods (TreeLikelihood, CachedPartialsLikelihood
    full and path, topo_pair, VmappedChains._loglike) within 1e-4 relative
    of the JAX package's device programs and within 1e-2 absolute of the
    float64 host log_likelihood (both float32, summed in other orders).
  - topo_pair with the same u1/u2a/u2b, and the param_sweep, full_iteration
    and vmapped iteration bodies fed the JAX package's own draws: the same
    accept flags, and the packed vectors within 1e-4 (relative for
    log-likelihoods).
  - Transition matrices of the vmapped route within 1e-6 of the JAX _q_eigen
    route.
  - Seeded sampler parity (pooled_sweep=False): the same Newick at every
    sample as the JAX host and device samplers, log-likelihoods within 0.5
    of the host run and within 1e-3 of the device run; backend="host" in
    both packages writes identical sample files.
  - The port's own random streams, statistically: fused and sequential
    acceptance rates within 0.35, equilibrium log-likelihoods within 25, the
    log-likelihood a sweep reports within 0.05 of a recompute.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from kgl_gene_tpu.phylo import codon as j_codon
from kgl_gene_tpu.phylo import likelihood as j_lik
from kgl_gene_tpu.phylo import mcmc as j_mcmc
from kgl_gene_tpu.phylo import model as j_model
from kgl_gene_tpu.phylo import nexus as j_nexus
from kgl_gene_tpu.phylo import partition as j_part
from kgl_gene_tpu.phylo import strom as j_strom
from kgl_gene_tpu.phylo import summary as j_summary
from kgl_gene_tpu.phylo import tree as j_tree
from kgl_gene_tpu.phylo import vmapped as j_vm
from kgl_gene_tpu_torch.phylo import codon as t_codon
from kgl_gene_tpu_torch.phylo import likelihood as t_lik
from kgl_gene_tpu_torch.phylo import mcmc as t_mcmc
from kgl_gene_tpu_torch.phylo import model as t_model
from kgl_gene_tpu_torch.phylo import nexus as t_nexus
from kgl_gene_tpu_torch.phylo import partition as t_part
from kgl_gene_tpu_torch.phylo import strom as t_strom
from kgl_gene_tpu_torch.phylo import summary as t_summary
from kgl_gene_tpu_torch.phylo import tree as t_tree
from kgl_gene_tpu_torch.phylo import vmapped as t_vm

CPU = "cpu"
REL = 1e-4


def _data(n_taxa, n_sites, seed, n_frac=0.0):
    """(taxa, alignment codes, the starting tree's Newick) from seeds."""
    rng = np.random.default_rng(seed)
    taxa = [f"T{i}" for i in range(n_taxa)]
    aln = rng.integers(0, 4, size=(n_taxa, n_sites)).astype(np.uint8)
    if n_frac:
        aln[rng.random(aln.shape) < n_frac] = 4
    newick = j_tree.random_tree(taxa, random.Random(seed)).newick()
    return taxa, aln, newick


def _trees(newick, taxa):
    """The same tree in both packages, parsed from one Newick string."""
    return (j_tree.parse_newick(newick, leaf_order=taxa),
            t_tree.parse_newick(newick, leaf_order=taxa))


def _models(ex=(1.0, 2.5, 0.7, 1.3, 3.0, 1.0), pi=(0.3, 0.2, 0.15, 0.35), shape=0.8,
            n_rates=1, pinv=0.0):
    return (j_model.SubstitutionModel(np.array(ex), np.array(pi), shape, n_rates, pinv),
            t_model.SubstitutionModel(np.array(ex), np.array(pi), shape, n_rates, pinv))


def _close(got, want, rel=REL):
    assert abs(got - want) <= rel * abs(want), (got, want)


# --------------------------------------------------------------------------- #
# host modules: exact
# --------------------------------------------------------------------------- #
def test_newick_round_trip_and_traversal_arrays_equal():
    text = "((A:0.1,B:0.2):0.05,(C:0.3,(D:0.4,E:0.15):0.25):0.1,F:0.5);"
    jt, tt = j_tree.parse_newick(text), t_tree.parse_newick(text)
    assert tt.newick() == jt.newick()
    assert t_tree.parse_newick(tt.newick()).newick() == tt.newick()
    ja, ta = jt.traversal_arrays(), tt.traversal_arrays()
    assert ja.keys() == ta.keys()
    for key in ja:
        np.testing.assert_array_equal(np.asarray(ta[key]), np.asarray(ja[key]))
    assert tt.splits() == jt.splits()
    assert tt.copy().newick() == jt.copy().newick()


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_random_tree_equal(seed):
    taxa = [f"X{i}" for i in range(7)]
    jt = j_tree.random_tree(taxa, random.Random(seed))
    tt = t_tree.random_tree(taxa, random.Random(seed))
    assert tt.newick(precision=17) == jt.newick(precision=17)


@pytest.mark.parametrize("n_rates,pinv", [(1, 0.0), (4, 0.25)])
def test_q_p_and_gamma_rates_equal(n_rates, pinv):
    jm, tm = _models(n_rates=n_rates, pinv=pinv)
    np.testing.assert_array_equal(tm.q_matrix(), jm.q_matrix())
    for a, b in zip(tm.eigen(), jm.eigen()):
        np.testing.assert_array_equal(a, b)
    edges = np.array([1e-6, 0.01, 0.3, 2.0])
    np.testing.assert_array_equal(tm.transition_matrices(edges), jm.transition_matrices(edges))
    for shape in (0.2, 1.0, 5.0):
        np.testing.assert_array_equal(t_model.discrete_gamma_rates(shape, 4),
                                      j_model.discrete_gamma_rates(shape, 4))
    hj, ht = j_model.SubstitutionModel.hky85(2.0, [0.1, 0.2, 0.3, 0.4]), \
        t_model.SubstitutionModel.hky85(2.0, [0.1, 0.2, 0.3, 0.4])
    np.testing.assert_array_equal(ht.q_matrix(), hj.q_matrix())


def test_nexus_read_write_equal(tmp_path):
    taxa, aln, newick = _data(5, 37, 2, n_frac=0.05)
    letters = "ACGTN"
    path = tmp_path / "data.nex"
    with open(path, "w") as f:
        f.write("#NEXUS\n[comment]\nbegin data;\n  dimensions ntax=5 nchar=37;\n"
                "  format datatype=dna missing=? gap=-;\n  matrix\n")
        for name, row in zip(taxa, aln):
            seq = "".join(letters[c] for c in row)
            f.write(f"  {name} {seq[:20]}\n")
        for name, row in zip(taxa, aln):
            seq = "".join(letters[c] for c in row)
            f.write(f"  {name} {seq[20:]}\n")
        f.write("  ;\nend;\nbegin trees;\n  translate\n"
                + ",\n".join(f"    {i} {t}" for i, t in enumerate(taxa, 1)) + ";\n")
        numbered = newick
        for i, t in enumerate(taxa, 1):
            numbered = numbered.replace(f"{t}:", f"{i}:")
        f.write(f"  tree start = [&U] {numbered}\nend;\n")
    jd, td = j_nexus.read_nexus(str(path)), t_nexus.read_nexus(str(path))
    assert td.taxa == jd.taxa
    np.testing.assert_array_equal(td.alignment, jd.alignment)
    assert td.trees.keys() == jd.trees.keys()
    assert td.trees["start"].newick() == jd.trees["start"].newick()
    j_nexus.write_nexus_trees(str(tmp_path / "j.nex"), [("a", jd.trees["start"])])
    t_nexus.write_nexus_trees(str(tmp_path / "t.nex"), [("a", td.trees["start"])])
    assert (tmp_path / "t.nex").read_text() == (tmp_path / "j.nex").read_text()


def test_splits_and_consensus_equal():
    taxa = [f"S{i}" for i in range(6)]
    js, ts = j_summary.TreeSummary(), t_summary.TreeSummary()
    for seed in range(12):
        text = j_tree.random_tree(taxa, random.Random(seed % 4)).newick()
        js.add_tree(j_tree.parse_newick(text))
        ts.add_tree(t_tree.parse_newick(text))
    assert ts.split_frequencies() == js.split_frequencies()
    assert ts.best_topologies(3) == js.best_topologies(3)
    for threshold in (0.2, 0.5):
        assert ts.majority_consensus(threshold).newick() == \
            js.majority_consensus(threshold).newick()


def test_partition_log_likelihood_equal():
    taxa, aln, newick = _data(5, 60, 4)
    jt, tt = _trees(newick, taxa)
    jm, tm = _models(n_rates=2)
    jp = j_part.PartitionModel.by_codon_position(60, [jm, jm, jm])
    tp = t_part.PartitionModel.by_codon_position(60, [tm, tm, tm])
    jp.relative_rates = tp.relative_rates = np.array([0.5, 1.0, 1.5])
    jp._normalise(), tp._normalise()
    assert t_part.partition_log_likelihood(tt, aln, tp) == \
        j_part.partition_log_likelihood(jt, aln, jp)
    ll = j_part.partition_log_likelihood(jt, aln, jp)
    jr = j_part.update_subset_relrates(jt, aln, jp, ll, random.Random(3))
    tr = t_part.update_subset_relrates(tt, aln, tp, ll, random.Random(3))
    assert tr[1:] == jr[1:]
    np.testing.assert_array_equal(tr[0].relative_rates, jr[0].relative_rates)


def test_codon_model_equal():
    jm = j_codon.CodonSubstitutionModel(kappa=2.5, omega=0.3)
    tm = t_codon.CodonSubstitutionModel(kappa=2.5, omega=0.3)
    np.testing.assert_array_equal(tm.q_matrix(), jm.q_matrix())
    np.testing.assert_array_equal(tm.transition_matrix(0.2), jm.transition_matrix(0.2))
    rng = np.random.default_rng(8)
    dna = rng.integers(0, 5, size=(4, 90)).astype(np.uint8)
    states = t_codon.codon_alignment(dna, tm)
    np.testing.assert_array_equal(states, j_codon.codon_alignment(dna, jm))
    newick = j_tree.random_tree(["a", "b", "c", "d"], random.Random(1)).newick()
    jt, tt = _trees(newick, ["a", "b", "c", "d"])
    assert t_codon.codon_log_likelihood(tt, states, tm) == \
        j_codon.codon_log_likelihood(jt, states, jm)


@pytest.mark.parametrize("n_rates,pinv", [(1, 0.0), (4, 0.2)])
def test_host_log_likelihood_exact(n_rates, pinv):
    taxa, aln, newick = _data(6, 80, 5, n_frac=0.05)
    aln[:, :5] = 2  # constant columns for the invariant mixture
    jt, tt = _trees(newick, taxa)
    jm, tm = _models(n_rates=n_rates, pinv=pinv)
    assert t_lik.log_likelihood(tt, aln, tm) == j_lik.log_likelihood(jt, aln, jm)


# --------------------------------------------------------------------------- #
# single device likelihoods
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_rates,pinv", [(1, 0.0), (4, 0.2)])
def test_tree_likelihood_matches_jax(n_rates, pinv):
    taxa, aln, newick = _data(7, 150, 6, n_frac=0.05)
    aln[:, :7] = 1
    jt, tt = _trees(newick, taxa)
    jm, tm = _models(n_rates=n_rates, pinv=pinv)
    want = j_lik.TreeLikelihood(jt, aln, n_rates)(jt, jm)
    got = t_lik.TreeLikelihood(tt, aln, n_rates, device=CPU)(tt, tm)
    _close(got, want)
    assert abs(got - t_lik.log_likelihood(tt, aln, tm)) < 1e-2


@pytest.fixture(scope="module")
def cached_case():
    taxa, aln, newick = _data(8, 200, 7, n_frac=0.03)
    aln[:, :12] = 2  # constant columns for the invariant mixture
    aln[:, 12] = 4   # and an all-N column
    return taxa, aln, newick


@pytest.fixture(scope="module")
def jax_backend(cached_case):
    """One JAX CachedPartialsLikelihood per rate-category count over
    cached_case's alignment, so each of its programs compiles once."""
    made = {}

    def get(n_rates):
        if n_rates not in made:
            made[n_rates] = j_lik.CachedPartialsLikelihood(cached_case[1], n_rates)
        return made[n_rates]
    return get


@pytest.mark.parametrize("n_rates,pinv", [(1, 0.0), (3, 0.1)])
def test_cached_full_and_path_match_jax(cached_case, n_rates, pinv):
    taxa, aln, newick = cached_case
    jt, tt = _trees(newick, taxa)
    jm, tm = _models(n_rates=n_rates, pinv=pinv)
    jb = j_lik.CachedPartialsLikelihood(aln, n_rates)
    tb = t_lik.CachedPartialsLikelihood(aln, n_rates, device=CPU)
    j0, t0 = jb.loglike(jt, jm), tb.loglike(tt, tm)
    jb.on_accept(), tb.on_accept()
    _close(t0, j0)
    assert abs(t0 - t_lik.log_likelihood(tt, aln, tm)) < 1e-2
    for k, scale in ((3, 2.0), (9, 0.4), (0, 1.7)):
        jn, tn = jt.edges()[k], tt.edges()[k]
        jn.edge_length *= scale
        tn.edge_length *= scale
        j1 = jb.loglike(jt, jm, changed_node_index=jn.index)
        t1 = tb.loglike(tt, tm, changed_node_index=tn.index)
        _close(t1, j1)
        full = t_lik.CachedPartialsLikelihood(aln, n_rates, device=CPU).loglike(tt, tm)
        _close(t1, full, 1e-5)
        assert abs(t1 - t_lik.log_likelihood(tt, aln, tm)) < 1e-2
        jb.on_accept(), tb.on_accept()
    assert tb.path_evals == 3 and tb.full_evals == 1


def test_reject_keeps_committed_state(cached_case):
    taxa, aln, newick = cached_case
    _jt, tree = _trees(newick, taxa)
    _jm, model = _models()
    backend = t_lik.CachedPartialsLikelihood(aln, device=CPU)
    backend.loglike(tree, model)
    backend.on_accept()
    node = tree.edges()[1]
    keep = node.edge_length
    node.edge_length *= 3.0
    backend.loglike(tree, model, changed_node_index=node.index)
    backend.on_reject()
    node.edge_length = keep
    node2 = tree.edges()[4]
    node2.edge_length *= 1.3
    ll2 = backend.loglike(tree, model, changed_node_index=node2.index)
    assert backend.path_evals == 2
    fresh = t_lik.CachedPartialsLikelihood(aln, device=CPU).loglike(tree, model)
    _close(ll2, fresh, 1e-5)


def _proposals(taxa, aln, newick, seed):
    """A JAX chain's fused-iteration proposals (Larget-Simon, polytomy from
    the accept and the reject state), from a state parsed from `newick`."""
    jm, _ = _models()
    chain = j_mcmc.Chain(aln, j_mcmc.ChainState(j_tree.parse_newick(newick, taxa), jm),
                         rng=random.Random(seed), backend=None)
    return chain, chain._prepare_full_iteration()


def _port(tree, taxa):
    return None if tree is None else t_tree.parse_newick(tree.newick(precision=17), taxa)


@pytest.mark.parametrize("seed", [1, 2, 5])
def test_topo_pair_matches_jax(cached_case, jax_backend, seed):
    taxa, aln, newick = cached_case
    chain, prep = _proposals(taxa, aln, newick, seed)
    p1, h1, pa, pb = prep[0], prep[3], prep[5], prep[11]
    jm, tm = _models()
    jb = jax_backend(1)
    tb = t_lik.CachedPartialsLikelihood(aln, device=CPU)
    ll0 = jb.loglike(chain.state.tree, jm)
    rng = np.random.default_rng(seed)
    for heat in (1.0, 0.4):
        u1, u2a, u2b = rng.random(3)
        args = (heat, ll0, None, h1, None, pa[1] + pa[2] if pa else 0.0,
                None, pb[1] + pb[2] if pb else 0.0, u1, u2a, u2b)
        jargs = list(args)
        jargs[2], jargs[4], jargs[6] = p1.tree, pa[0].tree if pa else None, \
            pb[0].tree if pb else None
        targs = list(args)
        targs[2], targs[4], targs[6] = (_port(t, taxa) for t in jargs[2:7:2])
        ja1, ja2, jll = jb.topo_pair(jm, *jargs)
        ta1, ta2, tll = tb.topo_pair(tm, *targs)
        assert (ta1, ta2) == (ja1, ja2)
        _close(tll, jll)


# --------------------------------------------------------------------------- #
# the pooled programs, fed the JAX package's draws
# --------------------------------------------------------------------------- #
def _jax_sweep_draws(key, model, n_edges, n_uniforms):
    """The draws of one JAX sweep/fused iteration run with
    backend._sweep_key = key, as likelihood.py:1022 and :576-630 /
    :883-935 take them."""
    _, sub = jax.random.split(key)
    ks = jax.random.split(sub, 12)
    freq = jnp.asarray(model.frequencies, jnp.float32)
    ex = np.asarray(model.exchangeabilities, np.float64)
    exn = jnp.asarray(ex / ex.sum(), jnp.float32)
    exn = exn / jnp.sum(exn)
    e0 = int(jax.random.randint(ks[0], (), 0, n_edges))
    u = [float(jax.random.uniform(ks[i])) for i in (1, 2, 3, 4, 6, 8, 9)][:n_uniforms]
    nf = np.asarray(jax.random.dirichlet(ks[5], jnp.maximum(freq * 500.0, 1e-3)))
    ne = np.asarray(jax.random.dirichlet(ks[7], jnp.maximum(exn * 500.0, 1e-3)))
    return t_lik.SweepDraws(e0, np.array(u), nf, ne)


@pytest.mark.parametrize("heat,n_rates,pinv", [(1.0, 1, 0.0), (0.5, 1, 0.0), (1.0, 3, 0.0),
                                             (1.0, 1, 0.3)])
def test_sweep_body_with_jax_draws(cached_case, jax_backend, heat, n_rates, pinv):
    taxa, aln, newick = cached_case
    jt, tt = _trees(newick, taxa)
    jm, tm = _models(n_rates=n_rates, pinv=pinv)
    jb = jax_backend(n_rates)
    tb = t_lik.CachedPartialsLikelihood(aln, n_rates, device=CPU)
    flags = []
    for seed in range(4):
        key = jax.random.PRNGKey(100 + seed)
        jb._sweep_key = key
        want = jb.param_sweep(jt, jm, heat)
        draws = _jax_sweep_draws(key, jm, len(tt.edges()), 6)
        packed = tb._sweep_body(tt, tm, heat, draws).wait()
        E = len(tt.edges())
        np.testing.assert_array_equal(packed[E + 11: E + 15] > 0.5, want["accepts"])
        np.testing.assert_allclose(packed[:E], want["edge_lengths"], rtol=1e-4)
        np.testing.assert_allclose(packed[E: E + 10],
                                   np.concatenate([want["frequencies"],
                                                   want["exchangeabilities"]]), atol=1e-4)
        _close(float(packed[E + 10]), want["log_like"])
        flags.append(want["accepts"])
    assert np.asarray(flags).any() and not np.asarray(flags).all()


@pytest.mark.parametrize("seed,pinv", [(1, 0.0), (3, 0.0), (4, 0.25), (6, 0.0)])
def test_full_iteration_body_with_jax_draws(cached_case, jax_backend, seed, pinv):
    taxa, aln, newick = cached_case
    chain, prep = _proposals(taxa, aln, newick, seed)
    (p1, perm1, ls_slot, h1, u1, pa, permA, newA, vlenA, hpA,
     u2a, pb, permB, newB, vlenB, hpB, u2b, _ra, _rb) = prep
    jm, tm = _models(pinv=pinv)
    jb = jax_backend(1)
    key = jax.random.PRNGKey(7 + seed)
    jb._sweep_key = key
    tree = chain.state.tree
    want = jb.full_iteration(tree, jm, 1.0, p1.tree, perm1, ls_slot, h1, u1,
                             pa[0].tree if pa else None, permA, newA, vlenA, hpA, u2a,
                             pb[0].tree if pb else None, permB, newB, vlenB, hpB, u2b)
    tb = t_lik.CachedPartialsLikelihood(aln, device=CPU)
    draws = _jax_sweep_draws(key, jm, len(tree.edges()), 7)
    fetch, sizes = tb._fiter_body(
        _port(tree, taxa), tm, 1.0, draws, _port(p1.tree, taxa), perm1, ls_slot, h1,
        _port(pa[0].tree if pa else None, taxa), permA, newA, vlenA, hpA, u2a,
        _port(pb[0].tree if pb else None, taxa), permB, newB, vlenB, hpB, u2b)
    got = tb._unpack_iteration(fetch.wait(), sizes)
    np.testing.assert_array_equal(got["accepts"], want["accepts"])
    _close(got["log_like"], want["log_like"])
    for name in ("frequencies", "exchangeabilities"):
        np.testing.assert_allclose(got[name], want[name], atol=1e-4)
    for name in ("bl_sweep", "bl_ls", "bl_a", "bl_b"):
        n = len(got[name])
        np.testing.assert_allclose(got[name], want[name][:n], rtol=1e-4)
    assert sizes[2] > 0 and sizes[3] > 0


# --------------------------------------------------------------------------- #
# vmapped chains
# --------------------------------------------------------------------------- #
def test_transition_matrices_match_jax_q_eigen():
    rng = np.random.default_rng(9)
    C, E = 3, 7
    exch = rng.dirichlet(np.full(6, 3.0), size=C)
    freq = rng.dirichlet(np.full(4, 5.0), size=C)
    bl = rng.exponential(0.3, size=(C, E))
    bl[0, 0], bl[1, 1], bl[2, 2] = 1e-8, 4.0, 25.0
    rates = j_model.discrete_gamma_rates(0.7, 4)
    pair = torch.as_tensor(t_vm._PAIR_OF_CELL)
    Q = t_vm.q_matrices(torch.as_tensor(exch, dtype=torch.float32),
                        torch.as_tensor(freq, dtype=torch.float32), pair)
    got = t_vm.transition_matrices(Q, torch.as_tensor(bl, dtype=torch.float32),
                                   torch.as_tensor(rates)).numpy()
    for c in range(C):
        lam, V, Vinv = j_vm._q_eigen(jnp.asarray(exch[c], jnp.float32),
                                     jnp.asarray(freq[c], jnp.float32))
        t = jnp.asarray(bl[c], jnp.float32)[:, None, None] * jnp.asarray(rates, jnp.float32)[None, :, None]
        want = np.asarray(jnp.einsum("ik,erk,kj->erij", V, jnp.exp(lam[None, None, :] * t), Vinv))
        np.testing.assert_allclose(got[:, c], want, atol=1e-6)


@pytest.mark.parametrize("t", [1e-9, 1e-3, 0.7, 30.0, 3e3])
def test_expm_matches_scipy(t):
    """exp(Q t) of GTR rate matrices against scipy's expm: the fixed
    scaling and squaring holds 1e-10 absolute from tiny to saturated t."""
    rng = np.random.default_rng(int(-np.log10(t) + 20))
    Q = np.stack([j_model.SubstitutionModel(rng.dirichlet(np.full(6, 2.0)),
                                            rng.dirichlet(np.full(4, 4.0))).q_matrix()
                  for _ in range(5)])
    got = t_vm._expm(torch.as_tensor(Q * t)).numpy()
    for q, g in zip(Q, got):
        np.testing.assert_allclose(g, scipy.linalg.expm(q * t), rtol=0, atol=1e-10)


def test_dirichlet_mt_moments():
    g = torch.Generator().manual_seed(4)
    n, K = 40_000, 8
    alpha = torch.tensor([[120.0, 60.0, 3.0, 0.4]]).expand(n, 4)
    x = t_vm.dirichlet_mt(alpha, torch.randn((n, 4, K), generator=g),
                          torch.rand((n, 4, K), generator=g),
                          torch.rand((n, 4), generator=g)).double().numpy()
    a = alpha[0].double().numpy()
    a0 = a.sum()
    mean, var = a / a0, a * (a0 - a) / (a0 * a0 * (a0 + 1))
    np.testing.assert_allclose(x.mean(0), mean, atol=4 * np.sqrt(var / n).max())
    np.testing.assert_allclose(x.var(0), var, rtol=0.05)
    np.testing.assert_allclose(x.sum(1), 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def vmapped_case():
    taxa, aln, newick = _data(6, 120, 11)
    jt, tt = _trees(newick, taxa)
    jc = j_vm.VmappedChains(jt, aln, n_chains=3, n_rate_categories=2, gamma_shape=0.6)
    tc = t_vm.VmappedChains(tt, aln, n_chains=3, n_rate_categories=2, gamma_shape=0.6,
                            device=CPU)
    return taxa, aln, jt, tt, jc, tc


def _carry(jc, tc):
    tc.set_params(*(np.asarray(x) for x in jc.params))


def test_vmapped_loglike_matches_jax(vmapped_case):
    taxa, aln, jt, tt, jc, tc = vmapped_case
    rng = np.random.default_rng(3)
    jc2 = jc.params._replace(
        edge_lengths=jnp.asarray(rng.exponential(0.2, size=jc.params.edge_lengths.shape),
                                 jnp.float32),
        frequencies=jnp.asarray(rng.dirichlet(np.full(4, 8.0), size=3), jnp.float32),
        exchangeabilities=jnp.asarray(rng.dirichlet(np.full(6, 8.0), size=3), jnp.float32))
    want = np.asarray(jax.jit(jc._loglike)(jc2))
    tc.set_params(*(np.asarray(x) for x in jc2))
    got = tc._loglike(tc.params).numpy()
    np.testing.assert_allclose(got, want, rtol=REL)
    for c in range(3):
        host_tree = t_tree.parse_newick(tt.newick(precision=17), taxa)
        for e, length in zip(host_tree.edges(), np.asarray(jc2.edge_lengths)[c]):
            e.edge_length = float(length)
        model = t_model.SubstitutionModel(np.asarray(jc2.exchangeabilities[c], np.float64),
                                          np.asarray(jc2.frequencies[c], np.float64), 0.6, 2)
        assert abs(got[c] - t_lik.log_likelihood(host_tree, aln, model)) < 1e-2


def test_vmapped_iterations_with_jax_draws(vmapped_case):
    """Four JAX iterations (_run with n_iters=1, key carried) replayed
    through the port's deterministic _iteration with the same draws."""
    taxa, aln, jt, tt, jc, tc = vmapped_case
    run1 = jax.jit(lambda p, k: jc._run(p, k, 1))
    params, key = jc.params, jax.random.PRNGKey(21)
    _carry(jc, tc)
    tparams = tc.params
    tll = tc._loglike(tparams)
    C, E = jc.n_chains, jc.n_edges
    for _ in range(4):
        keys = jax.random.split(key, 10)
        _k, k_edge, k_fac, k_acc, k_tl, k_tacc, k_freq, k_facc, k_swap, k_sacc = keys
        u = np.stack([np.asarray(jax.random.uniform(k, (C,)))
                      for k in (k_fac, k_acc, k_tl, k_tacc, k_facc)], 1)
        alpha = jnp.maximum(params.frequencies * 500.0, 1e-3)
        new_freqs = np.asarray(jax.random.dirichlet(k_freq, alpha))
        edge = np.asarray(jax.random.randint(k_edge, (C,), 0, E))
        swap_i = np.asarray([jax.random.randint(k_swap, (), 0, C - 1)])
        swap_u = np.asarray([jax.random.uniform(k_sacc)])
        params, jll, key, _trace = run1(params, key)
        tparams, tll = tc._iteration(tparams, tll, torch.as_tensor(edge),
                                     torch.as_tensor(u), torch.as_tensor(new_freqs),
                                     torch.as_tensor(swap_i), torch.as_tensor(swap_u))
        np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=REL)
        for got, want in zip(tparams, params):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_vmapped_run_own_stream_improves(vmapped_case):
    taxa, aln, jt, tt, jc, _tc = vmapped_case
    tc = t_vm.VmappedChains(tt, aln, n_chains=3, seed=5, device=CPU)
    start = float(tc._loglike(tc.params)[0])
    trace = tc.run(40)
    assert trace.shape == (40,) and np.isfinite(trace).all()
    assert trace[-1] > start
    again = t_vm.VmappedChains(tt, aln, n_chains=3, seed=5, device=CPU).run(40)
    np.testing.assert_array_equal(again, trace)


def test_set_params_rejects_bad_shapes(vmapped_case):
    tc = vmapped_case[5]
    with pytest.raises(ValueError):
        tc.set_params(np.zeros((3, 2)), np.zeros((3, 4)), np.zeros((3, 6)))


# --------------------------------------------------------------------------- #
# samplers
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def sampler_case():
    taxa, aln, newick = _data(8, 120, 5)
    return taxa, aln, newick


def _run(pkg, taxa, aln, newick, backend, pooled_sweep=True, iters=24, chains=2, seed=9,
         **kw):
    mcmc, tree, model = ((j_mcmc, j_tree, j_model) if pkg == "jax"
                         else (t_mcmc, t_tree, t_model))
    np.random.seed(42)  # the host Dirichlet proposals draw from the global RNG
    init = mcmc.ChainState(tree.parse_newick(newick, taxa),
                           model.SubstitutionModel(np.ones(6), np.full(4, 0.25), 1.0, 1, 0.0))
    s = mcmc.MCMCSampler(aln, init, n_chains=chains, seed=seed, backend=backend,
                         pooled_sweep=pooled_sweep, **kw)
    return s, s.run(iters, sample_freq=4, burn_in=0)


def test_seeded_sampler_parity(sampler_case):
    taxa, aln, newick = sampler_case
    _, host = _run("jax", taxa, aln, newick, "host")
    _, jdev = _run("jax", taxa, aln, newick, "device", pooled_sweep=False)
    s, tdev = _run("torch", taxa, aln, newick, "device", pooled_sweep=False, device=CPU)
    assert len(host) == len(jdev) == len(tdev) == 6
    for h, j, t in zip(host, jdev, tdev):
        assert t["newick"] == h["newick"] == j["newick"]
        assert abs(t["log_like"] - h["log_like"]) < 0.5
        assert abs(t["log_like"] - j["log_like"]) < 1e-3
    assert s.cold_chain.backend.path_evals > 0


def test_host_backend_sample_files_identical(tmp_path, sampler_case):
    taxa, aln, newick = sampler_case
    outs = {}
    for pkg in ("jax", "torch"):
        s, samples = _run(pkg, taxa, aln, newick, "host", iters=20)
        s.write_params(str(tmp_path / f"{pkg}.p.tsv"))
        nexus = j_nexus if pkg == "jax" else t_nexus
        tree = j_tree if pkg == "jax" else t_tree
        nexus.write_nexus_trees(str(tmp_path / f"{pkg}.t.nex"),
                                [(f"s{x['iteration']}", tree.parse_newick(x["newick"]))
                                 for x in samples])
        outs[pkg] = [(tmp_path / f"{pkg}.{ext}").read_text() for ext in ("p.tsv", "t.nex")]
    assert outs["torch"] == outs["jax"]


def _rates(s):
    c = s.cold_chain
    return {k: c.accept_counts[k] / max(c.try_counts[k], 1)
            for k in ("branch_length", "tree_length", "state_freq", "exchangeability",
                      "larget_simon")}


def test_fused_vs_sequential_statistics():
    taxa, aln, newick = _data(6, 120, 3)
    runs = {}
    for pooled, seed in ((True, 5), (False, 6)):
        s, _ = _run("torch", taxa, aln, newick, "device", pooled_sweep=pooled, iters=150,
                    chains=1, seed=seed, device=CPU)
        runs[pooled] = (_rates(s), s.cold_chain.state.log_like, s)
    (r_f, ll_f, s_f), (r_s, ll_s, _s) = runs[True], runs[False]
    for k in r_f:
        assert abs(r_f[k] - r_s[k]) < 0.35, (k, r_f, r_s)
    assert abs(ll_f - ll_s) < 25.0
    chain = s_f.cold_chain
    assert chain.try_counts["larget_simon"] == 150 and chain.try_counts["state_freq"] == 150
    # the host state mirrors the device decisions: a recompute on it gives
    # the log-likelihood the last fused iteration reported
    assert abs(chain.backend.loglike(chain.state.tree, chain.state.model)
               - chain.state.log_like) < 0.05


def test_sweep_ll_consistent_with_recompute():
    taxa, aln, newick = _data(6, 120, 3)
    tree = t_tree.parse_newick(newick, taxa)
    _jm, model = _models()
    be = t_lik.CachedPartialsLikelihood(aln, device=CPU, seed=4)
    for _ in range(3):
        res = be.param_sweep(tree, model, heating_power=1.0)
        for i, e in enumerate(tree.edges()):
            e.edge_length = float(res["edge_lengths"][i])
        model.frequencies = np.asarray(res["frequencies"], np.float64)
        model.exchangeabilities = np.asarray(res["exchangeabilities"], np.float64) \
            * float(np.sum(model.exchangeabilities))
        assert abs(res["log_like"] - be.loglike(tree, model)) < 0.05


def test_heated_chains_pipelined(sampler_case):
    taxa, aln, newick = sampler_case
    s, samples = _run("torch", taxa, aln, newick, "device", iters=10, chains=3, device=CPU)
    tips = s.chains[0].backend.tips
    assert all(c.backend.tips is tips for c in s.chains[1:])
    for c in s.chains:
        assert c.try_counts["larget_simon"] == 10 and c.try_counts["branch_length"] == 10
        assert np.isfinite(c.state.log_like)
    assert s.swap_attempts == 2 and len(samples) == 2


# --------------------------------------------------------------------------- #
# the two reference faults the port does not carry
# --------------------------------------------------------------------------- #
def test_chain_that_cannot_dispatch_advances_others_once(sampler_case, monkeypatch):
    """mcmc.py:744-752: the reference collects the chains already
    dispatched and then runs next_step() on every chain, so those advance
    two iterations; in the port every chain advances one."""
    taxa, aln, newick = sampler_case
    s, _ = _run("torch", taxa, aln, newick, "device", iters=0, chains=3, device=CPU)
    monkeypatch.setattr(s.chains[1], "dispatch_full_iteration", lambda: None)
    s.run(4, sample_freq=100, swap_freq=100)
    for c in s.chains:
        assert c.try_counts["branch_length"] == 4, [x.try_counts for x in s.chains]
        assert c.try_counts["tree_length"] == 4


def test_polytomy_accept_uniform_drawn_only_with_a_proposal(sampler_case, monkeypatch):
    """mcmc.py:505-506: the reference draws u2a/u2b even when that branch
    has no polytomy proposal, so its realized stream leaves the sequential
    path's; the port draws each only with its proposal."""
    taxa, aln, newick = sampler_case
    s, _ = _run("torch", taxa, aln, newick, "device", iters=0, chains=1, device=CPU)
    chain = s.cold_chain
    real = chain._propose_polytomy
    monkeypatch.setattr(chain, "_propose_polytomy",
                        lambda base, rng, annotate=False: None if base is chain.state
                        else real(base, rng, annotate))
    prep = chain._prepare_full_iteration()
    pa, u2a, pb, u2b, rng_a, rng_b = prep[5], prep[10], prep[11], prep[16], prep[17], prep[18]
    assert pb is None and u2b == 0.0
    assert rng_b.getstate() == chain.rng.getstate()  # nothing drawn for the reject branch
    assert pa is not None and rng_a.getstate() != chain.rng.getstate()
    monkeypatch.setattr(chain, "_propose_polytomy", lambda base, rng, annotate=False: None)
    prep = chain._prepare_full_iteration()
    assert prep[10] == prep[16] == 0.0
    assert prep[17].getstate() == prep[18].getstate() == chain.rng.getstate()


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #
def test_state_from_numpy_carries_the_jax_state(sampler_case):
    taxa, aln, newick = sampler_case
    jm, _ = _models(n_rates=2, pinv=0.1)
    js = j_mcmc.ChainState(j_tree.parse_newick(newick, taxa), jm)
    ts = t_mcmc.state_from_numpy(js.tree.newick(precision=17), jm.exchangeabilities,
                                 jm.frequencies, jm.gamma_shape, jm.n_rate_categories,
                                 jm.p_invariant, leaf_order=js.tree.leaf_names)
    assert ts.tree.newick(precision=17) == js.tree.newick(precision=17)
    assert ts.tree.leaf_names == js.tree.leaf_names
    assert t_lik.log_likelihood(ts.tree, aln, ts.model) == \
        j_lik.log_likelihood(js.tree, aln, js.model)
    with pytest.raises(ValueError):
        t_mcmc.state_from_numpy(newick, np.ones(5), np.full(4, 0.25))


def test_entry_points_run_on_the_card_unless_asked(sampler_case):
    """With no device argument every entry point takes the card; where there
    is none it raises instead of running on the CPU."""
    taxa, aln, newick = sampler_case
    tree = t_tree.parse_newick(newick, taxa)
    makers = [
        lambda: t_lik.TreeLikelihood(tree, aln),
        lambda: t_lik.CachedPartialsLikelihood(aln),
        lambda: t_vm.VmappedChains(tree, aln, n_chains=2),
        lambda: t_mcmc.MCMCSampler(aln, t_mcmc.ChainState(tree, t_model.SubstitutionModel())),
    ]
    for make in makers:
        if torch.cuda.is_available():
            obj = make()
            assert getattr(obj, "device", None) is None or obj.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError):
                make()
    host = t_mcmc.MCMCSampler(aln, t_mcmc.ChainState(tree, t_model.SubstitutionModel()),
                              backend="host")
    assert host.chains[0].backend is None
    with pytest.raises(ValueError):
        t_mcmc.MCMCSampler(aln, t_mcmc.ChainState(tree, t_model.SubstitutionModel()),
                           backend="auto", device=CPU)


def _write_data_nexus(path, taxa, aln):
    letters = "ACGTN"
    with open(path, "w") as f:
        f.write(f"#NEXUS\nbegin data;\n  dimensions ntax={len(taxa)} nchar={aln.shape[1]};\n"
                "  format datatype=dna;\n  matrix\n")
        for name, row in zip(taxa, aln):
            f.write(f"  {name} {''.join(letters[c] for c in row)}\n")
        f.write("  ;\nend;\n")


def test_strom_end_to_end_on_the_cpu(tmp_path):
    taxa, aln, _ = _data(6, 90, 12, n_frac=0.02)
    data = tmp_path / "data.nex"
    _write_data_nexus(data, taxa, aln)
    prefix = str(tmp_path / "run")
    assert t_strom.main(["-d", str(data), "--niter", "30", "--samplefreq", "5",
                         "--burnin", "10", "--nchains", "2", "--seed", "3",
                         "--output", prefix, "--device", "cpu"]) == 0
    rows = open(prefix + ".p.tsv").read().splitlines()
    assert rows[0].startswith("iteration\tlogL") and len(rows) == 1 + 4
    assert all(np.isfinite(float(r.split("\t")[1])) for r in rows[1:])
    trees = t_nexus.read_nexus(prefix + ".t.nex").trees
    assert len(trees) == 4
    assert all(set(t.leaf_names) == set(taxa) for t in trees.values())


def test_strom_host_backend_matches_jax(tmp_path):
    taxa, aln, _ = _data(5, 60, 13)
    data = tmp_path / "data.nex"
    _write_data_nexus(data, taxa, aln)
    texts = []
    for strom in (j_strom, t_strom):
        prefix = str(tmp_path / strom.__name__.split(".")[0])
        np.random.seed(5)
        strom.main(["-d", str(data), "--niter", "20", "--samplefreq", "5", "--burnin", "0",
                    "--seed", "2", "--output", prefix, "--backend", "host"])
        texts.append([open(prefix + ext).read() for ext in (".p.tsv", ".t.nex")])
    assert texts[0] == texts[1]


def test_port_phylo_imports_no_jax():
    import ast
    from pathlib import Path

    root = Path(t_lik.__file__).parent
    for path in root.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "kgl_gene_tpu"), (path, name)
    assert os.path.basename(str(root)) == "phylo"
