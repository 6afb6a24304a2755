"""The port's forward step (kgl_gene_tpu_torch/ops/pipeline.py) against
the JAX make_forward_step on the CPU: all six ForwardOutputs fields must
be exactly equal, with the JAX step run both through its Pallas kernels
(interpret mode) and without them, in both distance branches (Myers when
K <= 127 and S >= 512, the wavefront otherwise) and on both strands. The
SNP batches hold duplicate positions, as the bench's do."""

import numpy as np
import pytest
import torch

from kgl_gene_tpu.ops.pipeline import make_forward_step as j_make
from kgl_gene_tpu_torch.ops import pipeline as tp

LONG_REGION = np.random.default_rng(7).integers(0, 4, size=1200).astype(np.uint8)
LONG_EXONS = np.array([[100, 400], [500, 800]], dtype=np.int64)  # S = 600


def _batch(seed, B, K, L):
    rng = np.random.default_rng(seed)
    positions = rng.integers(0, L, size=(B, K)).astype(np.int32)
    positions[:, -2:] = positions[:, :2]  # duplicate positions in every sample
    alt = rng.integers(0, 4, size=(B, K)).astype(np.uint8)
    valid = rng.random((B, K)) < 0.8
    return positions, alt, valid


def _assert_equal(j_out, t_out):
    assert t_out._fields == j_out._fields
    for field in j_out._fields:
        j = np.asarray(getattr(j_out, field))
        t = getattr(t_out, field)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        t = t.numpy()
        assert t.dtype == j.dtype, (field, t.dtype, j.dtype)
        np.testing.assert_array_equal(t, j, err_msg=field)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("K", [12, 40])  # bands 31 and 63: the Myers branch
def test_myers_branch_matches_jax(K, reverse, use_pallas):
    args = _batch(K, 8, K, len(LONG_REGION))
    j_out = j_make(LONG_REGION, LONG_EXONS, 0, reverse_strand=reverse,
                   use_pallas=use_pallas)(*args)
    t_out = tp.make_forward_step(LONG_REGION, LONG_EXONS, 0, reverse_strand=reverse,
                                 device="cpu")(*args)
    _assert_equal(j_out, t_out)
    assert int(t_out.distance.max()) <= K


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_wavefront_branch_k_over_127_matches_jax(reverse, use_pallas):
    args = _batch(3, 4, 130, len(LONG_REGION))
    j_out = j_make(LONG_REGION, LONG_EXONS, 0, reverse_strand=reverse,
                   use_pallas=use_pallas)(*args)
    t_out = tp.make_forward_step(LONG_REGION, LONG_EXONS, 0, reverse_strand=reverse,
                                 device="cpu")(*args)
    _assert_equal(j_out, t_out)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_entry_shapes_match_jax(reverse, use_pallas):
    """The entry() geometry (S = 120 < 512): the wavefront branch."""
    import __graft_entry__ as g
    from kgl_gene_tpu_torch.entry import example_batch, example_geometry

    region, exons = g._example_geometry()
    t_region, t_exons = example_geometry()
    np.testing.assert_array_equal(t_region, region)
    np.testing.assert_array_equal(t_exons, exons)
    args = g._example_batch(8, 6, len(region))
    for got, want in zip(example_batch(8, 6, len(region)), args):
        np.testing.assert_array_equal(got, want)
    j_out = j_make(region, exons, 0, reverse_strand=reverse, use_pallas=use_pallas)(*args)
    t_out = tp.make_forward_step(region, exons, 0, reverse_strand=reverse,
                                 device="cpu")(*args)
    _assert_equal(j_out, t_out)


def test_entry_matches_graft_entry():
    import __graft_entry__ as g
    from kgl_gene_tpu_torch.entry import entry

    j_fn, j_args = g.entry()
    t_fn, t_args = entry(device="cpu")
    _assert_equal(j_fn(*j_args), t_fn(*t_args))


@pytest.mark.parametrize("table_name", ["NCBI_TABLE_2", "NCBI_TABLE_4"])
def test_other_tables_and_region_start(table_name):
    """Another genetic code, and exon intervals given in contig
    coordinates with a region start."""
    args = _batch(5, 6, 20, len(LONG_REGION))
    exons = LONG_EXONS + 1000
    j_out = j_make(LONG_REGION, exons, 1000, table_name=table_name)(*args)
    t_out = tp.make_forward_step(LONG_REGION, exons, 1000, table_name=table_name,
                                 device="cpu")(*args)
    _assert_equal(j_out, t_out)


def test_band_choice():
    """Band 31, 63 or 127 by the number of SNP slots; above 127, none."""
    from kgl_gene_tpu_torch.ops.myers import myers_band_for

    got = [myers_band_for(k, max_band=127) for k in (1, 31, 32, 63, 64, 127, 128)]
    assert got == [31, 31, 63, 63, 127, 127, None]


def test_default_device_is_the_card():
    """Without device='cpu' the step needs a card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.make_forward_step(LONG_REGION, LONG_EXONS, 0)
