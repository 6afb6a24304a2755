"""The port's variant apply, splice, strand conversion and translation
(kgl_gene_tpu_torch/ops/variant_apply.py) against the JAX package's
(kgl_gene_tpu/ops/variant_apply.py), on the CPU. Everything is integer,
so outputs must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgl_gene_tpu.ops import variant_apply as jva
from kgl_gene_tpu.sequence.alphabet import DNA5
from kgl_gene_tpu.sequence.tables import TABLE_NAMES, amino_translation_table
from kgl_gene_tpu_torch.ops import variant_apply as tva


def _snp_inputs(seed, B=6, K=12, L=40):
    rng = np.random.default_rng(seed)
    # few distinct positions, so duplicates are common; some out of range
    # and some negative (counted from the end, as a JAX scatter does)
    positions = rng.integers(-L - 3, L + 3, size=(B, K)).astype(np.int32)
    positions[:, K // 2 :] = rng.integers(0, 5, size=(B, K - K // 2))
    alt = rng.integers(0, 4, size=(B, K)).astype(np.uint8)
    valid = rng.random((B, K)) < 0.7
    region = rng.integers(0, 5, size=L).astype(np.uint8)
    return region, positions, alt, valid


def test_apply_snp_last_valid_slot_wins():
    region = np.zeros(10, np.uint8)
    pos = np.array([[3, 3, 3]], np.int32)
    alt = np.array([[3, 2, 1]], np.uint8)
    for valid, want in (([True, True, True], 1), ([True, True, False], 2),
                        ([True, False, False], 3), ([False, False, False], 0)):
        v = np.array([valid])
        j = np.asarray(jva.apply_snp_batch(jnp.asarray(region), pos, alt, v))
        t = tva.apply_snp_batch(torch.as_tensor(region), torch.as_tensor(pos),
                                torch.as_tensor(alt), torch.as_tensor(v)).numpy()
        assert j[0, 3] == want
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("seed", range(4))
def test_apply_snp_matches_jax_with_duplicates_and_masks(seed):
    region, pos, alt, valid = _snp_inputs(seed)
    j = np.asarray(jva.apply_snp_batch(jnp.asarray(region), pos, alt, valid))
    t = tva.apply_snp_batch(torch.as_tensor(region), torch.as_tensor(pos),
                            torch.as_tensor(alt), torch.as_tensor(valid))
    assert t.dtype == torch.uint8
    np.testing.assert_array_equal(t.numpy(), j)


def test_splice_and_reverse_complement_match_jax():
    rng = np.random.default_rng(3)
    exons = np.array([[105, 130], [140, 170]], np.int64)
    idx_j = jva.build_splice_index(exons, 100)
    idx_t = tva.build_splice_index(exons, 100)
    np.testing.assert_array_equal(idx_t, idx_j)
    mutated = rng.integers(0, 5, size=(4, 80)).astype(np.uint8)
    sp_j = np.asarray(jva.gather_splice(jnp.asarray(mutated), jnp.asarray(idx_j)))
    sp_t = tva.gather_splice(torch.as_tensor(mutated), idx_t)
    np.testing.assert_array_equal(sp_t.numpy(), sp_j)
    rc_j = np.asarray(jva.reverse_complement_batch(
        jnp.asarray(sp_j), jnp.asarray(DNA5.COMPLEMENT)))
    rc_t = tva.reverse_complement_batch(sp_t)
    assert rc_t.dtype == torch.uint8
    np.testing.assert_array_equal(rc_t.numpy(), rc_j)
    np.testing.assert_array_equal(rc_t.numpy(), DNA5.COMPLEMENT[sp_j[:, ::-1]])


@pytest.mark.parametrize("table_name", TABLE_NAMES)
def test_translate_matches_jax_all_tables(table_name):
    rng = np.random.default_rng(11)
    coding = rng.integers(0, 4, size=(5, 3 * 37 + 2)).astype(np.uint8)
    coding[rng.random(coding.shape) < 0.05] = 4  # codons holding N
    lut = amino_translation_table(table_name).amino_lut
    j_idx = np.asarray(jva._codon_index(jnp.asarray(coding)))
    t_idx = tva._codon_index(torch.as_tensor(coding))
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    j_plain = np.asarray(jva.translate_batch(jnp.asarray(coding), jnp.asarray(lut)))
    j_pallas = np.asarray(jva.translate_batch_pallas(
        jnp.asarray(coding), jnp.asarray(lut), interpret=True))
    t_plain = tva.translate_batch(torch.as_tensor(coding), torch.as_tensor(lut))
    t_wrap = tva.translate_batch_kernel(torch.as_tensor(coding), torch.as_tensor(lut))
    for got in (t_plain, t_wrap):
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), j_plain)
        np.testing.assert_array_equal(got.numpy(), j_pallas)


@pytest.mark.parametrize("B,S", [(4, 3 * 16), (3, 3 * 21 + 1), (3, 3 * 21 + 2), (1, 3 * 33),
                                 (1, 50), (5, 2), (5, 1), (2, 0), (0, 9)])
def test_translate_ragged_widths_match_jax(B, S):
    """S % 3 in {1, 2} drops the 1-2 trailing bases of each row; S < 3
    gives k = 0 columns; B = 1 and an empty batch keep their shapes."""
    rng = np.random.default_rng(100 * B + S)
    coding = rng.integers(0, 5, size=(B, S)).astype(np.uint8)
    lut = amino_translation_table("NCBI_TABLE_1").amino_lut
    want = np.asarray(jva.translate_batch(jnp.asarray(coding), jnp.asarray(lut)))
    assert want.shape == (B, S // 3)
    for fn in (tva.translate_batch, tva.translate_batch_kernel):
        got = fn(torch.as_tensor(coding), torch.as_tensor(lut))
        assert got.dtype == torch.uint8 and tuple(got.shape) == (B, S // 3)
        np.testing.assert_array_equal(got.numpy(), want)
    if B and S >= 3:
        j_pallas = np.asarray(jva.translate_batch_pallas(
            jnp.asarray(coding), jnp.asarray(lut), interpret=True))
        np.testing.assert_array_equal(j_pallas, want)


def test_translate_wrapper_refuses_non_cpu_tensors_it_cannot_launch():
    coding = torch.zeros(2, 9, dtype=torch.uint8, device="meta")
    lut = torch.zeros(65, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="on the card"):
        tva.translate_batch_kernel(coding, lut)


@pytest.mark.parametrize("seed", range(3))
def test_last_valid_slots_leaves_unique_positions(seed):
    """The card's scatter has no defined winner among duplicate indices,
    so the slots it sees must be unique: the last kept slot per position."""
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.integers(0, 6, size=(5, 16)))
    keep = torch.as_tensor(rng.random((5, 16)) < 0.7)
    out = tva.last_valid_slots(pos, keep)
    for b in range(5):
        kept = pos[b][out[b]].tolist()
        assert len(kept) == len(set(kept))
        for p in set(pos[b][keep[b]].tolist()):
            last = max(k for k in range(16) if keep[b, k] and pos[b, k] == p)
            assert bool(out[b, last])
