"""The plain reference agrees with the port's plain CPU route and its numpy
oracles at small sizes, and with a full DP on random substitution pairs."""

import numpy as np
import pytest
import torch

from kgl_gene_tpu_torch.ops.edit_distance import (
    batched_levenshtein, batched_levenshtein_local, levenshtein_local_numpy, levenshtein_numpy,
)
from kgl_gene_tpu_torch.ops.pipeline import make_forward_step
from kgl_gene_tpu_torch.sequence.alphabet import AminoAcid
from kgl_gene_tpu_torch.sequence.tables import amino_translation_table
from port_bench import generate
from port_bench.reference import dp, gene


def substituted(rng, n_pairs, length, max_subs, alphabet=4):
    a = rng.integers(0, alphabet, size=(n_pairs, length))
    b = a.copy()
    for r in range(n_pairs):
        k = int(rng.integers(0, max_subs + 1))
        sites = rng.choice(length, k, replace=False)
        b[r, sites] = rng.integers(0, alphabet, k)
    return a, b


@pytest.mark.parametrize("length,alphabet", [(1, 2), (7, 2), (25, 3), (60, 4)])
def test_banded_dp_equals_the_full_dp(length, alphabet):
    rng = np.random.default_rng(length)
    a, b = substituted(rng, 40, length, length, alphabet)
    g = dp.pair_distances(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    loc = dp.pair_distances(torch.as_tensor(a), torch.as_tensor(b), local=True).numpy()
    assert g.tolist() == [levenshtein_numpy(x, y) for x, y in zip(a, b)]
    assert loc.tolist() == [levenshtein_local_numpy(x, y) for x, y in zip(a, b)]


def test_banded_dp_equals_the_ports_plain_batched_routes():
    rng = np.random.default_rng(5)
    a, b = substituted(rng, 24, 300, 40)
    ta, tb = torch.as_tensor(a, dtype=torch.int32), torch.as_tensor(b, dtype=torch.int32)
    lens = torch.full((24,), 300, dtype=torch.int32)
    assert dp.pair_distances(ta, tb).tolist() == batched_levenshtein(ta, lens, tb, lens).tolist()
    assert dp.pair_distances(ta, tb, local=True).tolist() == \
        batched_levenshtein_local(ta, lens, tb, lens).tolist()


def test_the_frozen_table_is_ncbi_table_1_as_the_port_reads_it():
    aminos, starts = gene.TABLE
    port = amino_translation_table("NCBI_TABLE_1")
    assert "".join(AminoAcid.LETTERS[c] for c in port.amino_lut[:64]) == "".join(aminos)
    assert np.array_equal(port.start_lut[:64], starts)


@pytest.mark.parametrize("region_len,exons,strand,B,K", [
    (2181, [[0, 2181]], "-", 48, 8),                   # the cell's gene: B1 at band 31
    (4800, [[400, 1900], [2400, 3900]], "-", 12, 48),  # two exons on the reverse strand
    (480, [[40, 190], [240, 390]], "+", 24, 160),      # a short gene: B3
])
def test_step_reference_equals_the_ports_cpu_step(region_len, exons, strand, B, K):
    config = {"region_len": region_len, "exons": exons, "strand": strand}
    region = generate.gene_region(generate.rng_for(3, 0), config)
    traffic = {"genomes": B, "slots": K, "valid_p": 0.8, "sets": 2}
    step = make_forward_step(region, np.array(exons), 0, reverse_strand=strand == "-",
                             device="cpu")
    letters = np.frombuffer(AminoAcid.LETTERS.encode(), dtype=np.uint8)
    for positions, alt, valid in generate.snp_sets(generate.rng_for(3, 1), traffic, region_len):
        got = step(positions, alt, valid)
        want = gene.step_outputs(torch.as_tensor(region), [tuple(e) for e in exons],
                                 *(torch.as_tensor(x) for x in (positions, alt, valid)),
                                 reverse=strand == "-")
        for name in ("distance", "validity_code", "valid_protein", "allele_counts"):
            assert np.array_equal(getattr(got, name).numpy().astype(np.int64),
                                  want[name].numpy().astype(np.int64)), name
        assert np.array_equal(letters[got.amino.numpy()], want["amino"].numpy())
        assert len(set(want["validity_code"].tolist())) > 1


def test_first_wins_differs_only_where_slots_collide():
    region = torch.zeros(10, dtype=torch.uint8)
    pos = torch.tensor([[3, 3, 5]])
    alt = torch.tensor([[1, 2, 3]], dtype=torch.uint8)
    valid = torch.ones(1, 3, dtype=torch.bool)
    assert gene.apply_snps(region, pos, alt, valid)[0, 3] == 2
    assert gene.apply_snps(region, pos, alt, valid, first_wins=True)[0, 3] == 1


def test_the_gene_is_read_on_its_strand():
    config = {"region_start": 100, "region_len": 12, "exons": [[102, 105], [107, 110]],
              "strand": "-"}
    region = generate.gene_region(generate.rng_for(1, 0), config)
    coding = generate.coding_of(region, config)
    assert coding.tolist()[:3] == [0, 3, 2] and coding.tolist()[3:] == [3, 0, 0]  # ATG, TAA
    spliced = np.concatenate([region[2:5], region[7:10]])
    assert (3 - spliced[::-1]).tolist() == coding.tolist()
