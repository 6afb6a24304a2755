"""Each traffic mix fixes the amount of work: at three seeds the same
genomes, slots, haplotypes, pairs and route; the seed picks values only."""

import json

import numpy as np
import pytest

from port_bench import generate, run

MANIFEST = json.loads((run.ROOT / "BENCHMARK.json").read_text())
SEEDS = (1, 2**31 + 11, 2**40 + 3)


def work_of(config, traffic, sets):
    """The amounts of work a run of these inputs makes, and the route."""
    if traffic["generator"] == "snp_sets":
        B, K = sets[0][0].shape
        assert all(s[0].shape == (B, K) for s in sets)
        return {"genomes": B, "slots": K, "sets": len(sets)}
    n, S = sets[0].shape
    return {"haplotypes": n, "bases": S, "pairs": n * (n - 1) // 2, "sets": len(sets),
            "metric": traffic["metric"], "band": traffic.get("band")}


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_work_is_the_same_at_every_seed(workload):
    _cell, config, traffic = run.cell_files(MANIFEST, workload)
    works, firsts = [], []
    for seed in SEEDS:
        region, sets = generate.inputs(seed, config, traffic)
        works.append(work_of(config, traffic, sets))
        firsts.append(sets[0][0] if isinstance(sets[0], tuple) else sets[0])
        coding = generate.coding_of(region, config)
        codons = coding.reshape(-1, 3) @ np.array([16, 4, 1])
        assert codons[0] == generate.START_CODON and codons[-1] == generate.END_CODON
        assert not np.isin(codons[1:-1], generate.STOP_CODONS).any()
        if traffic["generator"] == "haplotype_sets":
            for haps in sets:
                assert ((haps != coding[None, :]).sum(1) <= traffic["slots"]).all()
                assert len(np.unique(haps, axis=0)) == len(haps)
    assert works[0] == works[1] == works[2]
    assert not np.array_equal(firsts[0], firsts[1])  # the seed changes the values


def test_the_routes_the_cells_name():
    from kgl_gene_tpu_torch.analysis.lib_seqmutation import DEVICE_BAND
    from kgl_gene_tpu_torch.ops.myers import myers_band_for

    step = json.loads((run.BENCH / "traffic/cohort.json").read_text())
    assert myers_band_for(step["slots"], max_band=127) == 31  # the port's rule: B1 at band 31
    near = json.loads((run.BENCH / "traffic/near.json").read_text())
    # the analysis's own band; every pair of the family is at most 2 x 8 apart, inside it
    assert near["band"] == DEVICE_BAND and 2 * near["slots"] <= near["band"]


def test_the_gene_is_read_on_its_strand():
    config = {"region_start": 100, "region_len": 12, "exons": [[102, 105], [107, 110]],
              "strand": "-"}
    region = generate.gene_region(generate.rng_for(1, 0), config)
    coding = generate.coding_of(region, config)
    assert coding.tolist()[:3] == [0, 3, 2] and coding.tolist()[3:] == [3, 0, 0]  # ATG, TAA
    spliced = np.concatenate([region[2:5], region[7:10]])
    assert (3 - spliced[::-1]).tolist() == coding.tolist()
