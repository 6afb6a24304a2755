"""Test hooks of the forward-step driver's cells (see cells/__init__.py).

Control: the SNP slots written in reverse order, so the first valid slot
at a position wins (the last-valid-wins guarantee broken: what a step
would do that scattered without masking overridden slots). It differs
from the program only where two valid slots of a genome meet at one
position, hence CONTROL_SMALL's 4,096 genomes.
Faults (the program's own outputs, broken where they are produced):
  stale: each call returns the outputs of the call before it;
  half: only the first half of the batch is computed, the rest copied from
      it, and the allele counts are the first half's doubled;
  altered: one genome's distance changed where it is produced.
The exchange between cards is not a fault of these cells: each runs on
one card.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from port_bench import generate
from port_bench.drivers.forward_step import PORT_AMINO_LETTERS
from port_bench.reference.gene import step_outputs
from port_bench.tests.cells._gene import check_gene

GENERATORS = ("snp_sets",)
SMALL = {"genomes": 32, "sets": 2, "amino_rows": 8}
CONTROL_SMALL = {"genomes": 4096, "sets": 2, "amino_rows": 16}


def control(cell):
    letters = torch.tensor(list(PORT_AMINO_LETTERS.encode()), dtype=torch.int64)
    codes = torch.zeros(256, dtype=torch.uint8)
    codes[letters] = torch.arange(len(letters), dtype=torch.uint8)
    region = torch.as_tensor(cell.region, device=cell.device)
    cache = {}

    def program(positions, alt, valid):
        key = id(positions)
        if key not in cache:
            args = (torch.as_tensor(x, device=cell.device) for x in (positions, alt, valid))
            want = step_outputs(region, cell.exons, *args, first_wins=True, reverse=cell.reverse)
            want["amino"] = codes.to(cell.device)[want["amino"].to(torch.int64)]
            cache[key] = SimpleNamespace(**want)
        return cache[key]

    cell.program = program


def stale(cell):
    real = cell.program
    last = [real(*cell.sets[-1])]

    def program(*args):
        out = real(*args)
        prev, last[0] = last[0], out
        return prev

    cell.program = program


def half(cell):
    real = cell.program

    def program(positions, alt, valid):
        h = positions.shape[0] // 2
        out = real(positions[:h], alt[:h], valid[:h])
        reps = -(-positions.shape[0] // h)

        def fill(x):
            return x.repeat(reps)[: positions.shape[0]]

        return SimpleNamespace(distance=fill(out.distance), validity_code=fill(out.validity_code),
                               valid_protein=fill(out.valid_protein),
                               allele_counts=out.allele_counts * 2,
                               amino=out.amino.repeat(reps, 1)[: positions.shape[0]])

    cell.program = program


def altered(cell):
    real = cell.program

    def program(*args):
        out = real(*args)
        distance = out.distance.clone()
        distance[0] += 1
        return out._replace(distance=distance)

    cell.program = program


FAULTS = {"stale": stale, "half": half, "altered": altered}


def work_of(config, traffic, inputs):
    _region, sets = inputs
    B, K = sets[0][0].shape
    assert all(s[0].shape == (B, K) for s in sets)
    return {"genomes": B, "slots": K, "sets": len(sets)}


def check_inputs(config, traffic, inputs, reads):
    """The gene's reading frame; and where the cell reads kernel B1's
    roofline, the port's own rule sends the step to B1: a band of at most
    127 for the traffic's slots, over a gene long enough to band. A traffic
    past B1's bands takes the unbanded kernel, and is held to no route."""
    from kgl_gene_tpu_torch.ops.myers import myers_band_for
    from kgl_gene_tpu_torch.ops.pipeline import MIN_BANDED_LEN

    region, _sets = inputs
    check_gene(config, region)
    if any(name.split(".")[0] == "b1_roofline_pct" for name in reads):
        assert myers_band_for(traffic["slots"], max_band=127) is not None
        assert len(generate.coding_of(region, config)) >= MIN_BANDED_LEN


def port_spans(traffic):
    return ["kgt.step"] + [f"kgt.step.{s}" for s in
                           ("upload", "apply", "translate", "distance", "checks")]
