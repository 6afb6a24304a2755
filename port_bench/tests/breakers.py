"""What the tests put in the program's place: the controls and the faults.

A patch takes the driver's Cell after set-up and replaces its `program`,
the call the window drives, so a run goes on exactly as a real one but
with the timed path broken underneath.

Controls (the reference in the program's place, one stated guarantee
broken):
  forward_step: the SNP slots written in reverse order, so the first valid
      slot at a position wins (the last-valid-wins guarantee broken: what a
      step would do that scattered without masking overridden slots);
  pair_matrix: the upper triangle alone, the mirror into the lower one left
      out (the symmetry guarantee broken: what a matrix would do whose host
      assembly was cut to the half the tree reads). The Hamming distance in
      place of the edit distance is no control here: on these haplotypes,
      a few substitutions apart, the two seldom differ.
Faults (the program's own outputs, broken where they are produced):
  stale: each call returns the outputs of the call before it;
  half: only the first half of the batch is computed, the rest copied from
      it, and the allele counts are the first half's doubled;
  altered: one answer changed where it is produced (a genome's distance,
      or one entry in 128 of the matrix, in both halves).
The exchange between cards is not a fault of these cells: each runs on
one card.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from port_bench.drivers.forward_step import PORT_AMINO_LETTERS
from port_bench.reference.dp import pair_distances
from port_bench.reference.gene import step_outputs

__all__ = ["CONTROLS", "FAULTS"]


def _step_control(cell):
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


def _matrix_control(cell):
    cache = {}

    def program(seqs):
        key = id(seqs)
        if key not in cache:
            s = torch.as_tensor(seqs, device=cell.device)
            n = s.shape[0]
            out = np.zeros((n, n), dtype=np.float64)
            out[cell.iu, cell.ju] = pair_distances(s[cell.iu], s[cell.ju],
                                                   local=cell.local).cpu().numpy()
            cache[key] = out  # the lower triangle is never filled
        return cache[key]

    cell.program = program


def _stale(cell):
    real = cell.program
    last = [None]

    def program(*args):
        out = real(*args)
        prev, last[0] = last[0], out
        return out if prev is None else prev

    last[0] = real(*(cell.sets[-1] if isinstance(cell.sets[-1], tuple) else (cell.sets[-1],)))
    cell.program = program


def _half_step(cell):
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


def _half_matrix(cell):
    real = cell.program

    def program(seqs):
        h = seqs.shape[0] // 2
        return real(np.concatenate([seqs[:h], seqs[: seqs.shape[0] - h]]))

    cell.program = program


def _altered_step(cell):
    real = cell.program

    def program(*args):
        out = real(*args)
        distance = out.distance.clone()
        distance[0] += 1
        return out._replace(distance=distance)

    cell.program = program


def _altered_matrix(cell):
    real = cell.program

    def program(seqs):
        m = real(seqs).copy()
        iu, ju = np.triu_indices(m.shape[0], k=1)
        iu, ju = iu[::128], ju[::128]
        m[iu, ju] += 1
        m[ju, iu] += 1
        return m

    cell.program = program


CONTROLS = {"forward_step": _step_control, "pair_matrix": _matrix_control}
FAULTS = {
    "forward_step": {"stale": _stale, "half": _half_step, "altered": _altered_step},
    "pair_matrix": {"stale": _stale, "half": _half_matrix, "altered": _altered_matrix},
}
