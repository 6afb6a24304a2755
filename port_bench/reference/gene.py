"""The plain reference of the forward step: what the port's step returns
to the host, worked out again from the harness's own inputs.

For one batch of genomes against one gene:
  1. each genome's valid SNP slots are written into the region in slot
     order, so where several valid slots name one position the last wins;
  2. the exons are spliced in order, and for a gene on the reverse strand
     the splice is reverse-complemented;
  3. the codons are translated by the frozen NCBI table in this folder
     (`amino`, as ASCII letters);
  4. the validity code is 3 when the first amino acid is not one that a
     start codon of the table codes for, else 2 when a stop lies before
     the last codon, else 1 when the last codon is not a stop, else 0; the
     protein is valid when the code is 0;
  5. the distance is the Levenshtein distance of the mutant's coding
     sequence to the gene's (dp.pair_distances);
  6. the allele count of slot k is the number of genomes whose slot k is
     valid.
`first_wins` writes the slots in reverse order instead: the control that
breaks the last-valid-wins guarantee.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path

import numpy as np
import torch

from .dp import pair_distances

__all__ = ["TABLE", "apply_snps", "step_outputs", "translate"]

_TABLE_FILE = Path(__file__).resolve().parent / "ncbi_table_1.json"
_CODE_OF_BASE = {"A": 0, "C": 1, "G": 2, "T": 3}


def _load_table():
    raw = json.loads(_TABLE_FILE.read_text())
    aminos = np.zeros(64, dtype="<U1")
    starts = np.zeros(64, dtype=bool)
    for i, triple in enumerate(itertools.product(raw["bases"], repeat=3)):
        c = _CODE_OF_BASE[triple[0]] * 16 + _CODE_OF_BASE[triple[1]] * 4 + _CODE_OF_BASE[triple[2]]
        aminos[c] = raw["aminos"][i]
        starts[c] = raw["starts"][i] == "M"
    return aminos, starts


TABLE = _load_table()  # (amino letter by codon number over A=0 C=1 G=2 T=3, start codons)


def apply_snps(region: torch.Tensor, positions, alt, valid, first_wins: bool = False):
    """(B, L) uint8 mutated regions: each valid slot's alt code at its
    position, the slots written in order (last wins), or in reverse order
    with first_wins."""
    B, K = positions.shape
    out = region.to(torch.uint8).expand(B, -1).clone()
    rows = torch.arange(B, device=out.device)
    order = range(K - 1, -1, -1) if first_wins else range(K)
    for k in order:
        m = valid[:, k]
        out[rows[m], positions[m, k].to(torch.int64)] = alt[m, k].to(torch.uint8)
    return out


def translate(coding: torch.Tensor):
    """(B, S // 3) amino letters as uint8 ASCII, and (B, S // 3) bool
    stops, by the frozen table; the codes are bases 0..3 only."""
    aminos, _ = TABLE
    lut = torch.as_tensor(np.frombuffer("".join(aminos).encode(), dtype=np.uint8).copy(),
                          device=coding.device)
    B, S = coding.shape
    cod = coding[:, : S - S % 3].reshape(B, -1, 3).to(torch.int64)
    amino = lut[cod[..., 0] * 16 + cod[..., 1] * 4 + cod[..., 2]]
    return amino, amino == ord("*")


def _on_strand(spliced: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The spliced bases read on the gene's strand (codes 0..3)."""
    return (3 - spliced.flip(-1)).to(spliced.dtype) if reverse else spliced


def step_outputs(region, exons, positions, alt, valid, first_wins: bool = False,
                 reverse: bool = False):
    """Reference outputs of one step, as tensors on region's device: dict
    distance (B,), validity_code (B,), valid_protein (B,), allele_counts
    (K,) as int64 / bool, and amino (B, S // 3) uint8 ASCII letters.
    exons: (lo, hi) offsets into the region; reverse: the gene lies on the
    reverse strand."""
    aminos, starts = TABLE
    start_aminos = torch.as_tensor(
        np.frombuffer("".join(sorted(set(aminos[starts]))).encode(), dtype=np.uint8).copy(),
        device=region.device)
    mutated = apply_snps(region, positions, alt, valid, first_wins)
    coding = _on_strand(torch.cat([mutated[:, lo:hi] for lo, hi in exons], 1), reverse)
    ref_coding = _on_strand(torch.cat([region[lo:hi] for lo, hi in exons]), reverse)
    amino, stop = translate(coding)
    no_start = ~torch.isin(amino[:, 0], start_aminos)
    internal = stop[:, :-1].any(1)
    no_stop = ~stop[:, -1]
    code = torch.where(no_start, 3, torch.where(internal, 2, torch.where(no_stop, 1, 0)))
    distance = pair_distances(coding, ref_coding[None, :].expand_as(coding))
    return {
        "distance": distance,
        "validity_code": code.to(torch.int64),
        "valid_protein": code == 0,
        "allele_counts": valid.to(torch.int64).sum(0),
        "amino": amino,
    }
