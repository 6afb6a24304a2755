"""NEXUS file IO: DATA/CHARACTERS and TREES blocks.

Capability parity with the kpl NEXUS reading (kpl_geneticdata.h via the
NCL library, kpl_tree_io.h): parse the DATA block MATRIX into aligned
sequences (DNA), honour the TAXA dimensions, and read/write TREES blocks
with taxon translation tables.

Copy of kgl_gene_tpu/phylo/nexus.py: Python on the host.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..sequence.alphabet import DNA5
from ..utils.logging import log
from .tree import PhyloTree, parse_newick

__all__ = ["NexusData", "read_nexus", "write_nexus_trees"]


class NexusData:
    def __init__(self, taxa: List[str], alignment: np.ndarray,
                 trees: Optional[Dict[str, PhyloTree]] = None):
        self.taxa = taxa
        self.alignment = alignment  # (n_taxa, n_sites) uint8 DNA5 codes
        self.trees = trees or {}

    @property
    def n_taxa(self) -> int:
        return len(self.taxa)

    @property
    def n_sites(self) -> int:
        return self.alignment.shape[1] if self.alignment.size else 0


def read_nexus(path: str) -> NexusData:
    with open(path) as f:
        text = f.read()
    # Strip comments [..].
    text = re.sub(r"\[[^\]]*\]", "", text)
    lower = text.lower()
    if not lower.lstrip().startswith("#nexus"):
        raise ValueError("not a NEXUS file")

    taxa: List[str] = []
    sequences: Dict[str, str] = {}
    trees: Dict[str, PhyloTree] = {}

    # MATRIX inside data/characters block.
    matrix_match = re.search(r"matrix(.*?);", lower, re.S)
    if matrix_match:
        body = text[matrix_match.start(1) : matrix_match.end(1)]
        for line in body.splitlines():
            line = line.strip()
            if not line:
                continue
            parts = line.split(None, 1)
            if len(parts) != 2:
                continue
            name, seq = parts
            name = name.strip("'\"")
            seq = seq.replace(" ", "")
            if name not in sequences:
                taxa.append(name)
                sequences[name] = seq
            else:  # interleaved continuation
                sequences[name] += seq

    # translate table (trees block).
    translate: Dict[str, str] = {}
    translate_match = re.search(r"translate(.*?);", lower, re.S)
    if translate_match:
        body = text[translate_match.start(1) : translate_match.end(1)]
        for item in body.split(","):
            parts = item.split()
            if len(parts) >= 2:
                translate[parts[0]] = parts[1].strip("'\"")

    for match in re.finditer(r"tree\s+(\S+)\s*=\s*(?:\[&[RU]\]\s*)?([^;]+);", text,
                             re.IGNORECASE):
        name, newick_text = match.group(1), match.group(2)
        if translate:
            # Replace numeric taxon labels (word boundaries before : , ) ).
            newick_text = re.sub(
                r"(?<=[(,])(\w+)(?=[:,)])",
                lambda m: translate.get(m.group(1), m.group(1)),
                newick_text,
            )
        try:
            trees[name] = parse_newick(newick_text + ";")
        except (ValueError, IndexError) as exc:
            log().warn("NEXUS tree {} parse failed: {}", name, exc)

    if sequences:
        lengths = {len(s) for s in sequences.values()}
        if len(lengths) != 1:
            raise ValueError(f"unaligned NEXUS matrix: lengths {sorted(lengths)}")
        alignment = np.stack([DNA5.from_string(sequences[t].upper().replace("-", "N").replace("?", "N"))
                              for t in taxa])
    else:
        alignment = np.zeros((0, 0), dtype=np.uint8)
    return NexusData(taxa, alignment, trees)


def write_nexus_trees(path: str, trees: List[Tuple[str, PhyloTree]]) -> None:
    """Write a TREES block with a translate table (the kpl tree sample
    output format)."""
    if not trees:
        return
    taxa = trees[0][1].leaf_names
    with open(path, "w") as f:
        f.write("#NEXUS\n\nbegin trees;\n  translate\n")
        for i, taxon in enumerate(taxa, 1):
            sep = "," if i < len(taxa) else ";"
            f.write(f"    {i} {taxon}{sep}\n")
        index = {t: str(i) for i, t in enumerate(taxa, 1)}
        for name, tree in trees:
            newick = tree.newick()
            for taxon in sorted(taxa, key=len, reverse=True):
                newick = re.sub(
                    rf"(?<=[(,]){re.escape(taxon)}(?=[:,)])", index[taxon], newick
                )
            f.write(f"  tree {name} = [&U] {newick}\n")
        f.write("end;\n")
