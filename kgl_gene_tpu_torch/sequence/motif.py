"""Sequence motif search: promoter/TF binding motifs over DNA sequences.

Capability parity with SequenceMotif (kgl_sequence/kgl_sequence_motif.h)
and the RNA motif search of the legacy analyses (kgl_rna_search.h): IUPAC
degenerate motif patterns compiled to regex over sequence text, returning
match intervals.

Copy of kgl_gene_tpu/sequence/motif.py.
"""

from __future__ import annotations

from typing import List, Union

from ..utils.intervals import OpenRightInterval
from ..utils.search import search_view
from .sequence import DNA5SequenceCoding, DNA5SequenceLinear

__all__ = ["iupac_to_regex", "find_motifs", "find_promoter_motifs"]

_IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T", "U": "T",
    "R": "[AG]", "Y": "[CT]", "S": "[GC]", "W": "[AT]",
    "K": "[GT]", "M": "[AC]", "B": "[CGT]", "D": "[AGT]",
    "H": "[ACT]", "V": "[ACG]", "N": "[ACGTN]",
}


def iupac_to_regex(motif: str) -> str:
    """Translate a degenerate IUPAC motif into a regex."""
    return "".join(_IUPAC.get(ch.upper(), ch) for ch in motif)


def find_motifs(sequence, motif: str) -> List[OpenRightInterval]:
    """All occurrences of an IUPAC motif in a sequence."""
    text = sequence.to_string() if hasattr(sequence, "to_string") else str(sequence)
    return search_view(iupac_to_regex(motif), text)


# The reference's prime example: the malaria promoter TATA-like element.
TATA_BOX = "TATAWAW"


def find_promoter_motifs(sequence, upstream_of: int, window: int = 1000,
                         motif: str = TATA_BOX) -> List[OpenRightInterval]:
    """Search the window upstream of a gene start for a promoter motif;
    intervals are in contig coordinates."""
    start = max(0, upstream_of - window)
    sub = sequence.subsequence(start, upstream_of - start)
    return [iv.translate(start) for iv in find_motifs(sub, motif)]
