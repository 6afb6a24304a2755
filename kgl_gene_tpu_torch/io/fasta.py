"""FASTA reader/writer producing code-array sequences.

Capability parity with ParseFasta (kgl_genomics/kgl_genome_io/kgl_io_fasta.h):
reads plain or compressed FASTA into DNA5SequenceLinear contigs. The byte ->
code conversion is a single vectorized LUT gather over the concatenated
contig bytes rather than a per-line loop.

Copy of kgl_gene_tpu/io/fasta.py.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from ..sequence.alphabet import DNA5
from ..sequence.sequence import DNA5SequenceLinear
from ..utils.logging import log
from .streams import open_text_stream

__all__ = ["read_fasta", "write_fasta"]


def read_fasta(path: str) -> Iterator[Tuple[str, DNA5SequenceLinear]]:
    """Yield (contig_id, sequence) pairs. The contig id is the first token
    of the description line."""
    contig_id = None
    chunks: List[bytes] = []
    with open_text_stream(path) as stream:
        for line in stream:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(">"):
                if contig_id is not None:
                    yield contig_id, _assemble(chunks)
                contig_id = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            elif line.startswith(";"):
                continue  # old-style comment
            else:
                if contig_id is None:
                    log().warn("FASTA {}: sequence data before first header ignored", path)
                    continue
                chunks.append(line.encode("ascii"))
    if contig_id is not None:
        yield contig_id, _assemble(chunks)


def _assemble(chunks: List[bytes]) -> DNA5SequenceLinear:
    raw = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    return DNA5SequenceLinear(DNA5.CHAR_TO_CODE[raw])


def write_fasta(path: str, records, line_width: int = 80) -> None:
    """Write (id, sequence-like) records; sequences may be DNA5SequenceLinear,
    coding or amino sequences (anything with to_string())."""
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            text = seq.to_string() if hasattr(seq, "to_string") else str(seq)
            for start in range(0, len(text), line_width):
                f.write(text[start : start + line_width] + "\n")
