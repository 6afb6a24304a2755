"""Square text (TSV/CSV) parser.

Capability parity with SquareTextParser/SquareTextRows
(kgl_genomics/kgl_parser/kgl_square_parser.h:45,109): parse a delimited
text file into rows of fields, verify a constant field count, optional
header handling. The base of every tabular resource parser.

Copy of kgl_gene_tpu/io/square_parser.py.
"""

from __future__ import annotations

from typing import List, Optional

from ..utils.logging import log
from .streams import open_text_stream

__all__ = ["SquareTextRows", "parse_square_text"]

TAB = "\t"
COMMA = ","


class SquareTextRows:
    def __init__(self, rows: List[List[str]]):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def verify_field_count(self, expected: int) -> bool:
        """checkRowSize: every row must have the expected field count."""
        bad = [i for i, row in enumerate(self.rows) if len(row) != expected]
        if bad:
            log().warn(
                "square text: {} rows with field count != {} (first at row {})",
                len(bad), expected, bad[0],
            )
            return False
        return True


def parse_square_text(
    path: str,
    delimiter: str = TAB,
    skip_comments: str = "#",
    header: bool = False,
) -> SquareTextRows:
    """Parse the file; returns rows (header row dropped if header=True)."""
    rows: List[List[str]] = []
    with open_text_stream(path) as stream:
        for line in stream:
            line = line.rstrip("\n")
            if not line or (skip_comments and line.startswith(skip_comments)):
                continue
            rows.append(line.split(delimiter))
    if header and rows:
        rows = rows[1:]
    return SquareTextRows(rows)
