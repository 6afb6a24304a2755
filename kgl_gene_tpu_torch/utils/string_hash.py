"""Compile-time-style string hashing (kel_utility/kel_string_hash.h
parity): CRC32-based stable string hashes usable as switch keys and for
deterministic dataset fingerprints.

Copy of kgl_gene_tpu/utils/string_hash.py.
"""

from __future__ import annotations

import zlib

__all__ = ["string_hash", "combine_hash"]


def string_hash(text: str) -> int:
    """Stable 32-bit CRC hash of a string."""
    return zlib.crc32(text.encode("utf-8")) & 0xFFFFFFFF


def combine_hash(seed: int, value: int) -> int:
    """Order-dependent hash combiner (boost::hash_combine style)."""
    return (seed ^ (value + 0x9E3779B9 + ((seed << 6) & 0xFFFFFFFF) + (seed >> 2))) & 0xFFFFFFFF
