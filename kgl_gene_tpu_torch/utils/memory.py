"""Memory audit utilities.

Capability parity with AuditMemory (kel_utility/kel_mem_alloc.h:29): the
reference counts new/delete to catch leaks and trims the free store; in
Python the equivalents are allocation snapshots (tracemalloc), live-object
accounting for the big array types, and gc + malloc_trim-style compaction.

Copy of kgl_gene_tpu/utils/memory.py.
"""

from __future__ import annotations

import gc
import tracemalloc
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["AuditMemory"]


class AuditMemory:
    """Static audit facade."""

    _snapshot: Optional[tracemalloc.Snapshot] = None

    @staticmethod
    def start_audit() -> None:
        if not tracemalloc.is_tracing():
            tracemalloc.start()
        AuditMemory._snapshot = tracemalloc.take_snapshot()

    @staticmethod
    def audit_delta(top: int = 10):
        """Top allocation growth since start_audit."""
        if AuditMemory._snapshot is None:
            return []
        current = tracemalloc.take_snapshot()
        return current.compare_to(AuditMemory._snapshot, "lineno")[:top]

    @staticmethod
    def trim_free_store() -> int:
        """Release free memory (gc + malloc_trim via ctypes when available);
        returns collected object count."""
        collected = gc.collect()
        try:
            import ctypes

            libc = ctypes.CDLL("libc.so.6")
            libc.malloc_trim(0)
        except OSError:
            pass
        return collected

    @staticmethod
    def traced_bytes() -> Tuple[int, int]:
        """(current, peak) traced allocation bytes since start_audit — the
        live-object accounting telemetry (object_count_ analogue). Plain
        ndarrays are not gc-tracked, so tracemalloc is the accurate probe."""
        if not tracemalloc.is_tracing():
            return 0, 0
        return tracemalloc.get_traced_memory()
