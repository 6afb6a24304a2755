"""General utilities: tokenizing, paths, process resource probes.

Capability parity with kel_utility/kel_utility.h:21,46-52 (Utility class):
string tokenizers (the VCF hot-path splitters), file-path helpers, and
process memory / CPU-time probes used by the run report.

Copy of kgl_gene_tpu/utils/utility.py.
"""

from __future__ import annotations

import os
import resource
import time
from typing import List

__all__ = [
    "tokenize",
    "char_tokenize",
    "trim_ends",
    "file_exists",
    "file_extension",
    "file_name",
    "process_mem_usage",
    "process_time_usage",
]


def tokenize(text: str, delimiter: str) -> List[str]:
    """Split on a (possibly multi-char) delimiter (Utility::tokenizer)."""
    return text.split(delimiter)


def char_tokenize(text: str, delimiter: str) -> List[str]:
    """Split on a single character (Utility::charTokenizer)."""
    return text.split(delimiter)


def trim_ends(text: str) -> str:
    return text.strip()


def file_exists(path: str) -> bool:
    return os.path.isfile(path)


def file_extension(path: str) -> str:
    return os.path.splitext(path)[1].lstrip(".")


def file_name(path: str) -> str:
    return os.path.basename(path)


def process_mem_usage() -> tuple:
    """(vm_usage_mb, resident_mb) (Utility::process_mem_usage)."""
    try:
        with open("/proc/self/status") as f:
            status = f.read()
        vm = rss = 0.0
        for line in status.splitlines():
            if line.startswith("VmSize:"):
                vm = float(line.split()[1]) / 1024.0
            elif line.startswith("VmRSS:"):
                rss = float(line.split()[1]) / 1024.0
        return vm, rss
    except OSError:
        usage = resource.getrusage(resource.RUSAGE_SELF)
        return 0.0, usage.ru_maxrss / 1024.0


def process_time_usage() -> tuple:
    """(system_seconds, user_seconds) (Utility::process_time_usage)."""
    usage = resource.getrusage(resource.RUSAGE_SELF)
    return usage.ru_stime, usage.ru_utime
