"""Uniform allele-frequency access across VCF INFO dialects.

Capability parity with FrequencyDatabaseRead
(kgl_variant_db/kgl_variant_db_freq.h:26-90): AF/AC/AN lookup for the
super-populations AFR/AMR/EAS/EUR/SAS/ALL across the 1000-Genomes
("AFR_AF", ...) and gnomAD ("AF_afr"/"AC_afr"/"AN_afr", ...) field naming
dialects, vectorized over the InfoStore columns.

Copy of kgl_gene_tpu/stats/frequency.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["SuperPopulation", "FrequencyDatabaseRead", "SUPER_POPULATIONS"]

SUPER_POPULATIONS = ("AFR", "AMR", "EAS", "EUR", "SAS", "ALL")


class SuperPopulation:
    AFR = "AFR"
    AMR = "AMR"
    EAS = "EAS"
    EUR = "EUR"
    SAS = "SAS"
    ALL = "ALL"


def _dialect_candidates(super_pop: str, field: str) -> List[str]:
    """Candidate INFO ids for (super population, AF|AC|AN)."""
    sp = super_pop.upper()
    lower = sp.lower()
    if sp == "ALL":
        return [field, f"{field}_joint", f"{field}_raw"]
    return [
        f"{sp}_{field}",        # 1000 Genomes: AFR_AF
        f"{field}_{lower}",     # gnomAD: AF_afr
        f"{field}_{sp}",        # occasionally AF_AFR
    ]


class FrequencyDatabaseRead:
    """Read AF/AC/AN per variant (by info row) from an InfoStore."""

    def __init__(self, info_store):
        self.info = info_store

    def _resolve(self, super_pop: str, field: str) -> Optional[str]:
        for candidate in _dialect_candidates(super_pop, field):
            if self.info.has_field(candidate):
                return candidate
        return None

    def _scalar(self, fid: str, info_row: int) -> Optional[float]:
        value = self.info.value(fid, info_row)
        if isinstance(value, list):
            value = value[0] if value else None
        if value is None or (isinstance(value, float) and np.isnan(value)):
            return None
        return float(value)

    # --- per-variant getters ---------------------------------------------
    def allele_frequency(self, super_pop: str, info_row: int) -> Optional[float]:
        fid = self._resolve(super_pop, "AF")
        return self._scalar(fid, info_row) if fid else None

    def allele_count(self, super_pop: str, info_row: int) -> Optional[float]:
        fid = self._resolve(super_pop, "AC")
        return self._scalar(fid, info_row) if fid else None

    def allele_total(self, super_pop: str, info_row: int) -> Optional[float]:
        fid = self._resolve(super_pop, "AN")
        return self._scalar(fid, info_row) if fid else None

    # --- vectorized columns -----------------------------------------------
    def frequency_column(self, super_pop: str) -> Optional[np.ndarray]:
        """AF for every info row as a float array (NaN where missing)."""
        fid = self._resolve(super_pop, "AF")
        if fid is None:
            return None
        try:
            return self.info.float_column(fid)
        except KeyError:
            values = [
                self._scalar(fid, row) for row in range(self.info.count)
            ]
            return np.array(
                [np.nan if v is None else v for v in values], dtype=np.float64
            )
