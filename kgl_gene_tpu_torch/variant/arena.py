"""Columnar variant arena: the primary storage of unique alleles.

This is the TPU-native replacement for the reference's pointer-graph
variant DB (kgl_variant_db/kgl_variant_db.h): instead of millions of
shared_ptr<Variant> objects, unique alleles live once in struct-of-arrays
columns (positions, packed ref/alt bases, lengths) and genomes reference
them by row index. The reference's transposed VariantDBVariant view
(kgl_variant_db_variant.h:26-83) is thereby the *primary* format, and
device export is a zero-copy slice.

Copy of kgl_gene_tpu/variant/arena.py.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..sequence.sequence import DNA5SequenceLinear
from .variant import FormatData, Variant, VariantPhase

__all__ = ["VariantArena"]


class VariantArena:
    """Append-only interning store for unique (contig, offset, ref, alt)
    alleles. Thread-safe interning (the reference guards PopulationDB::
    addVariant with a mutex; here only the tiny intern step is locked)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._contig_ids: List[str] = []
        self._contig_index: Dict[str, int] = {}
        # Python builder lists; frozen into arrays on demand.
        self._contig: List[int] = []
        self._offset: List[int] = []
        self._ref: List[bytes] = []   # uint8 code bytes
        self._alt: List[bytes] = []
        self._identifier: List[str] = []
        self._info_row: List[int] = []
        self._index: Dict[Tuple[int, int, bytes, bytes], int] = {}
        self._frozen: Optional[dict] = None

    # --- pickling (population snapshots; the lock is recreated) -----------
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    def contig_index(self, contig_id: str) -> int:
        idx = self._contig_index.get(contig_id)
        if idx is None:
            idx = len(self._contig_ids)
            self._contig_ids.append(contig_id)
            self._contig_index[contig_id] = idx
        return idx

    def contig_name(self, index: int) -> str:
        return self._contig_ids[index]

    @property
    def contig_names(self) -> List[str]:
        return list(self._contig_ids)

    def intern(
        self,
        contig_id: str,
        offset: int,
        ref_codes: np.ndarray,
        alt_codes: np.ndarray,
        identifier: str = "",
        info_row: int = -1,
    ) -> int:
        """Return the arena row for this allele, creating it if new."""
        ref_b = ref_codes.tobytes()
        alt_b = alt_codes.tobytes()
        with self._lock:
            cidx = self.contig_index(contig_id)
            key = (cidx, offset, ref_b, alt_b)
            row = self._index.get(key)
            if row is None:
                row = len(self._offset)
                self._index[key] = row
                self._contig.append(cidx)
                self._offset.append(offset)
                self._ref.append(ref_b)
                self._alt.append(alt_b)
                self._identifier.append(identifier)
                self._info_row.append(info_row)
                self._frozen = None
            return row

    def intern_bytes(
        self,
        contig_idx: int,
        offset: int,
        ref_b: bytes,
        alt_b: bytes,
        identifier: str = "",
        info_row: int = -1,
    ) -> int:
        """Intern with pre-encoded code bytes and a resolved contig index —
        the hot ingest form (no numpy, no per-call contig lookup)."""
        with self._lock:
            key = (contig_idx, offset, ref_b, alt_b)
            row = self._index.get(key)
            if row is None:
                row = len(self._offset)
                self._index[key] = row
                self._contig.append(contig_idx)
                self._offset.append(offset)
                self._ref.append(ref_b)
                self._alt.append(alt_b)
                self._identifier.append(identifier)
                self._info_row.append(info_row)
                self._frozen = None
            return row

    def __len__(self) -> int:
        return len(self._offset)

    # ------------------------------------------------------------------ #
    # columnar accessors (lazily frozen)
    # ------------------------------------------------------------------ #
    def _freeze(self) -> dict:
        if self._frozen is None:
            ref_len = np.fromiter((len(b) for b in self._ref), dtype=np.int32, count=len(self._ref))
            alt_len = np.fromiter((len(b) for b in self._alt), dtype=np.int32, count=len(self._alt))
            alt0 = np.fromiter(
                (b[0] if b else 0 for b in self._alt), dtype=np.uint8,
                count=len(self._alt),
            )
            ref0 = np.fromiter(
                (b[0] if b else 0 for b in self._ref), dtype=np.uint8,
                count=len(self._ref),
            )
            self._frozen = {
                "contig": np.asarray(self._contig, dtype=np.int32),
                "offset": np.asarray(self._offset, dtype=np.int64),
                "ref_len": ref_len,
                "alt_len": alt_len,
                "alt0": alt0,
                "ref0": ref0,
            }
        return self._frozen

    @property
    def offsets(self) -> np.ndarray:
        return self._freeze()["offset"]

    @property
    def contigs(self) -> np.ndarray:
        return self._freeze()["contig"]

    @property
    def ref_lens(self) -> np.ndarray:
        return self._freeze()["ref_len"]

    @property
    def alt_lens(self) -> np.ndarray:
        return self._freeze()["alt_len"]

    @property
    def alt_first(self) -> np.ndarray:
        """First alt base code per row (the applied base for 1X SNPs)."""
        return self._freeze()["alt0"]

    @property
    def ref_first(self) -> np.ndarray:
        """First ref base code per row."""
        return self._freeze()["ref0"]

    def is_snp_column(self) -> np.ndarray:
        """Vectorized SNP classification over all rows (canonical rows are
        len-1/len-1; same-length multi-base rows use the single-difference
        rule on the slow path)."""
        f = self._freeze()
        snp = (f["ref_len"] == 1) & (f["alt_len"] == 1)
        maybe = (f["ref_len"] == f["alt_len"]) & ~snp
        for row in np.nonzero(maybe)[0]:
            ref = np.frombuffer(self._ref[row], dtype=np.uint8)
            alt = np.frombuffer(self._alt[row], dtype=np.uint8)
            snp[row] = int(np.sum(ref != alt)) == 1
        return snp

    def ref_codes(self, row: int) -> np.ndarray:
        return np.frombuffer(self._ref[row], dtype=np.uint8)

    def alt_codes(self, row: int) -> np.ndarray:
        return np.frombuffer(self._alt[row], dtype=np.uint8)

    def identifier(self, row: int) -> str:
        return self._identifier[row]

    def info_row(self, row: int) -> int:
        return self._info_row[row]

    # ------------------------------------------------------------------ #
    def make_variant(
        self,
        row: int,
        phase: VariantPhase = VariantPhase.UNPHASED,
        format_data: Optional[FormatData] = None,
        pass_filter: bool = True,
    ) -> Variant:
        """Materialise a flyweight Variant view for a row + incidence."""
        return Variant(
            contig_id=self._contig_ids[self._contig[row]],
            offset=self._offset[row],
            phase=phase,
            identifier=self._identifier[row],
            ref=DNA5SequenceLinear(self.ref_codes(row)),
            alt=DNA5SequenceLinear(self.alt_codes(row)),
            format_data=format_data,
            info_index=self._info_row[row],
            pass_filter=pass_filter,
        )

    def hgvs(self, row: int) -> str:
        from ..sequence.alphabet import DNA5

        contig = self._contig_ids[self._contig[row]]
        ref = DNA5.to_string(self.ref_codes(row))
        alt = DNA5.to_string(self.alt_codes(row))
        return f"{contig}:g.{self._offset[row]}{ref}>{alt}"
