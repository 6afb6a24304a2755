"""Native host-ingest functions (C++ via ctypes).

Copy of kgl_gene_tpu/native/__init__.py for the PyTorch port. The source
is this package's own kgt_native.cpp; g++ builds it on first use into
kgl_gene_tpu_torch/_build/libkgt_native.so (listed in .gitignore):

    g++ -O3 -shared -fPIC -std=c++17 -o _build/libkgt_native.so \
        native/kgt_native.cpp -lz -lpthread

and rebuilds it when the source is newer than the library. The build
writes to a name of its own and renames it into place, so processes that
build at the same moment each load a whole library. A failed build raises
with the compiler's output: nothing here answers "unavailable" and lets a
caller drop to another route. Nothing is built at import time.

Functions:
  - bgzf_decompress(path): whole-file parallel BGZF inflate
  - NativeBGZFStream: streaming BGZF reader (slab inflate with prefetch)
  - parse_genotypes(...): one record's genotype columns
  - parse_vcf_records(...): the end-to-end C++ VCF record loop
  - indel_reconstruct(...): host replay of the SNP + indel step's coding
  - csr_build(...), mark_presence(...): the variant-major CSR build
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "LIB_PATH", "SOURCE", "NativeBGZFStream", "bgzf_decompress", "build", "csr_build",
    "indel_reconstruct", "library", "mark_presence", "native_available", "parse_genotypes",
    "parse_vcf_records",
]


class _KgtVcfResult(ctypes.Structure):
    """Mirror of KgtVcfResult in kgt_native.cpp (field order must match)."""

    _fields_ = [
        ("n_records", ctypes.c_int64),
        ("n_alts", ctypes.c_int64),
        ("n_incidences", ctypes.c_int64),
        ("n_contigs", ctypes.c_int64),
        ("n_numeric", ctypes.c_int64),
        ("n_flags", ctypes.c_int64),
        ("ad_mismatch", ctypes.c_int64),
        ("bad_records", ctypes.c_int64),
        ("rec_contig", ctypes.POINTER(ctypes.c_int32)),
        ("rec_pos", ctypes.POINTER(ctypes.c_int64)),
        ("rec_qual", ctypes.POINTER(ctypes.c_float)),
        ("rec_pass", ctypes.POINTER(ctypes.c_uint8)),
        ("rec_id_start", ctypes.POINTER(ctypes.c_int64)),
        ("rec_id_end", ctypes.POINTER(ctypes.c_int64)),
        ("rec_ref_start", ctypes.POINTER(ctypes.c_int64)),
        ("rec_ref_end", ctypes.POINTER(ctypes.c_int64)),
        ("rec_info_start", ctypes.POINTER(ctypes.c_int64)),
        ("rec_info_end", ctypes.POINTER(ctypes.c_int64)),
        ("alt_row_start", ctypes.POINTER(ctypes.c_int64)),
        ("alt_start", ctypes.POINTER(ctypes.c_int64)),
        ("alt_end", ctypes.POINTER(ctypes.c_int64)),
        ("contig_start", ctypes.POINTER(ctypes.c_int64)),
        ("contig_end", ctypes.POINTER(ctypes.c_int64)),
        ("inc_record", ctypes.POINTER(ctypes.c_int32)),
        ("inc_sample", ctypes.POINTER(ctypes.c_int32)),
        ("inc_allele", ctypes.POINTER(ctypes.c_int32)),
        ("inc_phase", ctypes.POINTER(ctypes.c_uint8)),
        ("inc_ref_count", ctypes.POINTER(ctypes.c_int32)),
        ("inc_alt_count", ctypes.POINTER(ctypes.c_int32)),
        ("inc_dp", ctypes.POINTER(ctypes.c_int32)),
        ("inc_gq", ctypes.POINTER(ctypes.c_float)),
        ("info_numeric", ctypes.POINTER(ctypes.c_double)),
        ("info_flags", ctypes.POINTER(ctypes.c_uint8)),
        ("n_arrays", ctypes.c_int64),
        ("arr_values", ctypes.POINTER(ctypes.c_double)),
        ("arr_field_start", ctypes.POINTER(ctypes.c_int64)),
        ("arr_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("arr_present", ctypes.POINTER(ctypes.c_uint8)),
        ("n_strings", ctypes.c_int64),
        ("str_pool", ctypes.POINTER(ctypes.c_char)),
        ("str_field_start", ctypes.POINTER(ctypes.c_int64)),
        ("str_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("str_present", ctypes.POINTER(ctypes.c_uint8)),
    ]


SOURCE = Path(__file__).resolve().parent / "kgt_native.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
LIB_PATH = BUILD_DIR / "libkgt_native.so"
CXX = ("g++",)
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile SOURCE into LIB_PATH unless the library is newer than the
    source. Returns the library's path; raises with the compiler's output
    when the build fails."""
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIB_PATH
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=LIB_PATH.name + ".", suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [*CXX, *CXX_FLAGS, "-o", tmp, str(SOURCE), "-lz", "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise RuntimeError(f"cannot build {LIB_PATH.name}: {' '.join(cmd)}: {exc}") from exc
        if proc.returncode:
            raise RuntimeError(
                f"cannot build {LIB_PATH.name}: {' '.join(cmd)} exited {proc.returncode}:\n"
                f"{proc.stderr}"
            )
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded native library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.kgt_bgzf_decompress.restype = ctypes.c_void_p
        lib.kgt_bgzf_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.kgt_free.restype = None
        lib.kgt_free.argtypes = [ctypes.c_void_p]
        lib.kgt_vcf_parse_genotypes.restype = ctypes.c_int
        lib.kgt_vcf_parse_genotypes.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.kgt_count_lines.restype = ctypes.c_long
        lib.kgt_count_lines.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.kgt_vcf_parse_records.restype = ctypes.POINTER(_KgtVcfResult)
        lib.kgt_vcf_parse_records.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.kgt_vcf_result_free.restype = None
        lib.kgt_vcf_result_free.argtypes = [ctypes.POINTER(_KgtVcfResult)]
        lib.kgt_bgzf_open.restype = ctypes.c_void_p
        lib.kgt_bgzf_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ]
        lib.kgt_bgzf_read.restype = ctypes.c_longlong
        lib.kgt_bgzf_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong]
        lib.kgt_bgzf_close.restype = None
        lib.kgt_bgzf_close.argtypes = [ctypes.c_void_p]
        lib.kgt_mark_presence.restype = None
        lib.kgt_mark_presence.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.kgt_csr_build.restype = ctypes.c_int64
        lib.kgt_csr_build.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,  # rows, lens
            ctypes.c_void_p, ctypes.c_int64,                   # gidx, n_parts
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,   # ranks, n_g, key_max
            ctypes.c_int64,                                    # total
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, # outputs
        ]
        lib.kgt_indel_reconstruct.restype = ctypes.c_int
        lib.kgt_indel_reconstruct.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,           # region, L
            ctypes.c_void_p, ctypes.c_int,             # exon_bounds, n_exons
            ctypes.c_int,                              # reverse
            ctypes.c_void_p, ctypes.c_void_p,          # pos, kind
            ctypes.c_void_p, ctypes.c_void_p,          # del_len, ins_codes
            ctypes.c_void_p, ctypes.c_void_p,          # ins_len, alt
            ctypes.c_void_p,                           # valid
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # B, K, A
            ctypes.c_int64, ctypes.c_void_p,           # pad_coding, complement
            ctypes.c_void_p, ctypes.c_void_p,          # coding_out, len_out
            ctypes.c_int64,                            # S_pad
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True once the library is built and loaded; raises when it cannot be
    built."""
    library()
    return True


def bgzf_decompress(path: str, threads: int = 0) -> bytes:
    """Whole-file parallel BGZF inflate; OSError when the file cannot be
    read or is not well-formed BGZF."""
    lib = library()
    if threads <= 0:
        threads = max((os.cpu_count() or 2) - 1, 1)
    size = ctypes.c_size_t(0)
    ptr = lib.kgt_bgzf_decompress(os.fsencode(path), threads, ctypes.byref(size))
    if not ptr:
        raise OSError(f"cannot inflate BGZF file {path}")
    try:
        return ctypes.string_at(ptr, size.value)
    finally:
        lib.kgt_free(ptr)


class NativeBGZFStream:
    """Streaming BGZF reader over the native slab decompressor: sequential
    block framing, parallel zlib inflate per slab, one slab of prefetch
    (the C++ side releases the GIL for the whole read, so inflate overlaps
    the record parse). Bounded memory at any file size. File-object
    surface: read / readinto / close / context manager.

    Reference counterpart: BGZStreamIO's reader -> inflate-pipeline ->
    ordered readLine workflow (kel_io/kel_bzip_workflow.h:42)."""

    def __init__(self, path: str, threads: int = 0,
                 slab_bytes: int = 24 << 20, verify: bool = False):
        lib = library()
        self._lib = lib
        self._handle = lib.kgt_bgzf_open(os.fsencode(path), threads, slab_bytes,
                                         1 if verify else 0)
        if not self._handle:
            raise OSError(f"cannot open BGZF file {path}")
        self._path = path

    def readinto(self, view) -> int:
        mv = memoryview(view).cast("B")
        if len(mv) == 0:
            return 0
        buf = (ctypes.c_char * len(mv)).from_buffer(mv)
        n = self._lib.kgt_bgzf_read(self._handle, buf, len(mv))
        if n < 0:
            raise OSError(f"corrupt BGZF stream in {self._path}")
        return int(n)

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            parts = []
            while True:
                chunk = self.read(16 << 20)
                if not chunk:
                    return b"".join(parts)
                parts.append(chunk)
        out = bytearray(n)
        got = self.readinto(out)
        return bytes(out[:got])

    def close(self) -> None:
        if self._handle:
            self._lib.kgt_bgzf_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


def parse_genotypes(
    genotype_text: bytes,
    n_samples: int,
    n_alleles: int,
    gt_idx: int,
    ad_idx: int = -1,
    dp_idx: int = -1,
    gq_idx: int = -1,
) -> Optional[Tuple[np.ndarray, ...]]:
    """Tokenise one record's genotype columns. Returns (gt_a, gt_b, ad, dp,
    gq, ad_count) arrays, or None when the text does not hold n_samples
    columns (the caller then parses that record in Python)."""
    lib = library()
    gt_a = np.empty(n_samples, dtype=np.int32)
    gt_b = np.empty(n_samples, dtype=np.int32)
    ad = np.empty(n_samples * (n_alleles + 1), dtype=np.int32)
    dp = np.empty(n_samples, dtype=np.int32)
    gq = np.empty(n_samples, dtype=np.float32)
    ad_count = np.empty(n_samples, dtype=np.int32)
    parsed = lib.kgt_vcf_parse_genotypes(
        genotype_text, len(genotype_text), n_samples, n_alleles,
        gt_idx, ad_idx, dp_idx, gq_idx,
        gt_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        gt_b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ad.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        gq.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ad_count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if parsed != n_samples:
        return None
    return gt_a, gt_b, ad.reshape(n_samples, n_alleles + 1), dp, gq, ad_count


def _copy_col(ptr, n: int, dtype) -> np.ndarray:
    if n == 0:
        return np.empty(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def parse_vcf_records(
    text,
    body_start: int,
    n_samples: int,
    mode: int,
    numeric_fields: "list[str]" = (),
    flag_fields: "list[str]" = (),
    array_fields: "list[str]" = (),
    string_fields: "list[str]" = (),
    threads: int = 0,
    length: Optional[int] = None,
) -> dict:
    """End-to-end C++ VCF record-loop parse (the reference's 50-thread
    native consumer pool, kgl_variant_factory_readvcf_impl.h:45). Returns a
    dict of flat numpy columns; strings are [start, end) offsets into
    ``text``. Subscribed INFO fields land as typed columns: numeric scalars,
    flags, numeric arrays (CSR values+offsets+present, the packed-memory
    job of kgl_evidence/kgl_variant_factory_vcf_evidence_memory.h:52-66)
    and string value pools (offsets+present into one byte pool per field).
    Modes: 0 Pf diploid, 1 phased diploid, 2 mono-genome."""
    lib = library()
    if threads <= 0:
        threads = max((os.cpu_count() or 2), 1)
    n = len(text) if length is None else length
    # Zero-copy buffer handoff: bytes pass as-is; bytearray/memoryview via
    # from_buffer (the chunked ingest reuses ONE buffer: no per-chunk
    # slicing copies on multi-GiB files).
    keepalive = None
    if isinstance(text, (bytearray, memoryview)):
        keepalive = (ctypes.c_char * len(text)).from_buffer(text)
        addr = ctypes.addressof(keepalive)
    else:
        addr = ctypes.cast(ctypes.c_char_p(text), ctypes.c_void_p).value
    res_ptr = lib.kgt_vcf_parse_records(
        addr, n, body_start, n_samples, mode,
        "\n".join(numeric_fields).encode(), "\n".join(flag_fields).encode(),
        "\n".join(array_fields).encode(), "\n".join(string_fields).encode(),
        threads,
    )
    del keepalive
    if not res_ptr:
        raise MemoryError("kgt_vcf_parse_records could not allocate its result")
    try:
        res = res_ptr.contents
        R, A, I, C = res.n_records, res.n_alts, res.n_incidences, res.n_contigs
        out = {
            "n_records": R, "n_alts": A, "n_incidences": I, "n_contigs": C,
            "ad_mismatch": res.ad_mismatch, "bad_records": res.bad_records,
            "rec_contig": _copy_col(res.rec_contig, R, np.int32),
            "rec_pos": _copy_col(res.rec_pos, R, np.int64),
            "rec_qual": _copy_col(res.rec_qual, R, np.float32),
            "rec_pass": _copy_col(res.rec_pass, R, np.uint8).astype(bool),
            "rec_id_start": _copy_col(res.rec_id_start, R, np.int64),
            "rec_id_end": _copy_col(res.rec_id_end, R, np.int64),
            "rec_ref_start": _copy_col(res.rec_ref_start, R, np.int64),
            "rec_ref_end": _copy_col(res.rec_ref_end, R, np.int64),
            "rec_info_start": _copy_col(res.rec_info_start, R, np.int64),
            "rec_info_end": _copy_col(res.rec_info_end, R, np.int64),
            "alt_row_start": _copy_col(res.alt_row_start, R + 1, np.int64),
            "alt_start": _copy_col(res.alt_start, A, np.int64),
            "alt_end": _copy_col(res.alt_end, A, np.int64),
            "contig_start": _copy_col(res.contig_start, C, np.int64),
            "contig_end": _copy_col(res.contig_end, C, np.int64),
            "inc_record": _copy_col(res.inc_record, I, np.int32),
            "inc_sample": _copy_col(res.inc_sample, I, np.int32),
            "inc_allele": _copy_col(res.inc_allele, I, np.int32),
            "inc_phase": _copy_col(res.inc_phase, I, np.uint8),
            "inc_ref_count": _copy_col(res.inc_ref_count, I, np.int32),
            "inc_alt_count": _copy_col(res.inc_alt_count, I, np.int32),
            "inc_dp": _copy_col(res.inc_dp, I, np.int32),
            "inc_gq": _copy_col(res.inc_gq, I, np.float32),
        }
        n_num, n_flag = res.n_numeric, res.n_flags
        out["info_numeric"] = (
            _copy_col(res.info_numeric, n_num * R, np.float64).reshape(n_num, R)
            if n_num else np.empty((0, R), dtype=np.float64)
        )
        out["info_flags"] = (
            _copy_col(res.info_flags, n_flag * R, np.uint8)
            .reshape(n_flag, R).astype(bool)
            if n_flag else np.empty((0, R), dtype=bool)
        )
        # numeric-array CSR + string pools per subscribed field
        na, ns = res.n_arrays, res.n_strings
        arrays = {}
        if na:
            field_start = _copy_col(res.arr_field_start, na + 1, np.int64)
            all_vals = _copy_col(res.arr_values, int(field_start[-1]), np.float64)
            offsets = _copy_col(res.arr_offsets, na * (R + 1), np.int64).reshape(na, R + 1)
            present = (
                _copy_col(res.arr_present, na * R, np.uint8)
                .reshape(na, R).astype(bool)
            )
            for f, fid in enumerate(array_fields):
                arrays[fid] = (
                    all_vals[field_start[f] : field_start[f + 1]],
                    offsets[f], present[f],
                )
        out["info_arrays"] = arrays
        strings = {}
        if ns:
            field_start = _copy_col(res.str_field_start, ns + 1, np.int64)
            total = int(field_start[-1])
            pool = ctypes.string_at(res.str_pool, total) if total else b""
            offsets = _copy_col(res.str_offsets, ns * (R + 1), np.int64).reshape(ns, R + 1)
            present = (
                _copy_col(res.str_present, ns * R, np.uint8)
                .reshape(ns, R).astype(bool)
            )
            for f, fid in enumerate(string_fields):
                lo, hi = int(field_start[f]), int(field_start[f + 1])
                strings[fid] = (pool[lo:hi], offsets[f], present[f])
        out["info_strings"] = strings
        return out
    finally:
        lib.kgt_vcf_result_free(res_ptr)


def indel_reconstruct(region, exon_bounds, reverse_strand, pos, kind,
                      del_len, ins_codes, ins_len, alt, valid,
                      pad_coding, complement, s_pad):
    """Native replay of the SNP + indel step's coding sequences
    (kgt_indel_reconstruct): (coding (B, s_pad) uint8, coding_len (B,)
    int32). ops/pipeline.py reconstruct_indel_coding_plain is its numpy
    plain version."""
    lib = library()
    region = np.ascontiguousarray(region, np.uint8)
    exon_bounds = np.ascontiguousarray(exon_bounds, np.int64)
    pos = np.ascontiguousarray(pos, np.int32)
    kind = np.ascontiguousarray(kind, np.int8)
    del_len = np.ascontiguousarray(del_len, np.int32)
    ins_codes = np.ascontiguousarray(ins_codes, np.uint8)
    ins_len = np.ascontiguousarray(ins_len, np.int32)
    alt = np.ascontiguousarray(alt, np.uint8)
    valid = np.ascontiguousarray(valid, np.uint8)
    complement = np.ascontiguousarray(complement, np.uint8)
    B, K = pos.shape
    A = ins_codes.shape[2]
    for name, x, shape in (("kind", kind, (B, K)), ("del_len", del_len, (B, K)),
                           ("ins_codes", ins_codes, (B, K, A)), ("ins_len", ins_len, (B, K)),
                           ("alt", alt, (B, K)), ("valid", valid, (B, K)),
                           ("complement", complement, (5,))):
        if x.shape != shape:
            raise ValueError(f"{name} has shape {x.shape}, expected {shape}")
    if exon_bounds.ndim != 2 or exon_bounds.shape[1] != 2:
        raise ValueError(f"exon_bounds has shape {exon_bounds.shape}, expected (E, 2)")
    coding = np.empty((B, int(s_pad)), np.uint8)
    lens = np.empty(B, np.int32)
    rc = lib.kgt_indel_reconstruct(
        region.ctypes.data, len(region),
        exon_bounds.ctypes.data, len(exon_bounds),
        1 if reverse_strand else 0,
        pos.ctypes.data, kind.ctypes.data, del_len.ctypes.data,
        ins_codes.ctypes.data, ins_len.ctypes.data, alt.ctypes.data,
        valid.ctypes.data, B, K, A,
        int(pad_coding), complement.ctypes.data,
        coding.ctypes.data, lens.ctypes.data, int(s_pad),
    )
    if rc != 0:
        raise RuntimeError(f"kgt_indel_reconstruct returned {rc}")
    return coding, lens


def _part_pointers(parts):
    """(rows arrays kept alive, their pointer array, their lengths)."""
    keep = [np.ascontiguousarray(rows, np.int32) for _g, rows in parts]
    ptrs = (ctypes.c_void_p * max(len(keep), 1))(*[a.ctypes.data for a in keep])
    lens = np.asarray([len(a) for a in keep], np.int64)
    return keep, ptrs, lens


def csr_build(parts, rank_of_row, n_g, key_max, total):
    """Native variant-major CSR dedup build (kgt_csr_build): parts is a
    list of (gidx, rows int32 array); returns (values uint8, variant_of
    int32, genome_of int32) truncated to nnz. variant/columnar.py
    csr_triples_plain is its numpy plain version."""
    lib = library()
    keep, ptrs, lens = _part_pointers(parts)
    gidx = np.asarray([g for g, _r in parts], np.int32)
    rank_of_row = np.ascontiguousarray(rank_of_row, np.int32)
    values = np.empty(total, np.uint8)
    variant_of = np.empty(total, np.int32)
    genome_of = np.empty(total, np.int32)
    nnz = lib.kgt_csr_build(
        ptrs, lens.ctypes.data, gidx.ctypes.data, len(keep),
        rank_of_row.ctypes.data, int(n_g), int(key_max), int(total),
        values.ctypes.data, variant_of.ctypes.data, genome_of.ctypes.data,
    )
    del keep
    if nnz < 0:
        raise RuntimeError(f"kgt_csr_build returned {nnz}")
    return values[:nnz], variant_of[:nnz], genome_of[:nnz]


def mark_presence(parts, arena_len):
    """Native presence bitmap over arena rows (bool (arena_len,)).
    variant/columnar.py presence_plain is its numpy plain version."""
    lib = library()
    keep, ptrs, lens = _part_pointers(parts)
    for rows in keep:
        if len(rows) and (rows.min() < 0 or rows.max() >= arena_len):
            raise ValueError("an incidence row lies outside the arena")
    present = np.zeros(arena_len, np.uint8)
    lib.kgt_mark_presence(ptrs, lens.ctypes.data, len(keep), present.ctypes.data)
    del keep
    return present.view(bool)
