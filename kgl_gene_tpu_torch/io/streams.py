"""Stream IO: transparent text/gzip/bgzf/bz2 line readers.

Copy of kgl_gene_tpu/io/streams.py. A BGZF file under 2 GiB inflates
whole through the native library (native/, built on first use); a larger
one streams through the threaded BGZFReader.

Capability parity with the reference stream factory
(kel_io/kel_basic_io.h:75-105 BaseStreamIO::getStreamIO and
kel_io/kel_file_io.h) and the multithreaded BGZF reader
(kel_io/kel_bzip_workflow.h:42). The host ingest path is deliberately
process/thread-parallel on the host CPU (TPUs don't decompress), with the
parallel-block BGZF design preserved: bgzf files are RFC-1952 concatenated
64 KiB blocks, so blocks decompress independently on a thread pool and are
re-assembled in order.
"""

from __future__ import annotations

import bz2
import gzip
import io
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

__all__ = ["open_text_stream", "read_lines", "BGZFReader", "is_bgzf"]

_BGZF_EXTENSIONS = (".bgz", ".bgzf")
_GZ_EXTENSIONS = (".gz",)
_BZ2_EXTENSIONS = (".bz2",)


def is_bgzf(path: str) -> bool:
    """Detect the BGZF magic (gzip header with the BC extra subfield)."""
    try:
        with open(path, "rb") as f:
            header = f.read(18)
    except OSError:
        return False
    if len(header) < 18 or header[:2] != b"\x1f\x8b":
        return False
    flg = header[3]
    if not flg & 4:  # FEXTRA
        return False
    return header[12:14] == b"BC"


def open_text_stream(path: str):
    """Open path as a text stream, selecting the decompressor by extension
    (and BGZF by magic). Mirrors BaseStreamIO::getStreamIO."""
    lower = path.lower()
    if lower.endswith(_BGZF_EXTENSIONS) or (lower.endswith(_GZ_EXTENSIONS) and is_bgzf(path)):
        # Native whole-file parallel inflate for files that fit comfortably
        # in memory; the threaded streaming reader otherwise.
        if os.path.getsize(path) < 2 << 30:
            from ..native import bgzf_decompress

            return io.TextIOWrapper(
                io.BytesIO(bgzf_decompress(path)), encoding="ascii", errors="replace"
            )
        return io.TextIOWrapper(BGZFReader(path), encoding="ascii", errors="replace")
    if lower.endswith(_GZ_EXTENSIONS):
        return gzip.open(path, "rt")
    if lower.endswith(_BZ2_EXTENSIONS):
        return bz2.open(path, "rt")
    return open(path, "rt")


def read_lines(path: str) -> Iterator[str]:
    """Iterate lines (newline-stripped) from any supported stream."""
    with open_text_stream(path) as stream:
        for line in stream:
            yield line.rstrip("\n")


class BGZFReader(io.RawIOBase):
    """Parallel-block BGZF decompressor with sequential read() semantics.

    Design carried over from the reference's BGZStreamIO
    (kel_io/kel_bzip_workflow.h:42): one reader splits the file into BGZF
    blocks (each <= 64 KiB uncompressed, RFC-1952 framed), a thread pool
    inflates blocks concurrently, and output is consumed in file order.
    CRC32 verification is optional (kel_bzip_workflow_verify.cpp:17).
    """

    def __init__(self, path: str, threads: Optional[int] = None, verify: bool = False,
                 prefetch_blocks: int = 64):
        self._file = open(path, "rb")
        self._threads = threads or min(8, (os.cpu_count() or 2))
        self._verify = verify
        self._prefetch = prefetch_blocks
        self._pool = ThreadPoolExecutor(max_workers=self._threads)
        self._pending = []  # FIFO of futures for decompressed blocks
        self._buffer = b""
        self._buffer_pos = 0
        self._eof_blocks = False

    # --- block framing ----------------------------------------------------
    def _read_block(self) -> Optional[bytes]:
        """Read one raw BGZF block (compressed bytes) from the file."""
        header = self._file.read(12)
        if len(header) == 0:
            return None
        if len(header) < 12:
            raise IOError("truncated BGZF block header")
        if header[:2] != b"\x1f\x8b":
            raise IOError("bad BGZF magic")
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = self._file.read(xlen)
        bsize = None
        pos = 0
        while pos + 4 <= len(extra):
            si1, si2, slen = extra[pos], extra[pos + 1], struct.unpack("<H", extra[pos + 2 : pos + 4])[0]
            if si1 == 66 and si2 == 67 and slen == 2:  # 'B','C'
                bsize = struct.unpack("<H", extra[pos + 4 : pos + 6])[0]
            pos += 4 + slen
        if bsize is None:
            raise IOError("BGZF block missing BC subfield")
        remainder = self._file.read(bsize - xlen - 11)  # deflate data + crc + isize
        return header + extra + remainder

    @staticmethod
    def _inflate(raw: bytes, verify: bool) -> bytes:
        # Skip the fixed 12-byte header + extra field, then raw deflate.
        xlen = struct.unpack("<H", raw[10:12])[0]
        comp = raw[12 + xlen : -8]
        crc32, isize = struct.unpack("<II", raw[-8:])
        data = zlib.decompress(comp, wbits=-15)
        if len(data) != isize:
            raise IOError("BGZF block size mismatch")
        if verify and (zlib.crc32(data) & 0xFFFFFFFF) != crc32:
            raise IOError("BGZF block CRC32 mismatch")
        return data

    def _fill_pipeline(self):
        while not self._eof_blocks and len(self._pending) < self._prefetch:
            raw = self._read_block()
            if raw is None:
                self._eof_blocks = True
                break
            self._pending.append(self._pool.submit(self._inflate, raw, self._verify))

    # --- RawIOBase interface ---------------------------------------------
    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        out = self.read(len(b))
        b[: len(out)] = out
        return len(out)

    def read(self, size: int = -1) -> bytes:
        chunks = []
        remaining = size if size >= 0 else None
        while remaining is None or remaining > 0:
            if self._buffer_pos >= len(self._buffer):
                self._fill_pipeline()
                if not self._pending:
                    break
                self._buffer = self._pending.pop(0).result()
                self._buffer_pos = 0
                if not self._buffer:  # EOF marker block
                    continue
            take = len(self._buffer) - self._buffer_pos
            if remaining is not None:
                take = min(take, remaining)
                remaining -= take
            chunks.append(self._buffer[self._buffer_pos : self._buffer_pos + take])
            self._buffer_pos += take
        return b"".join(chunks)

    def close(self):
        if not self.closed:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._file.close()
        super().close()


def write_bgzf(path: str, data: bytes, block_size: int = 65280) -> None:
    """Write data as a BGZF file (used by tests and cache writers)."""
    with open(path, "wb") as f:
        for start in range(0, len(data), block_size):
            block = data[start : start + block_size]
            f.write(_bgzf_block(block))
        f.write(_bgzf_block(b""))  # EOF marker


def _bgzf_block(data: bytes) -> bytes:
    comp_obj = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = comp_obj.compress(data) + comp_obj.flush()
    # BSIZE = total block length - 1 = header(18) + comp + footer(8) - 1.
    bsize = len(comp) + 25
    header = struct.pack(
        "<4BIBBHBBHH", 31, 139, 8, 4, 0, 0, 255, 6, 66, 67, 2, bsize
    )
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + comp + footer
