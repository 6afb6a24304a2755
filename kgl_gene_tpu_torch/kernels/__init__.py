"""Build, load and launch the hand-written CUDA kernels under csrc/.

Every csrc/*.cu is compiled for sm_90a by its own nvcc process, all
started together, and the objects are linked into one shared library with
a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu      (one per source, in parallel)
    nvcc -shared -o _build/libkgt_kernels.so <objects>

The library lands in kgl_gene_tpu_torch/_build/ (listed in .gitignore) on
first use and is rebuilt when any source is newer than it. Nothing outside
the package's sources is needed besides the CUDA toolkit. Nothing is built
or loaded at import time: the CPU tests import every module.

Each C entry point launches on the stream it is handed and returns the
cudaError_t of the launch; launch() raises on any nonzero code. LAUNCHES
counts launches per kernel name, one for each successful launch.

The small kernels cost less on the device than their launch costs on the
host, so launch() keeps the host side short: the C functions are looked up
once, the raw handle of the current stream comes from one C call, and the
CUDA device is switched only for a tensor that does not lie on the current
one. scripts/torch_launch_cost.py times each of these pieces on the card.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "build", "check_args", "current_stream_handle", "launch", "library",
           "reset_launches"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libkgt_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int64
# C signatures: every pointer and the stream as c_void_p, sizes as int64.
_SIGNATURES = {
    # coding, row_stride, B, k, lut, out, stream
    "kgt_translate": (_P, _I, _I, _I, _P, _P, _P),
    # a, a_stride, Wa, b, b_stride, Wb, la, lb, out, B, stream
    "kgt_wavefront": (_P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _P),
    # the same arguments with the layout (G lanes a pair, K blocks a lane)
    # before stream: the local (infix) distance, the shorter row the query
    "kgt_local": (_P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P),
    # a, a_stride, Wa, text, text_stride, Wt, la, lb, out, B, band_k, stream
    "kgt_myers": (_P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _P),
    # as kgt_myers, with body (1 group, 0 thread, -1 by the rule) before stream
    "kgt_myers_with_body": (_P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P),
    # a, a_stride, Wa, b, b_stride, Wb, la, lb, out, B, band_k, body (1 warp,
    # 0 block, -1 by the band), stream
    "kgt_banded": (_P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P),
    # a, a_stride, Wa, b, b_stride, Wb, la, lb, codes, pair_pitch, B, M, band_k,
    # body (1 warp, 0 block, -1 by the band), stream
    "kgt_banded_choices": (_P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # codes, row_stride, pair_stride, M, W, la, lb, ops, counts, B, band_k,
    # max_steps, stream
    "kgt_walk": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P),
    # ptr_i, ids_i, ic_i, ni, ptr_j, ids_j, ic_j, nj, tile, entries, out,
    # symmetric, stream: compact rows
    "kgt_mica": (_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _I, _P),
    # a_lane, b, b_stride, Mb, la, lb, src_pp, src_p, dst_pp, dst_p, result, B, W,
    # i0, Ma, d0, h, k_first, H_own, warps, stream: one launch (a chunk, or a
    # sub-step of one) of the sharded long-pair wavefront
    "kgt_wavefront_chunk": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _P),
    # a_lane, b, b_stride, Mb, la, lb, pp0, p0, pp1, p1, result, B, W, i0, Ma, d0,
    # H, n, warps, stream: n chunks in one cooperative launch
    "kgt_wavefront_chunks": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P),
    # codes, G, L, af, valid, mask (0 none, 1 per locus, 2 per genome),
    # chunk_loci, terms, logs, partial, tickets, lo, hi, stream: the
    # Loglikelihood's tables, its grid and first bracket (two kernels)
    "kgt_loglik_grid": (_P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # codes, G, L, valid, mask, chunk_loci, terms, partial, tickets, lo, hi,
    # out (null but on the last step), stream: one golden-section step
    "kgt_loglik_step": (_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # codes, G, L, af, valid, mask, wide (4-byte row loads), chunk_loci, first,
    # state, partial, tickets, running, skipped, stream: one HallME step
    "kgt_hallme_step": (_P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    # codes, V, G, row stride, mask, counts, stream: FWS pass one, each
    # variant's codes 1 and 2 over the masked genomes
    "kgt_fws_variants": (_P, _I, _I, _I, _P, _P, _P),
    # codes, G, row stride, order, hs, bounds, S, Gp, het, hom, hs sums,
    # stream: FWS pass two, each genome's sums over each segment of rows
    "kgt_fws_genomes": (_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P),
    # next, hops, l2_only, out, stream: a pointer chase of one thread, timed
    # by chip_smoke.py for the walk's latency bound
    "kgt_chase": (_P, _I, _I, _P, _P),
    # coding, row_stride, k, out -> 1 (vector body) or 0 (scalar); no launch
    "kgt_translate_body": (_P, _I, _I, _P),
    # B, Wa, Wt, band_k -> 1 (group body) or 0 (thread); no launch
    "kgt_myers_body": (_I, _I, _I, _I),
    # G, K, Wa, Wb, out: kgt_local's layout (G, K) into out (3 int64, host):
    # blocks an SM holds, registers and local bytes a thread (-1: a layout
    # the kernel lacks); no launch
    "kgt_local_resources": (_I, _I, _I, _I, _P),
    # tile, entries -> blocks of kgt_mica an SM holds; no launch
    "kgt_mica_occupancy": (_I, _I),
    # warps, H -> blocks of kgt_wavefront_chunks the current device holds at
    # once (-1: a geometry the kernel refuses); no launch
    "kgt_wavefront_chunks_blocks": (_I, _I),
    # kind (0 the grid, 1 a step), mask -> blocks of the Loglikelihood
    # kernel an SM of the current device holds; no launch
    "kgt_loglik_blocks": (_I, _I),
    # mask, wide -> blocks of a HallME step an SM of the current device
    # holds; no launch
    "kgt_hallme_blocks": (_I, _I),
    # band_k -> 1 (warp body) or 0 (block); no launch
    "kgt_banded_body": (_I,),
    "kgt_banded_choices_body": (_I,),
}

LAUNCHES: collections.Counter = collections.Counter()
_lib = None
_entry_points: dict = {}  # C function by name, filled by library()
# The current stream's cudaStream_t as an int, in one C call; a build of
# torch without CUDA lacks it, and never launches.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
build_log = ""


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile csrc/*.cu into LIB_PATH unless it is newer than every
    source. Returns the library's path; raises with nvcc's output on any
    failure. The compiler's resource report is kept in build_log."""
    global build_log
    sources = sorted(CSRC.glob("*.cu"))
    newest = max(p.stat().st_mtime for p in [*sources, *CSRC.glob("*.cuh")])
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= newest:
        return LIB_PATH
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_lib = Path(tmp) / LIB_PATH.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _s, o, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, LIB_PATH)
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _entry_points[name] = fn
        lib.kgt_error_string.argtypes = [ctypes.c_int]
        lib.kgt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_args(dtype, **tensors) -> None:
    """Raise unless every tensor lies on the card, has `dtype` and is
    contiguous: what the kernels take."""
    for name, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{name} must be on the card, got {x.device}")
        if x.dtype is not dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def current_stream_handle(index: int) -> int:
    """cudaStream_t of device `index`'s current stream, as an int."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(kernel: str, name: str, device: torch.device, *args) -> None:
    """Call C entry point `name` on `device`'s current stream, raise if the
    launch returned an error, and count one launch of `kernel`. `device`
    is that of the tensors behind the pointers in `args`."""
    fn = _entry_points.get(name) or getattr(library(), name)
    index = device.index
    if index == torch.cuda.current_device():
        rc = fn(*args, current_stream_handle(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, current_stream_handle(index))
    if rc != 0:
        msg = library().kgt_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    LAUNCHES[kernel] += 1
