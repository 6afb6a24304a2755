"""The two bodies of kernels B1, B4 and B5 side by side, and the walk kernel.

    python3 scripts/torch_kernel_bodies.py [--quick] [--sass]

Builds the kernels and prints the compiler's register and spill report.
Then, on the card:

  1. holds each body of B1 (group: a pair over NB lanes of a warp; thread:
     a pair a thread), of B4 and of B5 (warp: a pair a warp; block: a pair
     a block), and the walk kernel, against the plain PyTorch versions at
     S = 3,000 (exact);
  2. times both bodies of B1 over a grid of pair counts for every band,
     with one shared text and with per-pair texts, on the device alone (a
     CUDA graph replay), and prints which body the launcher's rule takes
     at each: the rule's thresholds (group_max_pairs in csrc/myers.cu)
     were set from this table;
  3. times both bodies of B4 at bands 31 to 255 and the walk kernel at
     the transcript family's shape (256 pairs of 3,000 bases, band 127);
  4. times both bodies of B5 over 256, 4,096 and 32,640 pairs of 3,000
     bases at bands 31 to 255.

--quick stops after step 1. --sass writes the machine code of the new bodies, of the
16 x 16 MICA kernel (csrc/mica.cu, whose instructions a merge step chip_smoke.py's
MICA_MERGE_OPS counts) and of B3 and the local kernel at two slots a lane
(csrc/wavefront.cu), as cuobjdump prints it, to a sass_<kernel>.txt file each first.
Needs a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import S, banded_case, exact, nvidia_smi_line, time_device  # noqa: E402
from kgl_gene_tpu_torch import kernels  # noqa: E402
from kgl_gene_tpu_torch.ops.banded import (  # noqa: E402
    banded_choices, banded_choices_kernel_body, banded_choices_plain, banded_distance,
    banded_kernel_body, banded_plain,
)
from kgl_gene_tpu_torch.ops.myers import (  # noqa: E402
    MYERS_BANDS, myers_distance_padded, myers_kernel_body, myers_layout, myers_plain,
)
from kgl_gene_tpu_torch.ops.traceback import tb_walk, tb_walk_plain  # noqa: E402


def mutants(rng, B, edits):
    """(a, la, ref, lb): B mutants of one 3,000-base reference with up to
    `edits` substitutions each, full lengths."""
    ref = rng.integers(0, 4, size=S).astype(np.int32)
    a = np.tile(ref, (B, 1))
    for i in range(B):
        n = int(rng.integers(0, edits + 1))
        pos = rng.choice(S, n, replace=False)
        a[i, pos] = (a[i, pos] + 1 + rng.integers(0, 3, n)) % 4
    lens = np.full(B, S, np.int32)
    return a, lens, ref[None, :], lens


def check(dev):
    rng = np.random.default_rng(7)
    a, la, b, lb = (torch.as_tensor(x, device=dev) for x in banded_case(rng, 64))
    ref = b[:1].contiguous()
    for k in MYERS_BANDS:
        for text, name in ((ref, "shared"), (b, "per-pair")):
            want = myers_plain(a, la, text, lb, k)
            for body in ("group", "thread"):
                exact(f"B1 {body} body k={k} {name} text (B=64, S={S}, ragged)",
                      myers_distance_padded(a, la, text, lb, band_k=k, _body=body), want)
    a16, la16, b16, lb16 = (x[:16].contiguous() for x in (a, la, b, lb))
    for k in (31, 63, 127, 255):
        want = banded_choices_plain(a16, la16, b16, lb16, k, a16.shape[1])
        for body in ("warp", "block"):
            exact(f"B4 {body} body k={k} (B=16, S={S}, ragged)",
                  banded_choices(a16, la16, b16, lb16, band_k=k, _body=body), want)
    # B5: B = 64, 63 and 1; ragged pairs with la = 0, lb = 0 and gaps
    # beyond the band.
    for k in (0, 15, 63, 127, 255, 511):
        for n in (64, 63, 1):
            args = (a[:n], la[:n], b[:n], lb[:n])
            want = banded_plain(*args, k)
            for body in ("warp", "block") if k <= 255 else ("block",):
                exact(f"B5 {body} body k={k} (B={n}, S={S}, ragged)",
                      banded_distance(*args, band_k=k, _body=body), want)
    codes = banded_choices(a, la, b, lb, band_k=127)
    got = tb_walk(codes, la, lb, band_k=127, max_steps=300)
    want = tb_walk_plain(codes, la, lb, band_k=127, max_steps=300)
    exact("walk ops (B=64, k=127, 300 steps)", got[0], want[0])
    exact("walk counts", got[1], want[1])
    torch.cuda.synchronize()


def time_myers(dev):
    rng = np.random.default_rng(8)
    grid = (64, 256, 1024, 4096, 8192, 16384, 32768)
    a, la, ref, lb = mutants(rng, max(grid), 48)
    a_t, la_t, ref_t, lb_t = (torch.as_tensor(x, device=dev) for x in (a, la, ref, lb))
    b_t = a_t.roll(1, 0).contiguous()
    print("B1 device ms: band NB text B | group thread | rule")
    for k in MYERS_BANDS[1:]:
        NB = myers_layout(k)[1]
        for text, name in ((ref_t, "shared"), (b_t, "per-pair")):
            for B in grid:
                args = (a_t[:B], la_t[:B], text[:B] if text.shape[0] > 1 else text, lb_t[:B])
                ms = {body: time_device(
                    [lambda body=body: myers_distance_padded(*args, band_k=k, _body=body)], 3,
                    windows=3) for body in ("group", "thread")}
                print(f"  k={k} NB={NB} {name} B={B}: group {ms['group']:.6f} thread "
                      f"{ms['thread']:.6f} | rule takes {myers_kernel_body(B, S, S, k)}", flush=True)


def time_choices_and_walk(dev):
    rng = np.random.default_rng(9)
    a, la, ref, lb = mutants(rng, 256, 48)
    a_t, la_t, lb_t = (torch.as_tensor(x, device=dev) for x in (a, la, lb))
    ref_t = torch.as_tensor(np.tile(ref, (256, 1)), device=dev)
    for k in (31, 63, 127, 255):
        ms = {body: time_device(
            [lambda body=body: banded_choices(ref_t, lb_t, a_t, la_t, band_k=k, _body=body)], 3,
            windows=3) for body in ("warp", "block")}
        print(f"B4 device ms, B=256 S={S} k={k}: warp {ms['warp']:.6f} block {ms['block']:.6f} "
              f"| rule takes {banded_choices_kernel_body(k)}", flush=True)
    k = 127
    codes = banded_choices(ref_t, lb_t, a_t, la_t, band_k=k)
    steps = 2 * k + 1 + (S + 252) // 253 + 8
    ms = time_device([lambda: tb_walk(codes, lb_t, la_t, band_k=k, max_steps=steps)], 5)
    print(f"walk device ms, B=256 k={k} {steps} steps: {ms:.6f}")


def time_banded(dev):
    rng = np.random.default_rng(10)
    grid = (256, 4096, 32640)
    a, la, _ref, lb = mutants(rng, max(grid), 48)
    a_t, la_t, lb_t = (torch.as_tensor(x, device=dev) for x in (a, la, lb))
    b_t = a_t.roll(1, 0).contiguous()
    for k in (31, 63, 127, 255):
        for B in grid:
            args = (a_t[:B], la_t[:B], b_t[:B], lb_t[:B])
            ms = {body: time_device(
                [lambda body=body: banded_distance(*args, band_k=k, _body=body)],
                3 if B > 4096 else 10, windows=3) for body in ("warp", "block")}
            print(f"B5 device ms, B={B} S={S} k={k}: warp {ms['warp']:.6f} block "
                  f"{ms['block']:.6f} | rule takes {banded_kernel_body(k)}", flush=True)


def dump_sass():
    """The SASS of each new kernel body, one file a kernel."""
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(kernels.LIB_PATH)], capture_output=True,
                          text=True, check=True).stdout
    for chunk in text.split("\t\tFunction : ")[1:]:
        name = chunk.split("\n", 1)[0]
        for key in ("myers_group_kernelILi3E", "banded_warp_kernelILi8ELb1E",
                    "banded_warp_kernelILi8ELb0E", "walk_kernel", "mica_kernelILi16E",
                    "bitvector_kernelILi2ELb0E", "bitvector_kernelILi2ELb1E"):
            if key in name:
                with open(os.path.join(out_dir, f"sass_{key}.txt"), "w") as f:
                    f.write(chunk)
                print(f"  SASS of {key}: {chunk.count(chr(10)) // 2} lines")


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {nvidia_smi_line()}")
    kernels.library()
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("==") or "Compiling" in line:
            print("  " + line.strip())
    if "--sass" in sys.argv:
        dump_sass()
    dev = torch.device("cuda")
    check(dev)
    if "--quick" not in sys.argv:
        time_myers(dev)
        time_choices_and_walk(dev)
        time_banded(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
