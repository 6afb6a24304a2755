"""Where the port's forward step spends its time on the card.

    python3 scripts/torch_profile_step.py

Runs kgl_gene_tpu_torch's forward step at the bench shape (4,800 bp
region, two exons to 3,000 coding bases, K = 48 SNP slots) at B = 256 and
B = 4,096 under torch.profiler, and prints for each: the host wall time
per step, the device time per step by kernel, and the device's busy share
of the window (device kernel time over wall time; one stream, so kernels
do not overlap). Chrome traces go to chiprun_out/. Needs a CUDA device.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import EXONS, REGION_LEN, gene_region, nvidia_smi_line, snp_batch  # noqa: E402
from kgl_gene_tpu_torch.ops.pipeline import make_forward_step  # noqa: E402

STEPS = 10


def device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {nvidia_smi_line()}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    region = gene_region(rng)
    step = make_forward_step(region, EXONS, 0)
    for B in (256, 4096):
        inputs = [torch.as_tensor(x, device="cuda") for x in snp_batch(rng, B, 48, REGION_LEN)]
        for _ in range(5):
            step(*inputs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                step(*inputs)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / STEPS
        # Device-side events only: a CPU op's self device time repeats the
        # time of the kernels it launched.
        events = [e for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CPU and device_us(e) > 0]
        dev = sum(device_us(e) for e in events) / STEPS
        print(f"B={B}: wall {wall * 1e3:.4f} ms/step (profiled), device {dev / 1e3:.4f} ms/step, "
              f"busy share {dev / (wall * 1e6):.3f}, {len(events)} kernel kinds")
        for e in sorted(events, key=device_us, reverse=True)[:15]:
            print(f"  {device_us(e) / STEPS:10.2f} us/step  x{e.count // STEPS:<3d} {e.key[:90]}")
        prof.export_chrome_trace(os.path.join(out_dir, f"torch_step_B{B}.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
