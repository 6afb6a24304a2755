#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels under kgl_gene_tpu_torch/csrc, holds each one against
its plain PyTorch version on the card (exact integer equality), drives the
port's forward step (kgl_gene_tpu_torch.ops.pipeline.make_forward_step)
through five configurations and checks every output against the plain
forward on the CPU, then times the step and each kernel. It imports
nothing of JAX or of the JAX package.

Output: progress lines, then one JSON line {"kernels": [...]}, the card's
name and power limit from nvidia-smi, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, with no result, when there
is no CUDA device, when the port is missing, or when any phase fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

SEED = 0
REGION_LEN = 4800
EXONS = np.array([[400, 1900], [2400, 3900]], dtype=np.int64)  # 3,000 coding bases
S = 3000
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# H100 SXM peak rates list no int32 rate outside the tensor cores; the
# float32 rate (67 T/s) stands in, which makes every bound of an integer
# kernel a floor (Hopper issues int32 at half that rate).
OPS_PER_S = 67e12
MYERS_OPS_PER_BLOCK_COLUMN = 34  # 17 word ops of 64 bits, two int32 ops each
WAVEFRONT_OPS_PER_CELL = 6       # compare, 2 adds, 2 mins, store select


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters, windows=5):
    """Median over `windows` of the mean ms per call, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / iters)
    return statistics.median(per)


def gene_region(rng):
    """A random region whose exons splice to an open reading frame: ATG,
    998 random sense codons, TAA. SNPs then give every validity code."""
    region = rng.integers(0, 4, size=REGION_LEN).astype(np.uint8)
    stops = {48, 50, 56}  # TAA, TAG, TGA
    sense = np.array([c for c in range(64) if c not in stops])
    codons = np.concatenate([[14], rng.choice(sense, S // 3 - 2), [48]])  # ATG ... TAA
    coding = np.stack([codons // 16, codons // 4 % 4, codons % 4], 1).reshape(-1)
    at = 0
    for lo, hi in EXONS:
        region[lo:hi] = coding[at : at + hi - lo]
        at += hi - lo
    return region.astype(np.uint8)


def snp_batch(rng, B, K, L):
    positions = rng.integers(0, L, size=(B, K)).astype(np.int32)
    alt = rng.integers(0, 4, size=(B, K)).astype(np.uint8)
    valid = rng.random((B, K)) < 0.8
    return positions, alt, valid


def exact(name, got, want):
    """max |got - want| over integer tensors; raises unless 0."""
    import torch

    got = got.cpu().to(torch.int64)
    want = want.cpu().to(torch.int64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got - want).abs().max()) if got.numel() else 0
    if err:
        bad = int((got != want).sum())
        raise AssertionError(f"{name}: {bad} entries differ, max abs err {err}")
    log(f"  {name}: exact ({got.numel()} values)")
    return err


def phase_kernels(dev, errs):
    """Each kernel against its plain version on the card."""
    import torch

    from kgl_gene_tpu_torch.ops.edit_distance import batched_levenshtein
    from kgl_gene_tpu_torch.ops.myers import myers_distance_padded, myers_plain
    from kgl_gene_tpu_torch.ops.variant_apply import (
        translate_batch, translate_batch_kernel,
    )
    from kgl_gene_tpu_torch.ops.wavefront import batched_levenshtein_kernel
    from kgl_gene_tpu_torch.sequence.tables import amino_translation_table

    rng = np.random.default_rng(SEED + 1)

    # B2: (256, 3000) with N codons present.
    coding = rng.integers(0, 4, size=(256, S)).astype(np.uint8)
    coding[rng.random(coding.shape) < 0.01] = 4
    coding_t = torch.as_tensor(coding, device=dev)
    for name in ("NCBI_TABLE_1", "NCBI_TABLE_2"):
        lut = torch.as_tensor(amino_translation_table(name).amino_lut, device=dev)
        errs["translate"] = max(errs["translate"], exact(
            f"B2 translate {name} (256, {S})",
            translate_batch_kernel(coding_t, lut), translate_batch(coding_t, lut)))

    # B1: shared text, bands 31/63/127 at S = 3000, B = 256, ragged la/lb,
    # lb = 0, la = 0, pairs far outside the band.
    B = 256
    ref = rng.integers(0, 5, size=S).astype(np.int32)
    a = np.tile(ref, (B, 1))
    for i in range(B):
        n = int(rng.integers(0, 140))
        pos = rng.choice(S, n, replace=False)
        a[i, pos] = (a[i, pos] + 1 + rng.integers(0, 4, n)) % 5
    a[:8] = rng.integers(0, 5, size=(8, S))  # unrelated: distance >> band
    la = np.full(B, S, np.int32) - rng.integers(0, 200, B).astype(np.int32)
    lb = np.full(B, S, np.int32) - rng.integers(0, 200, B).astype(np.int32)
    la[8], lb[9], la[10], lb[10] = 0, 0, 0, 0
    lb[11] = S - 500  # |la - lb| beyond every band
    a_t, la_t, lb_t = (torch.as_tensor(x, device=dev) for x in (a, la, lb))
    ref_t = torch.as_tensor(ref[None, :], device=dev)
    for k in (31, 63, 127):
        errs["myers"] = max(errs["myers"], exact(
            f"B1 myers shared text k={k} (B={B}, S={S})",
            myers_distance_padded(a_t, la_t, ref_t, lb_t, band_k=k),
            myers_plain(a_t, la_t, ref_t, lb_t, k)))
    per_pair = torch.as_tensor(np.roll(a, 1, axis=0), device=dev)
    errs["myers"] = max(errs["myers"], exact(
        f"B1 myers per-pair text k=63 (B={B}, S={S})",
        myers_distance_padded(a_t, la_t, per_pair, lb_t, band_k=63),
        myers_plain(a_t, la_t, per_pair, lb_t, 63)))

    # B3: the entry() shape (S = 120, shared reference) and S = 3000,
    # B = 64, ragged per-pair lengths.
    e_ref = rng.integers(0, 4, size=(1, 120)).astype(np.int32)
    e_a = np.tile(e_ref, (8, 1))
    e_a[rng.random(e_a.shape) < 0.05] = 2
    e_l = np.full(8, 120, np.int32)
    args = [torch.as_tensor(x, device=dev) for x in (e_a, e_l, e_ref, e_l)]
    errs["wavefront"] = max(errs["wavefront"], exact(
        "B3 wavefront entry shape (B=8, S=120)",
        batched_levenshtein_kernel(*args), batched_levenshtein(*args)))
    wa = torch.as_tensor(a[:64], device=dev)
    wb = torch.as_tensor(np.roll(a, 3, axis=0)[:64], device=dev)
    args = [wa, la_t[:64].contiguous(), wb, lb_t[:64].contiguous()]
    errs["wavefront"] = max(errs["wavefront"], exact(
        f"B3 wavefront ragged (B=64, S={S})",
        batched_levenshtein_kernel(*args), batched_levenshtein(*args)))
    torch.cuda.synchronize()


def main_path_configs(rng, region):
    """name -> (make_forward_step kwargs, inputs, kernels expected)."""
    from kgl_gene_tpu_torch.entry import example_batch, example_geometry

    e_region, e_exons = example_geometry()
    gene = dict(region_codes=region, exon_intervals=EXONS, region_start=0)
    return {
        "a bench B=256 K=48": (dict(gene), snp_batch(rng, 256, 48, REGION_LEN), "myers"),
        "b population B=4096 K=48": (dict(gene), snp_batch(rng, 4096, 48, REGION_LEN), "myers"),
        "c reverse strand B=4096 K=48": (dict(gene, reverse_strand=True),
                                         snp_batch(rng, 4096, 48, REGION_LEN), "myers"),
        "d wavefront B=256 K=160": (dict(gene), snp_batch(rng, 256, 160, REGION_LEN), "wavefront"),
        "e entry()": (dict(region_codes=e_region, exon_intervals=e_exons, region_start=0),
                      example_batch(8, 6, len(e_region)), "wavefront"),
    }


def phase_main_path(dev, configs):
    """Drive every configuration on the card with the launch counts set to
    0 just before and read just after; then hold each against the plain
    forward on the CPU. Returns the counts of the whole run."""
    import torch

    from kgl_gene_tpu_torch import kernels
    from kgl_gene_tpu_torch.ops.pipeline import make_forward_step

    steps = {name: make_forward_step(**kw, device=dev) for name, (kw, _i, _k) in configs.items()}
    inputs = {name: tuple(torch.as_tensor(x, device=dev) for x in inp)
              for name, (_kw, inp, _k) in configs.items()}
    torch.cuda.synchronize()
    outs, per_config = {}, {}
    kernels.reset_launches()
    before = {}
    for name in configs:
        out = steps[name](*inputs[name])
        torch.cuda.synchronize()
        now = dict(kernels.LAUNCHES)
        per_config[name] = {k: now.get(k, 0) - before.get(k, 0) for k in ("translate", "myers", "wavefront")}
        before = now
        outs[name] = out
    total = dict(kernels.LAUNCHES)

    for name, (kw, inp, dist_kernel) in configs.items():
        counts = per_config[name]
        log(f"  {name}: launches {counts}")
        other = "wavefront" if dist_kernel == "myers" else "myers"
        if counts["translate"] < 1 or counts[dist_kernel] < 1 or counts[other]:
            raise AssertionError(f"{name}: expected translate and {dist_kernel}, got {counts}")
        t0 = time.perf_counter()
        plain = make_forward_step(**kw, device="cpu")(*inp)
        log(f"    plain CPU forward {time.perf_counter() - t0:.1f} s")
        got = outs[name]
        for field in got._fields:
            g, p = getattr(got, field), getattr(plain, field)
            if g.dtype != p.dtype:
                raise AssertionError(f"{name}.{field}: dtype {g.dtype} != {p.dtype}")
            exact(f"{name}.{field}", g, p)
        n_valid = torch.as_tensor(inp[2]).sum(1)
        if bool((got.distance.cpu().to(torch.int64) > n_valid).any()):
            raise AssertionError(f"{name}: a distance exceeds its number of valid SNPs")
        if not bool((got.distance >= 0).all()):
            raise AssertionError(f"{name}: negative distance")
    return total, steps, inputs


def phase_times(dev, steps, inputs, configs):
    import torch

    from kgl_gene_tpu_torch.ops.edit_distance import batched_levenshtein
    from kgl_gene_tpu_torch.ops.myers import myers_distance_padded, myers_plain
    from kgl_gene_tpu_torch.ops.variant_apply import (
        _codon_index, translate_batch, translate_batch_kernel,
    )
    from kgl_gene_tpu_torch.ops.wavefront import batched_levenshtein_kernel
    from kgl_gene_tpu_torch.sequence.tables import amino_translation_table

    for name in ("a bench B=256 K=48", "b population B=4096 K=48"):
        step, inp = steps[name], inputs[name]
        for _ in range(3):
            step(*inp)
        torch.cuda.synchronize()
        per = []
        for _ in range(20):
            t0 = time.perf_counter()
            step(*inp)
            torch.cuda.synchronize()
            per.append(time.perf_counter() - t0)
        med = statistics.median(per)
        B = inp[0].shape[0]
        log(f"  step {name}: median {med * 1e3:.4f} ms over 20, {B / med:.1f} genomes/s")

    # Kernel inputs at the main path's shapes: (a) for B2 and B1, (d) for B3.
    out_a = steps["a bench B=256 K=48"](*inputs["a bench B=256 K=48"])
    coding = out_a.mutated_coding
    region = configs["a bench B=256 K=48"][0]["region_codes"]
    ref = np.concatenate([region[lo:hi] for lo, hi in EXONS]).astype(np.int32)
    ref_t = torch.as_tensor(ref[None, :], device=dev)
    lut = torch.as_tensor(amino_translation_table().amino_lut, device=dev)
    B = coding.shape[0]
    a32 = coding.to(torch.int32)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    coding_d = steps["d wavefront B=256 K=160"](*inputs["d wavefront B=256 K=160"]).mutated_coding
    d32 = coding_d.to(torch.int32)
    lens_d = torch.full((d32.shape[0],), S, dtype=torch.int32, device=dev)
    idx = _codon_index(coding)
    torch.cuda.synchronize()

    k = S // 3
    rows = []
    t_ms = time_cuda(lambda: translate_batch_kernel(coding, lut), 200)
    p_ms = time_cuda(lambda: translate_batch(coding, lut), 50)
    l_ms = time_cuda(lambda: lut[idx], 200)
    nbytes = B * S + B * k + 65
    rows.append(dict(
        name="translate", route="cuda", source="kgl_gene_tpu_torch/csrc/translate.cu",
        replaces="kgl_gene_tpu/ops/variant_apply.py:95", shape=f"({B}, {S}) uint8",
        ms=t_ms, plain_ms=p_ms, library_ms=l_ms,
        bound_ms=max(nbytes / MEM_BYTES_PER_S, B * k * 8 / OPS_PER_S) * 1e3,
        bound_by="bytes"))

    NB = 3  # band 63
    m_ms = time_cuda(lambda: myers_distance_padded(a32, lens, ref_t, lens, band_k=63), 20)
    mp_ms = time_cuda(lambda: myers_plain(a32, lens, ref_t, lens, 63), 1, windows=3)
    ops = B * S * NB * MYERS_OPS_PER_BLOCK_COLUMN
    nbytes = B * S * 4 + S * 4 + 3 * B * 4
    rows.append(dict(
        name="myers", route="cuda", source="kgl_gene_tpu_torch/csrc/myers.cu",
        replaces="kgl_gene_tpu/ops/pallas_myers.py:74", shape=f"B={B} S={S} k=63 shared text",
        ms=m_ms, plain_ms=mp_ms, library_ms=None,
        bound_ms=max(ops / OPS_PER_S, nbytes / MEM_BYTES_PER_S) * 1e3,
        bound_by="operations" if ops / OPS_PER_S >= nbytes / MEM_BYTES_PER_S else "bytes"))

    Bd = d32.shape[0]
    w_ms = time_cuda(lambda: batched_levenshtein_kernel(d32, lens_d, ref_t, lens_d), 10)
    wp_ms = time_cuda(lambda: batched_levenshtein(d32, lens_d, ref_t, lens_d), 1, windows=3)
    ops = Bd * S * S * WAVEFRONT_OPS_PER_CELL
    nbytes = Bd * S * 4 + S * 4 + 3 * Bd * 4
    rows.append(dict(
        name="wavefront", route="cuda", source="kgl_gene_tpu_torch/csrc/wavefront.cu",
        replaces="kgl_gene_tpu/ops/pallas_edit_distance.py:36", shape=f"B={Bd} S={S} shared reference",
        ms=w_ms, plain_ms=wp_ms, library_ms=None,
        bound_ms=max(ops / OPS_PER_S, nbytes / MEM_BYTES_PER_S) * 1e3,
        bound_by="operations" if ops / OPS_PER_S >= nbytes / MEM_BYTES_PER_S else "bytes"))
    for r in rows:
        log(f"  kernel {r['name']} at {r['shape']}: {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), library {r['library_ms']}")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from kgl_gene_tpu_torch import kernels
    except ImportError as exc:
        print(f"chip_smoke: the port is missing ({exc})", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    card = nvidia_smi_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    errs = {"translate": 0, "myers": 0, "wavefront": 0}
    phase = "build"
    try:
        log("phase 1: build")
        t0 = time.perf_counter()
        kernels.library()
        log(f"  built and loaded in {time.perf_counter() - t0:.1f} s")
        for line in kernels.build_log.splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log("  " + line.strip())

        phase = "kernels against plain versions"
        log(f"phase 2: {phase}")
        phase_kernels(dev, errs)

        phase = "main path"
        log(f"phase 3: {phase}")
        rng = np.random.default_rng(SEED)
        region = gene_region(rng)
        configs = main_path_configs(rng, region)
        launches, steps, inputs = phase_main_path(dev, configs)
        log(f"  main path launches: {launches}")
        for name in errs:
            if launches.get(name, 0) < 1:
                raise AssertionError(f"kernel {name} never launched on the main path")

        phase = "times"
        log(f"phase 4: {phase}")
        rows = phase_times(dev, steps, inputs, configs)
    except Exception:  # noqa: BLE001 - report the failing phase and exit non-zero
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' failed", file=sys.stderr)
        return 1

    report = []
    for r in rows:
        report.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": launches.get(r["name"], 0),
            "max_abs_err": errs[r["name"]], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": report}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
