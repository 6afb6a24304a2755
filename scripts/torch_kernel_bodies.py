"""The two bodies of kernels B1, B4 and B5 side by side, the walk kernel, the
MICA kernel, and the chunk kernel of the sharded long-pair wavefront.

    python3 scripts/torch_kernel_bodies.py [--quick] [--sass] [--mica-order] [--chunk] [--local]

Builds the kernels and prints the compiler's register and spill report.
Then, on the card:

  1. holds each body of B1 (group: a pair over NB lanes of a warp; thread:
     a pair a thread), of B4 and of B5 (warp: a pair a warp; block: a pair
     a block), and the walk kernel, against the plain PyTorch versions at
     S = 3,000 (exact), and the MICA kernel (csrc/mica.cu: kgt_mica on
     compact rows) against mica_plain;
  2. times both bodies of B1 over a grid of pair counts for every band,
     with one shared text and with per-pair texts, on the device alone (a
     CUDA graph replay), and prints which body the launcher's rule takes
     at each: the rule's thresholds (group_max_pairs in csrc/myers.cu)
     were set from this table;
  3. times both bodies of B4 at bands 31 to 255, and the walk kernel
     (csrc/walk.cu: kgt_walk, step-major tapes and an early exit) at
     chip_smoke.py phase 4's shape, warm and right after a fresh B4;
  4. times both bodies of B5 over 256, 4,096 and 32,640 pairs of 3,000
     bases at bands 31 to 255.

  5. times the chunk kernel (csrc/sharded_wavefront.cu: kgt_wavefront_chunk,
     4 lanes a thread, a warp exchange every 32 steps), held against
     chunk_plain, on the middle chunk (128 diagonals) of chip_smoke.py's
     32,768-base pair from the pair's real DP state; then at every count
     of warps a block (the table behind chunk_geometry's rule), and the
     cooperative route (kgt_wavefront_chunks) at 8 and 64 chunks a launch
     and over the whole pair.

  6. (--local) holds kernel `local` (csrc/wavefront.cu, kgt_local) in
     every layout of its table (ops/local.py LOCAL_LAYOUTS) that holds the
     width against the layout of a pair a warp and the word-level plain
     version, then times the layout of a pair a warp (G = 32) and the
     rule's group layout over pair counts at 2,181 (kelch13), 2,304 and
     3,000 bases, on the device alone: the table behind GROUP_MIN_PAIRS;
     and prints each layout's live share, shared memory and warps an SM.

--quick stops after step 1; --chunk runs step 5 alone after it, --local step 6. --mica-order then times the MICA kernel on
chip_smoke.py phase 3f's 8,192 rows as the port orders them (each tile's
rows by length inside the block) and with all rows put in one order by
length first, the alternative the design did not take, with each order's
lane slots, shared memory and blocks an SM. --sass writes the machine code of the new bodies, of
the MICA kernel (csrc/mica.cu; chip_smoke.py's MICA_MERGE_OPS counts the merge loop of
mica_rows_kernel) and of B3 and the local kernel at one and two slots a lane
(csrc/wavefront.cu), and of both chunk kernels, as cuobjdump prints it, to a
sass_<kernel>.txt file each first, with the instructions of the chunk
body's loop of 32 steps (128 cells a thread) counted.
Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from kgl_gene_tpu_torch import kernels  # noqa: E402
from kgl_gene_tpu_torch.ops.banded import (  # noqa: E402
    banded_choices, banded_choices_kernel_body, banded_choices_plain, banded_distance,
    banded_kernel_body, banded_plain,
)
from kgl_gene_tpu_torch.ops.local import (  # noqa: E402
    GROUP_MIN_PAIRS, LOCAL_LAYOUTS, batched_levenshtein_local_kernel, bitvector_local_plain,
    live_share, local_layout, local_smem_bytes,
)
from kgl_gene_tpu_torch.ops.myers import (  # noqa: E402
    MYERS_BANDS, myers_distance_padded, myers_kernel_body, myers_layout, myers_plain,
)
from kgl_gene_tpu_torch.ops.sharded_wavefront import (  # noqa: E402
    CHUNK_EXCHANGE_STEPS, CHUNK_LANES_A_THREAD,
)
from kgl_gene_tpu_torch.ops.similarity import (  # noqa: E402
    ancestor_lists, mica, mica_plain, mica_rows, mica_smem_bytes, mica_tile, row_set,
)
from kgl_gene_tpu_torch.ops.traceback import tb_walk, tb_walk_plain  # noqa: E402


def chunk_state(dev, halo=128):
    """chip_smoke.py's 32,768-base pair at world 1, its chunks run up to the
    middle one: (rank lanes, d0 of the middle chunk, its index)."""
    from chip_smoke import MULTI_LONG, MULTI_LONG_EDITS, SEED, long_pair

    from kgl_gene_tpu_torch.ops import sharded_wavefront as sw

    pair = long_pair(np.random.default_rng(SEED + 6), MULTI_LONG[0], *MULTI_LONG_EDITS)
    s = sw.rank_lanes(*pair, 0, 1, halo, dev)
    c = s.n_chunks // 2
    return sw.run_chunks(s, 0, c), 2 + c * s.H, c, pair


def time_chunk(dev):
    """Step 5: the chunk kernel, the warps a block, the cooperative route."""
    from chip_smoke import time_device

    from kgl_gene_tpu_torch.ops import sharded_wavefront as sw

    s, d0, c, pair = chunk_state(dev)
    B, W = s.a_lane.shape
    outs = {name: s._replace(out_pp=s.out_pp.clone(), out_p=s.out_p.clone(),
                             result=s.result.clone())
            for name in ("new", "plain")}

    def body():
        return sw.chunk(outs["new"], d0)

    sw.chunk_plain(outs["plain"], d0)
    body()
    for key in ("out_p", "out_pp"):
        if not torch.equal(getattr(outs["new"], key)[:, s.H:], getattr(outs["plain"], key)[:, s.H:]):
            raise AssertionError("the chunk kernel differs from chunk_plain")
    cells = sum(min(d, s.Ma) - max(0, d - s.Mb) + 1 for d in range(d0, d0 + s.H))
    print(f"chunk {c} of {s.n_chunks} of the {s.Ma}-base pair (H={s.H}, {W - s.H} lanes, "
          f"{cells} cells): equal to chunk_plain", flush=True)
    ms = [time_device([body], 20, windows=3) for _ in range(3)]
    print(f"  device ms: {' / '.join(f'{x:.6f}' for x in ms)}", flush=True)
    rule = sw.chunk_geometry(W - s.H, s.H, B, torch.cuda.get_device_properties(dev).multi_processor_count)
    row = []
    for warps in range(1, 13):
        if sw.block_lanes(warps) <= s.H:
            continue
        o = outs["new"]
        ms = time_device([lambda warps=warps: kernels.launch(
            "wavefront_chunk", "kgt_wavefront_chunk", dev, s.a_lane.data_ptr(), s.b.data_ptr(),
            s.b.stride(0), s.Mb, s.la.data_ptr(), s.lb.data_ptr(), s.pp.data_ptr(),
            s.p.data_ptr(), o.out_pp.data_ptr(), o.out_p.data_ptr(), o.result.data_ptr(), B, W,
            s.i0, s.Ma, d0, s.H, 0, s.H, warps)], 20, windows=3)
        T = sw.block_lanes(warps) - s.H
        row.append(f"{warps}: {ms:.6f} ({-(-(W - s.H) // T)} tiles)")
    print(f"  by warps a block (rule: {rule}): " + ", ".join(row), flush=True)
    for n in (8, 64):
        o = outs["new"]
        ms = time_device([lambda n=n: kernels.launch(
            "wavefront_chunks", "kgt_wavefront_chunks", dev, s.a_lane.data_ptr(), s.b.data_ptr(),
            s.b.stride(0), s.Mb, s.la.data_ptr(), s.lb.data_ptr(), s.pp.data_ptr(), s.p.data_ptr(),
            o.out_pp.data_ptr(), o.out_p.data_ptr(), o.result.data_ptr(), B, W, s.i0, s.Ma, d0,
            s.H, n, rule[0])], 3, windows=3)
        print(f"  cooperative launch of {n} chunks: {ms:.6f} ms on the device, "
              f"{ms / n:.6f} a chunk", flush=True)
    for _ in range(3):
        t = sw.rank_lanes(*pair, 0, 1, s.H, dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t = sw.run_chunks(t, 0, t.n_chunks)
        end.record()
        torch.cuda.synchronize()
        print(f"  the whole pair in one launch ({t.n_chunks} chunks): "
              f"{start.elapsed_time(end):.4f} ms, distance {t.result.tolist()}", flush=True)


def loop_counts(sass):
    """(instructions, SHFL) of the period loop of `sass`, the chunk kernel's
    cuobjdump text: of the bodies between a backward branch and its target,
    the one with the most SHFL (a shuffle a step), and of those the
    shortest (the body without the capture)."""
    import re

    ops = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)", sass)]
    best = None
    for addr, op in ops:
        m = re.search(rf"/\*{addr:04x}\*/[^\n]*BRA[^\n]*?0x([0-9a-f]+)", sass)
        if op != "BRA" or not m or int(m.group(1), 16) >= addr:
            continue
        body = [o for a, o in ops if int(m.group(1), 16) <= a <= addr]
        key = (-sum(o.startswith("SHFL") for o in body), len(body))
        best = key if best is None or key < best else best
    return (best[1], -best[0]) if best else (0, 0)


def mutants(rng, B, edits):
    """(a, la, ref, lb): B mutants of one 3,000-base reference with up to
    `edits` substitutions each, full lengths."""
    from chip_smoke import S

    ref = rng.integers(0, 4, size=S).astype(np.int32)
    a = np.tile(ref, (B, 1))
    for i in range(B):
        n = int(rng.integers(0, edits + 1))
        pos = rng.choice(S, n, replace=False)
        a[i, pos] = (a[i, pos] + 1 + rng.integers(0, 3, n)) % 4
    lens = np.full(B, S, np.int32)
    return a, lens, ref[None, :], lens


def check(dev):
    from chip_smoke import S, banded_case, exact

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
    want = tb_walk_plain(codes, la, lb, band_k=127, max_steps=300)
    got = tb_walk(codes, la, lb, band_k=127, max_steps=300)
    exact("walk ops, kgt_walk (B=64, k=127, 300 steps)", got[0], want[0])
    exact("walk counts, kgt_walk", got[1], want[1])
    lists = np.full((300, 192), -1, np.int32)
    for r in range(300):
        L = int(rng.integers(0, 193))
        lists[r, :L] = np.sort(rng.choice(600, L, replace=False))
    ids = torch.as_tensor(lists, device=dev)
    ic = torch.as_tensor((rng.random(lists.shape) * 8).astype(np.float32), device=dev)
    want = mica_plain(ids, ic, ids, ic)
    if not torch.equal(mica(ids, ic), want):
        raise AssertionError("kgt_mica differs from mica_plain (n=300, K=192)")
    print("kgt_mica (n=300, K=192): equal to mica_plain")
    torch.cuda.synchronize()


def time_myers(dev):
    from chip_smoke import S, time_device

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
    from chip_smoke import S, time_device

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
    time_walk(dev)


def time_walk(dev):
    """The walk kernel at chip_smoke.py phase 4's shape (phase 3b's 256
    mutants against their reference, band 127, 275 steps): on the device
    with the codes in the L2 (a CUDA graph of back-to-back walks), and
    each walk right after a fresh B4 over the same inputs, as
    reference_cigars runs it."""
    from chip_smoke import WALK_COLD_REPS, family_walk_case, time_after, time_device

    choices, rl, plens, k, steps = family_walk_case(dev)
    codes = choices()
    want = tb_walk_plain(codes, rl, plens, band_k=k, max_steps=steps)
    got = tb_walk(codes, rl, plens, band_k=k, max_steps=steps)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("kgt_walk differs from tb_walk_plain at phase 4's shape")
    warm = [time_device([lambda: tb_walk(codes, rl, plens, band_k=k, max_steps=steps)], 10,
                        windows=3) for _ in range(2)]
    cold_ms, = time_after(choices, [lambda c: tb_walk(c, rl, plens, band_k=k, max_steps=steps)],
                          WALK_COLD_REPS)
    print(f"walk kgt_walk, B={len(rl)} k={k} {steps} steps: device ms warm "
          f"{' / '.join(f'{x:.6f}' for x in warm)}, right after B4 {cold_ms:.6f}", flush=True)


def time_banded(dev):
    from chip_smoke import S, time_device

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


def time_mica_order(dev):
    """The MICA kernel on phase 3f's rows in the port's order and in one
    global order by length (whose output comes in that order: no scatter
    back is counted), timed in turns, beside each order's lane slots
    (chip_smoke.mica_work), shared memory and blocks an SM."""
    import tempfile

    from chip_smoke import (
        GO_MAX_TERMS, mica_work, time_cuda_turns, time_device, write_go_gaf, write_go_obo,
    )
    from kgl_gene_tpu_torch.ontology.annotation import TermAnnotation
    from kgl_gene_tpu_torch.ontology.graph import GoGraph
    from kgl_gene_tpu_torch.ontology.information import InformationContent
    from kgl_gene_tpu_torch.ontology.obo import parse_go_file

    with tempfile.TemporaryDirectory() as tmp:
        obo, gaf = os.path.join(tmp, "go.obo"), os.path.join(tmp, "pf3d7.gaf")
        write_go_gaf(gaf, write_go_obo(obo))
        graph = GoGraph(parse_go_file(obo))
        annotation = TermAnnotation.from_gaf_file(gaf, graph=graph)
    info = InformationContent(graph, annotation)
    bp = annotation.all_terms("biological_process")[:GO_MAX_TERMS]
    ids, vals = ancestor_lists(info, np.array([graph.term_index(t) for t in bp]))
    lens = (ids >= 0).sum(1)
    lib = kernels.library()
    orders = {"port": np.arange(len(ids)), "by length": np.argsort(lens, kind="stable")}
    sets = {}
    for name, perm in orders.items():
        off = np.r_[0, np.cumsum(lens[perm])]
        keep = ids[perm] >= 0
        sets[name] = (row_set(off, ids[perm][keep], vals[perm][keep], dev), mica_tile(off, off, True))
    want = mica_rows(sets["port"][0])
    perm = torch.as_tensor(orders["by length"], device=dev)
    if not torch.equal(mica_rows(sets["by length"][0]), want[perm][:, perm]):
        raise AssertionError("the rows in one order by length give another matrix")
    calls = [lambda rows=rows: mica_rows(rows) for rows, _tile in sets.values()]
    host = time_cuda_turns(calls, 5, windows=3)
    least = mica_work(ids, dev)[0]
    print(f"MICA kernel, n = {len(ids)}, K = {ids.shape[1]} (chip_smoke.py phase 3f's rows):")
    for (name, perm), ms, call, (_rows, (tile, entries)) in zip(
            orders.items(), host, calls, sets.values()):
        slots = mica_work(ids[perm], dev)[1]
        print(f"  {name}: {ms:.4f} ms host-inclusive, device {time_device([call], 5, windows=3):.4f}"
              f" ms; lane slots {slots / least:.3f} x the steps; tile {tile}, "
              f"{mica_smem_bytes(tile, entries)} B of shared memory, "
              f"{lib.kgt_mica_occupancy(tile, entries)} blocks an SM", flush=True)


def local_pool(dev, B, S, seed):
    """B pairs of S-base rows with codes 0..3 (the haplotypes' alphabet):
    the second row of each pair a copy of the first with 2% of its bases
    drawn anew, as a gene family's members differ."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randint(0, 4, (B, S), generator=gen, device=dev, dtype=torch.int32)
    b = a.clone()
    hit = torch.rand((B, S), generator=gen, device=dev) < 0.02
    b[hit] = torch.randint(0, 4, (int(hit.sum()),), generator=gen, device=dev, dtype=torch.int32)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    return a, lens, b, lens


def check_local(dev):
    """Every layout that holds each width against a pair a warp (the
    parent's layout) and the word-level plain version: full-width pools,
    ragged warps with empty queries and codes outside 0..4, both orders."""
    from chip_smoke import exact, local_pair_set

    rng = np.random.default_rng(20)
    for S in (2048, 2181, 2304, 3000, 3072):
        a, la, b, lb = local_pair_set(rng, [(S, S)] * 5 + [(S - 1, S), (64 * (-(-S // 64) - 1) + 1, S),
                                            (0, S), (S, 300), (1, 9), (S, S - 40), (700, 1200)])
        a[:, :3] = rng.integers(-3, 40, (a.shape[0], 3))
        args = [torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32), device=dev)
                for x in (a, la, b, lb)]
        want = bitvector_local_plain(*args)
        for G, K in LOCAL_LAYOUTS:
            if G == 32 or G * K * 64 >= S:
                for x in (args, [args[2], args[3], args[0], args[1]]):
                    w = want if x is args else bitvector_local_plain(*x)
                    exact(f"local ({G}, {K}) S={S} ragged, odd codes"
                          f"{'' if x is args else ', the other order'}",
                          batched_levenshtein_local_kernel(*x, _layout=(G, K)), w)
        pool = local_pool(dev, 4099, S, S)
        wide = batched_levenshtein_local_kernel(*pool, _layout=(32, 1 if S <= 2048 else 2))
        exact(f"local S={S} 4,099 pairs: the rule's layout {local_layout(4099, S, S)} "
              "against a pair a warp", batched_levenshtein_local_kernel(*pool), wide)
    torch.cuda.synchronize()


def time_local(dev):
    """Device ms of the layout of a pair a warp and the rule's group layout
    over pair counts: the table behind GROUP_MIN_PAIRS."""
    from chip_smoke import time_device

    for S in (2181, 2304, 3000):
        nblk = -(-S // 64)
        group = local_layout(max(GROUP_MIN_PAIRS, 32640), S, S)
        wide = (32, 1 if S <= 2048 else 2)
        for G, K in dict.fromkeys((wide, group)):
            print(f"local S={S}: layout ({G}, {K}), live share {live_share(nblk, G, K):.4f}, "
                  f"{local_smem_bytes(S, S, (G, K))} B of shared memory a warp, "
                  f"{local_resources(G, K, S)[0]} warps an SM", flush=True)
        pool = local_pool(dev, 32640, S, 1)
        print(f"local device ms, S={S}: B | ({wide[0]}, {wide[1]}) | ({group[0]}, {group[1]}) | "
              f"rule", flush=True)
        for B in (256, 1024, 2048, 3072, 4096, 5120, 6144, 8192, 16384, 32640):
            args = [x[:B] for x in pool]
            ms = [time_device([lambda lay=lay: batched_levenshtein_local_kernel(*args, _layout=lay)],
                              3 if B > 4096 else 10, windows=3) for lay in (wide, group)]
            print(f"  {B} | {ms[0]:.6f} | {ms[1]:.6f} | {local_layout(B, S, S)}", flush=True)


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
                    "banded_warp_kernelILi8ELb0E", "walk_kernel", "mica_rows_kernel", "bitvector_kernelILi32ELi1ELb0E",
                    "bitvector_kernelILi32ELi2ELb0E",
                    *(f"bitvector_kernelILi{G}ELi{K}ELb1E" for G, K in LOCAL_LAYOUTS),
                    "wavefront_chunk_kernel", "wavefront_chunks_kernel"):
            if key in name:
                with open(os.path.join(out_dir, f"sass_{key}.txt"), "w") as f:
                    f.write(chunk)
                print(f"  SASS of {key}: {chunk.count(chr(10)) // 2} lines")
                if key == "wavefront_chunk_kernel":
                    n, shfl = loop_counts(chunk)
                    cells = CHUNK_EXCHANGE_STEPS * CHUNK_LANES_A_THREAD
                    print(f"    its loop of {CHUNK_EXCHANGE_STEPS} steps ({cells} cells a "
                          f"thread): {n} instructions, {shfl} SHFL, {n / cells:.2f} a cell")
    local_report()


def local_resources(G, K, S):
    """(warps an SM, registers, spilled bytes a thread) of kernel `local`
    in layout (G, K) at S bases (the occupancy API and the function's
    attributes)."""
    out = (ctypes.c_int64 * 3)()
    err = kernels.library().kgt_local_resources(G, K, S, S, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"kgt_local_resources({G}, {K}): error {err}")
    return tuple(out)


def local_report():
    """Registers, spills and warps an SM of kernel `local` in each layout,
    at 2,181 and 3,000 bases."""
    for G, K in LOCAL_LAYOUTS:
        res = {S: local_resources(G, K, S) for S in (2181, 3000)}
        regs, spill = res[2181][1:]
        print(f"  local ({G}, {K}): {regs} registers, {spill} bytes of local memory a thread "
              f"(spills); warps an SM {{2181: {res[2181][0]}, 3000: {res[3000][0]}}}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import nvidia_smi_line

    print(f"card: {nvidia_smi_line()}")
    kernels.library()
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("==") or "Compiling" in line:
            print("  " + line.strip())
    if "--sass" in sys.argv:
        dump_sass()
    dev = torch.device("cuda", torch.cuda.current_device())
    check(dev)
    if "--chunk" in sys.argv:
        time_chunk(dev)
        return 0
    if "--local" in sys.argv:
        check_local(dev)
        time_local(dev)
        return 0
    if "--mica-order" in sys.argv:
        time_mica_order(dev)
    if "--quick" not in sys.argv:
        time_myers(dev)
        time_choices_and_walk(dev)
        time_banded(dev)
        time_chunk(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
