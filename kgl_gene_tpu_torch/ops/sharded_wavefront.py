"""Sharded anti-diagonal wavefront: the exact edit distance of a few very
long pairs, the DP split over the ranks of a mesh.

Counterpart of kgl_gene_tpu/ops/sharded_wavefront.py (sharded_levenshtein,
the device loop _build_kernel at :42 with its fori_loop at :103 and its
ppermute at :110). The lanes of the wavefront, DP rows i = 0..la, are
split over the ranks: rank r owns Wl of them, [r Wl, (r + 1) Wl), and
keeps H = halo lanes to their left. At a chunk boundary every lane holds
exact values of diagonals d - 1 and d - 2; during the next t steps lane k
of the rank stays exact iff k >= t (the dependency cone grows one lane a
step, and a cell reads only rows i - 1 and i), so the owned lanes (k >= H)
stay exact for H steps, the chunk. One ring exchange a chunk (parallel.
dist.ring_shift: send to rank r + 1, receive from rank r - 1) refreshes the
halo from the left neighbour's exact owned lanes; rank 0's halo stays at
the sentinel. The result is captured on owned lanes only and summed over
the ranks (psum): the owner of lane la captures a pair, and a pair with
la + lb < 2 is credited once, by that owner, at the start.

One chunk of one rank is one launch of kernel `wavefront_chunk`
(csrc/sharded_wavefront.cu), or several for a halo over MAX_SUB_HALO; the
ring exchange runs between chunks. A rank with no exchange between its
chunks (world 1, where the reference's ppermute to itself leaves the halo
at the sentinel) runs them all in one cooperative launch where the grid
fits the card (run_chunks, the rule in one_launch_fits). chunk_plain is the
reference's algorithm in PyTorch, one diagonal a step, and run_chunks_plain
its loop over chunks: what a CPU tensor takes, and what the kernels are
held against on the card. A CUDA tensor launches a kernel or raises.

Dropped from the TPU version: the 128-lane rounding of the rank's lane
count (:176, a TPU layout) and the sentinel-padded reversed copy of b (the
kernel and the plain version index b directly). The DP covers rows up to
the longest a and columns up to the longest b of the batch, not the
padded widths: the cells past them never reach a captured one.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..parallel.dist import SampleMesh, psum, ring_shift

__all__ = ["CHUNK_EXCHANGE_STEPS", "CHUNK_LANES_A_THREAD", "CHUNK_MAX_WARPS", "MAX_SUB_HALO",
           "RankLanes", "block_lanes", "chunk", "chunk_geometry", "chunk_plain", "halo_lanes",
           "one_launch_fits", "rank_lanes", "refresh_halo", "run_chunk", "run_chunks",
           "run_chunks_plain", "sharded_levenshtein", "sub_steps"]

# The kernel's geometry (csrc/sharded_wavefront.cu: kR, kS, kMaxWarps,
# kMaxHalo): 4 lanes a thread, a warp's 32 halo lanes refreshed every 32
# steps, at most 16 warps a block, at most 512 steps a launch.
CHUNK_LANES_A_THREAD = 4
CHUNK_EXCHANGE_STEPS = 32
CHUNK_MAX_WARPS = 16
MAX_SUB_HALO = 512


class RankLanes(NamedTuple):
    """One rank's share of the wavefront of a batch of B pairs.

    Local lane k is DP row i = i0 + k (i0 = r Wl - H); lanes k < H are the
    halo. a_lane (B, W) int32 holds a[i - 1] on rows 1..Ma and -1 off them;
    b (B, max(Mb, 1)) int32; la, lb (B,) int32; pp, p (B, W) int32 the
    diagonals d - 2 and d - 1 at the chunk's start, out_pp, out_p the
    buffers the chunk writes its owned lanes to; result (B,) int32 the
    captures of this rank."""

    a_lane: torch.Tensor
    b: torch.Tensor
    la: torch.Tensor
    lb: torch.Tensor
    pp: torch.Tensor
    p: torch.Tensor
    out_pp: torch.Tensor
    out_p: torch.Tensor
    result: torch.Tensor
    Wl: int
    H: int
    i0: int
    Ma: int
    Mb: int
    n_chunks: int


def rank_lanes(seq_a, len_a, seq_b, len_b, rank: int, world_size: int, halo: int,
               device) -> RankLanes:
    """Rank `rank`'s lanes of the wavefront of the pairs (seq_a, seq_b)
    (numpy (B, *) codes, lengths clamped to the widths), at diagonal 2."""
    seq_a = np.asarray(seq_a)
    seq_b = np.asarray(seq_b)
    B = seq_a.shape[0]
    la = np.clip(np.asarray(len_a, dtype=np.int64), 0, seq_a.shape[1])
    lb = np.clip(np.asarray(len_b, dtype=np.int64), 0, seq_b.shape[1])
    Ma = int(la.max()) if B else 0
    Mb = int(lb.max()) if B else 0
    Wl = -(-(Ma + 1) // world_size)
    H = min(halo, Wl)
    W = Wl + H
    i0 = rank * Wl - H
    i_g = i0 + np.arange(W)
    on_table = (i_g >= 1) & (i_g <= Ma)
    a_lane = np.full((B, W), -1, dtype=np.int32)
    a_lane[:, on_table] = seq_a[:, i_g[on_table] - 1]
    b = np.zeros((B, max(Mb, 1)), dtype=np.int32)
    b[:, :Mb] = seq_b[:, :Mb]
    big = Ma + Mb + 1
    pp = np.where(i_g == 0, 0, big).astype(np.int32)          # D[0][0]
    p = np.where((i_g >= 0) & (i_g <= 1), 1, big).astype(np.int32)  # D[1][0], D[0][1]
    owns_la = (la >= rank * Wl) & (la < (rank + 1) * Wl)
    result = np.where((la + lb < 2) & owns_la, la + lb, 0).astype(np.int32)
    steps = Ma + Mb - 1  # diagonals 2 .. Ma + Mb
    n_chunks = -(-steps // H) if steps > 0 else 0

    def on(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32), device=device)

    pp_t = on(np.repeat(pp[None], B, 0))
    p_t = on(np.repeat(p[None], B, 0))
    return RankLanes(on(a_lane), on(b), on(la), on(lb), pp_t, p_t, pp_t.clone(),
                     p_t.clone(), on(result), Wl, H, i0, Ma, Mb, n_chunks)


def chunk_plain(s: RankLanes, d0: int) -> None:
    """Diagonals d0 .. d0 + H - 1 of one rank, one diagonal a step, in
    PyTorch: writes the owned lanes (k >= H) of diagonals d0 + H - 2 and
    d0 + H - 1 to s.out_pp, s.out_p and each capture of the chunk to
    s.result. The halo lanes of the out buffers are left as they were."""
    B, W = s.a_lane.shape
    dev = s.a_lane.device
    H = s.H
    i = s.i0 + torch.arange(W, device=dev)
    lane_ok = (i >= 0) & (i <= s.Ma)
    big = s.Ma + s.Mb + 1
    edge = torch.full((B, 1), big, dtype=torch.int32, device=dev)
    k_la = (s.la.to(torch.int64) - s.i0)
    owns_la = (k_la >= H) & (k_la < W)
    k_la = k_la.clamp(0, W - 1)[:, None]
    hit_d = (s.la + s.lb).to(torch.int64)
    pp, p = s.pp, s.p
    for t in range(H):
        d = d0 + t
        j = d - i
        j_in = (j >= 1) & (j <= s.Mb)
        bc = torch.where(j_in, s.b.index_select(1, (j - 1).clamp(0, s.b.shape[1] - 1)), -2)
        cost = (s.a_lane != bc).to(torch.int32)
        left_p = torch.cat([edge, p[:, :-1]], 1)    # D[i - 1][j]
        left_pp = torch.cat([edge, pp[:, :-1]], 1)  # D[i - 1][j - 1]
        cand = torch.minimum(torch.minimum(left_p, p) + 1, left_pp + cost)
        cand = torch.where(j == 0, i.to(torch.int32), cand)
        cand = torch.where(i == 0, j.to(torch.int32), cand)
        cand = torch.where(lane_ok & (j >= 0) & (j <= s.Mb), cand, big).to(torch.int32)
        hit = owns_la & (hit_d == d)
        s.result.copy_(torch.where(hit, cand.gather(1, k_la)[:, 0], s.result))
        pp, p = p, cand
    s.out_pp[:, H:] = pp[:, H:]
    s.out_p[:, H:] = p[:, H:]


def block_lanes(warps: int) -> int:
    """Lanes a block of `warps` warps covers: a warp's 4 x 32 lanes, the
    warps overlapping by their CHUNK_EXCHANGE_STEPS halo lanes."""
    lanes = 32 * CHUNK_LANES_A_THREAD
    return lanes + (warps - 1) * (lanes - CHUNK_EXCHANGE_STEPS)


def sub_steps(H: int) -> list:
    """The launches of one chunk of H diagonals: ceil(H / MAX_SUB_HALO) runs
    of steps as equal as can be, in order."""
    n = -(-H // MAX_SUB_HALO)
    return [H // n + (q < H % n) for q in range(n)]


@functools.lru_cache(maxsize=256)
def chunk_geometry(lanes: int, h: int, B: int, sms: int) -> tuple:
    """(warps a block, T owned lanes a block, tiles) of a launch that writes
    `lanes` lanes after h steps. A warp issues its steps at the integer
    pipe's rate and a scheduler with two warps takes about twice as long,
    so the launch lasts as long as its busiest SM: the rule takes the warps
    that give the busiest SM the fewest lanes, ceil(B x tiles / sms) blocks
    of block_lanes(warps), and of those the fewest blocks (the fewest halo
    lanes recomputed)."""
    best = None
    for w in range(1, CHUNK_MAX_WARPS + 1):
        T = block_lanes(w) - h
        if T < 1:
            continue
        tiles = -(-lanes // T)
        key = (-(-B * tiles // sms) * block_lanes(w), tiles)
        if best is None or key < best[0]:
            best = key, (w, T, tiles)
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _args(s: RankLanes):
    kernels.check_args(torch.int32, a_lane=s.a_lane, b=s.b, la=s.la, lb=s.lb, pp=s.pp,
                       p=s.p, out_pp=s.out_pp, out_p=s.out_p, result=s.result)
    return (s.a_lane.data_ptr(), s.b.data_ptr(), s.b.stride(0), s.Mb, s.la.data_ptr(),
            s.lb.data_ptr())


def chunk(s: RankLanes, d0: int) -> None:
    """One chunk of one rank: kernel `wavefront_chunk` on the card,
    chunk_plain on the CPU. The same contract as chunk_plain. A chunk of
    H <= MAX_SUB_HALO diagonals is one launch; a longer one runs the
    launches of sub_steps(H) in turn, each from the last exact lane of the
    one before (after h steps from exact lanes, lanes k >= h are exact),
    through scratch buffers, the last into the out buffers."""
    if s.a_lane.device.type == "cpu":
        return chunk_plain(s, d0)
    head = _args(s)
    B, W = s.a_lane.shape
    dev = s.a_lane.device
    src = (s.pp, s.p)
    steps = sub_steps(s.H)
    scratch = torch.empty((2, 2, B, W), dtype=torch.int32, device=dev) if len(steps) > 1 else None
    k_first = 0
    for q, h in enumerate(steps):
        dst = (s.out_pp, s.out_p) if q == len(steps) - 1 else tuple(scratch[q % 2])
        warps = chunk_geometry(W - k_first - h, h, B, _sm_count(dev.index))[0]
        kernels.launch(
            "wavefront_chunk", "kgt_wavefront_chunk", dev, *head,
            src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(), dst[1].data_ptr(),
            s.result.data_ptr(), B, W, s.i0, s.Ma, d0 + k_first, h, k_first, s.H, warps,
        )
        src, k_first = dst, k_first + h


def run_chunk(s: RankLanes, c: int, step=chunk) -> RankLanes:
    """Chunk c (diagonals 2 + c H ..) of rank lanes s through `step`; the
    lanes with the chunk's output as the next chunk's input."""
    step(s, 2 + c * s.H)
    return s._replace(pp=s.out_pp, p=s.out_p, out_pp=s.pp, out_p=s.p)


def run_chunks_plain(s: RankLanes, c0: int, n: int) -> RankLanes:
    """Chunks c0 .. c0 + n - 1 with nothing between them, chunk_plain one
    after the other: the contract of run_chunks."""
    for c in range(c0, c0 + n):
        s = run_chunk(s, c, chunk_plain)
    return s


def one_launch_fits(s: RankLanes) -> bool:
    """The rule of run_chunks on the card, from the geometry alone: a chunk
    is one launch (H <= MAX_SUB_HALO) and the grid, B x tiles blocks of
    chunk_geometry's warps, is no larger than the blocks the card holds at
    once (blocks an SM at the kernel's registers and shared memory, times
    the SMs). On the CPU, where run_chunks is run_chunks_plain, True."""
    if s.a_lane.device.type == "cpu":
        return True
    if s.H > MAX_SUB_HALO:
        return False
    B, W = s.a_lane.shape
    dev = s.a_lane.device
    warps, _T, tiles = chunk_geometry(W - s.H, s.H, B, _sm_count(dev.index))
    with torch.cuda.device(dev):
        held = kernels.library().kgt_wavefront_chunks_blocks(warps, s.H)
    return 0 < B * tiles <= held


def run_chunks(s: RankLanes, c0: int, n: int) -> RankLanes:
    """Chunks c0 .. c0 + n - 1 of rank lanes s with no exchange between
    them: on the card one cooperative launch of kernel `wavefront_chunks`
    (counted under that name), a grid barrier between two chunks and the
    buffers swapped inside it; run_chunks_plain on the CPU. The state ends
    where n run_chunk calls leave it. Raises unless one_launch_fits(s)."""
    if s.a_lane.device.type == "cpu":
        return run_chunks_plain(s, c0, n)
    if n == 0:
        return s
    if not one_launch_fits(s):
        raise ValueError(f"chunks of {s.H} diagonals of {tuple(s.a_lane.shape)} lanes do not "
                         "fit one cooperative launch")
    head = _args(s)
    B, W = s.a_lane.shape
    dev = s.a_lane.device
    warps = chunk_geometry(W - s.H, s.H, B, _sm_count(dev.index))[0]
    kernels.launch(
        "wavefront_chunks", "kgt_wavefront_chunks", dev, *head,
        s.pp.data_ptr(), s.p.data_ptr(), s.out_pp.data_ptr(), s.out_p.data_ptr(),
        s.result.data_ptr(), B, W, s.i0, s.Ma, 2 + c0 * s.H, s.H, n, warps,
    )
    if n % 2:
        s = s._replace(pp=s.out_pp, p=s.out_p, out_pp=s.pp, out_p=s.p)
    return s


def halo_lanes(s: RankLanes) -> torch.Tensor:
    """(2, B, H): the rank's rightmost H owned lanes of diagonals d - 1 and
    d - 2, the right neighbour's halo."""
    return torch.stack([s.p[:, s.Wl:], s.pp[:, s.Wl:]])


def refresh_halo(s: RankLanes, recv: torch.Tensor) -> None:
    """Write the left neighbour's lanes `recv` (halo_lanes of rank r - 1)
    into the halo; lanes off the table keep the sentinel."""
    i = s.i0 + torch.arange(s.H, device=recv.device)
    bad = (i < 0) | (i > s.Ma)
    big = s.Ma + s.Mb + 1
    s.p[:, : s.H] = torch.where(bad, big, recv[0])
    s.pp[:, : s.H] = torch.where(bad, big, recv[1])


def sharded_levenshtein(seq_a, len_a, seq_b, len_b, mesh: Optional[SampleMesh] = None,
                        halo: int = 128) -> np.ndarray:
    """Exact Levenshtein distances of (a small batch of) very long pairs,
    the DP wavefront split over the ranks of `mesh` (a world of one rank on
    the card when None).

    seq_a (B, Ma), seq_b (B, Mb) integer codes, len_a, len_b the true
    lengths; the same on every rank. Returns (B,) int32 on every rank,
    equal to levenshtein_numpy. halo: the lanes each rank keeps to its
    left, the diagonals a chunk runs between two exchanges (any; a rank
    runs min(halo, its lane count)). A world of one rank runs its chunks
    in one launch where one_launch_fits, else a launch a chunk."""
    if mesh is None:
        mesh = SampleMesh.single()
    s = rank_lanes(seq_a, len_a, seq_b, len_b, mesh.rank, mesh.world_size, halo,
                   mesh.device)
    if mesh.world_size == 1 and one_launch_fits(s):
        s = run_chunks(s, 0, s.n_chunks)
    else:
        for c in range(s.n_chunks):
            s = run_chunk(s, c)
            if mesh.world_size > 1:
                refresh_halo(s, ring_shift(halo_lanes(s), mesh))
    return psum(s.result, mesh).cpu().numpy()
