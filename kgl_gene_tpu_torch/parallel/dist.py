"""The sample mesh of the multi-device forms, its collectives, and a
launcher that runs one process a rank.

Counterpart of the 1-D jax.sharding.Mesh that the JAX package's
parallel/mesh.py, ops/pipeline.py (make_multichip_step,
make_multichip_indel_step) and ops/sharded_wavefront.py run under
shard_map. The port is SPMD the PyTorch way: one process a rank, each with
an explicit torch.device, and torch.distributed collectives where the JAX
package writes psum, ppermute or a sharded output:

    psum          jax.lax.psum over the mesh axis
    gather_rows   np.asarray of a sample-sharded jax.Array (the padded whole)
    ring_shift    jax.lax.ppermute to rank r + 1 (sharded_wavefront.py:110)

With one rank and no process group each is the identity, as the JAX
package's single-device branches are (parallel/mesh.py:63-67, :203-204).
rank_rows cuts a rank's block of an array's rows, as a sample-sharded
jax.Array holds it.

The backend is a stated choice (choose_backend), not a fallback: NCCL when
every rank has a card of its own, gloo on the CPU and when ranks share a
card (NCCL refuses two ranks on one GPU). gloo takes CUDA tensors for the
collectives named in GLOO_CUDA_OPS; for the others (send and recv) a
collective copies a CUDA tensor to the host and back, deliberately, and
counts the copy in the mesh's host_copies. Compute stays on the rank's
device in every case.

run_ranks starts the ranks with the spawn start method (CUDA needs it),
joins them into one group through a FileStore in a temporary directory (no
port is chosen), and returns each rank's result; when a rank raises, dies
or misses the deadline it kills the others and raises, so it never hangs.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import resolve_device

__all__ = ["GLOO_CUDA_OPS", "SampleMesh", "choose_backend", "gather_rows", "mesh_of",
           "pad_to_multiple", "psum", "rank_device", "rank_rows", "ring_shift", "run_ranks"]

# The collectives gloo runs on CUDA tensors itself; any other op on a CUDA
# tensor over gloo goes through the host.
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather"})
POLL_S = 0.1  # how often run_ranks looks at its ranks while it waits


@dataclasses.dataclass(frozen=True, eq=False)
class SampleMesh:
    """One rank's view of a 1-D mesh over the sample (genome) axis.

    group is the process group the collectives run in, None for a world of
    one rank that no launcher joined into a group; backend names its
    backend ("nccl", "gloo") or is None with no group. host_copies counts,
    by collective, the CUDA tensors that went through the host."""

    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None
    backend: Optional[str] = None
    host_copies: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @classmethod
    def single(cls, device=None) -> "SampleMesh":
        """A world of one rank on `device` (the card unless 'cpu')."""
        return cls(device=resolve_device(device))

    @classmethod
    def joined(cls, device=None) -> "SampleMesh":
        """This process's rank of the default process group, joined
        already. The rank's device is card LOCAL_RANK (the rank when it is
        unset) mod the card count, or the CPU when device='cpu'."""
        rank = dist.get_rank()
        dev = rank_device(resolve_device(device).type,
                          int(os.environ.get("LOCAL_RANK", rank)))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return cls(rank, dist.get_world_size(), dev, dist.group.WORLD, dist.get_backend())


def mesh_of(device) -> SampleMesh:
    """A SampleMesh as it is, any device as a world of one rank on it."""
    return device if isinstance(device, SampleMesh) else SampleMesh.single(device)


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0,
                    fill=0) -> np.ndarray:
    """Pad an axis up to a multiple (static-shape sharding requirement)."""
    size = array.shape[axis]
    target = ((size + multiple - 1) // multiple) * multiple
    if target == size:
        return array
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, target - size)
    return np.pad(array, pad, constant_values=fill)


def rank_rows(array: np.ndarray, mesh: SampleMesh) -> np.ndarray:
    """Axis 0 of `array` padded with zeros to a multiple of the world size
    (pad_to_multiple) and cut into world-size equal blocks: block r."""
    padded = pad_to_multiple(np.asarray(array), mesh.world_size, axis=0)
    rows = padded.shape[0] // mesh.world_size
    return np.ascontiguousarray(padded[mesh.rank * rows : (mesh.rank + 1) * rows])


def choose_backend(world_size: int, device_type: str) -> str:
    """gloo on the CPU and when ranks share a card; NCCL when every rank
    has a card of its own."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if world_size <= torch.cuda.device_count() else "gloo"


def rank_device(device_type: str, rank: int) -> torch.device:
    """Rank `rank`'s device: the CPU, or card rank mod the card count (the
    ranks share cards round robin when there are fewer cards than ranks)."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _through_host(mesh: SampleMesh, op: str, x: torch.Tensor) -> bool:
    """Whether `op` on `x` goes through the host (gloo and a CUDA tensor
    that gloo does not take for it); counts the copy."""
    if mesh.backend == "gloo" and x.is_cuda and op not in GLOO_CUDA_OPS:
        mesh.host_copies[op] += 1
        return True
    return False


def psum(x: torch.Tensor, mesh: SampleMesh) -> torch.Tensor:
    """The sum of x over the ranks (a new tensor; x is left as it was)."""
    if mesh.group is None:
        return x
    host = _through_host(mesh, "all_reduce", x)
    buf = x.cpu() if host else x.clone()
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(x.device) if host else buf


def gather_rows(x: torch.Tensor, mesh: SampleMesh) -> torch.Tensor:
    """Every rank's row shard x, in rank order, as one tensor on x's
    device: the whole padded array the shards were cut from."""
    if mesh.group is None:
        return x
    host = _through_host(mesh, "all_gather", x)
    src = x.cpu() if host else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts, 0)
    return out.to(x.device) if host else out


def ring_shift(x: torch.Tensor, mesh: SampleMesh) -> torch.Tensor:
    """Send x to rank r + 1 and return what rank r - 1 sent (ranks mod the
    world size). With one rank it returns x, as a ppermute to itself does."""
    if mesh.world_size == 1:
        return x
    host = _through_host(mesh, "send", x)
    src = x.cpu() if host else x.contiguous()
    recv = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, (mesh.rank + 1) % mesh.world_size, mesh.group),
           dist.P2POp(dist.irecv, recv, (mesh.rank - 1) % mesh.world_size, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if host else recv


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
def _rank_main(fn, rank, world_size, backend, device_type, store_path, timeout_s,
               args, results):
    """A spawned rank: join the group, run fn(mesh, *args), report."""
    try:
        dev = rank_device(device_type, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        group = None
        if backend is not None:
            dist.init_process_group(
                backend, store=dist.FileStore(store_path, world_size), rank=rank,
                world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s),
                device_id=dev if backend == "nccl" else None)
            group = dist.group.WORLD
        mesh = SampleMesh(rank, world_size, dev, group, backend=backend)
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:  # noqa: BLE001 - the parent raises with this traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs) -> None:
    started = [p for p in procs if p.pid is not None]
    for p in started:
        if p.is_alive():
            p.kill()
    for p in started:
        p.join(10)


def run_ranks(fn: Callable, world_size: int, *, backend: Optional[str] = None,
              device=None, timeout_s: float = 90.0, args: Sequence = ()) -> list:
    """Run fn(mesh, *args) in `world_size` spawned processes, one a rank,
    and return the ranks' results in rank order.

    fn must be a module-level function of a module the ranks can import
    (spawn pickles it by name), and its result must pickle. device: the
    card unless 'cpu' (rank r takes card r mod the card count). backend:
    choose_backend's unless given; 'nccl' with more ranks than cards
    raises. A world of one rank joins a group only when a backend is
    named. Build the CUDA kernels before calling (kernels.library()): the
    ranks load the library the parent built. When a rank raises or exits
    without a result, or the ranks are not all done in timeout_s seconds,
    every rank is killed and this raises RuntimeError (with the rank's
    traceback) or TimeoutError."""
    device_type = resolve_device(device).type
    if backend is None and world_size > 1:
        backend = choose_backend(world_size, device_type)
    if backend == "nccl" and (device_type != "cuda"
                              or world_size > torch.cuda.device_count()):
        raise ValueError(f"NCCL needs a card a rank: {world_size} ranks, "
                         f"{torch.cuda.device_count() if device_type == 'cuda' else 0} cards")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got: dict = {}
    with tempfile.TemporaryDirectory(prefix="kgt_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, backend, device_type,
                                   os.path.join(tmp, "store"), timeout_s, tuple(args),
                                   results))
                 for r in range(world_size)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout_s
            while len(got) < world_size:
                try:
                    rank, ok, payload = results.get(timeout=POLL_S)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        # a rank whose result is still in the pipe has exited 0
                        try:
                            rank, ok, payload = results.get(timeout=1.0)
                        except queue_mod.Empty:
                            raise RuntimeError(
                                f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                                "and no result") from None
                    elif time.monotonic() > deadline:
                        missing = [r for r in range(world_size) if r not in got]
                        raise TimeoutError(f"ranks {missing} of {world_size} did not finish "
                                           f"within {timeout_s} s")
                    else:
                        continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{payload}")
                got[rank] = payload
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            _stop(procs)
            results.close()
    return [got[r] for r in range(world_size)]
