"""Host-side concurrency backend: pools, bounded queues, ordered pipelines.

Capability parity with kel_thread/ — the reference's entire "distributed
backend" (SURVEY.md section 2.8):
  - WorkflowThreads  (futures thread pool, kel_workflow_threads.h:27)
  - QueueMtSafe      (unbounded MT queue, kel_queue_mt_safe.h)
  - QueueTidal       (high/low-watermark bounded queue with producer
                      backpressure, kel_queue_tidal.h:54-60)
  - QueueMonitor     (sampling thread: stats + stall detection,
                      kel_queue_monitor.h:29,209)
  - WorkflowPipeline (MT In->Out transform preserving FIFO order,
                      kel_workflow_pipeline.h:37)

In the TPU build these exist for the HOST ingest path only (feeding
decompression/tokenisation and jax.device_put double-buffering); the
numeric fan-out the reference ran on these pools is batched onto the
device instead.

Copy of kgl_gene_tpu/parallel/host_pipeline.py.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Generic, Iterable, Iterator, List, Optional, TypeVar

from ..utils.logging import log

__all__ = [
    "WorkflowThreads",
    "QueueMtSafe",
    "QueueTidal",
    "QueueMonitor",
    "WorkflowPipeline",
    "WorkflowAsync",
    "MTStreamBuffer",
]

T = TypeVar("T")
U = TypeVar("U")


class WorkflowThreads:
    """Futures-based pool; defaultThreads() = hardware-1, clamped to job
    size (kel_workflow_threads.h:40-50)."""

    def __init__(self, thread_count: Optional[int] = None):
        self.thread_count = thread_count or self.default_threads()
        self._pool = ThreadPoolExecutor(max_workers=self.thread_count)

    @staticmethod
    def default_threads(job_size: Optional[int] = None) -> int:
        import os

        threads = max((os.cpu_count() or 2) - 1, 1)
        if job_size is not None and job_size > 0:
            threads = min(threads, job_size)
        return threads

    def enqueue_future(self, fn: Callable, *args, **kwargs) -> Future:
        return self._pool.submit(fn, *args, **kwargs)

    def enqueue_void(self, fn: Callable, *args, **kwargs) -> None:
        self._pool.submit(fn, *args, **kwargs)

    def join(self) -> None:
        self._pool.shutdown(wait=True)
        self._pool = ThreadPoolExecutor(max_workers=self.thread_count)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)


class QueueMtSafe(Generic[T]):
    """Unbounded thread-safe FIFO queue."""

    def __init__(self, name: str = ""):
        self.name = name
        self._q: queue.Queue = queue.Queue()
        self.total_pushed = 0

    def push(self, item: T) -> None:
        self._q.put(item)
        self.total_pushed += 1

    def wait_and_pop(self) -> T:
        return self._q.get()

    def try_pop(self) -> Optional[T]:
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def size(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()


class QueueTidal(Generic[T]):
    """Bounded queue with high/low watermark flow control: producers block
    once size reaches high_tide and resume when consumers drain it to
    low_tide (kel_queue_tidal.h:24-35). Bounds memory without lock-stepping
    producers and consumers."""

    def __init__(self, high_tide: int = 10000, low_tide: int = 2000, name: str = ""):
        if low_tide > high_tide:
            raise ValueError("low_tide must be <= high_tide")
        self.high_tide = high_tide
        self.low_tide = low_tide
        self.name = name
        self._items: queue.Queue = queue.Queue()
        self._flood = threading.Event()  # set = producers blocked
        self._lock = threading.Lock()
        self.total_pushed = 0
        self.flood_count = 0  # number of high-tide episodes (flood/ebb cycles)

    def push(self, item: T) -> None:
        while self._flood.is_set():
            # Blocked until the ebb drains to low tide.
            time.sleep(0.0005)
        self._items.put(item)
        with self._lock:
            self.total_pushed += 1
            if self._items.qsize() >= self.high_tide and not self._flood.is_set():
                self._flood.set()
                self.flood_count += 1

    def wait_and_pop(self) -> T:
        item = self._items.get()
        if self._flood.is_set() and self._items.qsize() <= self.low_tide:
            self._flood.clear()
        return item

    def size(self) -> int:
        return self._items.qsize()

    def empty(self) -> bool:
        return self._items.empty()


class QueueMonitor:
    """Async sampling thread recording queue-size stats and warning on
    stalled queues (kel_queue_monitor.h launchStats)."""

    def __init__(self, queue_obj, sample_ms: int = 100, name: str = "queue",
                 stall_samples: int = 50):
        self.queue = queue_obj
        self.sample_ms = sample_ms
        self.name = name
        self.stall_samples = stall_samples
        self.samples: List[int] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_pushed = -1
        self._stall_count = 0

    def launch_stats(self) -> None:
        self._thread = threading.Thread(target=self._sample_loop, daemon=True)
        self._thread.start()

    def _sample_loop(self):
        consecutive_static = 0
        while not self._stop.wait(self.sample_ms / 1000.0):
            size = self.queue.size()
            self.samples.append(size)
            pushed = getattr(self.queue, "total_pushed", None)
            if pushed is not None and size > 0:
                if pushed == self._last_pushed:
                    consecutive_static += 1
                    if consecutive_static == self.stall_samples:
                        self._stall_count += 1
                        log().warn(
                            "queue {} appears stalled: size {} static for {} samples",
                            self.name, size, self.stall_samples,
                        )
                else:
                    consecutive_static = 0
                self._last_pushed = pushed

    def stop_stats(self) -> dict:
        """Stop sampling and return the utilisation report."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        report = {
            "name": self.name,
            "samples": len(self.samples),
            "mean_size": sum(self.samples) / len(self.samples) if self.samples else 0.0,
            "max_size": max(self.samples, default=0),
            "stalls": self._stall_count,
        }
        if hasattr(self.queue, "flood_count"):
            report["flood_cycles"] = self.queue.flood_count
        return report


class WorkflowPipeline(Generic[T, U]):
    """Multithreaded In -> Out transform preserving FIFO order: work items
    fan out to a pool but results are consumed in submission order via a
    future queue (kel_workflow_pipeline.h:37)."""

    def __init__(self, transform: Callable[[T], U], threads: Optional[int] = None,
                 high_tide: int = 10000, low_tide: int = 2000, name: str = "pipeline"):
        self.transform = transform
        self.name = name
        self._pool = ThreadPoolExecutor(
            max_workers=threads or WorkflowThreads.default_threads()
        )
        self._futures: QueueTidal[Future] = QueueTidal(high_tide, low_tide, name)
        self._closed = False

    def push(self, item: T) -> None:
        if self._closed:
            raise RuntimeError("pipeline closed")
        self._futures.push(self._pool.submit(self.transform, item))

    def wait_and_pop(self) -> U:
        return self._futures.wait_and_pop().result()

    def size(self) -> int:
        return self._futures.size()

    def close(self) -> None:
        self._closed = True
        self._pool.shutdown(wait=True)

    def map_iter(self, items: Iterable[T], prefetch: int = 256) -> Iterator[U]:
        """Stream items through the pipeline with bounded read-ahead."""
        pending: queue.Queue = queue.Queue()
        items_iter = iter(items)
        in_flight = 0
        exhausted = False
        while True:
            while not exhausted and in_flight < prefetch:
                try:
                    item = next(items_iter)
                except StopIteration:
                    exhausted = True
                    break
                pending.put(self._pool.submit(self.transform, item))
                in_flight += 1
            if in_flight == 0:
                break
            yield pending.get().result()
            in_flight -= 1


class WorkflowAsync(Generic[T]):
    """Unordered async workflow with stop-token shutdown
    (kel_thread/kel_workflow_async.h:33-140).

    N worker threads pop queued objects and apply the workflow function.
    When a thread pops the STOP token it re-queues it for its siblings and
    terminates; the LAST thread instead calls the workflow function WITH
    the stop token — which is how multi-stage chains gang: stage N's
    function pushes into stage N+1, so the token cascades down the chain
    and every stage drains in order.
    """

    def __init__(self, stop_token: T, queue_obj=None):
        self.stop_token = stop_token
        self.queue = queue_obj if queue_obj is not None else QueueMtSafe()
        self._threads: List[threading.Thread] = []
        self._active = 0
        self._lock = threading.Lock()
        self._work_fn: Optional[Callable] = None

    def activate_workflow(self, threads: int, fn: Callable, *args) -> bool:
        """Start the workers; returns False if already active. `fn` is
        called as fn(*args, item) on every queued object (and, by the last
        thread, on the stop token itself)."""
        with self._lock:
            if self._active > 0:
                return False
            self._work_fn = lambda item: fn(*args, item)
            n = max(1, threads)
            self._active = n
        for _ in range(n):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)
        return True

    def push(self, item: T) -> None:
        self.queue.push(item)

    def stop(self) -> None:
        """Push the stop token and block until all workers exit."""
        self.queue.push(self.stop_token)
        self.join()

    def join(self) -> None:
        for t in self._threads:
            t.join()
        self._threads.clear()

    def _worker(self) -> None:
        while True:
            item = self.queue.wait_and_pop()
            if item == self.stop_token:
                with self._lock:
                    self._active -= 1
                    last = self._active == 0
                if last:
                    # Last thread out: forward the token through the
                    # workflow function so ganged downstream stages stop.
                    self._work_fn(item)
                else:
                    self.queue.push(item)
                return
            self._work_fn(item)


class MTStreamBuffer:
    """Dedicated reader-thread stream buffer (MTStreamIO / kel_mt_buffer.h):
    a daemon thread pulls lines from a text stream into a tidal queue so
    parsing never waits on IO; readLine pops with backpressure intact."""

    EOF = None

    def __init__(self, stream, high_tide: int = 100_000, low_tide: int = 20_000):
        self._stream = stream
        self._queue: QueueTidal = QueueTidal(high_tide, low_tide, "mt_stream")
        self._eof = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        try:
            for line in self._stream:
                self._queue.push(line)
        finally:
            self._queue.push(self.EOF)

    def read_line(self) -> Optional[str]:
        """Next line or None at end of stream."""
        if self._eof:
            return None
        line = self._queue.wait_and_pop()
        if line is self.EOF:
            self._eof = True
            return None
        return line

    def __iter__(self) -> Iterator[str]:
        while True:
            line = self.read_line()
            if line is None:
                return
            yield line

    def close(self) -> None:
        self._stream.close()
        self._thread.join(timeout=5)
