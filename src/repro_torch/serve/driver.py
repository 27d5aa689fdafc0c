"""Async serving driver: a background tick loop around
``FederationServer`` (the port of ``repro.serve.driver``).

The synchronous server couples solving to the caller — ``submit`` only
enqueues, and nothing completes until someone calls ``tick``/``drain``.
``AsyncDriver`` decouples them: a daemon thread owns the tick loop, so
``submit`` returns a ``ServeFuture`` immediately and the queue drains in
the background at a configurable cadence.

    driver = AsyncDriver(server, interval_s=0.0)
    driver.start()
    futs = [driver.submit(S, ds, seed=0, q=q) for q, (S, ds) in ...]
    driver.wait(futs, timeout_s=60)       # or poll fut.done()
    driver.stop()                         # drains by default, joins

Semantics:

  * DETERMINISM — the driver adds no scheduling of its own: it just
    calls ``server.tick()``, so admission order (deadline → aging →
    fullest bucket, FIFO within bucket) is that of a manual tick loop
    over the same submission order, and per-request results do not
    depend on how a batch was composed (padding is inert, and a bucket's
    batch always has ``max_batch`` slots, so every tick of a bucket runs
    the same shapes). Queue mutations are guarded by the server's lock;
    submits landing mid-tick ride the next tick.
  * DEVICE — the tick thread makes the server's card its current device
    and launches on that device's default stream. ``submit`` featurizes
    on the caller's current stream, so callers submit from the default
    stream (as PyTorch code does unless it picks another), which orders
    each request's draws before the tick that reads them.
  * CADENCE — ``interval_s`` sleeps between NON-EMPTY polls; an empty
    queue parks the thread on a condition variable until the next
    submit (no busy-wait), so an idle driver costs nothing.
  * SHUTDOWN — ``stop(drain=True)`` (default) lets the loop finish the
    queue, then joins the thread; ``stop(drain=False)`` exits after the
    in-flight tick, leaving queued requests pending (the server is
    untouched — a later ``server.drain()`` completes them).
  * METRICS — ``stats()`` reports the loop's tick utilization
    (``busy_s / wall_s`` — the fraction of driver wall time spent
    inside ``server.tick()``) next to tick/request counts;
    ``server.metrics`` keeps the solve-side telemetry.
"""
from __future__ import annotations

import threading
import time

import torch

from repro_torch.serve.queue import FederationServer, ServeFuture


class AsyncDriver:
    """Background tick loop for one ``FederationServer``."""

    def __init__(self, server: FederationServer, interval_s: float = 0.0):
        if interval_s < 0:
            raise ValueError(f"interval_s must be >= 0, got {interval_s}")
        self.server = server
        self.interval_s = float(interval_s)
        self._wake = threading.Condition()
        self._thread = None
        self._running = False
        self._drain_on_stop = True
        self._started_at = None
        self._stopped_wall = 0.0         # accumulated across start/stop
        self.busy_s = 0.0                # seconds inside server.tick()
        self.ticks = 0                   # non-empty ticks fired
        self.empty_polls = 0             # wake-ups that found no work
        self.completed = 0               # requests completed by the loop

    # ------------------------------------------------------------ loop
    def _loop(self, cuda_index):
        if cuda_index is not None:
            torch.cuda.set_device(cuda_index)
        while True:
            with self._wake:
                if not self._running:
                    if not (self._drain_on_stop and self.server.pending()):
                        return
                elif not self.server.pending():
                    # park until a submit (or stop) wakes us — no
                    # busy-wait on an idle queue
                    self.empty_polls += 1
                    self._wake.wait(timeout=0.05)
                    continue
            t0 = time.perf_counter()
            done = self.server.tick()
            self.busy_s += time.perf_counter() - t0
            if done:
                self.ticks += 1
                self.completed += done
            if self.interval_s and self._running:
                time.sleep(self.interval_s)

    # --------------------------------------------------------- control
    def start(self):
        """Start the background tick thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        dev = self.server.device
        cuda_index = None
        if dev.type == "cuda":
            cuda_index = (torch.cuda.current_device() if dev.index is None
                          else dev.index)
        self._running = True
        self._started_at = time.perf_counter()
        self._thread = threading.Thread(target=self._loop,
                                        args=(cuda_index,),
                                        name="serve-tick", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout_s: float | None = None):
        """Stop the loop and join the thread. ``drain=True`` (default)
        finishes the queue first; ``drain=False`` leaves queued requests
        pending on the untouched server."""
        with self._wake:
            self._drain_on_stop = bool(drain)
            self._running = False
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"serve-tick thread did not stop within {timeout_s}s")
            self._thread = None
        if self._started_at is not None:
            self._stopped_wall += time.perf_counter() - self._started_at
            self._started_at = None
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---------------------------------------------------------- submit
    def submit(self, S, dataset, *, seed=0, q=0, deadline_ticks=None,
               draws=None) -> ServeFuture:
        """``server.submit`` + wake the tick thread. Returns the future
        immediately; the background loop completes it."""
        fut = self.server.submit(S, dataset, seed=seed, q=q,
                                 deadline_ticks=deadline_ticks, draws=draws)
        with self._wake:
            self._wake.notify_all()
        return fut

    @staticmethod
    def wait(futures, timeout_s: float = 60.0, poll_s: float = 0.002):
        """Block until every future is done (or raise ``TimeoutError``)."""
        deadline = time.perf_counter() + timeout_s
        for fut in futures:
            while not fut.done():
                if time.perf_counter() > deadline:
                    raise TimeoutError(
                        "serve futures still pending after "
                        f"{timeout_s}s — is the driver running?")
                time.sleep(poll_s)
        return futures

    # ----------------------------------------------------------- stats
    def stats(self) -> dict:
        """Loop-side telemetry: ``tick_utilization`` is busy_s/wall_s —
        the fraction of driver wall time spent inside ticks (1.0 ≈
        solve-bound, ~0 ≈ idle/cadence-bound)."""
        wall = self._stopped_wall
        if self._started_at is not None:
            wall += time.perf_counter() - self._started_at
        return {
            "ticks": self.ticks,
            "empty_polls": self.empty_polls,
            "requests_completed": self.completed,
            "busy_s": self.busy_s,
            "wall_s": wall,
            "tick_utilization": (self.busy_s / wall if wall > 0 else 0.0),
            "interval_s": self.interval_s,
            "running": bool(self._thread is not None
                            and self._thread.is_alive()),
        }
