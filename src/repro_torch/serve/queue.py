"""Continuous-batching federation server (the port of
``repro.serve.queue``).

``FederationServer`` turns the bucketed request-batched solver into a
request/response loop: ``submit()`` featurizes ONE new federation (its
mixing matrix + dataset) at its true shape on the server's device, pads
it into its shape bucket and enqueues it; ``tick()`` admits up to
``max_batch`` bucket-compatible requests, stacks them into the bucket's
fixed ``(B, n_pad, ...)`` batch (empty slots are masked out) and solves
them in one call, scattering per-request results to their futures.

Admission: a tick serves the FULLEST bucket in the queue (ties broken by
FIFO head position, so a uniform stream is plain FIFO), EXCEPT that a
bucket whose head request has been passed over for ``max_wait_ticks``
ticks wins outright (oldest-waiting first), and a request submitted with
``deadline_ticks=`` outranks both once passing it over would miss the
deadline.

``depth="adaptive"`` serves through the batched early-exit solver
(``solver._serve_core_adaptive``): each request also carries a padded
convergence-probe split, results gain a realized ``depth``, and
``metrics.summary()`` grows a depth histogram and FLOPs-saved estimates.

``serve.AsyncDriver`` wraps the server in a background tick thread
(``submit`` returns at once, ticks fire at a cadence); queue mutations are
guarded by a server lock, so driver ticks and caller submits interleave
safely.

``mesh=`` splits the request axis of every bucket solve over the mesh's
agent-role axis (``solver.request_shardings``): a batch of B requests
runs as B/shards slots per device, θ copied to each, and the results
come back to the host in slot order. Requests are featurized and padded
on the mesh's home device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import torch

from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.launch.mesh import mesh_device
from repro_torch.serve.buckets import BucketSpec, pad_cohort, pad_probe
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.solver import (make_bucket_solver, request_shardings,
                                      resolve_serve_mix)
from repro_torch.utils.cache import BoundedLRU
from repro_torch.utils.device import resolve_device, to_tensor

_REQUIRED = ("Xtr", "Ytr", "Xte", "Yte")


class ServeFuture:
    """Result handle for one submitted federation."""

    def __init__(self):
        self._result = None
        self._done = False
        self.latency = None              # seconds, set at completion

    def done(self) -> bool:
        return self._done

    def result(self) -> dict:
        if not self._done:
            raise RuntimeError("request not solved yet — call "
                               "FederationServer.tick()/drain() first")
        return self._result

    def _set(self, result, latency):
        self._result = result
        self.latency = latency
        self._done = True


@dataclasses.dataclass
class _Request:
    bucket: object
    arrays: tuple          # padded (S, W0, Xl, Yl, Xte, Yte[, Xp, Yp])
    mask: torch.Tensor
    t_real: float
    n_real: int
    rows_real: int
    future: ServeFuture
    t_submit: float
    ticks_waited: int = 0                # ticks passed over (aging input)
    deadline_ticks: int | None = None    # admission deadline (optional)


class FederationServer:
    """Amortized-solver server for one trained model.

    ``cfg``/``theta`` come from meta-training; the model serves ANY
    cohort size (the perceptron is shared across agents, so its parameter
    shapes never mention n_agents). ``mix`` is None/"dense" or
    "cuda"/"pallas": on the card each runs the graph-filter kernel, on
    the CPU the plain filter (see ``solver.resolve_serve_mix``).
    ``depth`` is "fixed" or "adaptive" (the early exit configured by
    cfg.exit_threshold / min_layers / probe_size). ``device=None`` means
    the CUDA card; without one, pass ``device="cpu"``. ``mesh`` (a
    ``launch.mesh.Mesh``) splits each bucket batch over its agent-role
    axis; ``max_batch`` must divide over it, and the server's device is
    the mesh's home device."""

    def __init__(self, cfg: SURFConfig, theta, *, activation="relu",
                 mix=None, task=None, buckets: BucketSpec = None,
                 max_batch: int = 8, max_buckets: int = 16,
                 depth: str = "fixed", max_wait_ticks: int = 8,
                 device=None, mesh=None):
        if cfg.topology == "star":
            raise ValueError(
                "star-topology serving is unsupported: the server-row "
                "mask bakes cfg.n_agents and breaks under agent padding "
                "— serve decentralized configs")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if depth not in ("fixed", "adaptive"):
            raise ValueError(f"depth must be 'fixed' or 'adaptive', got "
                             f"{depth!r}")
        if max_wait_ticks < 1:
            raise ValueError(f"max_wait_ticks must be >= 1, got "
                             f"{max_wait_ticks}")
        if mesh is not None:
            # fail at construction, not at the first tick: the request
            # axis must split evenly over the mesh
            request_shardings(mesh, int(max_batch), depth)
        self.device = (resolve_device(device) if mesh is None
                       else mesh_device(mesh, device))
        self.mesh = mesh
        self.depth = depth
        self.max_wait_ticks = int(max_wait_ticks)
        self.cfg = cfg
        self.theta = {k: to_tensor(v, self.device) for k, v in theta.items()}
        self.activation = activation
        self.mix_fn = resolve_serve_mix(mix)
        self.task = resolve_task(cfg, task)
        self.buckets = buckets if buckets is not None else BucketSpec()
        self.max_batch = int(max_batch)
        self._cache = BoundedLRU(maxsize=max_buckets, name="serve-buckets")
        self.metrics = ServeMetrics(cache=self._cache)
        self._queue = deque()
        # guards queue mutations only (submit's append, tick's admission
        # sweep) so an async driver can tick while submits keep landing;
        # the solve itself runs outside the lock
        self._lock = threading.RLock()

    # ------------------------------------------------------------ admit
    def submit(self, S, dataset, *, seed=0, q=0, deadline_ticks=None,
               draws=None) -> ServeFuture:
        """Enqueue one federation: mixing matrix ``S`` (n, n) + dataset
        dict (``Xtr``/``Ytr``/``Xte``/``Yte`` in the (n, m, F)/(n, m)
        layout, numpy or tensors). The solve draws from
        ``unroll.solve_generator(seed, q)`` on the server's device, the
        stream ``solve_federation(..., seed=seed)`` uses for q = 0;
        ``draws=(W0, Xl, Yl)`` replaces the draws. Featurization happens
        NOW at the true cohort shape; padding follows.

        ``deadline_ticks``: the request should be admitted within that
        many ticks of entering the queue (see ``_select_bucket``)."""
        if deadline_ticks is not None and int(deadline_ticks) < 1:
            raise ValueError(f"deadline_ticks must be >= 1, got "
                             f"{deadline_ticks}")
        S = to_tensor(S, self.device, torch.float32)
        if S.dim() != 2 or S.shape[0] != S.shape[1]:
            raise ValueError(f"S must be square (n, n), got "
                             f"{tuple(S.shape)}")
        n = S.shape[0]
        missing = [k for k in _REQUIRED if k not in dataset]
        if missing:
            raise ValueError(f"dataset missing keys {missing}")
        for k in _REQUIRED:
            if len(dataset[k]) != n:
                raise ValueError(
                    f"dataset[{k!r}] leads with {len(dataset[k])} "
                    f"agents but S is {n}x{n}")
        cfg_r = dataclasses.replace(self.cfg, n_agents=n)
        batch = self.task.to_batch(dataset, self.device)
        W0, Xl, Yl = U.featurize_cohort(
            U.solve_generator(seed, q, self.device), batch, cfg_r,
            task=self.task, draws=draws)
        t = batch["Xte"].shape[1]
        bucket = self.buckets.bucket_for(n, t)
        *arrays, mask, t_real = pad_cohort(S, W0, Xl, Yl, batch["Xte"],
                                           batch["Yte"], bucket)
        if self.depth == "adaptive":
            m = batch["Xtr"].shape[1]
            if m < self.cfg.probe_size:
                raise ValueError(
                    f"adaptive serving needs probe_size="
                    f"{self.cfg.probe_size} training rows per agent for "
                    f"the convergence probe, got {m} — probe rows must "
                    "be shape-constant per bucket solver")
            arrays += pad_probe(*U.probe_batch(batch, cfg_r), bucket)
        fut = ServeFuture()
        req = _Request(
            bucket=bucket, arrays=tuple(arrays), mask=mask, t_real=t_real,
            n_real=n, rows_real=t, future=fut,
            t_submit=time.perf_counter(),
            deadline_ticks=(None if deadline_ticks is None
                            else int(deadline_ticks)))
        with self._lock:
            self._queue.append(req)
        return fut

    def pending(self) -> int:
        """Requests currently queued (a tick completes what it admits)."""
        with self._lock:
            return len(self._queue)

    # ------------------------------------------------------------ solve
    def _solver(self, bucket):
        return make_bucket_solver(self.cfg, bucket, self.max_batch,
                                  activation=self.activation,
                                  mix_fn=self.mix_fn, task=self.task,
                                  cache=self._cache, depth=self.depth,
                                  mesh=self.mesh)

    def _empty_slot(self, bucket):
        """All-zero, all-masked batch slot — t_real = t_pad keeps the
        padded-loss corrections on their identity branch. The all-false
        mask also starts adaptive slots INACTIVE (depth 0, no layer work
        charged to them)."""
        d, b = self.task.dim, self.cfg.batch_per_agent
        F, L = self.task.feat_dim, self.cfg.n_layers
        n, t = int(bucket.n_agents), int(bucket.rows)
        f32, ydt = torch.float32, self.task.label_dtype
        z = lambda *shape, dtype=f32: torch.zeros(  # noqa: E731
            shape, dtype=dtype, device=self.device)
        arrays = (z(n, n), z(n, d), z(L, n, b, F), z(L, n, b, dtype=ydt),
                  z(n, t, F), z(n, t, dtype=ydt))
        if self.depth == "adaptive":
            p = int(self.cfg.probe_size)
            arrays += (z(n, p, F), z(n, p, dtype=ydt))
        return arrays, z(n, dtype=torch.bool), float(t)

    def _select_bucket(self):
        """The tick's bucket, by the deadline-then-aging admission
        policy:

          1. if any queued request would MISS its ``deadline_ticks``
             when passed over this tick (slack = deadline − waited ≤ 1),
             the bucket holding the most urgent such request wins
             (smallest slack; FIFO position breaks ties);
          2. else, if any bucket's HEAD request has been passed over for
             ``max_wait_ticks`` ticks, the oldest-waiting such bucket
             wins (FIFO position breaks ties);
          3. otherwise the FULLEST bucket wins (occupancy capped at
             ``max_batch``), ties broken by FIFO head position."""
        counts, first_pos, urgent = {}, {}, {}
        for i, r in enumerate(self._queue):
            counts[r.bucket] = counts.get(r.bucket, 0) + 1
            first_pos.setdefault(r.bucket, i)
            if r.deadline_ticks is not None:
                slack = r.deadline_ticks - r.ticks_waited
                if slack <= 1:
                    cur = urgent.get(r.bucket)
                    if cur is None or slack < cur[0]:
                        urgent[r.bucket] = (slack, i)
        if urgent:
            return min(urgent, key=lambda b: urgent[b])
        aged = [b for b, i in first_pos.items()
                if self._queue[i].ticks_waited >= self.max_wait_ticks]
        if aged:
            return max(aged, key=lambda b: (
                self._queue[first_pos[b]].ticks_waited, -first_pos[b]))
        return max(counts, key=lambda b: (
            min(counts[b], self.max_batch), -first_pos[b]))

    def _sync(self):
        devices = ({self.device} if self.mesh is None
                   else set(self.mesh.devices.flat))
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _run(self, solve, arrays, mask, t_real):
        """Stack per-slot tensors to (B, ...) and solve; returns the
        outputs and the solve's wall seconds, timed between two
        synchronizations of the card (launches alone return early)."""
        stacked = [torch.stack(a) for a in zip(*arrays)]
        mask = torch.stack(mask)
        t_real = torch.tensor(t_real, dtype=torch.float32,
                              device=self.device)
        self._sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = solve(stacked[0], self.theta, *stacked[1:], mask, t_real)
        self._sync()
        return out, time.perf_counter() - t0

    def tick(self) -> int:
        """One continuous-batching step: pick a bucket
        (``_select_bucket``), admit up to ``max_batch`` of its requests
        FIFO-within-bucket, solve, complete their futures. Passed-over
        requests age by one tick. Returns the number of requests
        completed (0 on an empty queue). Bucket selection and admission
        run under the server lock (an async driver may tick while
        submits keep landing); the solve itself does not."""
        with self._lock:
            if not self._queue:
                return 0
            bucket = self._select_bucket()
            admitted, rest = [], deque()
            while self._queue:
                r = self._queue.popleft()
                if r.bucket == bucket and len(admitted) < self.max_batch:
                    admitted.append(r)
                else:
                    r.ticks_waited += 1
                    rest.append(r)
            self._queue = rest
        empty, e_mask, e_t = self._empty_slot(bucket)
        n_empty = self.max_batch - len(admitted)
        out, wall = self._run(
            self._solver(bucket),
            [r.arrays for r in admitted] + [empty] * n_empty,
            [r.mask for r in admitted] + [e_mask] * n_empty,
            [r.t_real for r in admitted] + [e_t] * n_empty)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        now = time.perf_counter()
        lats = []
        for i, r in enumerate(admitted):
            res = {k: v[i] for k, v in out.items()}
            res["W"] = res["W"][:r.n_real]
            lat = now - r.t_submit
            r.future._set(res, lat)
            lats.append(lat)
        useful = sum(r.n_real * r.rows_real for r in admitted)
        padded = self.max_batch * int(bucket.n_agents) * int(bucket.rows)
        kw = {}
        if self.depth == "adaptive":
            # empty slots have depth 0, so the layers this tick ran (one
            # graph-filter launch each) are the deepest request's
            depths = [int(d) for d in out["depth"][:len(admitted)]]
            kw = {"depths": depths, "layers_run": max(depths, default=0),
                  "n_layers": self.cfg.n_layers}
        self.metrics.record_tick(bucket, len(admitted), self.max_batch,
                                 useful, padded, lats, wall, **kw)
        return len(admitted)

    def drain(self) -> int:
        """Tick until the queue is empty; returns requests completed."""
        done = 0
        while self.pending():
            done += self.tick()
        return done

    # ------------------------------------------------------------- warm
    def warm(self, cohorts) -> list:
        """Prepare ahead of traffic: ``cohorts`` is an iterable of
        (n_agents, test_rows) pairs; each distinct bucket they map to
        gets its solver built and run once on an all-masked zero batch
        (which also builds the kernel library and loads cuBLAS).
        Returns the warmed buckets."""
        warmed = self.buckets.buckets_for(cohorts)
        for bucket in warmed:
            empty, e_mask, e_t = self._empty_slot(bucket)
            self._run(self._solver(bucket), [empty] * self.max_batch,
                      [e_mask] * self.max_batch, [e_t] * self.max_batch)
        return warmed

    def cache_stats(self) -> dict:
        """Stats of this server's bucket-solver cache."""
        return self._cache.stats()
