"""Serving telemetry: throughput, latency percentiles, bucket occupancy
and pad waste (the port of ``repro.serve.metrics``).

``ServeMetrics`` accumulates one record per completed request and one
per solver tick; ``summary()`` condenses them:

  * ``federations_per_sec`` — completed requests over total solve wall
    time, with the solve timed from a synchronized card to a
    synchronized card (and a ``rolling_`` variant over the last
    ``window`` ticks);
  * ``latency_p50_ms`` / ``latency_p99_ms`` — enqueue→complete, so
    queueing delay counts, exactly what a caller observes;
  * ``occupancy`` — admitted requests over offered batch slots (low
    occupancy = the stream is too fragmented for ``max_batch``);
  * ``pad_waste`` — 1 − useful/padded compute cells, where a cell is
    one (agent × test-row) unit; waste comes from bucket rounding AND
    empty batch slots;
  * ``bucket_cache`` — hit/miss/insert/eviction counts of the server's
    bucket-solver LRU (``repro_torch.cache_stats()`` format);
  * adaptive-depth telemetry (``depth="adaptive"`` servers only) —
    ``depth_hist`` counts realized per-request depths, ``mean_depth``
    their mean, ``request_flops_saved`` = 1 − Σdepth/(N·L) the share of
    per-request layer work the early exit skipped, and
    ``batch_flops_saved`` = 1 − Σlayers_run/(ticks·L) what the BATCH
    saved (a tick runs to its slowest request, one graph-filter launch
    per layer, so batch savings lag request savings under mixed
    difficulty).
"""
from __future__ import annotations

from collections import deque

import numpy as np


class ServeMetrics:
    def __init__(self, window: int = 64, cache=None):
        # the server's bucket-solver BoundedLRU; its live stats()
        # ride along in every summary() snapshot
        self.cache = cache
        self.latencies = []              # seconds, one per completed request
        self.completed = 0
        self.ticks = 0
        self.solve_time = 0.0            # seconds inside solver calls
        self.slots_offered = 0           # max_batch per tick
        self.admitted = 0
        self.useful_cells = 0.0          # Σ n_real * t_real over requests
        self.padded_cells = 0.0          # Σ slots * n_pad * t_pad over ticks
        self.per_bucket = {}             # bucket -> tick count
        self._window = deque(maxlen=window)   # (wall, n_admitted) per tick
        self.depth_hist = {}             # realized depth -> request count
        self.layers_run = 0              # Σ layers run over adaptive ticks
        self.adaptive_ticks = 0
        self.n_layers = 0                # L, for flops-saved denominators

    def record_tick(self, bucket, n_admitted, slots, useful_cells,
                    padded_cells, latencies, wall, depths=None,
                    layers_run=None, n_layers=None):
        """One solver invocation: ``n_admitted`` requests in ``slots``
        batch slots of ``bucket``, per-request enqueue→complete
        ``latencies`` (seconds), ``wall`` seconds in the solve. Adaptive
        servers also pass per-request realized ``depths``, the layers the
        tick ran (``layers_run``) and the model depth ``n_layers``."""
        self.ticks += 1
        self.completed += int(n_admitted)
        self.admitted += int(n_admitted)
        self.slots_offered += int(slots)
        self.solve_time += float(wall)
        self.useful_cells += float(useful_cells)
        self.padded_cells += float(padded_cells)
        self.latencies.extend(float(x) for x in latencies)
        key = tuple(bucket)
        self.per_bucket[key] = self.per_bucket.get(key, 0) + 1
        self._window.append((float(wall), int(n_admitted)))
        if depths is not None:
            self.adaptive_ticks += 1
            self.layers_run += int(layers_run)
            self.n_layers = int(n_layers)
            for d in depths:
                self.depth_hist[int(d)] = self.depth_hist.get(int(d), 0) + 1

    def summary(self) -> dict:
        lat = np.asarray(self.latencies, np.float64)
        w_wall = sum(w for w, _ in self._window)
        w_n = sum(n for _, n in self._window)
        out = {
            "requests_completed": self.completed,
            "ticks": self.ticks,
            "federations_per_sec": (self.completed / self.solve_time
                                    if self.solve_time > 0 else 0.0),
            "rolling_federations_per_sec": (w_n / w_wall
                                            if w_wall > 0 else 0.0),
            "latency_p50_ms": (float(np.percentile(lat, 50)) * 1e3
                               if lat.size else 0.0),
            "latency_p99_ms": (float(np.percentile(lat, 99)) * 1e3
                               if lat.size else 0.0),
            "occupancy": (self.admitted / self.slots_offered
                          if self.slots_offered else 0.0),
            "pad_waste": (1.0 - self.useful_cells / self.padded_cells
                          if self.padded_cells > 0 else 0.0),
            "per_bucket_ticks": {f"n{n}xt{t}": c
                                 for (n, t), c in
                                 sorted(self.per_bucket.items())},
        }
        if self.cache is not None:
            out["bucket_cache"] = dict(self.cache.stats())
        if self.adaptive_ticks:
            total_depth = sum(d * c for d, c in self.depth_hist.items())
            n_req = max(sum(self.depth_hist.values()), 1)
            L_ = max(self.n_layers, 1)
            out.update({
                "depth_hist": {str(d): c for d, c in
                               sorted(self.depth_hist.items())},
                "mean_depth": total_depth / n_req,
                "request_flops_saved": 1.0 - total_depth / (n_req * L_),
                "batch_flops_saved": 1.0 - self.layers_run / (
                    self.adaptive_ticks * L_),
            })
        return out
