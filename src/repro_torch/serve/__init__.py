"""Amortized-solver serving: batch-solve NEW federations at request rate.

    server = FederationServer(cfg, theta, mix="cuda")
    server.warm([(n, t), ...])           # build ahead of traffic
    fut = server.submit(S, dataset, seed=0)
    server.tick()                        # or drain()
    fut.result()["final_acc"]

Layers: ``solver`` (the request-batched masked forward, fixed or
adaptive depth), ``buckets`` (shape bucketing + inert padding), ``queue``
(continuous batching + futures, deadline-aware admission), ``driver``
(``AsyncDriver`` — a background tick thread so ``submit`` returns at
once), ``metrics`` (throughput / latency / pad-waste / cache / depth
telemetry). The CLI driver is ``repro_torch.launch.surf_serve``.
"""
from repro_torch.serve.buckets import (Bucket, BucketSpec, pad_cohort,
                                       pad_probe)
from repro_torch.serve.driver import AsyncDriver
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import FederationServer, ServeFuture
from repro_torch.serve.solver import (SERVE_MIXES, make_bucket_solver,
                                      request_shardings, resolve_serve_mix,
                                      serve_cache_key)

__all__ = ["Bucket", "BucketSpec", "pad_cohort", "pad_probe",
           "AsyncDriver", "ServeMetrics", "FederationServer",
           "ServeFuture", "SERVE_MIXES", "make_bucket_solver",
           "request_shardings", "resolve_serve_mix", "serve_cache_key"]
