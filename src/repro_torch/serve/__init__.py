"""Amortized-solver serving: batch-solve NEW federations at request rate.

    server = FederationServer(cfg, theta, mix="cuda")
    server.warm([(n, t), ...])           # build ahead of traffic
    fut = server.submit(S, dataset, seed=0)
    server.tick()                        # or drain()
    fut.result()["final_acc"]

Layers: ``solver`` (the request-batched masked forward), ``buckets``
(shape bucketing + inert padding), ``queue`` (continuous batching +
futures, deadline-aware admission), ``metrics`` (throughput / latency /
pad-waste / cache telemetry).
"""
from repro_torch.serve.buckets import Bucket, BucketSpec, pad_cohort
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import FederationServer, ServeFuture
from repro_torch.serve.solver import (SERVE_MIXES, make_bucket_solver,
                                      resolve_serve_mix, serve_cache_key)

__all__ = ["Bucket", "BucketSpec", "pad_cohort", "ServeMetrics",
           "FederationServer", "ServeFuture", "SERVE_MIXES",
           "make_bucket_solver", "resolve_serve_mix", "serve_cache_key"]
