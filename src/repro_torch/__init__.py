"""PyTorch + CUDA port of the SURF reproduction (the JAX package
``repro`` stays beside it as the reference).

Layout mirrors ``repro`` module for module. The package imports torch
and numpy only — never jax, nothing of ``repro`` — and the root stays
import-light: it re-exports the cache hygiene entry points.

    import repro_torch
    repro_torch.clear_caches()          # drop every cached bucket solver
    repro_torch.cache_stats()           # {name: {size, hits, misses, ...}}
"""
from repro_torch.utils.cache import cache_stats, clear_caches  # noqa: F401

__all__ = ["clear_caches", "cache_stats"]
