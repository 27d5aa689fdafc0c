"""Bounded-LRU caches and the process-wide cache registry behind
``repro_torch.clear_caches()`` / ``repro_torch.cache_stats()``: the
port's copy of ``repro.utils.cache`` (pure Python).

The serving layer keeps one solver object per shape bucket in a
``BoundedLRU``: a MutableMapping (the ``key in CACHE`` / ``CACHE[key]``
idiom works) that evicts the least-recently-used entry past ``maxsize``
instead of growing without bound.

Caches register themselves by name in a WEAK registry, so module-level
caches live as long as their module and per-instance caches (one bucket
cache per ``FederationServer``) vanish with their owner instead of
leaking through the registry. ``clear_caches()`` empties every live
registered cache (or just the named ones); ``cache_stats()`` returns a
per-cache stats snapshot.

Stats semantics: ``hits`` counts item lookups (``cache[key]``),
``misses`` counts ``get_or_build`` calls that had to build, ``inserts``
counts stores, ``evictions`` counts LRU drops. Call sites using the
plain mapping protocol therefore count hits exactly and misses only via
inserts; ``get_or_build`` accounts both.
"""
from __future__ import annotations

import itertools
import threading
import weakref
from collections import OrderedDict
from collections.abc import MutableMapping

_registry_lock = threading.Lock()
_REGISTRY: "OrderedDict[str, weakref.ref]" = OrderedDict()
_counter = itertools.count(1)


def register_cache(name: str, cache: "BoundedLRU") -> str:
    """Register ``cache`` under ``name`` (weakly). A taken name gets a
    ``#k`` suffix so per-instance caches never clobber module-level
    ones. Returns the name actually used."""
    with _registry_lock:
        _prune_locked()
        used = name
        while used in _REGISTRY:
            used = f"{name}#{next(_counter)}"
        _REGISTRY[used] = weakref.ref(cache)
    return used


def _prune_locked():
    dead = [n for n, ref in _REGISTRY.items() if ref() is None]
    for n in dead:
        del _REGISTRY[n]


def _live_caches():
    with _registry_lock:
        _prune_locked()
        return [(n, ref()) for n, ref in _REGISTRY.items()]


def clear_caches(*names: str):
    """Empty every live registered cache (the serve bucket solvers).
    With ``names``, clear only those — unknown
    names raise so typos don't silently clear nothing. Returns the list
    of cache names cleared."""
    live = _live_caches()
    if names:
        known = {n for n, _ in live}
        missing = [n for n in names if n not in known]
        if missing:
            raise KeyError(
                f"unknown cache name(s) {missing}; registered: "
                f"{sorted(known)}")
        live = [(n, c) for n, c in live if n in names]
    cleared = []
    for n, c in live:
        if c is not None:
            c.clear()
            cleared.append(n)
    return cleared


def cache_stats() -> dict:
    """{name: stats dict} snapshot of every live registered cache."""
    return {n: c.stats() for n, c in _live_caches() if c is not None}


class BoundedLRU(MutableMapping):
    """An LRU-bounded mapping with hit/miss/eviction stats.

    ``maxsize`` bounds the entry count — inserting past it evicts the
    least-recently-used entry (lookups refresh recency). ``name``
    registers the cache in the process registry (see module docstring);
    ``self.name`` is the registered (possibly suffixed) name."""

    def __init__(self, maxsize: int = 64, name: str | None = None):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self._data: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.name = register_cache(name, self) if name else None

    def __getitem__(self, key):
        with self._lock:
            value = self._data[key]          # KeyError propagates
            self._data.move_to_end(key)
            self.hits += 1
            return value

    def __setitem__(self, key, value):
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            self.inserts += 1
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self.evictions += 1

    def __delitem__(self, key):
        with self._lock:
            del self._data[key]

    def __contains__(self, key):
        with self._lock:
            return key in self._data

    def __iter__(self):
        with self._lock:
            return iter(list(self._data))

    def __len__(self):
        with self._lock:
            return len(self._data)

    def get_or_build(self, key, build):
        """``cache[key]`` if present (a hit), else ``build()``, store and
        return it (a miss). The one call site idiom that counts both
        sides of the stats."""
        with self._lock:
            if key in self._data:
                return self[key]
            self.misses += 1
        value = build()                      # build outside the lock
        self[key] = value
        return value

    def clear(self):
        with self._lock:
            self._data.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._data), "maxsize": self.maxsize,
                    "hits": self.hits, "misses": self.misses,
                    "inserts": self.inserts, "evictions": self.evictions}
