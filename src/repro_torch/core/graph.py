"""Compatibility shim: graphs live in ``repro_torch.topology.families``.

The port of ``repro.core.graph``: it re-exports the original
``core.graph`` surface, the same objects, so imports of that surface
keep working. New code imports ``repro_torch.topology.families``.
"""
from __future__ import annotations

from repro_torch.topology.families import (  # noqa: F401
    build_topology,
    er_graph,
    is_connected,
    metropolis_weights,
    metropolis_weights_loop,
    regular_graph,
    ring_graph,
    star_graph,
)
