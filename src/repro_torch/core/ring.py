"""Ring-topology graph filter as nearest-neighbour boundary-row
exchanges instead of a dense S @ W; the port of ``repro.core.ring``.

A SPECIAL CASE of the general block-sparse halo mixer
(``topology.halo``): the Metropolis matrix of a circulant 2·hops-regular
ring is banded with offsets {0, ±1} at the shard level and ``hops``
needed boundary rows per direction, so ``make_halo_mix`` moves O(hops·d)
per mixing round. This module keeps the ring constructor and its stable
``("ring", ...)`` cache tag. Built with ``axis="agent"`` on a 2-D
``('seed', 'agent')`` mesh it exchanges over the agent axis of seed row
0; the legacy ``axis="data"`` meshes are the 1-D case. The reference's
``mesh_context`` has no counterpart: a torch mesh needs no scope.
"""
from __future__ import annotations

from repro_torch.sharding.surf_rules import mesh_fingerprint
from repro_torch.topology.families import metropolis_weights, ring_graph
from repro_torch.topology.halo import make_halo_mix


def make_ring_mix(mesh, axis: str, n: int, hops: int):
    """The Horner graph filter ``mix_fn(W, h)`` for the 2·hops-regular
    circulant ring: ``make_halo_mix`` applied to
    ``metropolis_weights(ring_graph(n, hops))``, tagged
    ``("ring", axis, n, hops, mesh-fingerprint)`` so two rings of one
    geometry share cached bodies."""
    return make_halo_mix(mesh, axis, dense_equivalent(n, hops),
                         tag=("ring", axis, n, hops,
                              mesh_fingerprint(mesh)))


def dense_equivalent(n, hops):
    """The dense Metropolis mixing matrix the ring path must reproduce."""
    return metropolis_weights(ring_graph(n, hops))
