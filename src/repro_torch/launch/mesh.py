"""The SURF meshes: a named grid of ``torch.device``s, driven by one
process; the port of ``repro.launch.mesh``.

JAX's mesh is single-controller (one process drives every device), and
so is this one: ``Mesh`` holds a numpy grid of devices with named axes,
the engines place agent blocks, seed lanes and Q slices on its devices
(``sharding.surf_rules``), and the halo mixers copy boundary rows between
them (``topology.halo``). PyTorch launches asynchronously, so on several
real cards the shards' work overlaps. There is no multi-process path:
the reference has none either (it never calls ``jax.distributed``).

``make_surf_mesh(seed_shards, agent_shards)`` is the ONE axis system the
SURF engines consume: ``('seed', 'agent')``, the seed axis of the
seed-batched trainer and the agent axis the halo/ring mixers exchange
over (``sharding.surf_rules.axis_for_role`` maps role → axis name; the
legacy 1-D ``make_agent_mesh`` and its ``'data'`` axis are the
degenerate agent-only case).

``devices=None`` means the visible CUDA cards, and a mesh needing more
raises. A mesh is SIMULATED only when asked for: an explicit
``devices=`` list may repeat one device — the port's counterpart of the
reference's ``XLA_FLAGS=--xla_force_host_platform_device_count=N``. The
tests build ``devices=["cpu"] * 8``; ``chip_smoke.py`` builds
``["cuda:0"] * k``, shards that share one card (they show the cost of the
decomposition, not multi-card scaling). ``Mesh.simulated`` says so, and
every record made on such a mesh carries it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sharding.surf_rules import check_divides


class Mesh:
    """A named grid of torch devices. ``devices`` is a numpy object array
    of ``torch.device``s, ``axis_names`` one name per dim and ``shape``
    the axis sizes by name (as ``jax.sharding.Mesh``)."""

    def __init__(self, devices, axis_names):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(given[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-D device grid but axis names "
                             f"{tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def home(self) -> torch.device:
        """The device at index 0 of every axis: where the engines keep
        what they replicate (θ, the optimizer state, S)."""
        return self.devices.flat[0]

    @property
    def simulated(self) -> bool:
        """True when one device stands for several shards."""
        return len({str(d) for d in self.devices.flat}) < self.size

    def along(self, axis, **at) -> tuple:
        """The devices along ``axis``, the other axes at the indices
        ``at`` names (0 by default): ``mesh.along("agent", seed=1)``."""
        idx = [slice(None) if name == axis else int(at.get(name, 0))
               for name in self.axis_names]
        return tuple(self.devices[tuple(idx)].flat)

    def __repr__(self):
        sim = ", simulated" if self.simulated else ""
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.flat]}{sim})")


def host_device_count() -> int:
    """Number of visible CUDA devices (0 without a card)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _grid(need, shape, devices, what):
    """``need`` devices as a grid of ``shape``: the first ``need`` of
    ``devices``, or of the visible CUDA cards when None."""
    if devices is None:
        have = host_device_count()
        if need > have:
            raise ValueError(
                f"{what} needs {need} devices but only {have} CUDA "
                f"device(s) are visible; to simulate the shards pass "
                f"devices=['cuda:0'] * {need} (one card) or "
                f"devices=['cpu'] * {need} (the CPU)")
        devices = [f"cuda:{i}" for i in range(need)]
    devices = list(devices)
    if len(devices) < need:
        raise ValueError(f"{what} needs {need} devices, devices= lists "
                         f"{len(devices)}")
    return np.array([torch.device(d) for d in devices[:need]],
                    dtype=object).reshape(shape)


def make_cpu_mesh():
    """1-device ('data', 'model') mesh on the CPU, for smoke tests."""
    return Mesh(_grid(1, (1, 1), ["cpu"], "make_cpu_mesh"),
                ("data", "model"))


def make_surf_mesh(seed_shards: int = 1, agent_shards: int = 1, *,
                   n_seeds: int | None = None, n_agents: int | None = None,
                   devices=None):
    """The SURF axis system: a named ``('seed', 'agent')`` 2-D mesh of
    ``seed_shards`` × ``agent_shards`` devices, row-major over
    ``devices`` (None: the visible CUDA cards). Either axis degenerates
    cleanly: ``make_surf_mesh(1, P)`` is an agent-only mesh,
    ``make_surf_mesh(P, 1)`` a seed-only one.

    ``n_seeds`` / ``n_agents``: problem sizes to validate UP FRONT, with
    an actionable error, instead of deep inside an engine."""
    seed_shards, agent_shards = int(seed_shards), int(agent_shards)
    if seed_shards < 1 or agent_shards < 1:
        raise ValueError(f"make_surf_mesh: shard counts must be >= 1, got "
                         f"seed_shards={seed_shards} "
                         f"agent_shards={agent_shards}")
    if n_seeds is not None:
        check_divides(n_seeds, seed_shards, "make_surf_mesh", "n_seeds",
                      "the seed-batched engine gives every shard an equal "
                      "block of seed lanes; pass a seed batch whose "
                      f"length is a multiple of seed_shards={seed_shards}")
    if n_agents is not None:
        check_divides(n_agents, agent_shards, "make_surf_mesh", "n_agents",
                      "the halo exchange gives every shard an equal row "
                      f"block of W; lower agent_shards={agent_shards}")
    grid = _grid(seed_shards * agent_shards, (seed_shards, agent_shards),
                 devices, f"make_surf_mesh({seed_shards}, {agent_shards})")
    return Mesh(grid, ("seed", "agent"))


def make_agent_mesh(n_shards: int | None = None, devices=None):
    """DEGENERATE-CASE SHIM: the legacy 1-D agent-axis mesh — ``n_shards``
    devices on 'data' and a trivial 'model' axis. Defaults to every
    listed device (the visible CUDA cards when ``devices`` is None). New
    code builds ``make_surf_mesh(1, n_shards)``."""
    if n_shards is None:
        n_shards = host_device_count() if devices is None else len(devices)
    n = int(n_shards)
    return Mesh(_grid(n, (n, 1), devices, f"make_agent_mesh({n})"),
                ("data", "model"))


def mesh_device(mesh, device):
    """The home device of a run on ``mesh``: ``mesh.home`` (checked by
    ``resolve_device``), which an explicit ``device`` must name."""
    from repro_torch.utils.device import resolve_device
    home = resolve_device(mesh.home)
    if device is None:
        return home
    dev = torch.device(device)
    if dev.type != home.type or dev.index not in (None, home.index):
        raise ValueError(f"device={device!r} is not the mesh's home device "
                         f"{mesh.home} (the devices of a run on a mesh "
                         "come from the mesh)")
    return home
