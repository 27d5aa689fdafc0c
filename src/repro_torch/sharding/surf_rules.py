"""Placement rules for the SURF engines on a ``launch.mesh.Mesh``: the
port of ``repro.sharding.surf_rules``.

The reference hands ``NamedSharding``s to ``jax.jit`` and lets the SPMD
partitioner move the data. The port's mesh is single-controller too (one
process drives every device), but PyTorch has no partitioner: a rule
here returns a ``Placement``, which says which device holds which block
of a tensor, and the engines place, select and gather by it.

AXIS ROLES, not axis names: every rule places one of two roles —

  * the SEED role (``seed_sharding``): the seed lanes of the
    seed-batched engine, lane i on the device of its seed shard;
  * the AGENT role (``agent_sharding``, the Q rules): W's row blocks,
    which the halo/ring mixers exchange boundary rows between, and the Q
    axis of the Q-sharded pools (data-parallel over the same devices).

``axis_for_role`` maps a role to the mesh axis that carries it: the
named ``'seed'``/``'agent'`` axes of a ``make_surf_mesh`` 2-D mesh, or
the legacy ``'data'`` axis of the 1-D shim meshes. Every rule degrades
to replication when the dim does not divide the axis (the reference's
policy), except where a caller checks divisibility first
(``check_divides``) because replication would be silently wrong.

``mesh_fingerprint`` is the hashable mesh identity the engines' cache
keys carry.

JAX-only, the reference's ``NamedSharding`` trees for ``jax.jit``'s
in/out shardings, which have no partitioner to go to here:
``stacked_agent_sharding`` (the pool's agent axis: ``agent_sharding``
places the row blocks), ``stacked_shardings_tree`` and
``stacked_sharded_flags`` (per-leaf shardings and their cache-key
summary: the halo engines place the pool themselves), ``stacked_q_tree``
(per-leaf Q shardings: ``stacked_q_sharding`` and ``ShardedPool``),
``schedule_sharding`` and ``train_state_shardings`` (replicated: the
engines keep the schedule and the state on the mesh's home device).
"""
from __future__ import annotations

from typing import NamedTuple

ROLE_AXES = {"seed": "seed", "agent": "agent"}


class Placement(NamedTuple):
    """Where the blocks of one dim of a tensor live: ``devices[a]`` holds
    block ``a`` of dim ``dim`` (equal blocks, in order). ``dim is None``
    means replicated: every device may hold the whole tensor, and the
    engines keep it on ``devices[0]``, the mesh's home device."""
    axis: str | None
    dim: int | None
    devices: tuple

    @property
    def spec(self):
        """The reference's ``PartitionSpec`` as a tuple: ``()`` when
        replicated, else ``axis`` at ``dim`` (``(None, "agent")``)."""
        if self.dim is None:
            return ()
        return (None,) * self.dim + (self.axis,)

    @property
    def shards(self) -> int:
        return 1 if self.dim is None else len(self.devices)

    def owner(self, index, size):
        """The block holding entry ``index`` of a dim of ``size``."""
        return 0 if self.dim is None else index // (size // self.shards)

    def device_of(self, index, size):
        return self.devices[self.owner(index, size)]

    def split(self, x):
        """``x``'s blocks, each on its device (views when a block already
        lies there)."""
        if self.dim is None:
            return [x.to(self.devices[0])]
        blocks = x.chunk(self.shards, self.dim)
        return [b.to(dev) for b, dev in zip(blocks, self.devices)]


def check_divides(count, shards, what, noun, fix):
    """The ONE actionable divisibility guard behind ``make_surf_mesh``,
    the halo planners, the seed-batched engine and the sharded server: an
    axis whose problem size does not divide its shard count fails UP
    FRONT naming the fix."""
    if shards <= 1 or count % shards == 0:
        return
    divisors = [d for d in range(1, count + 1) if count % d == 0]
    raise ValueError(
        f"{what}: {noun}={count} does not divide over {shards} shards — "
        f"{fix}; pick a shard count from the divisors of {count} "
        f"({divisors})")


def axis_for_role(mesh, role: str):
    """Mesh axis carrying an axis ROLE ('seed' | 'agent'): the named axis
    of a ``make_surf_mesh`` 2-D mesh when present, else the legacy 'data'
    axis, else None (nothing to place over — every rule replicates)."""
    try:
        name = ROLE_AXES[role]
    except KeyError:
        raise ValueError(f"unknown axis role {role!r}; one of "
                         f"{sorted(ROLE_AXES)}")
    if name in mesh.axis_names:
        return name
    if "data" in mesh.axis_names:
        return "data"
    return None


def mesh_fingerprint(mesh):
    """Hashable identity of a mesh for cache keys (None passes through so
    unsharded bodies keep their keys): axis names, axis sizes and the
    devices in grid order. A simulated mesh repeats a device, so it never
    shares a key with a real one of the same shape."""
    if mesh is None:
        return None
    return (tuple(mesh.axis_names),
            tuple(int(mesh.shape[a]) for a in mesh.axis_names),
            tuple(str(d) for d in mesh.devices.flat))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    return int(mesh.shape[axis]) if axis in mesh.axis_names else 1


def replicated(mesh) -> Placement:
    return Placement(None, None, (mesh.home,))


def _dim_placement(dim_size, mesh, axis, position, **at):
    """``axis`` at ``position`` when the dim divides the axis size, else
    replicated (on the first device along ``axis``). ``at`` fixes the
    other axes' indices (default 0)."""
    size = _axis_size(mesh, axis)
    if size <= 1 or (dim_size is not None and dim_size % size != 0):
        if axis is None or axis not in mesh.axis_names:
            return replicated(mesh)
        return Placement(None, None, mesh.along(axis, **at)[:1])
    return Placement(axis, position, mesh.along(axis, **at))


def agent_sharding(mesh, n_agents=None, axis=None, **at) -> Placement:
    """W's agent axis (dim 0) over the AGENT-role axis: the halo mixers'
    row blocks. ``at`` picks the seed row of a 2-D mesh (``seed=r``)."""
    axis = axis_for_role(mesh, "agent") if axis is None else axis
    return _dim_placement(n_agents, mesh, axis, 0, **at)


def stacked_q_sharding(mesh, n_q=None, axis=None) -> Placement:
    """A stacked pool's Q axis (dim 0) over the AGENT-role axis:
    data-parallel evaluation, and the Q-sharded training pool."""
    axis = axis_for_role(mesh, "agent") if axis is None else axis
    return _dim_placement(n_q, mesh, axis, 0)


def seed_sharding(mesh, n_seeds=None, axis=None) -> Placement:
    """The seed lanes (dim 0 of every per-seed stack) over the SEED-role
    axis: lane i runs on the home device of its seed shard."""
    axis = axis_for_role(mesh, "seed") if axis is None else axis
    return _dim_placement(n_seeds, mesh, axis, 0)


def q_select_axis(mesh, n_q=None, axis=None):
    """The mesh axis a Q-SHARDED pool's per-step select runs over, or None
    when the pool would replicate anyway (no mesh, axis size 1, or
    indivisible Q): the one gate both ``make_q_select`` and the placement
    rules consult, so they never disagree."""
    if mesh is None:
        return None
    axis = axis_for_role(mesh, "agent") if axis is None else axis
    size = _axis_size(mesh, axis)
    if size <= 1 or n_q is None or n_q % size != 0:
        return None
    return axis


class ShardedPool:
    """A stacked pool (dict of (Q, ...) tensors) split along Q by a
    ``Placement``: each device holds Q/shards datasets. A replicated
    placement keeps one block, the whole pool, on the home device.
    ``get(q)`` is dataset q on its owner's device (views)."""

    def __init__(self, pool, placement: Placement):
        self.n_q = int(next(iter(pool.values())).shape[0])
        self.placement = placement
        cols = {k: placement.split(v) for k, v in pool.items()}
        self.blocks = [{k: cols[k][a] for k in cols}
                       for a in range(placement.shards)]
        self.q_local = self.n_q // placement.shards

    def __len__(self):
        return self.n_q

    def device_of(self, q):
        return self.placement.device_of(q, self.n_q)

    def get(self, q):
        block = self.blocks[self.placement.owner(q, self.n_q)]
        return {k: v[q % self.q_local] for k, v in block.items()}


def make_q_select(mesh, axis):
    """``select(pool, t, device) -> batch`` for a Q-SHARDED
    ``ShardedPool`` over ``axis``: meta-step t's dataset t mod Q, copied
    from the device that owns it to ``device`` (the reference's
    owner-masked psum moves one dataset's bytes per step, whatever Q is;
    so does this copy). The copy is BIT-equal to the replicated index."""
    def select(pool, t, device):
        if pool.placement.axis != axis:
            raise ValueError(f"the pool is placed over "
                             f"{pool.placement.axis!r}, the select over "
                             f"{axis!r} of mesh {mesh_fingerprint(mesh)}")
        return {k: v.to(device) for k, v in pool.get(t % len(pool)).items()}

    return select


def train_scan_shardings(mesh, axis=None, n_eval_q=None, q_sharded=False,
                         n_q=None):
    """Placements of the single-seed driver's data: ``{"state", "pool",
    "eval_pool"}``. The state stays on the home device, with S (θ is
    shared by every agent). The training pool is
    Q-sharded over the agent-role axis when ``q_sharded`` (gated by
    ``q_select_axis``), else replicated: the port's halo mixers split W's
    rows themselves at every filter call (``topology.halo``), so the pool
    need not be agent-sharded. The snapshot pool (``n_eval_q``) is
    Q-sharded whenever Q divides the axis: data-parallel snapshots."""
    rep = replicated(mesh)
    axis = axis_for_role(mesh, "agent") if axis is None else axis
    pool = (stacked_q_sharding(mesh, n_q, axis)
            if q_sharded and q_select_axis(mesh, n_q, axis) is not None
            else rep)
    ev = stacked_q_sharding(mesh, n_eval_q, axis) if n_eval_q else rep
    return {"state": rep, "pool": pool, "eval_pool": ev}


def seed_scan_shardings(mesh, n_seeds=None, axis=None, n_eval_q=None,
                        q_sharded=False, n_q=None):
    """Placements of the seed-batched driver's data: the per-seed states
    (with their S and nominal S_eval) over the SEED-role axis (lane i on
    its seed shard's home device); the shared pools Q-sharded over the
    AGENT-role axis ONLY on a 2-D mesh (``agent != seed``), where they
    follow ``train_scan_shardings``'s rules. On a 1-D mesh both roles
    resolve to one axis, which the seed lanes own, and both pools stay
    replicated."""
    seed_ax = axis_for_role(mesh, "seed") if axis is None else axis
    agent_ax = axis_for_role(mesh, "agent")
    seed = seed_sharding(mesh, n_seeds, seed_ax)
    rep = replicated(mesh)
    two_d = (agent_ax is not None and agent_ax != seed_ax
             and _axis_size(mesh, agent_ax) > 1)
    if two_d:
        inner = train_scan_shardings(mesh, axis=agent_ax, n_eval_q=n_eval_q,
                                     q_sharded=q_sharded, n_q=n_q)
        pool, ev = inner["pool"], inner["eval_pool"]
    else:
        pool = ev = rep
    return {"state": seed, "pool": pool, "eval_pool": ev}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


class Replicas:
    """Copies of replicated values (S, θ: tensors or dicts of tensors) on
    the devices that use them, each made once: ``on(device)`` returns the
    dict of values on ``device`` (the originals on their own device)."""

    def __init__(self, **values):
        self._values = values
        self._on = {}

    def on(self, device):
        if device not in self._on:
            self._on[device] = {k: _to(v, device)
                                for k, v in self._values.items()}
        return self._on[device]
