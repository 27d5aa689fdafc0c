"""Block-sparse halo-exchange graph mixing: ``S @ W`` with W's agent axis
split over the devices of a mesh's agent axis, for ARBITRARY mixing
matrices; the port of ``repro.topology.halo``.

Decomposition: partition the n agents into ``nshards`` contiguous
blocks of ``nl = n/nshards`` rows. ``S`` then splits into shard-level
blocks ``S[a, b]`` and

    (S @ W)|_a  =  Σ_δ  S[a, (a+δ) mod nshards] @ W|_{(a+δ) mod nshards}

over shard offsets δ. Only offsets with a NONZERO block anywhere move
data, and each moves only the UNION of source-block rows any
destination references (for a circulant ring of ``hops`` neighbours,
``hops`` boundary rows per direction: ``core.ring`` is the special case
offsets = {0, ±1}). Dense parity is exact by construction: every nonzero
of S lands in exactly one offset block. The plans (``halo_plan``,
``scheduled_halo_plan``) are numpy and bit-equal to the reference's.

The exchange: the reference's ``shard_map`` becomes an explicit loop
over the agent axis's shards, W's row block ``a`` on shard ``a``'s
device, and each ``ppermute`` of offset δ a ``.to(dst)`` copy of that
offset's union rows ``Y[rows]``. Autograd flows through the copies and
the indexing, so the meta-step's gradient (and RSDUN's grad-of-grad
through the loss) needs nothing new. The mixer takes W on the run's
home device, places its row blocks on the shards, runs the K hops there
and gathers the result home: the perceptron and the loss run on the home
device, where θ lives.

``resident`` selects the engine of each shard's communication-free
on-shard block ``S0_loc @ Y`` (``_resident_matmul``): a plain matmul, or
the CUDA graph-filter kernel as its 1-tap case h = [0, 1]
(``mix="halo-pallas"``; the plain filter on CPU tensors). Per layer of K
hops that is nshards · K forward launches; every one of them also takes
a dW launch in the backward, even in layer 1, because Horner's first
iterate h_K · W_loc carries a gradient through h.

Three mixers share the filter body (``_halo_filter``) and differ only in
how they bind the coefficient blocks: ``make_halo_mix`` bakes one S;
``ScheduledHaloMix.at_step(t)`` binds step t of a time-varying schedule
whose plan is time-constant (the union support ∪_t supp(S_t): link
failures, dropouts and Markov outages never ADD edges, so a banded base
keeps its savings); ``SeedHaloMix.bind(lane, t)`` binds one seed lane
(and step) of the seed-batched engine on a 2-D ('seed', 'agent') mesh,
each lane exchanging over the agent devices of its seed row. Every
mixer carries a hashable ``.tag`` (content hash of S, mesh fingerprint)
for the cache keys.
"""
from __future__ import annotations

import hashlib
import weakref

import numpy as np
import torch

from repro_torch.sharding.surf_rules import (agent_sharding, check_divides,
                                             mesh_fingerprint,
                                             seed_sharding)


def _check_divisible(n, nshards, what="halo plan"):
    """Every halo planner fails an indivisible agent axis HERE with the
    shared actionable message."""
    check_divides(n, nshards, what, "n",
                  f"the halo exchange gives every shard an equal "
                  f"n/{nshards} row block of W; build the mesh via "
                  f"launch.mesh.make_surf_mesh(seed_shards, agent_shards, "
                  f"n_agents={n})")


def _np32(S):
    """S (numpy, a tensor on any device, or a nested list) as f32 numpy."""
    if isinstance(S, torch.Tensor):
        return S.detach().to("cpu", torch.float32).numpy()
    return np.asarray(S, np.float32)


def _digest(S):
    return hashlib.sha256(np.ascontiguousarray(S).tobytes()).hexdigest()[:16]


RESIDENTS = ("dense", "pallas")


def _resident_matmul(resident):
    """The per-hop RESIDENT block product ``S0_loc @ Y``: a plain matmul
    (``resident="dense"``) or the graph-filter kernel called as its 1-tap
    case ``h = [0, 1] → 0·Y + 1·S0 Y`` (``resident="pallas"``), through
    ``kernels.graph_filter.graph_filter`` and its gradient, so the
    meta-gradient runs the kernel's dW entry too. On CPU tensors the
    wrapper takes the plain filter; on CUDA tensors it launches the
    kernel or raises. Boundary rows are exchanged either way."""
    if resident not in RESIDENTS:
        raise ValueError(f"resident must be one of {RESIDENTS}, got "
                         f"{resident!r}")
    if resident == "dense":
        return lambda S0, Y: S0 @ Y
    from repro_torch.kernels.graph_filter import graph_filter
    one_hop = {}

    def res(S0, Y):
        h = one_hop.get(Y.device)
        if h is None:
            h = one_hop[Y.device] = torch.tensor([0.0, 1.0],
                                                 device=Y.device)
        return graph_filter(S0, Y, h)

    return res


def _halo_filter(devices, row_sets, perms, resident="dense"):
    """The shared K-tap Horner graph filter ``(W, h, S0s, Sds) -> Y`` over
    the agent-axis shards on ``devices``: block ``a`` of W's rows on
    ``devices[a]``, one copy per active offset and shard carrying only
    that offset's union rows. ``S0s[a]`` (nl, nl) and ``Sds[i][a]``
    (nl, len(row_sets[i])) are the coefficient blocks on shard a's
    device; ``perms[i]`` the (source, destination) shard pairs of offset
    i. W and the result live on W's device."""
    res_mm = _resident_matmul(resident)
    idx = [[torch.as_tensor(rows, dtype=torch.long, device=dev)
            for dev in devices] for rows in row_sets]

    def apply_S(Ys, S0s, Sds):
        recv = [[None] * len(devices) for _ in perms]
        for i, perm in enumerate(perms):
            for src, dst in perm:
                recv[i][dst] = Ys[src][idx[i][src]].to(devices[dst])
        outs = []
        for a, Y in enumerate(Ys):
            out = res_mm(S0s[a], Y)
            for i in range(len(perms)):
                out = out + Sds[i][a] @ recv[i][a]
            outs.append(out)
        return outs

    def filter_sharded(W, h, S0s, Sds):
        Ws = [b.to(dev) for b, dev in zip(W.chunk(len(devices), 0),
                                          devices)]
        hs = [h.to(dev) for dev in devices]
        K = h.shape[0] - 1
        Ys = [hs[a][K] * Ws[a] for a in range(len(devices))]
        for k in range(K - 1, -1, -1):
            Ys = apply_S(Ys, S0s, Sds)
            Ys = [Y + hs[a][k] * Ws[a] for a, Y in enumerate(Ys)]
        return torch.cat([Y.to(W.device) for Y in Ys], 0)

    return filter_sharded


def _offset_perms(plans, nshards):
    return [[(j, (j - delta) % nshards) for j in range(nshards)]
            for delta, _, _ in plans]


def _on_devices(blocks, devices, axis):
    """Split numpy ``blocks`` along the shard ``axis`` into one tensor per
    shard, each on its device."""
    return [torch.from_numpy(np.ascontiguousarray(np.take(blocks, a, axis)))
            .to(dev) for a, dev in enumerate(devices)]


def halo_plan(S, nshards):
    """The static exchange plan for ``S`` on ``nshards`` shards.

    Returns ``(S0, plans)``: ``S0`` (nshards, nl, nl) is the
    block-diagonal (offset-0, communication-free) part; ``plans`` is a
    list of ``(delta, rows, Sd)`` per active nonzero offset δ ≠ 0 with
    ``rows`` the union of source-block row indices any shard needs
    (what the δ exchange carries) and ``Sd`` (nshards, nl, len(rows))
    the per-shard coefficient blocks restricted to those rows."""
    S = _np32(S)
    n = S.shape[0]
    if S.ndim != 2 or S.shape[1] != n:
        raise ValueError(f"halo plan: S must be (n, n), got shape "
                         f"{tuple(S.shape)}")
    _check_divisible(n, nshards)
    nl = n // nshards
    blocks = S.reshape(nshards, nl, nshards, nl).transpose(0, 2, 1, 3)
    a = np.arange(nshards)
    S0 = blocks[a, a]                               # (nshards, nl, nl)
    plans = []
    for delta in range(1, nshards):
        blk = blocks[a, (a + delta) % nshards]      # (nshards, nl, nl)
        if not blk.any():
            continue
        rows = np.nonzero(blk.any(axis=(0, 1)))[0]  # union of needed rows
        plans.append((delta, rows, np.ascontiguousarray(blk[:, :, rows])))
    return S0, plans


def halo_exchange_rows(plans):
    """Total rows moved per shard per mixing round: the static
    communication model of a plan (the dense path would gather
    (nshards−1)·nl rows instead). Times d times 4 bytes per round is the
    port's counterpart of the reference's collective-bytes count."""
    return sum(len(rows) for _, rows, _ in plans)


def make_halo_mix(mesh, axis: str, S, *, tag=None, resident="dense"):
    """Block-sparse Horner graph filter ``mix_fn(W, h)`` reproducing
    ``graph_filter(S, W, h)`` with W's agent axis split over mesh axis
    ``axis``. Works for ANY (n, n) mixing matrix with n divisible by the
    shard count, nshards=1 included (the local dense product). ``tag``
    overrides the content-hash cache tag (``core.ring`` re-tags its
    circulant case). ``resident="pallas"`` runs each shard's on-shard
    block through the graph-filter kernel (``_resident_matmul``) and tags
    the mixer ``"halo-pallas"``."""
    S = _np32(S)
    n = S.shape[0]
    nshards = int(mesh.shape[axis])
    S0, plans = halo_plan(S, nshards)
    devices = agent_sharding(mesh, n, axis).devices
    S0s = _on_devices(S0, devices, 0)
    Sds = [_on_devices(Sd, devices, 0) for _, _, Sd in plans]
    filt = _halo_filter(devices, [rows for _, rows, _ in plans],
                        _offset_perms(plans, nshards), resident)

    def mix_fn(W, h):
        return filt(W, h, S0s, Sds)

    if tag is None:
        kind = "halo" if resident == "dense" else "halo-pallas"
        tag = (kind, axis, n, nshards, _digest(S), mesh_fingerprint(mesh))
    mix_fn.tag = tag
    mix_fn.plan = (S0, plans)
    return mix_fn


def scheduled_halo_plan(S_stack, nshards):
    """Time-constant exchange plan for a stacked (T, n, n) schedule: the
    offset/row structure of the UNION support ``∪_t supp(S_t)``, with
    per-step coefficient blocks restricted to the union's row sets.

    Returns ``(S0_t, plans)``: ``S0_t`` (T, nshards, nl, nl) is the
    block-diagonal part per step; ``plans`` is a list of
    ``(delta, rows, Sd_t)`` per offset active ANYWHERE in the schedule,
    ``Sd_t`` (T, nshards, nl, len(rows)). Every exchange carries the
    union rows at every step — a step whose S_t does not reference some
    row multiplies it by zero — so the plan is identical across t."""
    S_stack = _np32(S_stack)
    if S_stack.ndim != 3 or S_stack.shape[1] != S_stack.shape[2]:
        raise ValueError(f"scheduled halo plan: S_stack must be (T, n, n), "
                         f"got shape {tuple(S_stack.shape)}")
    T, n, _ = S_stack.shape
    _check_divisible(n, nshards, "scheduled halo plan")
    nl = n // nshards
    union = (S_stack != 0.0).any(axis=0).astype(np.float32)
    _, plans_u = halo_plan(union, nshards)
    blocks = (S_stack.reshape(T, nshards, nl, nshards, nl)
              .transpose(0, 1, 3, 2, 4))        # (T, a, b, nl, nl)
    a = np.arange(nshards)
    S0_t = blocks[:, a, a]                      # (T, nshards, nl, nl)
    plans = []
    for delta, rows, _ in plans_u:
        blk = blocks[:, a, (a + delta) % nshards]   # (T, nshards, nl, nl)
        plans.append((delta, rows, np.ascontiguousarray(blk[:, :, :, rows])))
    return S0_t, plans


class ScheduledHaloMix:
    """Halo mixer for a time-constant-plan schedule: ``at_step(t)``
    returns the step-``t % T`` graph filter ``mix_fn(W, h)``. The drivers
    call it with the CARRIED step (``state.step``), so checkpoint-restored
    runs resume the exact mixing stream. ``scheduled``/``steps``/
    ``schedule_digest``/``tag`` are the engine protocol: the drivers
    re-bind the mixer every meta-step (and refuse a schedule whose
    content digest differs)."""

    scheduled = True

    def __init__(self, mesh, axis, S_stack, *, tag=None, resident="dense"):
        S_stack = _np32(S_stack)
        T, n, _ = S_stack.shape
        nshards = int(mesh.shape[axis])
        S0_t, plans = scheduled_halo_plan(S_stack, nshards)
        devices = agent_sharding(mesh, n, axis).devices
        self._S0 = _on_devices(S0_t, devices, 1)        # (T, nl, nl) each
        self._Sd = [_on_devices(Sd, devices, 1) for _, _, Sd in plans]
        self._filter = _halo_filter(devices, [rows for _, rows, _ in plans],
                                    _offset_perms(plans, nshards), resident)
        self.steps = T
        self.plan = (S0_t, plans)
        self.schedule_digest = _digest(S_stack)
        if tag is None:
            kind = ("halo-sched" if resident == "dense"
                    else "halo-sched-pallas")
            tag = (kind, axis, n, T, nshards, self.schedule_digest,
                   mesh_fingerprint(mesh))
        self.tag = tag

    def at_step(self, t):
        """The graph filter for meta-step ``t`` (cycling mod T)."""
        ti = int(t) % self.steps
        S0s = [x[ti] for x in self._S0]
        Sds = [[x[ti] for x in Sd] for Sd in self._Sd]
        return lambda W, h: self._filter(W, h, S0s, Sds)


def make_scheduled_halo_mix(mesh, axis: str, schedule, *, tag=None,
                            resident="dense"):
    """The time-constant-plan halo mixer for a
    ``topology.schedule.TopologySchedule`` (or a raw (T, n, n) stack):
    pass it as ``mix_fn`` TOGETHER with the schedule to the training
    drivers and time-varying training keeps the halo exchange.
    ``resident="pallas"`` runs each step's on-shard block through the
    kernel (see ``_resident_matmul``)."""
    S_stack = schedule.S if hasattr(schedule, "S") else schedule
    return ScheduledHaloMix(mesh, axis, S_stack, tag=tag, resident=resident)


class _LaneMix:
    """One seed lane of a ``SeedHaloMix`` as a scheduled single-seed
    mixer (``at_step``): the sequential run of that lane on the same mesh
    (``train_scan(..., mix_fn=seed_mix.lane(i))``)."""

    scheduled = True

    def __init__(self, mix, lane):
        self._mix, self._lane = mix, lane
        self.steps = mix.steps
        self.schedule_digest = mix.lane_digests[lane]
        self.tag = mix.tag + ("lane", lane)

    def at_step(self, t):
        return self._mix.bind(self._lane, t)


class SeedHaloMix:
    """Per-SEED halo mixer for the seed-batched engine on a 2-D
    ``('seed', 'agent')`` mesh: one seed- (and, for schedule stacks,
    time-) constant exchange plan over the UNION support across every
    seed's mixing matrices, with per-seed coefficient blocks.

    Lane i runs on its seed shard r = ``seed_sharding(mesh,
    n_seeds).owner(i)`` and exchanges over the agent devices of mesh row
    r, where its blocks live. Engine protocol (``seed_batched = True``):
    ``engine.seeds`` calls ``bind(lane, state.step)`` in each lane's
    lockstep meta-step; ``lane(i)`` is the same binding as a single-seed
    mixer, for the lane's sequential run.

    ``S_stack``: (n_seeds, n, n) static per-seed matrices, or
    (n_seeds, T, n, n) per-seed schedule stacks (``scheduled = True``;
    ``bind`` selects step t mod T). Seeds of a scenario share a base
    graph and perturbations never ADD edges, so the union across seeds
    and steps keeps a banded base's savings."""

    seed_batched = True

    def __init__(self, mesh, axis, S_stack, *, tag=None, resident="dense"):
        # remember WHICH object the blocks were built from: the engine's
        # content-digest guard short-circuits on identity
        try:
            self._src_ref = weakref.ref(S_stack)
        except TypeError:
            self._src_ref = None
        S_stack = _np32(S_stack)
        if S_stack.ndim == 3:
            scheduled = False
            n_seeds, n, n2 = S_stack.shape
        elif S_stack.ndim == 4:
            scheduled = True
            n_seeds, T, n, n2 = S_stack.shape
        else:
            raise ValueError(
                "SeedHaloMix: S_stack must be (n_seeds, n, n) or "
                f"(n_seeds, T, n, n), got shape {tuple(S_stack.shape)}")
        if n2 != n:
            raise ValueError(f"SeedHaloMix: mixing matrices must be "
                             f"square, got {(n, n2)}")
        nshards = int(mesh.shape[axis])
        flat = S_stack.reshape(-1, n, n)
        union = (flat != 0.0).any(axis=0).astype(np.float32)
        _, plans_u = halo_plan(union, nshards)
        nl = n // nshards
        blocks = (flat.reshape(-1, nshards, nl, nshards, nl)
                  .transpose(0, 1, 3, 2, 4))    # (B, a, b, nl, nl)
        a = np.arange(nshards)
        lead = (n_seeds, T) if scheduled else (n_seeds,)
        S0 = blocks[:, a, a]                    # (B, nshards, nl, nl)
        plans = []
        for delta, rows, _ in plans_u:
            blk = blocks[:, a, (a + delta) % nshards]
            plans.append((delta, rows,
                          np.ascontiguousarray(blk[:, :, :, rows])))
        S0 = S0.reshape(lead + S0.shape[1:])
        plans = [(d, rows, Sd.reshape(lead + Sd.shape[1:]))
                 for d, rows, Sd in plans]
        self.plan = (S0, plans)
        self.scheduled = scheduled
        self.steps = T if scheduled else None
        self.n_seeds = n_seeds
        # each lane's blocks and filter on the agent devices of its row
        seeds = seed_sharding(mesh, n_seeds)
        row_of = "seed" in mesh.axis_names
        rows_u = [rows for _, rows, _ in plans]
        perms = _offset_perms(plans, nshards)
        shard_ax = 1 if scheduled else 0
        self._filters, self._lanes = {}, []
        for i in range(n_seeds):
            r = seeds.owner(i, n_seeds)
            devices = agent_sharding(
                mesh, n, axis, **({"seed": r} if row_of else {})).devices
            if r not in self._filters:
                self._filters[r] = _halo_filter(devices, rows_u, perms,
                                                resident)
            self._lanes.append(
                (r, _on_devices(S0[i], devices, shard_ax),
                 [_on_devices(Sd[i], devices, shard_ax)
                  for _, _, Sd in plans]))
        self.stack_digest = _digest(S_stack)
        self.lane_digests = [_digest(s) for s in S_stack]
        if tag is None:
            kind = ("halo-seeds" if resident == "dense"
                    else "halo-seeds-pallas")
            tag = (kind, axis, n, n_seeds, T if scheduled else 0, nshards,
                   self.stack_digest, mesh_fingerprint(mesh))
        self.tag = tag

    def bind(self, lane, t):
        """The graph filter of seed lane ``lane`` at meta-step ``t``
        (schedule stacks select step t mod T; static ones ignore t)."""
        r, S0s, Sds = self._lanes[lane]
        if self.scheduled:
            ti = int(t) % self.steps
            S0s = [x[ti] for x in S0s]
            Sds = [[x[ti] for x in Sd] for Sd in Sds]
        filt = self._filters[r]
        return lambda W, h: filt(W, h, S0s, Sds)

    def lane(self, i):
        """Lane ``i`` as a single-seed mixer: a scheduled mixer
        (``at_step``) for schedule stacks, else a static ``mix_fn(W, h)``;
        tagged apart from the whole stack's mixer."""
        if self.scheduled:
            return _LaneMix(self, i)
        mix_fn = self.bind(i, 0)
        mix_fn.tag = self.tag + ("lane", i)
        return mix_fn


def make_seed_halo_mix(mesh, axis: str, S_stack, *, tag=None,
                       resident="dense"):
    """The per-seed halo mixer for ``train_surf(seeds=...)`` /
    ``engine.seeds.train_scan_seeds`` on a 2-D ('seed', 'agent') mesh.
    ``S_stack``: the per-seed (n_seeds, n, n) static stack or
    (n_seeds, T, n, n) schedule stack the engine trains with (also a
    list of per-seed ``TopologySchedule``s). ``resident="pallas"`` runs
    each lane's on-shard block through the kernel."""
    if isinstance(S_stack, (list, tuple)):
        S_stack = np.stack([_np32(s.S if hasattr(s, "S") else s)
                            for s in S_stack])
    return SeedHaloMix(mesh, axis, S_stack, tag=tag, resident=resident)
