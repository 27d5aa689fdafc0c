"""Time-varying mixing-matrix schedules: the port of
``repro.topology.schedule``.

A ``TopologySchedule`` is a stacked ``(T, n, n)`` f32 tensor of mixing
matrices on an explicit device, plus a hashable ``tag``. The training
drivers (``engine.scan.train_scan`` / ``train``) accept a schedule
wherever they accept a static S: they move the stack to the run's device
once and meta-step ``t`` mixes with ``S[state.step % T]`` in every
unrolled layer — the carried step, so a run resumed from a
``TrainState`` continues at the right S_t.

Builders (all deterministic under ``seed``: numpy ``default_rng``, so
every stack is bit-equal to the reference's; per-step matrices are
rebuilt with the chosen weight rule, so every S_t stays symmetric and
doubly stochastic — an agent isolated by failures or dropout gets
self-weight 1 and holds its value):

  * ``static_schedule``       — a (1, n, n) constant (cycles to any T),
  * ``link_failure_schedule`` — each base edge drops i.i.d. per step
    with probability ``p_fail``,
  * ``markov_link_schedule``  — each edge is an independent up/down
    2-state Markov chain (``p_drop`` up→down, ``p_recover`` down→up),
  * ``dropout_schedule``      — ``n_drop`` agents lose all their links
    per step,
  * ``ring_to_random_anneal`` — Watts–Strogatz rewiring probability
    annealed 0 → ``beta_max`` over ``stages`` waypoints.

Builders take ``device=`` like every entry point of the port: None is
the CUDA card, and without one the caller passes ``device="cpu"``.
Schedules compose with the default mixer and any S-as-argument
(``takes_S``) mixer; a baked-S halo/ring mixer would ignore them, unless
it is a SCHEDULED halo mixer built from the same schedule
(``topology.halo.make_scheduled_halo_mix``), which the drivers re-bind
at every meta-step by the carried step.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.topology import families as F
from repro_torch.utils.device import resolve_device, to_tensor


class TopologySchedule(NamedTuple):
    """Stacked time-varying mixing matrices and a provenance tag.

    ``S``: (T, n, n) f32 tensor; ``tag``: hashable identity of the
    builder, its parameters and seed. ``cache_tag`` is the structural
    part (the stack's shape), as in the reference."""
    S: torch.Tensor
    tag: tuple

    @property
    def steps(self) -> int:
        return int(self.S.shape[0])

    @property
    def n_agents(self) -> int:
        return int(self.S.shape[1])

    @property
    def cache_tag(self) -> tuple:
        return ("schedule", tuple(int(d) for d in self.S.shape))


def _as_schedule(A_stack, tag, weights, device, **kw):
    S = weights_batch(A_stack, weights=weights, **kw)
    return TopologySchedule(
        S=torch.as_tensor(S, dtype=torch.float32,
                          device=resolve_device(device)), tag=tag)


def weights_batch(A_stack, weights="metropolis", **kw):
    """Apply a ``families.WEIGHT_RULES`` rule over a (T, n, n) adjacency
    batch (numpy, float64). Metropolis is vectorized (slice-exact against
    the per-step call); other rules loop over T."""
    A = np.asarray(A_stack, bool)
    T, n, _ = A.shape
    if weights == "metropolis" and not kw:
        deg = A.sum(-1)
        pair = np.maximum(deg[:, :, None], deg[:, None, :])
        W = np.where(A, 1.0 / (1.0 + pair), 0.0)
        idx = np.arange(n)
        W[:, idx, idx] = 0.0
        W[:, idx, idx] = 1.0 - W.sum(-1)
        return W
    rule = F.WEIGHT_RULES[weights]
    return np.stack([rule(A[t], **kw) for t in range(T)])


def static_schedule(S, tag=None, device=None):
    """Wrap a static (n, n) mixing matrix as a (1, n, n) schedule: it
    cycles (t % 1 == 0) to any number of meta-steps, so a static run
    through the schedule path equals the plain-S run bit for bit. A
    tensor S stays on its device unless ``device`` is given."""
    if isinstance(S, torch.Tensor) and device is None:
        dev = S.device
    else:
        dev = resolve_device(device)
    S = to_tensor(S, dev, torch.float32)
    if S.dim() != 2 or S.shape[0] != S.shape[1]:
        raise ValueError(f"expected a square (n, n) S, got "
                         f"{tuple(S.shape)}")
    return TopologySchedule(S=S[None],
                            tag=tag or ("static", int(S.shape[0])))


def link_failure_schedule(A, steps, p_fail=0.1, seed=0,
                          weights="metropolis", device=None):
    """i.i.d. link failures: every base edge of ``A`` is independently
    down with probability ``p_fail`` at each of ``steps`` meta-steps."""
    A = np.asarray(A, bool)
    n = len(A)
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, 1)
    up = (rng.random((steps, iu[0].size)) >= p_fail) & A[iu]
    At = np.zeros((steps, n, n), bool)
    At[:, iu[0], iu[1]] = up
    At |= At.transpose(0, 2, 1)
    tag = ("linkfail", n, int(steps), float(p_fail), int(seed), weights)
    return _as_schedule(At, tag, weights, device)


def markov_link_schedule(A, steps, p_drop=0.05, p_recover=0.5, seed=0,
                         weights="metropolis", device=None):
    """Markov link switching: each base edge is an independent 2-state
    chain, starting up, going down w.p. ``p_drop`` and recovering w.p.
    ``p_recover`` per meta-step (bursty outages, not i.i.d. flicker)."""
    A = np.asarray(A, bool)
    n = len(A)
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, 1)
    base = A[iu]
    state = base.copy()
    ups = np.empty((steps, base.size), bool)
    for t in range(steps):
        u = rng.random(base.size)
        state = np.where(state, u >= p_drop, u < p_recover) & base
        ups[t] = state
    At = np.zeros((steps, n, n), bool)
    At[:, iu[0], iu[1]] = ups
    At |= At.transpose(0, 2, 1)
    tag = ("markov", n, int(steps), float(p_drop), float(p_recover),
           int(seed), weights)
    return _as_schedule(At, tag, weights, device)


def dropout_schedule(A, steps, n_drop=1, seed=0, weights="metropolis",
                     device=None):
    """Agent dropout: at each meta-step ``n_drop`` agents (a fresh
    uniform draw per step) lose ALL their links — their mixing row
    becomes e_i (they hold their value) and their neighbours move the
    lost weight onto themselves."""
    A = np.asarray(A, bool)
    n = len(A)
    if not 0 <= n_drop < n:
        raise ValueError(f"n_drop must be in [0, {n}), got {n_drop}")
    rng = np.random.default_rng(seed)
    drop = np.zeros((steps, n), bool)
    for t in range(steps):
        drop[t, rng.choice(n, n_drop, replace=False)] = True
    At = A[None] & ~drop[:, :, None] & ~drop[:, None, :]
    tag = ("dropout", n, int(steps), int(n_drop), int(seed), weights)
    return _as_schedule(At, tag, weights, device)


def ring_to_random_anneal(n, steps, k=4, beta_max=1.0, stages=8, seed=0,
                          weights="metropolis", device=None):
    """Ring→random anneal: ``stages`` Watts–Strogatz graphs with rewiring
    probability annealed linearly 0 → ``beta_max``, each held for about
    steps/stages consecutive meta-steps. Stage 0 is the circulant ring;
    the last is (approximately) a random graph."""
    stages = max(1, min(int(stages), int(steps)))
    graphs = []
    for s in range(stages):
        beta = beta_max * (s / (stages - 1) if stages > 1 else 0.0)
        graphs.append(F.small_world_graph(n, k=k, beta=beta, seed=seed + s))
    reps = np.array_split(np.arange(steps), stages)
    At = np.concatenate([np.repeat(graphs[s][None], len(r), axis=0)
                         for s, r in enumerate(reps) if len(r)])
    tag = ("anneal", n, int(steps), int(k), float(beta_max), stages,
           int(seed), weights)
    return _as_schedule(At, tag, weights, device)
