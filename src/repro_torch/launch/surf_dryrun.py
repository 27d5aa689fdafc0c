"""Dry run of SURF's own meta-training step on the production mesh: the
port of ``repro.launch.surf_dryrun``.

The agent axis n (= 256, ``configs.surf_paper.DRYRUN``, a power-of-two
variant of the paper's n = 100) shards over the data axes; the unrolled
perceptron θ (Θ(d²) parameters) is replicated. The reference lowers the
step for the mesh and parses its HLO. The port runs the step once on
the ``meta`` device under ``launch.hlo_cost`` (FLOPs, bytes and live
bytes, split over the data axes that carry the agents: the 'model' axis
replicates the work) and takes the collective bytes from its own plans,
per meta-step:

  * dense mixing (``S @ W``, the graph filter): an all-gather of W over
    the agent axis per mixing round, (s − 1)/s · n · d · 4 bytes on s
    agent shards;
  * ring / halo: ``topology.halo.halo_exchange_rows(plan)`` boundary rows
    × d × 4 bytes per mixing round (the ring is the halo plan of its
    circulant matrix; a scheduled halo mixer's plan is the union over
    its steps, as it exchanges);
  * mixing rounds: K per layer forward, and K per layer but the first in
    the backward (dW of the first layer is not needed), so K (2L − 1) per
    training step and K L per deployed solve;
  * training also all-reduces θ's gradient over the agent shards,
    2 · (s − 1)/s · |θ| · 4 bytes;
  * a Q-sharded pool's select moves one dataset's bytes per step,
    whatever Q is (``q_scan_collective_bytes``).
"""
from __future__ import annotations

import time
import traceback

import numpy as np
import torch

from repro_torch.configs.surf_paper import DRYRUN
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import HBM_BW, NVLINK_BW, PEAK_FLOPS
from repro_torch.sharding.rules import axis_size, data_axes
from repro_torch.topology.halo import halo_exchange_rows

META = torch.device("meta")


def surf_batch_specs(cfg, task=None):
    """``meta`` tensors of one meta-training batch (the Xtr/Ytr/Xte/Yte
    dict every SURF description needs). ``task`` shapes the per-example
    feature dim and label dtype for non-default inner problems
    (``core.tasks``)."""
    from repro_torch.core.tasks import resolve_task
    task = resolve_task(cfg, task)
    n, m, t, F_ = (cfg.n_agents, cfg.train_per_agent, cfg.test_per_agent,
                   task.feat_dim)
    ldt = task.label_dtype
    return {
        "Xtr": torch.empty((n, m, F_), dtype=torch.float32, device=META),
        "Ytr": torch.empty((n, m), dtype=ldt, device=META),
        "Xte": torch.empty((n, t, F_), dtype=torch.float32, device=META),
        "Yte": torch.empty((n, t), dtype=ldt, device=META),
    }


def _draws(cfg, task=None):
    """``meta`` stand-ins of one solve's draws (W0, Xl, Yl)."""
    from repro_torch.core.tasks import resolve_task
    task = resolve_task(cfg, task)
    n, L, b = cfg.n_agents, cfg.n_layers, cfg.batch_per_agent
    return (torch.empty((n, task.dim), device=META),
            torch.empty((L, n, b, task.feat_dim), device=META),
            torch.empty((L, n, b), dtype=task.label_dtype, device=META))


def _theta_bytes(cfg, task=None):
    from repro_torch.engine.resume import state_template
    return hlo_cost.tree_bytes(state_template(cfg, task).theta)


def mixing_rounds(cfg, infer=False):
    """Graph-filter rounds (hops) per meta-step (or per deployed solve)."""
    K, L = cfg.filter_taps, cfg.n_layers
    return K * L if infer else K * (2 * L - 1)


def _mix_round_bytes(cfg, mix_fn, shards, task=None):
    """(kind, bytes per device per mixing round) of ``mix_fn``."""
    from repro_torch.core.tasks import resolve_task
    d = resolve_task(cfg, task).dim
    if mix_fn is None:
        return "all-gather", hlo_cost.ring(shards) * cfg.n_agents * d * 4.0
    return "collective-permute", (halo_exchange_rows(mix_fn.plan[1])
                                  * d * 4.0)


def meta_step_collective_bytes(cfg, S, mesh, mix_fn=None, infer=False):
    """Per-META-STEP collective bytes per device of the agent-sharded step
    on ``mesh`` (agents over its data axes, or its 'agent' axis):
    (total, per-kind dict). ``mix_fn`` None is dense mixing; a halo or
    ring mixer (``topology.halo``, ``core.ring``; scheduled ones too)
    contributes its plan's exchange rows. ``S`` is the static stand-in
    the reference's signature carries (not read)."""
    axes = data_axes(mesh) or ("agent",)
    s = axis_size(mesh, axes)
    kind, per_round = _mix_round_bytes(cfg, mix_fn, s)
    coll = {kind: mixing_rounds(cfg, infer) * per_round}
    if not infer:
        coll["all-reduce"] = 2.0 * hlo_cost.ring(s) * _theta_bytes(cfg)
    coll = {k: v for k, v in coll.items() if v}
    return float(sum(coll.values())), coll


def seed_meta_step_collective_bytes(cfg, S_stack, mesh, mix_fn=None):
    """Per-META-STEP collective bytes per device of the SEED-BATCHED step
    on a 2-D ('seed', 'agent') mesh: each device runs its seed shard's
    n_seeds / seed_shards lanes, and each lane mixes over the 'agent'
    axis (dense all-gather, or the seed halo mixer's union plan) and
    all-reduces its θ gradient over it. Returns (total, per-kind)."""
    n_seeds = int(np.asarray(S_stack.shape)[0])
    lanes = n_seeds // int(mesh.shape["seed"])
    s = int(mesh.shape["agent"])
    kind, per_round = _mix_round_bytes(cfg, mix_fn, s)
    coll = {kind: lanes * mixing_rounds(cfg) * per_round,
            "all-reduce": lanes * 2.0 * hlo_cost.ring(s) * _theta_bytes(cfg)}
    coll = {k: v for k, v in coll.items() if v}
    return float(sum(coll.values())), coll


def q_scan_collective_bytes(cfg, S, mesh, n_q, steps=4, eval_q=0,
                            q_sharded=True, naive_select=False):
    """Per-META-STEP select bytes per device of the Q-SHARDED scan engine
    (the meta-step's own collectives are ``meta_step_collective_bytes``'s):
    a Q-sharded pool's select copies one dataset per step from its owner
    (``sharding.surf_rules.make_q_select``), whatever Q is; a snapshot
    pool of ``eval_q`` datasets (every 2 steps) one eval dataset per
    snapshot; ``naive_select`` the counterfactual that gathers the whole
    sharded pool, (q − 1)/q · Q datasets per step; a replicated pool
    (``q_sharded=False``) moves nothing. ``steps`` and ``S`` are the
    reference's signature (the count is per step). Returns (bytes,
    per-kind)."""
    from repro_torch.sharding.surf_rules import q_select_axis
    one = hlo_cost.tree_bytes(surf_batch_specs(cfg))
    coll = {}
    axis = q_select_axis(mesh, int(n_q)) if q_sharded else None
    if axis is not None:
        if naive_select:
            q = int(mesh.shape[axis])
            coll["all-gather"] = hlo_cost.ring(q) * int(n_q) * one
        else:
            coll["select"] = one
    if eval_q and q_select_axis(mesh, int(eval_q)) is not None:
        coll["select"] = coll.get("select", 0.0) + one / 2
    return float(sum(coll.values())), coll


def _mixer(kind, mesh, cfg, A, S):
    if kind is None:
        return None
    if kind == "ring":
        from repro_torch.core.ring import make_ring_mix
        assert cfg.topology == "ring"
        return make_ring_mix(mesh, "data", cfg.n_agents,
                             max(1, cfg.degree // 2))
    if kind == "halo":
        from repro_torch.topology.halo import make_halo_mix
        return make_halo_mix(mesh, "data", S)
    if kind == "halo-sched":
        from repro_torch.topology.halo import make_scheduled_halo_mix
        from repro_torch.topology.schedule import link_failure_schedule
        sch = link_failure_schedule(A, 50, p_fail=0.2, seed=0,
                                    device="cpu")
        return make_scheduled_halo_mix(mesh, "data", sch)
    raise ValueError(f"mix must be None|'ring'|'halo'|'halo-sched', got "
                     f"{kind!r}")


def count_meta_step(cfg, S, mix_fn=None, infer=False):
    """Run one meta-training step of ``cfg`` (``infer``: the deployed
    unrolled solve, forward only) on the ``meta`` device under
    ``launch.hlo_cost``, through the default mixer (the graph filter's
    plain version on ``meta``) or ``mix_fn``. Returns (the ``Cost``,
    {"state", "batch", "draws"}: the step's ``meta`` inputs, global)."""
    from repro_torch.core import unroll as U
    from repro_torch.engine import make_meta_step
    from repro_torch.engine.resume import state_template
    S_m = torch.empty(tuple(np.shape(S)), device=META)
    inputs = {"state": state_template(cfg), "batch": surf_batch_specs(cfg),
              "draws": _draws(cfg)}
    if infer:
        def step_fn(state, batch, draws):
            mf = (mix_fn.at_step(state.step)
                  if getattr(mix_fn, "scheduled", False) else mix_fn)
            W0, Xl, Yl = draws
            W = W0
            for l, p_l in enumerate(U.unbind_layers(state.theta)):
                W = U.udgd_layer(p_l, S_m, W, Xl[l], Yl[l], cfg, mix_fn=mf)
            return state, torch.mean(W)
    else:
        meta_step, _ = make_meta_step(cfg, S_m, mix_fn=mix_fn)

        def step_fn(state, batch, draws):
            return meta_step(state, batch, draws=draws)
    _, cost = hlo_cost.count(step_fn, inputs["state"], inputs["batch"],
                             inputs["draws"])
    return cost, inputs


def lower_surf_step(multi_pod: bool = False, cfg=DRYRUN, ring: bool = False,
                    infer: bool = False, mix: str | None = None):
    """Describe one meta-training step (``infer=True``: the deployed
    unrolled optimizer, forward only) of ``cfg`` on the production mesh
    and return its record: memory, FLOPs and bytes (counted on ``meta``,
    ``count_meta_step``), collectives (from the plans), roofline. ``mix``:
    None (dense S @ W), "ring" (ring topologies only; ``ring=True`` is the
    legacy spelling), "halo" or "halo-sched" (a link-failure schedule over
    the config's graph through the scheduled halo mixer). Arguments per
    device: the state (replicated) and the batch and draws split over the
    agent shards."""
    from repro_torch.topology.families import build_topology
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    dp = data_axes(mesh)
    s = axis_size(mesh, dp)
    mix = mix or ("ring" if ring else None)
    rec = {"arch": "surf-udgd" + (f"-{mix}" if mix else ""),
           "shape": f"n{cfg.n_agents}_L{cfg.n_layers}"
                    + ("_infer" if infer else ""),
           "mesh": mesh_name, "chips": mesh.size,
           "simulated": mesh.simulated, "device": "meta", "tag": ""}
    try:
        A, S = build_topology(cfg.topology, cfg.n_agents,
                              degree=cfg.degree, seed=0)
        mix_fn = _mixer(mix, mesh, cfg, A, S)
        t0 = time.time()
        cost, inputs = count_meta_step(cfg, S, mix_fn, infer)
        count_s = time.time() - t0
        total, coll = meta_step_collective_bytes(cfg, S, mesh, mix_fn,
                                                 infer=infer)
        parsed = hlo_cost.summarize(cost, s, coll)
        st = inputs["state"]
        arg_b = (hlo_cost.tree_bytes([st.theta, st.lam, st.opt_state])
                 + hlo_cost.tree_bytes([inputs["batch"],
                                        inputs["draws"]]) / s)
        terms = (("compute_s", parsed["flops"] / PEAK_FLOPS),
                 ("memory_s", parsed["bytes"] / HBM_BW),
                 ("collective_s", parsed["collective_bytes"] / NVLINK_BW))
        rec.update(
            status="ok", count_s=round(count_s, 2),
            memory={"argument_bytes": arg_b,
                    "peak_live_bytes": cost.peak_live_bytes / s,
                    "per_device_total": arg_b + cost.peak_live_bytes / s},
            cost={"flops": cost.flops, "matmul_flops": cost.matmul_flops,
                  "bytes": cost.bytes,
                  "peak_live_bytes": cost.peak_live_bytes,
                  "aten_ops": cost.ops},
            parsed=parsed,
            roofline={k: v for k, v in terms} | {
                "dominant": max(terms, key=lambda kv: kv[1])[0][:-2]})
        if mix_fn is not None:
            rec["exchange_rows_per_round"] = halo_exchange_rows(
                mix_fn.plan[1])
    except Exception as e:  # noqa: BLE001 — a failed description is the
        # result, as a failed lowering is the reference's
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec
