"""Production-mesh dry run: describe every (arch × input-shape) step on the
reference's meshes (16×16 = 256 chips; 2×16×16 = 512) and record its
memory, cost, collectives and roofline per device: the port of
``repro.launch.dryrun``.

The reference lowers and compiles each step for 512 simulated XLA
devices and reads the compiled module. The port has no compiler to ask:
it builds the step's arguments on the ``meta`` device (shapes and dtypes,
nothing allocated), places them by the partition rules
(``sharding.rules``) on a ``meta`` mesh (``make_production_mesh``, its
``simulated`` flag set), runs the step once on ``meta`` under the cost
counter (``launch.hlo_cost``) and derives per-device numbers:

  * memory: argument and output bytes per device, exact from the specs;
    the peak as arguments plus the counted peak of live bytes split
    evenly over the devices. The reference's fields beside it:
    ``alias_bytes`` the outputs that share storage with an argument (the
    train step's donated parameters and Adam state, updated in place),
    ``temp_bytes`` the counted peak less the outputs that do not (those
    are live at the step's end, so within the peak), so that
    ``per_device_total`` is the reference's argument + temp + output −
    alias, a donated tree counted once;
  * cost: FLOPs and bytes, counted globally and split evenly (work the
    partitioner would replicate is not modelled);
  * collectives: the FSDP all-gathers of data-sharded weights (forward,
    and again in the backward under remat, per microbatch), the
    reduce-scatter of their gradients per microbatch and the all-reduce
    of the gradients of weights replicated over the data axes, with the
    reference's ring multipliers. Activation collectives of model-sharded
    products and MoE all-to-alls are not modelled (the record says so);
  * the roofline on the H100's data-sheet peaks (``launch.roofline``).

A train step with gradient accumulation counts one microbatch's loss and
gradients and multiplies them by the microbatch count, as the HLO model
multiplies a scan body by its trip count. The port's prefill computes
only the last position's logits (``steps.make_prefill_step``); the
reference's computes all of them, 2·B·(S−1)·d·V more matmul FLOPs,
which the record states as ``reference_logits_flops``.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multipod]
      [--jobs 8]
  python -m repro_torch.launch.dryrun --surf [--surf-ring|--surf-infer]
Outputs one JSON per combo under build/dryrun_torch/ (gitignored).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from unittest import mock

from repro_torch import flags
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.launch import hlo_cost
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import compute_roofline
from repro_torch.launch.specs import shape_supported
from repro_torch.sharding.rules import (PartitionSpec, axis_size, data_axes,
                                        shard_factor)

OUT_DIR = os.path.join("build", "dryrun_torch")
NOT_MODELLED = ("activation collectives of model-sharded products "
                "(tensor-parallel all-reduces and all-gathers) and MoE "
                "all-to-alls")


def _leaves_with_specs(tree, specs):
    """(leaf, spec) pairs; a spec where the tree goes on covers every
    leaf below it."""
    if isinstance(specs, PartitionSpec):
        return [(t, specs) for t in hlo_cost.leaves(tree)]
    if isinstance(tree, dict):
        return [p for k in tree for p in _leaves_with_specs(tree[k],
                                                            specs[k])]
    if isinstance(tree, (list, tuple)):
        return [p for t, s in zip(tree, specs)
                for p in _leaves_with_specs(t, s)]
    return []


def per_device_bytes(tree, specs, mesh) -> float:
    """Bytes one device holds of ``tree`` placed by ``specs``."""
    return float(sum(hlo_cost.nbytes(t) / shard_factor(s, mesh)
                     for t, s in _leaves_with_specs(tree, specs)))


def weight_collectives(params, p_specs, mesh, mode, microbatches=1,
                       remat=True) -> dict:
    """Per-device collective bytes of one step's weights, by kind: the
    FSDP all-gathers of data-sharded weights (forward; again in the
    backward of a train step), the reduce-scatter of their gradients and
    the all-reduce of the gradients of data-replicated weights, per
    microbatch."""
    dp = data_axes(mesh)
    n_dp = axis_size(mesh, dp) if dp else 1
    coll = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    gathers = (2 if remat else 1) if mode == "train" else 1
    for t, spec in _leaves_with_specs(params, p_specs):
        data_split = [e for e in spec if isinstance(e, tuple)]
        n = axis_size(mesh, data_split[0]) if data_split else 1
        full = hlo_cost.nbytes(t) / (shard_factor(spec, mesh) / n)
        if n > 1:
            coll["all-gather"] += gathers * microbatches * full * \
                hlo_cost.ring(n)
            if mode == "train":
                coll["reduce-scatter"] += microbatches * full * \
                    hlo_cost.ring(n)
        elif mode == "train" and n_dp > 1:
            coll["all-reduce"] += microbatches * 2.0 * full * \
                hlo_cost.ring(n_dp)
    return {k: v for k, v in coll.items() if v}


def _one_microbatch(mb):
    """Within: ``steps.loss_and_grads`` runs once, counted ``mb`` times;
    later calls return its (shape-only) result. The ``mb``-th call hands
    it over and keeps no reference, so the step frees its gradients when
    it would on a card (a donated step leaf by leaf)."""
    real, first, calls = ST.loss_and_grads, [], [0]

    def once(*args, **kwargs):
        if not first:
            with hlo_cost.trips(mb):
                first.append(real(*args, **kwargs))
        calls[0] += 1
        return first.pop() if calls[0] >= mb else first[0]
    return mock.patch.object(ST, "loss_and_grads", once)


def aliased(out, args) -> list:
    """For each output leaf, in order, whether it shares storage with an
    argument: the donated trees a step updates in place."""
    keys = {hlo_cost.storage_key(t) for t in hlo_cost.leaves(args)}
    return [hlo_cost.storage_key(t) in keys for t in hlo_cost.leaves(out)]


def alias_bytes(out, out_specs, mask, mesh) -> float:
    """Bytes one device holds of the outputs ``mask`` (``aliased``) marks:
    XLA's ``alias_size``."""
    return float(sum(hlo_cost.nbytes(t) / shard_factor(s, mesh)
                     for (t, s), a in zip(_leaves_with_specs(out, out_specs),
                                          mask) if a))


def describe(cfg, shape, mesh, counts=None):
    """Count one (cfg × shape) step on ``mesh``; returns the record's
    measured fields (memory, cost, parsed, roofline, ...). ``counts``, a
    dict the caller keeps, shares a count between meshes: it is global,
    and depends on the mesh only through the microbatches and the weight
    placement."""
    step = ST.jitted_step(cfg, shape, mesh)
    key = (step.microbatches, step.weight_stationary)
    t0 = time.time()
    if counts is None or key not in counts:
        with _one_microbatch(step.microbatches):
            out, cost = hlo_cost.count(step.fn, *step.args)
        counted = (out, cost, aliased(out, step.args))
        if counts is not None:
            counts[key] = counted
    out, cost, mask = counted if counts is None else counts[key]
    count_s = time.time() - t0
    chips = mesh.size
    arg_b = per_device_bytes(step.args, step.in_specs, mesh)
    out_b = per_device_bytes(out, step.out_specs, mesh)
    alias_b = alias_bytes(out, step.out_specs, mask, mesh)
    peak_b = cost.peak_live_bytes / chips
    coll = weight_collectives(step.args[0], step.in_specs[0], mesh,
                              shape.mode, step.microbatches)
    parsed = hlo_cost.summarize(cost, chips, coll)
    rl = compute_roofline(parsed, cfg, shape, chips)
    rec = dict(
        count_s=round(count_s, 2), microbatches=step.microbatches,
        weight_stationary=step.weight_stationary,
        memory={"argument_bytes": arg_b, "output_bytes": out_b,
                "temp_bytes": peak_b - (out_b - alias_b),
                "alias_bytes": alias_b, "peak_live_bytes": peak_b,
                "per_device_total": arg_b + peak_b},
        cost={"flops": cost.flops, "matmul_flops": cost.matmul_flops,
              "bytes": cost.bytes, "peak_live_bytes": cost.peak_live_bytes,
              "aten_ops": cost.ops},
        parsed=parsed, roofline=rl.to_dict(),
        collectives_not_modelled=NOT_MODELLED)
    if shape.mode == "prefill":
        rec["reference_logits_flops"] = (2.0 * shape.global_batch
                                         * (shape.seq_len - 1)
                                         * cfg.d_model * cfg.vocab)
    return rec


def run_combo(arch: str, shape_name: str, multi_pod: bool, outdir: str,
              tag: str = "", lower_only: bool = False, counts=None):
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": mesh.size, "simulated": mesh.simulated,
           "device": "meta", "tag": tag}
    ok, reason = shape_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        _write(rec, outdir, tag)
        return rec
    try:
        if lower_only:
            t0 = time.time()
            ST.jitted_step(cfg, shape, mesh)
            rec.update(status="lowered", lower_s=round(time.time() - t0, 2))
        else:
            rec.update(status="ok", **describe(cfg, shape, mesh, counts),
                       params=cfg.param_count(),
                       params_active=cfg.param_count(active_only=True))
    except Exception as e:  # noqa: BLE001 — a failed description is the
        # result, as a failed lowering is the reference's
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    _write(rec, outdir, tag)
    return rec


def run_surf(multi_pod: bool, outdir: str, ring: bool = False,
             infer: bool = False, mix=None):
    """Dry run of SURF's own meta-training step with the agent axis
    sharded over the data axes (``launch.surf_dryrun``); ``mix`` as
    ``lower_surf_step``'s."""
    from repro_torch.launch.surf_dryrun import lower_surf_step
    rec = lower_surf_step(multi_pod=multi_pod, ring=ring, infer=infer,
                          mix=mix)
    _write(rec, outdir, rec.get("tag", ""))
    return rec


def run_grid(archs, shapes, multi_pods, outdir, tag="", lower_only=False,
             jobs=1):
    """``run_combo`` over every (arch, shape, multi_pod); with ``jobs`` > 1
    in that many worker processes, each taking one (arch, shape) on every
    mesh (the meshes share its count) under this process's flags. Returns
    the records, in that order."""
    pairs = [(a, s, tuple(multi_pods), outdir, tag, lower_only)
             for a in archs for s in shapes]
    if jobs <= 1:
        return [r for p in pairs for r in run_meshes(*p)]
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    kw = dataclasses.asdict(flags.get())
    with ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn")) as ex:
        return [r for recs in ex.map(_run_meshes_args, pairs,
                                     [kw] * len(pairs)) for r in recs]


def run_meshes(arch, shape_name, multi_pods, outdir, tag="",
               lower_only=False):
    """``run_combo`` of one (arch, shape) on each of ``multi_pods``, the
    meshes sharing the count where they can."""
    counts = {}
    return [run_combo(arch, shape_name, m, outdir, tag, lower_only, counts)
            for m in multi_pods]


def _run_meshes_args(args, flag_kw):
    flags.set_flags(**flag_kw)     # a spawned worker starts from defaults
    return run_meshes(*args)


def _write(rec, outdir, tag=""):
    os.makedirs(outdir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    if tag:
        name += f"__{tag}"
    with open(os.path.join(outdir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def _summary(rec):
    msg = {k: rec.get(k) for k in ("arch", "shape", "mesh", "status",
                                   "count_s")}
    if rec.get("status") == "ok":
        msg["dominant"] = rec["roofline"]["dominant"]
    if rec.get("status") == "error":
        msg["error"] = rec["error"]
    return msg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--surf", action="store_true")
    ap.add_argument("--surf-ring", action="store_true",
                    help="SURF dry run with the ring mixing")
    ap.add_argument("--surf-infer", action="store_true",
                    help="SURF dry run of the deployed (forward-only) "
                         "unrolled optimizer")
    ap.add_argument("--lower-only", action="store_true",
                    help="build each step's description without counting")
    ap.add_argument("--tag", default="")
    ap.add_argument("--opts", default="",
                    help="flags, e.g. blockwise_prefill,"
                         "serve_weight_stationary,microbatch_target=4")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the (arch x shape) grid")
    args = ap.parse_args(argv)
    saved = flags.get()
    try:
        if args.opts:
            flags.parse_opts(args.opts)
            if not args.tag:
                args.tag = args.opts.replace(",", "+").replace("=", "")
        if args.surf or args.surf_ring or args.surf_infer:
            rec = run_surf(args.multipod, args.out, ring=args.surf_ring,
                           infer=args.surf_infer)
            print(json.dumps(_summary(rec)), flush=True)
            return [rec]
        archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
        shapes = list(SHAPES) if args.shape == "all" else [args.shape]
        recs = run_grid(archs, shapes, [args.multipod], args.out, args.tag,
                        args.lower_only, args.jobs)
        for rec in recs:
            print(json.dumps(_summary(rec)), flush=True)
        return recs
    finally:
        flags.set_flags(**dataclasses.asdict(saved))


if __name__ == "__main__":
    main()
