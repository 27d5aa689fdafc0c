"""Cost counts of one step, the role of the reference's HLO cost model
(``repro.launch.hlo_cost``), for a port that has no HLO.

The reference parses the post-SPMD HLO of a compiled step, loop trip
counts included. The port runs the step itself once on the ``meta``
device (shapes only, nothing allocated or computed) under a
``TorchDispatchMode`` that sees every aten op, forward, backward and
remat's recompute alike, and counts:

  * FLOPs: matmul-like ops (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    ``convolution``) as 2·M·N·K (``matmul_flops``, the number the
    reference's ``dot`` FLOPs compare with), and every other computing op
    as one FLOP per output element, as ``hlo_cost`` counts elementwise
    ops. The dry run builds the LLM steps with ``plain_kernels=True``:
    attention is the plain softmax (``sdpa``) and the wkv recurrence
    ``wkv_ref``, which is also what the reference's XLA counts (its models
    differentiate plain ``sdpa``). The flash and wkv wrappers refuse a
    ``meta`` tensor; the graph filter's takes its plain version there.
    A hand-written kernel's launch is a ctypes call that no dispatch mode
    sees, so the count never runs one.
  * bytes: each op's tensor inputs and outputs, unfused. That is what
    eager PyTorch moves between ops; it is not XLA's fused count (fusion
    keeps a fused op's intermediates on chip), so it is the larger.
    View ops (reshapes, transposes, slices, expands) move nothing.
  * live bytes: each new storage an op creates adds its bytes while a
    tensor on it lives (autograd's saved tensors included: they are held
    until the backward frees them); the peak stands in for XLA's
    ``temp_size``. Inputs made before the count (the step's arguments)
    are not counted here.

Time loops (the plain wkv recurrence, Mamba's chunked scan) run one step
on ``meta`` and count it T times, forward and backward, as the HLO model
multiplies a while body by its trip count (``scans_by_trip_count``):
stepping 32,768 positions one by one would take minutes on ``meta``.

Collective bytes are not seen by a one-process count. ``summarize`` takes
them from the caller (``launch.dryrun`` derives them from the partition
specs), with the ring multipliers of the reference: all-gather ≈
result·(n−1)/n, reduce-scatter ≈ operand·(n−1)/n, all-reduce ≈
2·operand·(n−1)/n.

JAX-only, the reference's HLO text parser and its tables:
``parse_module``, ``analyze``, ``Computation``, ``Op``, ``COLLECTIVES``,
``ELEMENTWISE``, ``ZERO_COST`` and ``DTYPE_BYTES`` (the dispatch-mode
count above replaces them).
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

MATMUL = {aten.mm.default, aten.mm.dtype, aten.addmm.default,
          aten.bmm.default, aten.baddbmm.default}
CONV = {aten.convolution.default}
# Ops that allocate or describe without computing: no FLOPs, no bytes.
NO_COST = {aten.empty.memory_format, aten.empty_strided.default,
           aten.empty_like.default, aten.new_empty.default,
           aten.new_empty_strided.default, aten.lift_fresh.default,
           aten.detach.default, aten.alias.default,
           aten._local_scalar_dense.default}


def leaves(tree):
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from leaves(t)


def nbytes(t):
    return t.numel() * t.element_size()


def tree_bytes(tree) -> float:
    """The bytes of every tensor of a tree."""
    return float(sum(nbytes(t) for t in leaves(tree)))


def storage_key(t):
    return t.untyped_storage()._cdata


def _matmul_flops(func, args, out):
    if func in (aten.mm.default, aten.mm.dtype, aten.bmm.default):
        a = args[0]
    else:                               # addmm / baddbmm: (bias, a, b)
        a = args[1]
    return 2.0 * out.numel() * a.shape[-1]


def _conv_flops(args, out):
    w = args[1]                          # (C_out, C_in / groups, *kernel)
    per_out = 1
    for d in w.shape[1:]:
        per_out *= d
    return 2.0 * out.numel() * per_out


@dataclass
class Cost:
    """What one counted step did (global, not per device)."""
    flops: float = 0.0
    matmul_flops: float = 0.0
    bytes: float = 0.0
    peak_live_bytes: float = 0.0
    ops: int = 0


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes and live bytes of the aten ops it sees.
    ``scale`` multiplies what is counted (a time loop's trip count)."""

    def __init__(self, external=()):
        super().__init__()
        self.cost = Cost()
        self.scale = [1.0]
        self._live = {}                  # storage key -> [bytes, tensors]
        self._now = 0.0
        self._external = {storage_key(t) for t in external}

    def _release(self, key):
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._now -= entry[0]
            del self._live[key]

    def _track(self, t):
        key = storage_key(t)
        if key in self._external:
            return
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self._now += entry[0]
            self.cost.peak_live_bytes = max(self.cost.peak_live_bytes,
                                            self._now)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(leaves(out))
        for t in outs:
            self._track(t)
        if func in NO_COST or getattr(func, "is_view", False):
            return out
        m = self.scale[-1]
        c = self.cost
        c.ops += 1
        if func in MATMUL:
            f = _matmul_flops(func, args, outs[0])
            c.matmul_flops += m * f
        elif func in CONV:
            f = _conv_flops(args, outs[0])
            c.matmul_flops += m * f
        else:
            f = float(sum(t.numel() for t in outs))
        c.flops += m * f
        moved = sum(nbytes(t) for t in leaves((args, kwargs)))
        moved += sum(nbytes(t) for t in outs)
        c.bytes += m * moved
        return out


_ACTIVE: list[CostMode] = []


@contextlib.contextmanager
def trips(n):
    """Count what runs inside ``n`` times (a loop body standing for its
    trip count)."""
    mode = _ACTIVE[-1] if _ACTIVE else None
    if mode is not None:
        mode.scale.append(mode.scale[-1] * n)
    try:
        yield
    finally:
        if mode is not None:
            mode.scale.pop()


class _OneStep(torch.autograd.Function):
    """One step of a time loop, counted T times forward and, in its
    backward, T times again (the step's vjp through the graph its forward
    recorded). Returns the step's outputs; the caller expands them over
    T."""

    @staticmethod
    def forward(ctx, T, step, *inputs):
        ctx.T = T
        ctx.inputs = [x.detach().requires_grad_(x.is_floating_point())
                      for x in inputs]
        # the step's own graph keeps its tensors (a remat region's hooks
        # would recompute the whole region inside this backward)
        with torch.enable_grad(), trips(T), \
                torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                         lambda t: t):
            ctx.outs = tuple(step(*ctx.inputs))
        return tuple(o.detach() for o in ctx.outs)

    @staticmethod
    def backward(ctx, *gouts):
        want = [x for x in ctx.inputs if x.requires_grad]
        pairs = [(o, g) for o, g in zip(ctx.outs, gouts)
                 if g is not None and o.requires_grad]
        with trips(ctx.T):
            grads = torch.autograd.grad(
                [o for o, _ in pairs], want, [g for _, g in pairs],
                allow_unused=True) if pairs else [None] * len(want)
        it = iter(grads)
        out = [next(it) if x.requires_grad else None for x in ctx.inputs]
        del ctx.inputs, ctx.outs
        return (None, None, *out)


def _one_step(T, step, *inputs):
    return _OneStep.apply(T, step, *inputs)


def _meta_wkv(r, k, v, w, u, S0=None):
    """The wkv recurrence (``ssm_scan.ref.wkv_ref``) on ``meta``: one step
    counted T times; y (B,H,T,dk) in r's dtype, S (B,H,dk,dk) f32."""
    B, H, T, dk = r.shape
    S = (torch.zeros((B, H, dk, dk), dtype=torch.float32, device=r.device)
         if S0 is None else S0)

    def step(rt, kt, vt, wt, u, S):
        rt, kt, vt, wt = (a.to(torch.float32) for a in (rt, kt, vt, wt))
        kv = kt[..., :, None] * vt[..., None, :]
        y = torch.einsum("bhk,bhkv->bhv", rt,
                         S + u.to(torch.float32)[..., :, None] * kv)
        return y, wt[..., :, None] * S + kv

    y, S = _one_step(T, step, *(a[:, :, 0] for a in (r, k, v, w)), u, S)
    return y[:, :, None].expand(B, H, T, dk).contiguous().to(r.dtype), S


def _meta_time_scan(step, state, xs, chunk=128):
    """``ssm.chunked_time_scan`` on ``meta``: one step counted T times;
    the stacked outputs are written once, as the loop's ``torch.stack``
    writes them. Parameters the step closes over get no gradient through
    the scan (a few elementwise products per step)."""
    T = xs[0].shape[0]
    state, y = _one_step(T, lambda s, *x: step(s, x), state,
                         *(a[0] for a in xs))
    return state, y[None].expand((T,) + tuple(y.shape)).contiguous()


@contextlib.contextmanager
def scans_by_trip_count():
    """Within: the model's time loops count one step T times (on
    ``meta`` only)."""
    from repro_torch.models import ssm
    with mock.patch.object(ssm, "chunked_time_scan", _meta_time_scan), \
            mock.patch.object(ssm, "wkv_ref", _meta_wkv):
        yield


def count(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once (on ``meta`` tensors) and return
    (its result, the ``Cost``). The tensors among the arguments are the
    step's inputs: not counted as live bytes."""
    mode = CostMode(external=list(leaves((args, kwargs))))
    # autograd holds each saved tensor's Python object until the backward
    # frees it, so its bytes stay live as long as on a card
    hooks = torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                     lambda t: t)
    with mode, hooks, scans_by_trip_count():
        _ACTIVE.append(mode)
        try:
            out = fn(*args, **kwargs)
        finally:
            _ACTIVE.pop()
    return out, mode.cost


def ring(n):
    """The ring multiplier (n − 1) / n of a collective over n devices."""
    return (n - 1) / n if n > 1 else 0.0


def summarize(cost: Cost, chips=1, collectives=None) -> dict:
    """Per-device numbers of one step, the reference's keys: the counted
    FLOPs and bytes split evenly over ``chips`` (the ideal SPMD split;
    work replicated across devices is not modelled), ``collectives`` the
    per-device bytes by kind as the caller derived them."""
    coll = dict(collectives or {})
    return {"flops": cost.flops / chips,
            "matmul_flops": cost.matmul_flops / chips,
            "bytes": cost.bytes / chips,
            "collective_bytes": float(sum(coll.values())),
            "collectives": coll}
