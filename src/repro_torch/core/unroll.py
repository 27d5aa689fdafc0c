"""U-DGD: DGD unrolled into GNN layers (paper §5, eq. U-DGD); the port of
``repro.core.unroll``.

One unrolled layer at agent i:
    w_{i,l} = [H_l(W_{l-1})]_i  −  σ( M_l [w_{i,l-1} ∥ b_{i,l}] + d_l )
where H_l is a K-tap graph filter  H(W) = Σ_{k≤K} h_{k,l} S^k W  and the
perceptron (M_l, d_l) is shared by all agents.

θ is a plain dict of stacked per-layer tensors {h (L,K+1), M (L,din,d),
d (L,d)}; the reference's ``lax.scan`` over layers is a Python loop.
Layer functions take any leading batch axes in front of the agent axis
(the serve path stacks requests there). Random draws come from an
explicit ``torch.Generator``; they cannot match JAX's threefry stream, so
``featurize_cohort`` also takes injected draws.

JAX-only: ``batch_vector`` (the reference's legacy flattening, kept
there for compatibility; the layers use the task's ``batch_vector``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SURFConfig
from repro_torch.core.tasks import resolve_task
# Σ_k h_k S^k W, chosen by device: the plain Horner filter for CPU
# tensors, the CUDA kernel (forward and backward) for CUDA tensors.
from repro_torch.kernels.graph_filter.ops import graph_filter
from repro_torch.utils.device import to_tensor

ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh}

# The mixer names. The DENSE ones select the default mixer
# (``mix_fn=None``): "dense" is the reference's name for its plain filter,
# "pallas" for its kernel and "cuda" the port's, and on the card all of
# them launch the kernel. The server takes these only. The halo names
# build a baked-S exchange over a mesh's agent axis (``core.surf.
# _resolve_mix``): "ring" (``core.ring``), "halo" and "halo-pallas"
# (``topology.halo``, the latter with each shard's on-shard block
# through the kernel).
DENSE_MIXES = (None, "dense", "pallas", "cuda")
MIXES = DENSE_MIXES + ("ring", "halo", "halo-pallas")


def _mix(mix_fn, S, W, h):
    """Apply the layer's graph filter through the mixer protocol:

      * ``mix_fn is None`` — ``graph_filter``
        (``kernels.graph_filter.ops``): the CUDA kernel on CUDA tensors,
        the plain Horner filter on CPU tensors;
      * ``mix_fn.takes_S`` — ``mix_fn(S, W, h)``: an S-as-argument filter,
        such as ``kernels.graph_filter.make_plain_mix``, the plain filter
        the kernel path is held against;
      * otherwise — ``mix_fn(W, h)``: a baked-S exchange (the ring / halo
        mixers of ``core.ring`` / ``topology.halo``), which ignores S."""
    if mix_fn is None:
        return graph_filter(S, W, h)
    if getattr(mix_fn, "takes_S", False):
        return mix_fn(S, W, h)
    return mix_fn(W, h)


def perceptron_in_dim(cfg: SURFConfig, task=None) -> int:
    task = resolve_task(cfg, task)
    return task.dim + cfg.batch_per_agent * task.batch_feat


def init_udgd(generator, cfg: SURFConfig, dtype=torch.float32, init="dgd",
              task=None):
    """Stacked per-layer parameters {h (L,K+1), M (L,din,d), d (L,d)},
    drawn from ``generator`` on its device.

    init='dgd' starts h at the DGD point (pure one-hop mixing h=[0,1,0..],
    M near zero); init='random' is the generic init."""
    task = resolve_task(cfg, task)
    L_, K = cfg.n_layers, cfg.filter_taps
    d = task.dim
    din = perceptron_in_dim(cfg, task)
    device = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    if init == "dgd":
        h0 = torch.zeros((L_, K + 1), device=device)
        h0[:, min(1, K)] = 1.0
        h = h0 + 0.01 * normal(L_, K + 1)
        M = 0.01 * normal(L_, din, d) * (din ** -0.5)
    elif init == "random":
        h = 0.5 * normal(L_, K + 1)
        M = normal(L_, din, d) * (din ** -0.5)
    else:
        raise ValueError(f"init must be 'dgd' or 'random', got {init!r}")
    dd = torch.zeros((L_, d), device=device)
    return {k: v.to(dtype) for k, v in (("h", h), ("M", M), ("d", dd))}


def _mix_and_update(params_l, S, W, Xb, Yb, cfg, activation, mix_fn,
                    task):
    """(H_l(W), σ(M_l [w_i ∥ b_i] + d_l)) of one layer."""
    task = resolve_task(cfg, task)
    mixed = _mix(mix_fn, S, W, params_l["h"])
    b_in = task.batch_vector(Xb, Yb)
    z = torch.cat([W, b_in], dim=-1) @ params_l["M"] + params_l["d"]
    return mixed, ACTIVATIONS[activation](z)


def udgd_layer(params_l, S, W, Xb, Yb, cfg: SURFConfig, activation="relu",
               mix_fn=None, task=None):
    """One unrolled layer. W (..., n, d); Xb (..., n, b, F); Yb (..., n, b);
    S (..., n, n). ``mix_fn`` replaces the dense filter (see ``_mix``)."""
    mixed, update = _mix_and_update(params_l, S, W, Xb, Yb, cfg, activation,
                                    mix_fn, task)
    return mixed - update


def star_filter_mask(cfg: SURFConfig, device=None):
    """§5.2: in classical FL the server (node 0) has no local data — its
    perceptron update is masked out; it only aggregates. (n, 1)."""
    mask = torch.ones((cfg.n_agents, 1), device=device)
    if cfg.topology == "star":
        mask[0, 0] = 0.0
    return mask


def udgd_layer_star(params_l, S, W, Xb, Yb, cfg: SURFConfig,
                    activation="relu", mix_fn=None, task=None):
    """Classical-FL layer: the server node only aggregates (no local
    update). Same mixer protocol as ``udgd_layer`` (see ``_mix``)."""
    mixed, update = _mix_and_update(params_l, S, W, Xb, Yb, cfg, activation,
                                    mix_fn, task)
    return mixed - star_filter_mask(cfg, W.device) * update


def layer_params(theta, l):
    """Layer ``l``'s slice of the stacked θ."""
    return {k: v[l] for k, v in theta.items()}


def unbind_layers(theta):
    """θ as a list of L per-layer dicts. One ``unbind`` per stacked
    tensor: its backward writes each layer's gradient into ONE stacked
    buffer, where L separate ``theta[k][l]`` selects would each add a
    zero-filled full-size gradient (L × 2.1 GB for M at PAPER width)."""
    keys = list(theta)
    return [dict(zip(keys, vals))
            for vals in zip(*(theta[k].unbind(0) for k in keys))]


def udgd_forward(params, S, W0, Xl, Yl, cfg: SURFConfig, activation="relu",
                 mix_fn=None, task=None):
    """Run L layers. Xl (L,n,b,F), Yl (L,n,b).
    Returns (W_L, W_all (L+1,n,d) including W0)."""
    task = resolve_task(cfg, task)
    Ws = [W0]
    for l in range(cfg.n_layers):
        Ws.append(udgd_layer(layer_params(params, l), S, Ws[-1], Xl[l],
                             Yl[l], cfg, activation, mix_fn=mix_fn,
                             task=task))
    return Ws[-1], torch.stack(Ws)


def probe_batch(batch, cfg: SURFConfig):
    """The held-aside convergence-probe batch: the first
    ``cfg.probe_size`` TRAINING rows per agent (capped at the split
    size). It draws nothing, so the per-layer mini-batch stack stays the
    one the fixed-depth path draws."""
    p = min(int(cfg.probe_size), int(batch["Xtr"].shape[1]))
    return batch["Xtr"][:, :p], batch["Ytr"][:, :p]


def udgd_forward_adaptive(params, S, W0, Xl, Yl, Xp, Yp, cfg: SURFConfig,
                          activation="relu", mix_fn=None, task=None,
                          layer_fn=None):
    """Convergence-adaptive forward: run the unrolled layers in order and
    stop once the probe-batch grad-norm ratio
    ‖∇f(W_l)‖/‖∇f(W_{l-1})‖ reaches 1 − ``cfg.exit_threshold`` (the layer bought less than an
    ``exit_threshold`` fractional descent: the descending-constraint
    certificate as a stopping rule) and at least ``cfg.min_layers``
    layers have run. The reference's ``lax.while_loop`` is a Python loop
    over l < L that reads the exit decision on the host after each layer.

    Xl/Yl are the SAME pre-sampled (L, n, b) stacks ``udgd_forward``
    consumes, and (Xp, Yp) the probe split (``probe_batch``). With
    ``exit_threshold == 0`` the exit is off: the loop makes the calls
    ``udgd_forward`` makes, in its order, and computes no probe norms, so
    W_L is bit-equal to its W_L on one device.

    Returns ``(W_L, depth)``: the final iterate and the number of layers
    run (an int, L when no certificate fired)."""
    task = resolve_task(cfg, task)
    if layer_fn is None:
        layer_fn = (udgd_layer_star if cfg.topology == "star"
                    else udgd_layer)
    thr = float(cfg.exit_threshold)
    min_l = int(cfg.min_layers)
    adaptive = thr > 0.0
    W = W0
    g_prev = task.grad_norm(W0, Xp, Yp) if adaptive else None
    for l in range(cfg.n_layers):
        W = layer_fn(layer_params(params, l), S, W, Xl[l], Yl[l], cfg,
                     activation, mix_fn=mix_fn, task=task)
        if adaptive:
            g = task.grad_norm(W, Xp, Yp)
            ratio = g / g_prev.clamp(min=1e-12)
            if l + 1 >= min_l and bool(ratio >= 1.0 - thr):
                return W, l + 1
            g_prev = g
    return W, cfg.n_layers


# Seeding scheme of the port's generators (JAX's threefry keys have no
# torch counterpart; each ``fold_in`` of the reference becomes a
# generator with a seed of its own):
#
#   * train_surf(seed): ``seeded_generator(seed)`` draws θ in
#     ``init_state`` (the reference's ``PRNGKey(seed)`` for ``init_udgd``);
#   * meta-step t of a run with seed ``seed``: ``step_generator`` =
#     2**63 + seed · 1_000_003 + t (the reference's
#     ``fold_in(PRNGKey(seed), t)``, ``engine/scan.py``);
#   * solve of dataset q under evaluation seed ``seed``:
#     ``solve_generator`` = (1000 + seed) · 1_000_003 + q (the
#     reference's ``fold_in(PRNGKey(1000 + seed), q)``);
#   * async-study solve of dataset q under evaluation seed ``seed``
#     (``core.surf.evaluate_async``): ``async_generator`` =
#     (2000 + seed) · 1_000_003 + q (the reference's
#     ``fold_in(PRNGKey(2000 + seed), q)``, ``_eval_keys`` in
#     ``core/surf.py``);
#   * the in-loop snapshot after meta-step t of a run with seed ``seed``,
#     on eval dataset q (``engine.snapshots``): ``snapshot_generator`` =
#     2**62 + (seed · 1_000_003 + t) · 1_000_003 + q (the reference's
#     ``fold_in(fold_in(fold_in(PRNGKey(seed), SNAP), t), q)``);
#   * the RSDUN perturbations of meta-step t (a robust config,
#     ``engine.core``): ``robust_generator`` = 3 · 2**62 + seed ·
#     1_000_003 + t. The reference splits them off the step key, so its
#     robust runs draw other W0 and mini-batches than its nominal ones;
#     here the step stream is untouched by the robust option.
#
# The streams hold disjoint quarters of the 64-bit seed space: solve and
# async seeds below 2**62 (seeds below 4.6·10^12, q below 1_000_003),
# snapshot seeds in [2**62, 2**63) (seeds below 4.6·10^6, t and q below
# 1_000_003), step seeds in [2**63, 3 · 2**62) and robust seeds above
# (seeds below 4.6·10^12, t below 1_000_003). So no two kinds of draw
# ever share a stream. The async stream is the solve stream shifted by
# 1000 seeds, exactly as in the reference: ``async_generator(seed, q)``
# draws what ``solve_generator(seed + 1000, q)`` draws, and no other
# solve seed meets it.
STEP_SEED_BASE = 2 ** 63
SNAPSHOT_SEED_BASE = 2 ** 62
ROBUST_SEED_BASE = 3 * 2 ** 62


def seeded_generator(seed, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (θ's init draws
    come from ``seeded_generator(seed)``)."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def step_generator(seed, t, device) -> torch.Generator:
    """The generator meta-step ``t`` of a training run with seed ``seed``
    draws its W0 and layer mini-batches from, on ``device`` (see the
    seeding scheme above)."""
    return seeded_generator(
        STEP_SEED_BASE + int(seed) * 1_000_003 + int(t), device)


def solve_generator(seed, q, device) -> torch.Generator:
    """The generator one solve of dataset ``q`` under evaluation seed
    ``seed`` draws from (see the seeding scheme above);
    ``evaluate_surf``, ``solve_federation`` and ``FederationServer.submit``
    all use it, so a served request and its single-cohort solve on one
    device see the same draws."""
    return seeded_generator((1000 + int(seed)) * 1_000_003 + int(q),
                            device)


def async_generator(seed, q, device) -> torch.Generator:
    """The generator the async study's solve of dataset ``q`` under
    evaluation seed ``seed`` draws from (``core.surf.evaluate_async``;
    see the seeding scheme above: the stream of
    ``solve_generator(seed + 1000, q)``)."""
    return seeded_generator((2000 + int(seed)) * 1_000_003 + int(q),
                            device)


def snapshot_generator(seed, t, q, device) -> torch.Generator:
    """The generator the in-loop snapshot after meta-step ``t`` (the
    carried step) of a run with seed ``seed`` draws from for eval dataset
    ``q`` (see the seeding scheme above)."""
    return seeded_generator(
        SNAPSHOT_SEED_BASE + (int(seed) * 1_000_003 + int(t)) * 1_000_003
        + int(q), device)


def robust_generator(seed, t, device) -> torch.Generator:
    """The generator meta-step ``t`` of a robust run with seed ``seed``
    draws its RSDUN perturbations from (see the seeding scheme above)."""
    return seeded_generator(
        ROBUST_SEED_BASE + int(seed) * 1_000_003 + int(t), device)


def sample_deltas(generator, cfg: SURFConfig, task=None, deltas=None,
                  device=None):
    """The RSDUN perturbations δ ~ N(0, I) of one meta-step, shape
    (robust_samples, L+1, n, d), drawn from ``generator`` on its device;
    ``deltas`` (numpy or a tensor of that shape) replaces the draw."""
    shape = (cfg.robust_samples, cfg.n_layers + 1, cfg.n_agents,
             resolve_task(cfg, task).dim)
    if deltas is not None:
        deltas = to_tensor(deltas, device, torch.float32)
        if tuple(deltas.shape) != shape:
            raise ValueError(f"deltas must have shape {shape}, got "
                             f"{tuple(deltas.shape)}")
        return deltas
    if generator is None:
        raise ValueError("a robust meta-step needs delta_generator= "
                         "(unroll.robust_generator) or deltas=")
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device)


def sample_w0(generator, cfg: SURFConfig, task=None):
    return resolve_task(cfg, task).init_state(generator, cfg)


def sample_layer_batches(generator, Xtr, Ytr, cfg: SURFConfig):
    """Stochastic unrolling: one independent uniform mini-batch per layer
    per agent. Xtr (n, m, F), Ytr (n, m) -> (L, n, b, F), (L, n, b)."""
    L_, n, b = cfg.n_layers, cfg.n_agents, cfg.batch_per_agent
    m = Xtr.shape[1]
    idx = torch.randint(0, m, (L_, n, b), generator=generator,
                        device=generator.device).to(Xtr.device)
    rows = torch.arange(n, device=Xtr.device)[None, :, None]
    return Xtr[rows, idx], Ytr[rows, idx]


def featurize_cohort(generator, batch, cfg: SURFConfig, task=None,
                     draws=None):
    """The stochastic featurization ONE solve of a cohort consumes:
    W0 ~ N(μ0, σ0²I) and the L per-layer per-agent mini-batches from the
    cohort's training split, drawn in that order from ``generator``.
    Returns (W0 (n,d), Xl (L,n,b,F), Yl (L,n,b)) on the batch's device.

    ``draws=(W0, Xl, Yl)`` (numpy or tensors) replaces the random draws;
    the parity tests feed both packages the reference's draws so."""
    task = resolve_task(cfg, task)
    dev = batch["Xtr"].device
    if draws is not None:
        W0, Xl, Yl = draws
        return (to_tensor(W0, dev, torch.float32),
                to_tensor(Xl, dev, torch.float32),
                to_tensor(Yl, dev, task.label_dtype))
    W0 = sample_w0(generator, cfg, task=task).to(dev)
    Xl, Yl = sample_layer_batches(generator, batch["Xtr"], batch["Ytr"], cfg)
    return W0, Xl, Yl
