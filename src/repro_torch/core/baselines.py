"""FL baselines the paper compares against (Fig. 5, App. D.2): the port
of ``repro.core.baselines``.

Decentralized: DGD (full-batch local gradient, eq. 10), DSGD (a
1-sample stochastic gradient), DFedAvgM (6 local momentum steps between
mixings, Sun et al. 2023). Classical/star: FedAvg, FedProx (proximal
local objective), SCAFFOLD (control variates).

All run the same inner ``Task`` as U-DGD (``task=``; None resolves the
config's task); every mixing with the graph (or server round trip)
counts as ONE communication round, so the x-axes match the paper's
figures. Each run returns numpy ``{"loss": (rounds,), "acc": (rounds,)}``
after every round; the "acc" slot carries ``task.fl_metric``.

The mixing is a plain ``S @ W`` (``torch.matmul``), as the reference
mixes outside its Pallas kernel: no baseline runs the graph-filter
kernel. The reference's ``lax.scan`` over rounds is a Python loop, and
its ``jax.random`` key becomes an explicit ``torch.Generator``. The
random draws are made before the first round, and ``draws=`` replaces
them (the tests replay the reference's draws, and ``chip_smoke.py``
hands one set of numpy draws to a card run and a CPU run):

  * DSGD: ``{"idx": (rounds, n, 1)}`` mini-batch row indices;
  * DFedAvgM: ``{"idx": (rounds, local_steps, n, batch_per_agent)}``;
  * FedAvg, FedProx, SCAFFOLD: ``{"sel": (rounds, participate)}``, the
    participating agents (distinct), and ``{"idx": (rounds, local_steps,
    participate, batch_per_agent)}``, rows into each participant's
    training split.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SURFConfig
from repro_torch.core.tasks import resolve_task
from repro_torch.utils.device import resolve_device, to_tensor


def _setup(cfg, task, device, W0, batch, S=None):
    task = resolve_task(cfg, task)
    device = resolve_device(device)
    W0 = to_tensor(W0, device, torch.float32)
    batch = task.to_batch(batch, device)
    S = None if S is None else to_tensor(S, device, torch.float32)
    return task, device, W0, batch, S


def _draw(draws, key, generator, shape, high, device, permutation=False):
    """``draws[key]`` checked against ``shape`` and [0, ``high``), or a
    fresh draw from ``generator``: uniform indices, or the first
    shape[-1] entries of a permutation of range(high) per leading
    index."""
    if draws is not None:
        x = to_tensor(draws[key], device, torch.long)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"draws[{key!r}] has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
        if x.numel() and (x.min().item() < 0 or x.max().item() >= high):
            raise ValueError(f"draws[{key!r}] holds indices outside "
                             f"[0, {high})")
        return x
    if generator is None:
        raise ValueError("pass a torch.Generator or draws=")
    gdev = generator.device
    if permutation:
        x = torch.stack([torch.randperm(high, generator=generator,
                                        device=gdev)[:shape[-1]]
                         for _ in range(shape[0])])
    else:
        x = torch.randint(0, high, shape, generator=generator, device=gdev)
    return x.to(device)


def _gather(X, Y, idx):
    """Rows ``idx`` (P, b) of each agent's split: X (P, m, F), Y (P, m)."""
    rows = torch.arange(X.shape[0], device=X.device)[:, None]
    return X[rows, idx], Y[rows, idx]


def _local_grads(W, Xb, Yb, task):
    """∇f_i(w_i) per agent (``Task._agent_grads``, the reference's
    ``vmap(grad(task.local_loss))``)."""
    return task._agent_grads(W, Xb, Yb)


def _metrics(W, batch, task):
    return (task.fl_loss(W, batch["Xte"], batch["Yte"]),
            task.fl_metric(W, batch["Xte"], batch["Yte"]))


def _result(rows):
    loss, acc = zip(*rows)
    return {"loss": torch.stack(loss).cpu().numpy(),
            "acc": torch.stack(acc).cpu().numpy()}


@torch.no_grad()
def run_dgd(S, W0, batch, generator, cfg: SURFConfig, rounds=200, lr=1e-3,
            task=None, device=None):
    """W ← S W − β ∇f_local(W), the full local batch each round. DGD
    draws nothing; ``generator`` is taken for the common signature."""
    task, device, W, batch, S = _setup(cfg, task, device, W0, batch, S)
    rows = []
    for _ in range(rounds):
        g = _local_grads(W, batch["Xtr"], batch["Ytr"], task)
        W = S @ W - lr * g
        rows.append(_metrics(W, batch, task))
    return _result(rows)


@torch.no_grad()
def run_dsgd(S, W0, batch, generator, cfg: SURFConfig, rounds=200, lr=1e-4,
             task=None, device=None, draws=None):
    """One-sample stochastic gradient per round."""
    task, device, W, batch, S = _setup(cfg, task, device, W0, batch, S)
    n, m = batch["Ytr"].shape
    idx = _draw(draws, "idx", generator, (rounds, n, 1), m, device)
    rows = []
    for r in range(rounds):
        Xb, Yb = _gather(batch["Xtr"], batch["Ytr"], idx[r])
        g = _local_grads(W, Xb, Yb, task)
        W = S @ W - lr * g
        rows.append(_metrics(W, batch, task))
    return _result(rows)


@torch.no_grad()
def run_dfedavgm(S, W0, batch, generator, cfg: SURFConfig, rounds=200,
                 lr=1e-2, local_steps=6, beta=0.9, task=None, device=None,
                 draws=None):
    """Decentralized FedAvg with momentum (Sun et al. 2023): 6 local
    momentum SGD steps on mini-batches, then one graph mixing. The
    momentum carries across rounds."""
    task, device, W, batch, S = _setup(cfg, task, device, W0, batch, S)
    n, m = batch["Ytr"].shape
    idx = _draw(draws, "idx", generator,
                (rounds, local_steps, n, cfg.batch_per_agent), m, device)
    mom = torch.zeros_like(W)
    rows = []
    for r in range(rounds):
        for i in range(local_steps):
            Xb, Yb = _gather(batch["Xtr"], batch["Ytr"], idx[r, i])
            g = _local_grads(W, Xb, Yb, task)
            mom = beta * mom + g
            W = W - lr * mom
        W = S @ W
        rows.append(_metrics(W, batch, task))
    return _result(rows)


# --------------------------------------------------------- classical (star)
def _classical_draws(cfg, draws, generator, rounds, local_steps,
                     participate, m, device):
    n = cfg.n_agents
    sel = _draw(draws, "sel", generator, (rounds, participate), n, device,
                permutation=True)
    if draws is not None and any(len(set(row)) != participate
                                 for row in sel.tolist()):
        raise ValueError("draws['sel'] must name distinct agents per round")
    idx = _draw(draws, "idx", generator,
                (rounds, local_steps, participate, cfg.batch_per_agent), m,
                device)
    return sel, idx


def _local_round(w, batch, sel_r, idx_r, task, lr, direction):
    """The participants' local steps from the global ``w``: each step
    subtracts lr · ``direction(g, W_local)``, g the local gradients."""
    Xs, Ys = batch["Xtr"][sel_r], batch["Ytr"][sel_r]
    W_local = w[None].repeat(sel_r.shape[0], 1)
    for idx in idx_r:
        Xb, Yb = _gather(Xs, Ys, idx)
        g = _local_grads(W_local, Xb, Yb, task)
        W_local = W_local - lr * direction(g, W_local)
    return W_local


@torch.no_grad()
def run_fedavg(W0, batch, generator, cfg: SURFConfig, rounds=25, lr=1e-1,
               local_steps=6, participate=10, task=None, device=None,
               draws=None):
    """FedAvg with partial participation (paper: 10 agents per round)."""
    task, device, W0, batch, _ = _setup(cfg, task, device, W0, batch)
    sel, idx = _classical_draws(cfg, draws, generator, rounds, local_steps,
                                participate, batch["Ytr"].shape[1], device)
    w, rows = W0[0], []
    for r in range(rounds):
        W_local = _local_round(w, batch, sel[r], idx[r], task, lr,
                               lambda g, W_: g)
        w = W_local.mean(0)
        rows.append(_metrics(w[None].expand(cfg.n_agents, -1), batch, task))
    return _result(rows)


@torch.no_grad()
def run_fedprox(W0, batch, generator, cfg: SURFConfig, rounds=25, lr=1e-1,
                local_steps=6, participate=10, mu=0.1, task=None,
                device=None, draws=None):
    """FedProx: local objective + (μ/2)‖w − w_global‖²."""
    task, device, W0, batch, _ = _setup(cfg, task, device, W0, batch)
    sel, idx = _classical_draws(cfg, draws, generator, rounds, local_steps,
                                participate, batch["Ytr"].shape[1], device)
    w, rows = W0[0], []
    for r in range(rounds):
        w_glob = w
        W_local = _local_round(w, batch, sel[r], idx[r], task, lr,
                               lambda g, W_: g + mu * (W_ - w_glob[None]))
        w = W_local.mean(0)
        rows.append(_metrics(w[None].expand(cfg.n_agents, -1), batch, task))
    return _result(rows)


@torch.no_grad()
def run_scaffold(W0, batch, generator, cfg: SURFConfig, rounds=25, lr=1e-1,
                 local_steps=6, participate=10, task=None, device=None,
                 draws=None):
    """SCAFFOLD (Karimireddy et al. 2020) with option-II control
    variates: global w and c, one c_i per agent."""
    task, device, W0, batch, _ = _setup(cfg, task, device, W0, batch)
    n, d = W0.shape
    sel, idx = _classical_draws(cfg, draws, generator, rounds, local_steps,
                                participate, batch["Ytr"].shape[1], device)
    w, rows = W0[0], []
    c = torch.zeros((d,), device=device)
    ci = torch.zeros((n, d), device=device)
    for r in range(rounds):
        ci_sel = ci[sel[r]]
        W_local = _local_round(w, batch, sel[r], idx[r], task, lr,
                               lambda g, W_: g - ci_sel + c[None])
        ci_new_sel = (ci_sel - c[None]
                      + (w[None] - W_local) / (local_steps * lr))
        # a new tensor: ci_sel, read above, stays this round's c_i
        ci = ci.index_copy(0, sel[r], ci_new_sel)
        c = c + (ci_new_sel - ci_sel).sum(0) / n
        w = w + (W_local - w[None]).mean(0)
        rows.append(_metrics(w[None].expand(n, -1), batch, task))
    return _result(rows)


DECENTRALIZED = {"dgd": run_dgd, "dsgd": run_dsgd, "dfedavgm": run_dfedavgm}
CLASSICAL = {"fedavg": run_fedavg, "fedprox": run_fedprox,
             "scaffold": run_scaffold}
