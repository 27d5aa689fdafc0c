"""LM training in the reference's production dtype on the CPU: bf16
parameters with f32 Adam moments (``repro.launch.specs.PARAM_DTYPE``,
``repro.optim.optimizers``), the donated step, and the wkv recurrence
differentiated through its final state.

  * reduced qwen3-4b and rwkv6-1.6b at 2 layers through both packages on
    the same bf16 weights (``lm_params_from_numpy``): the port's gradients
    (``loss_and_grads``) are held by their distance from the port's f32
    gradients of the same weights widened, within DIST_FACTOR x the
    reference's (``jax.value_and_grad`` of its ``lm_loss``), as
    ``tests/test_torch_bf16.py`` holds the forward: the two packages round
    bf16 at other places (the reference's compiled step keeps f32 between
    fused bf16 ops);
  * one ``make_train_step`` step in bf16 against the reference's jitted
    step: parameters stay bf16, m and v f32, t 1; the loss agrees to bf16
    rounding, m is held by its distance from the f32 step's as the
    gradients are, and each parameter is within 2 lr of the reference's
    (Adam's first step moves each entry by at most lr) and the two
    roundings to bf16;
  * ``make_train_step(donate=True)`` bit-equal to the undonated step, f32
    and bf16, 1 and 2 microbatches, with the same tree objects returned
    and updated in place; ``donated_adam_step_`` frees each gradient;
  * the plain wkv's gradients with cotangents on y and on the final state
    S against the reference's ``jax.vjp``, at the wkv tests' tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.ssm_scan import wkv_ref as jwkv_ref
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as JM
from repro_torch.checkpoint.convert import lm_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels.ssm_scan import wkv, wkv_ref
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import model as M
from repro_torch.optim import adam, clip_by_global_norm, donated_adam_step_
from repro_torch.utils.tree import _leaves, _map

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

ARCHS = ["qwen3-4b", "rwkv6-1.6b"]
LAYERS, B, S, LR = 2, 2, 16, 1e-3
DIST_FACTOR = 1.5     # the port's distance from f32 over the reference's
GRAD_TOL = 5e-4       # tests/test_torch_wkv.py: the plain wkv's gradients


def _np(x):
    """A tensor or a jax array as f32 numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}".lstrip(".")))
        return out
    return {prefix: tree}


def _dist(a, ref):
    """‖a − ref‖₂ / ‖ref‖₂ over every tensor of two trees (matched by
    their dotted names)."""
    a, ref = _flat(a), _flat(ref)
    assert set(a) == set(ref)
    d = sum(float(np.square(_np(a[n]) - _np(ref[n])).sum()) for n in ref)
    r = sum(float(np.square(_np(ref[n])).sum()) for n in ref)
    return np.sqrt(d / r)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference cfg, port cfg, reference bf16 params, port params, the
    port's params widened to f32, batch as numpy)."""
    jcfg = dataclasses.replace(jget_config(request.param).reduced(),
                               n_layers=LAYERS)
    tcfg = dataclasses.replace(get_config(request.param).reduced(),
                               n_layers=LAYERS)
    jp = JM.init_lm(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    ids = np.random.default_rng(1).integers(0, tcfg.vocab, (B, S + 1))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    return jcfg, tcfg, jp, tp, _map(lambda t: t.float(), tp), batch


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_bf16_grads_within_reference_distance_of_f32(pair):
    jcfg, tcfg, jp, tp, tp32, batch = pair
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.lm_loss(jcfg, p, _j(batch)), has_aux=True))(jp)
    (tl, _), tg = loss_and_grads(tcfg, tp, _t(batch), remat=False)
    (_, _), g32 = loss_and_grads(tcfg, tp32, _t(batch), remat=False,
                                 plain_kernels=True)
    assert all(g.dtype == torch.bfloat16 for g in _leaves(tg))
    assert _dist(tg, g32) <= DIST_FACTOR * _dist(jg, g32), (
        _dist(tg, g32), _dist(jg, g32))
    assert abs(float(tl) - float(jl)) <= 2.0 ** -7 * abs(float(jl))


def test_bf16_train_step_matches_reference(pair):
    jcfg, tcfg, jp, tp, tp32, batch = pair
    jstep, jopt = jmake_train_step(jcfg, lr=LR, remat=False)
    jp1, jo1, jm = jax.jit(jstep)(jp, jopt.init(jp), _j(batch))
    step, opt = make_train_step(tcfg, lr=LR, remat=False)
    tp1, to1, tm = step(tp, opt.init(tp), _t(batch))
    _, o32, _ = step(tp32, opt.init(tp32), _t(batch))
    assert all(p.dtype == torch.bfloat16 for p in _leaves(tp1))
    assert all(m.dtype == torch.float32 for m in _leaves(to1["m"]))
    assert all(v.dtype == torch.float32 for v in _leaves(to1["v"]))
    assert int(to1["t"]) == int(jo1["t"]) == 1
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= (
        2.0 ** -7 * abs(float(jm["loss"])))
    assert _dist(to1["m"], o32["m"]) <= DIST_FACTOR * _dist(jo1["m"],
                                                            o32["m"])
    jf, tf = _flat(jp1), _flat(tp1)
    for name, ref in jf.items():
        got, ref = _np(tf[name]), _np(ref)
        assert (np.abs(got - ref) <= 2 * LR * (1 + 1e-3) + 2.0 ** -8 * (
            np.abs(got) + np.abs(ref))).all(), name


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_donated_step_bit_equal(dtype, microbatches):
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              n_layers=LAYERS)
    params = M.init_lm(cfg, 0, getattr(torch, dtype), device="cpu")
    ids = np.random.default_rng(2).integers(0, cfg.vocab, (2 * B, S + 1))
    batch = _t({"tokens": ids[:, :-1], "labels": ids[:, 1:]})
    kw = dict(lr=LR, remat=False, microbatches=microbatches)
    undonated, opt = make_train_step(cfg, **kw)
    donated, _ = make_train_step(cfg, donate=True, **kw)
    pu, ou = params, opt.init(params)
    pd, od = _map(torch.clone, params), opt.init(params)
    for _ in range(2):
        pu, ou, mu = undonated(pu, ou, batch)
        pd2, od2, md = donated(pd, od, batch)
        assert pd2 is pd and od2 is od
        assert mu["loss"].item() == md["loss"].item()
        assert mu["grad_norm"].item() == md["grad_norm"].item()
    for a, b in zip(_leaves((pu, ou)), _leaves((pd, od))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in
                   zip(_leaves(params), _leaves(pd)))


def test_donated_adam_step_frees_each_gradient():
    """On a small tree of dicts and lists: the clip, Adam and the update in
    place, bit-equal to the functional three, each gradient's slot set to
    None once its parameter is updated."""
    rng = np.random.default_rng(3)
    mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32))
    params = {"a": mk(4, 3).bfloat16(), "b": [mk(5), {"c": mk(2, 2)}]}
    grads = _map(lambda p: (3 * mk(*p.shape)).to(p.dtype), params)
    opt = adam(LR)
    clipped, gn = clip_by_global_norm(grads, 1.0)
    upd, ref_state = opt.update(clipped, opt.init(params))
    ref = _map(lambda p, u: p + u.to(p.dtype), params, upd)
    state = opt.init(params)
    got, state2, gn2 = donated_adam_step_(grads, state, params, LR)
    assert got is params and state2 is state and gn2.item() == gn.item()
    assert all(g is None for g in (grads["a"], grads["b"][0],
                                   grads["b"][1]["c"]))
    for a, b in zip(_leaves((ref, ref_state)), _leaves((params, state))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B_,H,T,dk", [(2, 2, 20, 16), (1, 3, 33, 8)])
def test_plain_wkv_gradients_through_the_final_state(B_, H, T, dk, dtype):
    rng = np.random.default_rng(T + dk)
    mk = lambda: 0.5 * rng.standard_normal((B_, H, T, dk)).astype(np.float32)
    r, k, v = mk(), mk(), mk()
    w = (0.5 + 0.5 / (1 + np.exp(-mk()))).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, dk))).astype(np.float32)
    dy, dS = mk(), rng.standard_normal((B_, H, dk, dk)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(a).astype(jdt) for a in (r, k, v, w)] + [
        jnp.asarray(u)]
    (y, S), vjp = jax.vjp(lambda *a: jwkv_ref(*a), *jargs)
    ref = vjp((jnp.asarray(dy).astype(jdt), jnp.asarray(dS)))
    xs = [torch.tensor(a).to(getattr(torch, dtype)).requires_grad_()
          for a in (r, k, v, w)] + [torch.tensor(u).requires_grad_()]
    for fn in (wkv_ref, wkv):        # the plain version, and the wrapper
        yt, St = fn(*xs)
        got = torch.autograd.grad(
            (yt, St), xs, (torch.tensor(dy).to(yt.dtype), torch.tensor(dS)))
        for name, g, gr in zip("rkvwu", got, ref):
            gr = _np(gr)
            # bf16 gradients: one rounding each side
            tol = GRAD_TOL if dtype == "float32" else 2.0 ** -7
            np.testing.assert_allclose(_np(g), gr, rtol=tol,
                                       atol=GRAD_TOL * np.abs(gr).max(),
                                       err_msg=f"d{name}")
