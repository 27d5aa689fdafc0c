"""The port's Mamba mixer (``repro_torch.models.ssm``, the Mamba half)
against the reference's (``repro.models.ssm``), on the CPU, on the same
weights (numpy-seeded trees with ``init_mamba``'s keys and shapes) and
inputs: ``mamba_full`` (y and the final state), 8 decode steps of
``mamba_step`` after it, ``chunked_time_scan`` at lengths 128 does not
divide, the causal conv, ``init_mamba``'s deterministic tensors, and the
gradients against ``jax.vjp`` with and without checkpointed chunks.

Tolerance: 1e-4 (atol and rtol; gradients: of each one's largest entry),
``tests/test_torch_lm.py``'s. The reference's functions run jitted.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import SSMConfig
from repro.models import ssm as JS
from repro_torch.models import ssm as S

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

TOL = 1e-4
D = 16
CFG = SSMConfig(kind="mamba", d_state=8, d_conv=4, expand=2)

j_full = jax.jit(JS.mamba_full, static_argnums=(1, 3))
j_step = jax.jit(JS.mamba_step, static_argnums=(1,))


def _params(seed=0, d=D, s=CFG):
    """A numpy tree with ``init_mamba``'s keys and shapes; dt_bias drawn
    around the reference's −4.6 so the decays spread."""
    rng = np.random.default_rng(seed)
    di, N = s.expand * d, s.d_state
    f = lambda scale, *shape: (rng.standard_normal(shape) * scale).astype(
        np.float32)
    return {"in_x": {"w": f(d ** -0.5, d, di)},
            "in_z": {"w": f(d ** -0.5, d, di)},
            "conv": f(0.2, s.d_conv, di),
            "x_bc": {"w": f(di ** -0.5, di, 2 * N)},
            "x_dt": {"w": f(di ** -0.5, di, 1)},
            "dt_bias": (-4.6 + 2 * rng.random(di)).astype(np.float32),
            "A_log": np.log(np.arange(1, N + 1, dtype=np.float32))[None]
            .repeat(di, 0) + f(0.1, di, N),
            "D": 1 + f(0.1, di),
            "out": {"w": f(di ** -0.5, di, d)}}


def _pair(seed=0):
    tree = _params(seed)
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(torch.tensor, tree))


def _x(shape, seed=1):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(
        np.float32)


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=TOL,
                               rtol=TOL, err_msg=what)


def test_init_mamba_matches_reference():
    """Same keys and shapes; A_log = log(1..N) repeated over di,
    dt_bias = −4.6 and D = 1, exactly."""
    s = SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2)
    ref = jax.jit(JS.init_mamba, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), 24, s, jnp.float32)
    from repro_torch.models import layers as L
    got = S.init_mamba(L.Init(torch.Generator().manual_seed(0)), 24, s)
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_g = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert {jax.tree_util.keystr(k): v.shape for k, v in flat_r.items()} == {
        k: tuple(v.shape) for k, v in flat_g.items()}
    for k in ("A_log", "dt_bias", "D"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("T,chunk", [(10, 5), (10, 128), (44, 16)])
def test_mamba_full_and_decode_match_reference(T, chunk):
    """``mamba_full`` (y, h, conv rows) against the reference's, then 8
    decode steps from its state, output and state at every step."""
    jp, tp = _pair()
    x = _x((2, T + 8, D))
    jy, jst = j_full(jp, CFG, jnp.asarray(x[:, :T]), chunk)
    with torch.no_grad():
        y, st = S.mamba_full(tp, CFG, torch.tensor(x[:, :T]), chunk)
    _close(y, jy, "y")
    for k in ("h", "conv"):
        _close(st[k], jst[k], f"state {k}")
    for t in range(T, T + 8):
        jy1, jst = j_step(jp, CFG, jnp.asarray(x[:, t:t + 1]), jst)
        with torch.no_grad():
            y1, st = S.mamba_step(tp, CFG, torch.tensor(x[:, t:t + 1]), st)
        _close(y1, jy1, f"decode y at {t}")
        for k in ("h", "conv"):
            _close(st[k], jst[k], f"decode {k} at {t}")


def test_decode_continues_the_full_sequence():
    """The reference's own check (``tests/test_ssm.py``): stepping through
    the sequence gives ``mamba_full``'s output; and the conv state keeps
    the last d_conv − 1 rows of the conv's input."""
    _, tp = _pair(2)
    x = torch.tensor(_x((2, 10, D), 3))
    with torch.no_grad():
        y_full, st_full = S.mamba_full(tp, CFG, x, chunk=5)
        st = S.init_mamba_state(2, D, CFG)
        ys = []
        for t in range(10):
            y1, st = S.mamba_step(tp, CFG, x[:, t:t + 1], st)
            ys.append(y1)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, atol=2e-4, rtol=0)
    torch.testing.assert_close(st["conv"], st_full["conv"], atol=1e-6,
                               rtol=0)
    xi = x @ tp["in_x"]["w"]
    torch.testing.assert_close(st_full["conv"], xi[:, -3:], atol=0, rtol=0)


def test_conv_matches_reference_and_conv1d():
    """The causal depthwise conv at d_conv = 4 against the reference's
    ``conv_general_dilated`` and against ``F.conv1d(groups=di)``."""
    rng = np.random.default_rng(5)
    di = 12
    w = rng.standard_normal((4, di)).astype(np.float32)
    x = rng.standard_normal((3, 9, di)).astype(np.float32)
    ref = jax.jit(JS._mamba_conv_full)({"conv": jnp.asarray(w)},
                                       jnp.asarray(x))
    got = S._mamba_conv_full({"conv": torch.tensor(w)}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    c1 = F.conv1d(F.pad(torch.tensor(x).transpose(1, 2), (3, 0)),
                  torch.tensor(w).T[:, None, :], groups=di).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), c1.numpy(), atol=1e-6)


@pytest.mark.parametrize("T,chunk", [(24, 8), (300, 128), (131, 128),
                                     (5, 128)])
def test_chunked_time_scan_matches_reference(T, chunk):
    """A scan at lengths 128 does not divide (300: chunks of 4; 131, a
    prime: chunks of 1), and the reference's ``_pick_chunk``."""
    xs = _x((T, 3), T)

    def jstep(c, x):
        c = 0.9 * c + x
        return c, c * 2.0

    def tstep(c, x):
        c = 0.9 * c + x[0]
        return c, c * 2.0

    jc, jy = jax.jit(functools.partial(JS.chunked_time_scan, jstep,
                                       chunk=chunk))(jnp.zeros(3),
                                                     jnp.asarray(xs))
    c, y = S.chunked_time_scan(tstep, torch.zeros(3), (torch.tensor(xs),),
                               chunk)
    # XLA contracts 0.9 c + x into one FMA: a few ulp over 300 steps (atol
    # for entries near 0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    for n in (1, 5, 24, 100, 128, 131, 300, 2048, 4096, 1000):
        assert S._pick_chunk(n) == JS._pick_chunk(n)


@pytest.mark.parametrize("remat", [True, False])
def test_gradients_match_jax_vjp(remat, monkeypatch):
    """Gradients of (y, h) through ``mamba_full`` (every weight and x)
    against ``jax.vjp`` of the reference's at T = 20, ``chunk=8`` (8 does
    not divide 20, so ``_pick_chunk`` takes 4: five chunks), each chunk
    checkpointed or, with ``remat`` off, run directly."""
    calls = []
    if remat:
        inner = S._checkpoint
        monkeypatch.setattr(S, "_checkpoint", lambda fn, *a: (
            calls.append(fn.__name__), inner(fn, *a))[1])
    else:
        monkeypatch.setattr(S, "_checkpoint", lambda fn, *a: (
            calls.append("direct"), fn(*a))[1])
    jp, tp = _pair(4)
    x = _x((2, 20, D), 6)
    rng = np.random.default_rng(7)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gh = rng.standard_normal((2, 2 * D, CFG.d_state)).astype(np.float32)
    jgp, jgx = jax.jit(lambda p, xx, c: jax.vjp(
        lambda p_, x_: (lambda o: (o[0], o[1]["h"]))(
            JS.mamba_full(p_, CFG, x_, 8)), p, xx)[1](c))(
        jp, jnp.asarray(x), (jnp.asarray(gy), jnp.asarray(gh)))
    leaves, tdef = jax.tree.flatten(tp)
    live = [t.clone().requires_grad_() for t in leaves]
    tx = torch.tensor(x, requires_grad=True)
    y, st = S.mamba_full(jax.tree.unflatten(tdef, live), CFG, tx, 8)
    ((y * torch.tensor(gy)).sum() + (st["h"] * torch.tensor(gh)).sum()
     ).backward()
    assert calls == (["_run_chunk"] if remat else ["direct"]) * 5
    for (path, jg), t in zip(jax.tree_util.tree_flatten_with_path(jgp)[0],
                             live):
        jg = np.asarray(jg)
        np.testing.assert_allclose(t.grad.numpy(), jg,
                                   atol=TOL * np.abs(jg).max(),
                                   err_msg=jax.tree_util.keystr(path))
    jgx = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), jgx,
                               atol=TOL * np.abs(jgx).max())
