"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``), on the CPU: the cases of ``tests/test_moe.py`` and
the MoE properties of ``tests/test_properties.py``, on the same weights
(the reference's ``init_moe`` tree as numpy) and inputs.

The weights are numpy-seeded trees with ``init_moe``'s keys, shapes and
scales, and the reference's functions run jitted (its eager ops would each
compile apart).

Tolerances: 1e-5 for ``moe_apply`` against the reference and against the
reference's dense oracle (``tests/test_moe.py``'s); 1e-6 for the router's
weights and losses (one softmax in f32); bit-equal dispatch maps; 1e-4 of
each gradient's largest entry against ``jax.vjp`` (f32 sums in another
order, ``tests/test_torch_lm_train.py``'s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig
from repro.models import layers as JL
from repro.models import moe as JMO
from repro_torch.configs import get_config
from repro_torch.models import moe as MO

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

D, DFF = 16, 32
j_moe_apply = jax.jit(JMO.moe_apply, static_argnums=(2, 3))
j_route = jax.jit(JMO.route, static_argnums=(2,))
j_dispatch = jax.jit(JMO.dispatch_indices, static_argnums=(1, 2))


def no_drop(E=4, k=2, shared=0, d_expert=None):
    return MoEConfig(n_experts=E, top_k=k, n_shared=shared,
                     d_expert=d_expert, capacity_factor=float(E) / k)


def _t(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _params(m, act, seed=0, d=D, dff=DFF):
    """A numpy tree with ``init_moe``'s keys, shapes and scales."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: (rng.standard_normal(shape) * d ** -0.5).astype(
        np.float32)
    de, E = m.d_expert or dff, m.n_experts
    p = {"router": {"w": f(d, E)}, "wu": f(E, d, de), "wd": f(E, de, d)}
    if act == "swiglu":
        p["wg"] = f(E, d, de)
    if m.n_shared:
        hid = de * m.n_shared
        p["shared"] = {k: {"w": f(*shape)} for k, shape in (
            ("wg", (d, hid)), ("wu", (d, hid)), ("wd", (hid, d)))
            if act == "swiglu" or k != "wg"}
    return p


def _setup(m, act, shape, seed=0):
    """(reference params, port params, x as numpy)."""
    tree = _params(m, act, seed)
    x = np.random.default_rng(seed + 100).standard_normal(
        shape + (D,)).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), _t(tree), x


def dense_oracle(p, x2, m, act):
    return _dense_oracle(p, x2, m, act)


@__import__("functools").partial(jax.jit, static_argnums=(2, 3))
def _dense_oracle(p, x2, m, act):
    """The reference's oracle (``tests/test_moe.py``): every expert on every
    token, combined with the router's weights."""
    w, idx, _, _ = JMO.route(p, x2, m)
    if act == "swiglu":
        g = jnp.einsum("td,edf->tef", x2, p["wg"])
        u = jnp.einsum("td,edf->tef", x2, p["wu"])
        h = jax.nn.silu(g) * u
    else:
        h = jax.nn.gelu(jnp.einsum("td,edf->tef", x2, p["wu"]))
    ye = jnp.einsum("tef,efd->ted", h, p["wd"])
    y = jnp.einsum("tk,tkd->td", w, jnp.take_along_axis(
        ye, idx[..., None], axis=1))
    if "shared" in p:
        y = y + JL.mlp(p["shared"], x2, act)
    return y


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_apply_matches_reference_and_dense_oracle(act, shared):
    m = no_drop(shared=shared)
    jp, tp, x = _setup(m, act, (3, 7))
    y, lb, z = MO.moe_apply(tp, torch.tensor(x), m, act)
    jy, jlb, jz = j_moe_apply(jp, jnp.asarray(x), m, act)
    assert y.shape == (3, 7, D)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(y.reshape(-1, D).numpy(), np.asarray(
        dense_oracle(jp, jnp.asarray(x.reshape(-1, D)), m, act)), atol=1e-5)
    np.testing.assert_allclose([float(lb), float(z)], [float(jlb), float(jz)],
                               rtol=1e-6)


def test_capacity_drops_tokens():
    """With tiny capacity, overflow tokens get zero routed output (exactly,
    without shared experts), as in the reference, and the kept ones their
    dense-oracle output."""
    m = MoEConfig(n_experts=4, top_k=1, capacity_factor=0.25)
    jp, tp, x = _setup(m, "swiglu", (1, 64))
    y, _, _ = MO.moe_apply(tp, torch.tensor(x), m, "swiglu")
    jy, _, _ = j_moe_apply(jp, jnp.asarray(x), m, "swiglu")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    y2 = y.reshape(-1, D).numpy()
    oracle = np.asarray(dense_oracle(jp, jnp.asarray(x.reshape(-1, D)), m,
                                     "swiglu"))
    tok_idx, _ = MO.dispatch_indices(MO.route(
        tp, torch.tensor(x.reshape(-1, D)), m)[1], 64, m)
    kept = np.zeros(64, bool)
    kept[tok_idx[tok_idx < 64].numpy()] = True
    assert 0 < kept.sum() < 64 and kept.sum() <= 4 * MO.capacity(64, m)
    assert (y2[~kept] == 0).all()
    np.testing.assert_allclose(y2[kept], oracle[kept], atol=1e-5)
    assert np.isfinite(y2).all()


@pytest.mark.parametrize("T,k,E,cf", [(40, 2, 8, 1.0), (64, 1, 4, 0.25),
                                      (37, 3, 5, 1.25), (4, 6, 64, 1.25),
                                      (9, 2, 4, 2.0)])
def test_dispatch_indices_bit_equal(T, k, E, cf):
    """``tok_idx`` and ``slot_src`` equal the reference's, overflow and
    empty slots included; ``slot_of`` inverts ``slot_src``."""
    m = MoEConfig(n_experts=E, top_k=k, capacity_factor=cf)
    rng = np.random.default_rng(T * 7 + k)
    # distinct experts per token, as top_k gives
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    jt, js = j_dispatch(jnp.asarray(idx), T, m)
    tt, ts = MO.dispatch_indices(torch.tensor(idx), T, m)
    assert tt.dtype == ts.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _, slot_src, slot_of = MO.dispatch_maps(torch.tensor(idx), T, m)
    C = MO.capacity(T, m)
    flat = slot_src.reshape(-1)
    for s, pair in enumerate(flat.tolist()):
        if pair < T * k:
            assert slot_of.reshape(-1)[pair] == s
    assert int((slot_of < E * C).sum()) == int((flat < T * k).sum())


def test_capacity_matches_reference():
    """The capacity expression in the reference's float order: 960, 640
    and 1280 slots at 8192 prefill tokens for the three MoE archs, 1 in
    decode at B = 4."""
    for name, prefill in (("deepseek-moe-16b", 960),
                          ("llama4-scout-17b-a16e", 640),
                          ("jamba-1.5-large-398b", 1280)):
        m = get_config(name).moe
        assert MO.capacity(8192, m) == prefill == JMO.capacity(8192, m)
        assert MO.capacity(4, m) == 1 == JMO.capacity(4, m)
    for E, k, cf in ((64, 6, 1.25), (16, 1, 1.25), (16, 2, 1.25),
                     (4, 2, 2.0), (8, 2, 1.0), (4, 1, 0.25)):
        m = MoEConfig(n_experts=E, top_k=k, capacity_factor=cf)
        for n in range(1, 300, 7):
            assert MO.capacity(n, m) == JMO.capacity(n, m), (E, k, cf, n)


@pytest.mark.parametrize("T,k,seed", [(2, 1, 0), (17, 2, 1), (32, 4, 2),
                                      (9, 3, 3)])
def test_route_matches_reference(T, k, seed):
    """Weights, indices (top-k sorted), lb and z against the reference's;
    and ``tests/test_properties.py``'s: weights sum to 1, indices distinct
    and in range."""
    E = 8
    m = MoEConfig(n_experts=E, top_k=k)
    tree = _params(m, "swiglu", seed, d=8, dff=16)
    x2 = np.random.default_rng(seed + 1).standard_normal((T, 8)).astype(
        np.float32)
    jw, jidx, jlb, jz = j_route(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(x2), m)
    w, idx, lb, z = MO.route(_t(tree), torch.tensor(x2), m)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose([float(lb), float(z)], [float(jlb), float(jz)],
                               rtol=1e-6)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    assert ((idx >= 0) & (idx < E)).all()
    assert all(len(set(r)) == k for r in idx.tolist())


@pytest.mark.parametrize("act,shared,cf", [("swiglu", 1, 1.25),
                                           ("gelu", 0, 2.0),
                                           ("swiglu", 0, 0.5)])
def test_gradients_match_jax_vjp(act, shared, cf):
    """Gradients of (y, lb, z) through ``moe_apply`` (every weight and x)
    against ``jax.vjp`` of the reference's, with random cotangents;
    cf 0.5 drops tokens."""
    m = MoEConfig(n_experts=4, top_k=2, n_shared=shared, capacity_factor=cf)
    jp, tp, x = _setup(m, act, (2, 12), seed=3)
    rng = np.random.default_rng(0)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    glb, gz = 0.7, -0.3
    jgp, jgx = jax.jit(lambda p, xx, c: jax.vjp(
        lambda p_, x_: JMO.moe_apply(p_, x_, m, act), p, xx)[1](c))(
        jp, jnp.asarray(x), (jnp.asarray(gy), jnp.float32(glb),
                             jnp.float32(gz)))
    leaves, tdef = jax.tree.flatten(tp)
    live = [t.clone().requires_grad_() for t in leaves]
    tx = torch.tensor(x, requires_grad=True)
    y, lb, z = MO.moe_apply(jax.tree.unflatten(tdef, live), tx, m, act)
    (y * torch.tensor(gy)).sum().add(glb * lb + gz * z).backward()
    for (path, jg), t in zip(jax.tree_util.tree_flatten_with_path(jgp)[0],
                             live):
        jg = np.asarray(jg)
        scale = max(np.abs(jg).max(), 1e-6)
        np.testing.assert_allclose(t.grad.numpy(), jg, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))
    jgx = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), jgx,
                               atol=1e-4 * np.abs(jgx).max())


def test_gather_backward_equals_scatter_add():
    """The gathers' backward (a sum over each row's readers, in order)
    equals autograd through plain indexing (a scatter-add), for the
    dispatch and the combine, drops included."""
    m = MoEConfig(n_experts=4, top_k=2, capacity_factor=0.75)
    T, d = 20, 6
    gen = torch.Generator().manual_seed(0)
    idx = torch.stack([torch.randperm(4, generator=gen)[:2]
                       for _ in range(T)])
    tok_idx, slot_src, slot_of = MO.dispatch_maps(idx, T, m)
    E, C = tok_idx.shape
    for src_rows, index, inverse in (
            (T, tok_idx, slot_of),
            (E * C, slot_of, slot_src.reshape(-1, 1))):
        src = torch.randn(src_rows, d, generator=gen, requires_grad=True)
        g = torch.randn(index.shape + (d,), generator=gen)
        out = MO._Gather.apply(src, index, inverse)
        (got,) = torch.autograd.grad(out, src, g)
        pad = torch.cat([src, src.new_zeros(1, d)])
        ref_out = pad[index]
        (ref,) = torch.autograd.grad(ref_out, src, g)
        torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
