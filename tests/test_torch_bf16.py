"""The port in bf16 against the reference on the CPU: the primitives that
round differently from it, the parameter conversion, and reduced
gemma3-27b (a window-8 local layer with a ring cache, then a global one)
and qwen3-4b through both packages on the same bf16 weights.

The repairs (each test below fails on the port as it was before them):

  * the untied head and the tied unembedding give f32 logits accumulated
    in f32 from bf16 operands, as the reference's
    ``preferred_element_type=f32`` does (the port rounded the product to
    bf16 and widened it): within f32 summation order, 1e-6 of the largest
    logit;
  * ``dense`` with a bias rounds once, after adding the bias to the f32
    product, as the reference does: bit-equal;
  * ``lm_params_from_numpy`` takes a bf16 tree (numpy's ``ml_dtypes``
    bfloat16, which torch cannot read) through its 16-bit patterns and
    keeps the dtype: bit-equal.

What remains between the two packages in bf16 is not the port's:

  * the port's plain path (``plain_kernels=True``) is bit-equal, hidden
    states and caches, to the reference run op by op
    (``jax.disable_jit()``); logits within f32 summation order;
  * the reference's own forward runs each repeat's body under
    ``lax.scan``, compiled by XLA, which keeps f32 between fused bf16
    elementwise ops (``--xla_allow_excess_precision``, on by default). With
    that flag off its forward is bit-equal to its op-by-op run, so to the
    port's plain path. The fused forward is the nearer of the two to an
    f32 forward of the same bf16 weights;
  * the port's model on the CPU runs flash attention's plain version
    (``attention_ref``, P kept in f32, as the reference's kernel keeps
    it), where the reference's model runs ``sdpa``, which rounds P to bf16
    before P·V.

So the port's kernel path is held by distance: its logits and hidden
states, as max |d| / max |f32|, within 1.5x the reference's fused
forward's distance from the port's f32 forward of the same weights, over
the forward and over a prefill with 4 teacher-forced decode steps
across gemma3's window.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.checkpoint.convert import (lm_opt_state_from_numpy,
                                            lm_params_from_numpy)
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.utils.device import to_tensor
from repro_torch.utils.tree import _map

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

ARCHS = ["gemma3-27b", "qwen3-4b"]
PROMPT, NEW = 12, 4          # gemma3's window of 8 makes its cache a ring
SUM_ORDER = 1e-6             # f32 summation order, of the largest |entry|
DIST_FACTOR = 1.5            # the port's distance from f32 over the reference's
GEMM_FLIPS = 1e-3            # bf16 GEMM outputs one ulp off (summation order)


def _bf16(rng, *shape, scale=1.0):
    return jnp.asarray(scale * rng.standard_normal(shape).astype(
        np.float32)).astype(jnp.bfloat16)


def _t(a):
    """A bf16 jax array as a bf16 tensor, through its 16-bit patterns (not
    through ``to_tensor``, whose bf16 path has its own test)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(x):
    """A tensor or a jax array as f32 numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _dist(a, ref):
    a, ref = _np(a), _np(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _one_ulp(got, ref, what, share=0.0):
    """bf16 ``got`` equal to ``ref`` but for at most ``share`` of the
    entries, each of those within one bf16 ulp (2^-7 of its magnitude)."""
    got, ref = _np(got), _np(ref)
    off = got != ref
    assert off.mean() <= share, (what, off.mean())
    assert (np.abs(got - ref)[off] <= 2.0 ** -7 * np.abs(ref)[off]).all(), \
        what


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}".lstrip(".")))
        return out
    return {prefix: tree}


# ------------------------------------------------------------- the repairs
@pytest.mark.parametrize("tied", [False, True])
def test_bf16_logits_accumulate_in_f32(tied):
    """The head (``model._logits``, untied) and ``unembed`` (tied) on bf16
    operands: f32 logits within f32 summation order of the reference's."""
    rng = np.random.default_rng(0)
    x, w = _bf16(rng, 2, 5, 64), _bf16(rng, 64, 300, scale=0.3)
    cfg = get_config("gemma3-27b").reduced()
    if tied:
        table = w.T
        ref = JL.unembed({"table": table}, x)
        got = L.unembed({"table": _t(table)}, _t(x))
    else:
        ref = JM._logits(jget_config("gemma3-27b").reduced(),
                         {"head": {"w": w}}, x)
        got = M._logits(cfg, {"head": {"w": _t(w)}}, _t(x))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0,
                               atol=SUM_ORDER * np.abs(_np(ref)).max())


@pytest.mark.parametrize("shape", [(3, 7, 64, 96), (2, 1, 256, 768)])
def test_bf16_dense_with_bias_rounds_once(shape):
    """``dense`` with a bias in bf16 (the qwen archs' and whisper's
    projections): bias added to the f32 product, one rounding; bit-equal
    to the reference."""
    B, S, d_in, d_out = shape
    rng = np.random.default_rng(1)
    p = {"w": _bf16(rng, d_in, d_out, scale=d_in ** -0.5),
         "b": _bf16(rng, d_out)}
    x = _bf16(rng, B, S, d_in)
    got = L.dense({k: _t(v) for k, v in p.items()}, _t(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(JL.dense(p, x)))


# ------------------------------------------------------------- the models
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference cfg, port cfg, reference bf16 params, port params, the
    port's params widened to f32, ids)."""
    jcfg = jget_config(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    jp = JM.init_lm(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    ids = np.random.default_rng(0).integers(0, tcfg.vocab,
                                            (2, PROMPT + NEW))
    return jcfg, tcfg, jp, tp, _map(lambda t: t.float(), tp), ids


def test_bf16_params_and_moments_convert(pair):
    """The reference's ``init_lm`` tree in bf16 (``jax.tree.map(np.asarray,
    ...)``: ml_dtypes bfloat16 leaves) converts leaf for leaf, bf16 kept,
    bit-equal, as does one leaf through ``to_tensor``; Adam moments in
    bf16 convert to f32, exactly."""
    _, tcfg, jp, _, _, _ = pair
    jp = jax.tree.map(np.asarray, jp)
    tp = lm_params_from_numpy(tcfg, jp, device="cpu")
    ref, got = _leaves(jp), _leaves(tp)
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert got[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(_np(got[k]), _np(ref[k]), err_msg=k)
    table = to_tensor(jp["embed"]["table"], "cpu")
    assert table.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(table), _np(ref["embed.table"]))
    opt = lm_opt_state_from_numpy(tcfg, {"m": jp, "v": jp, "t": 3},
                                  device="cpu")
    for k, v in _leaves(opt["m"]).items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), _np(ref[k]), err_msg=k)


def test_bf16_layer_ops_match_reference(pair):
    """Layer 0 (gemma3: also layer 1, the global one) op by op, each port
    op fed the reference's bf16 inputs to it: the embedding, the norms,
    the qk-norms, the rotation on the same angles, the residual add
    bit-equal; the bf16 GEMMs (projections, the MLP, ``sdpa``'s P·V)
    equal but for at most GEMM_FLIPS of their entries, each one bf16 ulp
    off (f32 summation order before the rounding); RoPE's angles within
    an f32 ulp of the angle (XLA's and torch's f32 ``pow``, ``cos`` and
    ``sin`` are different implementations). The kernel path's attention
    on the CPU (``attention_ref``: P kept in f32, as the reference's
    kernel keeps it) against the reference's ``sdpa`` (P rounded to bf16)
    within ``bf16_error_bound`` per element."""
    from repro.models import attention as JA
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import attention as A
    from repro_torch.models import stack as ST
    jcfg, tcfg, jp, tp, _, ids = pair
    a = tcfg.attn
    B, S = ids.shape
    kinds = [(j, kind) for j, kind in enumerate(ST.build_segments(tcfg)[0][2])]
    with jax.disable_jit():
        x = JL.embed(jp["embed"], jnp.asarray(ids))
        _one_ulp(L.embed(tp["embed"], torch.tensor(ids)), x, "embed")
        for j, kind in kinds:
            jl = jax.tree.map(lambda t: t[0], jp["segments"]["seg0"][f"s{j}"])
            tl = ST._index(tp["segments"]["seg0"][f"s{j}"], 0)
            t = lambda v: _t(np.asarray(v))
            h = JL.rmsnorm(jl["ln1"], x)
            _one_ulp(L.rmsnorm(tl["ln1"], t(x)), h, "ln1")
            pos = jnp.asarray(np.arange(S)[None].repeat(B, 0))
            cos, sin = JL.rope_angles(pos, a.d_head, a.rope_theta)
            for g, r in zip(L.rope_angles(torch.tensor(np.asarray(pos)),
                                          a.d_head, a.rope_theta),
                            (cos, sin)):
                assert (np.abs(g.numpy() - np.asarray(r))
                        <= np.spacing(np.float32(S))).all()
            qkv = {}
            for w, heads, norm in (("wq", a.n_heads, "qn"),
                                   ("wk", a.n_kv_heads, "kn"),
                                   ("wv", a.n_kv_heads, None)):
                y = JL.dense(jl["attn"][w], h)
                _one_ulp(L.dense(tl["attn"][w], t(h)), y, w, GEMM_FLIPS)
                y = y.reshape(B, S, heads, a.d_head)
                if norm:
                    n = JL.rmsnorm(jl["attn"][norm], y)
                    _one_ulp(L.rmsnorm(tl["attn"][norm], t(y)), n, norm)
                    r = JL.apply_rope(n, cos, sin)
                    _one_ulp(L.apply_rope(t(n), _t(np.asarray(cos)),
                                          _t(np.asarray(sin))), r, "rope")
                    y = r
                qkv[w] = y
            mask = JA.causal_window_mask(S, S, 0, kind[2])[None]
            att = JA.sdpa(qkv["wq"], qkv["wk"], qkv["wv"], mask, a.n_kv_heads)
            tq, tk, tv = (t(qkv[w]) for w in ("wq", "wk", "wv"))
            tmask = A.causal_window_mask(S, kind[2])[None]
            _one_ulp(A.sdpa(tq, tk, tv, tmask, a.n_kv_heads), att, "sdpa",
                     GEMM_FLIPS)
            o = FA.flash_attention(*(u.transpose(1, 2) for u in (tq, tk, tv)),
                                   causal=True, window=kind[2])
            o_sdpa = t(att).reshape(B, S, a.n_heads, a.d_head).transpose(1, 2)
            bound = FA.bf16_error_bound(*(u.transpose(1, 2)
                                          for u in (tq, tk, tv)),
                                        o_sdpa, window=kind[2])
            assert ((o.float() - o_sdpa.float()).abs() <= bound).all()
            y = JL.dense(jl["attn"]["wo"], att)
            _one_ulp(L.dense(tl["attn"]["wo"], t(att)), y, "wo", GEMM_FLIPS)
            x2 = x + y
            _one_ulp(t(x) + t(y), x2, "residual")
            h2 = JL.rmsnorm(jl["ln2"], x2)
            _one_ulp(L.rmsnorm(tl["ln2"], t(x2)), h2, "ln2")
            f = JL.mlp(jl["ffn"], h2, tcfg.act)
            _one_ulp(L.mlp(tl["ffn"], t(h2), tcfg.act), f, "mlp", GEMM_FLIPS)
            x = x2 + f


def test_bf16_unfused_runs_are_peers(pair):
    """The port's plain path and the reference run op by op (both
    unfused; they part only where a bf16 GEMM's summation order flips a
    rounding, which then spreads): each within DIST_FACTOR x the
    other's distance from the port's f32 forward of the same weights, on
    the hidden states and the logits."""
    jcfg, tcfg, jp, tp, tp32, ids = pair
    tokens = torch.tensor(ids)
    with jax.disable_jit():
        jh, _, _ = JM.forward_hidden(jcfg, jp, jnp.asarray(ids))
        jl = JM._logits(jcfg, jp, jh)
    th, _, _ = M.forward_hidden(tcfg, tp, tokens, plain_kernels=True)
    tl = M._logits(tcfg, tp, th)
    assert th.dtype == torch.bfloat16 and tl.dtype == torch.float32
    h32, _, _ = M.forward_hidden(tcfg, tp32, tokens, plain_kernels=True)
    l32 = M._logits(tcfg, tp32, h32)
    for got, ref, f32 in ((th, jh, h32), (tl, jl, l32)):
        assert _dist(got, f32) <= DIST_FACTOR * _dist(ref, f32)
        assert _dist(ref, f32) <= DIST_FACTOR * _dist(got, f32)


def test_fused_reference_is_excess_precision(tmp_path):
    """The reference's own bf16 forward (its repeats under ``lax.scan``,
    compiled) with ``--xla_allow_excess_precision=false``, in a fresh
    process: bit-equal to its op-by-op run, for both archs. With the flag
    on (the default, this process) it differs from that run, and sits
    nearer the port's f32 forward of the same weights."""
    ids = np.random.default_rng(0).integers(0, 512, (2, PROMPT + NEW))
    np.save(tmp_path / "ids.npy", ids)
    code = ("import sys, jax, jax.numpy as jnp, numpy as np\n"
            "from repro.configs import get_config\n"
            "from repro.models import model as JM\n"
            "ids = jnp.asarray(np.load(sys.argv[1]))\n"
            f"for name in {ARCHS!r}:\n"
            "    cfg = get_config(name).reduced()\n"
            "    p = JM.init_lm(cfg, jax.random.PRNGKey(0), jnp.bfloat16)\n"
            "    h, _, _ = JM.forward_hidden(cfg, p, ids)\n"
            "    np.save(f'{sys.argv[2]}/{name}.npy',\n"
            "            np.asarray(h.astype(jnp.float32)))\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": (os.environ.get("XLA_FLAGS", "")
                         + " --xla_allow_excess_precision=false").strip()}
    subprocess.run([sys.executable, "-c", code, str(tmp_path / "ids.npy"),
                    str(tmp_path)], env=env, check=True, timeout=300)
    for name in ARCHS:
        jcfg, tcfg = jget_config(name).reduced(), get_config(name).reduced()
        jp = JM.init_lm(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
        with jax.disable_jit():
            ops, _, _ = JM.forward_hidden(jcfg, jp, jnp.asarray(ids))
        np.testing.assert_array_equal(np.load(tmp_path / f"{name}.npy"),
                                      _np(ops), err_msg=name)
        fused, _, _ = JM.forward_hidden(jcfg, jp, jnp.asarray(ids))
        tp32 = _map(lambda t: t.float(), lm_params_from_numpy(
            tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
        h32, _, _ = M.forward_hidden(tcfg, tp32, torch.tensor(ids),
                                     plain_kernels=True)
        assert not np.array_equal(_np(fused), _np(ops)), name
        assert _dist(fused, h32) < _dist(ops, h32), name


def test_bf16_forward_within_reference_distance_of_f32(pair):
    """The port's kernel path in bf16 and the reference's forward, each
    against the port's f32 forward of the same bf16-valued weights: the
    port's hidden states and logits within DIST_FACTOR x the
    reference's distance."""
    jcfg, tcfg, jp, tp, tp32, ids = pair
    tokens = torch.tensor(ids)
    jl, _, _ = JM.forward(jcfg, jp, jnp.asarray(ids))
    jh, _, _ = JM.forward_hidden(jcfg, jp, jnp.asarray(ids))
    th, _, _ = M.forward_hidden(tcfg, tp, tokens)
    tl = M._logits(tcfg, tp, th)
    h32, _, _ = M.forward_hidden(tcfg, tp32, tokens, plain_kernels=True)
    l32 = M._logits(tcfg, tp32, h32)
    for what, got, ref, f32 in (("hidden", th, jh, h32),
                                ("logits", tl, jl, l32)):
        assert _dist(got, f32) <= DIST_FACTOR * _dist(ref, f32), (
            what, _dist(got, f32), _dist(ref, f32))


def test_bf16_prefill_and_decode_through_the_ring(pair):
    """A prefill of PROMPT ids, then NEW decode steps teacher-forced on the
    same ids in bf16 (gemma3's local layer: a ring of 8 slots, wrapped by
    the decode), through the port's kernel path and the reference, and
    through the port in f32 from the same weights. At every step the
    logits, and after the last step every cache tensor, of the port
    within DIST_FACTOR x the reference's distance from the f32 run."""
    jcfg, tcfg, jp, tp, tp32, ids = pair
    cache_len = PROMPT + NEW
    head = torch.tensor(ids[:, :PROMPT])
    ref = [JM.forward(jcfg, jp, jnp.asarray(ids[:, :PROMPT]),
                      want_cache=True, cache_len=cache_len)]
    got = [M.forward(tcfg, tp, head, want_cache=True, cache_len=cache_len)]
    f32 = [M.forward(tcfg, tp32, head, want_cache=True, cache_len=cache_len,
                     plain_kernels=True)]
    ring = [k for k, v in _leaves(got[0][1]).items()
            if v.shape[-3] < cache_len]
    assert bool(ring) == bool(tcfg.attn.window)
    for i in range(NEW):
        pos, tok = PROMPT + i, ids[:, PROMPT + i:PROMPT + i + 1]
        ref.append(JM.decode_step(jcfg, jp, jnp.asarray(tok), ref[-1][1],
                                  jnp.int32(pos), cache_len))
        for run, p in ((got, tp), (f32, tp32)):
            run.append(M.decode_step(tcfg, p, torch.tensor(tok), run[-1][1],
                                     pos, cache_len))
    for step in range(NEW + 1):
        d_got = _dist(got[step][0], f32[step][0])
        d_ref = _dist(ref[step][0], f32[step][0])
        assert d_got <= DIST_FACTOR * d_ref, (step, d_got, d_ref)
    caches, f32_caches = _leaves(got[-1][1]), _leaves(f32[-1][1])
    for k, v in _leaves(ref[-1][1]).items():
        d_got, d_ref = _dist(caches[k], f32_caches[k]), _dist(v, f32_caches[k])
        assert d_got <= DIST_FACTOR * d_ref, (k, d_got, d_ref)
