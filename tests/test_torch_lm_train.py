"""The port's LM training path against the reference, on the CPU, at the
reduced configs of qwen3-4b, rwkv6-1.6b, gemma3-27b and whisper-small
(its batches carry 24 frames; the MoE and
hybrid archs: ``tests/test_torch_lm_moe_train.py``, with these helpers):
``lm_loss`` and its gradients (chunked cross-entropy, remat, nested remat),
``make_train_step`` (with gradient accumulation), ``blockwise_sdpa``,
``TokenPipeline``, the ``launch.train`` driver and LM checkpoints.

Both packages run the same parameters: the reference's ``init_lm`` tree
converted with ``checkpoint.convert.lm_params_from_numpy`` (Adam's state
with ``lm_opt_state_from_numpy``), and the same token ids from numpy. The
reference runs its own model code; the port runs its kernels' wrappers,
which take their plain versions (autograd-differentiated) on CPU tensors.

Tolerances, each with its reason:

  * 1e-4 (atol and rtol) for losses, gradients, parameters and Adam's
    moments (relative to each tensor's largest entry): f32 sums in another
    order, the tolerance of ``tests/test_torch_lm.py`` (measured at most
    2.5e-5 on the gradients, in rwkv6's time-mix);
  * Adam's noise floor: where a gradient entry is at the f32 noise floor,
    the two packages' f32 evaluations differ by more than 1e-4 of Adam's
    m, and Adam's first, sign-like step (about −lr·sign(g) even for a
    gradient of 1e-10) turns that into a parameter difference of up to
    2·lr. Parameter entries outside 1e-4 there are counted apart (the
    noise rule of ``chip_smoke.py``'s meta-step gate) and may be at most
    0.2% of the tree (about 30 of 1.4 M entries show it here);
  * 2e-5 for ``blockwise_sdpa`` (``tests/test_perf_opts.py``'s);
  * microbatches against one batch at ``tests/test_perf_opts.py``'s: loss
    within 1e-4 relative, the first parameter leaf within 5e-5.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JCKPT
from repro import flags as jflags
from repro.configs import get_config as jget_config
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch import train as jtrain
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch import checkpoint as CKPT
from repro_torch import flags
from repro_torch.checkpoint.convert import (lm_opt_state_from_numpy,
                                            lm_params_from_numpy)
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.ssm_scan import ops as WKV
from repro_torch.launch import train
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.models import stack as ST
from repro_torch.utils.tree import _leaves

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

TOL = 1e-4
NOISE_REL, NOISE_SHARE = 1e-4, 2e-3
# the dense and RWKV archs (the MoE and hybrid ones have a file of their
# own, so the two files' reference compiles run on separate workers). The
# dense archs that need more than one card in full are left out: their
# layers are qwen3-4b's kinds (QKV bias as whisper's attentions carry),
# and each would add about 80 s of reference compiles to this file, which
# alone sets the suite's wall time; they serve in tests/test_torch_lm.py.
MULTI_CARD = ("chameleon-34b", "qwen1.5-32b", "qwen2-72b")
ARCH_NAMES = sorted(n for n, c in ARCHS.items()
                    if c.moe is None and n not in MULTI_CARD)
B, S = 2, 16
# (chunked_ce, remat, nested_remat_group): the flag cases of lm_loss
LOSS_CASES = {"plain": (0, False, 1), "chunked_ce": (4, False, 1),
              "remat": (0, True, 1), "nested_remat+chunked_ce": (4, True, 2)}


@pytest.fixture(autouse=True)
def reset_flags():
    yield
    for f in (jflags, flags):
        f.set_flags(**dataclasses.asdict(f.Flags()))


def _set_flags(**kw):
    jflags.set_flags(**kw)
    flags.set_flags(**kw)


def _pair(arch, n_layers=None):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    jparams = JM.init_lm(jcfg, jax.random.PRNGKey(0))
    tparams = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, seed, batch=B, seq=S):
    """Token ids and labels of ``cfg``'s vocab, and for an enc-dec model
    (batch, 24, d) frame embeddings, the reference drivers' frame count."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab, (batch, seq + 1))
    out = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    if cfg.layout == "encdec":
        out["frames"] = (0.02 * rng.standard_normal(
            (batch, 24, cfg.d_model))).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}".lstrip(".")))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix: np.asarray(tree, np.float32)}


def _close_tree(got, ref, what):
    """Each tensor within TOL of the reference, relative to its largest
    entry."""
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        scale = max(np.abs(ref[k]).max(), 1.0)
        np.testing.assert_allclose(got[k], ref[k], atol=TOL * scale,
                                   rtol=TOL, err_msg=f"{what} {k}")


def _state_close(tp, to, jp, jo):
    """Parameters and Adam state after one step from one state: m and v
    within TOL of each tensor's largest entry; parameters within TOL,
    except entries at the noise floor (m apart by more than NOISE_REL of
    it), which are counted apart: at most NOISE_SHARE of the tree.
    Returns that count."""
    for name in ("m", "v"):
        _close_tree(to[name], jo[name], f"adam {name}")
    assert int(to["t"]) == int(jo["t"])
    tp, jp = _flat(tp), _flat(jp)
    tm, jm = _flat(to["m"]), _flat(jo["m"])
    n_noise = n_all = 0
    for k in jp:
        noise = np.abs(tm[k] - jm[k]) > NOISE_REL * np.abs(jm[k])
        outside = ~np.isclose(tp[k], jp[k], atol=TOL, rtol=TOL)
        assert not (outside & ~noise).any(), (
            k, np.abs(tp[k] - jp[k])[outside & ~noise].max())
        n_noise += int((outside & noise).sum())
        n_all += noise.size
    assert n_noise <= NOISE_SHARE * n_all, (n_noise, n_all)
    return n_noise


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_lm_loss_and_grads_match_reference(arch, case, monkeypatch):
    """``lm_loss`` and every gradient against ``jax.value_and_grad`` of the
    reference's, with chunked CE, remat and nested remat (at 8 layers, so
    groups of 2 repeats nest: the port checkpoints the groups)."""
    ce, remat, group = LOSS_CASES[case]
    jcfg, tcfg, jparams, tparams = _pair(arch, 8 if group > 1 else None)
    _set_flags(chunked_ce=ce, nested_remat_group=group)
    batch = _batch(tcfg, 1)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.lm_loss(jcfg, p, _j(batch), remat=remat),
        has_aux=True))(jparams)
    calls = []
    checkpoint = ST._checkpoint
    monkeypatch.setattr(ST, "_checkpoint", lambda fn, *a: (
        calls.append(fn.__name__), checkpoint(fn, *a))[1])
    (tl, taux), tg = loss_and_grads(tcfg, tparams, _t(batch), remat=remat)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    assert sorted(taux) == sorted(jaux) == ["lb", "z"]
    for k in taux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=TOL,
                                   err_msg=k)
    assert (float(taux["lb"]) > 0) == (tcfg.moe is not None)
    _close_tree(tg, jg, "grad")
    # the reference's condition: a segment whose repeats g divides, more
    # than g of them (deepseek's 1 + 7 and jamba's one 8-layer body: none)
    nests = group > 1 and any(reps % group == 0 and reps > group
                              for _, reps, _ in ST.build_segments(tcfg))
    assert ("group" in calls) == nests
    assert ("body" in calls) == remat


@pytest.mark.parametrize("S,W,qc", [(64, 0, 16), (64, 12, 16),
                                    (96, 24, 32), (100, 7, 32)])
def test_blockwise_sdpa_matches_reference(S, W, qc):
    """The reference's shapes and tolerance (``test_perf_opts.py``):
    against the reference's ``blockwise_sdpa`` and the port's own masked
    ``sdpa``."""
    rng = np.random.default_rng(S + W)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, 2, 16)).astype(np.float32)
            for _ in range(2))
    y = A.blockwise_sdpa(*map(torch.tensor, (q, k, v)), 2, causal=True,
                         window=W, q_chunk=qc)
    y_ref = JA.blockwise_sdpa(q, k, v, 2, causal=True, window=W, q_chunk=qc)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=2e-5)
    mask = A.causal_window_mask(S, W)[None]
    y_full = A.sdpa(*map(torch.tensor, (q, k, v)), mask, 2)
    np.testing.assert_allclose(y.numpy(), y_full.numpy(), atol=2e-5)


def test_blockwise_flag_routes_the_plain_path(monkeypatch):
    """``blockwise_prefill`` takes ``blockwise_sdpa`` on the plain path at
    Sq >= 2048 (the reference's condition), with the same output as the
    masked ``sdpa``; below 2048 it does not."""
    _, tcfg, _, tparams = _pair("gemma3-27b")
    calls = []
    blockwise = A.blockwise_sdpa
    monkeypatch.setattr(A, "blockwise_sdpa", lambda *a, **k: (
        calls.append(k["q_chunk"]), blockwise(*a, **k))[1])
    p = ST._index(tparams["segments"]["seg0"], 0)["s0"]
    kind = ST.build_segments(tcfg)[0][2][0]
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        (1, 2048, tcfg.d_model)).astype(np.float32))
    ctx = ST.Ctx(mode="full", plain_kernels=True)
    with torch.no_grad():
        y0, _, _ = ST.apply_layer_full(tcfg, kind, p, x, ctx)
        flags.set_flags(blockwise_prefill=True, q_chunk=256)
        y1, _, _ = ST.apply_layer_full(tcfg, kind, p, x, ctx)
        assert calls == [256]
        ST.apply_layer_full(tcfg, kind, p, x[:, :2047], ctx)
    assert calls == [256]
    torch.testing.assert_close(y1, y0, atol=2e-4, rtol=1e-4)


def _stub_card_path(monkeypatch):
    """Route the model's flash and wkv calls to the wrappers' card paths
    (``_on_card``) on CPU tensors, each launch stubbed by a plain
    computation whose outputs are detached, as a ctypes launch's are."""
    def fa_launch(q, k, v, causal, window, want_lse=False):
        o = FA.attention_ref(q, k, v, causal=causal, window=window).detach()
        return (o, torch.zeros(q.shape[:3])) if want_lse else o

    def fa_launch_bwd(q, k, v, o, lse, do, causal, window):
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(FA.attention_ref(
                *xs, causal=causal, window=window), xs, do)

    def wkv_launch(*args):
        return tuple(t.detach() for t in WKV.wkv_ref(*args)) + (None,)

    def wkv_launch_bwd(r, k, v, w, u, dy, dS, states):
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in (r, k, v, w, u)]
            return torch.autograd.grad(WKV.wkv_ref(*xs)[0], xs, dy)

    monkeypatch.setattr(FA, "_launch", fa_launch)
    monkeypatch.setattr(FA, "_launch_bwd", fa_launch_bwd)
    monkeypatch.setattr(WKV, "_launch", wkv_launch)
    monkeypatch.setattr(WKV, "_launch_bwd", wkv_launch_bwd)
    monkeypatch.setattr(A, "FA", SimpleNamespace(
        flash_attention=lambda q, k, v, causal=True, window=0:
        FA._on_card(q, k, v, causal, window)))
    monkeypatch.setattr(SSM, "WKV", SimpleNamespace(wkv=WKV._on_card))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_card_path_gradients_reach_every_projection(arch, remat,
                                                    monkeypatch):
    """On the card a kernel's output comes from a ctypes launch with no
    ``grad_fn``, so before the autograd functions a loss through the
    kernels got no gradient for wq, wk, wv or the RWKV time-mix
    projections (the residual stream still carried one: nothing raised).
    With the launches stubbed on CPU tensors, the card path's gradients
    equal the plain path's for every parameter (whisper's encoder's
    included, each nonzero, the key biases aside: cross-attention's dk
    and dv reach the encoder), and the kernels launch as stated: per step, L forward
    launches (2L with remat) and L backward, L the layers of the kernel's
    kind (a Mamba layer launches neither; a whisper decoder layer launches
    flash twice, self and cross)."""
    _, tcfg, _, tparams = _pair(arch)
    batch = _t(_batch(tcfg, 8))
    (ref_loss, _), ref = loss_and_grads(tcfg, tparams, batch, remat=remat)
    _stub_card_path(monkeypatch)
    kernel = FA.flash_attention if tcfg.attn is not None else WKV.wkv
    before = (kernel.launches, kernel.bwd_launches)
    (loss, _), got = loss_and_grads(tcfg, tparams, batch, remat=remat)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    _close_tree(got, ref, "grad")
    proj = ("attn.wq.w", "attn.wk.w", "attn.wv.w") if tcfg.attn else (
        "tmix.wr.w", "tmix.wk.w", "tmix.wv.w", "tmix.wa.w", "tmix.u")
    if tcfg.layout == "encdec":
        proj += tuple(f"{a}.w{p}.w" for a in ("self", "cross")
                      for p in "qkv")
    flat = _flat(got)
    for name in proj:
        hits = [k for k in flat if k.endswith(name)]
        assert hits and all(np.abs(flat[k]).max() > 0 for k in hits), name
    # whisper's encoder: every gradient nonzero but the key biases', which
    # are zero to f32 rounding (softmax ignores a shift of a logit row)
    enc = [k for k in flat if k.startswith("enc.")]
    largest = max(np.abs(v).max() for v in flat.values())
    for k in enc:
        m = np.abs(flat[k]).max()
        assert (m <= 1e-6 * largest) if k.endswith(".wk.b") else m > 0, k
    assert bool(enc) == (tcfg.layout == "encdec")
    kinds = [k[0] for _, reps, body in ST.build_segments(tcfg)
             for k in body for _ in range(reps)]
    L = (ST.attention_calls(tcfg) if tcfg.attn is not None
         else kinds.count("rwkv"))
    assert (kernel.launches - before[0], kernel.bwd_launches - before[1]) == (
        (2 if remat else 1) * L, L)
