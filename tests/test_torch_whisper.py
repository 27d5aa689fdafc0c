"""The port's enc-dec path (whisper-small) against the reference, on the
CPU, at the reduced config (2 encoder and 2 decoder layers, d_model 256,
4 heads of 64) with 24 frames: the audio frontend stub, the attention
variants (non-causal, RoPE-free, cross-attention, cross decode),
``encode``, the blockwise flag on non-causal calls, the cross cache
through decode, ``serve.main`` and ``launch.train.main``, and the
microbatched step's split of the frames. The flash kernel's arithmetic
(emulated in plain torch, forward and backward) is held against the
reference's Pallas kernel and ``jax.vjp`` at whisper's kinds of call:
dh = 64, non-causal, Sq ≠ Skv, Skv off every tile multiple.

Both packages run the same parameters (the reference's ``init_lm`` tree
converted with ``lm_params_from_numpy``) on the same numpy-drawn ids and
frames. Tolerance: 1e-4 (atol and rtol), that of ``tests/test_torch_lm.py``;
10x the reference's f32 kernel tolerance for the flash emulation and
``tests/test_torch_flash_attention.py``'s gradient tolerance for its
backward, as that file holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import flags as jflags
from repro.configs import get_config as jget_config
from repro.configs import whisper_small as jwhisper
from repro.kernels.flash_attention import flash_attention as jflash
from repro.launch import train as jtrain
from repro.launch.steps import make_decode_step as jdecode_step
from repro.launch.steps import make_prefill_step as jprefill_step
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import attention as JA
from repro.models import frontend as JF
from repro.models import model as JM
from repro_torch import flags
from repro_torch.checkpoint.convert import lm_params_from_numpy
from repro_torch.configs import get_config, whisper_small
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention as A
from repro_torch.models import frontend as F
from repro_torch.models import model as M
from repro_torch.models import stack as ST
from test_torch_flash_attention import (TOL as FLASH_TOL,
                                        _kernel_emulation, _np)
from test_torch_flash_bwd_f32 import (_bwd_emulation, _close_grads,
                                      _grad_inputs, _reference_grads)
from test_torch_lm import _close, _leaves

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

ARCH = "whisper-small"
TOL = 1e-4
FRAMES, PROMPT, NEW = 24, 10, 4


@pytest.fixture(autouse=True)
def reset_flags():
    yield
    for f in (jflags, flags):
        f.set_flags(**dataclasses.asdict(f.Flags()))


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, port cfg, reference params, port params, ids,
    frames)."""
    jcfg, tcfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jparams = JM.init_lm(jcfg, jax.random.PRNGKey(0))
    tparams = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, tcfg.vocab, (2, PROMPT + NEW))
    frames = (0.02 * rng.standard_normal((2, FRAMES, tcfg.d_model))).astype(
        np.float32)
    return jcfg, tcfg, jparams, tparams, ids, frames


def _attn_params(seed, d, a):
    """One attention's parameters with nonzero biases, both packages."""
    jp = JA.init_attn(jax.random.PRNGKey(seed), d, a, jnp.float32)
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.standard_normal(
        x.shape).astype(np.float32) * (x.ndim == 1), jp)
    return jp, jax.tree.map(torch.tensor, jp)


# ----------------------------------------------------------------- frontend
def test_frontend_matches_reference():
    """``AUDIO_FRAMES`` (the config's and the frontend's), the sinusoidal
    ``add_positions`` in x's dtype, and the frame spec's shape and dtype
    on the meta device."""
    assert F.AUDIO_FRAMES == JF.AUDIO_FRAMES == 1500
    assert whisper_small.AUDIO_FRAMES == jwhisper.AUDIO_FRAMES == 1500
    x = np.random.default_rng(1).standard_normal((2, 37, 48)).astype(
        np.float32)
    _close(F.add_positions(torch.tensor(x)), JF.add_positions(x),
           "add_positions")
    xb = F.add_positions(torch.tensor(x).bfloat16())
    assert xb.dtype == torch.bfloat16
    spec = F.audio_frames_spec(4, 768)
    jspec = JF.audio_frames_spec(4, 768)
    assert tuple(spec.shape) == tuple(jspec.shape) == (4, 1500, 768)
    assert spec.dtype == torch.bfloat16 and spec.device.type == "meta"
    assert F.audio_frames_spec(1, 8, torch.float32).dtype == torch.float32


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("variant", ["encoder", "decoder_self", "cross",
                                     "plain_cross"])
def test_attention_variants_match_reference(variant):
    """Non-causal RoPE-free self-attention (the encoder), causal RoPE-free
    self-attention (the decoder), and cross-attention with Sq ≠ Skv, both
    through the kernel's wrapper (its plain version on the CPU) and with
    ``plain``; y and the cache material k, v."""
    a = get_config(ARCH).reduced().attn
    d = 96
    jp, tp = _attn_params(3, d, a)
    rng = np.random.default_rng(5)
    Sq, Skv = (13, 13) if variant in ("encoder", "decoder_self") else (7, 29)
    x = rng.standard_normal((2, Sq, d)).astype(np.float32)
    kv = rng.standard_normal((2, Skv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq), (2, Sq))
    kpos = np.broadcast_to(np.arange(Skv), (2, Skv))
    kw = dict(causal=variant == "decoder_self", use_rope=False)
    jkw, tkw = dict(kw), dict(kw, plain=variant == "plain_cross")
    if variant in ("cross", "plain_cross"):
        jkw.update(kv_x=kv, kv_positions=kpos)
        tkw.update(kv_x=torch.tensor(kv), kv_positions=torch.tensor(kpos))
    jy, (jk, jv) = JA.full_attention(jp, a, x, pos, **jkw)
    ty, (tk, tv) = A.full_attention(tp, a, torch.tensor(x),
                                    torch.tensor(pos), **tkw)
    assert tuple(tk.shape) == (2, Skv, a.n_kv_heads, a.d_head)
    for got, ref, what in ((ty, jy, "y"), (tk, jk, "k"), (tv, jv, "v")):
        _close(got, ref, f"{variant} {what}")


@pytest.mark.parametrize("cross", [False, True])
def test_decode_attention_variants_match_reference(cross):
    """RoPE-free decode: a self-attention step writes its slot; a cross
    step reads the encoder's K/V and leaves the cache as it was."""
    a = get_config(ARCH).reduced().attn
    d, W, pos = 96, 11, 6
    jp, tp = _attn_params(4, d, a)
    rng = np.random.default_rng(6)
    x1 = rng.standard_normal((2, 1, d)).astype(np.float32)
    cache = {n: rng.standard_normal((2, W, a.n_kv_heads, a.d_head)).astype(
        np.float32) for n in ("k", "v")}
    tcache = {n: torch.tensor(c) for n, c in cache.items()}
    before = {n: c.clone() for n, c in tcache.items()}
    jy, jc = JA.decode_attention(jp, a, x1, jnp.int32(pos), cache,
                                 use_rope=False, cross=cross)
    ty, tc = A.decode_attention(tp, a, torch.tensor(x1), pos, tcache,
                                use_rope=False, cross=cross)
    _close(ty, jy, "y")
    for n in ("k", "v"):
        _close(tc[n], jc[n], f"cache {n}")
    if cross:
        assert tc is tcache
        assert all(torch.equal(tcache[n], before[n]) for n in ("k", "v"))
    else:
        assert not torch.equal(tcache["k"][:, pos], before["k"][:, pos])


# (B, H, KV, Sq, Skv, dh, block_kv of the reference's kernel): whisper's
# kinds of call at test size. Skv = 150 is off the kernel's kv tiles (32 in
# f32) and the backward's key blocks (128); block_kv divides Skv, as the
# reference's non-causal path requires.
WHISPER_CALLS = [(1, 4, 4, 150, 150, 64, 50),    # encoder self
                 (2, 4, 4, 45, 150, 64, 50),     # cross, Sq < Skv
                 (1, 2, 2, 70, 75, 64, 25)]


@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,bkv", WHISPER_CALLS)
def test_flash_arithmetic_at_whisper_calls(B, H, KV, Sq, Skv, dh, bkv):
    """The plain version and the emulated kernel arithmetic (split TF32,
    kv tiles of 32), non-causal, against the reference's Pallas kernel in
    interpret mode; the emulated backward kernel against ``jax.vjp`` of
    the reference's oracle."""
    jargs, args, do = _grad_inputs(B, H, KV, Sq, Skv, dh, seed=Sq + Skv)
    o_ref = _np(jflash(*jargs, causal=False, block_q=32, block_kv=bkv,
                       interpret=True))
    tol = 10 * FLASH_TOL["float32"]
    for got in (flash_attention(*args, causal=False),
                _kernel_emulation(*args, causal=False, window=0)):
        np.testing.assert_allclose(_np(got), o_ref, atol=tol, rtol=tol)
    got = _bwd_emulation(*args, torch.tensor(do), False, 0)
    _close_grads(got, _reference_grads(jargs, do, False, 0))


def test_blockwise_flag_is_not_taken_by_non_causal_calls(monkeypatch):
    """``blockwise_prefill`` at Sq >= 2048: a causal call on the plain path
    takes ``blockwise_sdpa``; a non-causal one (an encoder layer, through
    the wrapper or ``plain``) never does, as in the reference, and matches
    the full non-causal ``sdpa``."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), d_model=32,
                              attn=dataclasses.replace(
                                  get_config(ARCH).reduced().attn,
                                  n_heads=2, n_kv_heads=2, d_head=16))
    calls = []
    blockwise = A.blockwise_sdpa
    monkeypatch.setattr(A, "blockwise_sdpa", lambda *a, **k: (
        calls.append(k["causal"]), blockwise(*a, **k))[1])
    flags.set_flags(blockwise_prefill=True, q_chunk=512)
    params = M.init_lm(cfg, 0, device="cpu")
    p = ST._index(params["enc"]["segments"]["enc"], 0)["s0"]
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        (1, 2048, cfg.d_model)).astype(np.float32))
    pos = torch.arange(2048).expand(1, 2048)
    with torch.no_grad():
        for plain in (False, True):
            y, _, _ = ST.apply_layer_full(
                cfg, ("enc",), p, x, ST.Ctx(plain_kernels=plain))
            assert torch.isfinite(y).all()
        assert calls == []
        h = torch.nn.functional.layer_norm(x, (cfg.d_model,))
        y_nc, _ = A.full_attention(p["attn"], cfg.attn, h, pos,
                                   causal=False, use_rope=False,
                                   blockwise=True, plain=True)
        assert calls == []
        q = A._project_q(p["attn"], cfg.attn, h, pos, False)
        k, v = A._project_kv(p["attn"], cfg.attn, h, pos, False)
        ref = A.L.dense(p["attn"]["wo"], A.sdpa(q, k, v, None, 2))
        torch.testing.assert_close(y_nc, ref, atol=1e-5, rtol=1e-5)
        A.full_attention(p["attn"], cfg.attn, h, pos, causal=True,
                         use_rope=False, blockwise=True)
    assert calls == [True]


# ------------------------------------------------------------------- model
def test_encode_matches_reference(pair):
    """``encode`` (positions, the non-causal encoder layers, ``ln_post``),
    through the wrapper and with ``plain_kernels``."""
    jcfg, tcfg, jparams, tparams, _, frames = pair
    ref = JM.encode(jcfg, jparams, jnp.asarray(frames))
    for plain in (False, True):
        got = M.encode(tcfg, tparams, torch.tensor(frames),
                       plain_kernels=plain)
        assert got.shape == (2, FRAMES, tcfg.d_model)
        _close(got, ref, f"encode plain={plain}")


def test_encdec_needs_frames(pair):
    _, tcfg, _, tparams, ids, _ = pair
    with pytest.raises(ValueError, match="frames"):
        M.forward(tcfg, tparams, torch.tensor(ids))


def test_cross_cache_is_unchanged_by_decode(pair):
    """The prefill's cross caches hold the encoder's projected K/V
    (FRAMES long, equal to the reference's); decode writes each self
    cache's slot and leaves every cross cache bit for bit as it was."""
    jcfg, tcfg, jparams, tparams, ids, frames = pair
    cache_len = PROMPT + NEW
    _, tcache, _ = M.forward(tcfg, tparams, torch.tensor(ids[:, :PROMPT]),
                             torch.tensor(frames), want_cache=True,
                             cache_len=cache_len)
    _, jcache, _ = JM.forward(jcfg, jparams, jnp.asarray(ids[:, :PROMPT]),
                              jnp.asarray(frames), want_cache=True,
                              cache_len=cache_len)
    cross = {k: v.clone() for k, v in _named_cross(tcache)}
    assert cross and all(v.shape[2] == FRAMES for v in cross.values())
    ref = _leaves(jcache)
    for k, v in cross.items():
        _close(v, ref[k], f"cross cache {k}")
    selfk = tcache["dec"]["s0"]["self"]["k"].clone()
    for i in range(NEW):
        pos = PROMPT + i
        M.decode_step(tcfg, tparams, torch.tensor(ids[:, pos:pos + 1]),
                      tcache, pos, cache_len)
    for k, v in _named_cross(tcache):
        assert torch.equal(v, cross[k]), k
    assert not torch.equal(tcache["dec"]["s0"]["self"]["k"], selfk)


def _named_cross(cache):
    return [(k, v) for k, v in _leaves_t(cache) if ".cross." in k]


def _leaves_t(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_t(v, f"{prefix}.{k}".lstrip("."))
    else:
        yield prefix, tree


def test_init_cache_takes_enc_len(pair):
    """``init_cache(..., enc_len=)``: the reference's tree and shapes, the
    cross caches enc_len long; without it, the reference's default 0."""
    jcfg, tcfg, _, _, _, _ = pair
    for kw in ({}, {"enc_len": FRAMES}):
        ref = _leaves(JM.init_cache(jcfg, 2, 20, **kw))
        got = _leaves(M.init_cache(tcfg, 2, 20, device="cpu", **kw))
        assert {k: v.shape for k, v in got.items()} == {
            k: v.shape for k, v in ref.items()}
    assert got["dec.s0.cross.k"].shape[2] == FRAMES


def test_convert_names_encoder_paths(pair):
    """The reference's whisper tree converts (``enc`` included); a missing
    or extra encoder key is refused with its dotted path."""
    _, tcfg, jparams, tparams, _, _ = pair
    assert "enc.ln_post.scale" in _leaves(tparams)
    bad = jax.tree.map(np.asarray, jparams)
    bad["enc"].pop("ln_post")
    with pytest.raises(ValueError, match=r"missing \['enc.ln_post'\]"):
        lm_params_from_numpy(tcfg, bad, device="cpu")
    bad = jax.tree.map(np.asarray, jparams)
    bad["enc"]["segments"]["enc"]["s0"]["extra"] = np.zeros(1)
    with pytest.raises(ValueError, match=r"unexpected \['enc.segments.enc"
                                         r".s0.extra'\]"):
        lm_params_from_numpy(tcfg, bad, device="cpu")
    bad = jax.tree.map(np.asarray, jparams)
    del bad["enc"]
    with pytest.raises(ValueError, match=r"missing \['enc'\]"):
        lm_params_from_numpy(tcfg, bad, device="cpu")


# ---------------------------------------------------------------- drivers
def test_serve_main_matches_reference_ids(pair, monkeypatch):
    """``serve.main`` with the reference's parameters, prompts and frames
    gives the reference's greedy ids; with its own seeded draws, the
    reference's frame shape (B, 24, d)."""
    jcfg, tcfg, jparams, tparams, ids, frames = pair
    B, P, N = 2, PROMPT, NEW + 2
    gen = serve.main(["--arch", ARCH, "--batch", str(B), "--prompt-len",
                      str(P), "--tokens", str(N), "--device", "cpu"],
                     prompts=ids[:, :P], params=tparams, frames=frames)
    prefill, decode = jprefill_step(jcfg, P + N), jdecode_step(jcfg, P + N)
    tok, cache = prefill(jparams, {"tokens": jnp.asarray(ids[:, :P]),
                                   "frames": jnp.asarray(frames)})
    out = [tok]
    for i in range(N - 1):
        tok, cache = decode(jparams, cache, tok, jnp.int32(P + i))
        out.append(tok)
    np.testing.assert_array_equal(gen, np.concatenate(out, axis=1))
    seen = {}
    prefill_step = serve.make_prefill_step

    def spy(cfg, cache_len):
        fn = prefill_step(cfg, cache_len)

        def wrapped(params, batch):
            seen["frames"] = tuple(batch["frames"].shape)
            return fn(params, batch)
        return wrapped

    monkeypatch.setattr(serve, "make_prefill_step", spy)
    gen = serve.main(["--arch", ARCH, "--batch", "3", "--prompt-len", "5",
                      "--tokens", "3", "--device", "cpu"])
    assert gen.shape == (3, 3) and seen["frames"] == (3, 24, tcfg.d_model)
    with pytest.raises(ValueError, match="frames"):
        serve.main(["--arch", ARCH, "--batch", "2", "--device", "cpu"],
                   frames=frames[:, :, :8])


