"""The port's LLM serving path against the reference, on the CPU, at the
reduced configs of qwen3-4b (dense GQA, qk-norm, RoPE), rwkv6-1.6b
(RWKV6 time-mix and channel-mix), gemma3-27b (a window-8 local layer
with a ring cache, then a global layer), deepseek-moe-16b (a dense layer,
then a MoE layer with a shared expert), llama4-scout-17b-a16e (a local
and a global attention layer, MoE top-1 with a shared expert),
jamba-1.5-large-398b (8 layers: Mamba with dense and MoE FFNs, the
attention layer at position 4), whisper-small (2 encoder and 2
decoder layers, 24 frames; more in ``tests/test_torch_whisper.py``) and
the multi-card dense archs qwen2-72b (GQA, QKV bias), qwen1.5-32b (MHA,
QKV bias) and chameleon-34b (GQA, qk-norm).

Both packages run the same parameters: the reference's ``init_lm`` tree,
converted with ``checkpoint.convert.lm_params_from_numpy``, and the same
token ids (and, for whisper, frame embeddings) from numpy. The reference runs its own model code (plain
``sdpa``, its own RWKV scan); the port runs its kernels' wrappers, which
take their plain versions on CPU tensors.

Tolerance: 1e-4 (atol and rtol) for logits, hidden states and caches in
f32 (measured at most 7e-6 on the prefill logits); the reference's own
prefill/decode check uses 2e-3 / 1e-3 (``tests/test_smoke_archs.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.steps import make_decode_step as jdecode_step
from repro.launch.steps import make_prefill_step as jprefill_step
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import stack as JST
from repro_torch.checkpoint.convert import lm_params_from_numpy
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.ssm_scan import ops as WKV
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import stack as ST

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

TOL = 1e-4
ARCH_NAMES = sorted(ARCHS)
PROMPT, NEW = 12, 4          # gemma3's window of 8 makes its cache a ring
FRAMES = 24                  # whisper's frames (the reference drivers')


@pytest.fixture(scope="module", params=ARCH_NAMES)
def pair(request):
    """(reference cfg, port cfg, reference params, port params, prompts,
    frames: an enc-dec model's (2, FRAMES, d) embeddings, else None)."""
    jcfg = jget_config(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    jparams = JM.init_lm(jcfg, jax.random.PRNGKey(0))
    tparams = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, tcfg.vocab, (2, PROMPT + NEW))
    frames = None
    if tcfg.layout == "encdec":
        frames = (0.02 * rng.standard_normal(
            (2, FRAMES, tcfg.d_model))).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, ids, frames


def _jf(frames):
    return None if frames is None else jnp.asarray(frames)


def _tf(frames):
    return None if frames is None else torch.tensor(frames)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}".lstrip(".")))
        return out
    return {prefix: np.asarray(tree.float() if isinstance(tree, torch.Tensor)
                               else tree)}


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL, err_msg=what)


def test_configs_match_reference():
    for name in ARCH_NAMES:
        assert repr(get_config(name)) == repr(jget_config(name))
        assert repr(get_config(name).reduced()) == repr(
            jget_config(name).reduced())
        assert get_config(name).param_count() == jget_config(
            name).param_count()
        assert ST.build_segments(get_config(name)) == JST.build_segments(
            jget_config(name))


def test_unported_archs_name_their_roadmap_item():
    """Every arch of the reference is ported: the multi-card dense archs
    (queue 1 item 5) resolve to the reference's configs, and only an
    unknown name raises. whisper-small and its enc-dec kinds are ported;
    a kind the stack does not know raises ``ValueError``."""
    assert get_config("whisper-small").layout == "encdec"
    assert ARCH_NAMES == sorted(jget_config(n).name for n in ARCH_NAMES)
    for name in ("qwen2-72b", "qwen1.5-32b", "chameleon-34b"):
        assert repr(get_config(name)) == repr(jget_config(name))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    cfg = get_config("whisper-small").reduced()
    cache = ST.init_layer_cache(cfg, ("dec",), 1, 4, torch.float32,
                                enc_len=6)
    assert cache["cross"]["k"].shape == (1, 6, 4, 64)
    with pytest.raises(ValueError):
        ST.init_layer_cache(cfg, ("nope",), 1, 4, torch.float32)
    with pytest.raises(ValueError):
        ST.init_layer(L.Init(None, device=torch.device("meta")), cfg,
                      ("nope",))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_layers_match_reference(act):
    """The primitives on one input, including what no ported arch reaches
    (dense bias, the tanh-GELU MLP, the tied unembedding, layernorm with
    a non-trivial scale and bias)."""
    rng = np.random.default_rng(4)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x, pos = f(2, 5, 3, 16), np.arange(5)[None].repeat(2, 0)
    norm = {"scale": f(16), "bias": f(16)}
    mlp = {k: {"w": f(16, 24) if k != "wd" else f(24, 16),
               "b": f(24) if k != "wd" else f(16)}
           for k in (("wg", "wu", "wd") if act == "swiglu" else ("wu", "wd"))}
    emb = {"table": f(40, 16)}
    t = lambda tree: jax.tree.map(torch.tensor, tree)
    cos, sin = L.rope_angles(torch.tensor(pos), 16, 1e6)
    jcos, jsin = JL.rope_angles(jnp.asarray(pos), 16, 1e6)
    pairs = [
        (L.rmsnorm(t(norm), torch.tensor(x)), JL.rmsnorm(norm, x)),
        (L.layernorm(t(norm), torch.tensor(x)), JL.layernorm(norm, x)),
        (L.apply_rope(torch.tensor(x), cos, sin), JL.apply_rope(x, jcos, jsin)),
        (L.mlp(t(mlp), torch.tensor(x), act), JL.mlp(mlp, x, act)),
        (L.unembed(t(emb), torch.tensor(x)), JL.unembed(emb, x)),
        (L.embed(t(emb), torch.tensor(pos)), JL.embed(emb, pos)),
        (L.sinusoidal_positions(torch.tensor(pos * 37), 16),
         JL.sinusoidal_positions(jnp.asarray(pos * 37), 16)),
    ]
    for i, (got, ref) in enumerate(pairs):
        _close(got, ref, f"layer {i}")


def test_init_cache_matches_reference(pair):
    """``init_cache``: the same tree of zeros, window-sized for a local
    layer."""
    jcfg, tcfg, _, _, _, _ = pair
    ref = _leaves(JM.init_cache(jcfg, 2, 20))
    got = _leaves(M.init_cache(tcfg, 2, 20, device="cpu"))
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in ref.items()}
    assert all(not v.any() for v in got.values())


def test_params_round_trip(pair):
    """Every reference leaf lands under the same dotted name with the same
    values; the port's own ``init_lm`` gives the same names and shapes; a
    missing key or a wrong shape is refused."""
    jcfg, tcfg, jparams, tparams, _, _ = pair
    ref, got = _leaves(jparams), _leaves(tparams)
    assert sorted(ref) == sorted(got)
    assert any(k.startswith("segments.") and k.endswith(".w") for k in got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    own = _leaves(M.init_lm(tcfg, 0, device="cpu"))
    assert {k: v.shape for k, v in own.items()} == {
        k: v.shape for k, v in ref.items()}
    bad = jax.tree.map(np.asarray, jparams)
    bad.pop("final_norm")
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(tcfg, bad, device="cpu")
    bad = jax.tree.map(np.asarray, jparams)
    bad["embed"]["table"] = bad["embed"]["table"][:-1]
    with pytest.raises(ValueError, match="embed.table"):
        lm_params_from_numpy(tcfg, bad, device="cpu")


def test_forward_logits_match_reference(pair):
    """Logits and the auxiliary losses (nonzero with MoE layers)."""
    jcfg, tcfg, jparams, tparams, ids, frames = pair
    jl, _, jaux = JM.forward(jcfg, jparams, jnp.asarray(ids), _jf(frames))
    tl, cache, aux = M.forward(tcfg, tparams, torch.tensor(ids), _tf(frames))
    assert cache is None and tl.dtype == torch.float32
    assert sorted(aux) == sorted(jaux) == ["lb", "z"]
    for k in aux:
        _close(aux[k], jaux[k], f"aux {k}")
    assert (float(aux["lb"]) > 0) == (tcfg.moe is not None)
    assert tl.shape == (2, PROMPT + NEW, tcfg.vocab)
    _close(tl, jl, "logits")


def test_plain_kernels_switch_runs_the_reference_path(pair):
    """``plain_kernels=True`` swaps the kernels' wrappers for the model's
    own plain attention / recurrence; on the CPU both are plain, so the
    hidden states agree to f32 rounding."""
    _, tcfg, _, tparams, ids, frames = pair
    h, _, _ = M.forward_hidden(tcfg, tparams, torch.tensor(ids), _tf(frames))
    hp, _, _ = M.forward_hidden(tcfg, tparams, torch.tensor(ids), _tf(frames),
                                plain_kernels=True)
    torch.testing.assert_close(h, hp, atol=TOL, rtol=TOL)


def test_prefill_cache_and_teacher_forced_decode_match_reference(pair):
    """The cache after a prefill of PROMPT tokens, then NEW decode steps
    fed the same next tokens in both packages: logits and caches agree
    at every step (gemma3's local layer runs a ring cache; whisper's
    decoder layers a self and a cross cache)."""
    jcfg, tcfg, jparams, tparams, ids, frames = pair
    cache_len = PROMPT + NEW
    jl, jcache, _ = JM.forward(jcfg, jparams, jnp.asarray(ids[:, :PROMPT]),
                               _jf(frames), want_cache=True,
                               cache_len=cache_len)
    tl, tcache, _ = M.forward(tcfg, tparams, torch.tensor(ids[:, :PROMPT]),
                              _tf(frames), want_cache=True,
                              cache_len=cache_len)
    _close(tl, jl, "prefill logits")
    ref, got = _leaves(jcache), _leaves(tcache)
    assert sorted(ref) == sorted(got)
    for k in ref:
        _close(got[k], ref[k], f"prefill cache {k}")
    for i in range(NEW):
        pos = PROMPT + i
        tok = ids[:, pos:pos + 1]
        jl, jcache = JM.decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                                    jnp.int32(pos), cache_len)
        tl, tcache = M.decode_step(tcfg, tparams, torch.tensor(tok), tcache,
                                   pos, cache_len)
        _close(tl, jl, f"decode logits at {pos}")
        ref, got = _leaves(jcache), _leaves(tcache)
        for k in ref:
            _close(got[k], ref[k], f"decode cache {k} at {pos}")


def test_prefill_calls_each_kernel_once_per_layer(pair, monkeypatch):
    """Every full-sequence attention of the prefill goes through the flash
    wrapper (whisper: one per encoder layer and two per decoder layer,
    self and cross) and every RWKV time-mix through the wkv wrapper
    (counted by wrapping them: on the CPU the kernels' counters stay 0);
    a Mamba layer calls neither; decode calls neither."""
    _, tcfg, _, tparams, ids, frames = pair
    calls = {"flash": 0, "wkv": 0}

    def counted(fn, name):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(FA, "flash_attention",
                        counted(FA.flash_attention, "flash"))
    monkeypatch.setattr(WKV, "wkv", counted(WKV.wkv, "wkv"))
    kinds = [k[0] for _, reps, body in ST.build_segments(tcfg)
             for k in body for _ in range(reps)]
    want = {"flash": (kinds.count("attn") + tcfg.n_encoder_layers
                      + 2 * kinds.count("dec")), "wkv": kinds.count("rwkv")}
    assert want["flash"] == ST.attention_calls(tcfg)
    assert len(kinds) == tcfg.n_layers and sum(want.values()) > 0
    prefill = serve.make_prefill_step(tcfg, PROMPT + NEW)
    batch = {"tokens": torch.tensor(ids[:, :PROMPT])}
    if frames is not None:
        batch["frames"] = torch.tensor(frames)
    tok, cache = prefill(tparams, batch)
    assert calls == want
    decode = serve.make_decode_step(tcfg, PROMPT + NEW)
    for i in range(NEW - 1):
        tok, cache = decode(tparams, cache, tok, PROMPT + i)
    assert calls == want


def test_serve_main_generates_the_reference_ids(pair):
    """``serve.main`` on the CPU with the reference's parameters and the
    same prompts (and frames) gives the reference's greedy ids (its
    prefill and decode steps), with the shape and id range
    ``test_system.py`` asserts."""
    jcfg, tcfg, jparams, tparams, ids, frames = pair
    B, P, N = 2, PROMPT, NEW + 2
    gen = serve.main(["--arch", tcfg.name.removesuffix("-reduced"),
                      "--batch", str(B), "--prompt-len", str(P), "--tokens",
                      str(N), "--device", "cpu"],
                     prompts=ids[:, :P], params=tparams, frames=frames)
    assert gen.shape == (B, N)
    assert (gen >= 0).all() and (gen < tcfg.vocab).all()
    prefill = jprefill_step(jcfg, P + N)
    decode = jdecode_step(jcfg, P + N)
    jbatch = {"tokens": jnp.asarray(ids[:, :P])}
    if frames is not None:
        jbatch["frames"] = jnp.asarray(frames)
    tok, cache = prefill(jparams, jbatch)
    out = [tok]
    for i in range(N - 1):
        tok, cache = decode(jparams, cache, tok, jnp.int32(P + i))
        out.append(tok)
    np.testing.assert_array_equal(gen, np.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "gemma3-27b"])
def test_serve_main_seeded_draws(arch, capsys):
    """With its own seeded parameters and prompts (the reference system
    test's arguments), on the CPU: the reported shape and id range."""
    gen = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "8",
                      "--tokens", "6", "--device", "cpu"])
    assert gen.shape == (2, 6)
    vocab = get_config(arch).reduced().vocab
    assert (gen >= 0).all() and (gen < vocab).all()
    out = capsys.readouterr().out
    assert "prefill 2x8" in out and "tok/s" in out and "sample ids" in out


def test_serve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-4b", "--batch", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_lm(get_config("qwen3-4b").reduced(), 0)
