"""Checkpoint io and exact resume in the port (``checkpoint.io``,
``engine.resume``, ROADMAP item 7) on the CPU: checkpoints cross between
the packages in both directions bit for bit (single-seed and
seed-batched payloads, identical manifests), resumed port runs equal the
uninterrupted ones bit for bit, history and snapshot offsets, cadence
re-arming, the error cases of ``tests/test_engine.py``, and a port run
resumed from a reference checkpoint tracking the reference on its
replayed draws (5e-6, the reference's training parity tolerance,
``tests/test_pallas_mix.py``).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.checkpoint import io as jio
from repro.configs import surf_paper as jcfgs
from repro.core import surf as jsurf
from repro.core import unroll as JU
from repro.data import synthetic as jsyn
from repro_torch import engine as E
from repro_torch.checkpoint import io as tio
from repro_torch.configs import surf_paper as tcfgs
from repro_torch.core import surf as tsurf

CFG, JCFG = tcfgs.SMOKE, jcfgs.SMOKE
STATE_TOL = 5e-6


@pytest.fixture(scope="module")
def mds():
    return jsyn.make_meta_dataset(JCFG, 4, seed=0)


@pytest.fixture(scope="module")
def eval_ds():
    return jsyn.make_meta_dataset(JCFG, 2, seed=99)


def _leaves_equal(jtree, ttree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = [leaf for _, leaf in tio.flatten(ttree)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        b = np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b)
        np.testing.assert_array_equal(a, np.broadcast_to(b, a.shape))


def _state_equal(a, b):
    for (pa, x), (pb, y) in zip(tio.flatten(a), tio.flatten(b)):
        assert pa == pb
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), pa
        else:
            assert x == y, pa


def _manifest(path):
    with open(path + ".json") as f:
        return json.load(f)


# ------------------------------------------- across the two packages
def test_reference_checkpoint_restores_in_port_and_back(mds, tmp_path):
    _, S = jsurf.make_problem(JCFG, seed=0)
    jstate, _ = JE.train(JCFG, S, mds, 3, jax.random.PRNGKey(0))
    jpath = JE.resume.save_state(str(tmp_path / "j"), jstate)
    tstate = E.resume.restore_state(str(tmp_path / "j"), CFG, device="cpu")
    assert tstate.step == 3 and isinstance(tstate.step, int)
    assert tstate.opt_state["t"].dtype == torch.int32
    _leaves_equal(jstate, tstate)
    tpath = E.resume.save_state(str(tmp_path / "t"), tstate)
    assert _manifest(tpath) == _manifest(jpath)
    back = JE.resume.restore_state(str(tmp_path / "t"), JCFG)
    for a, b in zip(jax.tree_util.tree_leaves(jstate),
                    jax.tree_util.tree_leaves(back)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_seed_batched_checkpoints_cross_both_ways(mds, tmp_path):
    seeds = [0, 1]
    ja, jb = str(tmp_path / "ja"), str(tmp_path / "jb")
    jstates, _, _ = jsurf.train_surf(JCFG, mds, steps=4, seeds=seeds,
                                     log_every=0, checkpoint_every=4,
                                     checkpoint_dir=ja)
    tstates = E.resume.restore_seed_states(ja, CFG, 2, device="cpu")
    assert tstates.step == 4
    _leaves_equal(jstates, tstates)
    states, _, _ = tsurf.train_surf(CFG, mds, steps=4, seeds=seeds,
                                    log_every=0, checkpoint_every=4,
                                    checkpoint_dir=jb, device="cpu")
    assert _manifest(E.resume.seed_checkpoint_path(jb, 4)) \
        == _manifest(E.resume.seed_checkpoint_path(ja, 4))
    back = JE.resume.restore_seed_states(jb, JCFG, 2)
    _leaves_equal(back, states)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_io_round_trips_and_crosses_dtypes(tmp_path, dtype):
    tree = {"a": (torch.arange(6.0) / 7).to(dtype).reshape(2, 3),
            "b": {"c": torch.zeros(2, dtype=dtype)}, "step": 5}
    tio.save(str(tmp_path / "x"), tree, step=5)
    like = {"a": torch.empty((2, 3), dtype=dtype, device="meta"),
            "b": {"c": torch.empty(2, dtype=dtype, device="meta")},
            "step": 0}
    out = tio.restore(str(tmp_path / "x"), like, device="cpu")
    assert out["step"] == 5 and out["a"].dtype == dtype
    assert torch.equal(out["a"], tree["a"])
    jlike = {"a": jnp.zeros((2, 3), {torch.float32: jnp.float32,
                                      torch.bfloat16: jnp.bfloat16,
                                      torch.int32: jnp.int32}[dtype]),
             "b": {"c": jnp.zeros(2)}, "step": jnp.zeros((), jnp.int32)}
    j = jio.restore(str(tmp_path / "x"), jlike)
    np.testing.assert_array_equal(np.asarray(j["a"], np.float32),
                                  tree["a"].float().numpy())
    assert _manifest(str(tmp_path / "x"))["leaves"][0]["dtype"] == \
        {torch.float32: "float32", torch.bfloat16: "bfloat16",
         torch.int32: "int32"}[dtype]


# ------------------------------------------------------- exact resume
def test_resume_is_bit_exact_with_offsets(mds, eval_ds, tmp_path):
    """Single seed: in-loop checkpoints, then resume from step 10 with
    history and snapshots: equal to the uninterrupted run bit for bit,
    entries at absolute steps."""
    _, S = tsurf.make_problem(CFG, 0, device="cpu")
    d = str(tmp_path)
    full, fhist, fsnaps = E.train_scan(
        CFG, S, mds, 20, seed=3, log_every=5, eval_every=4,
        eval_datasets=eval_ds, checkpoint_every=5, checkpoint_dir=d,
        device="cpu")
    plain, _ = E.train_scan(CFG, S, mds, 20, seed=3, device="cpu")
    _state_equal(full, plain)                  # saving changes nothing
    assert tio.latest_step(d) == 20
    assert sorted(int(f[5:-5]) for f in os.listdir(d)
                  if f.endswith(".json")) == [5, 10, 15, 20]
    st, hist, snaps = E.resume.resume_train_scan(
        CFG, S, mds, 20, 3, d, step=10, log_every=5, eval_every=4,
        eval_datasets=eval_ds, device="cpu")
    _state_equal(st, full)
    assert [h["step"] for h in hist] == [10, 15, 19]
    assert [h["step"] for h in fhist][-3:] == [10, 15, 19]
    for a, b in zip(hist, fhist[-3:]):
        assert a == b
    assert [s["step"] for s in snaps] == [11, 15, 19]
    tail = {s["step"]: s for s in fsnaps}
    for s in snaps:
        for k in s:
            np.testing.assert_array_equal(s[k], tail[s["step"]][k])
    _, hist5 = E.resume.resume_train_scan(CFG, S, mds, 20, 3, d, step=10,
                                          log_every=3, device="cpu")
    assert [h["step"] for h in hist5] == [12, 15, 18, 19]


def test_resumed_run_rearms_checkpoint_cadence(mds, tmp_path):
    _, S = tsurf.make_problem(CFG, 0, device="cpu")
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    E.train_scan(CFG, S, mds, 8, seed=3, checkpoint_every=4,
                 checkpoint_dir=d1, device="cpu")
    E.resume.resume_train_scan(CFG, S, mds, 20, 3, d1, step=8,
                               checkpoint_every=4, checkpoint_dir=d2,
                               device="cpu")
    assert sorted(int(f[5:-5]) for f in os.listdir(d2)
                  if f.endswith(".json")) == [12, 16, 20]


def test_seed_batched_resume_is_bit_exact(mds, eval_ds, tmp_path):
    seeds, d = [0, 1], str(tmp_path)
    states, hist, snaps, S_stack = tsurf.train_surf(
        CFG, mds, steps=10, seeds=seeds, log_every=5, eval_every=3,
        eval_datasets=eval_ds, checkpoint_every=4, checkpoint_dir=d,
        device="cpu")
    assert E.resume.latest_seed_step(d) == 8
    assert os.path.isdir(os.path.join(d, "ckpt_4"))
    r, hr, sr = E.resume.resume_train_scan_seeds(
        CFG, S_stack, mds, 10, seeds, d, step=4, log_every=5, eval_every=3,
        eval_datasets=eval_ds, device="cpu")
    _state_equal(r, states)
    tail = [h for h in hist if h["step"] > 4]
    assert [h["step"] for h in hr] == [h["step"] for h in tail] == [5, 9]
    for a, b in zip(hr, tail):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert [s["step"] for s in sr] == [5, 8]
    for a, b in zip(sr, snaps[1:]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_port_resumes_a_reference_checkpoint_on_its_draws(mds, tmp_path):
    """A state trained 4 steps by the reference, saved by it, resumed by
    the port for 4 more on the reference's ``fold_in`` draws: it tracks
    the reference's uninterrupted 8-step run."""
    _, S = jsurf.make_problem(JCFG, seed=0)
    key = jax.random.PRNGKey(6)
    jfull, _ = JE.train(JCFG, S, mds, 8, key)
    jhalf, _ = JE.train(JCFG, S, mds, 4, key)
    JE.resume.save_state(str(tmp_path), jhalf)

    def draws(t):
        kw, kb = jax.random.split(jax.random.fold_in(key, t))
        ds = mds[t % len(mds)]
        return tuple(np.asarray(a) for a in (
            JU.sample_w0(kw, JCFG),
            *JU.sample_layer_batches(kb, jnp.asarray(ds["Xtr"]),
                                     jnp.asarray(ds["Ytr"]), JCFG)))

    state = E.resume.restore_state(str(tmp_path), CFG, device="cpu")
    out, _ = E.train_scan(CFG, np.asarray(S), mds, 4, state=state,
                          draws={t: draws(t) for t in range(4, 8)},
                          device="cpu")
    js = jax.tree.map(np.asarray, jfull)
    for k in js.theta:
        np.testing.assert_allclose(out.theta[k].numpy(), js.theta[k],
                                   atol=STATE_TOL, rtol=STATE_TOL)
    np.testing.assert_allclose(out.lam.numpy(), js.lam, atol=STATE_TOL,
                               rtol=STATE_TOL)
    assert out.step == 8 and int(out.opt_state["t"]) == 8


def test_train_surf_checkpoint_passthrough(mds, tmp_path):
    tsurf.train_surf(CFG, mds, steps=10, log_every=0, checkpoint_every=4,
                     checkpoint_dir=str(tmp_path), device="cpu")
    assert tio.latest_step(str(tmp_path)) == 8
    with pytest.raises(ValueError, match="engine='scan'"):
        tsurf.train_surf(CFG, mds, steps=4, engine="python",
                         checkpoint_every=2, checkpoint_dir=str(tmp_path),
                         device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        E.train_scan(CFG, np.eye(CFG.n_agents), mds, 2, checkpoint_every=5,
                     device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        E.train_scan_seeds(CFG, np.stack([np.eye(CFG.n_agents)] * 2), mds,
                           2, [0, 1], checkpoint_every=5, device="cpu")


# --------------------------------------------------------- error cases
def test_latest_step_missing_empty_and_junk(tmp_path):
    assert tio.latest_step(os.path.join(tmp_path, "nope")) is None
    assert tio.latest_step(tmp_path) is None
    for junk in ("ckpt_abc.json", "ckpt_.json", "other_3.json",
                 "ckpt_5.npz"):
        open(os.path.join(tmp_path, junk), "w").close()
    assert tio.latest_step(tmp_path) is None
    open(os.path.join(tmp_path, "ckpt_7.json"), "w").close()
    open(os.path.join(tmp_path, "ckpt_12.json"), "w").close()
    assert tio.latest_step(tmp_path) == 12
    assert E.resume.latest_seed_step(tmp_path) is None
    assert E.resume.latest_seed_step(None) is None


def test_restore_missing_and_mismatched(tmp_path):
    tree = {"a": torch.arange(3.0), "b": torch.zeros((2, 2))}
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tio.restore(os.path.join(tmp_path, "nope"), tree, device="cpu")
    path = os.path.join(tmp_path, "ck")
    tio.save(path, tree, step=0)
    os.remove(path + ".npz")
    with pytest.raises(FileNotFoundError, match="payload"):
        tio.restore(path, tree, device="cpu")
    tio.save(path, tree, step=0)
    with pytest.raises(ValueError, match="leaves"):
        tio.restore(path, {"a": torch.arange(3.0)}, device="cpu")


def test_resume_errors(mds, tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        E.resume.restore_state(str(tmp_path), CFG, device="cpu")
    with pytest.raises(FileNotFoundError):
        E.resume.restore_state(os.path.join(tmp_path, "missing"), CFG,
                               device="cpu")
    with pytest.raises(FileNotFoundError, match="seed-batched"):
        E.resume.restore_seed_states(str(tmp_path), CFG, 2, device="cpu")
    _, S = tsurf.make_problem(CFG, 0, device="cpu")
    st, _ = E.train_scan(CFG, S, mds, 3, device="cpu")
    E.resume.save_state(str(tmp_path), st)
    with pytest.raises(ValueError, match="beyond"):
        E.resume.resume_train_scan(CFG, S, mds, 2, 0, str(tmp_path),
                                   device="cpu")
    os.rename(os.path.join(tmp_path, "ckpt_3.json"),
              os.path.join(tmp_path, "ckpt_4.json"))
    os.rename(os.path.join(tmp_path, "ckpt_3.npz"),
              os.path.join(tmp_path, "ckpt_4.npz"))
    with pytest.raises(ValueError, match="carries step 3"):
        E.resume.restore_state(str(tmp_path), CFG, device="cpu")
