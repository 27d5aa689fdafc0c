"""The port's whisper-small training against the reference, on the CPU,
at the reduced config: ``launch.train.main`` against the reference's
driver, the microbatched step's split of the frames, and the key-bias
gradients that are zero in both packages. Moved from
``tests/test_torch_whisper.py`` (its fixtures and tolerance are there)
so that its file does not hold one test worker for most of the suite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as JM
from repro_torch.launch import steps
from repro_torch.launch import train
from test_torch_lm import _leaves
from test_torch_whisper import (ARCH, FRAMES, TOL, pair, reset_flags)

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)


def test_train_main_matches_reference_losses(pair, capsys):
    """``launch.train.main`` on reduced whisper: the loss decreases with the
    port's own draws; from the reference's parameters and its frames
    (``frames=`` replays ``fold_in(PRNGKey(0), t)``'s draws) the per-step
    losses follow the reference driver's."""
    jcfg, tcfg, jparams, tparams, _, _ = pair
    argv = ["--arch", ARCH, "--steps", "12", "--batch", "2", "--seq", "16",
            "--lr", "3e-3", "--log-every", "6"]
    losses = train.main(argv + ["--device", "cpu"])
    assert len(losses) == 12 and np.mean(losses[-5:]) < np.mean(losses[:5])
    assert "arch=whisper-small-reduced" in capsys.readouterr().out
    key = jax.random.PRNGKey(0)

    def ref_frames(t):
        return np.asarray(0.02 * jax.random.normal(
            jax.random.fold_in(key, t), (2, 24, jcfg.d_model)))

    ref = jtrain.main(argv)
    got = train.main(argv + ["--device", "cpu"], params=tparams,
                     frames=ref_frames)
    np.testing.assert_allclose(got, ref, rtol=1e-3)


def test_microbatched_step_splits_the_frames(pair, monkeypatch):
    """``make_train_step(microbatches=2)``: each microbatch's loss sees its
    half of the frames (rows in order), and the step matches the
    reference's with the same microbatches and the port's single batch."""
    jcfg, tcfg, jparams, tparams, _, _ = pair
    rng = np.random.default_rng(9)
    ids = rng.integers(0, tcfg.vocab, (4, 17))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:],
             "frames": (0.02 * rng.standard_normal(
                 (4, FRAMES, tcfg.d_model))).astype(np.float32)}
    seen = []
    lag = steps.loss_and_grads
    monkeypatch.setattr(steps, "loss_and_grads", lambda cfg, p, b, r: (
        seen.append(b["frames"].clone()), lag(cfg, p, b, r))[1])
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    out = {}
    for mb in (1, 2):
        step, opt = steps.make_train_step(tcfg, lr=1e-3, remat=False,
                                          microbatches=mb)
        out[mb] = step(tparams, opt.init(tparams), tb)
    assert [tuple(f.shape) for f in seen] == [(4, FRAMES, tcfg.d_model)] + [
        (2, FRAMES, tcfg.d_model)] * 2
    assert torch.equal(torch.cat(seen[1:]), tb["frames"])
    jstep, jopt = jmake_train_step(jcfg, lr=1e-3, remat=False,
                                   microbatches=2)
    _, _, jm = jax.jit(jstep)(jparams, jopt.init(jparams),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(out[2][2][key]), float(jm[key]),
                                   rtol=TOL, err_msg=key)
    assert float(out[1][2]["loss"]) == pytest.approx(
        float(out[2][2]["loss"]), rel=1e-4)


def test_key_bias_gradients_are_zero_in_both_packages(pair):
    """A key projection's bias moves every logit of a query row by the same
    q·b, which softmax ignores, so its gradient is zero analytically: in
    both packages every attention's key-bias gradient is zero to f32
    rounding (within 1e-6 of the largest gradient entry), while the query
    bias's is not. The card's gates hold these tensors to zero rather
    than to their own largest entry."""
    jcfg, tcfg, jparams, tparams, _, _ = pair
    rng = np.random.default_rng(3)
    ids = rng.integers(0, tcfg.vocab, (2, 17))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:],
             "frames": (0.02 * rng.standard_normal(
                 (2, FRAMES, tcfg.d_model))).astype(np.float32)}
    jg = jax.grad(lambda p: JM.lm_loss(jcfg, p, {
        k: jnp.asarray(v) for k, v in batch.items()})[0])(jparams)
    _, tg = steps.loss_and_grads(tcfg, tparams, {
        k: torch.tensor(v) for k, v in batch.items()}, remat=False)
    for grads in (_leaves(jg), _leaves(tg)):
        largest = max(np.abs(v).max() for v in grads.values())
        keys = [k for k in grads if k.endswith(".wk.b")]
        assert len(keys) == 3    # encoder, self, cross: each stacked
        for k in keys:
            assert np.abs(grads[k]).max() <= 1e-6 * largest, k
            q = k[:-len("wk.b")] + "wq.b"
            assert np.abs(grads[q]).max() > 1e-4 * largest, q
