"""The port's LM train step against the reference, on the CPU: three
Adam steps of each dense and RWKV arch, and the microbatched step against
the reference's and the single batch. Moved from
``tests/test_torch_lm_train.py`` (its helpers, tolerances and their
reasons are there) so that its file does not hold one test worker for
most of the suite.
"""
import jax
import numpy as np
import pytest
import torch

from repro.launch.steps import make_train_step as jmake_train_step
from repro_torch.checkpoint.convert import (lm_opt_state_from_numpy,
                                            lm_params_from_numpy)
from repro_torch.launch.steps import make_train_step
from repro_torch.utils.tree import _leaves
from test_torch_lm_train import (ARCH_NAMES, TOL, _batch, _j, _pair,
                                 _state_close, _t, reset_flags)

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_three_train_steps_match_reference(arch):
    """Three steps of ``make_train_step`` against the reference's jitted
    step: each from the reference's state (converted), so differences do
    not compound; the free-running losses of both over the three steps
    agree too."""
    jcfg, tcfg, jparams, tparams = _pair(arch)
    jstep, jopt = jmake_train_step(jcfg, lr=1e-3, remat=False)
    jstep = jax.jit(jstep)
    tstep, topt = make_train_step(tcfg, lr=1e-3, remat=False)
    jp, jo = jparams, jopt.init(jparams)
    tp_run, to_run = tparams, topt.init(tparams)
    for s in range(3):
        batch = _batch(tcfg, 10 + s, batch=4)
        tp = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
        to = lm_opt_state_from_numpy(tcfg, jax.tree.map(np.asarray, jo),
                                     device="cpu")
        tp, to, tm = tstep(tp, to, _t(batch))
        jp, jo, jm = jstep(jp, jo, _j(batch))
        for key in ("loss", "grad_norm", "moe_lb"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=TOL, atol=1e-7, err_msg=key)
        _state_close(tp, to, jp, jo)
        tp_run, to_run, tm_run = tstep(tp_run, to_run, _t(batch))
        np.testing.assert_allclose(float(tm_run["loss"]), float(jm["loss"]),
                                   rtol=TOL)


@pytest.mark.parametrize("mb", [1, 2, 4])
def test_microbatched_step_matches_reference_and_single(mb):
    """Gradient accumulation over ``mb`` microbatches against the
    reference's step with the same ``mb``, and against the port's single
    batch at the reference's own tolerances (``test_perf_opts.py``)."""
    jcfg, tcfg, jparams, tparams = _pair("qwen3-4b")
    batch = _batch(tcfg, 3, batch=4)
    jstep, jopt = jmake_train_step(jcfg, lr=1e-3, remat=False,
                                   microbatches=mb)
    jp, jo, jm = jax.jit(jstep)(jparams, jopt.init(jparams), _j(batch))
    out = {}
    for m in sorted({1, mb}):
        tstep, topt = make_train_step(tcfg, lr=1e-3, remat=False,
                                      microbatches=m)
        out[m] = tstep(tparams, topt.init(tparams), _t(batch))
    tp, to, tm = out[mb]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=TOL)
    _state_close(tp, to, jp, jo)
    assert float(out[1][2]["loss"]) == pytest.approx(float(tm["loss"]),
                                                     rel=1e-4)
    np.testing.assert_allclose(_leaves(out[1][0])[0].numpy(),
                               _leaves(tp)[0].numpy(), atol=5e-5)
