"""The port's LM training path against the reference for the MoE and
hybrid archs, on the CPU, at their reduced configs: deepseek-moe-16b (a
dense layer, then MoE with a shared expert), llama4-scout-17b-a16e (a
local and a global attention layer, MoE top-1) and jamba-1.5-large-398b
(8 layers: Mamba with dense and MoE FFNs, attention at layer 4). The
auxiliary losses lb and z are nonzero and enter the loss.

``tests/test_torch_lm_train.py``'s helpers and tolerances (1e-4 of each
tensor's largest entry; Adam's noise floor counted apart): the loss, lb,
z and every gradient of ``lm_loss`` against ``jax.value_and_grad`` (also
with nested remat and chunked cross-entropy, where the reference's
condition nests), one ``make_train_step`` step against the reference's
jitted step from one state, and the card path's gradients through
stubbed launches. Jamba runs its one case without remat: its 8 layers
are one repeat, so nothing nests, and remat of the Mamba scan is held in
``tests/test_torch_mamba.py``."""
import jax
import numpy as np
import pytest

from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as JM
from repro_torch.checkpoint.convert import (lm_opt_state_from_numpy,
                                            lm_params_from_numpy)
from repro_torch.configs import ARCHS
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import stack as ST
from test_torch_lm_train import (LOSS_CASES, TOL, _batch, _close_tree, _j,
                                 _pair, _state_close, _stub_card_path, _t,
                                 reset_flags)  # noqa: F401 (autouse fixture)
from test_torch_lm_train import \
    test_lm_loss_and_grads_match_reference as _loss_and_grads_case

import torch

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

MOE_ARCHS = sorted(n for n, c in ARCHS.items() if c.moe is not None)
CASES = [(a, c) for a in MOE_ARCHS
         for c in (("plain",) if a.startswith("jamba")
                   else ("plain", "nested_remat+chunked_ce"))]


@pytest.mark.parametrize("arch,case", CASES)
def test_moe_lm_loss_and_grads_match_reference(arch, case, monkeypatch):
    """``lm_loss`` (lb and z included) and every gradient against
    ``jax.value_and_grad`` of the reference's."""
    assert case in LOSS_CASES
    _loss_and_grads_case(arch, case, monkeypatch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_matches_reference(arch):
    """One ``make_train_step`` step against the reference's jitted step
    from the same state: loss, gradient norm, ``moe_lb``, parameters and
    Adam's moments."""
    jcfg, tcfg, jparams, tparams = _pair(arch)
    jstep, jopt = jmake_train_step(jcfg, lr=1e-3, remat=False)
    jo = jopt.init(jparams)
    tstep, _ = make_train_step(tcfg, lr=1e-3, remat=False)
    to = lm_opt_state_from_numpy(tcfg, jax.tree.map(np.asarray, jo),
                                 device="cpu")
    batch = _batch(tcfg, 10, batch=4)
    tp, to, tm = tstep(tparams, to, _t(batch))
    jp, jo, jm = jax.jit(jstep)(jparams, jo, _j(batch))
    assert float(jm["moe_lb"]) > 0
    for key in ("loss", "grad_norm", "moe_lb"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=TOL, atol=1e-7, err_msg=key)
    _state_close(tp, to, jp, jo)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_card_path_gradients_match_plain(arch, monkeypatch):
    """With the flash launches stubbed on CPU tensors, the card path's
    loss and gradients (remat) equal the plain path's, and flash launches
    2L forward and L backward, L the attention layers."""
    _, tcfg, _, tparams = _pair(arch)
    batch = _t(_batch(tcfg, 8))
    (ref_loss, ref_aux), ref = loss_and_grads(tcfg, tparams, batch,
                                              remat=True)
    _stub_card_path(monkeypatch)
    before = (FA.flash_attention.launches, FA.flash_attention.bwd_launches)
    (loss, aux), got = loss_and_grads(tcfg, tparams, batch, remat=True)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(float(aux["lb"]), float(ref_aux["lb"]),
                               rtol=1e-6)
    _close_tree(got, ref, "grad")
    L = sum(reps * sum(k[0] == "attn" for k in body)
            for _, reps, body in ST.build_segments(tcfg))
    assert L > 0
    assert (FA.flash_attention.launches - before[0],
            FA.flash_attention.bwd_launches - before[1]) == (2 * L, L)
