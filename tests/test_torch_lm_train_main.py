"""The port's LM training driver against the reference, on the CPU:
``TokenPipeline``, ``launch.train.main`` (the loss falls, its flags and
state), checkpoint and resume, the reference's LM checkpoints and Adam's
state conversion. Moved from ``tests/test_torch_lm_train.py`` (its
helpers, tolerances and their reasons are there) so that its file does
not hold one test worker for most of the suite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JCKPT
from repro.configs import get_config as jget_config
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch import train as jtrain
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as JM
from repro_torch import checkpoint as CKPT
from repro_torch import flags
from repro_torch.checkpoint.convert import lm_opt_state_from_numpy
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.utils.tree import _leaves
from test_torch_lm_train import (TOL, _batch, _flat, _j, _pair, _t,
                                 reset_flags)

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 7])
def test_token_pipeline_bit_equal(seed):
    jpipe = JTokenPipeline(512, 3, 24, seed=seed)
    tpipe = TokenPipeline(512, 3, 24, seed=seed)
    for _ in range(4):
        a, b = next(jpipe), next(tpipe)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_train_main_lowers_the_loss(capsys):
    """``launch.train.main`` on the CPU with the reference system test's
    arguments (``tests/test_system.py``): the loss decreases, and from
    the reference's parameters the per-step losses follow the reference
    driver's."""
    argv = ["--arch", "qwen3-4b", "--steps", "30", "--batch", "4", "--seq",
            "32", "--lr", "3e-3", "--log-every", "10"]
    losses = train.main(argv + ["--device", "cpu"])
    assert len(losses) == 30 and np.mean(losses[-5:]) < np.mean(losses[:5])
    out = capsys.readouterr().out
    assert "arch=qwen3-4b-reduced" in out and "done: loss" in out
    jcfg, tcfg, jparams, tparams = _pair("qwen3-4b")
    ref = jtrain.main(argv[:3] + ["12"] + argv[4:])
    got = train.main(argv[:3] + ["12"] + argv[4:] + ["--device", "cpu"],
                     params=tparams)
    np.testing.assert_allclose(got, ref, rtol=1e-3)


def test_train_main_flags_and_state(tmp_path):
    """``--opts`` holds for the run only; ``state=`` receives the final
    parameters and Adam state; ``--ckpt`` writes {"params", "step"} in the
    reference's format, which the reference restores."""
    state = {}
    path = str(tmp_path / "ck")
    train.main(["--arch", "rwkv6-1.6b", "--steps", "6", "--batch", "2",
                "--seq", "8", "--lr", "3e-3", "--device", "cpu", "--opts",
                "chunked_ce=4,nested_remat_group=2", "--ckpt", path],
               state=state)
    assert flags.get() == flags.Flags()
    assert int(state["opt_state"]["t"]) == 6
    jcfg = jget_config("rwkv6-1.6b").reduced()
    like = jax.eval_shape(lambda: {"params": JM.init_lm(
        jcfg, jax.random.PRNGKey(0)), "step": jnp.int32(0)})
    restored = JCKPT.restore(path, like)
    assert int(restored["step"]) == 6
    ref = _flat(restored["params"])
    for k, v in _flat(state["params"]).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_checkpoint_resume_training(tmp_path):
    """Save -> restore -> the next step from the restored parameters is
    bit-equal to the step from the in-memory ones (``test_system.py``'s
    resume test, which holds the losses at 1e-6)."""
    tcfg = get_config("qwen3-4b").reduced()
    params = M.init_lm(tcfg, 0, device="cpu")
    batch = _t(_batch(tcfg, 5))
    step, opt = make_train_step(tcfg, lr=1e-3, remat=False)
    opt_state = opt.init(params)
    params, opt_state, _ = step(params, opt_state, batch)
    path = str(tmp_path / "ck")
    CKPT.save(path, params)
    params2 = CKPT.restore(path, M.init_lm(tcfg, 0, device="meta"),
                           device="cpu")
    pa, _, ma = step(params, opt_state, batch)
    pb, _, mb = step(params2, opt_state, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for a, b in zip(_leaves(pa), _leaves(pb)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-1.6b"])
def test_reference_lm_checkpoint_restores_with_the_same_loss(arch, tmp_path):
    """An LM checkpoint written by the reference ({"params", "step"}, its
    train driver's) restored by the port gives the reference's loss."""
    jcfg, tcfg, jparams, _ = _pair(arch)
    path = str(tmp_path / "ref")
    JCKPT.save(path, {"params": jparams, "step": 3})
    like = {"params": M.init_lm(tcfg, 0, device="meta"), "step": 0}
    got = CKPT.restore(path, like, device="cpu")
    assert got["step"] == 3
    batch = _batch(tcfg, 6)
    jl, _ = JM.lm_loss(jcfg, jparams, _j(batch))
    with torch.no_grad():
        tl, _ = M.lm_loss(tcfg, got["params"], _t(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)


def test_opt_state_conversion_validates():
    jcfg, tcfg, jparams, _ = _pair("qwen3-4b")
    _, jopt = jmake_train_step(jcfg)
    jo = jax.tree.map(np.asarray, jopt.init(jparams))
    to = lm_opt_state_from_numpy(tcfg, jo, device="cpu")
    assert to["t"].dtype == torch.int32 and int(to["t"]) == 0
    assert all(t.dtype == torch.float32 for t in _leaves(to["m"]))
    with pytest.raises(ValueError, match="keys m, v, t"):
        lm_opt_state_from_numpy(tcfg, {"m": jo["m"]}, device="cpu")
    jo["v"]["embed"]["table"] = jo["v"]["embed"]["table"][:-1]
    with pytest.raises(ValueError, match="embed.table"):
        lm_opt_state_from_numpy(tcfg, jo, device="cpu")
