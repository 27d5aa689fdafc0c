"""The port's ``classification_task`` against the reference's, on the CPU.

Every config that both packages ship with a classification task gives
the same task (feature width, classes, head width) through each
package's factory, and the same FL loss and accuracy on one numpy batch
(f32 sums in another order: 1e-6 of the loss). A sparse-recovery config
raises the same ``ValueError`` in both. ``features_from_backbone``
(frozen features from an LLM of ``models/``) against the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import surf_paper as jcfgs
from repro.core.tasks import classification_task as jclassification_task
from repro_torch.configs import surf_paper as tcfgs
from repro_torch.core import tasks as ttasks

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

SHARED = ["PAPER", "PAPER_STAR", "BENCH", "SMOKE"]


@pytest.mark.parametrize("name", SHARED)
def test_classification_task_matches_reference(name):
    jcfg, tcfg = getattr(jcfgs, name), getattr(tcfgs, name)
    jt, tt = jclassification_task(jcfg), ttasks.classification_task(tcfg)
    assert isinstance(tt, ttasks.ClassificationTask)
    assert (tt.feat_dim, tt.n_classes, tt.dim) == (jt.feat_dim, jt.n_classes,
                                                   jt.dim)
    assert tt.dim == tcfg.head_dim == jcfg.head_dim
    assert tt.cache_tag == jt.cache_tag
    rng = np.random.default_rng(len(name))
    n, b = 6, 5
    W = (0.1 * rng.standard_normal((n, jt.dim))).astype(np.float32)
    X = rng.standard_normal((n, b, jt.feat_dim)).astype(np.float32)
    Y = rng.integers(0, jt.n_classes, (n, b)).astype(np.int32)
    jloss = float(jt.fl_loss(jnp.asarray(W), jnp.asarray(X), jnp.asarray(Y)))
    tloss = float(tt.fl_loss(torch.tensor(W), torch.tensor(X),
                             torch.tensor(Y, dtype=torch.long)))
    assert tloss == pytest.approx(jloss, rel=1e-6, abs=1e-6)
    jacc = float(jt.fl_metric(jnp.asarray(W), jnp.asarray(X), jnp.asarray(Y)))
    tacc = float(tt.fl_metric(torch.tensor(W), torch.tensor(X),
                              torch.tensor(Y, dtype=torch.long)))
    assert tacc == pytest.approx(jacc, abs=1e-6)


def test_classification_task_refuses_a_sparse_config():
    with pytest.raises(ValueError, match="'sparse_recovery' task") as jerr:
        jclassification_task(jcfgs.SPARSE_SMOKE)
    with pytest.raises(ValueError, match="'sparse_recovery' task") as terr:
        ttasks.classification_task(tcfgs.SPARSE_SMOKE)
    assert str(terr.value) == str(jerr.value)


def test_classification_task_is_exported_like_the_reference():
    """``repro_torch.core.tasks`` exports the factory, as
    ``repro.core.tasks`` does; the ``core.task`` shim does not, in either
    package."""
    import repro.core.task as jshim
    import repro.core.tasks as jtasks
    import repro_torch.core.task as tshim
    assert "classification_task" in jtasks.__all__
    assert "classification_task" in ttasks.__all__
    assert not hasattr(jshim, "classification_task")
    assert not hasattr(tshim, "classification_task")


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b"])
def test_features_from_backbone_matches_reference(arch):
    """Mean-pooled final hidden states of a reduced dense and a reduced MoE
    arch, from the reference's parameters (converted) and the same ids,
    at ``tests/test_torch_lm.py``'s 1e-4; both shims re-export it."""
    import jax

    import repro.core.task as jshim
    import repro_torch.core.task as tshim
    from repro.configs import get_config as jget_config
    from repro.models import model as JM
    from repro_torch.checkpoint.convert import lm_params_from_numpy
    from repro_torch.configs import get_config
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jparams = JM.init_lm(jcfg, jax.random.PRNGKey(0))
    tparams = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    ids = np.random.default_rng(1).integers(0, tcfg.vocab, (3, 10))
    ref = jshim.features_from_backbone(jcfg, jparams, jnp.asarray(ids))
    with torch.no_grad():
        got = tshim.features_from_backbone(tcfg, tparams, torch.tensor(ids))
    assert got.shape == (3, tcfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    assert "features_from_backbone" in tshim.__all__
