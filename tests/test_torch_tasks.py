"""The port's ``classification_task`` against the reference's, on the CPU.

Every config that both packages ship with a classification task gives
the same task (feature width, classes, head width) through each
package's factory, and the same FL loss and accuracy on one numpy batch
(f32 sums in another order: 1e-6 of the loss). A sparse-recovery config
raises the same ``ValueError`` in both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import surf_paper as jcfgs
from repro.core.tasks import classification_task as jclassification_task
from repro_torch.configs import surf_paper as tcfgs
from repro_torch.core import tasks as ttasks

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
