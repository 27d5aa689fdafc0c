"""The port's numpy-seeded inputs are bit-equal to the reference's:
``data.synthetic`` datasets and ``topology.families`` graphs and mixing
matrices. Both packages draw from ``np.random.default_rng`` with the same
calls, so the comparison is exact (no tolerance)."""
import numpy as np
import pytest

from repro.configs import surf_paper as jcfgs
from repro.core import surf as jsurf
from repro.data import synthetic as jsyn
from repro.topology import families as jfam
from repro_torch.configs import surf_paper as tcfgs
from repro_torch.core import surf as tsurf
from repro_torch.data import synthetic as tsyn
from repro_torch.topology import families as tfam

import torch

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

PRESETS = ["SMOKE", "BENCH", "PAPER"]


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_reference(name):
    j, t = getattr(jcfgs, name), getattr(tcfgs, name)
    for f in ("n_agents", "n_layers", "filter_taps", "feature_dim",
              "n_classes", "batch_per_agent", "train_per_agent",
              "test_per_agent", "eps", "w0_mean", "w0_std", "topology",
              "degree", "er_p", "head_dim"):
        assert getattr(j, f) == getattr(t, f), f


@pytest.mark.parametrize("name", PRESETS)
def test_sample_dataset_bit_equal(name):
    j, t = getattr(jcfgs, name), getattr(tcfgs, name)
    _equal(jsyn.class_means(j), tsyn.class_means(t))
    _equal(jsyn.sample_dataset(j, seed=7), tsyn.sample_dataset(t, seed=7))
    _equal(jsyn.sample_dataset(j, seed=3, alpha=0.3),
           tsyn.sample_dataset(t, seed=3, alpha=0.3))


@pytest.mark.parametrize("name", ["SMOKE", "BENCH"])
def test_make_meta_dataset_bit_equal(name):
    j, t = getattr(jcfgs, name), getattr(tcfgs, name)
    _equal(jsyn.make_meta_dataset(j, 3, seed=2),
           tsyn.make_meta_dataset(t, 3, seed=2))


KINDS = ["regular", "er", "ring", "star", "geometric", "smallworld", "pref",
         "torus"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("weights",
                         ["metropolis", "lazy_metropolis", "laplacian"])
@pytest.mark.parametrize("n,seed", [(8, 0), (100, 1)])
def test_build_topology_bit_equal(kind, weights, n, seed):
    kw = dict(degree=3, p=0.1, seed=seed, weights=weights)
    _equal(jfam.build_topology(kind, n, **kw),
           tfam.build_topology(kind, n, **kw))


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_problem_bit_equal(name, seed):
    """The preset's own graph and f32 mixing matrix for training seeds."""
    Aj, Sj = jsurf.make_problem(getattr(jcfgs, name), seed=seed)
    At, St = tsurf.make_problem(getattr(tcfgs, name), seed=seed,
                                device="cpu")
    _equal(Aj, At)
    _equal(np.asarray(Sj), St.numpy())


def test_build_topology_rejects_unknown_names():
    with pytest.raises(ValueError):
        tfam.build_topology("hypercube", 8)
    with pytest.raises(ValueError, match="unknown weight rule"):
        tfam.build_topology("ring", 8, weights="uniform")
