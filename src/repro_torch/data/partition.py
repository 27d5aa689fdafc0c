"""Dirichlet label partitioning across agents (paper Fig. 6
heterogeneity): the port's copy of ``repro.data.partition``. Pure numpy,
so the partitions are bit-equal to the reference's."""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels, n_agents, alpha, seed=0):
    """Split example indices across agents with per-class Dirichlet shares.
    Returns list of index arrays, one per agent."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    agent_idx = [[] for _ in range(n_agents)]
    for c in classes:
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        shares = rng.dirichlet(alpha * np.ones(n_agents))
        cuts = (np.cumsum(shares)[:-1] * len(idx)).astype(int)
        for a, part in enumerate(np.split(idx, cuts)):
            agent_idx[a].extend(part.tolist())
    return [np.array(sorted(a), dtype=np.int64) for a in agent_idx]


def heterogeneity_stat(agent_labels, n_classes):
    """Mean TV distance between per-agent label dists and the global one."""
    global_hist = np.bincount(np.concatenate(agent_labels),
                              minlength=n_classes).astype(float)
    global_hist /= global_hist.sum()
    tvs = []
    for ls in agent_labels:
        h = np.bincount(ls, minlength=n_classes).astype(float)
        h /= max(h.sum(), 1)
        tvs.append(0.5 * np.abs(h - global_hist).sum())
    return float(np.mean(tvs))
