"""Synthetic downstream datasets: the port's copy of
``repro.data.synthetic``. Pure numpy (``default_rng``), so every array
is bit-equal to the reference's, the sparse ground truths included.

The feature extractor is a fixed map: class c => N(μ_c, σ²I) in R^F with
frozen class means μ_c shared by ALL datasets. Datasets differ in their
LABEL distribution:
  * meta-training pool: a global class distribution ~ Dirichlet(imbalance)
    shared by every agent;
  * heterogeneous pool: per-AGENT class distributions ~ Dirichlet(alpha).
The sparse-recovery (federated LASSO) problems share the flat-dict
layout: Xtr (n, m, p) sensing rows, Ytr (n, m) f32 measurements.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import SURFConfig


def class_means(cfg: SURFConfig, seed=1234, sep=3.0):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(cfg.n_classes, cfg.feature_dim))
    return sep * mu / np.linalg.norm(mu, axis=1, keepdims=True)


def _sample_agent(rng, mu, probs, m, noise):
    C, F = mu.shape
    y = rng.choice(C, size=m, p=probs)
    x = mu[y] + noise * rng.normal(size=(m, F))
    return x.astype(np.float32), y.astype(np.int32)


def sample_dataset(cfg: SURFConfig, seed, *, alpha=None, imbalance=1.0,
                   noise=1.0, mu=None):
    """One downstream dataset: per-agent train/test splits.

    alpha=None  -> paper's class-imbalanced pool (global Dirichlet(imbalance))
    alpha=float -> per-agent Dirichlet(alpha) heterogeneity (Fig. 6)
    """
    rng = np.random.default_rng(seed)
    mu = class_means(cfg) if mu is None else mu
    n, C = cfg.n_agents, cfg.n_classes
    if alpha is None:
        probs = rng.dirichlet(imbalance * np.ones(C))
        agent_probs = np.tile(probs, (n, 1))
    else:
        agent_probs = rng.dirichlet(alpha * np.ones(C), size=n)
    Xtr = np.empty((n, cfg.train_per_agent, cfg.feature_dim), np.float32)
    Ytr = np.empty((n, cfg.train_per_agent), np.int32)
    Xte = np.empty((n, cfg.test_per_agent, cfg.feature_dim), np.float32)
    Yte = np.empty((n, cfg.test_per_agent), np.int32)
    for i in range(n):
        Xtr[i], Ytr[i] = _sample_agent(rng, mu, agent_probs[i],
                                       cfg.train_per_agent, noise)
        Xte[i], Yte[i] = _sample_agent(rng, mu, agent_probs[i],
                                       cfg.test_per_agent, noise)
    return {"Xtr": Xtr, "Ytr": Ytr, "Xte": Xte, "Yte": Yte}


def make_meta_dataset(cfg: SURFConfig, Q, seed=0, **kw):
    """Q downstream datasets (paper: Q=600 train / 30 test)."""
    mu = class_means(cfg)
    return [sample_dataset(cfg, seed * 100003 + q, mu=mu, **kw)
            for q in range(Q)]


# ------------------------------------------------- sparse recovery (LASSO)
def sample_sparse_dataset(cfg: SURFConfig, task, seed, *,
                          return_truth=False):
    """One federated-LASSO downstream problem: a shared k-sparse ground
    truth w* ∈ R^p (nonzeros ~ N(0, signal_scale²)), per-agent Gaussian
    sensing rows A_i (scaled 1/√p so row energy is O(1)) and
    measurements y_i = A_i w* + noise: Xtr (n, m, p) f32 sensing rows,
    Ytr (n, m) f32 measurements (and the test split alike)."""
    rng = np.random.default_rng(seed)
    n, p = cfg.n_agents, task.signal_dim
    w_star = np.zeros(p, np.float32)
    support = rng.choice(p, size=task.sparsity, replace=False)
    w_star[support] = (task.signal_scale
                       * rng.normal(size=task.sparsity)).astype(np.float32)

    def measure(m):
        A = (rng.normal(size=(n, m, p)) / np.sqrt(p)).astype(np.float32)
        y = (A @ w_star + task.noise * rng.normal(size=(n, m))
             ).astype(np.float32)
        return A, y
    Xtr, Ytr = measure(cfg.train_per_agent)
    Xte, Yte = measure(cfg.test_per_agent)
    out = {"Xtr": Xtr, "Ytr": Ytr, "Xte": Xte, "Yte": Yte}
    if return_truth:
        return out, w_star
    return out


def make_sparse_meta_dataset(cfg: SURFConfig, Q, task, seed=0,
                             return_truth=False):
    """Q sparse-recovery downstream problems, each with its own ground
    truth and sensing matrices (the seed stream of
    ``make_meta_dataset``). ``return_truth`` also returns the stacked
    (Q, p) ground-truth signals."""
    outs = [sample_sparse_dataset(cfg, task, seed * 100003 + q,
                                  return_truth=return_truth)
            for q in range(Q)]
    if return_truth:
        return [d for d, _ in outs], np.stack([w for _, w in outs])
    return outs
