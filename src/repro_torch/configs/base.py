"""SURF configuration dataclasses (the port's copy of the SURF half of
``repro.configs.base``). The LLM ``ArchConfig`` family arrives with the
LLM substrate; ``SparseRecoveryTaskConfig`` with the sparse-recovery
slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class TaskConfig:
    """Pure-data description of the inner FL problem the unrolled optimizer
    solves. Subclasses carry the task hyperparameters and the per-agent
    weight dimension; ``repro_torch.core.tasks.resolve_task`` turns one
    into the executable ``Task`` object (losses / metrics)."""
    kind: str = "abstract"

    @property
    def dim(self) -> int:
        raise NotImplementedError


@dataclass(frozen=True)
class ClassificationTaskConfig(TaskConfig):
    """Softmax-classifier head on frozen features (paper §6)."""
    kind: str = "classification"
    feature_dim: int = 64
    n_classes: int = 10

    @property
    def dim(self) -> int:
        return self.feature_dim * self.n_classes + self.n_classes

@dataclass(frozen=True)
class SURFConfig:
    """Paper-faithful SURF / U-DGD hyperparameters (§6 of the paper)."""
    n_agents: int = 100
    n_layers: int = 10          # L unrolled layers
    filter_taps: int = 2        # K communication rounds per layer
    feature_dim: int = 64       # frozen-feature dim (paper: 512, ResNet18)
    n_classes: int = 10
    batch_per_agent: int = 10   # minibatch fed to each unrolled layer
    train_per_agent: int = 45
    test_per_agent: int = 15
    eps: float = 0.01           # descending-constraint epsilon
    lr_theta: float = 1e-2
    lr_lambda: float = 1e-2
    w0_mean: float = 0.0
    w0_std: float = 0.1
    topology: str = "regular"   # regular | er | star | ring
    degree: int = 3
    er_p: float = 0.1
    # Inner problem. None keeps the legacy classification task built from
    # feature_dim/n_classes above (bit-exact default); any TaskConfig
    # overrides it and makes feature_dim/n_classes inert.
    task: Optional[TaskConfig] = None
    # RSDUN robust descending constraints (arxiv 2312.15788): when
    # robust_sigma > 0 the per-layer grad norms are the max over
    # robust_samples Gaussian perturbations W_l + σδ of the iterates
    # (and the nominal point), tightening the slack the dual ascent sees.
    robust_sigma: float = 0.0
    robust_samples: int = 2
    # Convergence-adaptive depth (solve-time early exit, RSDUN-style
    # certificate): the adaptive solve paths (depth="adaptive" on
    # evaluate_surf / solve_federation / FederationServer) stop unrolling
    # once the probe-batch grad-norm ratio ‖∇f(W_l)‖/‖∇f(W_{l-1})‖
    # plateaus at or above 1 − exit_threshold (i.e. the layer bought less
    # than an exit_threshold fractional descent). exit_threshold == 0
    # disables early exit — the adaptive path then runs all L layers and
    # reproduces the fixed-depth forward exactly. min_layers floors the
    # realized depth; probe_size is the held-aside train rows per agent
    # the certificate is evaluated on (cheap vs the full cohort).
    exit_threshold: float = 0.0
    min_layers: int = 1
    probe_size: int = 4

    @property
    def task_config(self) -> TaskConfig:
        if self.task is not None:
            return self.task
        return ClassificationTaskConfig(feature_dim=self.feature_dim,
                                        n_classes=self.n_classes)

    @property
    def head_dim(self) -> int:
        return self.task_config.dim
