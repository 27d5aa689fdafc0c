"""Pluggable inner FL problems: ``Task`` (``base.py``) and the one
resolution point ``resolve_task(cfg, task)``. Shipped: the paper's
softmax head, ``ClassificationTask``, and federated LASSO,
``SparseRecoveryTask``.
"""
from repro_torch.core.tasks.base import Task, resolve_task
from repro_torch.core.tasks.classification import (ClassificationTask,
                                                   classification_task)
from repro_torch.core.tasks.sparse_recovery import (SparseRecoveryTask,
                                                    signal_nmse,
                                                    soft_threshold,
                                                    sparse_recovery_task,
                                                    support_f1)

__all__ = ["Task", "resolve_task", "ClassificationTask",
           "classification_task",
           "SparseRecoveryTask", "sparse_recovery_task", "soft_threshold",
           "support_f1", "signal_nmse"]
