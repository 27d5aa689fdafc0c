"""Pluggable inner FL problems: ``Task`` (``base.py``) and the one
resolution point ``resolve_task(cfg, task)``. Shipped: the paper's
softmax head, ``ClassificationTask``.
"""
from repro_torch.core.tasks.base import Task, resolve_task
from repro_torch.core.tasks.classification import ClassificationTask

__all__ = ["Task", "resolve_task", "ClassificationTask"]
