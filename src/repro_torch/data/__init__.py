"""Synthetic downstream datasets (numpy, bit-equal to the reference),
Dirichlet partitions and the stacked meta-training pool: ``synthetic``,
``partition``, ``pipeline``."""
from repro_torch.data import partition, pipeline, synthetic  # noqa: F401

__all__ = ["synthetic", "partition", "pipeline"]
