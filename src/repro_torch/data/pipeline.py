"""The meta-training pool on the device: the port of
``repro.data.pipeline.stack_meta_datasets``. The training drivers, the
seed-batched engine and the in-loop snapshots take their pools from
here. The LM ``TokenPipeline`` of the reference is ROADMAP queue 1
item 18."""
from __future__ import annotations

import numpy as np


def stack_meta_datasets(datasets, task, device):
    """A list of downstream datasets (``Xtr``/``Ytr``/``Xte``/``Yte``
    dicts of one shape) as one dict of (Q, ...) tensors on ``device``:
    f32 features, labels in ``task.label_dtype``. An already stacked
    dict passes through ``task.to_batch`` (no copy when it already lies
    on ``device`` in those dtypes)."""
    if isinstance(datasets, (list, tuple)):
        if not datasets:
            raise ValueError("stack_meta_datasets: empty dataset list")
        datasets = {k: np.stack([np.asarray(ds[k]) for ds in datasets])
                    for k in ("Xtr", "Ytr", "Xte", "Yte")}
    return task.to_batch(datasets, device)
