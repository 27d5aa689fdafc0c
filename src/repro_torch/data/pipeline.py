"""The meta-training pool on the device (the port of
``repro.data.pipeline.stack_meta_datasets``; the training drivers, the
seed-batched engine and the in-loop snapshots take their pools from
here), and the LM training driver's token pipeline (``TokenPipeline``):
an infinite synthetic-corpus iterator, numpy-seeded, whose batches are
bit-equal to the reference's.

The corpus is a mixture of Zipf-distributed ids with Markov bigram
structure, so losses are non-trivial (a pure-uniform stream gives a
constant log V loss and hides optimizer bugs)."""
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


class TokenPipeline:
    """``next()`` gives {"tokens", "labels"}, each (batch, seq_len) int32
    numpy arrays (labels are tokens shifted by one), from
    ``np.random.default_rng(seed)`` in the reference's order of draws."""

    def __init__(self, vocab, batch, seq_len, seed=0, zipf_a=1.2):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        self.zipf_a = zipf_a
        # bigram successor table: token t -> small candidate set
        self._succ = self.rng.integers(0, vocab, size=(min(vocab, 4096), 8))

    def _zipf(self, shape):
        z = self.rng.zipf(self.zipf_a, size=shape)
        return np.minimum(z - 1, self.vocab - 1)

    def __iter__(self):
        return self

    def __next__(self):
        B, S = self.batch, self.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = self._zipf((B,))
        # vectorized Markov walk with Zipf jumps
        jump = self.rng.random((B, S)) < 0.3
        zipf_draws = self._zipf((B, S))
        choice = self.rng.integers(0, 8, size=(B, S))
        for t in range(S):
            succ = self._succ[toks[:, t] % self._succ.shape[0],
                              choice[:, t]]
            toks[:, t + 1] = np.where(jump[:, t], zipf_draws[:, t], succ)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
