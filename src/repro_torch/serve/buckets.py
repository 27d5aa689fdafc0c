"""Shape bucketing: map ragged cohorts onto a small set of padded shapes
(the port of ``repro.serve.buckets``).

A request is bucketed by ``(n_agents_bucket, rows_bucket)``, the smallest
configured sizes that fit its true agent count and test rows per agent.
Padding is inert:

  * agents — S gets zero rows/cols for padded agents (they contribute
    nothing to any real agent's graph-filter sum) and every W/X/Y agent
    row past ``n_real`` is zero; the solver re-zeroes W rows per layer;
  * test rows — padded rows are COPIES OF ROW 0, and the task's
    ``padded_local_loss`` / ``padded_local_metric`` subtract their
    contribution exactly.

``pad_cohort`` runs AFTER ``core.unroll.featurize_cohort``: W0 and the
layer batches were drawn at the true cohort shape. ``pad_probe`` pads the
convergence-probe split of adaptive depth over the agent axis only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Bucket(NamedTuple):
    """One padded serving shape: ``n_agents`` cohort slots x ``rows``
    test rows per agent."""
    n_agents: int
    rows: int


class BucketSpec(NamedTuple):
    """The configured bucket grid (ascending size ladders)."""
    agent_sizes: tuple = (8, 16, 32, 64, 128)
    row_sizes: tuple = (4, 8, 16, 32, 64)

    def bucket_for(self, n_agents: int, rows: int) -> Bucket:
        """Smallest bucket fitting (n_agents, rows); actionable error
        when the request exceeds the grid."""
        na = next((a for a in sorted(self.agent_sizes) if a >= n_agents),
                  None)
        nr = next((r for r in sorted(self.row_sizes) if r >= rows), None)
        if na is None or nr is None:
            raise ValueError(
                f"cohort (n_agents={n_agents}, rows={rows}) exceeds the "
                f"bucket grid (agent_sizes={tuple(self.agent_sizes)}, "
                f"row_sizes={tuple(self.row_sizes)}) — extend BucketSpec "
                "or split the cohort")
        return Bucket(na, nr)

    def buckets_for(self, cohorts):
        """Distinct buckets covering an iterable of (n_agents, rows)
        pairs, in first-seen order (warm-up helper)."""
        seen, out = set(), []
        for n, t in cohorts:
            b = self.bucket_for(n, t)
            if b not in seen:
                seen.add(b)
                out.append(b)
        return out


def pad_cohort(S, W0, Xl, Yl, Xte, Yte, bucket: Bucket):
    """Pad one featurized cohort (tensors on one device) to ``bucket``
    shape. Returns ``(S, W0, Xl, Yl, Xte, Yte, mask, t_real)``: agent axis
    padded with zeros (and zero S rows/cols), test-row axis padded with
    row-0 copies, ``mask`` (n_pad,) bool flagging real agents, ``t_real``
    the true row count (float) the padded-loss corrections consume."""
    n, t = S.shape[0], Xte.shape[1]
    npad, tpad = int(bucket.n_agents), int(bucket.rows)
    if n > npad or t > tpad:
        raise ValueError(f"cohort (n={n}, t={t}) does not fit bucket "
                         f"{bucket}")
    Sp = S.new_zeros((npad, npad))
    Sp[:n, :n] = S
    W0p = W0.new_zeros((npad,) + W0.shape[1:])
    W0p[:n] = W0
    Xlp = Xl.new_zeros((Xl.shape[0], npad) + Xl.shape[2:])
    Xlp[:, :n] = Xl
    Ylp = Yl.new_zeros((Yl.shape[0], npad) + Yl.shape[2:])
    Ylp[:, :n] = Yl
    Xtep = Xte.new_zeros((npad, tpad) + Xte.shape[2:])
    Xtep[:n, :t] = Xte
    Xtep[:n, t:] = Xte[:, :1]                 # row-0 copies (see module doc)
    Ytep = Yte.new_zeros((npad, tpad) + Yte.shape[2:])
    Ytep[:n, :t] = Yte
    Ytep[:n, t:] = Yte[:, :1]
    mask = torch.zeros(npad, dtype=torch.bool, device=S.device)
    mask[:n] = True
    return Sp, W0p, Xlp, Ylp, Xtep, Ytep, mask, float(t)


def pad_probe(Xp, Yp, bucket: Bucket):
    """Pad the convergence-probe split (``core.unroll.probe_batch``) to
    ``bucket``'s agent count. Probe ROWS are a config constant
    (``cfg.probe_size``), so only the agent axis pads, with zeros, which
    ``task.masked_grad_norm`` removes from the certificate exactly."""
    n, npad = Xp.shape[0], int(bucket.n_agents)
    if n > npad:
        raise ValueError(f"probe (n={n}) does not fit bucket {bucket}")
    Xpp = Xp.new_zeros((npad,) + Xp.shape[1:])
    Xpp[:n] = Xp
    Ypp = Yp.new_zeros((npad,) + Yp.shape[1:])
    Ypp[:n] = Yp
    return Xpp, Ypp
