"""Mixture-of-experts FFN with top-k routing, shared experts, and
capacity-bounded sort-based dispatch: the port of ``repro.models.moe``.

Supports fine-grained MoE (DeepSeekMoE: d_expert != d_ff, shared experts)
and top-1 (Llama4/Switch). Returns the standard load-balance auxiliary
loss plus a router z-loss.

The reference computes the expert products outside any Pallas kernel
(``einsum``), so here they are batched ``torch.bmm`` in f32 (cuBLAS, TF32
off). Dispatch and combine are gathers, never float atomics, so a rerun
on the card is bit-equal, backward included:

  * ``tok_idx`` (E, C) names the token in each expert slot (T, the
    sentinel, where the slot is empty) and ``slot_src`` (E, C) the
    (token, choice) pair that filled it (T·k where empty), as in the
    reference; ``slot_of`` (T, k) is the inverse map, the flat slot of
    each (token, choice) pair (E·C where the pair was dropped).
  * ``_Gather`` reads rows through one map and sums its gradient through
    the other: the dispatch gathers x through ``tok_idx`` and sums a
    token's at most k slot gradients over k in a fixed order; the
    combine gathers each token's at most k slot outputs through
    ``slot_of`` and sums them over k in a fixed order (the reference
    scatter-adds them), and its gradient gathers through ``slot_src``.
    An index at the sentinel reads a zero row.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers as L


def init_moe(init: L.Init, d_model, m: MoEConfig, d_ff_dense, act):
    """Expert weights are stacked on a leading E axis."""
    de = m.d_expert or d_ff_dense
    E = m.n_experts
    scale = d_model ** -0.5
    p = {"router": {"w": init.normal((d_model, E), scale)},
         "wu": init.normal((E, d_model, de), scale),
         "wd": init.normal((E, de, d_model), scale)}
    if act == "swiglu":
        p["wg"] = init.normal((E, d_model, de), scale)
    if m.n_shared:
        p["shared"] = L.init_mlp(init, d_model, de * m.n_shared, act)
    return p


def capacity(n_tokens, m: MoEConfig) -> int:
    return max(1, math.ceil(m.top_k * n_tokens / m.n_experts * m.capacity_factor))


def route(p, x2, m: MoEConfig):
    """x2 (T, d) -> (weights (T,k), expert_idx (T,k), aux losses)."""
    logits = (x2 @ p["router"]["w"]).to(L.ACC)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    weights = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    # Switch-style load-balance loss + z-loss
    E = m.n_experts
    me = probs.mean(0)                                       # mean router prob
    ce = F.one_hot(idx[:, 0], E).to(L.ACC).mean(0)           # top-1 share
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return weights, idx, lb_loss, z_loss


def _scatter_slots(se, col, values, E, C, fill):
    """An (E, C) map filled with ``fill``, ``values`` written at (se, col);
    a column of C (an overflow) lands in a spare column that is dropped,
    so no kept slot changes (the reference's ``mode="drop"``)."""
    out = torch.full((E, C + 1), fill, dtype=values.dtype, device=values.device)
    out[se, col] = values
    return out[:, :C]


def dispatch_maps(idx, n_tokens, m: MoEConfig):
    """Sort-based capacity dispatch. idx (T, k) expert assignment ->
    (tok_idx (E, C), slot_src (E, C), slot_of (T, k)), int64; see the
    module docstring."""
    T, k = idx.shape
    E, C = m.n_experts, capacity(n_tokens, m)
    dev = idx.device
    flat_e = idx.reshape(-1)                                 # (T*k,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    se, order = torch.sort(flat_e, stable=True)
    st = flat_t[order]
    # tokens per expert (bincount, as an integer sum that ``meta`` takes)
    counts = torch.zeros(E, dtype=se.dtype, device=dev).index_add_(
        0, se, torch.ones_like(se))
    seg_start = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[se]
    keep = pos_in_e < C
    col = torch.where(keep, pos_in_e, C)
    tok_idx = _scatter_slots(se, col, torch.where(keep, st, T), E, C, T)
    slot_src = _scatter_slots(se, col, torch.where(keep, order, T * k), E, C,
                              T * k)
    slot_of = torch.full((T * k,), E * C, dtype=torch.int64, device=dev)
    slot_of[order] = torch.where(keep, se * C + pos_in_e, E * C)
    return tok_idx, slot_src, slot_of.reshape(T, k)


def dispatch_indices(idx, n_tokens, m: MoEConfig):
    """The reference's pair: (tok_idx (E,C) with T as the OOB sentinel,
    slot_src (E,C) indexing the sorted order, T·k where empty), int32."""
    tok_idx, slot_src, _ = dispatch_maps(idx, n_tokens, m)
    return tok_idx.to(torch.int32), slot_src.to(torch.int32)


def _rows(src, index):
    """src (N, d) rows at ``index`` (any shape, values in [0, N]); N reads
    a zero row."""
    pad = torch.cat([src, src.new_zeros((1, src.shape[-1]))])
    return pad[index.reshape(-1)].reshape(index.shape + (src.shape[-1],))


class _Gather(torch.autograd.Function):
    """``src`` (N, d) rows at ``index`` (values in [0, N], N the sentinel).
    ``inverse`` (N, r) lists, for each source row, the flat positions of
    ``index`` that read it (``index.numel()`` where none): the gradient
    of row n is the sum over r, in order, of the output gradient at
    those positions. No atomics: a rerun is bit-equal."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return _rows(src, index)

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        return _rows(g, inverse).sum(1), None, None


def moe_apply(p, x, m: MoEConfig, act):
    """x (B, S, d) or (T, d). Returns (y, lb_loss, z_loss)."""
    shape = x.shape
    d = shape[-1]
    x2 = x.reshape(-1, d)
    T = x2.shape[0]
    weights, idx, lb_loss, z_loss = route(p, x2, m)
    tok_idx, slot_src, slot_of = dispatch_maps(idx, T, m)
    E, C = tok_idx.shape
    xg = _Gather.apply(x2, tok_idx, slot_of)                 # (E, C, d)
    if act == "swiglu":
        g = torch.bmm(xg, p["wg"]).to(L.ACC)
        u = torch.bmm(xg, p["wu"]).to(L.ACC)
        h = (F.silu(g) * u).to(x.dtype)
    else:
        u = torch.bmm(xg, p["wu"]).to(L.ACC)
        h = F.gelu(u, approximate="tanh").to(x.dtype)
    ye = torch.bmm(h, p["wd"]).to(L.ACC)                    # (E, C, d)
    # each token's at most k slot outputs, weighted, summed over k in order
    yk = _Gather.apply(ye.reshape(E * C, d), slot_of, slot_src.reshape(-1, 1))
    w = torch.where(slot_of < E * C, weights.to(L.ACC), 0.0)
    y2 = (yk * w[..., None]).sum(1).to(x.dtype)
    if "shared" in p:
        y2 = y2 + L.mlp(p["shared"], x2, act)
    return y2.reshape(shape), lb_loss, z_loss
