"""Feature flags of the performance options (the port's copy of
``repro.flags``): every option is a switch, so the plain baseline stays
reproducible and each option is a one-flag difference.

Flags are set with ``repro_torch.flags.set_flags(...)`` or from a string
(``parse_opts("blockwise_prefill,chunked_ce=512")``, the training driver's
``--opts``).

What the port does with each flag, on one card:

  * ``blockwise_prefill`` / ``q_chunk``: causal attention over Sq >= 2048
    in query chunks (``models.attention.blockwise_sdpa``) on the plain
    path (``plain_kernels=True`` or a CPU tensor); the flash kernel is
    blockwise by construction, so the kernel path takes the kernel either
    way.
  * ``chunked_ce``: cross-entropy per sequence chunk under remat
    (``models.model.chunked_ce_from_hidden``).
  * ``nested_remat_group``: nested remat of groups of layers
    (``models.stack.apply_segment``).
  * ``microbatch_target``: read by ``launch.steps.auto_microbatches``.
  * ``embed_d_sharded`` and ``megatron_pairs`` choose the partition specs
    of ``sharding.rules``, and ``serve_weight_stationary`` the decode
    step's weight placement in ``launch.steps.jitted_step``: the dry run
    (``launch.dryrun``) describes them on the production meshes. On one
    card they, ``ssm_shard_hints`` and ``seq_parallel`` change nothing:
    there is no mesh to shard over, as the reference's hints are no-ops
    without one.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class Flags:
    # prefill attention computed in q-chunks (online per-chunk masking,
    # window layers slice kv) instead of materializing S×S scores.
    blockwise_prefill: bool = False
    q_chunk: int = 512
    # embedding table (V, d): shard d over 'model' instead of V.
    embed_d_sharded: bool = False
    # decode: keep weights replicated over the data axes.
    serve_weight_stationary: bool = False
    # sharding hints on SSM/RWKV scan states (keep heads on 'model').
    ssm_shard_hints: bool = False
    # gradient-accumulation target: local microbatch sequences per step.
    microbatch_target: int = 2
    # nested (sqrt) remat: checkpointed groups of this many checkpointed
    # layers — residual storage drops from O(n_layers) to
    # O(n_layers/g + g) hiddens at ~+33% recompute.
    nested_remat_group: int = 1
    # chunked cross-entropy: logits + CE per sequence chunk under remat
    # instead of the full (B, S, V) f32 logits.
    chunked_ce: int = 0          # 0 = off; else chunk length
    # Megatron col/row-parallel pairing by parameter name.
    megatron_pairs: bool = False
    # Megatron sequence parallelism of the residual stream.
    seq_parallel: bool = False


_FLAGS = Flags()


def get() -> Flags:
    return _FLAGS


def set_flags(**kw) -> Flags:
    global _FLAGS
    _FLAGS = replace(_FLAGS, **kw)
    return _FLAGS


def parse_opts(opts: str) -> Flags:
    """'blockwise_prefill,serve_weight_stationary,microbatch_target=4'."""
    kw = {}
    for item in filter(None, opts.split(",")):
        if "=" in item:
            k, v = item.split("=", 1)
            kw[k] = int(v)
        else:
            kw[item] = True
    return set_flags(**kw)
