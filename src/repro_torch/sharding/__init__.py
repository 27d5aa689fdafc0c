"""Placement rules of the port: ``surf_rules`` (which device of a
``launch.mesh.Mesh`` holds which agent block, seed lane or Q slice) and
``rules`` (the LLM's partition specs on the production meshes, which the
dry run reads).

JAX-only: ``stacked_agent_sharding`` and ``train_state_shardings`` (see
``surf_rules``).
"""
from repro_torch.sharding.rules import (PartitionSpec,  # noqa: F401
                                        batch_shardings, batch_spec,
                                        cache_shardings, cache_spec,
                                        data_axes, param_spec,
                                        params_shardings)
from repro_torch.sharding.surf_rules import (Placement,  # noqa: F401
                                             Replicas, ShardedPool,
                                             agent_sharding,
                                             axis_for_role, check_divides,
                                             make_q_select, mesh_fingerprint,
                                             q_select_axis, replicated,
                                             seed_scan_shardings,
                                             seed_sharding,
                                             stacked_q_sharding,
                                             train_scan_shardings)

__all__ = ["PartitionSpec", "param_spec", "params_shardings", "batch_spec",
           "batch_shardings", "cache_spec", "cache_shardings", "data_axes",
           "Placement", "Replicas", "ShardedPool", "agent_sharding",
           "axis_for_role", "check_divides", "make_q_select",
           "mesh_fingerprint", "q_select_axis", "replicated",
           "seed_scan_shardings", "seed_sharding", "stacked_q_sharding",
           "train_scan_shardings"]
