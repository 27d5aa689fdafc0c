"""Placement rules of the port (``surf_rules``): which device of a
``launch.mesh.Mesh`` holds which agent block, seed lane or Q slice. The
reference's LLM rules (``sharding.rules``) are ROADMAP queue 1."""
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

__all__ = ["Placement", "Replicas", "ShardedPool", "agent_sharding", "axis_for_role",
           "check_divides", "make_q_select", "mesh_fingerprint",
           "q_select_axis", "replicated", "seed_scan_shardings",
           "seed_sharding", "stacked_q_sharding", "train_scan_shardings"]
