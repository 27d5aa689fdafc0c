"""The port's SURF dry run (``launch.surf_dryrun``, ``configs.surf_paper
.DRYRUN``) on the CPU: the config and the batch specs against the
reference's (both tasks), the collective counts against the halo plans
(the port's ``halo_exchange_rows`` and the reference's own plan of the
same matrix) and against counts by hand, and the records of the
described meta-step.

Classification labels are int64 in the port (its tasks index with
them) and int32 in the reference; every other dtype and every shape is
the reference's.
"""
import numpy as np
import pytest
import torch

from repro.configs import surf_paper as JSP
from repro.launch.surf_dryrun import surf_batch_specs as jsurf_batch_specs
from repro.topology import halo as JH
from repro.topology.families import build_topology as jbuild_topology
from repro_torch.configs import surf_paper as SP
from repro_torch.core.tasks import resolve_task
from repro_torch.launch import surf_dryrun as SD
from repro_torch.launch.mesh import make_production_mesh, make_surf_mesh
from repro_torch.topology import halo as H
from repro_torch.topology.families import build_topology

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

D = 512 * 10 + 10          # DRYRUN's head dim: F C + C


def test_dryrun_config_matches_reference():
    assert repr(SP.DRYRUN) == repr(JSP.DRYRUN)
    assert resolve_task(SP.DRYRUN).dim == D
    assert SD.mixing_rounds(SP.DRYRUN) == 2 * (2 * 10 - 1)
    assert SD.mixing_rounds(SP.DRYRUN, infer=True) == 2 * 10


@pytest.mark.parametrize("cfg", ["DRYRUN", "SPARSE_SMOKE"])
def test_surf_batch_specs_match_reference(cfg):
    port, ref = SD.surf_batch_specs(getattr(SP, cfg)), jsurf_batch_specs(
        getattr(JSP, cfg))
    assert port.keys() == ref.keys()
    for k, v in port.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(ref[k].shape), k
        want = str(ref[k].dtype)
        if want == "int32":
            assert v.dtype == torch.int64, k
        else:
            assert str(v.dtype) == f"torch.{want}", k


def _theta_bytes(cfg):
    from repro_torch.engine.resume import state_template
    return sum(t.numel() * 4 for t in state_template(cfg).theta.values())


@pytest.mark.parametrize("multi_pod", [False, True])
def test_meta_step_collectives_by_hand(multi_pod):
    """Dense: an all-gather of W per round over the 16 (or 32) agent
    shards; ring and halo: the plan's exchange rows (the reference's own
    plan of the same matrix agrees) × d × 4 per round; training adds θ's
    gradient all-reduce."""
    cfg = SP.DRYRUN
    mesh = make_production_mesh(multi_pod=multi_pod)
    s = 32 if multi_pod else 16
    A, S = build_topology(cfg.topology, cfg.n_agents, degree=cfg.degree,
                          seed=0)
    jA, jS = jbuild_topology(cfg.topology, cfg.n_agents, degree=cfg.degree,
                             seed=0)
    np.testing.assert_array_equal(np.asarray(S), np.asarray(jS))
    rounds, theta = 2 * 19, _theta_bytes(cfg)
    allreduce = 2 * (s - 1) / s * theta
    total, coll = SD.meta_step_collective_bytes(cfg, S, mesh)
    assert coll == {"all-gather": rounds * (s - 1) / s * 256 * D * 4,
                    "all-reduce": allreduce}
    assert total == sum(coll.values())
    _, infer = SD.meta_step_collective_bytes(cfg, S, mesh, infer=True)
    assert infer == {"all-gather": 20 * (s - 1) / s * 256 * D * 4}
    for kind in ("ring", "halo"):
        mix = SD._mixer(kind, mesh, cfg, A, S)
        rows = H.halo_exchange_rows(mix.plan[1])
        assert rows == JH.halo_exchange_rows(JH.halo_plan(np.asarray(S),
                                                          16)[1]) == 2
        _, coll = SD.meta_step_collective_bytes(cfg, S, mesh, mix)
        assert coll == {"collective-permute": rounds * rows * D * 4,
                        "all-reduce": allreduce}


def test_seed_meta_step_collectives_by_hand():
    """4 seeds on a (2 seed × 4 agent) mesh: each device runs 2 lanes; a
    seed halo mixer moves its union plan's rows per lane and round."""
    cfg = SP.DRYRUN
    mesh = make_surf_mesh(2, 4, devices=["meta"] * 8)
    S_stack = np.stack([build_topology("regular", cfg.n_agents, degree=3,
                                       seed=i)[1] for i in range(4)])
    theta, rounds = _theta_bytes(cfg), 2 * 19
    _, coll = SD.seed_meta_step_collective_bytes(cfg, S_stack, mesh)
    assert coll == {"all-gather": 2 * rounds * 3 / 4 * 256 * D * 4,
                    "all-reduce": 2 * 2 * 3 / 4 * theta}
    mix = H.make_seed_halo_mix(mesh, "agent", S_stack)
    rows = H.halo_exchange_rows(mix.plan[1])
    _, plans = H.halo_plan((np.abs(S_stack) > 0).any(0).astype(np.float32),
                           4)
    assert rows == H.halo_exchange_rows(plans) > 0
    _, coll = SD.seed_meta_step_collective_bytes(cfg, S_stack, mesh, mix)
    assert coll["collective-permute"] == 2 * rounds * rows * D * 4


def test_q_sharded_select_moves_one_dataset_whatever_q():
    cfg = SP.DRYRUN
    mesh = make_surf_mesh(1, 4, devices=["meta"] * 4)
    one = sum(t.numel() * t.element_size()
              for t in SD.surf_batch_specs(cfg).values())
    for n_q in (4, 8, 16):
        assert SD.q_scan_collective_bytes(cfg, None, mesh, n_q) == (
            one, {"select": one})
        naive, _ = SD.q_scan_collective_bytes(cfg, None, mesh, n_q,
                                              naive_select=True)
        assert naive == 3 / 4 * n_q * one
        assert SD.q_scan_collective_bytes(cfg, None, mesh, n_q,
                                          q_sharded=False) == (0.0, {})
    assert SD.q_scan_collective_bytes(cfg, None, mesh, 8, eval_q=4)[0] == \
        one * 1.5
    assert SD.q_scan_collective_bytes(cfg, None, mesh, 6) == (0.0, {})


@pytest.mark.parametrize("mix,infer", [(None, False), ("halo-sched", False),
                                       (None, True)])
def test_lower_surf_step_records(mix, infer):
    rec = SD.lower_surf_step(mix=mix, infer=infer)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["simulated"] and rec["device"] == "meta" and rec["chips"] == 256
    assert rec["arch"] == "surf-udgd" + (f"-{mix}" if mix else "")
    assert rec["shape"] == "n256_L10" + ("_infer" if infer else "")
    assert rec["parsed"]["collective_bytes"] == sum(
        rec["parsed"]["collectives"].values()) > 0
    assert rec["parsed"]["matmul_flops"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["per_device_total"] > rec["memory"][
        "argument_bytes"] > 0
    if mix:
        assert rec["exchange_rows_per_round"] > 0
