"""Three-term roofline of one described step on NVIDIA H100s: the port of
``repro.launch.roofline``, with the H100's constants in place of the TPU's.

  compute   = flops / PEAK_FLOPS          (per device, bf16)
  memory    = bytes / HBM_BW              (per device)
  collective= coll_bytes / NVLINK_BW      (per device, one direction)

flops / bytes / coll_bytes come from the dry run's count
(``launch.hlo_cost``: the step run once on ``meta``, split evenly over
the devices; collectives derived from the partition specs), per-device
quantities. MODEL_FLOPS = 6·N_active·tokens (train) or 2·N_active·tokens
(prefill / decode); the ratio MODEL_FLOPS / (chips · flops) exposes remat,
dispatch and padding waste.

The constants are NVIDIA's data-sheet values for the H100 80GB HBM3 SXM
at its 700 W power limit (dense rates, no sparsity), not measurements: a
card set below 700 W runs slower under load.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 80GB HBM3 SXM, 700 W, data sheet (not measured):
PEAK_FLOPS = 989e12     # bf16 dense tensor-core FLOP/s per card
HBM_BW = 3.35e12        # HBM3 bytes/s per card
NVLINK_BW = 450e9       # NVLink 4 bytes/s per card, each direction
ICI_BW = NVLINK_BW      # the reference's name for the chip-to-chip link


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes: float
    coll_bytes: float
    model_flops: float
    chips: int

    @property
    def dominant(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self):
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def bound_s(self):
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self):
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant,
                "flops_per_chip": self.flops, "bytes_per_chip": self.bytes,
                "coll_bytes_per_chip": self.coll_bytes,
                "model_flops": self.model_flops,
                "useful_flop_ratio": self.useful_flop_ratio,
                "chips": self.chips}


def model_flops(cfg, shape) -> float:
    n_active = cfg.param_count(active_only=True)
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # decode: 1 token/seq


def compute_roofline(parsed: dict, cfg, shape, chips: int) -> Roofline:
    return Roofline(
        compute_s=parsed["flops"] / PEAK_FLOPS,
        memory_s=parsed["bytes"] / HBM_BW,
        collective_s=parsed["collective_bytes"] / NVLINK_BW,
        flops=parsed["flops"], bytes=parsed["bytes"],
        coll_bytes=parsed["collective_bytes"],
        model_flops=model_flops(cfg, shape), chips=chips)
