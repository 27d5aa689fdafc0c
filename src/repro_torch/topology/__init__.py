"""Communication topologies (numpy, bit-equal to the reference):

  * ``families`` — graph generators, mixing-weight rules and spectral
    diagnostics (algebraic connectivity, SLEM);
  * ``schedule`` — time-varying S_t stacked as a (T, n, n) tensor
    (``TopologySchedule``) that the training drivers index by the
    carried meta-step.

The reference's third pillar, ``halo`` (block-sparse ``ppermute``
mixing), is ROADMAP queue 1 item 8.
"""
from repro_torch.topology import families, schedule  # noqa: F401
from repro_torch.topology.families import build_topology  # noqa: F401
from repro_torch.topology.schedule import TopologySchedule  # noqa: F401
