"""Communication topologies:

  * ``families`` — graph generators, mixing-weight rules and spectral
    diagnostics (numpy, bit-equal to the reference);
  * ``schedule`` — time-varying S_t stacked as a (T, n, n) tensor
    (``TopologySchedule``) that the training drivers index by the
    carried meta-step;
  * ``halo`` — block-sparse halo-exchange mixing over a mesh's agent
    axis for any mixing matrix (plans bit-equal to the reference's);
    schedules whose union support stays banded compose with it through
    ``make_scheduled_halo_mix``, seed batches through
    ``make_seed_halo_mix``.
"""
from repro_torch.topology import families, halo, schedule  # noqa: F401
from repro_torch.topology.families import build_topology  # noqa: F401
from repro_torch.topology.halo import (  # noqa: F401
    make_halo_mix, make_scheduled_halo_mix, make_seed_halo_mix)
from repro_torch.topology.schedule import TopologySchedule  # noqa: F401
