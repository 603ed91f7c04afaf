"""bigdl_tpu_torch.traffic: the production traffic harness (port of
``bigdl_tpu/traffic``).

- :mod:`~bigdl_tpu_torch.traffic.loadgen`: open-loop, deterministic,
  seeded arrival traces (Poisson, bursty, diurnal; mixed prompt and
  output lengths; deadline and cancel menus) replayed against an engine;
  arrivals never wait on completions, so the saturation knee shows.
- :mod:`~bigdl_tpu_torch.traffic.slo`: the SLO controller (windowed p99,
  scale-then-shed, the memory ledger's scale-up gate) and
  :func:`~bigdl_tpu_torch.traffic.slo.detect_knee`.
- :mod:`~bigdl_tpu_torch.traffic.chaos`: the incident log replayed as a
  seeded fault schedule through the port's ``fault_point`` sites,
  mid-load.
"""
from bigdl_tpu_torch.traffic.chaos import ChaosReplayer, build_schedule
from bigdl_tpu_torch.traffic.incidents import (append_incident,
                                               inter_incident_gaps,
                                               load_incidents)
from bigdl_tpu_torch.traffic.loadgen import (Arrival, LoadReport,
                                             TraceLoadGenerator)
from bigdl_tpu_torch.traffic.slo import SLOController, detect_knee

__all__ = [
    "Arrival", "LoadReport", "TraceLoadGenerator",
    "SLOController", "detect_knee",
    "ChaosReplayer", "build_schedule",
    "load_incidents", "append_incident", "inter_incident_gaps",
]
