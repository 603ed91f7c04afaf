"""bigdl_tpu_torch.traffic: the SLO controller (port of
``bigdl_tpu/traffic``'s ``slo``; the load generator, the chaos replayer
and the incident log wait for ROADMAP Queue 1 item 11.6)."""
from bigdl_tpu_torch.traffic.slo import SLOController

__all__ = ["SLOController"]
