"""Disaggregated prefill/decode serving on one card: phase replicas of
one model with KV-chain migration between them (port of
``bigdl_tpu/serving/disagg``)."""
from bigdl_tpu_torch.serving.disagg.coordinator import DisaggCoordinator

__all__ = ["DisaggCoordinator"]
