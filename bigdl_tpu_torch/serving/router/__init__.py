"""bigdl_tpu_torch.serving.router: cache-aware replica dispatch (port of
``bigdl_tpu/serving/router``).

Prefix-affinity routing over per-replica radix summaries, session
stickiness that composes with host-tier hibernation, and the routed LM
replica set on the resilience breaker core::

    from bigdl_tpu_torch.serving.router import LMReplicaSet, RadixRouter

    rset = LMReplicaSet(model, n_replicas=2,
                        router=RadixRouter(affinity_weight=0.7),
                        slots=8, max_new_tokens=32)
    s = rset.submit(prompt, session_id="chat-42")
    for tok in s.tokens():
        ...
"""
from bigdl_tpu_torch.serving.router.replicaset import (LMReplicaSet,
                                                       RoutedLMStream)
from bigdl_tpu_torch.serving.router.router import RadixRouter
from bigdl_tpu_torch.serving.router.sessions import SessionTable
from bigdl_tpu_torch.serving.router.summary import RadixSummary

__all__ = ["LMReplicaSet", "RoutedLMStream", "RadixRouter",
           "SessionTable", "RadixSummary"]
