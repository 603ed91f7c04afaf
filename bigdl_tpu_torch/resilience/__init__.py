"""bigdl_tpu_torch.resilience: the failure taxonomy, the fault injector,
the bounded retry policy and the replica-set failover core (port of
``bigdl_tpu/resilience``'s ``errors``, ``faults``, ``retry`` and the
engine-agnostic half of ``replicaset``; the padded-batch
``ReplicaSet`` waits for ROADMAP Queue 1 item 11.6)."""
from __future__ import annotations

from bigdl_tpu_torch.resilience.errors import (BackendLostError,
                                               ServingDeadlineExceeded,
                                               ServingOverloaded,
                                               TransientBackendError,
                                               classify_error)
from bigdl_tpu_torch.resilience.faults import (FaultInjector, fault_point,
                                               refresh_from_env)
from bigdl_tpu_torch.resilience.retry import with_backoff

__all__ = ["BackendLostError", "TransientBackendError", "ServingOverloaded",
           "ServingDeadlineExceeded", "classify_error", "FaultInjector",
           "fault_point", "refresh_from_env", "with_backoff"]
