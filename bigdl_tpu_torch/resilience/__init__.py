"""bigdl_tpu_torch.resilience: the failure taxonomy, the fault injector,
the bounded retry policy and replica-set failover (port of
``bigdl_tpu/resilience``: ``errors``, ``faults``, ``retry`` and
``replicaset``)."""
from __future__ import annotations

from bigdl_tpu_torch.resilience.errors import (BackendLostError,
                                               ServingDeadlineExceeded,
                                               ServingOverloaded,
                                               TransientBackendError,
                                               classify_error)
from bigdl_tpu_torch.resilience.faults import (FaultInjector, fault_point,
                                               refresh_from_env)
from bigdl_tpu_torch.resilience.replicaset import (HedgePolicy,
                                                   ReplicaSet)
from bigdl_tpu_torch.resilience.retry import with_backoff

__all__ = ["BackendLostError", "TransientBackendError", "ServingOverloaded",
           "ServingDeadlineExceeded", "classify_error", "FaultInjector",
           "fault_point", "refresh_from_env", "with_backoff", "HedgePolicy",
           "ReplicaSet"]
