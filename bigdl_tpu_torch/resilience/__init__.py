"""bigdl_tpu_torch.resilience: the failure taxonomy and the fault
injector (port of ``bigdl_tpu/resilience``'s ``errors`` and ``faults``;
the retry policy and the replica set wait for their slices)."""
from __future__ import annotations

from bigdl_tpu_torch.resilience.errors import (BackendLostError,
                                               ServingDeadlineExceeded,
                                               ServingOverloaded,
                                               TransientBackendError,
                                               classify_error)
from bigdl_tpu_torch.resilience.faults import (FaultInjector, fault_point,
                                               refresh_from_env)

__all__ = ["BackendLostError", "TransientBackendError", "ServingOverloaded",
           "ServingDeadlineExceeded", "classify_error", "FaultInjector",
           "fault_point", "refresh_from_env"]
