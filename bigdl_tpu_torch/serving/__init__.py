from bigdl_tpu_torch.resilience.replicaset import HedgePolicy
from bigdl_tpu_torch.serving.disagg import DisaggCoordinator
from bigdl_tpu_torch.serving.errors import (PoolExhausted, RequestExceedsPool,
                                            ServingClosed,
                                            ServingDeadlineExceeded,
                                            ServingOverloaded,
                                            ServingQueueFull)
from bigdl_tpu_torch.serving.kvcache import BlockPool, RadixCache
from bigdl_tpu_torch.serving.kvtier import HostBlockStore
from bigdl_tpu_torch.serving.lm_engine import (KVHandoff, LMMetrics,
                                               LMServingEngine, LMStream,
                                               StreamTruncation,
                                               prefill_bucket_lengths)
from bigdl_tpu_torch.serving.router import (LMReplicaSet, RadixRouter,
                                            RadixSummary, RoutedLMStream,
                                            SessionTable)
from bigdl_tpu_torch.serving.spec import SpecConfig

__all__ = ["BlockPool", "DisaggCoordinator", "HedgePolicy", "HostBlockStore",
           "KVHandoff", "LMMetrics", "LMReplicaSet", "LMServingEngine",
           "LMStream", "PoolExhausted", "RadixCache", "RadixRouter",
           "RadixSummary", "RequestExceedsPool", "RoutedLMStream",
           "ServingClosed", "ServingDeadlineExceeded", "ServingOverloaded",
           "ServingQueueFull", "SessionTable", "SpecConfig",
           "StreamTruncation", "prefill_bucket_lengths"]
