from bigdl_tpu_torch.resilience.replicaset import HedgePolicy
from bigdl_tpu_torch.serving.batcher import (DynamicBatcher,
                                             power_of_two_buckets)
from bigdl_tpu_torch.serving.compile_cache import CompileCache
from bigdl_tpu_torch.serving.disagg import DisaggCoordinator
from bigdl_tpu_torch.serving.engine import ServingEngine
from bigdl_tpu_torch.serving.errors import (PoolExhausted, RequestExceedsPool,
                                            ServingClosed,
                                            ServingDeadlineExceeded,
                                            ServingOverloaded,
                                            ServingQueueFull)
from bigdl_tpu_torch.serving.kvcache import BlockPool, RadixCache
from bigdl_tpu_torch.serving.kvtier import HostBlockStore
from bigdl_tpu_torch.serving.host_transfer import HostStager
from bigdl_tpu_torch.serving.lm_engine import (KVHandoff, LMMetrics,
                                               LMServingEngine, LMStream,
                                               StreamTruncation,
                                               prefill_bucket_lengths)
from bigdl_tpu_torch.serving.metrics import LatencyHistogram, ServingMetrics
from bigdl_tpu_torch.serving.placement import (DeviceTopology, MeshSlice,
                                               MeshSlicer, PlacementError,
                                               PlacementPolicy,
                                               serving_tp_rules,
                                               shard_params_chunked)
from bigdl_tpu_torch.serving.router import (LMReplicaSet, RadixRouter,
                                            RadixSummary, RoutedLMStream,
                                            SessionTable)
from bigdl_tpu_torch.serving.spec import DraftModel, SpecConfig, SpecMetrics

__all__ = ["BlockPool", "CompileCache", "DeviceTopology", "DisaggCoordinator",
           "DraftModel", "DynamicBatcher", "HedgePolicy", "HostBlockStore",
           "HostStager", "KVHandoff", "LMMetrics", "LMReplicaSet",
           "LMServingEngine", "LMStream", "LatencyHistogram", "MeshSlice",
           "MeshSlicer", "PlacementError", "PlacementPolicy",
           "PoolExhausted", "RadixCache", "RadixRouter", "RadixSummary",
           "RequestExceedsPool", "RoutedLMStream", "ServingClosed",
           "ServingDeadlineExceeded", "ServingEngine", "ServingMetrics",
           "ServingOverloaded", "ServingQueueFull", "SessionTable",
           "SpecConfig", "SpecMetrics", "StreamTruncation",
           "power_of_two_buckets", "prefill_bucket_lengths",
           "serving_tp_rules", "shard_params_chunked"]
