from bigdl_tpu_torch.serving.errors import (PoolExhausted, RequestExceedsPool,
                                            ServingClosed,
                                            ServingDeadlineExceeded,
                                            ServingOverloaded,
                                            ServingQueueFull)
from bigdl_tpu_torch.serving.kvtier import HostBlockStore
from bigdl_tpu_torch.serving.lm_engine import (LMMetrics, LMServingEngine,
                                               LMStream, StreamTruncation,
                                               prefill_bucket_lengths)
from bigdl_tpu_torch.serving.spec import SpecConfig

__all__ = ["HostBlockStore", "LMMetrics", "LMServingEngine", "LMStream",
           "PoolExhausted", "RequestExceedsPool", "ServingClosed",
           "ServingDeadlineExceeded", "ServingOverloaded", "ServingQueueFull",
           "SpecConfig", "StreamTruncation", "prefill_bucket_lengths"]
