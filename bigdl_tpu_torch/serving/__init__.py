from bigdl_tpu_torch.serving.errors import (PoolExhausted, RequestExceedsPool,
                                            ServingClosed, ServingQueueFull)
from bigdl_tpu_torch.serving.lm_engine import (LMMetrics, LMServingEngine,
                                               LMStream,
                                               prefill_bucket_lengths)
from bigdl_tpu_torch.serving.spec import SpecConfig

__all__ = ["LMMetrics", "LMServingEngine", "LMStream", "PoolExhausted",
           "RequestExceedsPool", "ServingClosed", "ServingQueueFull",
           "SpecConfig", "prefill_bucket_lengths"]
