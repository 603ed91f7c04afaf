from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          dot_product_attention,
                                          segment_mask)
from bigdl_tpu_torch.nn.criterions import (ClassNLLCriterion,
                                           TimeDistributedCriterion)
from bigdl_tpu_torch.nn.normalization import layer_norm

__all__ = ["ClassNLLCriterion", "MultiHeadAttention",
           "TimeDistributedCriterion", "dot_product_attention", "layer_norm",
           "segment_mask"]
