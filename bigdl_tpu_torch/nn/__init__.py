"""bigdl_tpu_torch.nn: the Module core and its layers (port of
``bigdl_tpu/nn``): ``Module``/``Criterion``, the linear family, the
containers, the activations, attention, the criterions and a layer
norm.  The rest of the reference's layer zoo (convolution, pooling,
normalization, recurrence, the table ops) is ROADMAP Queue 1 item 12."""
from bigdl_tpu_torch.nn.activations import (ELU, GELU, Abs, Clamp, Exp,
                                            HardShrink, HardTanh, LeakyReLU,
                                            Log, LogSigmoid, LogSoftMax,
                                            Power, PReLU, ReLU, ReLU6, RReLU,
                                            Sigmoid, SoftMax, SoftMin,
                                            SoftPlus, SoftShrink, SoftSign,
                                            Sqrt, Square, Tanh, TanhShrink,
                                            Threshold)
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          dot_product_attention,
                                          segment_mask)
from bigdl_tpu_torch.nn.containers import (Bottle, Concat, ConcatTable,
                                           Container, DepthConcat,
                                           FlattenTable, JoinTable, MapTable,
                                           MixtureTable, NarrowTable,
                                           ParallelTable, SelectTable,
                                           Sequential, SplitTable)
from bigdl_tpu_torch.nn.criterions import (ClassNLLCriterion,
                                           TimeDistributedCriterion)
from bigdl_tpu_torch.nn.initialization import (BilinearFiller, Default,
                                               InitializationMethod, Xavier)
from bigdl_tpu_torch.nn.linear import (MM, MV, Add, AddConstant, Bilinear,
                                       CAdd, CMul, Cosine, CosineDistance,
                                       DotProduct, Euclidean, Linear,
                                       LookupTable, Mul, MulConstant,
                                       PairwiseDistance, Scale)
from bigdl_tpu_torch.nn.module import Criterion, Module
from bigdl_tpu_torch.nn.normalization import layer_norm

__all__ = [
    "Abs", "Add", "AddConstant", "Bilinear", "BilinearFiller", "Bottle",
    "CAdd", "CMul", "Clamp", "ClassNLLCriterion", "Concat", "ConcatTable",
    "Container", "Cosine", "CosineDistance", "Criterion", "Default",
    "DepthConcat", "DotProduct", "ELU", "Euclidean", "Exp", "FlattenTable",
    "GELU", "HardShrink", "HardTanh", "InitializationMethod", "JoinTable",
    "LeakyReLU", "Linear", "Log", "LogSigmoid", "LogSoftMax", "LookupTable",
    "MM", "MV", "MapTable", "MixtureTable", "Module", "Mul", "MulConstant",
    "MultiHeadAttention", "NarrowTable", "PReLU", "PairwiseDistance",
    "ParallelTable", "Power", "RReLU", "ReLU", "ReLU6", "Scale",
    "SelectTable", "Sequential", "Sigmoid", "SoftMax", "SoftMin",
    "SoftPlus", "SoftShrink", "SoftSign", "SplitTable", "Sqrt", "Square",
    "Tanh", "TanhShrink", "Threshold", "TimeDistributedCriterion", "Xavier",
    "dot_product_attention", "layer_norm", "segment_mask"]
