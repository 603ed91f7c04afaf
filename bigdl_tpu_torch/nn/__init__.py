"""bigdl_tpu_torch.nn: the Module core and its layers (port of
``bigdl_tpu/nn``): ``Module``/``Criterion``, the linear family, the
containers, the activations, attention, convolution, pooling,
normalization, dropout, the shape layers and the table ops, and the
criterions the training paths use.  Recurrence (``recurrent.py``),
detection (``Nms``) and the other criterions are ROADMAP Queue 1 item
12."""
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
from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                     SpatialConvolutionMap,
                                     SpatialDilatedConvolution,
                                     SpatialFullConvolution,
                                     SpatialShareConvolution)
from bigdl_tpu_torch.nn.criterions import (ClassNLLCriterion,
                                           TimeDistributedCriterion)
from bigdl_tpu_torch.nn.dropout import Dropout, GradientReversal, L1Penalty
from bigdl_tpu_torch.nn.initialization import (BilinearFiller, Default,
                                               InitializationMethod, Xavier)
from bigdl_tpu_torch.nn.linear import (MM, MV, Add, AddConstant, Bilinear,
                                       CAdd, CMul, Cosine, CosineDistance,
                                       DotProduct, Euclidean, Linear,
                                       LookupTable, Mul, MulConstant,
                                       PairwiseDistance, Scale)
from bigdl_tpu_torch.nn.module import Criterion, Module
from bigdl_tpu_torch.nn.normalization import (
    BatchNormalization, LayerNorm, Normalize, SpatialBatchNormalization,
    SpatialContrastiveNormalization, SpatialCrossMapLRN,
    SpatialDivisiveNormalization, SpatialSubtractiveNormalization,
    layer_norm)
from bigdl_tpu_torch.nn.pooling import (RoiPooling, SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.shape import (Contiguous, Copy, Echo, Identity, Index,
                                      InferReshape, MaskedSelect, Narrow,
                                      Padding, Replicate, Reshape, Reverse,
                                      Select, SpatialZeroPadding, Squeeze,
                                      Transpose, Unsqueeze, View)
from bigdl_tpu_torch.nn.table_ops import (CAddTable, CDivTable, CMaxTable,
                                          CMinTable, CMulTable, CSubTable,
                                          Max, Mean, Min, Sum)

__all__ = [
    "Abs", "Add", "AddConstant", "BatchNormalization", "Bilinear",
    "BilinearFiller", "Bottle", "CAdd", "CAddTable", "CDivTable", "CMaxTable",
    "CMinTable", "CMul", "CMulTable", "CSubTable", "Clamp",
    "ClassNLLCriterion", "Concat", "ConcatTable", "Container", "Contiguous",
    "Copy", "Cosine", "CosineDistance", "Criterion", "Default", "DepthConcat",
    "DotProduct", "Dropout", "ELU", "Echo", "Euclidean", "Exp", "FlattenTable",
    "GELU", "GradientReversal", "HardShrink", "HardTanh", "Identity", "Index",
    "InferReshape", "InitializationMethod", "JoinTable", "L1Penalty",
    "LayerNorm", "LeakyReLU", "Linear", "Log", "LogSigmoid", "LogSoftMax",
    "LookupTable", "MM", "MV", "MapTable", "MaskedSelect", "Max", "Mean",
    "Min", "MixtureTable", "Module", "Mul", "MulConstant",
    "MultiHeadAttention", "Narrow", "NarrowTable", "Normalize", "PReLU",
    "Padding", "PairwiseDistance", "ParallelTable", "Power", "RReLU", "ReLU",
    "ReLU6", "Replicate", "Reshape", "Reverse", "RoiPooling", "Scale",
    "Select", "SelectTable", "Sequential", "Sigmoid", "SoftMax", "SoftMin",
    "SoftPlus", "SoftShrink", "SoftSign", "SpatialAveragePooling",
    "SpatialBatchNormalization", "SpatialContrastiveNormalization",
    "SpatialConvolution", "SpatialConvolutionMap", "SpatialCrossMapLRN",
    "SpatialDilatedConvolution", "SpatialDivisiveNormalization",
    "SpatialFullConvolution", "SpatialMaxPooling", "SpatialShareConvolution",
    "SpatialSubtractiveNormalization", "SpatialZeroPadding", "SplitTable",
    "Sqrt", "Square", "Squeeze", "Sum", "Tanh", "TanhShrink", "Threshold",
    "TimeDistributedCriterion", "Transpose", "Unsqueeze", "View", "Xavier",
    "dot_product_attention", "layer_norm", "segment_mask"]
