"""bigdl_tpu_torch.nn: the Module core and its layers (port of
``bigdl_tpu/nn``): ``Module``/``Criterion``, the linear family, the
containers, the activations, attention, convolution, pooling,
normalization, dropout, the shape layers, the table ops, the recurrent
stack (``recurrent.py``), detection (``Nms``) and the 24 criterions."""
from bigdl_tpu_torch.nn.activations import (ELU, GELU, Abs, Clamp, Exp,
                                            HardShrink, HardTanh, LeakyReLU,
                                            Log, LogSigmoid, LogSoftMax,
                                            Power, PReLU, ReLU, ReLU6, RReLU,
                                            Sigmoid, SoftMax, SoftMin,
                                            SoftPlus, SoftShrink, SoftSign,
                                            Sqrt, Square, Tanh, TanhShrink,
                                            Threshold)
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          blockwise_attention,
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
from bigdl_tpu_torch.nn.criterions import (
    AbsCriterion, BCECriterion, ClassNLLCriterion, ClassSimplexCriterion,
    CosineEmbeddingCriterion, CriterionTable, CrossEntropyCriterion,
    DistKLDivCriterion, HingeEmbeddingCriterion, L1Cost,
    L1HingeEmbeddingCriterion, MarginCriterion, MarginRankingCriterion,
    MSECriterion, MultiCriterion, MultiLabelMarginCriterion,
    MultiLabelSoftMarginCriterion, MultiMarginCriterion, ParallelCriterion,
    SmoothL1Criterion, SmoothL1CriterionWithWeights, SoftmaxWithCriterion,
    SoftMarginCriterion, TimeDistributedCriterion)
from bigdl_tpu_torch.nn.detection import Nms, nms
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
from bigdl_tpu_torch.nn.recurrent import (GRU, LSTM, BiRecurrent, Cell,
                                          Recurrent, RnnCell,
                                          TimeDistributed)
from bigdl_tpu_torch.nn.shape import (Contiguous, Copy, Echo, Identity, Index,
                                      InferReshape, MaskedSelect, Narrow,
                                      Padding, Replicate, Reshape, Reverse,
                                      Select, SpatialZeroPadding, Squeeze,
                                      Transpose, Unsqueeze, View)
from bigdl_tpu_torch.nn.table_ops import (CAddTable, CDivTable, CMaxTable,
                                          CMinTable, CMulTable, CSubTable,
                                          Max, Mean, Min, Sum)

__all__ = [
    "Abs", "AbsCriterion", "Add", "AddConstant", "BCECriterion",
    "BatchNormalization", "BiRecurrent", "Bilinear", "BilinearFiller",
    "Bottle", "CAdd", "CAddTable", "CDivTable", "CMaxTable", "CMinTable",
    "CMul", "CMulTable", "CSubTable", "Cell", "Clamp", "ClassNLLCriterion",
    "ClassSimplexCriterion", "Concat", "ConcatTable", "Container",
    "Contiguous", "Copy", "Cosine", "CosineDistance",
    "CosineEmbeddingCriterion", "Criterion", "CriterionTable",
    "CrossEntropyCriterion", "Default", "DepthConcat", "DistKLDivCriterion",
    "DotProduct", "Dropout", "ELU", "Echo", "Euclidean", "Exp", "FlattenTable",
    "GELU", "GRU", "GradientReversal", "HardShrink", "HardTanh",
    "HingeEmbeddingCriterion", "Identity", "Index", "InferReshape",
    "InitializationMethod", "JoinTable", "L1Cost", "L1HingeEmbeddingCriterion",
    "L1Penalty", "LSTM", "LayerNorm", "LeakyReLU", "Linear", "Log",
    "LogSigmoid", "LogSoftMax", "LookupTable", "MM", "MSECriterion", "MV",
    "MapTable", "MarginCriterion", "MarginRankingCriterion", "MaskedSelect",
    "Max", "Mean", "Min", "MixtureTable", "Module", "Mul", "MulConstant",
    "MultiCriterion", "MultiHeadAttention", "MultiLabelMarginCriterion",
    "MultiLabelSoftMarginCriterion", "MultiMarginCriterion", "Narrow",
    "NarrowTable", "Nms", "Normalize", "PReLU", "Padding", "PairwiseDistance",
    "ParallelCriterion", "ParallelTable", "Power", "RReLU", "ReLU", "ReLU6",
    "Recurrent", "Replicate", "Reshape", "Reverse", "RnnCell", "RoiPooling",
    "Scale", "Select", "SelectTable", "Sequential", "Sigmoid",
    "SmoothL1Criterion", "SmoothL1CriterionWithWeights", "SoftMarginCriterion",
    "SoftMax", "SoftMin", "SoftPlus", "SoftShrink", "SoftSign",
    "SoftmaxWithCriterion", "SpatialAveragePooling",
    "SpatialBatchNormalization", "SpatialContrastiveNormalization",
    "SpatialConvolution", "SpatialConvolutionMap", "SpatialCrossMapLRN",
    "SpatialDilatedConvolution", "SpatialDivisiveNormalization",
    "SpatialFullConvolution", "SpatialMaxPooling", "SpatialShareConvolution",
    "SpatialSubtractiveNormalization", "SpatialZeroPadding", "SplitTable",
    "Sqrt", "Square", "Squeeze", "Sum", "Tanh", "TanhShrink", "Threshold",
    "TimeDistributed", "TimeDistributedCriterion", "Transpose", "Unsqueeze",
    "View", "Xavier", "blockwise_attention", "dot_product_attention", "layer_norm", "nms",
    "segment_mask"]
