"""ResNet (port of ``bigdl_tpu/models/resnet``; ref
models/resnet/ResNet.scala:58-230): basic blocks and bottlenecks with
shortcut types A (identity + zero-padded channels), B (1x1 projection
where the width changes) and C (projection everywhere), for CIFAR-10
and ImageNet.  Each block is a ConcatTable + CAddTable, as in the
reference.

``data_format="NHWC"`` builds the channels-last variant: every
convolution, pool and batch norm takes logical NHWC activations, which
cuDNN runs with its NHWC kernels, and the model takes NHWC input.
Weights are OIHW in both and the parameter trees are identical, so
checkpoints move between the formats.  NCHW data reaches an NHWC model
through one ``nn.Transpose([(2, 3), (3, 4)])`` in front.
"""
from __future__ import annotations

from bigdl_tpu_torch import nn


def _shortcut(n_in: int, n_out: int, stride: int, shortcut_type: str,
              df: str) -> nn.Module:
    use_conv = shortcut_type == "C" or (shortcut_type == "B" and n_in != n_out)
    channel_dim = 2 if df == "NCHW" else 4  # 1-based concat dim
    if use_conv:
        return nn.Sequential(
            nn.SpatialConvolution(n_in, n_out, 1, 1, stride, stride,
                                  data_format=df),
            nn.SpatialBatchNormalization(n_out, data_format=df),
        )
    if n_in != n_out:  # type A: strided identity + zero-pad channels
        return nn.Sequential(
            nn.SpatialAveragePooling(1, 1, stride, stride, data_format=df),
            nn.Concat(channel_dim, nn.Identity(), nn.MulConstant(0.0)),
        )
    return nn.Identity()


def _basic_block(n_in: int, n_out: int, stride: int, shortcut_type: str,
                 df: str) -> nn.Module:
    main = nn.Sequential(
        nn.SpatialConvolution(n_in, n_out, 3, 3, stride, stride, 1, 1,
                              data_format=df),
        nn.SpatialBatchNormalization(n_out, data_format=df),
        nn.ReLU(True),
        nn.SpatialConvolution(n_out, n_out, 3, 3, 1, 1, 1, 1, data_format=df),
        nn.SpatialBatchNormalization(n_out, data_format=df),
    )
    return nn.Sequential(
        nn.ConcatTable(main, _shortcut(n_in, n_out, stride, shortcut_type, df)),
        nn.CAddTable(True),
        nn.ReLU(True),
    )


def _bottleneck(n_in: int, n_mid: int, stride: int, shortcut_type: str,
                df: str) -> nn.Module:
    n_out = n_mid * 4
    main = nn.Sequential(
        nn.SpatialConvolution(n_in, n_mid, 1, 1, 1, 1, data_format=df),
        nn.SpatialBatchNormalization(n_mid, data_format=df),
        nn.ReLU(True),
        nn.SpatialConvolution(n_mid, n_mid, 3, 3, stride, stride, 1, 1,
                              data_format=df),
        nn.SpatialBatchNormalization(n_mid, data_format=df),
        nn.ReLU(True),
        nn.SpatialConvolution(n_mid, n_out, 1, 1, 1, 1, data_format=df),
        nn.SpatialBatchNormalization(n_out, data_format=df),
    )
    return nn.Sequential(
        nn.ConcatTable(main, _shortcut(n_in, n_out, stride, shortcut_type, df)),
        nn.CAddTable(True),
        nn.ReLU(True),
    )


def ResNet(class_num: int = 1000, depth: int = 50, shortcut_type: str = "B",
           dataset: str = "imagenet", data_format: str = "NCHW") -> nn.Sequential:
    """ResNet factory (ref ResNet.scala apply): ``dataset`` is 'imagenet'
    (7x7 stem, bottleneck for depth>=50) or 'cifar10' (3x3 stem,
    basic blocks, depth = 6n+2)."""
    df = data_format
    if df not in ("NCHW", "NHWC"):
        raise ValueError(f"unsupported data_format {df!r}")
    model = nn.Sequential()
    if dataset == "imagenet":
        cfgs = {18: ([2, 2, 2, 2], 512, _basic_block),
                34: ([3, 4, 6, 3], 512, _basic_block),
                50: ([3, 4, 6, 3], 2048, _bottleneck),
                101: ([3, 4, 23, 3], 2048, _bottleneck),
                152: ([3, 8, 36, 3], 2048, _bottleneck)}
        if depth not in cfgs:
            raise ValueError(f"unsupported imagenet depth {depth}")
        blocks, n_features, block = cfgs[depth]
        model.add(nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, data_format=df))
        model.add(nn.SpatialBatchNormalization(64, data_format=df))
        model.add(nn.ReLU(True))
        model.add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, data_format=df))
        widths = [64, 128, 256, 512]
        n_in = 64
        for i, (n_blocks, width) in enumerate(zip(blocks, widths)):
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                model.add(block(n_in, width, stride, shortcut_type, df))
                n_in = width * 4 if block is _bottleneck else width
        model.add(nn.SpatialAveragePooling(7, 7, 1, 1, data_format=df))
        model.add(nn.View(n_features))
        model.add(nn.Linear(n_features, class_num))
        model.add(nn.LogSoftMax())
    elif dataset == "cifar10":
        if (depth - 2) % 6 != 0:
            raise ValueError("cifar10 resnet depth must be 6n+2")
        n = (depth - 2) // 6
        model.add(nn.SpatialConvolution(3, 16, 3, 3, 1, 1, 1, 1, data_format=df))
        model.add(nn.SpatialBatchNormalization(16, data_format=df))
        model.add(nn.ReLU(True))
        n_in = 16
        for width, first_stride in ((16, 1), (32, 2), (64, 2)):
            for j in range(n):
                model.add(_basic_block(n_in, width, first_stride if j == 0 else 1,
                                       shortcut_type, df))
                n_in = width
        model.add(nn.SpatialAveragePooling(8, 8, 1, 1, data_format=df))
        model.add(nn.View(64))
        model.add(nn.Linear(64, class_num))
        model.add(nn.LogSoftMax())
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    return model
